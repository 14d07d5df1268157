"""Hash-partition kernel: reorder a batch into per-partition runs.

Counterpart of ``spark_rapids_tpu/kernels/partition.py`` (``hash_partition``
:27): murmur3 of the key columns -> pmod -> a stable reorder by partition
id, plus int32 row counts per partition, so partition p holds rows
[offsets[p], offsets[p + 1]) of the output, offsets the exclusive cumsum of
the counts.  The order and the counts are bit-identical to the
reference's.

On CUDA tensors ``partition_order`` runs the stable radix passes of
``csrc/sort.cu`` over the partition ids (one pass up to 256 partitions, one
more for every further 8 bits) and counts the launch; on CPU
tensors it runs the plain version (a stable ``torch.sort`` and a
``torch.bincount``).

``round_robin_partition`` (:67) sends row i to partition ``(i + start) %
n``.  Its order has a closed form (partition p holds the rows r0 + q * n
in order, r0 = (p - start) mod n), which R1 ``round_robin_order`` writes
on the card, a thread per output row (``srt_round_robin_order``,
``csrc/sort.cu``); its plain version is the reference's: a stable sort of
the partition ids.  The counts, ceil((rows - r0) / n) where r0 < rows
and else 0, are host arithmetic: no radix pass, and no read of the counts
from the card.

``range_partition`` (K1) is the range sort's router
(``spark_rapids_tpu/plan/execs/range_sort.py`` ``make_router.route``
:96-113): each row's bucket is the number of sorted boundary rows whose
words are lexicographically at most its own, so equal keys never split,
then the same stable reorder by bucket and the counts.  On the card the
buckets come from ``srt_range_route`` (``csrc/sort.cu``); its plain
version ranks the boundary and key rows together (``torch.unique``) and
searches the boundaries' ranks.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.kernels import _lib
from spark_rapids_tpu_torch.kernels.hash import (DEFAULT_SEED,
                                                 murmur3_partition)
from spark_rapids_tpu_torch.kernels.selection import gather_batch

_SIGN64 = -2**63


def partition_order_plain(part: torch.Tensor, num_partitions: int
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    order = torch.sort(part, stable=True).indices.to(torch.int32)
    counts = torch.bincount(part.to(torch.int64), minlength=num_partitions)
    return order, counts.to(torch.int32)


def _partition_order_cuda(part: torch.Tensor, num_partitions: int
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    _lib.require_cuda("partition", part)
    lib = _lib.lib()
    n = part.shape[0]
    dev = part.device
    order = torch.empty(n, dtype=torch.int32, device=dev)
    counts = torch.empty(num_partitions, dtype=torch.int32, device=dev)
    max_bits = lib.srt_max_radix_bits()
    multi = (num_partitions - 1).bit_length() > max_bits
    ntiles = -(-n // lib.srt_sort_tile())
    hist = torch.empty((1 << max_bits) * max(ntiles, 1), dtype=torch.int32,
                       device=dev)
    totals = torch.empty(1 << max_bits, dtype=torch.int32, device=dev)
    # more than one pass: two key buffers and a second row-id buffer
    keys = torch.empty(2 * n if multi else 0, dtype=torch.int32, device=dev)
    ids_tmp = torch.empty(n if multi else 0, dtype=torch.int32, device=dev)
    _lib.check(lib.srt_partition(
        _lib.ptr(part), n, num_partitions, _lib.ptr(order), _lib.ptr(counts),
        _lib.ptr(keys[:n]) if multi else None,
        _lib.ptr(keys[n:]) if multi else None,
        _lib.ptr(ids_tmp) if multi else None, _lib.ptr(hist),
        _lib.ptr(totals), _lib.stream(dev)), "partition")
    _lib.LAUNCHES["partition"] += 1
    return order, counts


def partition_order(part: torch.Tensor, num_partitions: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stable order of the rows by int32 partition id in
    [0, num_partitions), and the int32 row count of each partition."""
    if num_partitions < 1:
        raise ValueError(f"partition: {num_partitions} partitions")
    if part.dtype != torch.int32 or part.dim() != 1:
        raise TypeError(f"partition ids must be 1-d int32, got {part.dtype}")
    if part.device.type == "cpu":
        return partition_order_plain(part, num_partitions)
    return _partition_order_cuda(part, num_partitions)


ROUND_ROBIN = "round_robin_order"


def round_robin_counts(rows: int, num_partitions: int,
                       start: int) -> List[int]:
    """Rows of each round-robin partition: partition p's first row is
    r0 = (p - start) mod n, so it holds ceil((rows - r0) / n) rows."""
    out = []
    for p in range(num_partitions):
        r0 = (p - start) % num_partitions
        out.append(-(-(rows - r0) // num_partitions) if r0 < rows else 0)
    return out


def round_robin_order_plain(rows: int, num_partitions: int, start: int,
                            device) -> torch.Tensor:
    """The reference's way: a stable sort of the partition ids."""
    part = ((torch.arange(rows, dtype=torch.int64, device=device) + start)
            % num_partitions).to(torch.int32)
    return partition_order_plain(part, num_partitions)[0]


def _round_robin_order_cuda(rows: int, num_partitions: int, start: int,
                            device: torch.device) -> torch.Tensor:
    order = torch.empty(rows, dtype=torch.int32, device=device)
    _lib.check(_lib.lib().srt_round_robin_order(
        rows, num_partitions, start, _lib.ptr(order), _lib.stream(device)),
        ROUND_ROBIN)
    if rows:
        _lib.LAUNCHES[ROUND_ROBIN] += 1
    return order


def round_robin_order(rows: int, num_partitions: int, start: int,
                      device) -> torch.Tensor:
    """R1: int32 [rows], the stable order of the rows by round-robin
    partition (i + start) % num_partitions, on ``device``."""
    if num_partitions < 1:
        raise ValueError(f"round robin: {num_partitions} partitions")
    if rows >= 2**31:
        raise ValueError("round robin: int32 row ids need rows < 2**31")
    start %= num_partitions
    device = torch.device(device)
    if device.type == "cpu":
        return round_robin_order_plain(rows, num_partitions, start, device)
    if device.type != "cuda":
        raise ValueError(f"{ROUND_ROBIN}: device {device}, expected cuda")
    return _round_robin_order_cuda(rows, num_partitions, start, device)


def round_robin_partition(batch: ColumnarBatch, num_partitions: int,
                          start_partition: int = 0
                          ) -> Tuple[ColumnarBatch, List[int]]:
    """(batch reordered by round-robin partition, host counts): row i goes
    to partition (i + start_partition) % num_partitions."""
    order = round_robin_order(batch.num_rows, num_partitions,
                              start_partition, batch.device)
    return (gather_batch(batch, order),
            round_robin_counts(batch.num_rows, num_partitions,
                               start_partition % num_partitions))


def hash_partition(batch: ColumnarBatch, key_cols: Sequence[int],
                   num_partitions: int, seed: int = DEFAULT_SEED
                   ) -> Tuple[ColumnarBatch, torch.Tensor]:
    """(batch reordered by partition, int32 counts[num_partitions]).  With
    the default seed it routes exactly as Spark's HashPartitioning."""
    _, part = murmur3_partition([batch.columns[c] for c in key_cols],
                                num_partitions, seed)
    order, counts = partition_order(part, num_partitions)
    return gather_batch(batch, order), counts


def _check_route(words: torch.Tensor, bounds: torch.Tensor) -> None:
    if words.dtype != torch.int64 or words.dim() != 2:
        raise TypeError(f"range route: words must be int64 [nk, n], got "
                        f"{words.dtype} {tuple(words.shape)}")
    if bounds.dtype != torch.int64 or bounds.dim() != 2 \
            or bounds.shape[1] != words.shape[0]:
        raise TypeError(f"range route: boundaries must be int64 [nb, "
                        f"{words.shape[0]}], got {bounds.dtype} "
                        f"{tuple(bounds.shape)}")


def range_route_plain(words: torch.Tensor, bounds: torch.Tensor
                      ) -> torch.Tensor:
    """int32 bucket of each row (the signed order of word ^ sign bit is the
    uint64 order of the word)."""
    n, nb = words.shape[1], bounds.shape[0]
    if nb == 0 or n == 0:
        return torch.zeros(n, dtype=torch.int32, device=words.device)
    rows = torch.cat([bounds, words.t()]) ^ _SIGN64
    _, rank = torch.unique(rows, dim=0, return_inverse=True)
    return torch.searchsorted(rank[:nb].contiguous(), rank[nb:].contiguous(),
                              right=True).to(torch.int32)


def _range_route_cuda(words: torch.Tensor, bounds: torch.Tensor
                      ) -> torch.Tensor:
    _lib.require_cuda("range_partition", words, bounds)
    lib = _lib.lib()
    nk, n = words.shape
    nb = bounds.shape[0]
    dest = torch.empty(n, dtype=torch.int32, device=words.device)
    _lib.check(lib.srt_range_route(
        _lib.ptr(words.contiguous()), n, nk, _lib.ptr(bounds.contiguous()),
        nb, _lib.ptr(dest), _lib.stream(words.device)), "range_partition")
    if n:
        _lib.LAUNCHES["range_partition"] += 1
    return dest


def range_route(words: torch.Tensor, bounds: torch.Tensor) -> torch.Tensor:
    """int32 [n]: each row's bucket in [0, nb] for int64 [nk, n] row words
    (uint64 bits, plane major) against int64 [nb, nk] boundary rows sorted
    and distinct."""
    _check_route(words, bounds)
    if words.device.type == "cpu":
        return range_route_plain(words, bounds)
    return _range_route_cuda(words, bounds)


def range_partition(words: torch.Tensor, bounds: torch.Tensor,
                    num_partitions: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1: (the stable order of the rows by range bucket, int32
    counts[num_partitions]); num_partitions > the number of boundaries."""
    if num_partitions <= bounds.shape[0]:
        raise ValueError(f"range partition: {bounds.shape[0]} boundaries "
                         f"make {bounds.shape[0] + 1} buckets, more than "
                         f"{num_partitions}")
    return partition_order(range_route(words, bounds), num_partitions)
