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
``torch.bincount``).  ``round_robin_partition`` (:67) is not ported.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.kernels import _lib
from spark_rapids_tpu_torch.kernels.hash import (DEFAULT_SEED,
                                                 murmur3_partition)
from spark_rapids_tpu_torch.kernels.selection import gather_batch


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


def hash_partition(batch: ColumnarBatch, key_cols: Sequence[int],
                   num_partitions: int, seed: int = DEFAULT_SEED
                   ) -> Tuple[ColumnarBatch, torch.Tensor]:
    """(batch reordered by partition, int32 counts[num_partitions]).  With
    the default seed it routes exactly as Spark's HashPartitioning."""
    _, part = murmur3_partition([batch.columns[c] for c in key_cols],
                                num_partitions, seed)
    order, counts = partition_order(part, num_partitions)
    return gather_batch(batch, order), counts
