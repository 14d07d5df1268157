#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
  1. device: a CUDA card must exist; prints its name and power limit;
  2. build: compiles the port's CUDA kernels from csrc/ (timed);
  3. kernels: each hand-written kernel against its plain PyTorch version on
     the card: the q6 path's kernels at its shapes (n = 1,048,576;
     selectivities 1.8%, 50% and 0%; 10% nulls; a ragged n = 1,000,003),
     and the q1 path's (murmur3, partition, sort, segmented sum) at
     n = 1,048,576 and 1,000,003 over int32, int64, Decimal64, double and
     bool keys with 10% nulls, -0.0 and NaN and 7, 1,000 and ~n distinct;
     then every kernel at the shapes q1 gives it (the filter's mask, the
     sort of the filtered key and the 8-column gather by its permutation,
     the group boundaries, the segmented sums, the 7-row partial batch's
     hash and partition, the reduce side's concat); each timed shape
     compared before it is timed, with its time, the plain version's, a
     library call's and its bound.  A kernel's ``max_abs_err`` is the
     largest difference over all its comparisons;
  4. data: TPC-H lineitem at SF10 (60,012,150 rows, all eleven columns on
     the card, batches of 1,048,576 rows, 4 partitions), with independent
     numpy evaluations of q6 and q1;
  5. q6 through GpuSession, held against numpy, with every q6 kernel's
     launch count checked over that run, then timed, then profiled for
     the card's busy time and idle share;
  6. q1 the same way: grouped partial aggregate, hash exchange into 16
     partitions, final aggregate;
  7. prints the kernels summary line, then the result line last.
Imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from spark_rapids_tpu_torch.api.session import GpuSession  # noqa: E402
from spark_rapids_tpu_torch.columnar.arrow import batch_from_numpy  # noqa: E402
from spark_rapids_tpu_torch.columnar.column import DeviceColumn  # noqa: E402
from spark_rapids_tpu_torch.columnar.batch import (  # noqa: E402
    ColumnarBatch, Schema)
from spark_rapids_tpu_torch.kernels import _lib  # noqa: E402
from spark_rapids_tpu_torch.kernels import hash as HK  # noqa: E402
from spark_rapids_tpu_torch.kernels import partition as PK  # noqa: E402
from spark_rapids_tpu_torch.kernels import reduction as R  # noqa: E402
from spark_rapids_tpu_torch.kernels import selection as S  # noqa: E402
from spark_rapids_tpu_torch.kernels import sort as SK  # noqa: E402
from spark_rapids_tpu_torch import types as T  # noqa: E402
from spark_rapids_tpu_torch.testing import tpch  # noqa: E402

HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA data sheet
# no integer peak is published beside the tensor-core rates: the f32 rate
# outside the tensor cores stands for the 32-bit integer and f64-add work
# (an upper bound on the rate, so the bound stays a lower bound on time)
OPS_PER_S = 67e12
N = 1 << 20                      # rows per batch on the q6 path
RAGGED = 1_000_003
SEL_Q6 = 0.018                   # q6's selectivity on this generator
SF10_ROWS = 10 * tpch.ROWS_PER_SF
F64_RTOL_KERNEL = 1e-12          # sum order differs from torch.sum
F64_RTOL_Q6 = 1e-9               # against numpy's pairwise sum
F64_RTOL_Q1 = 1e-9               # against numpy's bincount sums
Q1_CUTOFF = tpch._days(1998, 9, 2)
SHUFFLE_PARTITIONS = 16
ITERS, WARMUP = 20, 3

KERNELS = {
    "compaction_map": ("csrc/selection.cu",
                       "spark_rapids_tpu/kernels/selection.py:65"),
    "gather": ("csrc/selection.cu",
               "spark_rapids_tpu/kernels/selection.py:191"),
    "masked_sum": ("csrc/reduction.cu",
                   "spark_rapids_tpu/plan/execs/aggregate.py:274"),
    "concat": ("csrc/selection.cu",
               "spark_rapids_tpu/kernels/selection.py:429"),
    "murmur3": ("csrc/hash.cu", "spark_rapids_tpu/kernels/hash.py:237"),
    "partition": ("csrc/sort.cu",
                  "spark_rapids_tpu/kernels/partition.py:27"),
    "sort": ("csrc/sort.cu", "spark_rapids_tpu/kernels/sort.py:200"),
    "segmented_sum": ("csrc/reduction.cu",
                      "spark_rapids_tpu/kernels/groupby.py:166"),
}
Q6_KERNELS = ("compaction_map", "gather", "masked_sum", "concat")
Q1_KERNELS = ("compaction_map", "gather", "concat", "murmur3", "partition",
              "sort", "segmented_sum")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn) -> float:
    """Median time of one call between CUDA events recorded around it."""
    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(ITERS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_profile(fn, calls: int = ITERS, idle_ok: bool = False):
    """Device activity of ``calls`` calls of fn under torch.profiler (CUPTI):
    (device ms per call, device activities per call, device ms by name).
    Device activities are kernels, copies and memsets; their summed
    durations are the time the card worked, whatever the host did.  A
    trace with no device activity is taken again, twice at most; then it
    fails, unless the caller declares (``idle_ok``) that fn may launch
    nothing, as an empty gather does."""
    fn()
    torch.cuda.synchronize()
    for _ in range(3):   # a trace now and then comes back without the card
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU,
                            torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        by_name = {}
        count = 0
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                by_name[e.name] = by_name.get(e.name, 0.0) + \
                    e.time_range.elapsed_us() / 1e3 / calls
                count += 1
        if count:
            break
    require(count > 0 or idle_ok, "torch.profiler recorded no device "
            "activity for a call that launches work")
    return sum(by_name.values()), count / calls, by_name


def measure(kernel, plain, library, nbytes: int, ops: int = 0,
            idle_ok: bool = False) -> dict:
    """Times of the kernel's wrapper, its plain version and the library
    call (None: there is none) on the same inputs: ``*_ms`` is the median
    time of one call between CUDA events, which also holds the host's work
    while the card waits for it; ``*_device_ms`` is the card's own time
    per call (profiler).  ``idle_ok``: the inputs are empty, so a call may
    launch nothing."""
    out = {}
    for key, fn in (("kernel", kernel), ("plain", plain),
                    ("library", library)):
        if fn is None:
            out[f"{key}_ms"] = out[f"{key}_device_ms"] = None
            continue
        out[f"{key}_ms"] = cuda_ms(fn)
        out[f"{key}_device_ms"] = device_profile(fn, idle_ok=idle_ok)[0]
    out["bound_us"] = bound_ms(nbytes, ops) * 1e3
    return out


def summarize(line: dict, nbytes: int, ops: int = 0) -> dict:
    """The kernels-line entry: device times, beside the bound.  Its
    ``max_abs_err`` is filled in at the end of phase 3, from ERRS."""
    return dict(ms=line["kernel_device_ms"],
                call_ms=line["kernel_ms"],
                plain_ms=line["plain_device_ms"],
                library_ms=line["library_device_ms"],
                bound_ms=bound_ms(nbytes, ops),
                bound_by="bytes" if nbytes / HBM_BYTES_PER_S >= ops / OPS_PER_S
                else "operations")


def bound_ms(nbytes: int, ops: int = 0) -> float:
    """The least time for the work: bytes over the memory rate or
    operations over the peak rate, whichever is larger."""
    return max(nbytes / HBM_BYTES_PER_S, ops / OPS_PER_S) * 1e3


def require(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


#: kernel -> the largest |kernel - plain| over every comparison of phase 3
ERRS: dict = {}


def abs_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest |got - want| over two tensors of one shape and type; NaNs in
    the same places count as equal."""
    if got.numel() == 0:
        return 0.0
    if got.dtype == torch.bool:
        return float((got != want).any())
    if got.is_floating_point():
        same = (got == want) | (torch.isnan(got) & torch.isnan(want))
        d = (got - want).abs().masked_fill(same, 0.0)
        return float(d.max())
    return float((got.to(torch.int64) - want.to(torch.int64)).abs().max())


def hold(kernel: str, pairs, what: str, rtol=None) -> float:
    """Hold each (kernel's tensor, plain version's tensor) pair: bit for bit,
    or within ``rtol`` relative; record the largest absolute error."""
    err = 0.0
    for got, want in pairs:
        require(got.shape == want.shape and got.dtype == want.dtype,
                f"{kernel}: {what}: {tuple(got.shape)} {got.dtype} against "
                f"{tuple(want.shape)} {want.dtype}")
        e = abs_err(got, want)
        if rtol is None:
            ok = torch.equal(bits(got), bits(want))
        else:
            ok = bool(((got - want).abs() <= rtol * want.abs()).all())
        require(ok, f"{kernel} differs from its plain version: {what} "
                f"(max abs err {e})")
        err = max(err, e)
    ERRS[kernel] = max(ERRS.get(kernel, 0.0), err)
    return err


def column_pairs(got, want) -> list:
    return [p for x, y in zip(got, want, strict=True)
            for p in ((x.data, y.data), (x.validity, y.validity))]


def random_column(rng, n, dtype: T.DataType, null_frac: float,
                  dev) -> DeviceColumn:
    if dtype == T.DOUBLE:
        vals = rng.uniform(0.0, 1e5, n)
    elif dtype == T.BOOLEAN:
        vals = rng.rand(n) < 0.5
    elif dtype.torch_dtype == torch.int32:
        vals = rng.randint(-2**31, 2**31 - 1, n, dtype=np.int64)
    else:
        vals = rng.randint(-2**62, 2**62, n, dtype=np.int64)
    valid = rng.rand(n) >= null_frac
    return DeviceColumn.from_numpy(vals.astype(dtype.np_dtype), dtype, valid,
                                   dev)


def bits(t: torch.Tensor) -> torch.Tensor:
    """Floats as their bits, so that NaN equals itself."""
    if not t.is_floating_point():
        return t
    return t.view({2: torch.int16, 4: torch.int32,
                   8: torch.int64}[t.element_size()])


# -- phase 1 ------------------------------------------------------------------

def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available()"
                         " is False)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    return smi


# -- phase 2 ------------------------------------------------------------------

def phase_build() -> None:
    t0 = time.perf_counter()
    path = _lib.build()
    _lib.lib()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "library": os.path.relpath(path)})


# -- phase 3 ------------------------------------------------------------------

def q1_shapes(dev) -> dict:
    """The shapes q1 gives the kernels, from the first SF10 batch: the
    filter's mask; the partial step's work batch (the int32 key and its
    seven f64 inputs), the key's sort permutation, the group-boundary
    flags and the group starts; and a 7-row partial batch's key, which the
    exchange hashes and partitions."""
    chunk = next(tpch.iter_lineitem(SF10_ROWS, seed=42, batch_rows=N))
    mask = chunk["l_shipdate"] <= Q1_CUTOFF
    key = chunk["l_linenumber"][mask]
    qty, price, disc, tax = (chunk[c][mask].astype(np.float64) / 100 for c in
                             ("l_quantity", "l_extendedprice", "l_discount",
                              "l_tax"))
    disc_price = price * (1.0 - disc)
    charge = disc_price * (1.0 + tax)
    order = np.argsort(key, kind="stable")
    skey = key[order]
    boundary = np.r_[True, skey[1:] != skey[:-1]]
    work = [DeviceColumn.from_numpy(key, T.INT, None, dev)] + [
        DeviceColumn.from_numpy(v, T.DOUBLE, None, dev)
        for v in (qty, price, disc_price, charge, qty, price, disc)]
    return {
        "filter_mask": torch.from_numpy(mask).to(dev),
        "key": work[0],
        "work": work,
        "order": torch.from_numpy(order.astype(np.int32)).to(dev),
        "boundary": torch.from_numpy(boundary).to(dev),
        "sorted_qty": DeviceColumn.from_numpy(qty[order], T.DOUBLE, None,
                                              dev),
        "starts": torch.from_numpy(np.flatnonzero(boundary).astype(
            np.int32)).to(dev),
        "partial_key": DeviceColumn.from_numpy(
            np.arange(1, 8, dtype=np.int32), T.INT, None, dev),
    }


def check_compaction(rng, dev, shapes, summary) -> dict:
    """Random masks at q6's selectivity and others, then q1's filter mask
    (96.5% set) and its group-boundary flags (7 set in ~1.01M)."""
    cases = [(f"p={p}", torch.from_numpy(rng.rand(n) < p).to(dev), (n, p))
             for n, p in ((N, SEL_Q6), (N, 0.5), (N, 0.0), (RAGGED, 0.5))]
    cases += [("q1_filter", shapes["filter_mask"], None),
              ("q1_boundary", shapes["boundary"], None)]
    masks = {}
    for label, mask, key in cases:
        n = mask.shape[0]
        got, count = S.compaction_map(mask)
        want, wcount = S.compaction_map_plain(mask)
        require(count == wcount, f"compaction_map count differs: {label}")
        hold("compaction_map", [(got, want)], f"{label} n={n}")
        lib_idx = torch.nonzero(mask).flatten().to(torch.int32)
        require(torch.equal(got, lib_idx), "compaction_map != torch.nonzero")
        if key is not None:
            masks[key] = (mask, got)
        nbytes = n + 4 * count
        line = {"kernel": "compaction_map", "shape": label, "n": n,
                "count": count, **measure(
                    lambda: S.compaction_map(mask),
                    lambda: S.compaction_map_plain(mask),
                    lambda: torch.nonzero(mask), nbytes)}
        emit(line)
        if key == (N, SEL_Q6):
            summary["compaction_map"] = summarize(line, nbytes)
    return masks


def check_gather(rng, dev, masks, shapes, summary) -> None:
    # q6's four columns after pruning, then the other widths
    q6_types = [tpch.DEC12_2, tpch.DEC12_2, tpch.DEC12_2, T.DATE]
    for (n, p), (_, idx) in masks.items():
        types = q6_types + [T.DOUBLE, T.BOOLEAN, T.INT]
        cols = [random_column(rng, n, dt, 0.1, dev) for dt in types]
        cases = [("map", idx)]
        if p == 0.5:
            oob = torch.tensor([-1, n, 2**31 - 1, 0, n - 1], dtype=torch.int32,
                               device=dev)
            cases.append(("map+out_of_range", torch.cat([idx, oob])))
        for label, ix in cases:
            hold("gather", column_pairs(S.gather_columns(cols, ix),
                                        S.gather_columns_plain(cols, ix)),
                 f"n={n} p={p} {label}")
        q6_cols = cols[:4]
        m = idx.shape[0]
        planes = [t for c in q6_cols for t in (c.data, c.validity)]
        nbytes = 4 * m + 2 * m * sum(c.data.element_size() + 1
                                     for c in q6_cols)
        line = {"kernel": "gather", "shape": f"p={p}", "n_src": n, "rows": m,
                "columns": 4,
                **measure(lambda: S.gather_columns(q6_cols, idx),
                          lambda: S.gather_columns_plain(q6_cols, idx),
                          lambda: [torch.index_select(t, 0, idx)
                                   for t in planes], nbytes,
                          idle_ok=m == 0)}
        emit(line)
        if (n, p) == (N, SEL_Q6):
            summary["gather"] = summarize(line, nbytes)
    # q1's partial step: the 8 work columns by the key's sort permutation
    work, order = shapes["work"], shapes["order"]
    m = order.shape[0]
    hold("gather", column_pairs(S.gather_columns(work, order),
                                S.gather_columns_plain(work, order)),
         f"q1's {len(work)}-column gather by the sort permutation, n={m}")
    planes = [t for c in work for t in (c.data, c.validity)]
    nbytes = 4 * m + 2 * m * sum(c.data.element_size() + 1 for c in work)
    emit({"kernel": "gather", "shape": "q1_sorted", "n_src": m, "rows": m,
          "columns": len(work),
          **measure(lambda: S.gather_columns(work, order),
                    lambda: S.gather_columns_plain(work, order),
                    lambda: [torch.index_select(t, 0, order) for t in planes],
                    nbytes)})


def check_masked_sum(rng, dev, masks, summary) -> None:
    m_q6 = masks[(N, SEL_Q6)][1].shape[0]
    cases = [(m_q6, 0.0), (N, 0.1), (RAGGED, 0.1), (N, 1.0), (0, 0.0), (1, 0.0)]
    for n, null_frac in cases:
        for dt in (T.DOUBLE, T.LONG):
            c = random_column(rng, n, dt, null_frac, dev)
            value, ok, nvalid = R.masked_sum(c.data, c.validity)
            pv, pok, pn = R.masked_sum_plain(c.data, c.validity)
            what = f"n={n} {dt!r}"
            hold("masked_sum", [(ok, pok), (nvalid, pn)], what)
            err = hold("masked_sum", [(value, pv)], what,
                       F64_RTOL_KERNEL if dt == T.DOUBLE else None)
            if n < N and not (n == m_q6 and dt == T.DOUBLE):
                continue
            nbytes = 9 * n + 17
            line = {"kernel": "masked_sum", "dtype": repr(dt), "n": n,
                    "null_frac": null_frac, "abs_err": err,
                    **measure(lambda: R.masked_sum(c.data, c.validity),
                              lambda: R.masked_sum_plain(c.data, c.validity),
                              lambda: torch.sum(c.data), nbytes)}
            emit(line)
            if n == m_q6 and dt == T.DOUBLE:
                summary["masked_sum"] = summarize(line, nbytes)


def check_concat(rng, dev, summary) -> None:
    k = 58   # one-row partials of q6 at SF10
    # q1's reduce side: a partition's pieces, one from each map batch, of
    # one row, or two where two keys share the partition
    cases = [("q6_partials", [1] * k, 0.0), ("q1_partials", [2] * k, 0.0),
             ("ragged", list(rng.randint(0, 20_000, k)), 0.1),
             ("with_empty", [0, 5, 0, 0, 7, 0], 0.1),
             ("one_piece", [RAGGED], 0.1)]
    for label, sizes, null_frac in cases:
        for dt in (T.DOUBLE, T.LONG, T.INT, T.DATE, T.BOOLEAN):
            pieces = [random_column(rng, int(s), dt, null_frac, dev)
                      for s in sizes]
            hold("concat", column_pairs([S.concat_column(pieces)],
                                        [S.concat_column_plain(pieces)]),
                 f"{label} {dt!r}")
        if label != "q6_partials":
            continue
        pieces = [random_column(rng, 1, T.DOUBLE, 0.0, dev) for _ in range(k)]
        hold("concat", column_pairs([S.concat_column(pieces)],
                                    [S.concat_column_plain(pieces)]),
             "the timed pieces")
        nbytes = 2 * 9 * k
        line = {"kernel": "concat", "pieces": k, "rows": k,
                **measure(lambda: S.concat_column(pieces),
                          lambda: S.concat_column_plain(pieces),
                          lambda: (torch.cat([p.data for p in pieces]),
                                   torch.cat([p.validity for p in pieces])),
                          nbytes)}
        emit(line)
        summary["concat"] = summarize(line, nbytes)


SPECIAL_KEYS = np.array([0.0, -0.0, np.nan, -np.nan])


def key_column(rng, n, dtype: T.DataType, distinct: int, dev,
               null_frac: float = 0.1) -> DeviceColumn:
    """n keys drawn from about ``distinct`` values, with nulls; doubles
    take -0.0, 0.0 and NaNs of both signs at 5% of the rows."""
    v = rng.randint(0, distinct, n).astype(np.int64) - distinct // 2
    if dtype == T.BOOLEAN:
        vals = v % 2 == 0
    elif dtype == T.DOUBLE:
        vals = v / 4.0
        special = rng.rand(n) < 0.05
        vals[special] = rng.choice(SPECIAL_KEYS, int(special.sum()))
    elif dtype.torch_dtype == torch.int32:
        vals = v
    else:      # long and Decimal64: wide values, within 18 digits
        vals = v * (2**33 + 7)
    valid = rng.rand(n) >= null_frac
    return DeviceColumn.from_numpy(vals.astype(dtype.np_dtype), dtype, valid,
                                   dev)


KEY_TYPES = (T.INT, T.LONG, tpch.DEC12_2, T.DOUBLE)


def key_cases(n):
    return [(dt, d) for dt in KEY_TYPES for d in (7, 1_000, n)] + [
        (T.BOOLEAN, 2)]


def hold_murmur3(cols, what: str) -> None:
    h, part = HK.murmur3_partition(cols, SHUFFLE_PARTITIONS)
    want = HK.murmur3_hash_plain(cols)
    hold("murmur3", [(h, want), (part, HK.pmod(want, SHUFFLE_PARTITIONS))],
         what)


def check_murmur3(rng, dev, shapes, summary) -> None:
    for n in (N, RAGGED):
        for dt, distinct in key_cases(n):
            hold_murmur3([key_column(rng, n, dt, distinct, dev)],
                         f"n={n} {dt!r} distinct={distinct}")
    cols = [key_column(rng, N, dt, 1_000, dev) for dt in KEY_TYPES]
    hold("murmur3", [(HK.murmur3_hash(cols), HK.murmur3_hash_plain(cols))],
         "chained over four columns")
    for label, col in (("n", key_column(rng, N, T.INT, 1_000, dev)),
                       ("q1_partial", shapes["partial_key"])):
        hold_murmur3([col], f"the timed {label} key")
        n = col.num_rows
        # ~25 integer operations per 4-byte block, 3 for pmod
        nbytes, ops = 5 * n + 8 * n, 28 * n
        line = {"kernel": "murmur3", "shape": label, "n": n, "columns": 1,
                **measure(lambda: HK.murmur3_partition([col],
                                                       SHUFFLE_PARTITIONS),
                          lambda: HK.pmod(HK.murmur3_hash_plain([col]),
                                          SHUFFLE_PARTITIONS),
                          None, nbytes, ops)}
        emit(line)
        if label == "q1_partial":
            summary["murmur3"] = summarize(line, nbytes, ops)


def hold_partition(part, nparts: int, what: str) -> None:
    hold("partition", zip(PK.partition_order(part, nparts),
                          PK.partition_order_plain(part, nparts)), what)


def check_partition(rng, dev, shapes, summary) -> None:
    # up to 256 partitions take one radix pass, 257 and 4,096 two, 100,003
    # three
    for n in (N, RAGGED):
        for nparts in (1, 16, 200, 257, 4_096, 100_003):
            part = torch.from_numpy(rng.randint(0, nparts, n).astype(
                np.int32)).to(dev)
            hold_partition(part, nparts, f"n={n} parts={nparts}")
    hold_partition(torch.zeros(0, dtype=torch.int32, device=dev), 1_000,
                   "no rows")
    # the whole hash_partition against its plain pieces on the same tensors
    cols = [key_column(rng, RAGGED, dt, 1_000, dev) for dt in KEY_TYPES]
    batch = ColumnarBatch(tuple(cols), RAGGED, Schema(
        tuple(f"c{i}" for i in range(len(cols))), KEY_TYPES))
    for nparts in (SHUFFLE_PARTITIONS, 1_000):
        got, counts = PK.hash_partition(batch, [0, 3], nparts)
        w_part = HK.pmod(HK.murmur3_hash_plain([cols[0], cols[3]]), nparts)
        w_order, w_counts = PK.partition_order_plain(w_part, nparts)
        what = f"hash_partition over {nparts} partitions"
        hold("partition", [(counts, w_counts)], what)
        hold("gather", column_pairs(got.columns,
                                    S.gather_columns_plain(cols, w_order)),
             what)
    _, big = HK.murmur3_partition([key_column(rng, N, T.INT, 1_000, dev)],
                                  SHUFFLE_PARTITIONS)
    _, small = HK.murmur3_partition([shapes["partial_key"]],
                                    SHUFFLE_PARTITIONS)
    for label, part in (("n", big), ("q1_partial", small)):
        hold_partition(part, SHUFFLE_PARTITIONS, f"the timed {label} ids")
        n = part.shape[0]
        nbytes = 8 * n + 4 * SHUFFLE_PARTITIONS
        line = {"kernel": "partition", "shape": label, "n": n,
                "partitions": SHUFFLE_PARTITIONS, **measure(
                    lambda: PK.partition_order(part, SHUFFLE_PARTITIONS),
                    lambda: PK.partition_order_plain(part,
                                                     SHUFFLE_PARTITIONS),
                    lambda: (torch.sort(part, stable=True),
                             torch.bincount(part,
                                            minlength=SHUFFLE_PARTITIONS)),
                    nbytes)}
        emit(line)
        if label == "q1_partial":
            summary["partition"] = summarize(line, nbytes)


def hold_sort(cols, orders, what: str) -> None:
    batch = ColumnarBatch(tuple(cols), cols[0].num_rows, Schema(
        tuple(f"k{i}" for i in range(len(cols))),
        tuple(c.dtype for c in cols)))
    hold("sort", [(SK.sort_indices(batch, list(range(len(cols))), orders),
                   SK.sort_indices_plain(cols, orders))], what)


def check_sort(rng, dev, shapes, summary) -> None:
    asc = [SK.SortOrder()]
    for n in (N, RAGGED):
        for dt, distinct in key_cases(n):
            orders = asc if distinct != 1_000 else [SK.SortOrder(False)]
            hold_sort([key_column(rng, n, dt, distinct, dev)], orders,
                      f"n={n} {dt!r} distinct={distinct} {orders}")
    hold_sort([key_column(rng, RAGGED, T.INT, 7, dev),
               key_column(rng, RAGGED, T.DOUBLE, 1_000, dev)],
              [SK.SortOrder(True, False), SK.SortOrder(False, True)],
              "two keys")
    long_col = key_column(rng, N, T.LONG, N, dev)
    for label, col in (("n_long_nulls", long_col),
                       ("q1_partial", shapes["key"])):
        hold_sort([col], asc, f"the timed {label} key")
        n = col.num_rows
        batch = ColumnarBatch((col,), n, Schema(("k",), (col.dtype,)))
        nbytes = (col.data.element_size() + 1) * n + 4 * n
        line = {"kernel": "sort", "shape": label, "n": n,
                "dtype": repr(col.dtype), **measure(
                    lambda: SK.sort_indices(batch, [0], asc),
                    lambda: SK.sort_indices_plain([col], asc),
                    lambda: torch.sort(col.data, stable=True), nbytes)}
        emit(line)
        if label == "q1_partial":
            summary["sort"] = summarize(line, nbytes)
    # the permutation q1's gather takes is the sort's
    require(torch.equal(SK.sort_indices(ColumnarBatch(
        (shapes["key"],), shapes["key"].num_rows, Schema(("k",), (T.INT,))),
        [0], asc), shapes["order"]), "q1's sort differs from numpy's")


def hold_segmented_sum(c, st, what: str) -> float:
    got = R.segmented_sum(c.data, c.validity, st)
    want = R.segmented_sum_plain(c.data, c.validity, st)
    hold("segmented_sum", list(zip(got[1:], want[1:])), what)
    return hold("segmented_sum", [(got[0], want[0])], what,
                F64_RTOL_KERNEL if c.data.dtype == torch.float64 else None)


def check_segmented_sum(rng, dev, shapes, summary) -> None:
    for n in (N, RAGGED):
        for g in (7, 1_000, n // 2):
            starts = np.unique(np.r_[0, rng.randint(1, n, g - 1)])
            st = torch.from_numpy(starts.astype(np.int32)).to(dev)
            for dt in (T.DOUBLE, T.LONG):
                c = random_column(rng, n, dt, 0.1, dev)
                if g == 7:   # one segment all null
                    c.validity[starts[3]:starts[4]] = False
                    c.data[starts[3]:starts[4]] = 0
                hold_segmented_sum(c, st, f"n={n} g={g} {dt!r}")
    c, st = shapes["sorted_qty"], shapes["starts"]
    n, g = c.num_rows, st.shape[0]
    lengths = R.segment_rows(st, n)
    err = hold_segmented_sum(c, st, "q1's shape")
    nbytes, ops = 9 * n + 4 * g + 25 * g, 2 * n
    line = {"kernel": "segmented_sum", "shape": "q1_partial", "n": n,
            "segments": g, "abs_err": err, **measure(
                lambda: R.segmented_sum(c.data, c.validity, st),
                lambda: R.segmented_sum_plain(c.data, c.validity, st),
                lambda: torch.segment_reduce(c.data, "sum", lengths=lengths),
                nbytes, ops)}
    emit(line)
    summary["segmented_sum"] = summarize(line, nbytes, ops)


def phase_kernels(dev) -> dict:
    # the profiler itself must see the card
    device_profile(lambda: torch.ones(8, device=dev) + 1)
    rng = np.random.RandomState(2024)
    summary = {}
    shapes = q1_shapes(dev)
    masks = check_compaction(rng, dev, shapes, summary)
    check_gather(rng, dev, masks, shapes, summary)
    check_masked_sum(rng, dev, masks, summary)
    check_concat(rng, dev, summary)
    check_murmur3(rng, dev, shapes, summary)
    check_partition(rng, dev, shapes, summary)
    check_sort(rng, dev, shapes, summary)
    check_segmented_sum(rng, dev, shapes, summary)
    torch.cuda.synchronize()
    for name in KERNELS:
        summary[name]["max_abs_err"] = ERRS[name]
    return summary


# -- phase 4 ------------------------------------------------------------------

def q6_numpy(chunk) -> tuple:
    """Independent q6 over host arrays: (sum of (price/100)*(disc/100), n)."""
    ship = chunk["l_shipdate"]
    disc = chunk["l_discount"]
    mask = ((ship >= tpch._days(1994, 1, 1)) & (ship < tpch._days(1995, 1, 1))
            & (disc >= 5) & (disc <= 7) & (chunk["l_quantity"] < 2400))
    price = chunk["l_extendedprice"][mask].astype(np.float64) / 100
    return float(np.sum(price * (disc[mask].astype(np.float64) / 100))), \
        int(mask.sum())


def q1_numpy(chunk) -> np.ndarray:
    """Independent q1 partial over host arrays: [8 keys, 6] sums of qty,
    price, disc_price, charge, disc and the row count (key 0 unused)."""
    mask = chunk["l_shipdate"] <= Q1_CUTOFF
    key = chunk["l_linenumber"][mask]
    qty, price, disc, tax = (chunk[c][mask].astype(np.float64) / 100 for c in
                             ("l_quantity", "l_extendedprice", "l_discount",
                              "l_tax"))
    disc_price = price * (1.0 - disc)
    charge = disc_price * (1.0 + tax)
    cols = [np.bincount(key, w, minlength=8)
            for w in (qty, price, disc_price, charge, disc)]
    return np.stack(cols + [np.bincount(key, minlength=8).astype(
        np.float64)], axis=1)


def q1_rows_numpy(acc: np.ndarray) -> list:
    """(key, sum_qty, sum_base_price, sum_disc_price, sum_charge, avg_qty,
    avg_price, avg_disc, count_order) for keys 1..7."""
    rows = []
    for k in range(1, 8):
        sq, sp, sdp, sc, sd, n = acc[k]
        rows.append((k, sq, sp, sdp, sc, sq / n, sp / n, sd / n, int(n)))
    return rows


def phase_data(dev):
    t0 = time.perf_counter()
    batches, revenue, count = [], 0.0, 0
    q1_acc = np.zeros((8, 6))
    for chunk in tpch.iter_lineitem(SF10_ROWS, seed=42, batch_rows=N):
        r, c = q6_numpy(chunk)
        revenue += r
        count += c
        q1_acc += q1_numpy(chunk)
        batches.append(batch_from_numpy(chunk, tpch.LINEITEM_SCHEMA, dev))
    torch.cuda.synchronize()
    resident = sum(c.data.nbytes + c.validity.nbytes
                   for b in batches for c in b.columns)
    emit({"phase": "data", "rows": SF10_ROWS, "batches": len(batches),
          "resident_bytes": resident,
          "setup_seconds": time.perf_counter() - t0,
          "numpy_q6_revenue": revenue, "numpy_q6_count": count})
    sess = GpuSession()
    require(sess.device.type == "cuda", "session is not on the card")
    require(sess.conf.shuffle_partitions == SHUFFLE_PARTITIONS,
            "q1 runs with spark.sql.shuffle.partitions = 16")
    df = sess.create_dataframe(batches, num_partitions=4)
    return df, (revenue, count), q1_rows_numpy(q1_acc)


def run_path(name: str, query, df, kernels) -> tuple:
    """The main path of one query: every launch count set to 0 just before
    it runs and read just after; each of ``kernels`` must have launched."""
    _lib.reset_launch_counts()
    rows = query(df).collect()
    torch.cuda.synchronize()
    launches = dict(_lib.LAUNCHES)
    emit({"phase": f"{name}_launches", "launches": launches})
    for k in kernels:
        require(launches.get(k, 0) > 0, f"{name} never launched {k}")
    return rows, launches


def time_path(name: str, query, df) -> dict:
    """Median wall of 3 runs after the main-path run, then one profiled
    run: the card's busy time and idle share."""
    torch.cuda.reset_peak_memory_stats()
    walls = []
    for _ in range(3):
        t = time.perf_counter()
        query(df).collect()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
    wall = statistics.median(walls)
    busy_ms, activities, by_name = device_profile(lambda: query(df).collect(),
                                                  calls=1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    emit({"phase": f"{name}_profile", "device_busy_ms": busy_ms,
          "device_activities": activities,
          "idle_share": 1.0 - busy_ms / (wall * 1e3),
          "top_device_ms": top})
    return {"wall_s": wall, "wall_s_runs": walls,
            "rows_per_s": SF10_ROWS / wall, "device_busy_ms": busy_ms,
            "max_memory_allocated": torch.cuda.max_memory_allocated()}


def phase_q6(df, ref) -> dict:
    revenue, count = ref
    rows, launches = run_path("q6", tpch.q6, df, Q6_KERNELS)
    require(len(rows) == 1 and rows[0][0] is not None, f"q6 gave {rows}")
    rel = abs(rows[0][0] - revenue) / abs(revenue)
    require(rel <= F64_RTOL_Q6, f"q6 revenue {rows[0][0]} vs numpy {revenue}")
    timing = time_path("q6", tpch.q6, df)
    rows_c = tpch.q6_count(df).collect()
    require(rows_c[0][1] == count, f"q6 count {rows_c[0][1]} vs numpy {count}")
    rel_c = abs(rows_c[0][0] - revenue) / abs(revenue)
    require(rel_c <= F64_RTOL_Q6, f"q6_count revenue {rows_c[0][0]}")
    emit({"phase": "q6", "rows": SF10_ROWS, "revenue": rows[0][0],
          "rel_err": rel, "count": rows_c[0][1], **timing})
    return launches


def phase_q1(df, ref_rows) -> dict:
    rows, launches = run_path("q1", tpch.q1, df, Q1_KERNELS)
    rows = sorted(rows, key=lambda r: (r[0] is not None, r[0]))
    require(len(rows) == 7 and [r[0] for r in rows] == list(range(1, 8)),
            f"q1 gave keys {[r[0] for r in rows]}")
    max_rel = 0.0
    for got, want in zip(rows, ref_rows):
        require(got[8] == want[8], f"q1 count {got[8]} vs numpy {want[8]}")
        for g, w in zip(got[1:8], want[1:8]):
            require(g is not None and np.isfinite(g), f"q1 gave {got}")
            max_rel = max(max_rel, abs(g - w) / abs(w))
    require(max_rel <= F64_RTOL_Q1, f"q1 off numpy by {max_rel} relative")
    timing = time_path("q1", tpch.q1, df)
    emit({"phase": "q1", "rows": SF10_ROWS, "groups": len(rows),
          "max_rel_err": max_rel, "count_order": [r[8] for r in rows],
          "shuffle_partitions": SHUFFLE_PARTITIONS, **timing})
    return launches


def main() -> None:
    phase_device()
    dev = torch.device("cuda", torch.cuda.current_device())
    phase_build()
    summary = phase_kernels(dev)
    df, q6_ref, q1_ref = phase_data(dev)
    by_path = {"q6": phase_q6(df, q6_ref), "q1": phase_q1(df, q1_ref)}
    kernels = []
    for name, (source, replaces) in KERNELS.items():
        s = summary[name]
        counts = {p: launches.get(name, 0) for p, launches in by_path.items()}
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"spark_rapids_tpu_torch/{source}",
            "replaces": replaces, "launches": sum(counts.values()),
            "launches_by_path": counts,
            "max_abs_err": s["max_abs_err"], "ms": s["ms"],
            "call_ms": s["call_ms"], "plain_ms": s["plain_ms"],
            "bound_ms": s["bound_ms"], "bound_by": s["bound_by"],
            "library_ms": s["library_ms"]})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
