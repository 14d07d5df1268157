#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
  1. device: a CUDA card must exist; prints its name and power limit;
  2. build: compiles the port's CUDA kernels from csrc/ (timed);
  3. kernels: each hand-written kernel against its plain PyTorch version on
     the card, at the q6 path's shapes (n = 1,048,576; selectivities 1.8%,
     50% and 0%; 10% nulls; a ragged n = 1,000,003), with its time, the
     plain version's, a library call's and its memory-bound time;
  4. q6: TPC-H q6 at SF10 (60,012,150 lineitem rows, all eleven columns on
     the card, batches of 1,048,576 rows, 4 partitions) through GpuSession,
     held against an independent numpy evaluation, with every kernel's
     launch count checked over that run, then timed, then profiled for
     the card's busy time and idle share;
  5. prints the kernels summary line, then the result line last.
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
from spark_rapids_tpu_torch.kernels import _lib  # noqa: E402
from spark_rapids_tpu_torch.kernels import reduction as R  # noqa: E402
from spark_rapids_tpu_torch.kernels import selection as S  # noqa: E402
from spark_rapids_tpu_torch import types as T  # noqa: E402
from spark_rapids_tpu_torch.testing import tpch  # noqa: E402

HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA data sheet
N = 1 << 20                      # rows per batch on the q6 path
RAGGED = 1_000_003
SEL_Q6 = 0.018                   # q6's selectivity on this generator
SF10_ROWS = 10 * tpch.ROWS_PER_SF
F64_RTOL_KERNEL = 1e-12          # sum order differs from torch.sum
F64_RTOL_Q6 = 1e-9               # against numpy's pairwise sum
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
}


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


def device_profile(fn, calls: int = ITERS):
    """Device activity of ``calls`` calls of fn under torch.profiler (CUPTI):
    (device ms per call, device activities per call, device ms by name).
    Device activities are kernels, copies and memsets; their summed
    durations are the time the card worked, whatever the host did."""
    fn()
    torch.cuda.synchronize()
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
    return sum(by_name.values()), count / calls, by_name


def measure(kernel, plain, library, nbytes: int) -> dict:
    """Times of the kernel's wrapper, its plain version and the library
    call on the same inputs: ``*_ms`` is the median time of one call between
    CUDA events, which also holds the host's work while the card waits for
    it; ``*_device_ms`` is the card's own time per call (profiler)."""
    out = {}
    for key, fn in (("kernel", kernel), ("plain", plain),
                    ("library", library)):
        out[f"{key}_ms"] = cuda_ms(fn)
        out[f"{key}_device_ms"] = device_profile(fn)[0]
    out["bound_us"] = bound_ms(nbytes) * 1e3
    return out


def summarize(line: dict, max_abs_err, nbytes: int) -> dict:
    """The kernels-line entry: device times, beside the memory bound."""
    return dict(max_abs_err=max_abs_err, ms=line["kernel_device_ms"],
                plain_ms=line["plain_device_ms"],
                library_ms=line["library_device_ms"],
                bound_ms=bound_ms(nbytes))


def bound_ms(nbytes: int) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


def require(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


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


def same_columns(a, b) -> bool:
    return all(torch.equal(x.data, y.data) and torch.equal(x.validity,
                                                           y.validity)
               for x, y in zip(a, b))


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

def check_compaction(rng, dev, summary) -> dict:
    cases = [(N, SEL_Q6), (N, 0.5), (N, 0.0), (RAGGED, 0.5)]
    masks = {}
    for n, p in cases:
        mask = torch.from_numpy(rng.rand(n) < p).to(dev)
        got, count = S.compaction_map(mask)
        want, wcount = S.compaction_map_plain(mask)
        require(count == wcount and torch.equal(got, want),
                f"compaction_map differs at n={n} p={p}")
        lib_idx = torch.nonzero(mask).flatten().to(torch.int32)
        require(torch.equal(got, lib_idx), "compaction_map != torch.nonzero")
        masks[(n, p)] = (mask, got)
        nbytes = n + 4 * count
        line = {"kernel": "compaction_map", "n": n, "selectivity": p,
                "count": count, **measure(
                    lambda: S.compaction_map(mask),
                    lambda: S.compaction_map_plain(mask),
                    lambda: torch.nonzero(mask), nbytes)}
        emit(line)
        if (n, p) == (N, SEL_Q6):
            summary["compaction_map"] = summarize(line, 0, nbytes)
    return masks


def check_gather(rng, dev, masks, summary) -> None:
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
            got = S.gather_columns(cols, ix)
            want = S.gather_columns_plain(cols, ix)
            require(same_columns(got, want),
                    f"gather differs at n={n} p={p} {label}")
        q6_cols = cols[:4]
        m = idx.shape[0]
        planes = [t for c in q6_cols for t in (c.data, c.validity)]
        nbytes = 4 * m + 2 * m * sum(c.data.element_size() + 1
                                     for c in q6_cols)
        line = {"kernel": "gather", "n_src": n, "rows": m, "columns": 4,
                **measure(lambda: S.gather_columns(q6_cols, idx),
                          lambda: S.gather_columns_plain(q6_cols, idx),
                          lambda: [torch.index_select(t, 0, idx)
                                   for t in planes], nbytes)}
        emit(line)
        if (n, p) == (N, SEL_Q6):
            summary["gather"] = summarize(line, 0, nbytes)


def check_masked_sum(rng, dev, masks, summary) -> None:
    m_q6 = masks[(N, SEL_Q6)][1].shape[0]
    cases = [(m_q6, 0.0), (N, 0.1), (RAGGED, 0.1), (N, 1.0), (0, 0.0), (1, 0.0)]
    for n, null_frac in cases:
        for dt in (T.DOUBLE, T.LONG):
            c = random_column(rng, n, dt, null_frac, dev)
            value, ok, nvalid = R.masked_sum(c.data, c.validity)
            pv, pok, pn = R.masked_sum_plain(c.data, c.validity)
            require(torch.equal(ok, pok) and torch.equal(nvalid, pn),
                    f"masked_sum count/flag differs at n={n} {dt!r}")
            if dt == T.DOUBLE:
                err = abs(float(value) - float(pv))
                require(err <= F64_RTOL_KERNEL * abs(float(pv)),
                        f"masked_sum f64 off by {err} at n={n}")
            else:
                err = 0
                require(torch.equal(value, pv),
                        f"masked_sum i64 differs at n={n}")
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
                summary["masked_sum"] = summarize(line, err, nbytes)


def check_concat(rng, dev, summary) -> None:
    k = 58   # one-row partials of q6 at SF10
    cases = [("q6_partials", [1] * k, 0.0),
             ("ragged", list(rng.randint(0, 20_000, k)), 0.1),
             ("with_empty", [0, 5, 0, 0, 7, 0], 0.1),
             ("one_piece", [RAGGED], 0.1)]
    for label, sizes, null_frac in cases:
        for dt in (T.DOUBLE, T.LONG, T.DATE, T.BOOLEAN):
            pieces = [random_column(rng, int(s), dt, null_frac, dev)
                      for s in sizes]
            got = S.concat_column(pieces)
            want = S.concat_column_plain(pieces)
            require(same_columns([got], [want]),
                    f"concat differs: {label} {dt!r}")
        if label != "q6_partials":
            continue
        pieces = [random_column(rng, 1, T.DOUBLE, 0.0, dev) for _ in range(k)]
        nbytes = 2 * 9 * k
        line = {"kernel": "concat", "pieces": k, "rows": k,
                **measure(lambda: S.concat_column(pieces),
                          lambda: S.concat_column_plain(pieces),
                          lambda: (torch.cat([p.data for p in pieces]),
                                   torch.cat([p.validity for p in pieces])),
                          nbytes)}
        emit(line)
        summary["concat"] = summarize(line, 0, nbytes)


def phase_kernels(dev) -> dict:
    # a call that launches nothing (an empty gather) reads 0 device ms; the
    # profiler itself must see the card
    require(device_profile(lambda: torch.ones(8, device=dev) + 1)[1] > 0,
            "torch.profiler recorded no device activity")
    rng = np.random.RandomState(2024)
    summary = {}
    masks = check_compaction(rng, dev, summary)
    check_gather(rng, dev, masks, summary)
    check_masked_sum(rng, dev, masks, summary)
    check_concat(rng, dev, summary)
    torch.cuda.synchronize()
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


def phase_q6(dev) -> dict:
    t0 = time.perf_counter()
    batches, revenue, count = [], 0.0, 0
    for chunk in tpch.iter_lineitem(SF10_ROWS, seed=42, batch_rows=N):
        r, c = q6_numpy(chunk)
        revenue += r
        count += c
        batches.append(batch_from_numpy(chunk, tpch.LINEITEM_SCHEMA, dev))
    torch.cuda.synchronize()
    resident = sum(c.data.nbytes + c.validity.nbytes
                   for b in batches for c in b.columns)
    emit({"phase": "q6_data", "rows": SF10_ROWS, "batches": len(batches),
          "resident_bytes": resident,
          "setup_seconds": time.perf_counter() - t0,
          "numpy_revenue": revenue, "numpy_count": count})

    sess = GpuSession()
    require(sess.device.type == "cuda", "session is not on the card")
    df = sess.create_dataframe(batches, num_partitions=4)

    # the main path: counts from 0 just before, read just after
    _lib.reset_launch_counts()
    rows = tpch.q6(df).collect()
    torch.cuda.synchronize()
    launches = dict(_lib.LAUNCHES)
    emit({"phase": "q6_launches", "launches": launches})
    for name in KERNELS:
        require(launches.get(name, 0) > 0, f"q6 never launched {name}")
    require(len(rows) == 1 and rows[0][0] is not None, f"q6 gave {rows}")
    rel = abs(rows[0][0] - revenue) / abs(revenue)
    require(rel <= F64_RTOL_Q6, f"q6 revenue {rows[0][0]} vs numpy {revenue}")

    torch.cuda.reset_peak_memory_stats()
    walls = []
    for _ in range(3):
        t = time.perf_counter()
        tpch.q6(df).collect()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
    wall = statistics.median(walls)
    busy_ms, activities, by_name = device_profile(
        lambda: tpch.q6(df).collect(), calls=1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    emit({"phase": "q6_profile", "device_busy_ms": busy_ms,
          "device_activities": activities,
          "idle_share": 1.0 - busy_ms / (wall * 1e3),
          "top_device_ms": top})
    rows_c = tpch.q6_count(df).collect()
    require(rows_c[0][1] == count, f"q6 count {rows_c[0][1]} vs numpy {count}")
    rel_c = abs(rows_c[0][0] - revenue) / abs(revenue)
    require(rel_c <= F64_RTOL_Q6, f"q6_count revenue {rows_c[0][0]}")
    emit({"phase": "q6", "rows": SF10_ROWS, "revenue": rows[0][0],
          "rel_err": rel, "count": rows_c[0][1], "wall_s": wall,
          "wall_s_runs": walls, "rows_per_s": SF10_ROWS / wall,
          "max_memory_allocated": torch.cuda.max_memory_allocated()})
    return launches


def main() -> None:
    phase_device()
    dev = torch.device("cuda", torch.cuda.current_device())
    phase_build()
    summary = phase_kernels(dev)
    launches = phase_q6(dev)
    kernels = []
    for name, (source, replaces) in KERNELS.items():
        s = summary[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"spark_rapids_tpu_torch/{source}",
            "replaces": replaces, "launches": launches.get(name, 0),
            "max_abs_err": s["max_abs_err"], "ms": s["ms"],
            "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
            "bound_by": "bytes", "library_ms": s["library_ms"]})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
