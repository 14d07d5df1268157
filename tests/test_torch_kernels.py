"""The port's kernel wrappers against their JAX counterparts, on the CPU.

On CPU tensors each wrapper runs its plain PyTorch version; the CUDA
kernels are held against those plain versions on the card by
chip_smoke.py.  Inputs are made from a numpy seed and fed to both
packages.  Compaction, gather, concat and integer results must match
exactly; float sums within 1e-12 relative, because the two packages add
in different orders.
"""
import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu import types as JT
from spark_rapids_tpu.columnar.batch import ColumnarBatch as JaxBatch
from spark_rapids_tpu.columnar.column import DeviceColumn as JaxColumn
from spark_rapids_tpu.expressions.aggregates import (
    COUNT_STAR as J_COUNT_STAR, COUNT_VALID as J_COUNT_VALID, M2 as J_M2,
    MAX as J_MAX, MIN as J_MIN, SUM as J_SUM)
from spark_rapids_tpu.kernels import selection as jsel
from spark_rapids_tpu.plan.execs.aggregate import (
    _global_m2_merge as jax_global_m2_merge,
    _global_update as jax_global_update)

from spark_rapids_tpu_torch import types as PT
from spark_rapids_tpu_torch.columnar.arrow import arrow_to_batch
from spark_rapids_tpu_torch.columnar.column import DeviceColumn
from spark_rapids_tpu_torch.expressions.aggregates import (
    COUNT_STAR, COUNT_VALID, M2, MAX, MIN, SUM)
from spark_rapids_tpu_torch.kernels import reduction as R
from spark_rapids_tpu_torch.kernels import selection as S
from spark_rapids_tpu_torch.plan.execs.aggregate import (
    _global_m2_merge, _global_update, _Sums)

F64_RTOL = 1e-12


def _table(n: int, seed: int, null_frac: float = 0.1) -> pa.Table:
    rng = np.random.RandomState(seed)

    def mask():
        return rng.rand(n) < null_frac
    return pa.table({
        "i": pa.array(rng.randint(-1000, 1000, n).astype(np.int32),
                      mask=mask()),
        "l": pa.array(rng.randint(-2**62, 2**62, n, dtype=np.int64),
                      mask=mask()),
        "d": pa.array(rng.uniform(0, 1e5, n), mask=mask()),
        "b": pa.array(rng.rand(n) < 0.5, mask=mask()),
        "dt": pa.array(rng.randint(0, 20_000, n).astype(np.int32),
                       mask=mask()).cast(pa.date32()),
    })


@pytest.mark.parametrize("n,p", [(1, 1.0), (1_000, 0.0), (1_000, 0.018),
                                 (4_097, 0.5), (4_097, 1.0)])
def test_compaction_map_matches_reference(n, p):
    mask = np.random.RandomState(n).rand(n) < p
    ref_idx, ref_count = jsel.compaction_map(jnp.asarray(mask))
    idx, count = S.compaction_map(torch.from_numpy(mask))
    assert count == int(ref_count)
    assert idx.dtype == torch.int32 and idx.shape == (count,)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx)[:count])


@pytest.mark.parametrize("n,seed", [(1, 1), (700, 2), (2_049, 3)])
def test_gather_batch_matches_reference(n, seed):
    table = _table(n, seed)
    rng = np.random.RandomState(seed)
    # a sorted subset, repeats, and row ids out of range -> null rows
    idx = np.concatenate([np.sort(rng.choice(n, (n + 1) // 2, replace=False)),
                          rng.randint(0, n, 5), [-1, n, 2**31 - 1]]
                         ).astype(np.int32)
    ref_in = JaxBatch.from_arrow(table)
    cap = max(len(idx), ref_in.capacity)
    ref_idx = np.full((cap,), 2**31 - 1, np.int32)
    ref_idx[:len(idx)] = idx
    ref = jsel.gather_batch(ref_in, jnp.asarray(ref_idx),
                            jnp.int32(len(idx)), out_capacity=cap)
    port = S.gather_batch(arrow_to_batch(table, "cpu"), torch.from_numpy(idx))
    assert port.num_rows == len(idx)
    assert port.to_arrow().equals(ref.to_arrow())
    for c in port.columns:      # null rows carry zero data
        assert not c.data[~c.validity].any()


@pytest.mark.parametrize("sizes", [[1] * 7, [3, 0, 5, 1], [0], [257, 64]])
def test_concat_matches_reference(sizes):
    tables = [_table(s, 10 + i) for i, s in enumerate(sizes)]
    ref_in = [JaxBatch.from_arrow(t) for t in tables]
    cap = max(sum(sizes), 1)
    ref, status = jsel.concat_batches_device(ref_in, cap)
    assert int(status.required_rows) == sum(sizes)
    port = S.concat_batches_device([arrow_to_batch(t, "cpu") for t in tables])
    assert port.num_rows == sum(sizes)
    assert port.to_arrow().equals(ref.to_arrow())


def _reduce_inputs(kind: str, dtype, seed: int):
    rng = np.random.RandomState(seed)
    n = {"empty": 0, "one_row": 1, "all_null": 300, "nulls": 5_000}[kind]
    if dtype == "double":
        vals = rng.uniform(0, 1e5, n)
    else:
        vals = rng.randint(-2**62, 2**62, n, dtype=np.int64)  # sums wrap
    valid = np.zeros(n, np.bool_) if kind == "all_null" \
        else rng.rand(n) >= (0.1 if kind == "nulls" else 0.0)
    vals = np.where(valid, vals, 0)
    return vals, valid


@pytest.mark.parametrize("op", ["sum", "count_star", "count_valid"])
@pytest.mark.parametrize("dtype", ["double", "long"])
@pytest.mark.parametrize("kind", ["empty", "one_row", "all_null", "nulls"])
def test_global_update_matches_reference(op, dtype, kind):
    vals, valid = _reduce_inputs(kind, dtype, seed=len(kind))
    n = len(vals)
    jt, pt = (JT.DOUBLE, PT.DOUBLE) if dtype == "double" else (JT.LONG,
                                                                PT.LONG)
    jop, pop = {"sum": (J_SUM, SUM), "count_star": (J_COUNT_STAR, COUNT_STAR),
                "count_valid": (J_COUNT_VALID, COUNT_VALID)}[op]
    out_j, out_p = (jt, pt) if op == "sum" else (JT.LONG, PT.LONG)
    cap = max(n, 1)
    jcol = JaxColumn.from_numpy(vals, jt, valid, capacity=cap)
    live = jnp.arange(cap) < n
    ref_v, ref_ok = jax_global_update(jop, jcol, live, out_j)
    pcol = DeviceColumn.from_numpy(vals, pt, valid, "cpu")
    got = _global_update(pop, pcol, n, out_p, "cpu")
    assert got.num_rows == 1 and got.dtype == out_p
    assert bool(got.validity[0]) == bool(ref_ok)
    ref_v = np.asarray(ref_v).item() if bool(ref_ok) else 0
    if out_p == PT.DOUBLE:
        np.testing.assert_allclose(got.data.item(), ref_v, rtol=F64_RTOL)
    else:
        assert got.data.item() == ref_v


_EXTREME_TYPES = {"int": (JT.INT, PT.INT), "long": (JT.LONG, PT.LONG),
                  "double": (JT.DOUBLE, PT.DOUBLE),
                  "float": (JT.FLOAT, PT.FLOAT),
                  "bool": (JT.BOOLEAN, PT.BOOLEAN)}


def _extreme_inputs(kind: str, dtype: str, seed: int):
    """Values of the type with NaN, infinities and both zeros among the
    floats; ``all_nan`` holds only NaNs (MIN is NaN there)."""
    rng = np.random.RandomState(seed)
    n = {"empty": 0, "one_row": 1, "all_null": 300, "nulls": 5_000,
         "all_nan": 40}[kind]
    if dtype in ("double", "float"):
        vals = rng.randn(n) * 1e3
        vals[rng.rand(n) < 0.05] = np.nan
        vals[rng.rand(n) < 0.02] = np.inf
        vals[rng.rand(n) < 0.02] = -0.0
        if kind == "all_nan":
            vals[:] = np.nan
        vals = vals.astype(np.float32 if dtype == "float" else np.float64)
    elif dtype == "bool":
        vals = rng.rand(n) < 0.5
    elif dtype == "int":
        vals = rng.randint(-2**31, 2**31 - 1, n, dtype=np.int64).astype(
            np.int32)
    else:
        vals = rng.randint(-2**63, 2**63 - 1, n, dtype=np.int64)
    valid = np.zeros(n, np.bool_) if kind == "all_null" \
        else rng.rand(n) >= (0.1 if kind == "nulls" else 0.0)
    return np.where(valid, vals, np.zeros((), vals.dtype)), valid


_GLOBAL_CASES = [(op, dtype, kind)
                 for op in ("min", "max", "m2")
                 for dtype in _EXTREME_TYPES if op != "m2" or dtype != "bool"
                 for kind in ("empty", "one_row", "all_null", "nulls")
                 + (("all_nan",) if dtype in ("double", "float") else ())]


@pytest.mark.parametrize("op,dtype,kind", _GLOBAL_CASES)
def test_global_extreme_and_m2_match_reference(op, dtype, kind):
    """_global_update's MIN / MAX (exact, bits of floats) and M2 (within
    1e-12 relative) against the reference's on the same input."""
    vals, valid = _extreme_inputs(kind, dtype, seed=len(kind) + len(dtype))
    n = len(vals)
    jt, pt = _EXTREME_TYPES[dtype]
    jop, pop = {"min": (J_MIN, MIN), "max": (J_MAX, MAX),
                "m2": (J_M2, M2)}[op]
    out_p = PT.DOUBLE if op == "m2" else pt
    cap = max(n, 1)
    jcol = JaxColumn.from_numpy(vals, jt, valid, capacity=cap)
    ref_v, ref_ok = jax_global_update(jop, jcol, jnp.arange(cap) < n,
                                      JT.DOUBLE if op == "m2" else jt)
    got = _global_update(pop, DeviceColumn.from_numpy(vals, pt, valid, "cpu"),
                         n, out_p, "cpu")
    assert got.num_rows == 1 and got.dtype == out_p
    assert bool(got.validity[0]) == bool(ref_ok)
    if not bool(ref_ok):
        assert got.data.item() == 0
        return
    ref_v = np.asarray(ref_v).reshape(1)
    if op == "m2":
        np.testing.assert_allclose(got.data.numpy(), ref_v, rtol=F64_RTOL,
                                   equal_nan=True)
    else:
        got_v = got.data.numpy()
        assert got_v.dtype == ref_v.dtype
        if got_v.dtype.kind == "f":
            got_v = got_v.view({4: np.int32, 8: np.int64}[got_v.itemsize])
            ref_v = ref_v.view(got_v.dtype)
        np.testing.assert_array_equal(got_v, ref_v)


@pytest.mark.parametrize("rows", [0, 1, 57, 4_000])
def test_global_m2_merge_matches_reference(rows):
    """Chan's merge of partial (M2, sum, count) rows to one group, partials
    with count 0 among them (null M2, sum 0)."""
    rng = np.random.RandomState(rows)
    cnt = rng.randint(0, 5_000, rows).astype(np.int64)
    cnt[rng.rand(rows) < 0.1] = 0
    ok = cnt > 0
    s = np.where(ok, rng.randn(rows) * 1e6, 0.0)
    m2 = np.where(ok, rng.rand(rows) * 1e9, 0.0)
    cap = max(rows, 1)
    jcols = [JaxColumn.from_numpy(v, t, valid, capacity=cap) for v, t, valid
             in ((m2, JT.DOUBLE, ok), (s, JT.DOUBLE, ok),
                 (cnt, JT.LONG, np.ones(rows, np.bool_)))]
    ref_v, ref_ok = jax_global_m2_merge(*jcols, jnp.arange(cap) < rows)
    pcols = [DeviceColumn.from_numpy(v, t, valid, "cpu") for v, t, valid
             in ((m2, PT.DOUBLE, ok), (s, PT.DOUBLE, ok),
                 (cnt, PT.LONG, np.ones(rows, np.bool_)))]
    got = _global_m2_merge(*pcols, _Sums())
    assert bool(got.validity[0]) == bool(ref_ok)
    np.testing.assert_allclose(got.data.numpy(), np.asarray(ref_v).reshape(1),
                               rtol=F64_RTOL)


def test_masked_sum_flag_and_count():
    data = torch.tensor([1.5, 2.5, 4.0], dtype=torch.float64)
    value, ok, nvalid = R.masked_sum(data, torch.tensor([True, False, True]))
    assert value.item() == 5.5 and ok.item() and nvalid.item() == 2
    value, ok, nvalid = R.masked_sum(data, torch.zeros(3, dtype=torch.bool))
    assert value.item() == 0.0 and not ok.item() and nvalid.item() == 0


def test_wrappers_never_fall_back_off_the_cpu():
    """A tensor that is not on the CPU goes to the CUDA path, which raises
    for anything but a CUDA tensor: there is no quiet plain fallback."""
    meta = torch.empty(8, dtype=torch.bool, device="meta")
    with pytest.raises(ValueError, match="expected cuda"):
        S.compaction_map(meta)
    with pytest.raises(ValueError, match="expected cuda"):
        R.masked_sum(torch.empty(8, dtype=torch.float64, device="meta"),
                     meta)
    col = DeviceColumn(torch.empty(8, dtype=torch.int64, device="meta"),
                       meta, PT.LONG)
    with pytest.raises(ValueError, match="expected cuda"):
        S.gather_columns([col], torch.empty(2, dtype=torch.int32,
                                            device="meta"))
    with pytest.raises(ValueError, match="expected cuda"):
        S.concat_column([col, col])
    assert not S._lib.LAUNCHES
