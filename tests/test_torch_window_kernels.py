"""The window kernels' plain versions (the port's wrappers on CPU tensors)
against the JAX functions they port, called eagerly on the same numpy
inputs.

``window_layout`` against ``kernels/window.py`` ``window_layout`` (and
``row_number``, ``rank``, ``dense_rank`` over it), exact;
``frame_sum_count`` against ``bounded_sum_count`` (``rows_frame_sum`` and
``running_sum_range`` are its frames), int64 sums and counts exact, f64
sums within 1e-12 of the prefix's sum of |x| (both take differences of
prefixes; the reference's prefix spans the whole array);
``range_frame_bounds`` against ``frame_bounds_range``, exact, the int32
wrap and an unsorted run included; ``frame_extreme`` against
``bounded_min_max`` bit for bit: MAX as the function gives it (NaN
propagates), MIN as the reference's exec calls it for a float (NaN
mapped to +inf and left out, then NaN where the frame held only NaN).
Sizes n = 1, 2, 500 and 4,097; segments of one row each, one of all rows,
and random segments with peer runs (every pair for the layout, six of
them for the sums, the bounds and the extremes); the reference runs each
at 4,097 rows, the rows past n a partition of their own, so that it
compiles once a type; 10% nulls; frames empty, clamped at
the partition's ends and unbounded on either side.  The float specials
(NaN, +-inf, -0.0) of a frame sum are held against numpy's own sum of
each frame: the reference's difference of one cumsum turns every frame
after an infinity into NaN (pinned in tests/test_torch_window.py).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_tpu.kernels import window as JW

from spark_rapids_tpu_torch.kernels import window as WK

SIZES = (1, 2, 500, 4097)
SHAPES = ("one", "all", "random")
CASES = [(n, s) for n in SIZES for s in SHAPES]
#: every size and every shape, for the costlier references
FEW_CASES = [(1, "one"), (2, "all"), (500, "random"), (500, "one"),
             (4097, "random"), (4097, "all")]
F64_RTOL = 1e-12
ROWS_FRAMES = ((2, 0), (3, 3), (None, 0), (0, 2), (-1, 1), (None, None),
               (5, -2), (4, None))
RANGE_FRAMES = ((5, 5), (3, 0), (10, -2), (4, 4), (None, 3), (2, None),
                (None, None), (0, 0))
SPECIAL = np.array([np.nan, np.inf, -np.inf, 0.0, -0.0])
#: every reference call runs at this length, the rows past n a partition
#: of their own (nothing of the first n rows changes): one compile a type
PAD = max(SIZES)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for these tests' small tensors: under
    pytest-xdist the workers share the cores, and each torch op's thread
    pool then waits on the others (a 4,097-row plain kernel ran 130x
    slower in 6 processes at once)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _flags(n: int, shape: str, rng):
    """(partition boundaries, peer boundaries) at sorted positions."""
    if shape == "one":
        part = np.ones(n, np.bool_)
    elif shape == "all":
        part = np.zeros(n, np.bool_)
    else:
        part = rng.rand(n) < 0.02
    part[0] = True
    peer = part | (rng.rand(n) < 0.3)
    return part, peer


def _pad(a: np.ndarray, fill) -> np.ndarray:
    """The first n rows, then ``fill`` up to PAD rows."""
    return np.concatenate([a, np.full(PAD - len(a), fill, a.dtype)])


# The JAX functions run under jax.jit (their eager ops compile per call):
# a layout travels as the tuple of its arrays.

def _fields(jl):
    return tuple(getattr(jl, f.name)
                 for f in JW.dataclasses.fields(JW.WindowLayout))


@jax.jit
def _j_layout(part, peer):
    return _fields(JW.window_layout(part, peer, jnp.ones_like(part)))


@functools.partial(jax.jit, static_argnums=(5,))
def _j_sum_count(vals, valid, arrays, lo, up, dtype):
    return JW.bounded_sum_count(vals, valid, JW.WindowLayout(*arrays), lo,
                                up, dtype)


@jax.jit
def _j_range(key, arrays, pre, fol, has_pre, has_fol):
    """frame_bounds_range with each offset a scalar of the key's type, as
    the function's python int is (weak type: it wraps with the key); an
    unbounded side is the partition's end, as the function's None gives
    it (so one compile serves every frame)."""
    layout = JW.WindowLayout(*arrays)
    lo, up = JW.frame_bounds_range(key, layout, pre, fol)
    return (jnp.where(has_pre, lo, layout.seg_start),
            jnp.where(has_fol, up, layout.seg_end - 1))


@functools.partial(jax.jit, static_argnums=(5,))
def _j_min_max(vals, valid, arrays, lo, up, is_min):
    return JW.bounded_min_max(vals, valid, JW.WindowLayout(*arrays), lo, up,
                              is_min)[0]


def _layouts(n: int, shape: str, seed: int = 0):
    """rng, the reference's layout of the PAD rows, the port's of n."""
    rng = np.random.RandomState(seed + n)
    part, peer = _flags(n, shape, rng)
    padded = _pad(part, False)
    padded[n:n + 1] = True
    jl = JW.WindowLayout(*_j_layout(jnp.asarray(padded),
                                    jnp.asarray(padded | _pad(peer, False))))
    pl = WK.window_layout(torch.from_numpy(part), torch.from_numpy(peer))
    return rng, jl, pl


def _random_frames(rng, jl):
    """Frames inside each row's partition: random bounds, a fifth of
    them empty."""
    start, end = np.asarray(jl.seg_start), np.asarray(jl.seg_end)
    size = end - start
    lower = start + rng.randint(0, 1 << 30, len(start)) % size
    upper = start + rng.randint(0, 1 << 30, len(start)) % size
    lower, upper = np.minimum(lower, upper), np.maximum(lower, upper)
    empty = rng.rand(len(start)) < 0.2
    lower = np.where(empty, upper + 1, lower)
    return lower.astype(np.int32), upper.astype(np.int32)


def _frames(rng, jl, pl):
    """(name, lower, upper, max_len) of PAD rows from the reference's
    layout (the port's frames are their first n): ROWS frames (held
    against the port's ``frame_bounds_rows``), the running frame, the
    whole partition, random frames."""
    n = pl.n
    out = []
    for pre, fol in ROWS_FRAMES:
        lo, up = (np.array(b) for b in JW.frame_bounds_rows(jl, pre, fol))
        plo, pup = WK.frame_bounds_rows(pl, pre, fol)
        np.testing.assert_array_equal(plo.numpy(), lo[:n])
        np.testing.assert_array_equal(pup.numpy(), up[:n])
        bounded = pre is not None and fol is not None
        out.append((f"rows{pre},{fol}", lo, up,
                    max(pre + fol + 1, 1) if bounded else None))
    out.append(("running", np.array(jl.seg_start), np.array(jl.run_last),
                None))
    out.append(("whole", np.array(jl.seg_start), np.array(jl.seg_end) - 1,
                None))
    lo, up = _random_frames(rng, jl)
    out.append(("random", lo, up, None))
    return out


def _t(a: np.ndarray, n: int) -> torch.Tensor:
    """The port's input: the first n rows."""
    return torch.from_numpy(np.ascontiguousarray(a[:n]))


@pytest.mark.parametrize("n,shape", CASES)
def test_window_layout(n, shape):
    _, jl, pl = _layouts(n, shape)
    for name in ("seg_start", "seg_end", "run_id", "run_first",
                 "run_last"):
        got = getattr(pl, name)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(
            getattr(jl, name))[:n], err_msg=name)
    for fn in ("row_number", "rank", "dense_rank"):
        np.testing.assert_array_equal(
            getattr(WK, fn)(pl).numpy(),
            np.asarray(getattr(JW, fn)(jl))[:n], err_msg=fn)


def test_window_layout_of_no_rows():
    e = torch.empty(0, dtype=torch.bool)
    layout = WK.window_layout(e, e)
    assert layout.n == 0 and layout.seg_end.dtype == torch.int32


def _int64_values(rng, n):
    v = rng.randint(-2**63, 2**63 - 1, n, dtype=np.int64)
    v[rng.rand(n) < 0.05] = 2**63 - 1
    return v


@pytest.mark.parametrize("n,shape", FEW_CASES)
@pytest.mark.parametrize("dtype", ["int64", "float64"])
def test_frame_sum_count(n, shape, dtype):
    rng, jl, pl = _layouts(n, shape, seed=1)
    vals = (_int64_values(rng, n) if dtype == "int64"
            else rng.randn(n) * 1e3)
    valid = rng.rand(n) >= 0.1
    vals = _pad(np.where(valid, vals, np.zeros((), vals.dtype)), 0)
    valid = _pad(valid, False)
    jdt = jnp.int64 if dtype == "int64" else jnp.float64
    prefix_abs = np.cumsum(np.abs(vals.astype(np.float64)))
    for name, lo, up, _ in _frames(rng, jl, pl):
        js, jn = _j_sum_count(jnp.asarray(vals), jnp.asarray(valid),
                              _fields(jl), jnp.asarray(lo), jnp.asarray(up),
                              jdt)
        ps, pn = WK.frame_sum_count(_t(vals, n), _t(valid, n), pl.seg_start,
                                    _t(lo, n), _t(up, n))
        np.testing.assert_array_equal(pn.numpy(), np.asarray(jn)[:n],
                                      err_msg=name)
        js = np.asarray(js)[:n]
        if dtype == "int64":
            np.testing.assert_array_equal(ps.numpy(), js, err_msg=name)
        else:
            tol = F64_RTOL * prefix_abs[np.clip(up[:n], 0, n - 1)]
            assert (np.abs(ps.numpy() - js) <= tol).all(), name


@pytest.mark.parametrize("n", SIZES)
def test_frame_sum_specials_against_numpy(n):
    """NaN, +-inf and -0.0 in the frames: the port's sum is numpy's sum of
    the frame's valid values (exact where it is not finite, within 1e-12
    of the frame's sum of |x| where it is)."""
    rng, jl, pl = _layouts(n, "random", seed=2)
    vals = rng.randn(n) * 1e3
    special = rng.rand(n) < 0.05
    vals[special] = rng.choice(SPECIAL, special.sum())
    valid = rng.rand(n) >= 0.1
    for name, lo, up, _ in _frames(rng, jl, pl):
        ps, pn = WK.frame_sum_count(
            torch.from_numpy(vals), torch.from_numpy(valid), pl.seg_start,
            _t(lo, n), _t(up, n))
        for i in range(n):
            x = vals[lo[i]:max(up[i] + 1, lo[i])]
            x = x[valid[lo[i]:lo[i] + len(x)]]
            assert pn[i] == len(x), (name, i)
            want = np.sum(x) if len(x) else 0.0
            got = float(ps[i])
            if not np.isfinite(want):
                assert got == want or (np.isnan(want) and np.isnan(got)), \
                    (name, i, got, want)
            else:
                fin = x[np.isfinite(x)]
                assert abs(got - want) <= F64_RTOL * np.abs(fin).sum(), \
                    (name, i, got, want)


def _sorted_keys(key: np.ndarray, pl) -> np.ndarray:
    """The key ascending within each of the port's partitions."""
    return key[np.lexsort((key, pl.seg_start.numpy()))]


@pytest.mark.parametrize("n,shape", FEW_CASES)
@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_range_frame_bounds(n, shape, dtype):
    rng, jl, pl = _layouts(n, shape, seed=3)
    info = np.iinfo(dtype)
    keys = {"small": _sorted_keys(rng.randint(-40, 40, n).astype(dtype), pl)}
    # near the type's ends: key - preceding and key + following wrap
    edges = rng.randint(info.min, info.max, n, dtype=np.int64).astype(dtype)
    edges[:min(n, 2)] = info.min
    edges[n - min(n, 2):] = info.max
    keys["edges"] = _sorted_keys(edges, pl)
    # a null order key sorts first with its zeroed data: the run is not
    # sorted there, and both packages search it all the same
    keys["null_first"] = keys["small"].copy()
    keys["null_first"][pl.seg_start.numpy()] = 0
    for kname, key in keys.items():
        for pre, fol in RANGE_FRAMES:
            jlo, jup = _j_range(jnp.asarray(_pad(key, 0)), _fields(jl),
                                dtype(pre or 0), dtype(fol or 0),
                                pre is not None, fol is not None)
            plo, pup = WK.range_frame_bounds(torch.from_numpy(key),
                                             pl.seg_start, pl.seg_end, pre,
                                             fol)
            np.testing.assert_array_equal(plo.numpy(), np.asarray(jlo)[:n],
                                          err_msg=f"{kname} {pre},{fol}")
            np.testing.assert_array_equal(pup.numpy(), np.asarray(jup)[:n],
                                          err_msg=f"{kname} {pre},{fol}")


EXTREME_DTYPES = {"bool": np.bool_, "int32": np.int32, "int64": np.int64,
                  "float32": np.float32, "float64": np.float64}
#: ROWS frames the extremes leave out: the others are clamped, empty and
#: unbounded on either side, and "whole" is ROWS None..None
EXTREME_SKIP = ("rows3,3", "rows0,2", "rowsNone,None")


def _extreme_values(rng, n, dtype):
    if dtype == np.bool_:
        return rng.rand(n) < 0.5
    if dtype in (np.float32, np.float64):
        v = rng.randn(n) * 100
        special = rng.rand(n) < 0.1
        v[special] = rng.choice(SPECIAL, special.sum())
        return v.astype(dtype)
    return rng.randint(np.iinfo(dtype).min, np.iinfo(dtype).max, n,
                       dtype=np.int64).astype(dtype)


def _jax_extreme(vals, valid, jl, lo, up, is_min):
    """The reference's MIN / MAX over [lo, up]: ``bounded_min_max`` as its
    exec calls it (plan/execs/window.py:198-227)."""
    lo, up, arrays = jnp.asarray(lo), jnp.asarray(up), _fields(jl)
    floating = vals.dtype in (np.float32, np.float64)
    if not (floating and is_min):
        return np.asarray(_j_min_max(jnp.asarray(vals), jnp.asarray(valid),
                                     arrays, lo, up, is_min))
    nan = np.isnan(vals)
    v = _j_min_max(jnp.asarray(np.where(nan, np.inf, vals)
                               .astype(vals.dtype)),
                   jnp.asarray(valid & ~nan), arrays, lo, up, True)
    zeros = jnp.zeros(len(vals), jnp.float64)
    _, cnt = _j_sum_count(zeros, jnp.asarray(valid), arrays, lo, up,
                          jnp.float64)
    _, cnt_num = _j_sum_count(zeros, jnp.asarray(valid & ~nan), arrays, lo,
                              up, jnp.float64)
    only_nan = (np.asarray(cnt) > 0) & (np.asarray(cnt_num) == 0)
    return np.where(only_nan, np.array(np.nan, vals.dtype), np.asarray(v))


def _bits(a: np.ndarray) -> np.ndarray:
    a = np.asarray(a)
    if a.dtype == np.bool_:
        return a.astype(np.int8)
    if a.dtype == np.float32:
        return np.where(np.isnan(a), np.float32(np.nan), a).view(np.int32)
    if a.dtype == np.float64:
        return np.where(np.isnan(a), np.nan, a).view(np.int64)
    return a


@pytest.mark.parametrize("dtype", list(EXTREME_DTYPES))
@pytest.mark.parametrize("is_min", [True, False], ids=["min", "max"])
def test_frame_extreme(dtype, is_min):
    for n, shape in FEW_CASES:
        rng, jl, pl = _layouts(n, shape, seed=4)
        vals = _extreme_values(rng, n, EXTREME_DTYPES[dtype])
        valid = rng.rand(n) >= 0.1
        vals_p, valid_p = _pad(vals, vals[0]), _pad(valid, False)
        for name, lo, up, max_len in _frames(rng, jl, pl):
            if name in EXTREME_SKIP:
                continue
            want = _jax_extreme(vals_p, valid_p, jl, lo, up, is_min)[:n]
            got, nonempty = WK.frame_extreme(
                torch.from_numpy(vals), torch.from_numpy(valid), _t(lo, n),
                _t(up, n), is_min, max_len)
            np.testing.assert_array_equal(nonempty.numpy(), up[:n] >= lo[:n])
            np.testing.assert_array_equal(
                _bits(got.numpy()), _bits(want.astype(got.numpy().dtype)),
                err_msg=f"{n} {shape} {name}")
