"""The port's Decimal128 kernels' plain versions against the JAX package's
``spark_rapids_tpu/kernels/decimal.py``, on the CPU, exactly.

``decimal128_binary`` (add, subtract, multiply, rescale, to double),
``decimal128_divide`` (the 256-bit quotient, the small divisor and the
rescale down), ``segmented_sum128`` / ``masked_sum128`` and
``segmented_extreme128`` / ``masked_extreme128``: on CPU tensors each
wrapper runs its plain PyTorch version, which must give the reference
function's limbs and nulls on the same seeded limbs, edges included:
+-(10**38 - 1), -2**127, 2**127 - 1, sums and products at the precision
edge, HALF_UP ties of +-0.5 ulp, zero divisors, segments of one row and
all-null segments.  Tolerance 0 throughout.  chip_smoke.py holds the
CUDA kernels to these plain versions on the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_tpu.kernels import decimal as JD

from spark_rapids_tpu_torch.columnar.column import const128, to_python
from spark_rapids_tpu_torch.kernels import decimal as DK
from spark_rapids_tpu_torch.kernels import reduction as R

TOP = 10 ** 38 - 1
MIN128 = -(1 << 127)
EDGES = [0, 1, -1, 5, -5, 15, -15, 25, -25, TOP, -TOP, MIN128, (1 << 127) - 1,
         10 ** 37, -(10 ** 37), 10 ** 19, -(10 ** 19), (1 << 63) - 1,
         -(1 << 63), 10 ** 18 - 1]


def values(rng, n: int, bound_digits: int = 38, edges=True) -> list:
    """n seeded Python ints of up to ``bound_digits`` digits, of every
    magnitude, the edges first."""
    out = [e for e in EDGES if abs(e) < 10 ** bound_digits] if edges else []
    while len(out) < n:
        digits = int(rng.randint(0, bound_digits + 1))
        hi = 10 ** digits
        v = int(rng.randint(0, 2**62)) * int(rng.randint(0, 2**62)) % hi
        out.append(-v if rng.rand() < 0.5 else v)
    return out[:n]


def plane(vals) -> torch.Tensor:
    return torch.tensor([const128(v) for v in vals],
                        dtype=torch.int64).reshape(-1, 2)


def jlimbs(vals):
    """(hi, lo) jnp planes, the reference's order."""
    p = plane(vals).numpy()
    return jnp.asarray(p[:, 1]), jnp.asarray(p[:, 0])


def ints(out: torch.Tensor, valid: torch.Tensor) -> list:
    return [to_python(lo, hi) if ok else None
            for (lo, hi), ok in zip(out.tolist(), valid.tolist())]


def jints(h, l, ok) -> list:
    return [JD.to_python(a, b) if m else None
            for a, b, m in zip(np.asarray(h), np.asarray(l), np.asarray(ok))]


def valid_of(rng, n):
    v = torch.from_numpy(rng.rand(n) >= 0.1)
    v[:len(EDGES)] = True
    return v


@pytest.mark.parametrize("op", ["add", "sub"])
@pytest.mark.parametrize("ka,kb,precision", [(0, 0, 38), (0, 0, 20),
                                             (4, 0, 38), (0, 13, 30),
                                             (2, 9, 38)])
def test_add_sub_match_reference(op, ka, kb, precision):
    """(a * 10**ka) +- (b * 10**kb), null past ``precision``: the
    reference's rescale, add128 / sub128 and overflow."""
    rng = np.random.RandomState(ka * 7 + kb + precision)
    n = 600
    a = values(rng, n, 38 - ka)
    b = values(rng, n, 38 - kb)[::-1]
    va, vb = valid_of(rng, n), valid_of(rng, n)
    got, ok = DK.decimal128_binary(DK.ADD if op == "add" else DK.SUB,
                                   plane(a), va, plane(b), vb, ka, kb,
                                   precision)
    ah, al = JD.rescale(*jlimbs(a), 0, ka)
    bh, bl = JD.rescale(*jlimbs(b), 0, kb)
    h, l = (JD.add128 if op == "add" else JD.sub128)(ah, al, bh, bl)
    ref_ok = (va.numpy() & vb.numpy()
              & ~np.asarray(JD.overflow(h, l, precision)))
    assert ints(got, ok) == jints(h, l, ref_ok)


@pytest.mark.parametrize("precision", [38, 26, DK.INT128])
def test_checked_multiply_matches_reference(precision):
    """Products at and past the precision edge: ``mul128_checked``'s exact
    overflow (the 256-bit magnitude), then ``overflow`` at the result
    precision; one-limb operands are widened."""
    rng = np.random.RandomState(precision + 3)
    n = 700
    a = values(rng, n)
    b = values(rng, n, 20)[::-1]
    b[:8] = [10 ** 13, -(10 ** 13), 10 ** 12, 2, -2, 1, 0, 10 ** 19]
    va, vb = valid_of(rng, n), valid_of(rng, n)
    got, ok = DK.decimal128_binary(DK.MUL, plane(a), va, plane(b), vb,
                                   precision=precision)
    h, l, over = JD.mul128_checked(*jlimbs(a), *jlimbs(b))
    ref_ok = va.numpy() & vb.numpy() & ~np.asarray(over)
    if precision > 0:
        ref_ok &= ~np.asarray(JD.overflow(h, l, precision))
    assert ints(got, ok) == jints(h, l, ref_ok)
    # Decimal64 operands: the same products of their widened values
    small = [v % 10 ** 18 * (1 if i % 3 else -1) for i, v in enumerate(a)]
    got64, ok64 = DK.decimal128_binary(DK.MUL, torch.tensor(small), va,
                                       plane(b), vb, precision=precision)
    want, want_ok = DK.decimal128_binary(DK.MUL, plane(small), va, plane(b),
                                         vb, precision=precision)
    assert torch.equal(got64, want) and torch.equal(ok64, want_ok)


@pytest.mark.parametrize("k", [0, 1, 4, 18, 19, 38])
def test_rescale_up_matches_reference(k):
    """RESCALE in WRAP mode is the reference's wrapping ``rescale`` bit for
    bit over every input; with a precision it nulls what passes it."""
    rng = np.random.RandomState(k)
    n = 500
    a = values(rng, n)
    va = valid_of(rng, n)
    h, l = JD.rescale(*jlimbs(a), 0, k)
    got, ok = DK.decimal128_binary(DK.RESCALE, plane(a), va, ka=k,
                                   precision=DK.WRAP)
    assert torch.equal(ok, va)
    assert ints(got, ok) == jints(h, l, va.numpy())
    fit = values(rng, n, 38 - k)
    h, l = JD.rescale(*jlimbs(fit), 0, k)
    for p in (38, 30):
        got, ok = DK.decimal128_binary(DK.RESCALE, plane(fit), va, ka=k,
                                       precision=p)
        ref_ok = va.numpy() & ~np.asarray(JD.overflow(h, l, p))
        assert ints(got, ok) == jints(h, l, ref_ok)


@pytest.mark.parametrize("scale", [0, 2, 4, 17, 38])
def test_to_double_matches_reference(scale):
    """``to_double(v) / 10.0**scale`` bit for bit, -2**127 and
    10**38 - 1 included."""
    rng = np.random.RandomState(scale + 40)
    a = values(rng, 500)
    va = valid_of(rng, 500)
    got, ok = DK.decimal128_binary(DK.TO_DOUBLE, plane(a), va, ka=scale)
    want = np.asarray(JD.to_double(*jlimbs(a))) / (10.0 ** scale)
    want = np.where(va.numpy(), want, 0.0)
    assert torch.equal(ok, va)
    np.testing.assert_array_equal(got.numpy().view(np.int64),
                                  want.view(np.int64))


@pytest.mark.parametrize("shift,precision", [(0, 38), (13, 38), (15, 38),
                                             (38, 38), (40, 38), (6, 16),
                                             (13, DK.INT128)])
def test_divide_matches_reference(shift, precision):
    """``div128_by_128``: (a * 10**shift) / b with one HALF_UP rounding,
    zero divisors, ties at +-0.5 ulp, a two-staged shift past 38 and
    quotients past the precision, all null as the reference's are."""
    rng = np.random.RandomState(shift * 3 + precision)
    n = 400
    a = values(rng, n)
    b = values(rng, n, 19)[::-1]
    a[:6] = [5, -5, 15, -25, 1, -1]
    b[:6] = [10, 10, -10, 10, 2, 2]          # exact ties of 0.5
    b[6:9] = [0, 0, 0]
    va, vb = valid_of(rng, n), valid_of(rng, n)
    got, ok = DK.decimal128_divide(plane(a), va, plane(b), vb, shift,
                                   precision)
    h, l, over, zero = JD.div128_by_128(*jlimbs(a), *jlimbs(b), shift)
    ref_ok = (va.numpy() & vb.numpy() & ~np.asarray(zero)
              & ~np.asarray(over))
    if precision > 0:
        ref_ok &= ~np.asarray(JD.overflow(h, l, precision))
    assert ints(got, ok) == jints(h, l, ref_ok)


@pytest.mark.parametrize("half_up", [True, False])
def test_small_divisor_matches_reference(half_up):
    """``div128_small`` by a per-row count (avg's finalize) and the cast's
    truncating steps: a one-limb int64 divisor column."""
    rng = np.random.RandomState(int(half_up))
    n = 500
    a = values(rng, n, 37)
    d = rng.randint(1, 2**31, n).astype(np.int64)
    d[:5] = [1, 2, 3, 10, 2**31 - 1]
    ones = torch.ones(n, dtype=torch.bool)
    got, ok = DK.decimal128_divide(plane(a), ones, torch.from_numpy(d), ones,
                                   half_up=half_up, precision=DK.INT128)
    h, l = JD.div128_small(*jlimbs(a), jnp.asarray(d), half_up)
    assert ok.all()
    assert ints(got, ok) == jints(h, l, np.ones(n, bool))


@pytest.mark.parametrize("drop", [1, 9, 10, 20])
def test_rescale_down_matches_reference(drop):
    """A constant divisor 10**drop with HALF_UP: the reference's rescale
    down (truncating 10**9 steps, one HALF_UP last step)."""
    rng = np.random.RandomState(drop + 9)
    a = values(rng, 400)
    a[:4] = [5 * 10 ** (drop - 1), -5 * 10 ** (drop - 1),
             5 * 10 ** (drop - 1) - 1, 15 * 10 ** (drop - 1)]
    va = valid_of(rng, 400)
    got, ok = DK.decimal128_divide(plane(a), va, 10 ** drop,
                                   precision=DK.INT128)
    h, l = JD.rescale(*jlimbs(a), drop, 0)
    assert torch.equal(ok, va)
    assert ints(got, ok) == jints(h, l, va.numpy())


def test_divide_fuzz_against_python_ints():
    """The reference test's fuzz at kernel level: random magnitudes, signs,
    zero divisors and quotients past the precision, against Python's
    exact HALF_UP division."""
    rng = np.random.RandomState(7)
    n = 300
    a = [int(x) * int(10 ** int(e)) for x, e in zip(
        rng.randint(-10**9, 10**9, n), rng.randint(0, 12, n))]
    b = [int(x) * int(10 ** int(e)) for x, e in zip(
        rng.randint(-10**6, 10**6, n), rng.randint(0, 6, n))]
    b[::17] = [0] * len(b[::17])
    shift, precision = 15 - 4 + 2, 38     # decimal(25,4) / decimal(12,2)
    ones = torch.ones(n, dtype=torch.bool)
    got, ok = DK.decimal128_divide(plane(a), ones, torch.tensor(b), ones,
                                   shift, precision)
    for x, y, g in zip(a, b, ints(got, ok)):
        if y == 0:
            assert g is None
            continue
        q, r = divmod(abs(x) * 10 ** shift, abs(y))
        q += 1 if 2 * r >= abs(y) else 0
        q = -q if (x < 0) != (y < 0) else q
        assert g == (q if abs(q) < 10 ** precision else None), (x, y)


def segments(rng, n: int):
    """int32 starts: one-row segments, a long one, and the rest random."""
    cuts = sorted(set([0, 1, 2, 3, n // 2, n // 2 + 1]
                      + rng.randint(4, n, 20).tolist()))
    return torch.tensor(cuts, dtype=torch.int32)


def seg_ids(starts, n):
    bounds = starts.tolist() + [n]
    return np.repeat(np.arange(len(starts)), np.diff(bounds)).astype(np.int32)


@pytest.mark.parametrize("two", [True, False])
def test_segmented_sum128_matches_reference(two):
    """``segment_sum128`` (the exact 192-bit sum and its int128 overflow
    flag) under ``_seg_sum128``'s nulls: no valid row, past int128, past
    the buffer's precision; an all-null segment; Decimal64 rows
    sign-extended."""
    rng = np.random.RandomState(11 + two)
    n = 2_000
    vals = values(rng, n, 38 if two else 18)
    big = TOP if two else (1 << 63) - 1
    vals[n // 2 + 1: n // 2 + 40] = [big] * 39          # past the precision
    vals[3:10] = [MIN128 if two else -(1 << 63)] * 7    # past int128
    data = plane(vals) if two else torch.tensor(vals)
    valid = valid_of(rng, n)
    starts = segments(rng, n)
    valid[starts[4]:starts[5]] = False                  # an all-null one
    for precision in (38, 22, 20):
        got, ok, flags = R.segmented_sum128(data, valid, starts, precision)
        hi, lo = jlimbs(vals) if two else JD.widen64(jnp.asarray(vals))
        ids = jnp.asarray(seg_ids(starts, n))
        h, l, ov = JD.segment_sum128(hi, lo, jnp.asarray(valid.numpy()), ids,
                                     len(starts))
        nvalid = np.bincount(seg_ids(starts, n), valid.numpy(),
                             len(starts)) > 0
        wide = np.asarray(JD.overflow(h, l, precision))
        ref_ok = nvalid & ~np.asarray(ov) & ~wide
        assert ints(got, ok) == jints(h, l, ref_ok)
        assert ((flags.numpy() & R.PAST_INT128) != 0).tolist() == \
            np.asarray(ov).tolist()
    assert not ok[4] and (~ok).any() and ok.any()


def test_sum128_merge_poisons_and_global_sum():
    """A merge: a null partial beside a count above zero nulls its group
    (SPARK-28067), one beside a zero count does not; the whole-batch sum
    is ``sum128``'s."""
    part = [7, None, 5, 3, None, 2**70]
    count = torch.tensor([1, 4, 2, 1, 0, 3])
    valid = torch.tensor([v is not None for v in part])
    data = plane([v or 0 for v in part])
    starts = torch.tensor([0, 3], dtype=torch.int32)
    got, ok, flags = R.segmented_sum128(data, valid, starts, 38, count)
    assert ints(got, ok) == [None, 3 + 2**70]
    assert flags.tolist() == [R.POISONED, 0]
    vals = values(np.random.RandomState(5), 300)
    va = valid_of(np.random.RandomState(6), 300)
    got, ok, _ = R.masked_sum128(plane(vals), va, 38)
    h, l, ov = JD.sum128(*jlimbs(vals), jnp.asarray(va.numpy()))
    want_ok = not bool(ov) and not bool(JD.overflow(h, l, 38))
    assert ints(got, ok) == [JD.to_python(h, l) if want_ok else None]
    empty = torch.zeros((0, 2), dtype=torch.int64)
    got, ok, _ = R.masked_sum128(empty, torch.zeros(0, dtype=torch.bool), 38)
    assert ints(got, ok) == [None]


@pytest.mark.parametrize("is_min", [True, False])
def test_extreme128_matches_reference(is_min):
    """``segment_extreme128``: (signed high, unsigned low) order, equal
    high limbs with low limbs on both sides of 2**63, one-row and all-null
    segments; the whole-batch extreme."""
    rng = np.random.RandomState(int(is_min) + 20)
    n = 1_500
    vals = values(rng, n)
    vals[20:30] = [(5 << 64) + (1 << 63) + i for i in range(-5, 5)]
    valid = valid_of(rng, n)
    starts = segments(rng, n)
    valid[starts[6]:starts[7]] = False
    got, ok = R.segmented_extreme128(plane(vals), valid, starts, is_min)
    h, l, any_ok = JD.segment_extreme128(
        *jlimbs(vals), jnp.asarray(valid.numpy()),
        jnp.asarray(seg_ids(starts, n)), len(starts), is_min)
    assert ints(got, ok) == jints(h, l, any_ok)
    assert not ok[6]
    got, ok = R.masked_extreme128(plane(vals), valid, is_min)
    live = [v for v, m in zip(vals, valid.tolist()) if m]
    assert ints(got, ok) == [min(live) if is_min else max(live)]
