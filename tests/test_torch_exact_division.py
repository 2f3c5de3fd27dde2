"""The solver kernel's division by a shared reciprocal, emulated in NumPy.

``csrc/opt_solver.cu::div_by`` forms ``a / b`` from ``y = RN(1 / b)`` as
``q = RN(a y)``, ``nr = fma(b, q, -a)`` (the remainder negated) and
``q' = fma(-nr, y, q)``, under the guards ``div_ok`` (``a`` zero or
``|a|`` in ``[2^-79, 2^80]``) and ``div_ok_b`` (``b`` in ``[2^-40,
2^40]``, positive as every divisor of the solve; ``b = 2 S`` with ``y =
0.5 RN(1 / S)``, ``S`` in range).  Each
quotient must be NumPy's float32 ``a / b`` (IEEE, round to nearest) bit
for bit, signed zeros included (the argument that it is, below).  The
emulation is exact: the remainder ``b q - a`` of float32 operands is exact
in float64 and rounded once to float32, as the fma rounds it, and the last
fma's rounding to float32 is a correctly rounded sum (a float64 two-sum,
then a float32 midpoint broken by the sign of the error).
"""

import os
import re

import numpy as np
import pytest

from differt2d_tpu_torch import optimize

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(ROOT, "differt2d_tpu_torch", "ops", "csrc", "opt_solver.cu")
f32, f64 = np.float32, np.float64
LO, HI = 2.0 ** -79, 2.0 ** 80  # numerators (or zero)
B_LO, B_HI = 2.0 ** -40, 2.0 ** 40  # divisors (2 S up to 2^41)


def _rn32(hi, lo):
    """RN32(hi + lo) for float64 ``hi``, ``lo`` whose exact sum is wanted,
    in float32's normal range."""
    s = hi + lo
    bb = s - hi
    err = (hi - (s - bb)) + (lo - bb)  # s + err == hi + lo exactly
    # Where s sits on a float32 midpoint (its float64 bits below float32's
    # are a 1 and 28 zeros), float32(s) would take the even side: first
    # step s one float64 ulp toward the exact sum.
    bits = s.view(np.uint64)
    mid = np.nonzero(((bits & np.uint64(0x1FFFFFFF)) == np.uint64(0x10000000)) & (err != 0))[0]
    if mid.size:
        s = s.copy()
        s[mid] = np.nextafter(s[mid], np.copysign(np.inf, err[mid]))
    return s.astype(f32)


def div_by(a, b, y):
    """The kernel's three instructions, exactly (signed zeros included:
    float64 sums of zeros round as float32's)."""
    q = (a * y).astype(f32)
    nr = (b.astype(f64) * q.astype(f64) - a.astype(f64)).astype(f32)
    return _rn32(q.astype(f64), (-nr).astype(f64) * y.astype(f64))


def _check(a, b, y=None, chunk=1 << 16):
    """Every ``div_by(a, b, y)`` is float32's ``a / b``, bit for bit (in
    chunks that stay in cache)."""
    a, b = (np.ravel(np.asarray(v, f32)) for v in (a, b))
    y = None if y is None else np.ravel(np.asarray(y, f32))
    for i in range(0, a.size, chunk):
        ac, bc = a[i:i + chunk], b[i:i + chunk]
        ok = (((np.abs(ac) >= LO) | (ac == 0)) & (np.abs(ac) <= HI)
              & (bc >= B_LO) & (bc <= 2 * B_HI))
        assert ok.all(), "inputs outside the guards"
        with np.errstate(over="raise", invalid="raise", divide="raise", under="ignore"):
            yc = (f32(1) / bc) if y is None else y[i:i + chunk]
            got = div_by(ac, bc, yc)
            ref = ac / bc
        bad = np.nonzero(got.view(np.uint32) != ref.view(np.uint32))[0]
        assert bad.size == 0, (ac[bad[:3]], bc[bad[:3]], got[bad[:3]], ref[bad[:3]])


def _random(rng, n, e_lo=-79, e_hi=79):
    sign = rng.choice([-1.0, 1.0], n)
    return (sign * rng.uniform(1.0, 2.0, n) * 2.0 ** rng.integers(e_lo, e_hi + 1, n)).astype(f32)


def test_random_pairs():
    rng = np.random.default_rng(0)
    _check(_random(rng, 10 ** 6), np.abs(_random(rng, 10 ** 6, -40, 39)))


def test_quotients_at_rounding_midpoints():
    """a / b within 2^-25 / B of a float32 midpoint (B the significand of
    b): a = (B M -+ 1) / 2^25 with M = -+B^-1 mod 2^25 odd, so B M = 1 (mod
    2^25), for significands of b near both ends of the binade."""
    rng = np.random.default_rng(1)
    B = np.concatenate([2 ** 24 - 1 - 2 * rng.integers(0, 2 ** 21, 20000),
                        2 ** 23 + 1 + 2 * rng.integers(0, 2 ** 21, 20000),
                        2 ** 23 + 1 + 2 * rng.integers(0, 2 ** 22, 20000)]).astype(np.int64)
    sign = rng.choice([-1, 1], B.size)
    M = np.array([pow(int(x), -1, 2 ** 25) for x in B], np.int64)
    M = np.where(sign < 0, (2 ** 25 - M) % 2 ** 25, M)
    A = (B * M - sign) // 2 ** 25
    keep = (A >= 2 ** 23) & (A < 2 ** 24) & (M % 2 == 1)
    a = (A[keep] * 2.0 ** -23 * 2.0 ** rng.integers(-79, 79, keep.sum())).astype(f32)
    b = (B[keep] * 2.0 ** -23 * 2.0 ** rng.integers(-40, 39, keep.sum())).astype(f32)
    a = np.where(rng.uniform(size=a.size) < 0.5, -a, a)
    assert a.size > 15000
    _check(a, b)


def test_every_numerator_of_extreme_divisors():
    """Every seventh of the 2^23 significands of a against the divisors whose reciprocal's
    rounding error is largest (significands near 2) and smallest."""
    A = np.arange(2 ** 23, 2 ** 24, 7, dtype=np.int64)
    a = (A * 2.0 ** -23).astype(f32)
    for B in (2 ** 24 - 1, 2 ** 24 - 3, 2 ** 23 + 1, 2 ** 23 + 3):
        _check(a, np.full(a.shape, B * 2.0 ** -23, f32))


def test_powers_of_two_zeros_and_the_guard_edges():
    rng = np.random.default_rng(2)
    ea, eb = np.arange(-79, 81), np.arange(-40, 41)
    pa = np.concatenate([2.0 ** ea, -(2.0 ** ea), [0.0, -0.0]]).astype(f32)
    pb = (2.0 ** eb).astype(f32)
    a, b = np.meshgrid(pa, pb)
    _check(a.ravel(), b.ravel())
    edges = np.array([LO, np.nextafter(f32(LO), f32(1)), HI, np.nextafter(f32(HI), f32(0))], f32)
    b_edges = np.array([B_LO, np.nextafter(f32(B_LO), f32(1)), B_HI,
                        np.nextafter(f32(B_HI), f32(0))], f32)
    a, b = np.meshgrid(np.concatenate([edges, -edges, [0.0, -0.0], _random(rng, 200)]),
                       np.concatenate([b_edges, np.abs(_random(rng, 200, -40, 39))]))
    _check(a.ravel(), b.ravel())
    # Exact quotients (r == 0): q' is q, with its sign.
    q = _random(rng, 100000, -30, 30)
    b = np.abs(_random(rng, 100000, -20, 20))
    prod = q.astype(f64) * b.astype(f64)
    exact = prod.astype(f32).astype(f64) == prod
    _check(prod[exact].astype(f32), b[exact])


def test_half_reciprocal_of_twice_the_divisor():
    """unit_back divides by 2 S through 0.5 RN(1 / S): RN(1 / (2 S)) ==
    0.5 RN(1 / S) for S in range, and the quotients are IEEE's."""
    rng = np.random.default_rng(3)
    S = np.abs(_random(rng, 200000, -40, 39))
    y = f32(1) / S
    assert np.array_equal(f32(1) / (f32(2) * S), f32(0.5) * y)
    _check(_random(rng, S.size), f32(2) * S, f32(0.5) * y)


def test_adam_bias_divisors():
    """The divisors of adam's bias corrections, 1 - b1**t and 1 - b2**t for
    t = 1..1000 (optimize.bias_table, as the kernel's table forms them;
    the kernel divides by both through their reciprocals), against
    numerators over the range the moments take."""
    bc = optimize.bias_table(1000)
    d = (f32(1) - bc).astype(f32)
    assert (d >= B_LO).all() and (d <= 1.0).all()
    rng = np.random.default_rng(4)
    b = np.repeat(d, 500)
    _check(_random(rng, b.size, -40, 20), b)


def test_guard_matches_the_kernel():
    with open(SOURCE) as f:
        src = f.read()
    for const in ("kDivLo = 0x1p-79f;", "kDivHi = 0x1p80f;", "kDivisorLo = 0x1p-40f;",
                  "kDivisorHi = 0x1p40f;", "float q = __fmul_rn(a, y);",
                  "float nr = __fmaf_rn(b, q, -a);", "return __fmaf_rn(-nr, y, q);"):
        assert const in src, const


@pytest.mark.parametrize("a", [2.0 ** -80, -(2.0 ** -100), 1e-45, float("inf"), float("nan"),
                               2.0 ** 81])
def test_guard_rejects_what_the_theorem_does_not_cover(a):
    """Tiny, subnormal, huge, infinite and NaN numerators fail ``div_ok``
    and take IEEE division; with the remainder formed the other way round,
    a zero numerator would lose its sign."""
    m = abs(f32(a))
    assert not ((m >= LO or m == 0) and m <= HI)
    three = np.array([3.0], f32)
    y = f32(1) / three
    q = np.array([-0.0], f32) * y
    assert np.signbit(q[0]) and not np.signbit((f32(0.0) * y + q)[0])  # fma(+0, y, -0)
    assert np.signbit(div_by(np.array([-0.0], f32), three, y)[0])


# Why the three instructions give RN(a / b) although q = RN(a y) may lie up
# to 1.5 ulps from a / b, beyond Markstein's hypothesis (q within an ulp).
# Take a, b > 0 (the sequence is odd in a) and scale both by powers of two
# (the guards keep every step normal) so that their significands are
# integers A, B in [2^23, 2^24).  B = 2^23 gives y exact and r = 0; else
# y = Y 2^-47 with Y = RN(2^47 / B) and D = B Y - 2^47, |D| < B / 2.  In
# units u of the quotient's binade (2^-23 if A >= B, else 2^-24), a / b is
# N = A / (u B), q is K (an integer), the exact remainder is R = A / u - B K
# (an integer) and the fma rounds it to R' = R + rho; q + r y is T = K + R'
# Y 2^-47.  For every midpoint h = K + j + 1/2:
#   2 B (T - h) = M + 2 rho + R' D 2^-46,  M = 2 R - (2 j + 1) B = 2 B (N - h),
# and M != 0 (a / b is never a midpoint).  q' = RN(a / b) iff every such sum
# has the sign of M.  The first quotient's error is |X - N| = A |D| / (B 2^k)
# with 2^k = 2^24 if A >= B (< 1/2: q faithful) and 2^23 if A < B (< 1).
#   |N - K| < 1: |R| < B < 2^24, so rho = 0 and |R D| 2^-46 < B^2 2^-47 < 2;
#     |M| = 1 only where |R| = (B +- 1) / 2, and then |R D| 2^-46 < 1.
#   1 <= N - K < 3/2 (A < B; N < K is the mirror case): q was rounded down
#     across a float, so X - N <= -1/2 and D < 0; R, R' > 0 and rho <= 1
#     (R < 2^25).  For h <= K + 1/2, M >= B and |R' D| 2^-46 < 3.  For
#     h >= K + 3/2, R' D < 0 and -M >= 2 B (3/2 - (N - K)) > 2 (B - A |D| /
#     2^23) > 2 (B - (B - 1) B / 2^24) > 2 >= 2 rho.
# The one pair whose q falls into the binade below a / b (K not an integer)
# is A = 2^23, B = 2^24 - 1: it is checked below with the others.


def _significands():
    return np.arange(2 ** 23 + 1, 2 ** 24, dtype=np.int64)


def test_every_divisor_reciprocal_matches_the_argument():
    """For all 2^23 - 1 divisor significands B > 2^23: float32's 1 / b is
    Y 2^-47 with Y = RN(2^47 / B), and |D| = |B Y - 2^47| < B / 2."""
    B = _significands()
    Y = (2 ** 48 // B + 1) // 2  # RN(2^47 / B): 2^48 / B is never odd
    D = B * Y - 2 ** 47
    assert (2 * np.abs(D) < B).all()
    y = f32(1) / (B * 2.0 ** -23).astype(f32)
    assert np.array_equal(y.astype(f64), Y * 2.0 ** -24)


def test_every_divisor_at_its_largest_first_quotient_errors():
    """Every divisor significand against the numerator that makes the first
    quotient's error A |D| / (B 2^23) largest (A = B - 1); where that bound
    passes half an ulp (|D| > 2^22), also A = B - 2 and B - 3; and the pair
    A = 2^23, B = 2^24 - 1.  Many of these first quotients lie an ulp or
    more from a / b; every final quotient is IEEE's."""
    B = _significands()
    Y = (2 ** 48 // B + 1) // 2
    wide = B[np.abs(B * Y - 2 ** 47) > 2 ** 22]
    assert wide.size > 10 ** 6
    unfaithful = 0
    for A, Bs in ((B - 1, B), (wide - 2, wide), (wide - 3, wide),
                  (np.array([2 ** 23]), np.array([2 ** 24 - 1]))):
        a, b = (A * 2.0 ** -23).astype(f32), (Bs * 2.0 ** -23).astype(f32)
        _check(a, b)
        exact = A / Bs
        q = (a * (f32(1) / b)).astype(f64)
        unfaithful += int((np.abs(q - exact) >= np.spacing(exact.astype(f32))).sum())
    assert unfaithful > 10 ** 6


def test_every_numerator_of_the_worst_divisor():
    """All 2^23 numerator significands against the divisor with the largest
    |D| / 2^23 (the first quotient's error bound)."""
    B = _significands()
    Y = (2 ** 48 // B + 1) // 2
    D = np.abs(B * Y - 2 ** 47)
    a = (np.arange(2 ** 23, 2 ** 24, dtype=np.int64) * 2.0 ** -23).astype(f32)
    _check(a, np.full(a.shape, B[np.argmax(D)] * 2.0 ** -23, f32))
