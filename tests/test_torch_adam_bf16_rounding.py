"""Fused Adam's bf16 arithmetic, modelled in numpy and held against the
f32 IEEE operation followed by bf16 round-to-nearest-even.

The plain version (``ops.kernels.fused_adam_plain`` on bf16 leaves) takes
every operation on two bf16 values in f32 and rounds its result to bf16:
``R(fl32(a op b))``. ``horovod_tpu_torch/ops/csrc/fused_adam.cu`` gets
the same bits another way, two elements a 32-bit word:

- ``*`` and ``+`` are one ``fma.rn.bf16x2`` each (``a * b + (-0)``,
  ``a * 1 + b``): the exact result rounded once to bf16. That equals the
  double rounding: an exact product of two bf16 values has 16 bits and
  is exact in f32 down to f32's subnormals, where it lies below the
  smallest bf16 midpoint that f32 could round onto; a sum is exact in f32
  when the exponents differ by at most 16, and beyond that it lies within
  2^-16 of the larger operand, far from any bf16 midpoint.
- ``v / b2c`` and ``m / b1c`` are ``v * rcp`` with ``rcp = 1 / b`` in f32
  once a launch (a product within 2^-23 of the quotient), ``t / den`` is
  ``t * rcp.approx(den)`` (within 2^-22), and the square root is
  ``sqrt.approx`` (1 ULP): operands and results are bf16, and in the
  normal range a quotient or a root of bf16 values lies at least 2^-19
  (relative) from a bf16 midpoint, so the approximation and the correctly
  rounded f32 value round to the same bf16. Below 2^-126 a quotient can
  be a bf16 midpoint exactly (a power-of-two divisor): the correctly
  rounded ``rcp`` keeps such a tie, an approximate one need not, so a
  ``t / den`` quotient nearer zero than 2^-125 (but not 0) is divided
  exactly. A divisor's reciprocal must be a normal f32 (else
  ``__fdiv_rn``), a root's operand a normal, 0 or +inf (else
  ``__fsqrt_rn``).
- the f32 results round to bf16 in pairs, ``cvt.rn.bf16x2.f32``.

The model below repeats those lines; where the card approximates, it
takes both ends of the approximation's error interval (``EPS``, wider
than the hardware's) and requires one bf16 result from both. The CUDA
code itself is held against the plain version on the card by
``chip_smoke.py`` and ``tools/b5_split.py``.
"""

import numpy as np
import pytest
import torch

from horovod_tpu_torch.ops import kernels as K

pytestmark = pytest.mark.torch_port

F32, F64 = np.float32, np.float64
#: relative error allowed an approximate reciprocal or root (the card's
#: rcp.approx and sqrt.approx are within 2^-22.9 and 1 ULP)
EPS = 2.0 ** -21
TINY, HUGE = 2.0 ** -126, 2.0 ** 126


def bf16_rne(a):
    """f32 -> the nearest bf16 (ties to even), as f32; NaN stays NaN:
    what ``cvt.rn.bf16x2.f32`` and PyTorch's cast do."""
    a = np.asarray(a, F32)
    b = a.view(np.uint32).astype(np.uint64)
    r = ((b + 0x7FFF + ((b >> 16) & 1)) >> 16 << 16).astype(np.uint32)
    return np.where(np.isnan(a), a, r.view(F32))


def bf16_once(x):
    """An exact value (f64) rounded once to bf16, ties to even, bf16's
    subnormals at 2^-133, overflow to inf: ``fma.rn.bf16x2``'s rounding."""
    x = np.asarray(x, F64)
    with np.errstate(all="ignore"):
        e = np.frexp(np.abs(x))[1]              # |x| in [2^(e-1), 2^e)
        q = np.exp2(np.maximum(e - 8, -133).astype(F64))
        r = np.rint(x / q) * q
        r = np.where(np.abs(r) >= 2.0 ** 128, np.copysign(np.inf, x), r)
    return np.where(np.isfinite(x), r, x).astype(F32)


def bf16_values():
    """Every bf16 bit pattern (65,536), as f32."""
    return (np.arange(1 << 16, dtype=np.uint32) << 16).view(F32)


def plain(op, a, b=None):
    """The plain version's step: the f32 operation, then bf16 RNE."""
    a = np.asarray(a, F32)
    with np.errstate(all="ignore"):
        if op == "sqrt":
            return bf16_rne(np.sqrt(a.astype(F64)).astype(F32))
        b = np.asarray(b, F32)
        return bf16_rne({"mul": a * b, "add": a + b, "div": a / b}[op])


# the kernel's lines ---------------------------------------------------------

def mul(a, b):
    """bf::mul: fma.rn.bf16x2(a, b, -0) (the product is exact in f64)."""
    with np.errstate(all="ignore"):
        return bf16_once(np.asarray(a, F64) * np.asarray(b, F64))


def add(a, b):
    """bf::add: fma.rn.bf16x2(a, 1, b). f64 rounds a sum only where the
    exponents differ by more than 45, where no bf16 midpoint is near."""
    with np.errstate(all="ignore"):
        return bf16_once(np.asarray(a, F64) + np.asarray(b, F64))


def rcp_fits(b):
    """bf::rcp_fits: 1 / b is a normal f32, or b is 0, inf or NaN."""
    a = np.abs(np.asarray(b, F32))
    return ((a >= TINY) & (a <= HUGE)) | (a == 0) | np.isinf(a) | np.isnan(a)


def div_const(a, b):
    """bf::div_const: a * __frcp_rn(b), rounded to bf16; __fdiv_rn where
    the reciprocal does not fit (b is one constant a launch)."""
    a, b = np.asarray(a, F32), F32(b)
    with np.errstate(all="ignore"):
        if rcp_fits(b):
            return bf16_rne(a * (F32(1) / b))
        return bf16_rne(a / b)


def _approx(exact64, fallback, fits):
    """bf16 of an f32 value within EPS of ``exact64`` (both ends of the
    interval, rounded to f32 and then to bf16, must agree); ``fallback``
    where ``fits`` is false."""
    with np.errstate(all="ignore"):
        lo = bf16_rne((exact64 * (1 - EPS)).astype(F32))
        hi = bf16_rne((exact64 * (1 + EPS)).astype(F32))
    lo, hi = np.where(fits, lo, fallback), np.where(fits, hi, fallback)
    nan = np.isnan(lo)
    assert np.array_equal(nan, np.isnan(hi)) and np.array_equal(
        lo[~nan].view(np.uint32), hi[~nan].view(np.uint32)), \
        "the approximation's error decides a bf16 rounding"
    return lo


def div_pair(a, d):
    """bf::div_pair: q = a * rcp.approx(d) where d's reciprocal fits and q
    is 0 or not below 2^-125 in magnitude, else __fdiv_rn; then bf16. The
    kernel decides on its q, which lies within EPS of the quotient: the
    approximation is taken wherever some q in that interval passes."""
    a, d = np.broadcast_arrays(np.asarray(a, F32), np.asarray(d, F32))
    with np.errstate(all="ignore"):
        exact = a.astype(F64) / d.astype(F64)
        # d = 0, inf or NaN: the reciprocal is exact, and a * (1 / d) is
        # the quotient's own inf, 0 or NaN
        special = (d == 0) | ~np.isfinite(d)
        exact = np.where(special, a.astype(F64) * (F64(1) / d), exact)
        small = (np.abs(exact) * (1 + EPS) < 2.0 ** -125) \
            & (np.abs(exact) * (1 - EPS) > 2.0 ** -150)
        return _approx(exact, bf16_rne(a / d), rcp_fits(d) & ~small)


def root(t):
    """bf::root: sqrt.approx where t is a normal, +inf or 0 (0 kept as
    it is, its sign too), else __fsqrt_rn; then bf16."""
    t = np.asarray(t, F32)
    with np.errstate(all="ignore"):
        fits = (t >= TINY) | (t == 0)
        exact = np.where(t == 0, t, np.sqrt(np.abs(t).astype(F64)))
        return _approx(exact, plain("sqrt", t), fits)


def model_adam(g, mu, nu, c):
    """One Adam step of the bf16 kernel (``adam_pair``) on bf16 values
    held as f32: ``(u, mu', nu')``."""
    k = {name: bf16_rne(F32(c[name])) for name in c}
    m2 = add(mul(k["omb1"], g), mul(k["b1"], mu))
    v2 = add(mul(k["omb2"], mul(g, g)), mul(k["b2"], nu))
    t2 = add(div_const(v2, k["b2c"]), k["eps_root"])
    den = add(root(t2), k["eps"])
    u = mul(k["neg_lr"], div_pair(div_const(m2, k["b1c"]), den))
    return u, m2, v2


# the pieces against the plain version's -------------------------------------

def _bits_equal(a, b):
    a, b = np.asarray(a, F32), np.asarray(b, F32)
    nan = np.isnan(a)
    assert np.array_equal(nan, np.isnan(b))
    assert np.array_equal(a[~nan].view(np.uint32), b[~nan].view(np.uint32))


def _specials():
    return np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 2.0 ** -133,
                     -2.0 ** -133, 2.0 ** -126, 3.3895314e38], F32)


def _random_bf16(rng, n):
    """n bf16 values over the whole range: random bit patterns."""
    bits = rng.randint(0, 1 << 16, n).astype(np.uint32) << 16
    return bits.view(F32)


def test_rounding_model_is_torchs_cast():
    """bf16_rne (the model of cvt.rn.bf16x2.f32 and of the plain version's
    cast) against PyTorch's f32 -> bf16 cast over all 2^32 f32 patterns
    at a stride of 4093 (every exponent, every rounding-bit pattern) and
    every NaN class (quiet and signalling, either sign, payloads in the
    dropped and the kept bits)."""
    bits = np.arange(0, 1 << 32, 4093, dtype=np.uint64).astype(np.uint32)
    ties = (np.arange(1 << 16, dtype=np.uint32) << 16) | 0x8000
    nans = np.array([s | e | m for s in (0, 0x80000000) for e in (0x7F800000,)
                     for m in (1, 0x7FFF, 0x8000, 0xFFFF, 0x10000, 0x3FFFFF,
                               0x400000, 0x400001, 0x7FFFFF)], np.uint32)
    x = np.concatenate([bits, ties, ties - 1, ties + 1, nans]).view(F32)
    ref = torch.from_numpy(x.copy()).to(torch.bfloat16).float().numpy()
    _bits_equal(bf16_rne(x), ref)
    assert np.isnan(bf16_rne(x[-len(nans):])).all()


def test_once_rounded_products_are_the_double_rounding():
    """mul (one rounding from the exact product) against R(fl32(a * b)):
    every bf16 squared (g * g), every bf16 times each of the step's
    constants, 2^21 random pairs, and products at the bottom of the range
    (both factors near 2^-67, their products near the smallest bf16 and
    its midpoints)."""
    x = bf16_values()
    _bits_equal(mul(x, x), plain("mul", x, x))
    for count in (1, 2, 10, 1000):
        c = K.adam_constants(1e-3, 0.9, 0.999, 1e-8, 0.0, count)
        for name in ("omb1", "b1", "omb2", "b2", "neg_lr"):
            k = bf16_rne(F32(c[name]))
            _bits_equal(mul(k, x), plain("mul", k, x))
    rng = np.random.RandomState(0)
    a, b = _random_bf16(rng, 1 << 21), _random_bf16(rng, 1 << 21)
    _bits_equal(mul(a, b), plain("mul", a, b))
    near = x[(np.abs(x) > 2.0 ** -72) & (np.abs(x) < 2.0 ** -60)]
    a, b = np.meshgrid(near[::7], near[::5])
    _bits_equal(mul(a, b), plain("mul", a, b))


def test_once_rounded_sums_are_the_double_rounding():
    """add against R(fl32(a + b)): 2^21 random pairs, pairs whose
    exponents differ by 15-26 (where f32 starts to round), cancelling
    pairs, subnormals, and every special value against every bf16."""
    rng = np.random.RandomState(1)
    a, b = _random_bf16(rng, 1 << 21), _random_bf16(rng, 1 << 21)
    _bits_equal(add(a, b), plain("add", a, b))
    x = bf16_values()
    finite = x[np.isfinite(x) & (np.abs(x) > 2.0 ** -100)
               & (np.abs(x) < 2.0 ** 100)]
    a = rng.choice(finite, 1 << 20)
    gap = rng.randint(15, 27, a.size).astype(F64)
    mant = 1 + rng.randint(0, 128, a.size) / 128.0
    sign = rng.choice([-1.0, 1.0], a.size)
    b = bf16_rne((a * sign * mant * np.exp2(-gap)).astype(F32))
    _bits_equal(add(a, b), plain("add", a, b))
    nb = bf16_rne(-(a * (1 + rng.randint(-3, 4, a.size) / 256.0)).astype(F32))
    _bits_equal(add(a, nb), plain("add", a, nb))
    sub = x[np.abs(x) < 2.0 ** -120]
    a, b = np.meshgrid(sub[::3], sub[::11])
    _bits_equal(add(a, b), plain("add", a, b))
    a, b = np.meshgrid(_specials(), x)
    _bits_equal(add(a, b), plain("add", a, b))


@pytest.mark.parametrize("count", [1, 2, 10, 1000, 100000])
def test_constant_divides_every_numerator(count):
    """div_const against R(fl32(a / b)) for all 65,536 bf16 numerators,
    b the bias corrections b1c and b2c at ``count`` (b1 0.9, b2 0.999)
    as the kernel rounds them; and for b a subnormal, above 2^126, 0, inf
    and NaN (where the kernel divides), powers of two and small odd
    multiples (exact quotients and subnormal midpoints)."""
    x = bf16_values()
    c = K.adam_constants(1e-3, 0.9, 0.999, 1e-8, 0.0, count)
    for b in (c["b1c"], c["b2c"]):
        b = bf16_rne(F32(b))
        assert rcp_fits(b)
        _bits_equal(div_const(x, b), plain("div", x, b))
    if count == 1:
        for b in (2.0 ** -126, 2.0 ** -130, 2.0 ** 127, 0.0, np.inf, np.nan,
                  -3.0, 0.75, 3.0, 6.0, 0.375, 4.0):
            _bits_equal(div_const(x, bf16_rne(F32(b))),
                        plain("div", x, bf16_rne(F32(b))))


def test_root_of_every_bf16():
    """root against R(fl32(sqrt(t))) for every bf16 t: normals and +inf
    through the approximation (which cannot move them across a bf16
    rounding boundary), subnormals, negatives, NaN and -inf through
    __fsqrt_rn, both zeros keeping their sign."""
    x = bf16_values()
    _bits_equal(root(x), plain("sqrt", x))
    assert np.signbit(root(np.array([-0.0], F32)))[0]


def test_den_divide():
    """div_pair against R(fl32(t / den)): 2^21 random pairs; each den
    with the numerators nearest to den times a bf16 midpoint (the closest
    a quotient of bf16 values comes to a rounding boundary); quotients in
    the subnormal range; every special value and every den whose
    reciprocal does not fit (subnormal, above 2^126) against every bf16."""
    rng = np.random.RandomState(2)
    t, d = _random_bf16(rng, 1 << 21), _random_bf16(rng, 1 << 21)
    _bits_equal(div_pair(t, d), plain("div", t, d))
    x = bf16_values()
    pos = x[np.isfinite(x) & (x > 2.0 ** -60) & (x < 2.0 ** 60)]
    d = rng.choice(pos, 1 << 18)
    mid = ((1 + (2 * rng.randint(0, 128, d.size) + 1) / 256.0)
           * np.exp2(rng.randint(-40, 40, d.size)))
    t0 = (mid * d).astype(F32)
    for t in (bf16_rne(t0), bf16_rne(np.nextafter(t0, F32(0))),
              bf16_rne(np.nextafter(t0, F32(np.inf)))):
        _bits_equal(div_pair(t, d), plain("div", t, d))
    small = x[np.isfinite(x) & (np.abs(x) < 2.0 ** -110)]
    t, d = np.meshgrid(small[::5], rng.choice(pos[pos > 2.0 ** 10], 64))
    _bits_equal(div_pair(t, d), plain("div", t, d))
    odd = np.concatenate([_specials(), [2.0 ** -127, 2.0 ** 127, -2.0 ** 126,
                                        2.0 ** 126]]).astype(F32)
    t, d = np.meshgrid(x, odd)
    _bits_equal(div_pair(t, d), plain("div", t, d))
    _bits_equal(div_pair(d, t), plain("div", d, t))


def _leaf(rng, n):
    g = (rng.randn(n) * 1e-2).astype(F32)
    mu = (rng.randn(n) * 1e-3).astype(F32)
    nu = (rng.rand(n) * 1e-6).astype(F32)
    g[:6] = [np.nan, np.inf, -np.inf, 0.0, -0.0, 1e-30]
    mu[6:12] = [np.inf, -0.0, 0.0, 1e-39, -1e-39, 1e30]
    nu[12:16] = [np.inf, 0.0, 1e-39, 1e30]
    g[16:32] = _random_bf16(rng, 16)
    mu[32:48] = _random_bf16(rng, 16)
    nu[48:64] = np.abs(_random_bf16(rng, 16))
    return [bf16_rne(v) for v in (g, mu, nu)]


@pytest.mark.parametrize("eps_root", [0.0, 1e-12])
def test_model_is_the_plain_version_over_steps(eps_root):
    """The whole model against ``kernels.fused_adam_plain`` on bf16
    leaves, four steps fed back, at a host count and at the bias
    corrections of a 0-d count tensor (a guarded state's), with NaN,
    infinities, zeros of both signs, subnormals and random bit patterns
    among the inputs."""
    rng = np.random.RandomState(3)
    g, mu, nu = _leaf(rng, 4096)
    for step in range(1, 5):
        count = step if step % 2 else torch.tensor(step, dtype=torch.int32)
        c = K.adam_constants(1e-3, 0.9, 0.999, 1e-8, eps_root, count)
        t = [torch.from_numpy(v).to(torch.bfloat16) for v in (g, mu, nu)]
        ref = [r.float().numpy() for r in K.fused_adam_plain(*t, c)]
        cc = {k: float(v) for k, v in c.items()}
        out = model_adam(g, mu, nu, cc)
        for a, b in zip(out, ref):
            _bits_equal(a, b)
        _, mu, nu = out
        g = bf16_rne((rng.randn(g.size) * 1e-2).astype(F32))


@pytest.mark.parametrize("count", [1, 1000])
def test_model_is_the_plain_version_at_every_pattern(count):
    """The whole model against the plain version with every bf16 bit
    pattern as g, mu and (its magnitude) nu, in three orders: the inputs
    ``chip_smoke.adam_bf16_edge_check`` gives the kernel on the card."""
    rng = np.random.RandomState(count)
    x = bf16_values()
    g, mu = x, x[rng.permutation(x.size)]
    nu = np.abs(x[rng.permutation(x.size)])
    for eps_root in (0.0, 1e-12):
        c = K.adam_constants(1e-3, 0.9, 0.999, 1e-8, eps_root, count)
        t = [torch.from_numpy(v).to(torch.bfloat16) for v in (g, mu, nu)]
        ref = [r.float().numpy() for r in K.fused_adam_plain(*t, c)]
        for a, b in zip(model_adam(g, mu, nu, c), ref):
            _bits_equal(a, b)
