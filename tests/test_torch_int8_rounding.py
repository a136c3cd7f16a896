"""The int8 wire kernels' rounding without a divide per element, modelled
in numpy and held against IEEE division.

``horovod_tpu_torch/ops/csrc/int8_wire.cuh`` requantizes a 256-element
block as the reference does (``sc = bf16_rne(amax / 127)``, ``q =
clip(round_half_even(x / sf), -127, 127)``), but takes the quotient as
``rint(x * rcp)`` with ``rcp = 1 / sf`` once a block (one fma: the product
is not rounded), falls back to ``rintf(x / sf)`` where ``x * rcp`` lies
within 2^-14 of a half-integer or ``sf`` is not a normal f32 or inf, and
reads the int8 from the low byte of ``clip(t) + 1.5 * 2^23``. B4's Average by a
power of two ``N`` multiplies by ``2^-k``. The model below repeats those
lines in f32 (f64 only where it holds an f32 fma's exact intermediate),
and every case must give the bits of ``np.float32(x) / np.float32(sf)``
then ``np.rint`` and the clip. The CUDA code itself is held against the
plain PyTorch version on the card by ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

from horovod_tpu_torch.ops import kernels as K

pytestmark = pytest.mark.torch_port

F32 = np.float32
ROUND = F32(12582912.0)                 # 1.5 * 2^23 (int8_wire.cuh kRound)
NEAR_HALF = F32(0.5) - F32(2.0 ** -14)  # kNearHalf
RCP_MAX = F32(2.0 ** 126)               # rcp's range where sf is normal
RCP_MIN = F32(2.0 ** -126)


def bf16_rne(a):
    """f32 -> the nearest bf16 (ties to even), as f32; NaN stays NaN."""
    a = np.asarray(a, F32)
    b = a.view(np.uint32).astype(np.uint64)
    r = ((b + 0x7FFF + ((b >> 16) & 1)) >> 16 << 16).astype(np.uint32)
    return np.where(np.isnan(a), a, r.view(F32))


def bf16_values(sign=1):
    """Every finite positive bf16 (subnormals included), as f32."""
    bits = np.arange(1, 0x7F80, dtype=np.uint32) << 16
    return sign * bits.view(F32)


def rcp_of(sf):
    """__frcp_rn(sf), made NaN unless sf is a normal f32 or inf
    (block_scale)."""
    with np.errstate(divide="ignore", over="ignore", invalid="ignore"):
        r = F32(1.0) / np.asarray(sf, F32)
        keep = (r <= RCP_MAX) & ((r >= RCP_MIN) | (r == 0))
    return np.where(keep, r, F32(np.nan)).astype(F32)


def fast_biased(x, rcp):
    """``u = clip(fma(x, rcp, kRound))`` to ``kRound +- 127`` and ``ok =
    |fma(x, rcp, -(fma(...) - kRound))| < kNearHalf``. x * rcp is exact
    in f64, and where |x * rcp| < 2^22 the fma's one rounding is kRound +
    rint(x * rcp); beyond, the clip gives +-127 whichever way ok goes."""
    with np.errstate(invalid="ignore"):
        p = np.asarray(x, F32).astype(np.float64) * np.asarray(rcp, F32)
        v = np.rint(p)
        d = (p - v).astype(F32)
        ok = np.abs(d) < NEAR_HALF
        u = (np.float64(ROUND) + np.clip(v, -127, 127)).astype(F32)
    return u, ok


def exact_biased(x, sf):
    """clip(rintf(x / sf)) + kRound, a NaN quotient giving 0."""
    with np.errstate(divide="ignore", invalid="ignore"):
        v = np.rint(np.asarray(x, F32) / np.asarray(sf, F32))
    return (np.where(np.isnan(v), F32(0), np.clip(v, -127, 127))
            + ROUND).astype(F32)


def low_byte(u):
    """The int8 in the low byte of u's bits (pack4)."""
    return (u.view(np.uint32) & 0xFF).astype(np.uint8).view(np.int8)


def model_quotient(x, sf):
    """The kernel's q of x at the block scale sf (sf > 0)."""
    x, sf = np.broadcast_arrays(np.asarray(x, F32), np.asarray(sf, F32))
    u, ok = fast_biased(x, rcp_of(sf))
    return low_byte(np.where(ok, u, exact_biased(x, sf))), ok


def ieee_quotient(x, sf):
    """The reference: clip(round_half_even(f32(x) / f32(sf))), NaN -> 0."""
    with np.errstate(divide="ignore", invalid="ignore"):
        v = np.rint(np.asarray(x, F32) / np.asarray(sf, F32))
    return np.where(np.isnan(v), 0, np.clip(v, -127, 127)).astype(np.int8)


def model_requant(blocks):
    """int8_wire.cuh's requant over rows of 256: ``(q int8, sc f32)``."""
    blocks = np.asarray(blocks, F32)
    with np.errstate(invalid="ignore"):
        amax = np.max(np.abs(blocks), axis=1, keepdims=True)  # NaN stays
        sc = bf16_rne(amax / F32(127))
    pos = sc > 0
    u, ok = fast_biased(blocks, np.where(pos, rcp_of(sc), F32(0)))
    u = np.where(ok, u, exact_biased(blocks, np.where(pos, sc, F32(1))))
    return np.where(pos, low_byte(u), 0).astype(np.int8), sc[:, 0]


def reference_requant(blocks):
    """compression.quantize_blockwise's expressions in numpy f32."""
    blocks = np.asarray(blocks, F32)
    with np.errstate(invalid="ignore"):
        amax = np.max(np.abs(blocks), axis=1, keepdims=True)
        sc = bf16_rne(amax / F32(127))
    pos = sc > 0
    q = ieee_quotient(blocks, np.where(pos, sc, F32(1)))
    return np.where(pos, q, 0).astype(np.int8), sc[:, 0]


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype.kind == "f":
        assert np.array_equal(np.isnan(a), np.isnan(b))
        a, b = a[~np.isnan(a)], b[~np.isnan(b)]
    assert np.array_equal(a, b)


def _mantissas():
    """Every positive bf16 mantissa (128), as sf in [1, 2)."""
    return (1.0 + np.arange(128) / 128.0).astype(F32)


@pytest.mark.parametrize("exponent", [-100, -20, 0, 20, 100])
def test_quotient_near_every_half_integer(exponent):
    """For every bf16 mantissa, the 4-ULP neighbourhoods of every
    (k + 0.5) * sf, |k + 0.5| <= 127.5: the fallback catches each case
    where x * rcp and x / sf round apart."""
    sf = _mantissas() * F32(2.0 ** exponent)
    halves = (np.arange(-128, 128) + 0.5).astype(F32)
    x0 = (halves[None, :] * sf[:, None]).astype(F32)       # exact
    xs = [x0]
    up, down = x0.copy(), x0.copy()
    for _ in range(4):
        up = np.nextafter(up, F32(np.inf))
        down = np.nextafter(down, F32(-np.inf))
        xs += [up, down]
    x = np.stack(xs, axis=-1)                               # [128, 256, 9]
    q, ok = model_quotient(x, sf[:, None, None])
    assert np.array_equal(q, ieee_quotient(x, sf[:, None, None]))
    # the exact half-integers themselves always take the divide
    assert not ok[..., 0].any()


@pytest.mark.parametrize("exponent", [-120, -60, 0, 60, 120])
def test_quotient_random(exponent):
    """Random quotients in (-127.5, 127.5) at every bf16 mantissa; the
    fallback runs for a few elements in ten thousand."""
    rng = np.random.RandomState(exponent + 1000)
    sf = _mantissas() * F32(2.0 ** exponent)
    quo = rng.uniform(-127.49, 127.49, (128, 8192))
    x = (quo * sf[:, None].astype(np.float64)).astype(F32)
    q, ok = model_quotient(x, sf[:, None])
    assert np.array_equal(q, ieee_quotient(x, sf[:, None]))
    assert 0 < (~ok).mean() < 2.0 ** -10


def test_quotient_scale_edge_cases():
    """sf a bf16 subnormal (rcp infinite or outside the normal range: every
    element divides), sf at the normal boundary, sf = inf (rcp 0: finite x
    gives 0, an infinite x NaN -> 0), against every finite bf16 sf."""
    rng = np.random.RandomState(7)
    sfs = np.concatenate([bf16_values(), [np.inf]]).astype(F32)
    x = np.clip(rng.uniform(-127.49, 127.49, (sfs.size, 16))
                * np.where(np.isinf(sfs), 1.0, sfs)[:, None],
                -3.4e38, 3.4e38).astype(F32)
    x[-1, :3] = [np.inf, -np.inf, 0.0]
    with np.errstate(over="ignore"):
        q, ok = model_quotient(x, sfs[:, None])
    assert np.array_equal(q, ieee_quotient(x, sfs[:, None]))
    sub = sfs < F32(2.0 ** -126)
    big = np.isfinite(sfs) & (sfs > F32(2.0 ** 126))
    assert sub.sum() == 127 and not ok[sub].any() and not ok[big].any()
    assert not ok[-1, :2].any() and ok[-1, 2:].all()


def _block(rng, amax):
    b = rng.uniform(-1, 1, 256) * amax
    b[rng.randint(256)] = amax * (1 if rng.rand() < 0.5 else -1)
    return b


def test_requant_blocks_match_the_reference():
    """Whole blocks, amax over every f32 binade (subnormal to near the
    largest finite), zeros, a NaN, an infinity: q and the scale."""
    rng = np.random.RandomState(11)
    blocks = [_block(rng, 2.0 ** e * m) for e in range(-149, 128)
              for m in (1.0, 1.3, 1.7)]
    blocks = np.asarray(blocks, F32)
    zero = np.zeros((1, 256), F32)
    nan = rng.randn(1, 256).astype(F32)
    nan[0, 17] = np.nan
    inf = rng.randn(2, 256).astype(F32)
    inf[0, 3], inf[1, 200] = np.inf, -np.inf
    inf[1, 201] = np.inf
    blocks = np.concatenate([blocks, zero, nan, inf])
    with np.errstate(over="ignore"):
        q, sc = model_requant(blocks)
    rq, rsc = reference_requant(blocks)
    _same(sc, rsc)
    assert np.array_equal(q, rq)
    assert np.array_equal(q[-4:-2], 0 * q[-4:-2])


def test_requant_at_the_largest_quotient():
    """amax / 127 just below a bf16 tie rounds down the furthest, so
    amax / sf is largest (127 (1 + 2^-8) ~ 127.496 < 127.5): every binade
    of sf, q +-127 there."""
    e = np.arange(-126, 121)
    a = (1 + 2.0 ** -8) * (1 - 2.0 ** -20) * 2.0 ** e   # just below a tie
    amax = (a * 127).astype(F32)
    blocks = np.zeros((e.size, 256), F32)
    blocks[:, 0], blocks[:, 1] = amax, -amax
    blocks[:, 2:] = np.nextafter(amax, F32(0))[:, None]
    sc = bf16_rne(amax / F32(127))
    assert np.array_equal(sc, (2.0 ** e).astype(F32))
    assert np.all(amax / sc > 127.49)
    q, _ = model_requant(blocks)
    rq, _ = reference_requant(blocks)
    assert np.array_equal(q, rq)
    assert np.array_equal(q[:, :2], np.tile([127, -127], (e.size, 1)))


def test_requant_model_matches_the_plain_version():
    """The model against ops.kernels.quantize_plain (what the card's
    kernel is held against) on random blocks of many scales."""
    rng = np.random.RandomState(3)
    flat = np.concatenate([_block(rng, 10.0 ** rng.uniform(-40, 38))
                           for _ in range(400)]).astype(F32)
    q, sc = K.quantize_plain(torch.from_numpy(flat))
    mq, msc = model_requant(flat.reshape(-1, 256))
    assert np.array_equal(q.numpy(), mq.reshape(-1))
    _same(sc.float().numpy(), msc)


def test_int8_to_float_and_back_without_conversions():
    """unpack4: the byte biased by 128 in the mantissa of 2^23, less
    2^23 + 128, is the int8 exactly; pack4: the low byte of v + kRound is
    v for every int8."""
    v = np.arange(-128, 128, dtype=np.int32)
    biased = (v.astype(np.uint32) ^ 0x80) & 0xFF
    f = (biased | 0x4B000000).astype(np.uint32).view(F32) - F32(8388736.0)
    assert np.array_equal(f, v.astype(F32))
    assert np.array_equal(low_byte((v.astype(F32) + ROUND).astype(F32)),
                          v.astype(np.int8))


def _f32_patterns(rng, n):
    bits = rng.randint(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32)
    special = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1e-45, -1e-45,
                        2.0 ** -126, 3.4028235e38, -3.4028235e38], F32)
    return np.concatenate([bits.view(F32), special])


@pytest.mark.parametrize("k", list(range(1, 31)))
def test_average_by_a_power_of_two_is_a_multiply(k):
    """acc * (1.0f / 2^k) == acc / 2^k for every f32 class: both are the
    correctly rounded quotient (subnormal results included, no flush)."""
    rng = np.random.RandomState(k)
    acc = _f32_patterns(rng, 1 << 16)
    inv = F32(1.0) / F32(2 ** k)                # the host's, in f32: exact
    assert inv == F32(2.0 ** -k)
    with np.errstate(all="ignore"):
        _same((acc * inv).view(np.uint32)[~np.isnan(acc)],
              (acc / F32(2 ** k)).view(np.uint32)[~np.isnan(acc)])
        assert np.isnan(acc * inv).sum() == np.isnan(acc).sum()


def test_average_by_other_divisors_is_not_a_multiply():
    """Why any other N keeps the divide: a multiply by 1/3 misrounds."""
    acc = np.arange(1, 4097, dtype=F32)
    assert not np.array_equal(acc * (F32(1) / F32(3)), acc / F32(3))
