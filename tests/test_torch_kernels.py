"""horovod_tpu_torch.ops.kernels: each kernel's plain version against the
JAX package on the same numpy inputs.

The JAX side runs both ways the JAX package's own tests run it on the
CPU: the Pallas kernels in interpret mode (``HOROVOD_PALLAS=1``) and the
discrete jnp path (``=0``). The bar is bit equality for the int8 wire
(quantize, roundtrip, dequant-accumulate, dequant-accumulate-requantize,
the per-row dequantize of the parameter gather), 2 ULP at the operand's
scale for fused Adam, as ``tests/test_pallas.py`` pins the Pallas kernel
against optax, and that test's rtol 2e-5 / atol 2e-6 for the Adasum
combines (their sums run in another order; a 16-bit output where the f32
value sits on a rounding boundary may land one ULP off). The CUDA
kernels themselves are held against these plain versions on the card by
``chip_smoke.py``; a CUDA tensor never reaches a plain version.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from horovod_tpu import compression as jc
from horovod_tpu.ops import pallas_kernels as pk
from horovod_tpu_torch import compression as tc
from horovod_tpu_torch.ops import kernels as K

import test_torch_workers as W

pytestmark = pytest.mark.torch_port

MODES = ["pallas_interpret", "discrete"]


@pytest.fixture(params=MODES)
def mode(request, monkeypatch):
    monkeypatch.setenv("HOROVOD_PALLAS",
                       "1" if request.param == "pallas_interpret" else "0")
    return request.param


def _rng(seed):
    return np.random.RandomState(seed)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()
    a = np.asarray(x)
    return a.astype(np.float32) if a.dtype == jnp.bfloat16 else a


def _assert_bits(port, ref):
    """Bit equality; a NaN must meet a NaN (its payload is not part of the
    contract: PyTorch, XLA and CUDA each pick their own)."""
    p, r = _np(port), _np(ref)
    assert p.shape == r.shape
    if p.dtype == np.float32:
        nan = np.isnan(p)
        assert np.array_equal(nan, np.isnan(r))
        p, r = p[~nan], r[~nan]
    assert np.array_equal(p.view(np.uint8) if p.dtype == np.int8 else p,
                          r.view(np.uint8) if r.dtype == np.int8 else r), \
        f"{np.abs(p.astype(np.float64) - r).max()}"
    if p.dtype == np.float32:
        assert np.array_equal(p.view(np.uint32), r.view(np.uint32))


def _jax_quantize(flat, mode):
    if mode == "pallas_interpret":
        return jc.quantize_blockwise(jnp.asarray(flat))
    return jc.quantize_blockwise(jnp.asarray(flat), use_pallas=False)


@pytest.mark.parametrize("length", [256, 2048, 1111, 255, 4096 + 3])
def test_quantize_bit_equal(mode, length):
    flat = _rng(length).randn(length).astype(np.float32)
    q, s = tc.quantize_blockwise(torch.from_numpy(flat))
    qj, sj = _jax_quantize(flat, mode)
    _assert_bits(q, qj)
    _assert_bits(s, sj)


def test_quantize_all_zero_blocks(mode):
    flat = np.concatenate([np.zeros(256, np.float32),
                           _rng(1).randn(256).astype(np.float32),
                           np.zeros(256, np.float32)])
    q, s = tc.quantize_blockwise(torch.from_numpy(flat))
    qj, sj = _jax_quantize(flat, mode)
    _assert_bits(q, qj)
    _assert_bits(s, sj)
    assert float(s[0]) == 0.0 and int(q[:256].abs().sum()) == 0


def test_quantize_half_way_values_round_to_even(mode):
    """scale 1 exactly (amax 127): x/scale lands on .5 and must round half
    to even, as jnp.round does (roundf would round away from zero)."""
    row = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 3.5, -3.5] * 32,
                   np.float32)
    q, s = tc.quantize_blockwise(torch.from_numpy(row))
    qj, sj = _jax_quantize(row, mode)
    _assert_bits(q, qj)
    _assert_bits(s, sj)
    assert q[:8].tolist() == [127, 0, 2, 2, 0, -2, 4, -4]


def test_quantize_bf16_scale_rounding(mode):
    base = np.linspace(0.9, 1.1, 256).astype(np.float32)
    rows = []
    for amax in (1.0, 1.0 + 2 ** -9, 127.0 * (1 + 2 ** -8), 3e-5, 1e37):
        r = base.copy()
        r[17] = amax
        rows.append(r / r.max() * amax)
    flat = np.concatenate(rows).astype(np.float32)
    q, s = tc.quantize_blockwise(torch.from_numpy(flat))
    qj, sj = _jax_quantize(flat, mode)
    _assert_bits(q, qj)
    _assert_bits(s, sj)


def _nonfinite_blocks(case):
    r = _rng(5)
    rows = [r.randn(256).astype(np.float32) for _ in range(4)]
    if case in ("nan", "mixed"):
        rows[1][17] = np.nan
    if case in ("inf", "mixed"):
        rows[2][3] = np.inf
        rows[3][200] = -np.inf
    return np.concatenate(rows + [r.randn(100).astype(np.float32)])


@pytest.mark.parametrize("case", ["nan", "inf", "mixed"])
def test_quantize_nonfinite_blocks(mode, case):
    """A NaN makes its block's scale NaN and its q 0; an infinity makes the
    scale inf and every q of the block 0 (inf / inf casts to 0); the
    roundtrip image of such a block is NaN. Other blocks are untouched."""
    flat = _nonfinite_blocks(case)
    q, s = tc.quantize_blockwise(torch.from_numpy(flat))
    qj, sj = _jax_quantize(flat, mode)
    _assert_bits(q, qj)
    _assert_bits(s, sj)
    bad = [1] * (case != "inf") + [2, 3] * (case != "nan")
    assert int(q.reshape(-1, 256)[bad].abs().sum()) == 0
    assert bool(torch.isfinite(s[0])) and int(q[:256].abs().max()) == 127
    q, s, rt = tc.quantize_chunked(torch.from_numpy(flat), 2)
    qj, sj, rtj = jc.quantize_chunked(
        jnp.asarray(flat), 2, use_pallas=(mode == "pallas_interpret"))
    _assert_bits(q, qj)
    _assert_bits(s, sj)
    _assert_bits(rt, rtj)


def test_quantize_bucketplan_shapes(mode):
    """The per-bucket flat lengths a BucketPlan partition produces."""
    import jax
    from horovod_tpu.ops.overlap import BucketPlan

    leaves = [jax.ShapeDtypeStruct(s, jnp.float32)
              for s in [(40, 30), (33,), (64, 64), (7,)]]
    plan = BucketPlan.build(leaves, n=8, bucket_bytes=4096)
    assert len(plan.buckets) >= 2
    for i, b in enumerate(plan.buckets):
        flat = _rng(100 + i).randn(b.Lp).astype(np.float32)
        q, s = tc.quantize_blockwise(torch.from_numpy(flat))
        qj, sj = _jax_quantize(flat, mode)
        _assert_bits(q, qj)
        _assert_bits(s, sj)


@pytest.mark.parametrize("n,length", [(8, 2048), (2, 1230), (3, 999)])
def test_quantize_chunked_roundtrip(mode, n, length):
    """The one-pass (q, scales, roundtrip) wire image of the error-feedback
    path, in the chunk layout of the quantized reduce-scatter."""
    flat = _rng(7).randn(length).astype(np.float32)
    q, s, rt = tc.quantize_chunked(torch.from_numpy(flat), n)
    qj, sj, rtj = jc.quantize_chunked(
        jnp.asarray(flat), n, use_pallas=(mode == "pallas_interpret"))
    _assert_bits(q, qj)
    _assert_bits(s, sj)
    _assert_bits(rt, rtj)
    _assert_bits(tc.quantize_roundtrip_chunked(torch.from_numpy(flat), n), rtj)


def _wire_image(n, sp, seed):
    r = _rng(seed)
    qr = r.randint(-127, 128, (n, sp)).astype(np.int8)
    sc = (np.abs(r.randn(n, sp // 256)) * 0.01).astype(np.float32)
    sc[:, 0] = 0.0
    qr[:, :256] = 0
    scj = jnp.asarray(sc).astype(jnp.bfloat16)
    sct = torch.from_numpy(sc).to(torch.bfloat16)
    return qr, scj, sct


def _jax_deq_acc(qr, scj, mode):
    if mode == "pallas_interpret":
        return pk.dequant_accumulate(jnp.asarray(qr), scj, jnp.float32, 256)
    n, sp = qr.shape
    return jc.dequantize_blockwise(
        jnp.asarray(qr).reshape(-1), scj.reshape(-1), jnp.float32
    ).reshape(n, sp).sum(axis=0)


@pytest.mark.parametrize("n,sp", [(8, 1536), (2, 512), (1, 2048)])
def test_dequant_accumulate_bit_equal(mode, n, sp):
    qr, scj, sct = _wire_image(n, sp, seed=3 + n)
    out = K.dequant_accumulate(torch.from_numpy(qr), sct)
    _assert_bits(out, _jax_deq_acc(qr, scj, mode))


def _jax_deq_acc_requant(qr, scj, mode, divisor):
    if mode == "pallas_interpret":
        return pk.dequant_accumulate_requantize(
            jnp.asarray(qr), scj, jnp.float32, 256, divisor=divisor)
    shard = _jax_deq_acc(qr, scj, mode)
    if divisor is not None:
        shard = shard / divisor
    return jc.quantize_blockwise(shard, use_pallas=False)


@pytest.mark.parametrize("divisor", [None, 1, 2, 3, 4, 6, 8])
def test_dequant_accumulate_requantize_bit_equal(mode, divisor):
    n, sp = 8, 2048
    qr, scj, sct = _wire_image(n, sp, seed=4)
    q2, s2 = K.dequant_accumulate_requantize(
        torch.from_numpy(qr), sct, divisor=divisor)
    qj, sj = _jax_deq_acc_requant(qr, scj, mode, divisor)
    _assert_bits(q2, qj)
    _assert_bits(s2, sj)


@pytest.mark.parametrize("divisor", [None, 2])
def test_dequant_accumulate_requantize_half_way(mode, divisor):
    """Exact half-way quotients after the divide: two senders at scale 1,
    127 + 127 at a block's first element (the sum's max, so the scale is
    2 / divisor) and odd sums elsewhere, each on a half-integer; they
    round half to even as jnp.round does."""
    n, sp = 2, 512
    qr, _, _ = _wire_image(n, sp, seed=9)
    sc = np.full((n, sp // 256), 0.01, np.float32)
    sc[:, 0] = 1.0
    qr[:, :256] = 0
    qr[:, 0] = 127
    qr[0, 1:256] = (np.arange(255) % 63 * 2 + 1) * (1 - 2 * (np.arange(255) % 2))
    scj = jnp.asarray(sc).astype(jnp.bfloat16)
    sct = torch.from_numpy(sc).to(torch.bfloat16)
    acc = qr[:, :256].astype(np.float32).sum(axis=0) / np.float32(divisor or 1)
    sf = np.float32(2.0 / (divisor or 1))
    assert np.all(np.abs(acc[1:] / sf) % 1 == 0.5)
    q2, s2 = K.dequant_accumulate_requantize(
        torch.from_numpy(qr), sct, divisor=divisor)
    assert s2[0].item() == sf
    qj, sj = _jax_deq_acc_requant(qr, scj, mode, divisor)
    _assert_bits(q2, qj)
    _assert_bits(s2, sj)
    assert np.array_equal(q2[:256].numpy(), np.clip(np.rint(acc / sf), -127, 127))


def test_dequant_accumulate_requantize_nonfinite(mode):
    """A NaN or an infinite scale on the wire (a sender's non-finite
    block) reaches the sum and the requantized block as in the
    reference."""
    n, sp = 4, 1024
    qr, scj, sct = _wire_image(n, sp, seed=6)
    sc = np.array(scj.astype(jnp.float32))
    sc[1, 1], sc[2, 2], sc[3, 2] = np.nan, np.inf, np.inf
    scj = jnp.asarray(sc).astype(jnp.bfloat16)
    sct = torch.from_numpy(sc).to(torch.bfloat16)
    _assert_bits(K.dequant_accumulate(torch.from_numpy(qr), sct),
                 _jax_deq_acc(qr, scj, mode))
    q2, s2 = K.dequant_accumulate_requantize(torch.from_numpy(qr), sct,
                                             divisor=n)
    if mode == "pallas_interpret":
        qj, sj = pk.dequant_accumulate_requantize(
            jnp.asarray(qr), scj, jnp.float32, 256, divisor=n)
    else:
        qj, sj = jc.quantize_blockwise(_jax_deq_acc(qr, scj, mode) / n,
                                       use_pallas=False)
    _assert_bits(q2, qj)
    _assert_bits(s2, sj)
    assert bool(torch.isnan(s2[1:3]).all())


# --------------------------------------------------------------------------
# fused Adam


def _ulp_close(a, b, scale, ulps=2):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    tol = ulps * np.spacing(
        np.maximum(np.maximum(np.abs(a), np.abs(b)), scale).astype(np.float32))
    assert (np.abs(a - b) <= tol).all(), np.abs(a - b).max()


def _bias_corrections(b1, b2, count):
    """``1 - b**count`` as optax takes it: under jit (its
    ``tree_bias_correction`` is jitted; op-by-op jnp rounds the ``pow``
    differently, and ``1 - pow`` cancels most digits)."""
    import jax

    return jax.jit(lambda c: (1 - b1 ** c, 1 - b2 ** c))(
        jnp.asarray(count, jnp.int32))


def _adam_inputs(L, seed):
    r = _rng(seed)
    g = r.randn(L).astype(np.float32)
    mu = (r.randn(L) * 0.01).astype(np.float32)
    nu = (np.abs(r.randn(L)) * 1e-4).astype(np.float32)
    return g, mu, nu


@pytest.mark.parametrize("count", [1, 3, 50, 1000])
def test_fused_adam_vs_jax(mode, count):
    g, mu, nu = _adam_inputs(1200, 21)
    b1, b2, eps, lr = 0.9, 0.999, 1e-8, 1e-3
    u, m, v = K.fused_adam_update(
        torch.from_numpy(g), torch.from_numpy(mu), torch.from_numpy(nu),
        count, lr=lr, b1=b1, b2=b2, eps=eps)
    b1c, b2c = _bias_corrections(b1, b2, count)
    if mode == "pallas_interpret":
        uj, mj, vj = pk.fused_adam_update(
            jnp.asarray(g), jnp.asarray(mu), jnp.asarray(nu), b1c, b2c,
            lr=lr, b1=b1, b2=b2, eps=eps)
    else:  # optax's expression chain, as test_pallas.py spells it
        mj = (1 - b1) * g + b1 * mu
        vj = (1 - b2) * (g ** 2) + b2 * nu
        uj = -lr * ((mj / b1c) / (jnp.sqrt(vj / b2c) + eps))
    if mode == "discrete":
        # op by op, each rounding on its own: the port's chain is the same
        for a, b in ((u, uj), (m, mj), (v, vj)):
            _assert_bits(a, np.asarray(b))
        return
    # the interpreted kernel runs under jit, where XLA contracts the
    # moment updates into FMAs: it sits up to 4 ULP (at the lr scale) from
    # the op-by-op chain — as jitted optax.adam does — so the bar against
    # it is the per-step relative 1e-6 (with 2 ULP of slack at zero)
    np.testing.assert_allclose(m.numpy(), np.asarray(mj), rtol=1e-6,
                               atol=2 * np.spacing(np.abs(g).max()))
    np.testing.assert_allclose(v.numpy(), np.asarray(vj), rtol=1e-6,
                               atol=2 * np.spacing(np.asarray(vj).max()))
    np.testing.assert_allclose(u.numpy(), np.asarray(uj), rtol=1e-6,
                               atol=2 * np.spacing(np.float32(lr)))


def test_plain_adam_matches_optax_steps():
    """Several steps of the port's Adam (plain and fused, identical on the
    CPU) track optax.adam within 2 ULP per step at the update scale."""
    import optax

    from horovod_tpu_torch import optim as to

    r = _rng(22)
    p = {"w": r.randn(40, 30).astype(np.float32),
         "b": r.randn(30).astype(np.float32)}
    ref = optax.adam(1e-3)
    sj = ref.init({k: jnp.asarray(v) for k, v in p.items()})
    plain, fused = to.adam(1e-3), to.fused_adam(1e-3)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    s0, s1 = plain.init(tp), fused.init(tp)
    for _ in range(5):
        g = {"w": r.randn(40, 30).astype(np.float32),
             "b": r.randn(30).astype(np.float32)}
        uj, sj = ref.update({k: jnp.asarray(v) for k, v in g.items()}, sj)
        tg = {k: torch.from_numpy(v) for k, v in g.items()}
        u0, s0 = plain.update(tg, s0)
        u1, s1 = fused.update(tg, s1)
        for k in ("w", "b"):
            assert torch.equal(u0[k], u1[k])
            np.testing.assert_allclose(u0[k].numpy(), np.asarray(uj[k]),
                                       rtol=5e-5, atol=5e-8)
            # keep the moments in lockstep so the ULP bar is per step
            s0["mu"][k] = torch.from_numpy(np.array(sj[0].mu[k]))
            s0["nu"][k] = torch.from_numpy(np.array(sj[0].nu[k]))
            s1["mu"][k], s1["nu"][k] = s0["mu"][k], s0["nu"][k]


def test_cuda_tensor_never_takes_the_plain_version(monkeypatch):
    """A tensor on a CUDA device goes to the kernel launch, never to the
    plain version (the launch is stubbed: this machine has no card). The
    Adasum kernels read operands at any element offset: a leaf sliced out
    of a group buffer at an odd offset is launched as it is."""
    called = []
    monkeypatch.setattr(K, "_on_cuda", lambda *ts: True)
    monkeypatch.setattr(K, "_launch", lambda kernel, *a: called.append(kernel))
    q, s = K.quantize_blockwise(torch.zeros(512))
    assert called == ["quantize"] and q.dtype == torch.int8
    out = K.dequantize_rows(torch.zeros(2, 512, dtype=torch.int8),
                            torch.zeros(2, 2, dtype=torch.bfloat16))
    assert called[-1] == "dequantize_rows" and out.shape == (2, 512)
    buf = torch.zeros(1001, dtype=torch.float16)
    a, b = buf[1:501], buf[501:]
    assert a.data_ptr() % 16 and b.data_ptr() % 16
    assert K.adasum_pair_combine(a, b).dtype == torch.float16
    assert called[-1] == "adasum_pair_combine"
    flat = torch.zeros(1001)[1:]
    K.adasum_segment_combine(flat, flat.clone(), (0, 10, 1000))
    assert called == ["quantize", "dequantize_rows", "adasum_pair_combine",
                      "adasum_segment_combine"]
    with pytest.raises(TypeError):
        K.adasum_pair_combine(a, b.float())
    with pytest.raises(ValueError, match="cover"):
        K.adasum_segment_combine(flat, flat, (0, 10, 999))


def test_other_devices_raise():
    with pytest.raises(ValueError, match="device"):
        K.quantize_blockwise(torch.zeros(512, device="meta"))


# --------------------------------------------------------------------------
# per-row dequantize of the ZeRO-3 int8 parameter gather


@pytest.mark.parametrize("n", [1, 2, 8])
@pytest.mark.parametrize("sp", [256, 768, 2304])
def test_dequantize_rows_bit_equal(mode, n, sp):
    """``sp`` a multiple of the block but not of the Pallas kernel's
    1024-column chunk; a NaN and an infinite scale block included."""
    qr, _, _ = _wire_image(n, sp, seed=8 + n)
    sc = (np.abs(_rng(sp).randn(n, sp // 256)) * 0.01).astype(np.float32)
    sc[0, 0] = np.nan
    sc[n - 1, -1] = np.inf
    scj = jnp.asarray(sc).astype(jnp.bfloat16)
    sct = torch.from_numpy(sc).to(torch.bfloat16)
    out = K.dequantize_rows(torch.from_numpy(qr), sct)
    want = jc.dequantize_rows(jnp.asarray(qr), scj, jnp.float32,
                              use_pallas=(mode == "pallas_interpret"))
    _assert_bits(out, want)
    assert out.shape == (n, sp) and bool(torch.isnan(out[0, :256]).any())


# --------------------------------------------------------------------------
# Adasum combines


def _assert_combine_close(port, ref):
    """rtol 2e-5 / atol 2e-6; a 16-bit output may instead sit one ULP of
    its type away (the f32 value on a rounding boundary), and rarely."""
    p = port.float().numpy()
    r = np.asarray(jnp.asarray(ref).astype(jnp.float32))
    off = ~np.isclose(p, r, rtol=2e-5, atol=2e-6)
    if port.dtype == torch.float32:
        assert not off.any(), np.abs(p - r).max()
        return
    ulp = np.abs(np.asarray(jnp.asarray(ref), np.float32)) * 2.0 ** -(
        8 if port.dtype == torch.bfloat16 else 11) + 1e-30
    assert (np.abs(p - r)[off] <= ulp[off] * 2).all()
    assert off.mean() < 0.01


def _jax_pair(a, b, mode):
    from horovod_tpu.ops import adasum as jada

    if mode == "pallas_interpret":
        return pk.adasum_pair_combine(a, b)
    return jada._pair_combine(a, b)


DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16),
          "f16": (torch.float16, jnp.float16)}


PAIR_SHAPES = [(1200,), (40, 30), (3000,), (8,)]


@pytest.mark.parametrize("shape", PAIR_SHAPES)
def test_adasum_pair_combine_vs_jax(mode, shape):
    _check_pair(mode, shape, "f32")


@pytest.mark.parametrize("shape", PAIR_SHAPES)
@pytest.mark.parametrize("dtype", ["bf16", "f16"])
def test_adasum_pair_combine_16bit_vs_pallas(monkeypatch, shape, dtype):
    """16-bit operands against the Pallas path only, which sums in f32 as
    the port does (the discrete ``jnp.vdot`` sums them in 16 bits)."""
    monkeypatch.setenv("HOROVOD_PALLAS", "1")
    _check_pair("pallas_interpret", shape, dtype)


def _check_pair(mode, shape, dtype):
    tt, jt = DTYPES[dtype]
    r = _rng(11)
    a = r.randn(*shape).astype(np.float32)
    b = r.randn(*shape).astype(np.float32)
    aj, bj = jnp.asarray(a).astype(jt), jnp.asarray(b).astype(jt)
    at = torch.from_numpy(np.array(aj.astype(jnp.float32))).to(tt)
    bt = torch.from_numpy(np.array(bj.astype(jnp.float32))).to(tt)
    out = K.adasum_pair_combine(at, bt)
    assert out.shape == shape and out.dtype == tt
    _assert_combine_close(out, _jax_pair(aj, bj, mode))


def test_adasum_pair_combine_zero_operands(mode):
    """``|a|² == 0`` zeroes its coefficient: combine(0, b) == cb·b and
    combine(0, 0) == 0, no NaN from 0/0."""
    z = np.zeros(600, np.float32)
    b = _rng(12).randn(600).astype(np.float32)
    out = K.adasum_pair_combine(torch.from_numpy(z), torch.from_numpy(b))
    _assert_combine_close(out, _jax_pair(jnp.asarray(z), jnp.asarray(b), mode))
    zz = K.adasum_pair_combine(torch.zeros(600), torch.zeros(600))
    assert bool((zz == 0).all())


@pytest.mark.parametrize("sizes", [[1000, 1, 500, 1571], [7, 0, 3000, 1]])
def test_adasum_segment_combine_vs_jax(mode, sizes):
    """A length-1 segment, an empty one, segments across the Pallas
    kernel's 1024-element chunks, and one all-zero segment."""
    from horovod_tpu.ops import adasum as jada

    L = sum(sizes)
    r = _rng(13)
    a = r.randn(L).astype(np.float32)
    b = r.randn(L).astype(np.float32)
    a[:sizes[0]] = 0.0
    offsets = np.concatenate([[0], np.cumsum(sizes)])
    seg = jnp.asarray(np.repeat(np.arange(len(sizes)), sizes))
    if mode == "pallas_interpret":
        want = pk.adasum_segment_combine(jnp.asarray(a), jnp.asarray(b), seg,
                                         len(sizes))
    else:
        want = jada._segment_combine(jnp.asarray(a), jnp.asarray(b), seg,
                                     len(sizes))
    out = K.adasum_segment_combine(torch.from_numpy(a), torch.from_numpy(b),
                                   offsets)
    _assert_combine_close(out, want)


@pytest.mark.parametrize("dtype", ["f32", "bf16", "f16"])
def test_segment_plain_is_the_pair_plain_of_each_segment(dtype):
    """The plain segmented combine widens to f32 before every product and
    narrows the blend to the operands' type, segment by segment: each
    segment's output is ``adasum_pair_combine_plain`` of that segment
    alone, bit for bit (a length-1, an empty, a zero and a chunk-crossing
    segment)."""
    tt = DTYPES[dtype][0]
    sizes = [1000, 1, 0, 8197, 7, 300]
    offsets = np.concatenate([[0], np.cumsum(sizes)])
    r = _rng(14)
    a = torch.from_numpy(r.randn(offsets[-1]).astype(np.float32)).to(tt)
    b = torch.from_numpy(r.randn(offsets[-1]).astype(np.float32)).to(tt)
    a[1001:9198] = 0.0
    out = K.adasum_segment_combine_plain(a, b, offsets)
    assert out.dtype == tt and out.shape == a.shape
    for lo, hi in zip(offsets, offsets[1:]):
        _assert_bits(out[lo:hi], K.adasum_pair_combine_plain(
            a[lo:hi].clone(), b[lo:hi].clone()))


def test_packed_combine_reaches_the_kernel_in_16_bits(monkeypatch):
    """A CUDA leaf table in bf16 or f16 goes to one launch counted as
    ``adasum_pair_combine``; the segmented wrappers take every operand
    type and refuse mixed ones, offsets that miss the buffer's end and
    (once per layout) offsets that decrease (the launch is stubbed: no
    card here)."""
    called = []
    monkeypatch.setattr(K, "_on_cuda", lambda *ts: True)
    monkeypatch.setattr(K, "_launch", lambda kernel, *a: called.append(kernel))
    offsets = (0, 7, 8, 72, 72)
    for tt in (torch.bfloat16, torch.float16):
        flat = torch.zeros(72, dtype=tt)
        assert K.adasum_pair_combine_packed(flat, flat, offsets).dtype == tt
        assert K.adasum_segment_combine(flat, flat, offsets).dtype == tt
    assert called == ["adasum_pair_combine", "adasum_segment_combine"] * 2
    with pytest.raises(TypeError):
        K.adasum_pair_combine_packed(flat, flat.float(), offsets)
    with pytest.raises(ValueError, match="cover"):
        K.adasum_pair_combine_packed(flat, flat, (0, 7, 70))
    with pytest.raises(ValueError, match="decrease"):
        K.adasum_pair_combine_packed(flat, flat, (0, 40, 8, 72))


# --------------------------------------------------------------------------
# fused Adam as one multi-tensor launch, and its int8 epilogue

ADAM_LEAVES = {
    "ragged": {"a": (1,), "b": (3,), "c": (257,), "d": (4099,), "e": (0,)},
    "shaped": {"conv/kernel": (3, 3, 4, 8), "conv/bias": (8,),
               "dense/kernel": (40, 30), "dense/bias": (30,)},
}


@pytest.mark.parametrize("leaves", list(ADAM_LEAVES))
def test_fused_adam_multi_vs_jax_fused_adam(monkeypatch, leaves):
    """Three steps of ``fused_adam_multi`` over every leaf at once against
    the JAX package's ``optim.fused_adam`` (its CPU path, the optax chain
    op by op): bit-equal per leaf, update and moments, an empty leaf
    included."""
    from horovod_tpu import optim as jo
    from horovod_tpu_torch.optim import tree_keys

    monkeypatch.setenv("HOROVOD_PALLAS", "0")
    shapes = ADAM_LEAVES[leaves]
    keys = tree_keys(shapes)
    r = _rng(51)
    tx = jo.fused_adam(1e-3)
    sj = tx.init({k: jnp.zeros(s, jnp.float32) for k, s in shapes.items()})
    mus = [torch.zeros(shapes[k]) for k in keys]
    nus = [torch.zeros(shapes[k]) for k in keys]
    for count in (1, 2, 3):
        g = {k: r.randn(*s).astype(np.float32) for k, s in shapes.items()}
        uj, sj = tx.update({k: jnp.asarray(v) for k, v in g.items()}, sj)
        us, mus, nus = K.fused_adam_multi(
            [torch.from_numpy(g[k]) for k in keys], mus, nus, count, lr=1e-3)
        for k, u, m, v in zip(keys, us, mus, nus):
            assert u.shape == shapes[k]
            _assert_bits(u, np.asarray(uj[k]))
            _assert_bits(m, np.asarray(sj[0].mu[k]))
            _assert_bits(v, np.asarray(sj[0].nu[k]))


@pytest.mark.parametrize("cap", [1, 2, 3, K.ADAM_MAX_LEAVES])
@pytest.mark.parametrize("lengths", [
    (1, 3, 257, 4099, 0), (K.ADAM_CHUNK, K.ADAM_CHUNK + 1, 0, 0, 5),
    tuple(range(0, 40000, 997))])
def test_adam_launch_plan_covers_every_element_once(cap, lengths):
    """The launch plan (chunks per leaf, the prefix table, the split at
    ``cap`` leaves a launch): every element of every leaf lies in exactly
    one chunk of one launch, in ``ceil(non-empty leaves / cap)``
    launches."""
    plan = K.adam_launch_plan(lengths, cap)
    live = [i for i, n in enumerate(lengths) if n]
    assert len(plan) == -(-len(live) // cap)
    cover = [np.zeros(n, np.int64) for n in lengths]
    for idx, first in plan:
        assert 1 <= len(idx) <= cap and first[0] == 0
        assert first.dtype == np.int32 and len(first) == len(idx) + 1
        for c in range(int(first[-1])):
            j = W.plan_leaf(first, c)
            lo = (c - int(first[j])) * K.ADAM_CHUNK
            assert lo < lengths[idx[j]]
            cover[idx[j]][lo:lo + K.ADAM_CHUNK] += 1
    assert [i for idx, _ in plan for i in idx] == live
    assert all((c == 1).all() for c in cover)


@pytest.mark.parametrize("layout", ["aligned", "offset_views", "strided"])
def test_fused_adam_multi_launch_table(monkeypatch, layout):
    """The CUDA path of ``fused_adam_multi`` up to the launch: one launch
    for every ``ADAM_MAX_LEAVES`` leaves, outputs as views of the leaves'
    shapes into three flat buffers at 16-byte boundaries, and a table
    that makes the kernel's rule write exactly the plain version's bits.
    Gradients may be views at any offset of one group buffer (Adasum) or
    strided (copied first)."""
    r = _rng(52)
    shapes = [(3,), (257,), (5, 7), (K.ADAM_CHUNK + 3,), (0,), (2, 3, 4)] * 50
    sizes = [int(np.prod(s)) for s in shapes]
    if layout == "offset_views":
        flat = torch.from_numpy(r.randn(sum(sizes) + len(sizes)).astype(np.float32))
        starts = np.cumsum([1] + [n + 1 for n in sizes])[:-1]
        gs = [flat[a:a + n].view(s) for a, n, s in zip(starts, sizes, shapes)]
    else:
        gs = [torch.from_numpy(r.randn(*s).astype(np.float32)) for s in shapes]
        if layout == "strided":
            gs = [g.t() if g.dim() == 2 else g for g in gs]
    mus = [torch.from_numpy((r.randn(*g.shape) * 0.01).astype(np.float32))
           for g in gs]
    nus = [torch.from_numpy((np.abs(r.randn(*g.shape)) * 1e-4).astype(
        np.float32)) for g in gs]
    want = K.fused_adam_multi(gs, mus, nus, 4, lr=1e-3)
    launched = []
    W.emulate_fused_adam(monkeypatch.setattr, launched)
    got = K.fused_adam_multi(gs, mus, nus, 4, lr=1e-3)
    live = sum(n > 0 for n in sizes)
    assert launched == [(min(K.ADAM_MAX_LEAVES, live - i), False)
                        for i in range(0, live, K.ADAM_MAX_LEAVES)]
    for outs, refs in zip(got, want):
        bases = {o.untyped_storage().data_ptr() for o in outs}
        assert len(bases) == 1                    # one flat buffer
        for o, ref in zip(outs, refs):
            assert o.shape == ref.shape and o.is_contiguous()
            assert o.data_ptr() % 16 == 0
            _assert_bits(o, ref)


@pytest.mark.parametrize("L", [3, 257, 1000, 4099])
def test_fused_adam_requant_epilogue_vs_jax(mode, L):
    """``fused_adam_update(..., requant_block=256)``: the update's
    blockwise int8 wire image, zero-padded to whole blocks, bit-equal to
    the JAX package's (the Pallas kernel's epilogue, or the optax chain
    on the padded shard quantized by the discrete path); the update within
    the bar of ``test_fused_adam_vs_jax``. Through the launch path too."""
    g, mu, nu = _adam_inputs(L, 53 + L)
    b1, b2, eps, lr, count = 0.9, 0.999, 1e-8, 1e-3, 3
    b1c, b2c = _bias_corrections(b1, b2, count)
    u, m, v, (q, s) = K.fused_adam_update(
        torch.from_numpy(g), torch.from_numpy(mu), torch.from_numpy(nu),
        count, lr=lr, requant_block=256)
    nb = -(-L // 256)
    assert q.shape == (nb * 256,) and s.shape == (nb,) and u.shape == (L,)
    if mode == "pallas_interpret":
        uj, _, _, (qj, sj) = pk.fused_adam_update(
            jnp.asarray(g), jnp.asarray(mu), jnp.asarray(nu), b1c, b2c,
            lr=lr, b1=b1, b2=b2, eps=eps, requant_block=256)
        np.testing.assert_allclose(u.numpy(), np.asarray(uj), rtol=1e-6,
                                   atol=2 * np.spacing(np.float32(lr)))
    else:
        pad = nb * 256 - L
        gp, mp, vp = (np.concatenate([x, np.zeros(pad, np.float32)])
                      for x in (g, mu, nu))
        mj = (1 - b1) * gp + b1 * mp
        vj = (1 - b2) * (gp ** 2) + b2 * vp
        uj = -lr * ((mj / b1c) / (jnp.sqrt(vj / b2c) + eps))
        qj, sj = _jax_quantize(np.asarray(uj), mode)
        _assert_bits(u, np.asarray(uj)[:L])
    _assert_bits(q, np.asarray(qj).reshape(-1))
    _assert_bits(s, np.asarray(sj).reshape(-1))


def test_fused_adam_update_is_the_one_tensor_launch(monkeypatch):
    """``fused_adam_update`` on the card is one launch of the same kernel
    over one leaf, with or without the epilogue (the epilogue's q and
    scales come back from that launch)."""
    g, mu, nu = (torch.from_numpy(x) for x in _adam_inputs(1000, 54))
    ref = K.fused_adam_update(g, mu, nu, 2, lr=1e-3, requant_block=256)
    launched = []
    W.emulate_fused_adam(monkeypatch.setattr, launched)
    u, m, v = K.fused_adam_update(g, mu, nu, 2, lr=1e-3)
    out = K.fused_adam_update(g, mu, nu, 2, lr=1e-3, requant_block=256)
    assert launched == [(1, False), (1, True)]
    for a, b in zip((u, m, v), ref[:3]):
        _assert_bits(a, b)
    for a, b in zip((*out[:3], *out[3]), (*ref[:3], *ref[3])):
        _assert_bits(a, b)
    with pytest.raises(ValueError, match="block"):
        K.fused_adam_update(g, mu, nu, 2, lr=1e-3, requant_block=128)


def test_fused_adam_multi_groups_dtypes_and_takes_a_device_count(
        monkeypatch):
    """bf16 and f32 leaves in one ``fused_adam_multi`` call: one launch a
    dtype (f32 first, as first seen), every output in its leaf's dtype and
    each leaf the plain version's bits through the kernel's table (bf16
    leaves at 8-element, 16-byte boundaries). A 0-d count tensor (a
    guarded state's) reaches the kernel as the device buffer of its bias
    corrections, bit-equal to the same step at an int count."""
    r = _rng(57)
    shapes = [(5, 7), (K.ADAM_CHUNK + 3,), (257,), (3,), (2, 3, 4)]
    dts = [torch.float32, torch.bfloat16, torch.bfloat16, torch.float32,
           torch.bfloat16]
    gs = [torch.from_numpy(r.randn(*s).astype(np.float32)).to(d)
          for s, d in zip(shapes, dts)]
    mus = [(g.float() * 0.01).to(g.dtype) for g in gs]
    nus = [(g.float() ** 2 * 1e-4).to(g.dtype) for g in gs]
    want = K.fused_adam_multi(gs, mus, nus, 4, lr=1e-3)
    launched = []
    W.emulate_fused_adam(monkeypatch.setattr, launched)
    for count in (4, torch.tensor(3, dtype=torch.int32) + 1):
        launched.clear()
        got = K.fused_adam_multi(gs, mus, nus, count, lr=1e-3)
        assert launched == [(2, False), (3, False)]
        for outs, refs in zip(got, want):
            for o, ref, d in zip(outs, refs, dts):
                assert o.dtype == d and o.shape == ref.shape
                assert o.data_ptr() % 16 == 0
                _assert_bits(o, ref)


def test_every_launch_matches_its_c_signature(monkeypatch):
    """Each wrapper hands its C function exactly the arguments its
    ``argtypes`` declare, the stream last: an argument ctypes does not
    know the type of is passed as a 32-bit int and cuts a pointer."""
    import contextlib
    import ctypes

    calls = []

    def fn(lib, sym):
        def c_function(*args):
            types = K._ARGTYPES[sym]
            assert len(args) == len(types), (sym, len(args), len(types))
            for a, t in zip(args, types):
                t.from_param(a)          # raises where ctypes cannot convert
            calls.append(sym)
            return 0
        return c_function

    class _Stream:
        cuda_stream = 0

    monkeypatch.setattr(K, "_on_cuda", lambda *ts: True)
    monkeypatch.setattr(K, "_fn", fn)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d=None: _Stream())
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    x = torch.zeros(512)
    q8, sc = torch.zeros(2, 512, dtype=torch.int8), torch.zeros(2, 2, dtype=torch.bfloat16)
    K.quantize_roundtrip(x)
    K.dequant_accumulate(q8, sc)
    K.dequant_accumulate_requantize(q8, sc, divisor=2)
    K.fused_adam_multi([x, torch.zeros(3, 4)], [x, torch.zeros(12)],
                       [x, torch.zeros(12)], 1, lr=1e-3)
    K.fused_adam_update(x, x, x, 1, lr=1e-3, requant_block=256)
    xb = x.to(torch.bfloat16)
    K.fused_adam_multi([xb], [xb], [xb], torch.tensor(2, dtype=torch.int32),
                       lr=1e-3)
    qkv = torch.zeros(1, 64, 2, 64, dtype=torch.bfloat16)
    K.flash_fwd(qkv, qkv, qkv, causal=True)
    K.dequantize_rows(q8, sc)
    K.adasum_pair_combine(x, x)
    K.adasum_segment_combine(x, x, (0, 100, 512))
    xh = x.to(torch.bfloat16)
    K.adasum_pair_combine_packed(xh, xh, (0, 100, 104, 512, 512))
    assert calls == ["hvd_quantize", "hvd_dequant_accumulate",
                     "hvd_dequant_accumulate_requantize", "hvd_fused_adam",
                     "hvd_fused_adam", "hvd_fused_adam", "hvd_flash_fwd",
                     "hvd_dequantize_rows",
                     "hvd_adasum_combine", "hvd_adasum_combine",
                     "hvd_adasum_combine"]


@pytest.mark.parametrize("shape,dtype", [
    ((1023,), np.float32), ((1024,), np.float32), ((37, 41), np.float32),
    ((3, 3, 16, 32), np.float32), ((2000,), np.int32)])
def test_int8_roundtrip_matches_jax(shape, dtype):
    """``compression.int8_roundtrip`` against the JAX package's: the
    dequantized wire image bit for bit in the leaf's shape (a NaN and an
    infinity among the values), and the very tensor back below the
    ``MIN_QUANT_ELEMS`` floor or for a dtype that is not quantized."""
    r = _rng(81)
    x = (r.randn(*shape) * 3).astype(dtype)
    if dtype == np.float32 and x.size > 600:
        x.reshape(-1)[[5, 500]] = [np.nan, np.inf]
    t = torch.from_numpy(x)
    got = tc.int8_roundtrip(t)
    want = np.asarray(jc.int8_roundtrip(jnp.asarray(x)))
    assert tuple(got.shape) == shape and got.dtype == t.dtype
    if x.size < tc.MIN_QUANT_ELEMS or dtype != np.float32:
        assert got is t
    else:
        assert not np.array_equal(got.numpy(), x)    # the wire is lossy
    _assert_bits(got, want)
