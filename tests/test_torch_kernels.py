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


@pytest.mark.parametrize("divisor", [None, 8])
def test_dequant_accumulate_requantize_bit_equal(mode, divisor):
    n, sp = 8, 2048
    qr, scj, sct = _wire_image(n, sp, seed=4)
    q2, s2 = K.dequant_accumulate_requantize(
        torch.from_numpy(qr), sct, divisor=divisor)
    if mode == "pallas_interpret":
        qj, sj = pk.dequant_accumulate_requantize(
            jnp.asarray(qr), scj, jnp.float32, 256, divisor=divisor)
    else:
        shard = _jax_deq_acc(qr, scj, mode)
        if divisor is not None:
            shard = shard / divisor
        qj, sj = jc.quantize_blockwise(shard, use_pallas=False)
    _assert_bits(q2, qj)
    _assert_bits(s2, sj)


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
