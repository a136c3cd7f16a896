"""The weight handoff (protocol, publisher, subscriber) and its wiring into
the training loops, against the JAX package, on the CPU.

- the wire: keyframe and delta payloads of trees with f32, small, int,
  bool and bf16 leaves, port → JAX ``decode`` and JAX → port ``decode``
  bit-equal, the int8 records (quantized values and bf16 scales) and
  ``wire_bytes`` equal, and the device ingest (``decode(device=)``) equal
  to the host path;
- the handoff: each of the JAX package's publisher/subscriber traces
  (``tests/test_serving.py``) is written once against a package
  interface and run through both packages; what the trace observes
  (generations, kinds, steps, metrics, KV keys, the served trees' bits)
  must be equal. Covered: the delta chain, GC back to the keyframe, a
  lagging subscriber's resync past GC, corrupt chunks, the staleness
  watermark, the elastic fence, ``publish_fail``, ``kv_restart_at_step``
  with and without the WAL, HTTP transport (``KVStoreServer`` +
  ``KVStoreClient``) and ``InProcessKVStore``;
- across packages over one store: a JAX publisher to a port subscriber
  and a port publisher to a JAX subscriber;
- wiring: ``ElasticRun(publisher=, publish_every=)`` at a world of one
  against the JAX driver, the republish after a resize in a gloo world
  of 2, the SIGTERM drain's final publication before the emergency
  checkpoint, and ``PublishCallback``.
"""

import os
import pickle
import time
import types
from unittest import mock

import ml_dtypes
import numpy as np
import pytest
import torch
import jax

import horovod_tpu.callbacks as jcallbacks
import horovod_tpu.observability.metrics as jmetrics
import horovod_tpu.resilience.chaos as jchaos
import horovod_tpu.resilience.health as jhealth
import horovod_tpu.resilience.loop as jloop
import horovod_tpu.run.rendezvous as jrdv
import horovod_tpu.serving as jserving
from horovod_tpu.serving import protocol as jprotocol
import horovod_tpu_torch.callbacks as tcallbacks
import horovod_tpu_torch.observability.metrics as tmetrics
import horovod_tpu_torch.resilience.chaos as tchaos
import horovod_tpu_torch.resilience.health as thealth
import horovod_tpu_torch.resilience.loop as tloop
import horovod_tpu_torch.run.rendezvous as trdv
import horovod_tpu_torch.serving as tserving
from horovod_tpu_torch import pytree
from horovod_tpu_torch.serving import protocol as tprotocol
from horovod_tpu_torch.testing import run_world

import torch_serving_workers as SW

pytestmark = pytest.mark.torch_port


def _clear(pkg):
    with pkg.publisher._ACTIVE_LOCK:
        pkg.publisher._ACTIVE.clear()


@pytest.fixture(autouse=True)
def _fresh():
    for m, c, h in ((jmetrics, jchaos, jhealth), (tmetrics, tchaos, thealth)):
        m.reset()
        m.set_enabled(True)
        h.reset()
        c.configure(None)
    _clear(jserving)
    _clear(tserving)
    yield
    for m, c, h in ((jmetrics, jchaos, jhealth), (tmetrics, tchaos, thealth)):
        m.reset()
        h.reset()
        c.reset()
    _clear(jserving)
    _clear(tserving)


def _tree(seed=0, big=2048, small=7):
    rng = np.random.RandomState(seed)
    return {
        "dense": {"kernel": rng.randn(big).astype(np.float32).reshape(-1, 64)},
        "bias": rng.randn(small).astype(np.float32),
        "step_count": np.int32(seed),
    }


def _drift(tree, seed, scale=0.01):
    rng = np.random.RandomState(seed)

    def one(x):
        if isinstance(x, dict):
            return {k: one(v) for k, v in sorted(x.items())}
        x = np.asarray(x)
        if x.dtype.kind == "f":
            return x + scale * rng.randn(*x.shape).astype(x.dtype)
        return x

    return one(tree)


def _bits(tree) -> list:
    """Every leaf's dtype, shape and bytes in flatten order (a tensor's
    bf16 as its 16 bits), to compare trees of both packages bit for bit."""
    out = []
    for leaf in pytree.flatten(tree)[0]:
        if isinstance(leaf, torch.Tensor):
            t = leaf.detach().cpu()
            a = (t.view(torch.int16).numpy() if t.dtype == torch.bfloat16
                 else t.numpy())
        else:
            a = np.asarray(leaf)
        if a.dtype.itemsize == 2 and a.dtype.kind in "Vf":
            a = a.view(np.int16)   # bf16 of either package
        out.append((a.shape, a.tobytes()))
    return out


# ------------------------------------------------------------------ the wire


def _wire_trees(seed):
    """The same tree in each package's host form: f32 (quantized and
    raw), int, bool and bf16 leaves (``ml_dtypes`` for JAX, ``V2`` for
    the port)."""
    rng = np.random.RandomState(seed)
    bf = rng.randn(3000).astype(np.float32).astype(ml_dtypes.bfloat16)
    base = dict(_tree(seed), mask=rng.rand(5) > 0.5,
                count=np.arange(1500, dtype=np.int32) * seed)
    return dict(base, half=bf), dict(base, half=bf.view(np.int16).view("V2"))


def test_payload_reads_across_packages_bit_equal():
    """A keyframe and three deltas, each encoded by both packages: the
    other package decodes it to the same bits, the records and
    ``wire_bytes`` agree, and the device ingest equals the host path."""
    jt, tt = _wire_trees(0)
    jrec = trec = None
    for g in range(4):
        if g:
            jt = dict(_drift(jt, g), half=jt["half"], mask=~jt["mask"])
            tt = dict(_drift(tt, g), half=tt["half"], mask=~tt["mask"])
        jpay, jinfo = jprotocol.encode(jt, jrec)
        tpay, tinfo = tprotocol.encode(tt, trec, device="cpu")
        assert tinfo["kind"] == jinfo["kind"] == ("key" if g == 0 else "delta")
        assert tinfo["wire_bytes"] == jinfo["wire_bytes"]
        assert tinfo["leaves"] == jinfo["leaves"]
        assert tinfo["quantized"] == (0 if g == 0 else 1)   # dense/kernel
        # the records: same tags, same int8 values and bf16 scale bits
        jd, td = pickle.loads(jpay), tprotocol._loads(tpay)
        assert [r[0] for r in jd["records"]] == [r[0] for r in td["records"]]
        for jr, tr in zip(jd["records"], td["records"]):
            if jr[0] == "q":
                np.testing.assert_array_equal(tr[1], jr[1])
                np.testing.assert_array_equal(tr[2].view(np.int16),
                                              jr[2].view(np.int16))
                assert tr[3:] == (tuple(jr[3]), jr[4])
        # each package decodes the other's payload to the same bits
        jrec_next = jprotocol.decode(jpay, jrec)
        trec_next = tprotocol.decode(tpay, trec)
        assert _bits(jprotocol.decode(tpay, jrec)) == _bits(jrec_next)
        assert _bits(tprotocol.decode(jpay, trec)) == _bits(trec_next)
        assert _bits(trec_next) == _bits(jrec_next)
        # the device ingest (a CPU device here) is the host path's bits
        dev = tprotocol.decode(tpay, trec, device="cpu")
        assert all(isinstance(x, torch.Tensor)
                   for x in pytree.flatten(dev)[0]
                   if not isinstance(x, (int, bool)))
        assert _bits(dev) == _bits(trec_next)
        jrec, trec = jrec_next, trec_next


def _per_leaf_encode(tree, base, block=256):
    """The delta encode of one ``quantize`` call a quantizable leaf (each
    delta padded to whole blocks and quantized alone): the reference the
    one-call encoder's payload is held to, byte for byte."""
    from horovod_tpu_torch import compression as tc

    leaves, treedef = pytree.flatten(tree)
    records = []
    for leaf, b in zip(leaves, pytree.flatten(base)[0]):
        if not tprotocol._is_array(leaf):
            records.append(("obj", leaf))
            continue
        arr = tprotocol._host(leaf)
        if arr.dtype.kind not in "fiu":
            records.append(("full", arr))
            continue
        delta = arr - np.asarray(tprotocol._host(b), dtype=arr.dtype)
        if tprotocol._quantizes(arr):
            q, sc = tc.quantize_blockwise(
                torch.from_numpy(np.ascontiguousarray(delta).reshape(-1)),
                block)
            records.append(("q", tprotocol._host(q), tprotocol._host(sc),
                            tuple(arr.shape), arr.dtype.str))
        else:
            records.append(("raw", delta))
    return tprotocol._dumps({"v": tprotocol.FORMAT_VERSION, "kind": "delta",
                             "block": block, "treedef": treedef,
                             "records": records})


def _quantize_launches(monkeypatch):
    """Send CPU tensors down ``kernels.quantize_blockwise``'s CUDA path
    and run its launches through the plain version, which reads and
    writes through the pointers the wrapper passes: the launches' lengths,
    in order."""
    import ctypes

    from horovod_tpu_torch.ops import kernels as K

    launched = []

    def at(ptr, n, ctype):
        return np.ctypeslib.as_array((ctype * n).from_address(ptr))

    def launch(kernel, lib, sym, device, x, q, sc, d, n):
        assert (kernel, sym, d) == ("quantize", "hvd_quantize", None)
        qq, ss = K.quantize_plain(torch.from_numpy(at(x, n, ctypes.c_float)))
        at(q, n, ctypes.c_int8)[:] = qq.numpy()
        at(sc, n // 256, ctypes.c_int16)[:] = ss.view(torch.int16).numpy()
        launched.append(n)

    monkeypatch.setattr(K, "_on_cuda", lambda *ts: True)
    monkeypatch.setattr(K, "_launch", launch)
    return launched


def _delta_tree(seed, lengths):
    rng = np.random.RandomState(seed)
    return {f"w{i:02d}": rng.randn(n).astype(np.float32).reshape(-1, 1)
            if n % 2 else rng.randn(n).astype(np.float32).reshape(2, -1)
            for i, n in enumerate(lengths)}


@pytest.mark.parametrize("lengths", [
    (1024, 2048, 4096, 1 << 14),                 # block multiples
    (1025, 1300, 2055, 4097, 1024, 3000),        # and not
])
def test_delta_is_one_quantize_call_byte_equal_to_per_leaf(lengths,
                                                           monkeypatch):
    """A delta of many quantizable leaves is ONE ``quantize`` launch over
    their padded deltas end to end, and its payload is the per-leaf
    encode's byte for byte (records, scales, treedef, pickle)."""
    base = _delta_tree(0, lengths)
    tree = _drift(base, 1)
    want = _per_leaf_encode(tree, base)
    launched = _quantize_launches(monkeypatch)
    payload, info = tprotocol.encode(tree, base, device="cpu")
    assert launched == [sum(n + (-n) % 256 for n in lengths)]
    assert info["quantized"] == len(lengths)
    assert payload == want


def test_delta_mixing_records_is_byte_equal_to_per_leaf(monkeypatch):
    """A tree of raw (small f32, int), ``full`` (bool, bf16 bits), ``obj``
    and quantizable f32 and f64 leaves: one launch a quantizable dtype on
    the card path (f32 here; f64 takes the plain version, as the kernel
    takes f32 only), the payload the per-leaf encode's byte for byte, and
    its decode the same tree either way."""
    rng = np.random.RandomState(5)
    base = {"a": rng.randn(3000).astype(np.float32),
            "b": rng.randn(7).astype(np.float32),
            "c": np.arange(2000, dtype=np.int32),
            "d": rng.rand(9) > 0.5,
            "e": rng.randn(1500).astype(np.float32).astype(
                ml_dtypes.bfloat16).view(np.int16).view("V2"),
            "f": rng.randn(1100).astype(np.float64),
            "g": rng.randn(40, 64).astype(np.float32),
            "h": 3, "i": "tag"}
    tree = dict(_drift(base, 2), d=~base["d"], h=4)
    want = _per_leaf_encode(tree, base)
    payload, info = tprotocol.encode(tree, base, device="cpu")
    assert payload == want and info["quantized"] == 3
    assert _bits(tprotocol.decode(payload, base)) == \
        _bits(tprotocol.decode(want, base))
    f32 = {k: v for k, v in tree.items() if k != "f"}
    f32_base = {k: v for k, v in base.items() if k != "f"}
    want = _per_leaf_encode(f32, f32_base)
    launched = _quantize_launches(monkeypatch)
    assert tprotocol.encode(f32, f32_base, device="cpu")[0] == want
    assert launched == [3072 + 2560]


def test_delta_without_quantizable_leaves_launches_nothing(monkeypatch):
    """Every leaf below the floor or not a wide float: no launch, the
    per-leaf encode's payload."""
    rng = np.random.RandomState(6)
    base = {"b": rng.randn(1023).astype(np.float32),
            "c": np.arange(5000, dtype=np.int64), "m": rng.rand(3) > 0.5}
    tree = dict(_drift(base, 3), m=~base["m"])
    launched = _quantize_launches(monkeypatch)
    payload, info = tprotocol.encode(tree, base, device="cpu")
    assert launched == [] and info["quantized"] == 0
    assert payload == _per_leaf_encode(tree, base)


def test_encode_refuses_a_mismatched_base_and_unknown_versions():
    payload, _ = tprotocol.encode(_tree(0))
    with pytest.raises(ValueError, match="treedef"):
        tprotocol.encode(_tree(1), {"other": np.zeros(3, np.float32)},
                         device="cpu")
    with pytest.raises(tserving.ChainError, match="without a base"):
        d = tprotocol._loads(payload)
        d["kind"] = "delta"
        tprotocol.decode(tprotocol._dumps(d))
    d = tprotocol._loads(payload)
    d["v"] = 99
    with pytest.raises(tserving.ChainError, match="version"):
        tprotocol.decode(tprotocol._dumps(d))
    for blob in (b"{", b"[]", b'{"version": 1}'):
        with pytest.raises(tserving.ChainError):
            tprotocol.parse_manifest(blob)


def test_wire_reader_names_foreign_classes():
    # GLOBAL flax.core FrozenDict, (), REDUCE: a class only flax can build
    blob = b"cflax.core\nFrozenDict\n)R."
    with pytest.raises(pickle.UnpicklingError, match="flax.core.FrozenDict"):
        tprotocol._loads(blob)


# ----------------------------------------------------------- the handoff


def _pkg(which):
    if which == "jax":
        return types.SimpleNamespace(
            name="jax", serving=jserving, protocol=jprotocol, rdv=jrdv,
            metrics=jmetrics, chaos=jchaos, health=jhealth, loop=jloop,
            callbacks=jcallbacks, publisher=lambda s, **kw:
            jserving.WeightPublisher(s, **kw))
    return types.SimpleNamespace(
        name="torch", serving=tserving, protocol=tprotocol, rdv=trdv,
        metrics=tmetrics, chaos=tchaos, health=thealth, loop=tloop,
        callbacks=tcallbacks, publisher=lambda s, **kw:
        tserving.WeightPublisher(s, device="cpu", **kw))


def _manifests(s, gens) -> list:
    out = []
    for g in gens:
        blob = s.get(f"/serving/manifest/{g}")
        if blob is None:
            out.append(None)
            continue
        m = __import__("json").loads(blob)
        out.append((m["generation"], m["step"], m["kind"], m["keyframe"],
                    m["base"], m["wire_bytes"], m["chunks"],
                    m["elastic_generation"]))
    return out


def sc_chain_gc_and_commit_order(P, tmp):
    order = []
    s = P.rdv.KVStoreServer()
    real_put = s.put

    def spy(key, value, ttl=None):
        order.append(key)
        real_put(key, value, ttl=ttl)

    s.put = spy
    pub = P.publisher(s, keyframe_every=3, chunk_bytes=4096, register=False)
    sub = P.serving.WeightSubscriber(s)
    t, served = _tree(0), []
    for i in range(1, 8):  # keyframes at 1, 4, 7
        t = _drift(t, i)
        pub.publish({"params": t}, i)
        sub.poll()
        assert _bits(sub.weights()) == _bits(pub.reconstruction())
        served.append(_bits(sub.weights()))
    out = dict(order=order, served=served, kf=pub.keyframe_generation,
               live=s.live_keys("/serving/manifest/"),
               dead=sorted(k for k in s.dead_keys() if "manifest" in k),
               gc=P.metrics.value("serving_generations_gc"),
               manifests=_manifests(s, [7]))
    s.close()
    return out


def sc_lagging_subscriber_resyncs(P, tmp):
    s = P.rdv.KVStoreServer()
    pub = P.publisher(s, keyframe_every=3, register=False)
    t = _tree(0)
    for i in range(1, 3):
        t = _drift(t, i)
        pub.publish({"params": t}, i)
    sub = P.serving.WeightSubscriber(s)
    sub.poll()
    for i in range(3, 9):  # keyframes at 4, 7; GC retires 2, 3
        t = _drift(t, i)
        pub.publish({"params": t}, i)
    out = sub.poll()
    assert _bits(out) == _bits(pub.reconstruction())
    res = dict(gen=sub.generation, served=_bits(out),
               resyncs=P.metrics.value("serving_subscribe_resyncs",
                                       reason="chain"))
    s.close()
    return res


def sc_corrupt_chunks_and_stale_serving(P, tmp):
    s = P.rdv.KVStoreServer()
    pub = P.publisher(s, register=False)
    t = _tree(0)
    for i in range(1, 3):
        t = _drift(t, i)
        pub.publish({"params": t}, i)
    sub = P.serving.WeightSubscriber(s, stale_after=0.05)
    assert sub.stale()
    sub.poll()
    assert not sub.stale()
    t3 = _drift(t, 3)
    pub.publish({"params": t3}, 3)
    t4 = _drift(t3, 4)
    pub.publish({"params": t4}, 4)
    s.put("/serving/chunks/4/0", b"xx")
    s.delete("/serving/chunks/1/0")
    progress = sub.poll()              # gen 3 commits, gen 4 cannot
    again = sub.poll()
    time.sleep(0.08)
    stale = sub.stale()
    P.serving.note_subscriber_health(sub)
    return dict(progress=_bits(progress), gen=sub.generation, lag=sub.lag(),
                again=again, stale=stale,
                health=P.health.health_state().name,
                errors=P.metrics.value("serving_subscribe_errors"))


def sc_fence_abort(P, tmp):
    s = P.rdv.KVStoreServer()
    calls = {"n": 0}

    def fence():
        calls["n"] += 1
        return 1 if calls["n"] == 1 else 2

    pub = P.publisher(s, register=False, fence_fn=fence)
    with pytest.raises(P.serving.PublishAborted):
        pub.publish({"params": _tree(0)}, 1)
    res = dict(gen=pub.generation, head=s.get("/serving/head"),
               chunks=s.live_keys("/serving/chunks/"),
               aborts=P.metrics.value("serving_publish_aborts"))
    pub.fence_fn = lambda: 2
    res["next"] = pub.publish({"params": _tree(0)}, 2)
    res["manifests"] = _manifests(s, [1])
    s.close()
    return res


def sc_publish_fail_never_tears(P, tmp):
    s = P.rdv.KVStoreServer()
    pub = P.publisher(s, register=False)
    sub = P.serving.WeightSubscriber(s)
    P.chaos.configure("publish_fail=1")
    seen = []
    real = P.chaos.inject_failure

    def probing(site, exc_factory=None):
        try:
            real(site, exc_factory)
        except BaseException:
            seen.append(sub.poll())
            raise

    with mock.patch.object(P.chaos, "inject_failure", probing):
        gen = pub.publish({"params": _tree(0)}, 1)
    res = dict(gen=gen, seen=seen, sub_gen=sub.generation,
               injected=P.metrics.value("resilience_chaos_injected",
                                        site="publish_fail"),
               retries=P.metrics.value("resilience_retries",
                                       scope="publish"))
    res["then"] = sub.poll() is not None and sub.generation
    s.close()
    return res


def sc_kv_restart(P, tmp):
    """kv_restart_at_step inside publish(): without a WAL the store comes
    back empty and the chain re-roots with a keyframe; with one the
    chain continues with deltas and the subscriber follows."""
    res = {}
    for wal in (None, os.path.join(tmp, f"{P.name}.wal")):
        P.metrics.reset()
        P.chaos.configure(None)
        s = P.rdv.KVStoreServer(wal_path=wal)
        pub = P.publisher(s, keyframe_every=100, register=False)
        sub = P.serving.WeightSubscriber(s)
        t = _tree(0)
        for i in (1, 2):
            t = _drift(t, i)
            pub.publish({"params": t}, i)
        sub.poll()
        P.chaos.configure("kv_restart_at_step=3")
        t = _drift(t, 3)
        pub.publish({"params": t}, 3)
        out = sub.poll()
        assert _bits(out) == _bits(pub.reconstruction())
        res[bool(wal)] = dict(
            kf=pub.keyframe_generation, gen=sub.generation,
            served=_bits(out), manifests=_manifests(s, [1, 2, 3]),
            injected=P.metrics.value("resilience_chaos_injected",
                                     site="kv_restart_at_step"))
        s.close()
        P.chaos.configure(None)
    return res


def sc_http_and_in_process_transports(P, tmp):
    s = P.rdv.KVStoreServer(secret="sek")
    port = s.start()
    client = P.rdv.KVStoreClient("127.0.0.1", port, secret="sek")
    pub = P.publisher(client, chunk_bytes=1024, register=False)
    t = _tree(0)
    pub.publish({"params": t}, 1)
    t2 = _drift(t, 1)
    pub.publish({"params": t2}, 2)
    sub = P.serving.subscribe_weights("127.0.0.1", port, secret="sek")
    out = sub.wait_for_generation(2, timeout=10)
    res = dict(http=_bits(out), step=sub.step,
               recon=_bits(pub.reconstruction()))
    s.close()
    mem = P.rdv.InProcessKVStore()
    pub = P.publisher(mem, keyframe_every=2, register=False)
    for i in range(1, 4):
        t = _drift(t, i)
        pub.publish({"params": t}, i)
    sub = P.serving.subscribe_weights(store=mem)
    res["in_process"] = _bits(sub.poll())
    with pytest.raises(ValueError):
        P.serving.subscribe_weights("h", 1, store=mem)
    return res


def sc_preempt_flush_and_callback(P, tmp):
    s = P.rdv.KVStoreServer()
    pub = P.publisher(s, publish_every=10)  # registered for the drain
    P.chaos.configure("sigterm_at_step=3")
    saved = []
    real_save = __import__(f"{P.loop.__name__.rsplit('.', 2)[0]}.checkpoint",
                           fromlist=["save"]).save

    def step_fn(state, i):
        return {"params": {"w": state["params"]["w"] + 1.0}}

    ck = os.path.join(tmp, f"{P.name}_ck")
    ckmod = __import__(f"{P.loop.__name__.rsplit('.', 2)[0]}.checkpoint",
                       fromlist=["save"])

    def spy(*a, **kw):
        saved.append(s.get("/serving/head"))   # the flush came first
        return real_save(*a, **kw)

    with mock.patch.object(ckmod, "save", spy):
        with pytest.raises(P.loop.Preempted) as ei:
            P.loop.run(step_fn, {"params": {"w": np.zeros(3, np.float32)}},
                       num_steps=100, checkpoint_dir=ck)
    P.chaos.configure(None)
    sub = P.serving.WeightSubscriber(s)
    out = sub.poll()
    res = dict(step=ei.value.step, w=np.asarray(out["w"]).tolist(),
               flushes=P.metrics.value("serving_final_flushes"),
               head_at_save=saved[:1])
    s.close()
    pub.unregister()
    s = P.rdv.KVStoreServer()
    pub = P.publisher(s, register=False)
    cb = P.callbacks.PublishCallback(pub, every=2)

    class Trainer:
        params = {"w": np.arange(4, dtype=np.float32)}

    cb.set_trainer(Trainer())
    for b in range(5):
        cb.on_batch_end(b)
        Trainer.params = {"w": Trainer.params["w"] + 1}
    res["cb_gen"] = pub.generation
    cb.on_train_end()
    res["cb_final"] = (pub.generation,
                       P.serving.WeightSubscriber(s).poll()["w"].tolist())
    with pytest.raises(ValueError):
        P.callbacks.PublishCallback(pub, every=0)
    s.close()
    return res


SCENARIOS = {f.__name__[3:]: f for f in (
    sc_chain_gc_and_commit_order, sc_lagging_subscriber_resyncs,
    sc_corrupt_chunks_and_stale_serving, sc_fence_abort,
    sc_publish_fail_never_tears, sc_kv_restart,
    sc_http_and_in_process_transports, sc_preempt_flush_and_callback)}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_handoff_scenario_matches_jax(name, tmp_path):
    fn = SCENARIOS[name]
    want = fn(_pkg("jax"), str(tmp_path))
    got = fn(_pkg("torch"), str(tmp_path))
    assert got == want


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_publications_cross_packages_over_one_store(direction):
    """One package publishes a chain (keyframe, deltas, a GC'd resync)
    onto a KV server, the other package's subscriber follows it and
    serves the publisher's reconstruction bit for bit."""
    pubp, subp = ((_pkg("jax"), _pkg("torch")) if direction == "jax_to_port"
                  else (_pkg("torch"), _pkg("jax")))
    s = pubp.rdv.KVStoreServer()
    pub = pubp.publisher(s, keyframe_every=3, register=False)
    sub = subp.serving.WeightSubscriber(s)
    t = _tree(0)
    for i in range(1, 9):
        t = _drift(t, i)
        pub.publish({"params": t}, i)
        if i in (1, 2, 8):        # lags over 3..7: resync at 8
            sub.poll()
            assert _bits(sub.weights()) == _bits(pub.reconstruction())
    assert sub.generation == 8
    s.close()


# ----------------------------------------------------------------- wiring


def test_elastic_run_publishes_on_cadence_as_jax_does():
    """World of one: publish_every=2 over 7 steps publishes the committed
    snapshot at steps 2, 4, 6 (keyframe, delta, delta), fenced on the
    elastic generation, in both packages; the subscriber holds the last
    committed weights."""
    import jax.numpy as jnp

    import horovod_tpu as jhvd
    import horovod_tpu.resilience.elastic as jelastic
    import horovod_tpu_torch as hvd
    import horovod_tpu_torch.resilience.elastic as telastic

    w0 = np.linspace(-1, 1, 2048).astype(np.float32)
    res = {}
    js = jrdv.KVStoreServer()
    jpub = jserving.WeightPublisher(js, keyframe_every=8, register=False)

    def jbuilder(n):
        return lambda st, i: {"params": {"w": st["params"]["w"] * 1.5 + 0.25}}

    jhvd.init(devices=jax.devices()[:1])
    try:
        jelastic.run(jbuilder, {"params": {"w": jnp.asarray(w0)}},
                     num_steps=7, devices=jax.devices()[:1],
                     publisher=jpub, publish_every=2)
    finally:
        jhvd.shutdown()
    res["jax"] = (_manifests(js, [1, 2, 3, 4]),
                  _bits(jserving.WeightSubscriber(js).poll()))
    ts = trdv.KVStoreServer()
    tpub = tserving.WeightPublisher(ts, keyframe_every=8, register=False,
                                    device="cpu")

    def tbuilder(n):
        return lambda st, i: {"params": {"w": st["params"]["w"] * 1.5 + 0.25}}

    hvd.init(device="cpu", init_method=f"tcp://127.0.0.1:{SW.free_port()}")
    try:
        telastic.run(tbuilder, {"params": {"w": torch.from_numpy(w0)}},
                     num_steps=7, publisher=tpub, publish_every=2)
    finally:
        hvd.shutdown()
    res["torch"] = (_manifests(ts, [1, 2, 3, 4]),
                    _bits(tserving.WeightSubscriber(ts).poll()))
    assert res["torch"] == res["jax"]
    assert [m[1:3] for m in res["torch"][0][:3]] == [
        (2, "key"), (4, "delta"), (6, "delta")]
    js.close()
    ts.close()


def test_elastic_resize_republishes_the_post_resize_state():
    """A gloo world of 2 under rank_fail=1 at step 3 and the rank's
    re-admission at step 5: rank 0 publishes on the cadence (every 2
    steps) and once after each resize, from the committed step the world
    resumes at, fenced on the elastic generation (the JAX driver's
    rules at ``horovod_tpu/resilience/elastic.py``)."""
    out = run_world(SW.elastic_publish_worker, 2,
                    "rank_fail=1,rank_fail_at_step=3,rank_join_at_step=5",
                    8, 2)
    log = out[0]
    # (generation, step, kind, elastic generation) of every publication
    assert log == [(1, 2, "key", 1), (2, 3, "delta", 2), (3, 4, "delta", 2),
                   (4, 5, "delta", 3), (5, 6, "delta", 3),
                   (6, 8, "delta", 3)]
