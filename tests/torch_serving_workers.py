"""Per-rank bodies of the serving tests' gloo worlds. Imports no JAX: the
spawned ranks import this module, not the test files."""

import json

import numpy as np
import torch

from horovod_tpu_torch.testing import free_port  # noqa: F401  (re-export)


def elastic_publish_worker(spec, steps, every):
    """``elastic.run`` of a trivial step under the chaos ``spec`` with a
    publisher on rank 0 (``publish_every=every``); rank 0 returns every
    manifest's (generation, step, kind, elastic generation)."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.resilience import chaos, elastic
    from horovod_tpu_torch.run.rendezvous import KVStoreServer
    from horovod_tpu_torch.serving import WeightPublisher

    if hvd.rank() == 0:
        chaos.configure(spec)
    s = KVStoreServer()
    pub = (WeightPublisher(s, keyframe_every=100, register=False,
                           device="cpu") if hvd.rank() == 0 else None)

    def builder(n):
        def step(st, i):
            w = st["params"]["w"] + float(i)
            hvd.allreduce(torch.zeros(1))          # one collective a step
            return {"params": {"w": w}}
        return step

    w0 = torch.arange(2048, dtype=torch.float32) / 2048
    elastic.run(builder, {"params": {"w": w0}}, num_steps=steps,
                snapshot_every=1, publisher=pub, publish_every=every)
    chaos.reset()
    if pub is None:
        return None
    out = []
    for g in range(1, pub.generation + 1):
        m = json.loads(s.get(f"/serving/manifest/{g}"))
        out.append((m["generation"], m["step"], m["kind"],
                    m["elastic_generation"]))
    s.close()
    return out


#: the torch.distributed functions a serving pass could reach
_DIST = ("all_reduce", "all_gather_single", "all_gather_into_tensor",
         "broadcast", "all_gather")


def tp_engine_worker(params, prompts, max_new, cfg, kw):
    """Build the model of ``cfg`` (CPU, f32) and a mesh ``{"tp": n}``,
    then serve ``prompts`` through a ``tp_axis="tp"`` engine and through
    a dense engine on the same weights; returns both runs' tokens and
    the collectives a decode pass made."""
    import horovod_tpu_torch as hvd
    import torch.distributed as dist
    from horovod_tpu_torch.models.transformer import TransformerLM
    from horovod_tpu_torch.parallel import build_mesh
    from horovod_tpu_torch.serving.engine import InferenceEngine
    from horovod_tpu_torch.testing import watching_calls

    build_mesh({"tp": hvd.size()})
    model = TransformerLM(**cfg, dtype=torch.float32, device="meta")

    def serve(tp_axis):
        e = InferenceEngine(model, device="cpu", tp_axis=tp_axis, **kw)
        e.set_weights(params, generation=1)
        reqs = [e.submit(p, max_new, rid=f"r{i}")
                for i, p in enumerate(prompts)]
        calls = []
        with watching_calls(dist, _DIST,
                            lambda name, a, k: calls.append(name)):
            per_pass = []
            while not e.scheduler.idle():
                n0 = len(calls)
                e.step()
                per_pass.append(len(calls) - n0)
        return [list(map(int, r.generated)) for r in reqs], calls, per_pass

    tp_tokens, tp_calls, per_pass = serve("tp")
    dense_tokens, dense_calls, _ = serve(None)
    # the control plane alone (submit, admission, no forward) makes no call
    e = InferenceEngine(model, device="cpu", tp_axis="tp", **kw)
    calls = []
    with watching_calls(dist, _DIST,
                        lambda name, a, k: calls.append(name)):
        e.submit(np.ones(3, np.int32), 2, rid="x")
        e.scheduler.admit()
    return dict(tp=tp_tokens, dense=dense_tokens,
                tp_calls={n: tp_calls.count(n) for n in set(tp_calls)},
                per_pass=per_pass, dense_calls=len(dense_calls),
                control_calls=len(calls))
