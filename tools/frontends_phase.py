#!/usr/bin/env python3
"""Phase 23 of ``chip_smoke.py`` (the TensorFlow, Keras, MXNet and Spark
frontends and the estimator), its per-process bodies, and the phase
alone.

    python3 tools/frontends_phase.py              # phase 23 on one GPU
    python3 tools/frontends_phase.py --gpus 4     # and its four-GPU part
    python3 tools/frontends_phase.py --probe      # the package probe

The probe prints which of the frontends' packages import (a part that
needs a package runs exactly when the probe finds it). (a), one GPU: the
MXNet bridge (``horovod_tpu_torch.mxnet``) on numpy arrays and a
duck-typed NDArray, every tensor handed to a collective on ``cuda:0``.
(b), N GPUs: a Spark barrier job without Spark
(``testing.run_barrier_job``: N processes, each running
``spark._run_barrier_slot`` over a fake ``BarrierTaskContext`` whose
``allGather`` runs over a store): the world forms on
``cuda:<local_rank>``, the MXNet bridge's collectives are exact against
numpy, and with TensorFlow and Keras the TF frontend's Adasum of an f32
delta and of its bf16 wire launches B8 (``adasum_pair_combine``, one
tensor a call). (c), with pandas and pyarrow:
``TorchEstimator`` fits and transforms a 2-layer MLP at ``num_proc=1``
(and N through ``run.run``), held against the same fit on the CPU
(plain PyTorch, the same seed and shards). The drivers are
``chip_smoke.frontends_phase`` and ``chip_smoke.frontends_gpus``.
"""

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

#: what the probe looks for
PACKAGES = ("tensorflow", "keras", "pandas", "pyarrow", "cloudpickle",
            "mxnet", "pyspark")

#: (c)'s data and model: a teacher of FEATURES inputs, ROWS rows, an MLP
#: FEATURES -> HIDDEN -> 1, SGD at LR, EPOCHS epochs of batch BATCH
EST = dict(features=32, hidden=256, rows=8192, batch=256, epochs=2,
           lr=0.05, seed=23, model_seed=5)


def probe() -> dict:
    """Each of :data:`PACKAGES`: its version, or None where it does not
    import (its ``keras`` backend beside it)."""
    import importlib

    out = {}
    for name in PACKAGES:
        try:
            mod = importlib.import_module(name)
        except Exception:  # noqa: BLE001 - any failure is "not here"
            out[name] = None
            continue
        out[name] = str(getattr(mod, "__version__", "unknown"))
        if name == "keras":
            out["keras_backend"] = mod.backend.backend()
    return out


def run_probe(timeout: float = 300.0) -> dict:
    """:func:`probe` in a child process (TensorFlow's import stays out of
    the caller)."""
    r = subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--probe"], capture_output=True, text=True,
                       timeout=timeout)
    if r.returncode != 0:
        raise RuntimeError(f"the package probe failed:\n{r.stderr[-2000:]}")
    return json.loads(r.stdout.strip().splitlines()[-1])


def rank_input(r: int, shape=(64, 1024)):
    """Rank ``r``'s integer-valued f32 input (exact in any sum of four)."""
    import numpy as np

    return (np.arange(shape[0] * shape[1], dtype=np.float32).reshape(shape)
            % 4096 + 10000.0 * (r + 1))


class NDArray:
    """The NDArray surface the MXNet bridge uses (``asnumpy()``,
    ``__setitem__``)."""

    def __init__(self, a):
        import numpy as np

        self._a = np.array(a)

    def asnumpy(self):
        return self._a.copy()

    def __setitem__(self, key, value):
        self._a[key] = value


class _Opt:
    def __init__(self):
        self.rescale_grad = 1.0
        self.seen = []

    def update(self, index, weight, grad, state):
        import numpy as np

        self.seen.append((index, np.array(grad)))


def _watch_devices():
    """A context that records the device and kind of every tensor handed
    to the port's allreduce/allgather/broadcast."""
    from horovod_tpu_torch.ops import collective as C
    from horovod_tpu_torch.testing import watching_calls

    seen = []
    return seen, watching_calls(
        C, ("allreduce", "allgather", "broadcast"),
        lambda name, a, kw: seen.append((name, str(a[0].device))))


def mxnet_ops(r: int, n: int) -> dict:
    """The MXNet bridge's ops on rank ``r``'s input in a world of ``n``:
    results (each its input's kind), the devices the collectives saw,
    and the optimizer's rescale and update."""
    import numpy as np

    import horovod_tpu_torch.mxnet as mhvd

    x = rank_input(r)
    seen, watch = _watch_devices()
    with watch:
        out = {"sum": mhvd.allreduce(x, average=False),
               "avg": mhvd.allreduce(x, average=True),
               "gather": mhvd.allgather(x[:8]),
               "bcast": mhvd.broadcast(x, root_rank=n - 1)}
        nd = NDArray(x)
        if mhvd.allreduce_(nd, average=False) is not nd:
            raise AssertionError("allreduce_ did not return its input")
        out["sum_nd"] = nd.asnumpy()
        if mhvd.broadcast_(nd, 0) is not nd:
            raise AssertionError("broadcast_ did not return its input")
        out["bcast_nd"] = nd.asnumpy()
        opt = mhvd.DistributedOptimizer(_Opt())
        grad = np.full((1024,), 2.0 * (r + 1), np.float32)
        opt.update(3, None, grad, None)
    kinds = sorted({type(v).__name__ for v in out.values()})
    return dict(out=out, kinds=kinds, devices=seen,
                rescale_grad=opt.rescale_grad, update_grad=grad,
                inner_seen=[i for i, _ in opt._optimizer.seen])


def mxnet_expected(n: int) -> dict:
    """What :func:`mxnet_ops` must give on every rank of ``n``: numpy
    arithmetic summed in rank order (integer-valued, so exact)."""
    import numpy as np

    xs = [rank_input(r) for r in range(n)]
    total = xs[0].copy()
    for x in xs[1:]:
        total = total + x
    return {"sum": total, "avg": total / np.float32(n),
            "gather": np.concatenate([x[:8] for x in xs]),
            "bcast": xs[n - 1], "sum_nd": total, "bcast_nd": total}


def check_mxnet(rec: dict, n: int, device: str) -> list:
    """The failures of one rank's :func:`mxnet_ops` record (empty: it
    passed)."""
    import numpy as np

    bad = []
    for k, v in mxnet_expected(n).items():
        got = rec["out"][k]
        if got.dtype != np.float32 or not np.array_equal(got, v):
            bad.append(f"{k} differs from numpy")
    if rec["kinds"] != ["ndarray"]:
        bad.append(f"results came back as {rec['kinds']}")
    if not rec["devices"] or any(d != device for _, d in rec["devices"]):
        bad.append(f"the collectives saw {rec['devices']}, not {device}")
    want_grad = 2.0 * sum(r + 1 for r in range(n)) if n > 1 \
        else 2.0   # a world of one exchanges nothing
    if rec["rescale_grad"] != 1.0 / n or \
            not np.all(rec["update_grad"] == want_grad) or \
            rec["inner_seen"] != [3]:
        bad.append(f"DistributedOptimizer.update: rescale "
                   f"{rec['rescale_grad']}, grad {rec['update_grad'][:2]}")
    return bad


def tf_adasum(r: int) -> dict:
    """The TF frontend's Adasum of a rank-distinct f32 delta and of the
    same through its bf16 wire (``Compression.fp16``), with each call's
    kernel launches (B8, ``adasum_pair_combine``, a level)."""
    import numpy as np
    import tensorflow as tf

    tf.config.set_visible_devices([], "GPU")    # TF computes on the CPU
    import horovod_tpu_torch.tensorflow as thvd
    from horovod_tpu_torch.ops import kernels as K

    rng = np.random.default_rng(100 + r)
    delta = tf.constant(rng.standard_normal((256, 1024)).astype(np.float32))
    out = {}
    for name, comp in (("f32", thvd.Compression.none),
                       ("bf16", thvd.Compression.fp16)):
        K.reset_launches()
        got = thvd.allreduce(delta, thvd.Adasum, compression=comp)
        out[name] = dict(value=got.numpy(), launches={
            k: v for k, v in K.launches.items() if v})
    return out


def slot_fn(with_tf: bool) -> dict:
    """``fn`` of a barrier task: ``hvd.init()`` from the slot's
    environment (on ``cuda:<local_rank>``), the MXNet bridge, and with
    TensorFlow the TF frontend's Adasum."""
    import horovod_tpu_torch as hvd

    hvd.init()
    try:
        r, n = hvd.rank(), hvd.size()
        out = {"rank": r, "size": n, "device": str(hvd.device()),
               "local_rank": int(os.environ["HOROVOD_LOCAL_RANK"]),
               "mxnet": mxnet_ops(r, n)}
        if with_tf:
            out["tf"] = tf_adasum(r)
        return out
    finally:
        hvd.shutdown()


# --------------------------------------------------------------------------
# (c) the estimator


def est_frame():
    """(c)'s DataFrame: a linear teacher with a little noise, from a
    seed."""
    import numpy as np
    import pandas as pd

    rng = np.random.default_rng(EST["seed"])
    x = rng.standard_normal((EST["rows"], EST["features"])).astype(np.float32)
    w = rng.standard_normal(EST["features"]).astype(np.float32)
    y = x @ w + 0.01 * rng.standard_normal(EST["rows"]).astype(np.float32)
    df = pd.DataFrame({f"f{i}": x[:, i] for i in range(EST["features"])})
    df["label"] = y
    return df


def est_model():
    import torch

    torch.manual_seed(EST["model_seed"])
    return torch.nn.Sequential(torch.nn.Linear(EST["features"], EST["hidden"]),
                               torch.nn.ReLU(),
                               torch.nn.Linear(EST["hidden"], 1))


def plain_fit(model, df, n: int, seed: int) -> list:
    """The estimator's fit at ``num_proc=n`` as plain PyTorch in this
    process, on whatever device ``model`` lies: shard ``r`` is
    ``df.iloc[r::n]``, every shard in the same seeded permutations, the
    ``n`` gradients averaged, one SGD step. Returns rank 0's mean loss an
    epoch."""
    import numpy as np
    import torch

    dev = next(model.parameters()).device
    cols = [f"f{i}" for i in range(EST["features"])]
    xs = [torch.tensor(df.iloc[r::n][cols].to_numpy(np.float32), device=dev)
          for r in range(n)]
    ys = [torch.tensor(df.iloc[r::n][["label"]].to_numpy(np.float32),
                       device=dev) for r in range(n)]
    opt = torch.optim.SGD(model.parameters(), lr=EST["lr"])
    gen = torch.Generator().manual_seed(seed)
    history = []
    for _ in range(EST["epochs"]):
        perm = torch.randperm(len(xs[0]), generator=gen).to(dev)
        losses = []
        for i in range(0, len(xs[0]), EST["batch"]):
            idx = perm[i:i + EST["batch"]]
            grads = []
            for r in range(n):
                model.zero_grad()
                loss = torch.nn.functional.mse_loss(model(xs[r][idx]),
                                                    ys[r][idx])
                loss.backward()
                grads.append([p.grad.clone() for p in model.parameters()])
                if r == 0:
                    losses.append(float(loss.detach()))
            for p, *gs in zip(model.parameters(), *grads):
                p.grad = sum(gs[1:], gs[0]) / torch.full((), float(n),
                                                         device=dev)
            opt.step()
        history.append(sum(losses) / len(losses))
    return history


def every_rank(inner):
    """Run the estimator's worker ``inner`` in a world this function
    forms (so the worker leaves it up), then gather every rank's
    parameters' digest; rank 0 returns the worker's result with the
    digests (``rank_shas``), the others None."""
    import hashlib

    import horovod_tpu_torch as hvd

    hvd.init()
    try:
        result = inner()
        model = inner.args[0]["model"]
        h = hashlib.sha256()
        for k, v in model.state_dict().items():
            h.update(k.encode())
            h.update(v.detach().cpu().numpy().tobytes())
        shas = hvd.allgather_object(h.hexdigest())
        devices = hvd.allgather_object(str(hvd.device()))
    finally:
        hvd.shutdown()
    if result is not None:
        result = dict(result, rank_shas=shas, devices=devices)
    return result


def main() -> None:
    import torch

    import chip_smoke as S

    gpus = int(sys.argv[2]) if len(sys.argv) > 2 and \
        sys.argv[1] == "--gpus" else 1
    if not torch.cuda.is_available():
        S.fail("phase 23 needs a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=30, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    from horovod_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.build_all(["adasum"])
    print(f"build: {time.perf_counter() - t0:.2f} s", flush=True)
    rec = S.frontends_phase(smi)
    S.print_frontends(rec, smi)
    out = {"phase23_s": rec["seconds"]}
    if gpus > 1:
        world = S.frontends_gpus(gpus, rec["probe"], smi)
        S.print_frontends_world(world, gpus, smi)
        out[f"phase23_at_{gpus}_s"] = world["seconds"]
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--probe"]:
        print(json.dumps(probe()), flush=True)
    else:
        main()
