#!/usr/bin/env python3
"""Phase 22 of ``chip_smoke.py`` (the launcher and the input plane), its
worker, and the phase alone.

    python3 tools/launcher_phase.py              # phase 22 on one GPU
    python3 tools/launcher_phase.py --gpus 4     # its four-GPU part
    python3 tools/launcher_phase.py --worker CFG # one worker (what the
                                                 # phase launches)

The worker is a plain user script: ``hvd.init()``, an
``ArrayShardStore`` of uint8 images read through a ``ResumableLoader``
(prefetch 2, placed on this process's device), a model trained by
``make_loader_step`` under ``resilience.run`` with a checkpoint at each
epoch, ``instrument_step`` on, and Horovod's callbacks
(``BroadcastGlobalVariablesCallback``, ``MetricAverageCallback``,
``LearningRateWarmupCallback`` over the first epoch, then a
``LearningRateScheduleCallback`` that halves the rate each epoch, batch by
batch, ``MetricsCallback``); the optimizer is ZeRO-1 + int8 + error feedback around
``inject_hyperparams(fused_adam)``, its learning rate pushed in with
``apply_lr`` each step. ``CFG`` is a JSON file (:func:`worker`'s keys);
the worker writes its record to ``<out>/rank<r>.json``. The phase's
drivers (``chip_smoke.launcher_phase`` and ``chip_smoke.launcher_gpus``)
launch it through ``python -m horovod_tpu_torch.run``. The CPU tests
launch it the same way with ``"device": "cpu"`` and a narrow model.
"""

import hashlib
import json
import os
import signal
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

#: the phase's dataset: synthetic images, in 16 shards of 128
P22_IMAGES, P22_SHARD, P22_SIDE, P22_CLASSES = 2048, 128, 224, 1000


def make_dataset(directory: str, n: int, side: int, classes: int,
                 rows_per_shard: int, seed: int = 0) -> dict:
    """``n`` uint8 images ``[side, side, 3]`` and int64 labels from
    ``seed``, written as an ``ArrayShardStore``; returns the manifest."""
    import numpy as np

    from horovod_tpu_torch.data import ArrayShardStore

    rng = np.random.default_rng(seed)
    x = rng.integers(0, 256, (n, side, side, 3), dtype=np.uint8)
    y = rng.integers(0, classes, (n,), dtype=np.int64)
    return ArrayShardStore.write(directory, (x, y), rows_per_shard)


def _model(cfg: dict, dev):
    import torch

    from horovod_tpu_torch import models

    if cfg["model"] == "resnet50":
        return models.ResNet50(dtype=torch.bfloat16, seed=cfg["model_seed"],
                               device=dev)
    model = models.ResNet([1, 1, 1, 1], models.BottleneckBlock,
                          num_classes=cfg["classes"], num_filters=8,
                          dtype=torch.float32, seed=cfg["model_seed"],
                          device=dev)
    if cfg.get("init"):
        import numpy as np

        from horovod_tpu_torch.models.convert import (
            load_flax_variables, unflatten_tree,
        )

        with np.load(cfg["init"]) as z:
            params = {k[2:]: z[k] for k in z.files if k.startswith("p/")}
            stats = {k[2:]: z[k] for k in z.files if k.startswith("s/")}
        load_flax_variables(model, unflatten_tree(params),
                            unflatten_tree(stats) or None)
    return model


class Trainer:
    """What the callbacks act on: the model's parameters (views: a
    broadcast writes through), the loop state's optimizer state, the
    learning rate."""

    def __init__(self, model, state: dict, lr: float):
        self.model, self.state, self.lr = model, state, lr

    @property
    def params(self):
        return self.model.jax_params()

    @params.setter
    def params(self, value):
        pass    # broadcast in place: the views are the model's

    @property
    def opt_state(self):
        return self.state["opt_state"]

    @opt_state.setter
    def opt_state(self, value):
        self.state["opt_state"] = value


def _sha(model) -> str:
    h = hashlib.sha256()
    for tree in (model.jax_params(), model.jax_batch_stats()):
        for k in sorted(tree):
            t = tree[k].detach().contiguous().cpu()
            h.update(k.encode() + b"\0" + t.view(-1).view(
                __import__("torch").uint8).numpy().tobytes())
    return h.hexdigest()


def _await_file(path: str, timeout: float = 120.0) -> None:
    t0 = time.monotonic()
    while not os.path.exists(path):
        if time.monotonic() - t0 > timeout:
            raise TimeoutError(f"{path} never appeared")
        time.sleep(0.01)


def _wait_for_sigterm(timeout: float = 120.0) -> None:
    """Hold this step until this process has received a SIGTERM (the
    launcher's forwarded preemption), then hand it on to the handler the
    preemption loop installed."""
    got = []
    previous = signal.getsignal(signal.SIGTERM)

    def latch(signum, frame):
        got.append(signum)
        if callable(previous):
            previous(signum, frame)

    signal.signal(signal.SIGTERM, latch)
    try:
        t0 = time.monotonic()
        while not got:
            if time.monotonic() - t0 > timeout:
                raise TimeoutError("no SIGTERM arrived")
            time.sleep(0.01)
    finally:
        signal.signal(signal.SIGTERM, previous)


def _announce(cfg: dict, name: str, step: int) -> None:
    """Tell the driver this rank holds ``step`` (a file in the signal
    directory, written whole): the step, the process, and the KV
    endpoints and secret the launcher gave it."""
    path = os.path.join(cfg["signal_dir"], name)
    with open(path + ".tmp", "w") as f:
        json.dump({"step": step, "pid": os.getpid(),
                   "kv_addrs": os.environ.get("HVD_RUN_KV_ADDRS"),
                   "secret": os.environ.get("HVD_RUN_SECRET")}, f)
    os.replace(path + ".tmp", path)


def worker(cfg: dict) -> dict:
    """One rank of phase 22 in an initialized world; returns its record.

    ``cfg`` keys: ``store`` (an ``ArrayShardStore`` directory), ``model``
    (``resnet50`` or ``narrow``), ``model_seed``, ``classes``, ``init``
    (narrow: an npz of flax params ``p/<key>`` and stats ``s/<key>``),
    ``batch`` (global), ``seed`` (the stream), ``epochs``, ``lr``,
    ``warmup_epochs`` (then the rate halves each epoch),
    ``checkpoint_dir``, ``deterministic``,
    ``log_calls`` (log each kernel wrapper call through
    ``chip_smoke.logging_calls``), ``row_sums`` (record each delivered
    row's pixel sum and label), ``preempt_at`` (hold that step until a
    SIGTERM arrives), ``kill_at`` and ``signal_dir`` (rank 0 announces
    that step in ``signal_dir`` and holds it until the driver has killed
    the primary KV store), ``copy_ms`` (time one batch's copy to the
    card)."""
    import numpy as np
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import callbacks as cbs, optim, resilience
    from horovod_tpu_torch.analysis import sanitizer
    from horovod_tpu_torch.data import ArrayShardStore, ResumableLoader
    from horovod_tpu_torch.observability import metrics
    from horovod_tpu_torch.ops import kernels as K
    from horovod_tpu_torch.resilience import health
    from horovod_tpu_torch.training import instrument_step, make_loader_step

    if cfg.get("deterministic"):
        torch.use_deterministic_algorithms(True)
        torch.backends.cudnn.benchmark = False
    dev = hvd.device()
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    rank, size = hvd.rank(), hvd.size()
    model = _model(cfg, dev)
    t_model = time.time()
    store = ArrayShardStore(cfg["store"])
    loader = ResumableLoader(store, cfg["batch"], seed=cfg["seed"],
                             prefetch=2)
    spe = loader.steps_per_epoch
    steps = spe * cfg["epochs"]
    lr = cfg["lr"]
    tx = hvd.DistributedOptimizer(
        optim.inject_hyperparams(hvd.fused_adam)(learning_rate=lr),
        compression=hvd.Compression.int8, error_feedback=True,
        shard_optimizer=True)
    step = instrument_step(hvd.make_train_step(model, tx,
                                               shard_optimizer=True),
                           batch_arg=1)
    state = {"params": model.jax_params(),
             "batch_stats": model.jax_batch_stats(),
             "opt_state": tx.init(model.jax_params())}
    trainer = Trainer(model, state, lr)
    callbacks = cbs.CallbackList([
        cbs.BroadcastGlobalVariablesCallback(0),
        cbs.MetricAverageCallback(),
        cbs.MetricsCallback(every_n_steps=0, printer=lambda s: None),
    ], trainer)
    # the learning rate as Keras drives it: the epoch and the batch within
    # it (the loader's key), Goyal's warmup over the first epochs, then
    # lr * 0.5 ** epoch, the schedule last so it wins where both act
    schedule = cbs.CallbackList([
        cbs.LearningRateWarmupCallback(
            warmup_epochs=cfg["warmup_epochs"], steps_per_epoch=spe,
            initial_lr=lr),
        cbs.LearningRateScheduleCallback(
            lambda epoch: 0.5 ** epoch, start_epoch=cfg["warmup_epochs"],
            staircase=False, steps_per_epoch=spe, initial_lr=lr),
    ], trainer)
    schedule.on_train_begin()
    rec = {"rank": rank, "size": size, "device": str(dev), "steps": [],
           "epoch_logs": [], "calls": [],
           "t_start": cfg.get("t_start"), "t_init": cfg.get("t_init"),
           "t_model": t_model, "t_built": time.time()}
    calls: list = []
    scale = torch.full((), 1.0 / 255.0, dtype=torch.float32, device=dev)
    epoch_losses: list = []

    def load(st):
        with torch.no_grad():
            for part, views in (("params", model.jax_params()),
                                ("batch_stats", model.jax_batch_stats())):
                for k, v in views.items():
                    if st[part][k].data_ptr() != v.data_ptr():
                        v.copy_(st[part][k])

    def step_fn(st, batch, i):
        if "t_first" not in rec:
            rec["t_first"] = time.time()
        x, y = batch
        epoch, k = loader.last_key[:2]
        if k == 0 or not rec["steps"]:
            schedule.on_epoch_begin(epoch)
        schedule.on_batch_begin(k)
        if i == 0 and cfg.get("check_first", True):
            want = store.gather(loader.last_indices)
            rec["first_batch_equal"] = bool(
                np.array_equal(x.cpu().numpy(), want[0])
                and np.array_equal(y.cpu().numpy(), want[1]))
        if cfg.get("preempt_at") == i:
            _announce(cfg, "at_preempt", i)
            _wait_for_sigterm()
        if cfg.get("kill_at") == i and rank == 0:
            _announce(cfg, "kill_at", i)
            _await_file(os.path.join(cfg["signal_dir"], "killed"))
        # health as the batch arrives (the step's own beat would walk a
        # quarantine's SUSPECT back to HEALTHY)
        state_name = health.health_state().name
        reason = health.MONITOR.reason()
        load(st)
        trainer.state = st
        opt = cbs.apply_lr(st["opt_state"], trainer.lr)
        before = dict(K.launches)
        if cuda:
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        calls.append([])
        opt, loss = step(opt, x.float() * scale, y)
        loss = float(loss)
        dt = time.perf_counter() - t0
        row = {"i": i, "key": list(loader.last_key[:2]),
               "ids": [int(v) for v in loader.last_indices],
               "lr": trainer.lr, "loss": loss, "wait_s": loader.last_wait,
               "step_s": dt, "t_end": time.perf_counter(),
               "launches": {k: K.launches[k] - before[k] for k in K.KERNELS
                            if K.launches[k] != before[k]},
               "health": state_name}
        if cfg.get("row_sums"):
            row["row_sums"] = x.sum(dim=(1, 2, 3),
                                    dtype=torch.int64).tolist()
            row["labels"] = y.tolist()
        if state_name != "HEALTHY":
            row["health_reason"] = reason
        rec["steps"].append(row)
        epoch_losses.append(loss)
        new = {"params": model.jax_params(),
               "batch_stats": model.jax_batch_stats(), "opt_state": opt}
        trainer.state = new
        if loader.cursor()[1] == 0:           # the epoch's last step
            logs = {"loss": float(np.mean(epoch_losses))}
            epoch_losses.clear()
            callbacks.on_epoch_end(loader.last_key[0], logs)
            rec["epoch_logs"].append(logs)
        return new

    stepped = make_loader_step(step_fn, loader)
    t0 = time.time()
    try:
        if cfg.get("log_calls"):
            import chip_smoke

            with chip_smoke.logging_calls(calls):
                final = resilience.run(
                    stepped, state, num_steps=steps,
                    checkpoint_dir=cfg.get("checkpoint_dir"),
                    checkpoint_every=spe, callbacks=callbacks)
        else:
            final = resilience.run(
                stepped, state, num_steps=steps,
                checkpoint_dir=cfg.get("checkpoint_dir"),
                checkpoint_every=spe, callbacks=callbacks)
    finally:
        loader.close()
    rec["run_s"] = time.time() - t0
    load(final)
    rec["calls"] = calls
    rec["params_sha"] = _sha(model)
    if cfg.get("save_params"):
        from horovod_tpu_torch.models.convert import flatten_tree, flax_params

        rec["params_npz"] = os.path.join(cfg["out"], f"params{rank}.npz")
        np.savez(rec["params_npz"], **{
            f"p/{k}": v for k, v in flatten_tree(flax_params(model)).items()},
            **{f"s/{k}": v.detach().cpu().numpy()
               for k, v in model.jax_batch_stats().items()})
    kv = sanitizer._kv
    rec["kv"] = {"failovers": getattr(kv, "failovers", None),
                 "epoch_seen": getattr(kv, "fencing_epoch_seen", None)}
    if cfg.get("kill_at") is not None and hasattr(kv, "get"):
        from horovod_tpu_torch.run.rendezvous import (
            KVStoreClient, parse_endpoints,
        )

        eps = parse_endpoints(os.environ["HVD_RUN_KV_ADDRS"])
        standby = KVStoreClient(*eps[1])     # the promoted store itself
        later = range(cfg["kill_at"] + 1, steps - 1)
        rec["kv"]["later_keys_on_standby"] = sum(
            standby.get(sanitizer.schedule_key(s, rank)) is not None
            for s in later)
        rec["kv"]["later_keys"] = len(later)
    rec["substituted"] = metrics.value("data_samples_substituted")
    rec["quarantined"] = store.quarantined()
    rec["health"] = health.health_state().name
    if cuda and cfg.get("copy_ms"):
        # one batch's copy to the card from page-locked memory, alone
        bufs = [torch.from_numpy(a).pin_memory()
                for a in store.gather(np.arange(cfg["batch"] // size))]
        times = []
        for it in range(12):
            t0e = torch.cuda.Event(enable_timing=True)
            t1e = torch.cuda.Event(enable_timing=True)
            t0e.record()
            for b in bufs:
                b.to(dev, non_blocking=True)
            t1e.record()
            t1e.synchronize()
            if it >= 2:
                times.append(t0e.elapsed_time(t1e))
        rec["copy_ms"] = sorted(times)[len(times) // 2]
        rec["copy_bytes"] = int(sum(b.numel() * b.element_size()
                                    for b in bufs))
    if cuda:
        rec["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    return rec


def worker_main(path: str) -> None:
    """``--worker CFG``: ``hvd.init()`` on the launcher's world (on the
    CPU when ``CFG`` says ``"device": "cpu"``), :func:`worker`, and the
    record written to ``<out>/rank<r>.json``."""
    import horovod_tpu_torch as hvd

    t_start = time.time()
    with open(path) as f:
        cfg = json.load(f)
    hvd.init(device=cfg.get("device"))
    try:
        rec = worker(dict(cfg, t_start=t_start, t_init=time.time()))
        with open(os.path.join(cfg["out"], f"rank{hvd.rank()}.json"),
                  "w") as f:
            json.dump(rec, f)
    finally:
        hvd.shutdown()


def main() -> None:
    if len(sys.argv) > 2 and sys.argv[1] == "--worker":
        worker_main(sys.argv[2])
        return
    import subprocess

    import torch

    import chip_smoke as S
    from horovod_tpu_torch.ops import _build

    gpus = int(sys.argv[2]) if len(sys.argv) > 2 and \
        sys.argv[1] == "--gpus" else 1
    if not torch.cuda.is_available():
        S.fail("phase 22 needs a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=30, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.perf_counter()
    _build.build_all()
    print(f"build: {time.perf_counter() - t0:.2f} s", flush=True)
    out = {}
    if gpus == 1:
        p22, calls = S.launcher_phase(smi)
        S.print_launcher(p22, smi)
        out = {"phase22_s": p22["seconds"],
               "kernels": S.launcher_kernel_rows("hvdrun@1", calls)}
        print(f"kernels (hvdrun@1 replay): {json.dumps(out['kernels'])} "
              f"({smi})", flush=True)
    else:
        world, wcalls = S.launcher_gpus(gpus, smi)
        S.print_launcher_world(world, gpus, smi)
        out["world_kernels"] = S.launcher_kernel_rows(f"hvdrun@{gpus}",
                                                      wcalls)
        print(f"kernels (hvdrun@{gpus} replay, rank 0): "
              f"{json.dumps(out['world_kernels'])} ({smi})", flush=True)
    out["seconds"] = time.perf_counter() - t0
    print(json.dumps(out), flush=True)
    print(f"{out['seconds']:.1f} s ({smi})", flush=True)


if __name__ == "__main__":
    main()
