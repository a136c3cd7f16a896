"""The port stands alone: with JAX (and flax, optax, ml_dtypes) made
unimportable, every module of horovod_tpu_torch (and chip_smoke.py)
imports, a checkpoint the JAX package wrote restores, and nothing of the
JAX package is loaded."""

import os
import pathlib
import re
import subprocess
import sys

import pytest

pytestmark = pytest.mark.torch_port

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "horovod_tpu_torch"


def _modules():
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        yield ".".join(parts)


def test_every_module_imports_with_jax_poisoned():
    mods = list(_modules())
    assert {"horovod_tpu_torch.ops.kernels", "horovod_tpu_torch.ops.adasum",
            "horovod_tpu_torch.optim", "horovod_tpu_torch.ops.collective",
            "horovod_tpu_torch.training", "horovod_tpu_torch.checkpoint",
            "horovod_tpu_torch.pytree", "horovod_tpu_torch.data.sampler",
            "horovod_tpu_torch.models.vgg", "horovod_tpu_torch.models.inception",
            "horovod_tpu_torch.models.mlp",
            "horovod_tpu_torch.models.mnist", "horovod_tpu_torch.core",
            "horovod_tpu_torch.torch", "horovod_tpu_torch.torch.mpi_ops",
            "horovod_tpu_torch.torch.compression",
            "horovod_tpu_torch.torch.sync_batch_norm",
            "horovod_tpu_torch.parallel", "horovod_tpu_torch.parallel.mesh",
            "horovod_tpu_torch.ops.hierarchical",
            "horovod_tpu_torch.parallel.spmd",
            "horovod_tpu_torch.parallel.ring_attention",
            "horovod_tpu_torch.parallel.pipeline",
            "horovod_tpu_torch.parallel.moe",
            "horovod_tpu_torch.observability.metrics",
            "horovod_tpu_torch.resilience.health",
            "horovod_tpu_torch.resilience.retry",
            "horovod_tpu_torch.resilience.chaos",
            "horovod_tpu_torch.resilience.loop",
            "horovod_tpu_torch.resilience.elastic",
            "horovod_tpu_torch.run.rendezvous",
            "horovod_tpu_torch.callbacks"} <= set(mods)
    assert set(OBSERVABILITY_MODULES) <= set(mods)
    assert set(SERVING_MODULES) <= set(mods)
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'flax', 'optax', 'ml_dtypes'):\n"
        "    sys.modules[name] = None\n"
        "import importlib\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        # the ZeRO-3 and Adasum entry points, reached as a user reaches them
        "import horovod_tpu_torch as hvd\n"
        "from horovod_tpu_torch.ops import adasum, collective, kernels\n"
        "from horovod_tpu_torch.models.convert import fsdp_params_from_jax\n"
        "assert hvd.Adasum == 2 and hvd.num_rank_is_power_2(4)\n"
        "for f in (hvd.FsdpParams, hvd.fsdp_pack_params, hvd.fsdp_gather_params,\n"
        "          hvd.fsdp_unpack_params, collective.quantized_all_gather,\n"
        "          adasum.adasum_allreduce, adasum.grouped_adasum_allreduce,\n"
        "          kernels.dequantize_rows, kernels.adasum_pair_combine,\n"
        "          kernels.adasum_segment_combine, hvd.fsdp_reshard_params):\n"
        "    assert callable(f)\n"
        # the host mesh and the hierarchical collectives
        "from horovod_tpu_torch.parallel.mesh import build_host_mesh\n"
        "from horovod_tpu_torch.ops import hierarchical\n"
        "for f in (build_host_mesh, hierarchical.hier_allreduce,\n"
        "          hierarchical.hierarchical_allgather):\n"
        "    assert callable(f)\n"
        # tensor, sequence, pipeline and expert parallelism
        "from horovod_tpu_torch import parallel as par\n"
        "from horovod_tpu_torch.parallel import spmd\n"
        "from horovod_tpu_torch.models import transformer_param_specs\n"
        "from horovod_tpu_torch.models.transformer import tp_block_apply\n"
        "from horovod_tpu_torch.training import (make_sp_train_step,\n"
        "    make_pp_train_step, split_transformer_for_pp,\n"
        "    make_transformer_pp_train_step)\n"
        "for f in (par.build_mesh, par.MeshConfig, par.ring_attention,\n"
        "          par.zigzag_ring_attention, par.ulysses_attention,\n"
        "          par.pipeline_apply, par.pipeline_apply_interleaved,\n"
        "          par.expert_parallel_moe, spmd.psum, spmd.ppermute,\n"
        "          spmd.all_to_all, tp_block_apply, transformer_param_specs,\n"
        "          make_sp_train_step, make_pp_train_step,\n"
        "          split_transformer_for_pp, make_transformer_pp_train_step):\n"
        "    assert callable(f)\n"
        # checkpoint and the new models, as a user reaches them
        "import horovod_tpu_torch.checkpoint as ck\n"
        "from horovod_tpu_torch.models import VGG16, InceptionV3, MLP, MnistCNN\n"
        "from horovod_tpu_torch.training import host_snapshot\n"
        "for f in (ck.save, ck.restore, ck.CheckpointManager, host_snapshot,\n"
        "          ck.consolidate_opt_state, VGG16, InceptionV3, MLP, MnistCNN):\n"
        "    assert callable(f)\n"
        # the numerics guard and dynamic loss scaling
        "from horovod_tpu_torch.resilience import chaos, numerics\n"
        "tx = hvd.DistributedOptimizer(hvd.adam(1e-3), loss_scale='dynamic')\n"
        "assert numerics.is_guarded(tx) and chaos.parse_spec('grad_nan_at_step=2')\n"
        # resilience: the preemption loop and the elastic driver, driven
        # in a world of one, and the stdlib-only modules import alone
        "import numpy as np\n"
        "from horovod_tpu_torch import resilience\n"
        "from horovod_tpu_torch.resilience import elastic, loop\n"
        "from horovod_tpu_torch.callbacks import HealthCallback\n"
        "out = loop.run(lambda st, i: {'w': st['w'] + 1}, {'w': np.zeros(1)},\n"
        "               num_steps=2, callbacks=[HealthCallback()])\n"
        "assert float(out['w'][0]) == 2.0 and resilience.RESUMABLE_EXIT_CODE == 75\n"
        "assert hvd.health_state() == resilience.HealthState.HEALTHY\n"
        "hvd.init(device='cpu')\n"
        "out = elastic.run(lambda n: (lambda st, i: {'w': st['w'] + n}),\n"
        "                  {'w': np.zeros(1)}, num_steps=3)\n"
        "assert float(out['w'][0]) == 3.0\n"
        "hvd.shutdown()\n"
        "import subprocess\n"
        "light = ('horovod_tpu_torch.observability.metrics', "
        "'horovod_tpu_torch.resilience.health', "
        "'horovod_tpu_torch.resilience.retry', "
        "'horovod_tpu_torch.run.rendezvous', 'horovod_tpu_torch.callbacks')\n"
        "for m in light:\n"
        "    probe = ('import sys, importlib; importlib.import_module(%r); '\n"
        "             'bad = [n for n in sys.modules if n.split(\".\")[0] in '\n"
        "             '(\"jax\", \"horovod_tpu\")]; assert not bad, bad' % m)\n"
        "    subprocess.run([sys.executable, '-c', probe], check=True)\n"
        # the frontend and the native core, driven in a world of one
        "import torch\n"
        "import horovod_tpu_torch.torch as thvd\n"
        "thvd.init(device='cpu', native_core=True)\n"
        "from horovod_tpu_torch import basics\n"
        "assert basics.core() is not None\n"
        "h = thvd.allreduce_async(torch.ones(3), name='g', op=thvd.Sum)\n"
        "assert thvd.synchronize(h).tolist() == [1.0, 1.0, 1.0]\n"
        "for f in (thvd.DistributedOptimizer, thvd.SyncBatchNorm,\n"
        "          thvd.broadcast_parameters, thvd.broadcast_optimizer_state):\n"
        "    assert callable(f)\n"
        "thvd.shutdown()\n"
        "import runpy\n"
        f"runpy.run_path({str(ROOT / 'chip_smoke.py')!r}, run_name='chip_smoke')\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m == 'horovod_tpu' or m.startswith('horovod_tpu.'))\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.startswith("ok")


#: the modules of the observability and analysis slice
OBSERVABILITY_MODULES = (
    "horovod_tpu_torch.observability",
    "horovod_tpu_torch.observability.trace",
    "horovod_tpu_torch.observability.clock",
    "horovod_tpu_torch.observability.exporters",
    "horovod_tpu_torch.observability.straggler",
    "horovod_tpu_torch.observability.aggregate",
    "horovod_tpu_torch.observability.flight",
    "horovod_tpu_torch.observability.slo",
    "horovod_tpu_torch.observability.regression",
    "horovod_tpu_torch.observability.reqtrace",
    "horovod_tpu_torch.analysis",
    "horovod_tpu_torch.analysis.sanitizer",
    "horovod_tpu_torch.analysis.lint",
    "horovod_tpu_torch.analysis.schedule",
    "horovod_tpu_torch.profiler",
    "horovod_tpu_torch.tuning",
)


@pytest.mark.parametrize("mod", OBSERVABILITY_MODULES)
def test_observability_module_imports_neither_jax_nor_the_jax_package(mod):
    """Each module of the slice, imported alone in a fresh interpreter,
    loads nothing of JAX or of ``horovod_tpu``, and no line of its source
    imports them lazily either (inside a function)."""
    probe = (
        "import sys, importlib\n"
        f"m = importlib.import_module({mod!r})\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'horovod_tpu'))\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    path = ROOT / (mod.replace(".", "/") + ".py")
    if not path.exists():
        path = ROOT / mod.replace(".", "/") / "__init__.py"
    lazy = re.compile(r"^\s+(import|from) (jax|flax|optax|horovod_tpu)\b")
    assert not [l for l in path.read_text().splitlines() if lazy.match(l)]


#: the modules of the serving slice
SERVING_MODULES = (
    "horovod_tpu_torch.serving",
    "horovod_tpu_torch.serving.protocol",
    "horovod_tpu_torch.serving.scheduler",
    "horovod_tpu_torch.serving.publisher",
    "horovod_tpu_torch.serving.subscriber",
    "horovod_tpu_torch.serving.engine",
    "horovod_tpu_torch.serving.rollout",
    "horovod_tpu_torch.serving.fleet",
)


@pytest.mark.parametrize("mod", SERVING_MODULES)
def test_serving_module_imports_with_jax_and_the_jax_package_blocked(mod):
    """Each serving module imports alone in a fresh interpreter where
    ``jax`` (and flax, optax, ml_dtypes) and ``horovod_tpu`` cannot be
    imported, and no line of its source imports them lazily."""
    probe = (
        "import sys, importlib\n"
        "for name in ('jax', 'jaxlib', 'flax', 'optax', 'ml_dtypes', "
        "'horovod_tpu'):\n"
        "    sys.modules[name] = None\n"
        f"m = importlib.import_module({mod!r})\n"
        "import horovod_tpu_torch.serving as s\n"
        "for n in s.__all__:\n"
        "    assert getattr(s, n) is not None, n\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    path = ROOT / (mod.replace(".", "/") + ".py")
    if not path.exists():
        path = ROOT / mod.replace(".", "/") / "__init__.py"
    lazy = re.compile(r"^\s+(import|from) (jax|flax|optax|horovod_tpu)\b")
    assert not [l for l in path.read_text().splitlines() if lazy.match(l)]


#: the modules of the launcher and input-plane slice
LAUNCHER_MODULES = (
    "horovod_tpu_torch.run",
    "horovod_tpu_torch.run.__main__",
    "horovod_tpu_torch.run.hosts",
    "horovod_tpu_torch.run.config_parser",
    "horovod_tpu_torch.run.safe_exec",
    "horovod_tpu_torch.run.env_util",
    "horovod_tpu_torch.run.replication",
    "horovod_tpu_torch.run.runner",
    "horovod_tpu_torch.data",
    "horovod_tpu_torch.data.store",
    "horovod_tpu_torch.data.loader",
    "horovod_tpu_torch.compat",
    "horovod_tpu_torch.callbacks",
    "horovod_tpu_torch.training",
    "horovod_tpu_torch.optim",
)


@pytest.mark.parametrize("mod", LAUNCHER_MODULES)
def test_launcher_module_imports_with_jax_and_the_jax_package_blocked(mod):
    """Each module of the launcher slice imports alone in a fresh
    interpreter where ``jax`` (and flax, optax, ml_dtypes) and
    ``horovod_tpu`` cannot be imported, has the JAX package's public names
    it ports, and no line of its source imports them lazily."""
    probe = (
        "import sys, importlib\n"
        "for name in ('jax', 'jaxlib', 'flax', 'optax', 'ml_dtypes', "
        "'horovod_tpu'):\n"
        "    sys.modules[name] = None\n"
        f"m = importlib.import_module({mod!r})\n"
        "from horovod_tpu_torch import callbacks, optim, training\n"
        "from horovod_tpu_torch.data import (ArrayShardStore, HDFSStore,\n"
        "    LocalStore, ResumableLoader, ShardedLoader, shard_indices)\n"
        "from horovod_tpu_torch.run import run, run_commandline, main\n"
        "for n in ('BroadcastGlobalVariablesCallback', "
        "'MetricAverageCallback', 'LearningRateScheduleCallback', "
        "'LearningRateWarmupCallback', 'apply_lr', 'scale_momentum'):\n"
        "    assert callable(getattr(callbacks, n)), n\n"
        "assert callable(optim.inject_hyperparams) and callable(optim.sgd)\n"
        "assert callable(training.make_loader_step)\n"
        "assert 'horovod_tpu' not in sys.modules or "
        "sys.modules['horovod_tpu'] is None\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    path = ROOT / (mod.replace(".", "/") + ".py")
    if not path.exists():
        path = ROOT / mod.replace(".", "/") / "__init__.py"
    lazy = re.compile(r"^\s+(import|from) (jax|flax|optax|horovod_tpu)\b")
    assert not [l for l in path.read_text().splitlines() if lazy.match(l)]


def test_the_launcher_tool_imports_neither_jax_nor_the_jax_package():
    """``tools/launcher_phase.py`` (phase 22's worker) and ``bin/
    hvdrun_torch`` import no JAX: every import line names the port, the
    standard library, numpy or torch (or ``chip_smoke``)."""
    for rel in ("tools/launcher_phase.py", "bin/hvdrun_torch"):
        text = (ROOT / rel).read_text()
        assert not re.search(r"^\s*(import|from) (jax|flax|optax|"
                             r"horovod_tpu)\b", text, re.M), rel


def test_serving_package_import_stays_light():
    """``import horovod_tpu_torch.serving`` loads the handoff surface
    only: the engine, rollout, fleet and scheduler load on first use of
    their names, as in the JAX package; its exports are
    the JAX package's."""
    import horovod_tpu.serving as js

    probe = (
        "import sys\n"
        "import horovod_tpu_torch.serving as s\n"
        "heavy = [n for n in ('horovod_tpu_torch.serving.engine',\n"
        "         'horovod_tpu_torch.serving.rollout',\n"
        "         'horovod_tpu_torch.serving.fleet',\n"
        "         'horovod_tpu_torch.serving.scheduler') if n in sys.modules]\n"
        "assert not heavy, heavy\n"
        "assert s.InferenceEngine.__module__ == "
        "'horovod_tpu_torch.serving.engine'\n"
        "assert 'horovod_tpu_torch.serving.engine' in sys.modules\n"
        "print(sorted(s.__all__))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == str(sorted(js.__all__))


def test_observability_exports_match_the_jax_package():
    """``horovod_tpu_torch.observability`` and ``.analysis`` export every
    name the JAX package's do."""
    import horovod_tpu.analysis as ja
    import horovod_tpu.observability as jo
    import horovod_tpu_torch.analysis as ta
    import horovod_tpu_torch.observability as to

    for j, t in ((jo, to),):
        missing = {n for n in vars(j) if not n.startswith("_")} - set(vars(t))
        assert not missing, sorted(missing)
    jax_only = {"interleave_profile", "collectives_before_last_compute"}
    assert set(ja.__all__) - set(ta.__all__) == jax_only
    for n in ta.__all__:
        assert getattr(ta, n) is not None


def test_parallel_exports_match_the_jax_package():
    """``horovod_tpu_torch.parallel`` exports every name the JAX package's
    ``horovod_tpu.parallel`` does (its submodules aside), and
    ``horovod_tpu_torch.models`` its ``transformer_param_specs``."""
    import types

    import horovod_tpu.parallel as jp
    import horovod_tpu_torch.models as tmodels
    import horovod_tpu_torch.parallel as tp

    def names(m):
        return {n for n, v in vars(m).items() if not n.startswith("_")
                and not isinstance(v, types.ModuleType)}

    missing = names(jp) - names(tp)
    assert not missing, sorted(missing)
    assert callable(tmodels.transformer_param_specs)


def test_no_source_line_imports_jax_or_the_jax_package():
    pat = re.compile(
        r"^\s*(import|from) (jax|flax|optax|ml_dtypes|horovod_tpu)\b")
    files = list(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    hits = [f"{f}:{i}" for f in files
            for i, line in enumerate(f.read_text().splitlines(), 1)
            if pat.match(line)]
    assert not hits, hits


def test_a_jax_checkpoint_restores_with_jax_poisoned(tmp_path):
    """The JAX package writes a checkpoint (an optax Adam state, an
    ``_EFState``, a bf16 leaf); a process that cannot import JAX, flax,
    optax or ml_dtypes restores it through the port, writes it back, and
    never loads the JAX package."""
    import numpy as np
    import jax.numpy as jnp
    import optax

    from horovod_tpu import checkpoint as jck
    from horovod_tpu.optim import _EFState

    params = {"w": np.arange(6, dtype=np.float32).reshape(2, 3),
              "h": np.asarray(jnp.arange(4, dtype=jnp.bfloat16))}
    state = {"params": params, "step": 3,
             "opt": _EFState(optax.adam(1e-3).init(params),
                             {"float32": np.ones(4, np.float32)})}
    jck.save(str(tmp_path / "jax"), 3, state)
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'flax', 'optax', 'ml_dtypes'):\n"
        "    sys.modules[name] = None\n"
        "from horovod_tpu_torch import checkpoint as ck\n"
        "from horovod_tpu_torch.training import host_tensor\n"
        f"d = {str(tmp_path)!r}\n"
        "t = ck.restore(d + '/jax', 3)\n"
        "adam = t['opt'].inner[0]\n"
        "assert type(adam).__name__ == 'ScaleByAdamState' and int(adam.count) == 0\n"
        "assert t['params']['h'].dtype.str == '|V2'\n"
        "assert host_tensor(t['params']['h']).float().tolist() == [0, 1, 2, 3]\n"
        "ck.save(d + '/port', 3, t)\n"
        "assert ck.latest_step(d + '/port') == 3\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('horovod_tpu', 'jax', 'optax', 'flax', 'ml_dtypes')\n"
        "             and sys.modules[m] is not None)\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip() == "ok"
    back = jck.restore(str(tmp_path / "port"), 3)
    assert type(back["opt"]).__name__ == "_EFState"
    np.testing.assert_array_equal(back["params"]["w"], params["w"])


def test_the_new_state_kinds_restore_with_jax_poisoned(tmp_path):
    """optax's ``MultiStepsState`` around a ``_PowerSGDState`` and a
    bucketed ZeRO-1 ``_EFState`` (``float32#k`` groups), written by the
    JAX package, restore and consolidate in a process that cannot import
    JAX, flax, optax or ml_dtypes; the bucketed exchange and PowerSGD
    (``ops.overlap``, ``compression``) run there too."""
    import numpy as np
    import optax

    import horovod_tpu as jhvd
    from horovod_tpu import checkpoint as jck

    params = {"w": np.ones((16, 12), np.float32), "b": np.zeros(12, np.float32)}
    jhvd.init(devices=__import__("jax").devices()[:1])
    try:
        psgd = jhvd.DistributedOptimizer(
            optax.adam(1e-3), compression=jhvd.Compression.powersgd(2),
            error_feedback=True, backward_passes_per_step=2).init(params)
        zero1 = jhvd.DistributedOptimizer(
            optax.adam(1e-3), compression=jhvd.Compression.fp16,
            error_feedback=True, shard_optimizer=True,
            bucket_bytes=256).init(params)
    finally:
        jhvd.shutdown()
    jck.save(str(tmp_path / "jax"), 1, {"params": params, "psgd": psgd,
                                        "zero1": zero1})
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'flax', 'optax', 'ml_dtypes'):\n"
        "    sys.modules[name] = None\n"
        "import torch\n"
        "import horovod_tpu_torch as hvd\n"
        "from horovod_tpu_torch import checkpoint as ck\n"
        "from horovod_tpu_torch.ops import overlap as ov\n"
        f"d = {str(tmp_path)!r}\n"
        "t = ck.restore(d + '/jax', 1)\n"
        "hvd.init(device='cpu')\n"
        "ms = ck.consolidate_opt_state(t['psgd'], t['params'])\n"
        "assert type(ms).__name__ == 'MultiStepsState'\n"
        "assert tuple(ms.inner_opt_state['q']['w'].shape) == (12, 2)\n"
        "z = ck.consolidate_opt_state(t['zero1'], t['params'], bucket_bytes=256)\n"
        "assert len(z['residual']) > 1 and z['shard'] == {'rank': 0, 'size': 1}\n"
        "g = {'w': torch.ones(16, 12), 'b': torch.ones(12)}\n"
        "red, _ = ov.bucketed_allreduce(g, bucket_bytes=256)\n"
        "assert all(torch.equal(red[k], g[k]) for k in g)\n"
        "tx = hvd.DistributedOptimizer(hvd.adam(1e-3), error_feedback=True,\n"
        "    compression=hvd.Compression.powersgd(2), backward_passes_per_step=2)\n"
        "p = {k: torch.from_numpy(v.copy()) for k, v in t['params'].items()}\n"
        "for _ in range(2):\n"
        "    u, ms = tx.update(g, ms, p)\n"
        "assert int(ms.gradient_step) == 1\n"
        "hvd.shutdown()\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('horovod_tpu', 'jax', 'optax', 'flax', 'ml_dtypes')\n"
        "             and sys.modules[m] is not None)\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip() == "ok"


#: the modules of the frontends and estimator slice; each group is
#: imported in one fresh interpreter (the TensorFlow and Keras group runs
#: where TensorFlow is installed: it imports it)
FRONTEND_MODULES = {
    "estimator": ("horovod_tpu_torch.estimator",),
    "mxnet": ("horovod_tpu_torch.mxnet", "horovod_tpu_torch.mxnet.mpi_ops"),
    "spark": ("horovod_tpu_torch.spark", "horovod_tpu_torch.spark.keras",
              "horovod_tpu_torch.spark.torch"),
    "tensorflow": ("horovod_tpu_torch.tensorflow.compression",
                   "horovod_tpu_torch.tensorflow.mpi_ops",
                   "horovod_tpu_torch.tensorflow",
                   "horovod_tpu_torch.tensorflow.keras",
                   "horovod_tpu_torch.keras",
                   "horovod_tpu_torch.keras.callbacks"),
}


@pytest.mark.parametrize("group", sorted(FRONTEND_MODULES))
def test_frontend_modules_import_with_jax_and_the_jax_package_blocked(group):
    """Each group of frontend modules imports in a fresh interpreter where
    ``jax`` (and flax, optax) and ``horovod_tpu`` cannot be imported;
    each module has the public functions and classes of its JAX
    counterpart, and no line of its source imports them lazily.
    ``ml_dtypes`` stays importable: TensorFlow needs it."""
    if group == "tensorflow":
        pytest.importorskip("tensorflow")
    mods = FRONTEND_MODULES[group]
    names = {mod: _public_names(_source(mod.replace("horovod_tpu_torch",
                                                    "horovod_tpu")))
             for mod in mods}
    probe = (
        "import sys, importlib\n"
        "for name in ('jax', 'jaxlib', 'flax', 'optax', 'horovod_tpu'):\n"
        "    sys.modules[name] = None\n"
        f"for mod, names in {names!r}.items():\n"
        "    m = importlib.import_module(mod)\n"
        "    missing = [n for n in names if not hasattr(m, n)]\n"
        "    assert not missing, (mod, missing)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
        "('jax', 'flax', 'optax', 'horovod_tpu') and sys.modules[n])\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    lazy = re.compile(r"^\s+(import|from) (jax|flax|optax|horovod_tpu)\b")
    for mod in mods:
        assert not [l for l in _source(mod).read_text().splitlines()
                    if lazy.match(l)], mod


def _source(mod: str) -> pathlib.Path:
    path = ROOT / (mod.replace(".", "/") + ".py")
    return path if path.exists() else ROOT / mod.replace(".", "/") / \
        "__init__.py"


def _public_names(path: pathlib.Path) -> list:
    """The public names a module defines or takes from its own package
    (its top-level functions, classes and assignments, and what it
    imports from ``horovod_tpu*``), read from its source: the JAX
    package's frontends import TensorFlow, which this process need not
    load to list them."""
    import ast

    out = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, ast.Assign):
            out.update(t.id for t in node.targets if isinstance(t, ast.Name))
        elif isinstance(node, ast.ImportFrom) and (node.module or "") \
                .startswith("horovod_tpu"):
            out.update(a.asname or a.name for a in node.names)
    return sorted(n for n in out if not n.startswith("_") and n != "*")


def test_every_jax_module_has_a_counterpart():
    """Every module of the JAX package has one at the same path in the
    port, but ``ops/hostlocal.py`` (not ported, a decision on record) and
    ``ops/pallas_kernels.py`` (whose counterpart is ``ops/kernels.py``)."""
    jax_pkg = ROOT / "horovod_tpu"
    have = {p.relative_to(PKG).as_posix() for p in PKG.rglob("*.py")}
    want = {p.relative_to(jax_pkg).as_posix() for p in jax_pkg.rglob("*.py")}
    assert want - have == {"ops/hostlocal.py", "ops/pallas_kernels.py"}
    assert "ops/kernels.py" in have


def test_the_package_import_loads_no_frontend_framework():
    """``import horovod_tpu_torch`` loads none of TensorFlow, Keras,
    pandas or the frontends."""
    probe = (
        "import sys\n"
        "import horovod_tpu_torch\n"
        "heavy = sorted(n for n in sys.modules if n.split('.')[0] in "
        "('tensorflow', 'keras', 'pandas', 'pyarrow', 'mxnet', 'pyspark') "
        "or n.startswith(('horovod_tpu_torch.tensorflow', "
        "'horovod_tpu_torch.keras', 'horovod_tpu_torch.estimator', "
        "'horovod_tpu_torch.spark', 'horovod_tpu_torch.mxnet')))\n"
        "assert not heavy, heavy\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]


def test_the_frontends_tool_imports_neither_jax_nor_the_jax_package():
    """``tools/frontends_phase.py`` (phase 23's bodies) imports no JAX and
    nothing of the JAX package, at any depth of its source."""
    text = (ROOT / "tools" / "frontends_phase.py").read_text()
    assert not re.search(r"^\s*(import|from) (jax|flax|optax|"
                         r"horovod_tpu)\b", text, re.M)
