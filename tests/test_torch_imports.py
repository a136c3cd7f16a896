"""The port stands alone: with JAX made unimportable, every module of
horovod_tpu_torch (and chip_smoke.py) imports, and nothing of the JAX
package is loaded."""

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
            "horovod_tpu_torch.training"} <= set(mods)
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'flax', 'optax'):\n"
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
        "          kernels.adasum_segment_combine):\n"
        "    assert callable(f)\n"
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


def test_no_source_line_imports_jax_or_the_jax_package():
    pat = re.compile(r"^\s*(import|from) (jax|flax|optax|horovod_tpu)\b")
    files = list(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    hits = [f"{f}:{i}" for f in files
            for i, line in enumerate(f.read_text().splitlines(), 1)
            if pat.match(line)]
    assert not hits, hits
