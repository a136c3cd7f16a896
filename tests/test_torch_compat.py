"""Framework version floors of horovod_tpu_torch (``compat.py``), case for
case with ``tests/test_compat.py``: the port's floors are torch's and
numpy's, the live environment meets them, a violation is reported with
the JAX package's parse of local suffixes, and ``hvd.init()`` warns (and
only then)."""

import importlib
import warnings

import pytest

from horovod_tpu import compat as jcompat
from horovod_tpu_torch import compat

pytestmark = pytest.mark.torch_port


def test_floors_are_the_ports():
    assert set(compat.MIN_VERSIONS) == {"torch", "numpy"}
    assert not {"jax", "flax", "optax"} & set(compat.MIN_VERSIONS)


def test_live_environment_meets_floors():
    live = {n: importlib.import_module(n).__version__
            for n in compat.MIN_VERSIONS}
    assert compat.check_versions(live) == []
    assert compat.installed_versions()["torch"] == str(live["torch"])


def test_floor_violation_detected():
    probs = compat.check_versions({"torch": "1.13.1", "numpy": "1.20.0",
                                   "jax": "0.1.0"})
    assert len(probs) == 2
    assert any("torch 1.13.1" in p for p in probs)
    assert any("numpy 1.20.0" in p for p in probs)


@pytest.mark.parametrize("v", ["2.13.0+cpu", "0.9", "2.0.0rc1", "12.9.1",
                               "2.4"])
def test_version_parse_matches_jax(v):
    assert compat._parse(v) == jcompat._parse(v)


def test_init_warns_on_unsupported(monkeypatch):
    import horovod_tpu_torch as hvd

    monkeypatch.setitem(compat.MIN_VERSIONS, "torch",
                        ("999.0.0", "the future"))
    with pytest.warns(RuntimeWarning, match="below the supported floor"):
        hvd.init(device="cpu")
    hvd.shutdown()


def test_init_silent_when_supported():
    import horovod_tpu_torch as hvd

    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        hvd.init(device="cpu")
    hvd.shutdown()
    assert not [x for x in w if "supported floor" in str(x.message)]
