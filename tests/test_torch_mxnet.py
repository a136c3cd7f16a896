"""The MXNet frontend of horovod_tpu_torch (``horovod_tpu_torch/mxnet/``)
against the JAX package's (``horovod_tpu/mxnet/``), through the JAX
tests' fakes (MXNet is retired upstream and not installed: the frontend
is duck-typed, the gluon trainer gated).

In one process (the port a world of one, the JAX package 8 replicas):
``rescale_grad`` is ``1 / size()`` in each; a summed allreduce is the
gradient times ``size()`` in each (exact: the inputs are small
integers); the optimizer's delegation, the trainer mixin and the dict
broadcast behave alike. The bridge hands the collective a tensor on
``basics.device()``. A gloo world of 2 runs every op on rank-distinct
integer-valued inputs and is held to numpy arithmetic exactly."""

import numpy as np
import pytest
import torch

import horovod_tpu.mxnet as jmx
import horovod_tpu_torch.mxnet as tmx
from horovod_tpu_torch import basics
from horovod_tpu_torch.ops import collective as C
from horovod_tpu_torch.testing import run_world

import torch_frontends_workers as W

pytestmark = pytest.mark.torch_port


@pytest.fixture(scope="module")
def both():
    import horovod_tpu as jhvd

    jhvd.init()
    tmx.init(device="cpu")
    yield
    tmx.shutdown()
    jhvd.shutdown()


@pytest.fixture(scope="module")
def world():
    return run_world(W.mxnet_world_worker, 2, timeout=120)


@pytest.mark.parametrize("m", [jmx, tmx], ids=["jax", "port"])
def test_rescale_grad_and_summed_update(both, m):
    inner = W.FakeOptimizer()
    opt = m.DistributedOptimizer(inner)
    assert opt.rescale_grad == pytest.approx(1.0 / m.size())
    grad = np.full((3,), 2.0, np.float32)
    opt.update(0, np.zeros((3,), np.float32), grad, None)
    if m.size() > 1:
        np.testing.assert_array_equal(grad, 2.0 * m.size())
    else:   # a world of one exchanges nothing (the reference's rule)
        np.testing.assert_array_equal(grad, 2.0)
    assert inner.seen[0][:2] == ("update", 0)
    np.testing.assert_array_equal(inner.seen[0][2], grad)
    grads = [np.ones((2,), np.float32), np.full((2,), 3.0, np.float32)]
    opt.update_multi_precision([4, 7], [None, None], grads, [None, None])
    np.testing.assert_array_equal(np.stack(grads),
                                  np.stack([np.ones(2), np.full(2, 3.0)])
                                  * (m.size() if m.size() > 1 else 1))
    assert inner.seen[1][:2] == ("ump", [4, 7])
    assert opt.seen is inner.seen   # __getattr__ reaches the wrapped one


@pytest.mark.parametrize("m", [jmx, tmx], ids=["jax", "port"])
def test_collectives_over_replicated_numpy(both, m):
    x = W.rank_input(0)
    np.testing.assert_array_equal(m.allreduce(x, average=True, name="a"), x)
    np.testing.assert_array_equal(m.allreduce(x, average=False),
                                  x * m.size())
    np.testing.assert_array_equal(m.allgather(x), np.tile(x, (m.size(), 1)))
    np.testing.assert_array_equal(m.broadcast(x, 0), x)
    y = x.copy()
    assert m.broadcast_(y, 0, name="b") is y
    assert m.allreduce_(y, average=False) is y
    np.testing.assert_array_equal(y, x * m.size())
    for out in (m.allreduce(x), m.allgather(x), m.broadcast(x, 0)):
        assert isinstance(out, np.ndarray) and out.dtype == np.float32


@pytest.mark.parametrize("m", [jmx, tmx], ids=["jax", "port"])
def test_trainer_mixin_and_dict_broadcast(both, m):
    class Trainer(m._TrainerAllreduceMixin):
        def __init__(self, params):
            self._params = params

    g1 = np.ones((2,), np.float32)
    g2 = np.full((2,), 5.0, np.float32)
    Trainer([W.FakeParam("w", g1), W.FakeParam("frozen", g2, "null")])\
        ._allreduce_grads()
    np.testing.assert_array_equal(g1, float(m.size() if m.size() > 1 else 1))
    np.testing.assert_array_equal(g2, 5.0)
    params = {"w": np.arange(4, dtype=np.float32),
              "b": np.full((2,), 3.0, np.float32)}
    m.broadcast_parameters(params, root_rank=0)
    np.testing.assert_array_equal(params["w"], np.arange(4))
    if m.size() > 1:    # a world of one returns before it looks
        with pytest.raises(ValueError, match="invalid params"):
            m.broadcast_parameters([("w", np.zeros(2))])
    with pytest.raises(ImportError, match="mxnet"):
        m.DistributedTrainer([], W.FakeOptimizer())
    assert m._HAVE_MXNET is False


def test_public_names_match_the_jax_package():
    missing = {n for n in dir(jmx) if not n.startswith("_")} - set(dir(tmx))
    assert not missing, sorted(missing)
    assert set(tmx.mpi_ops.__dict__) >= {
        n for n in jmx.mpi_ops.__dict__ if not n.startswith("_")}


def test_bridge_hands_the_collective_a_tensor_on_this_device(both,
                                                             monkeypatch):
    """Every op moves the values to ``basics.device()`` before the
    collective (the card on a GPU machine), and writes back in place
    for the in-place ops."""
    seen = []

    def spy(name):
        real = getattr(C, name)

        def call(t, *a, **k):
            seen.append((name, t.device, t.dtype))
            return real(t, *a, **k)
        return call

    for name in ("allreduce", "allgather", "broadcast"):
        monkeypatch.setattr(C, name, spy(name))
    nd = W.NDArray(W.rank_input(0))
    tmx.allreduce_(nd, average=False)
    tmx.broadcast_(nd, 0)
    tmx.allgather(np.ones((1, 2), np.float32))
    dev = basics.device()
    assert seen == [("allreduce", dev, torch.float32),
                    ("broadcast", dev, torch.float32),
                    ("allgather", dev, torch.float32)]
    np.testing.assert_array_equal(nd.asnumpy(), W.rank_input(0))


def test_world_collectives_exact(world):
    x0, x1 = W.rank_input(0), W.rank_input(1)
    for r, got in enumerate(world):
        np.testing.assert_array_equal(got["sum"], x0 + x1)
        np.testing.assert_array_equal(got["avg"], (x0 + x1) / np.float32(2))
        np.testing.assert_array_equal(got["sum_"], x0 + x1)
        np.testing.assert_array_equal(got["gather"],
                                      np.concatenate([x0[:2], x1[:2]]))
        np.testing.assert_array_equal(got["bcast"], x1)
        np.testing.assert_array_equal(got["bcast_nd"], x1)
        assert set(got["kinds"].values()) == {"ndarray"}
        assert got["rescale_grad"] == 0.5
        np.testing.assert_array_equal(got["update_grad"], np.full(3, 6.0))
        np.testing.assert_array_equal(got["ump_grads"],
                                      [[3.0, 3.0], [9.0, 9.0]])
        assert got["inner_seen"] == [("update", 0), ("ump", [4, 7])]
        np.testing.assert_array_equal(got["trainer"],
                                      [[3.0, 3.0], [5.0 * (r + 1)] * 2])
        np.testing.assert_array_equal(got["params"]["w"],
                                      W.rank_input(1, (4,)))
        np.testing.assert_array_equal(got["params"]["b"], [2.0, 2.0])
