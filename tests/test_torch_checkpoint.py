"""horovod_tpu_torch.checkpoint: the JAX package's checkpoint tests
(``tests/test_checkpoint.py``) against the port, the validity sweep, both
directions between the two packages (each restores what the other
wrote, leaf for leaf and bit for bit; the files are the same bytes), and
gloo worlds of 2 and 4: restore from the root's directory only, a
writer's failure on every rank, and a ZeRO-1 + EF state saved at world
4 and consolidated to world 2 against the JAX package's
``reshard_optimizer_state``. The optimizer states of bucketed overlap
(a ZeRO-1 state keyed ``dtype#k``), PowerSGD (``_PowerSGDState``) and
``backward_passes_per_step`` (optax's ``MultiStepsState``) that the JAX
package wrote restore in the port and continue as the JAX package
continues; the port's own saves of them restore in the JAX package."""

import logging
import os
import zipfile

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
import optax

import horovod_tpu as jhvd
from horovod_tpu import checkpoint as jck
from horovod_tpu.optim import _EFState, reshard_optimizer_state as jreshard
import horovod_tpu_torch as hvd
from horovod_tpu_torch import checkpoint as ck
from horovod_tpu_torch.models.convert import load_flax_variables
from horovod_tpu_torch.optim import reshard_optimizer_state
from horovod_tpu_torch.testing import run_world
from horovod_tpu_torch.training import host_snapshot, host_tensor

import test_torch_workers as W

pytestmark = pytest.mark.torch_port


def _state(step):
    return {"params": {"w": torch.full((2, 3), float(step)),
                       "b": torch.zeros(3)},
            "step": step, "meta": {"lr": 0.1, "note": "hello"}}


def _steps(d):
    return sorted(int(n.split("_")[1]) for n in os.listdir(d)
                  if n.startswith("step_"))


# --------------------------------------------------------------------------
# tests/test_checkpoint.py, against the port


@pytest.mark.parametrize("asynchronous", [False, True])
def test_roundtrip(tmp_path, asynchronous):
    d = str(tmp_path / "ck")
    mgr = ck.CheckpointManager(d)
    mgr.save(5, _state(5), asynchronous=asynchronous)
    mgr.wait_until_finished()
    out = mgr.restore(5)
    np.testing.assert_array_equal(out["params"]["w"], np.full((2, 3), 5.0))
    assert out["params"]["w"].dtype == np.float32
    assert out["step"] == 5 and out["meta"] == {"lr": 0.1, "note": "hello"}


def test_latest_step_discovery(tmp_path):
    d = str(tmp_path / "ck")
    for s in (1, 3, 2):
        ck.save(d, s, _state(s))
    assert ck.latest_step(d) == 3
    assert ck.restore(d)["step"] == 3
    assert ck.valid_steps(d) == [1, 2, 3]


def test_no_checkpoints(tmp_path):
    assert ck.latest_step(str(tmp_path / "none")) is None
    with pytest.raises(FileNotFoundError):
        ck.restore(str(tmp_path / "none"))


def test_overwrite_requires_force(tmp_path):
    d = str(tmp_path / "ck")
    ck.save(d, 1, _state(1))
    with pytest.raises(FileExistsError):
        ck.save(d, 1, _state(1))
    ck.save(d, 1, _state(7), force=True)
    assert ck.restore(d, 1)["step"] == 7


def test_partial_write_not_visible(tmp_path):
    d = str(tmp_path / "ck")
    ck.save(d, 1, _state(1))
    os.makedirs(os.path.join(d, ".tmp_step_9_junk"))   # a crashed writer
    assert ck.latest_step(d) == 1


@pytest.mark.parametrize("asynchronous", [False, True])
def test_rotation_keeps_last_n(tmp_path, asynchronous):
    """Rotation keeps the newest two; asynchronously, each save first
    fences the one in flight."""
    mgr = ck.CheckpointManager(str(tmp_path / "ck"), max_to_keep=2)
    for s in range(5):
        mgr.save(s, _state(s), asynchronous=asynchronous)
    assert mgr.latest_step() == 4
    assert _steps(str(tmp_path / "ck")) == [3, 4]
    assert mgr.restore()["step"] == 4


def test_async_snapshot_is_taken_at_call(tmp_path):
    """In-place changes after ``save()`` (a host array, a tensor, a view)
    do not reach the checkpoint: the snapshot is taken at the call."""
    mgr = ck.CheckpointManager(str(tmp_path / "ck"))
    w = torch.ones(4, 3)
    state = {"host": np.ones(4), "w": w, "view": w.t(), "step": 1}
    mgr.save(1, state, asynchronous=True)
    state["host"][:] = 99.0
    w.add_(5.0)
    mgr.wait_until_finished()
    out = mgr.restore(1)
    np.testing.assert_array_equal(out["host"], np.ones(4))
    np.testing.assert_array_equal(out["w"], np.ones((4, 3), np.float32))
    np.testing.assert_array_equal(out["view"], np.ones((3, 4), np.float32))


def test_async_failure_raises_at_fence(tmp_path):
    mgr = ck.CheckpointManager(str(tmp_path / "ck"))
    mgr.save(1, _state(1))
    mgr.save(1, _state(2), asynchronous=True)   # exists, no force
    with pytest.raises((FileExistsError, RuntimeError)):
        mgr.wait_until_finished()
    assert mgr.restore(1)["step"] == 1          # usable, original intact


def test_resume_reproduces_uninterrupted_run(tmp_path):
    """Params after [train 10] equal params after [train 6, async save,
    restore into a fresh model and state, train 4], bit for bit."""
    from horovod_tpu_torch.models import MLP

    r = np.random.RandomState(1)
    xs = [torch.from_numpy(r.randn(4, 8).astype(np.float32))
          for _ in range(10)]

    def fresh():
        m = MLP((16, 4), in_features=8, seed=3)
        tx = hvd.adam(0.01)
        return m, tx, tx.init(m.jax_params())

    def step(m, tx, st, x):
        for p in m.parameters():
            p.grad = None
        loss = ((torch.tanh(m(x)) - 0.1) ** 2).mean()
        loss.backward()
        with torch.no_grad():
            ups, st = tx.update(m.jax_grads(), st, m.jax_params())
            for k, u in ups.items():
                m.jax_params()[k].add_(u)
        return st

    m, tx, st = fresh()
    for x in xs:
        st = step(m, tx, st, x)
    want = {k: v.detach().clone() for k, v in m.jax_params().items()}

    mgr = ck.CheckpointManager(str(tmp_path / "ck"))
    m, tx, st = fresh()
    for x in xs[:6]:
        st = step(m, tx, st, x)
    mgr.save(6, {"params": m.jax_params(), "opt": st}, asynchronous=True)
    del m, st                                   # "preemption"
    restored = mgr.restore()
    m, tx, _ = fresh()
    load_flax_variables(m, restored["params"])
    st = ck.consolidate_opt_state(restored["opt"], m.jax_params())
    assert st["count"] == 6
    for x in xs[6:]:
        st = step(m, tx, st, x)
    for k, v in m.jax_params().items():
        assert torch.equal(v, want[k]), k


# --------------------------------------------------------------------------
# the validity sweep


def _corrupt(d, step, how):
    npz = os.path.join(d, f"step_{step}", "arrays.npz")
    if how == "truncated":
        with open(npz, "r+b") as f:
            f.truncate(os.path.getsize(npz) // 2)
    elif how == "flipped_byte":             # a byte in the middle of a member
        with zipfile.ZipFile(npz) as zf:
            info = zf.infolist()[0]
        with open(npz, "r+b") as f:
            f.seek(info.header_offset + 26)
            name_len, extra_len = np.frombuffer(f.read(4), "<u2")
            off = (info.header_offset + 30 + int(name_len) + int(extra_len)
                   + info.file_size // 2)
            f.seek(off)
            b = f.read(1)
            f.seek(off)
            f.write(bytes([b[0] ^ 0xFF]))
    elif how == "nan_leaf":
        with np.load(npz) as z:
            arrays = {k: z[k] for k in z.files}
        k = next(k for k, v in arrays.items() if v.dtype == np.float32)
        arrays[k] = arrays[k].copy()
        arrays[k].reshape(-1)[0] = np.nan
        np.savez(npz, **arrays)


@pytest.mark.parametrize("how,reason", [("truncated", "corrupt"),
                                        ("flipped_byte", "corrupt"),
                                        ("nan_leaf", "nonfinite")])
def test_invalid_checkpoints_are_skipped(tmp_path, how, reason):
    d = str(tmp_path / "ck")
    big = {"w": torch.arange(1000.0), "step": 1}
    ck.save(d, 1, big)
    ck.save(d, 2, big)
    _corrupt(d, 2, how)
    assert ck._checkpoint_invalid_reason(os.path.join(d, "step_2")) == reason
    assert not ck.is_valid_checkpoint(os.path.join(d, "step_2"))
    assert ck.latest_step(d) == 1
    assert ck.valid_steps(d) == [1]
    # the JAX package's sweep agrees on the same files
    assert jck.latest_step(d) == 1


def test_all_nonfinite_warns_and_the_opt_out_accepts_them(tmp_path, caplog,
                                                          monkeypatch):
    d = str(tmp_path / "ck")
    ck.save(d, 1, {"w": torch.tensor([1.0, float("inf")])})
    with caplog.at_level(logging.ERROR, logger="horovod_tpu_torch.checkpoint"):
        assert ck.latest_step(d) is None
    assert "HOROVOD_CHECKPOINT_FINITE_CHECK" in caplog.text
    monkeypatch.setenv("HOROVOD_CHECKPOINT_FINITE_CHECK", "0")
    assert ck.latest_step(d) == 1
    _corrupt(d, 1, "flipped_byte")               # the CRC check still runs
    assert ck.latest_step(d) is None


def test_data_cursors_ride_the_payload(tmp_path):
    from horovod_tpu_torch.data import sampler

    class Loader:
        name = "train"
        cursor = {"epoch": 2, "step": 11}

        def state(self):
            return dict(self.cursor)

        def restore(self, c):
            self.cursor = dict(c)

    sampler.reset()
    try:
        loader = Loader()
        sampler.register(loader)
        ck.save(str(tmp_path), 1, ck.attach_data_state({"w": torch.ones(2)}))
        sampler.reset()
        payload = ck.detach_data_state(ck.restore(str(tmp_path), 1))
        assert set(payload) == {"w"}
        fresh = Loader()
        fresh.cursor = {}
        sampler.register(fresh)                  # the pending cursor lands
        assert fresh.cursor == {"epoch": 2, "step": 11}
        assert ck.attach_data_state({"a": 1}, cursors={}) == {"a": 1}
    finally:
        sampler.reset()


# --------------------------------------------------------------------------
# both directions against the JAX package


def _jax_tree():
    """Dicts, lists, tuples, None, an optax Adam state, an _EFState,
    int/float/str leaves, f32, int32 and bf16 arrays."""
    r = np.random.RandomState(0)
    params = {"dense": {"kernel": r.randn(4, 3).astype(np.float32),
                        "bias": r.randn(3).astype(np.float32)},
              "emb": np.asarray(jnp.asarray(r.randn(5, 2), jnp.bfloat16))}
    adam = optax.adam(1e-3).init(params)
    adam = jax.tree_util.tree_map(np.asarray, adam)
    return {"params": params,
            "opt": _EFState(adam, {"float32": r.randn(2, 8).astype(np.float32)}),
            "ids": np.arange(6, dtype=np.int32),
            "scalar": np.float32(2.5),
            "step": 12, "lr": 1e-3, "name": "run-a",
            "nested": [(1, None), {"z": None, "a": [2.0, "s"]}], "none": None}


def _assert_same(a, b, path="state"):
    """Same structure, types and leaves, bit for bit (NaN meets NaN)."""
    assert type(a).__name__ == type(b).__name__, path
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        for k in a:
            _assert_same(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        if hasattr(a, "_fields"):
            assert a._fields == b._fields, path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert a.tobytes() == b.tobytes(), path
    else:
        assert a == b, path


def _files(d, step):
    p = os.path.join(d, f"step_{step}")
    with open(os.path.join(p, "tree.pkl"), "rb") as f:
        tree = f.read()
    with zipfile.ZipFile(os.path.join(p, "arrays.npz")) as zf:
        members = {n: zf.read(n) for n in zf.namelist()}
    return tree, members


def test_port_restores_what_jax_wrote(tmp_path):
    d = str(tmp_path / "jax")
    want = _jax_tree()
    jck.save(d, 3, want)
    got = ck.restore(d, 3)
    ref = jck.restore(d, 3)
    _assert_same(got, ref)
    assert got["params"]["emb"].dtype == np.dtype("|V2")   # as the reference
    bf16 = host_tensor(got["params"]["emb"])
    assert torch.equal(bf16.float(), torch.from_numpy(
        np.asarray(want["params"]["emb"], np.float32)))
    assert got["opt"].inner[0].count.dtype == np.int32
    np.testing.assert_array_equal(got["opt"].inner[0].mu["dense"]["kernel"],
                                  want["opt"].inner[0].mu["dense"]["kernel"])
    assert ck.latest_step(d) == 3 and ck.is_valid_checkpoint(
        os.path.join(d, "step_3"))


def test_jax_restores_what_the_port_wrote_byte_for_byte(tmp_path):
    """The port re-saves the tree it restored (stand-in namedtuples and
    all): the JAX package restores it, validates it, and the two steps'
    files are the same bytes."""
    dj, dp = str(tmp_path / "jax"), str(tmp_path / "port")
    jck.save(dj, 3, _jax_tree())
    ck.save(dp, 3, ck.restore(dj, 3))
    assert _files(dp, 3) == _files(dj, 3)
    assert jck.latest_step(dp) == 3
    assert jck.is_valid_checkpoint(os.path.join(dp, "step_3"))
    _assert_same(jax.tree_util.tree_map(np.asarray, jck.restore(dp, 3)),
                 jax.tree_util.tree_map(np.asarray, jck.restore(dj, 3)))


def test_jax_restores_port_tensors(tmp_path):
    """A tree of the port's own (tensors, a bf16 one and a view among
    them) written by the port: the JAX package reads the same values, and
    the bf16 leaf as the |V2 bits of the same bf16 numbers."""
    d = str(tmp_path / "port")
    st = W.ckpt_state()
    ck.save(d, 1, st)
    out = jck.restore(d, 1)
    assert ck.state_nbytes(ck.restore(d, 1)) == ck.state_nbytes(
        host_snapshot(st)) == 6 * 4 + 3 * 2 + 5 * 4 + 4 * 4
    np.testing.assert_array_equal(out["params"]["w"], st["params"]["w"])
    assert out["params"]["h"].dtype == np.dtype("|V2")
    assert torch.equal(host_tensor(out["params"]["h"]), st["params"]["h"])
    np.testing.assert_array_equal(out["ids"], st["ids"].numpy())
    assert out["step"] == 7 and out["meta"] == ("adam", None, [0.1])
    assert jck.latest_step(d) == 1


def test_unknown_jax_class_raises_and_names_it(tmp_path):
    import pickle

    from horovod_tpu_torch import pytree

    d = str(tmp_path / "ck")
    jck.save(d, 1, {"w": np.ones(2)})
    path = os.path.join(d, "step_1", "tree.pkl")
    with open(path, "rb") as f:
        blob = pickle.load(f)
    blob["meta"][0] = ("obj", jnp.float32)       # a JAX class as a leaf
    with open(path, "wb") as f:
        pickle.dump(blob, f)
    with pytest.raises(pickle.UnpicklingError, match="jax"):
        with open(path, "rb") as f:
            pytree.load(f)


# --------------------------------------------------------------------------
# gloo worlds


@pytest.mark.parametrize("n", [2, 4])
def test_restore_reads_only_the_roots_directory(tmp_path, n):
    outs = run_world(W.ckpt_root_worker, n, str(tmp_path))
    want = host_snapshot(W.ckpt_state(0))
    for r, out in enumerate(outs):
        assert out["others_empty"], r
        _assert_same(out["restored"], want, f"rank{r}")


def test_a_writer_failure_raises_on_every_rank(tmp_path):
    outs = run_world(W.ckpt_writer_failure_worker, 2, str(tmp_path))
    assert outs[0] == ["FileExistsError"] * 2
    assert outs[1] == ["RuntimeError"] * 2


def _jax_zero1(n, params, seed):
    """A JAX package ZeRO-1 + EF Adam state of ``n`` ranks, as its
    ``DistributedOptimizer(shard_optimizer=True, error_feedback=True)``
    lays it out (per-dtype ``[N, s]`` rows, ``count`` ``[N]``), with
    values in every element, the padding included."""
    r = np.random.RandomState(seed)
    L = sum(v.size for v in params.values())
    Lp = L + (-L) % n
    rows = lambda w: r.randn(n, w).astype(np.float32)  # noqa: E731
    adam = optax.ScaleByAdamState(count=np.full(n, 3, np.int32),
                                  mu={"float32": rows(Lp // n)},
                                  nu={"float32": np.abs(rows(Lp // n))})
    return _EFState((adam, optax.EmptyState()), {"float32": rows(Lp)})


@pytest.fixture(scope="module")
def zero1_worlds(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("zero1"))
    r = np.random.RandomState(1)
    params = {"a/kernel": r.randn(300, 5).astype(np.float32),
              "a/bias": r.randn(7).astype(np.float32),
              "b": r.randn(33, 3).astype(np.float32),
              "c": r.randn(2).astype(np.float32)}            # L = 1608 + 1
    params["d"] = r.randn(1).astype(np.float32)              # L % 4 == 1
    jstate = _jax_zero1(4, params, seed=2)
    adam = jstate.inner[0]
    saved = run_world(W.zero1_save_worker, 4, base, adam.count, adam.mu,
                      adam.nu, jstate.residual, params)
    restored = run_world(W.zero1_restore_worker, 2, base, params)
    nested = {}
    for k, v in params.items():          # the JAX package's nested tree
        node = nested
        *parents, leaf = k.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    want = jreshard(jstate, nested, to_size=2)
    return base, params, jstate, saved, restored, want


def test_zero1_save_gathers_the_rows(zero1_worlds):
    base, params, jstate, saved, _, _ = zero1_worlds
    tree = ck.restore(base, 5)
    opt = tree["opt"]
    assert opt["shard"] == {"size": 4} and tree["step"] == 5
    adam = jstate.inner[0]
    _assert_same(opt["inner"]["count"], adam.count)
    _assert_same(opt["inner"]["mu"], adam.mu)
    _assert_same(opt["inner"]["nu"], adam.nu)
    _assert_same(opt["residual"], jstate.residual)
    for r, out in enumerate(saved):      # the same size: what each rank held
        _assert_same(out["back"], out["held"], f"rank{r}")
        assert out["back"]["shard"] == {"rank": r, "size": 4}


def test_zero1_world4_to_world2_matches_jax_reshard(zero1_worlds):
    """Bit for bit against the JAX package's ``reshard_optimizer_state``:
    the rows re-packed for 2 ranks, ``count`` re-tiled from row 0 and the
    EF residual's mass (the sum over the 4 old rows) spread evenly."""
    base, params, _, _, restored, want = zero1_worlds
    wadam = want.inner[0]
    got = reshard_optimizer_state(ck.restore(base, 5)["opt"], params,
                                  to_size=2)
    _assert_same(got["inner"]["count"], np.asarray(wadam.count))
    _assert_same(got["inner"]["mu"], jax.tree_util.tree_map(np.asarray,
                                                            wadam.mu))
    _assert_same(got["inner"]["nu"], jax.tree_util.tree_map(np.asarray,
                                                            wadam.nu))
    _assert_same(got["residual"], jax.tree_util.tree_map(np.asarray,
                                                         want.residual))
    L = sum(v.size for v in params.values())
    res = np.asarray(want.residual["float32"])
    assert res.shape == (2, L + L % 2) and np.array_equal(res[0], res[1])
    for r, out in enumerate(restored):   # each rank of the world of 2
        assert out["shard"] == {"rank": r, "size": 2}
        assert out["inner"]["count"] == int(wadam.count[r])
        np.testing.assert_array_equal(out["inner"]["mu"]["float32"],
                                      np.asarray(wadam.mu["float32"])[r])
        np.testing.assert_array_equal(out["inner"]["nu"]["float32"],
                                      np.asarray(wadam.nu["float32"])[r])
        np.testing.assert_array_equal(out["residual"]["float32"], res[r])


def test_consolidate_reads_a_jax_written_zero1_state(zero1_worlds, tmp_path):
    """The JAX package's own ZeRO-1 checkpoint, restored in the port and
    consolidated to one rank, equals its ``reshard_optimizer_state``'s
    row 0."""
    _, params, jstate, _, _, _ = zero1_worlds
    jck.save(str(tmp_path), 1, {"opt": jstate})
    nested = {"a": {"kernel": params["a/kernel"], "bias": params["a/bias"]},
              "b": params["b"], "c": params["c"], "d": params["d"]}
    want = jreshard(jstate, nested, to_size=1)
    got = ck.consolidate_opt_state(ck.restore(str(tmp_path), 1)["opt"],
                                   {k: torch.from_numpy(v)
                                    for k, v in params.items()}, to_size=1)
    assert got["inner"]["count"] == 3
    np.testing.assert_array_equal(got["inner"]["mu"]["float32"].numpy(),
                                  np.asarray(want.inner[0].mu["float32"])[0])
    np.testing.assert_array_equal(got["residual"]["float32"].numpy(),
                                  np.asarray(want.residual["float32"])[0])


def test_what_is_not_ported_raises():
    """What the port still lacks raises where met; a bucketed (``dtype#k``)
    ZeRO-1 state, a ``NumericsGuardState`` and a ZeRO-3 tree and state
    at another world size, which used to, are now re-packed (the guard's around a bucketed ZeRO-1 state of 2 ranks,
    consolidated to one: its ``inner`` this rank's row, its scalars kept,
    ``rank_norms`` zeros at the new size)."""
    params = {"w": torch.zeros(10)}
    rows = {"shard": {"size": 2}, "inner": {"count": np.full(2, 1, np.int32),
                                           "mu": {"float32#0": np.zeros((2, 5),
                                                                        np.float32)}}}
    out = reshard_optimizer_state(rows, params, to_size=1)
    assert out["inner"]["mu"]["float32#0"].shape == (1, 10)
    from horovod_tpu_torch import pytree
    from horovod_tpu_torch.resilience import numerics as tnum

    guard = pytree._stand_in("horovod_tpu.resilience.numerics",
                             "NumericsGuardState",
                             pytree._NAMEDTUPLE_FIELDS[
                                 ("horovod_tpu", "NumericsGuardState")])
    assert guard is tnum.NumericsGuardState
    scalars = dict(ewma=np.float32(0.5), count=np.int32(3),
                   bad_count=np.int32(1), bad_streak=np.int32(0),
                   last_bad=np.int32(0), last_finite=np.int32(1),
                   last_norm=np.float32(0.25),
                   norms={"float32": np.float32(0.25)},
                   loss_scale=np.float32(4.0), good_streak=np.int32(1),
                   chaos_fired=np.int32(0),
                   rank_norms=np.array([0.2, 0.3], np.float32))
    state = guard(inner=rows, **scalars)
    out = ck.consolidate_opt_state(state, params, to_size=1)
    assert isinstance(out, tnum.NumericsGuardState)
    assert out.inner["shard"] == {"rank": 0, "size": 1}
    assert tuple(out.inner["inner"]["mu"]["float32#0"].shape) == (10,)
    assert tnum.verdict(out)["rank_norms"] == [0.0]
    for f in ("ewma", "count", "bad_count", "loss_scale", "last_norm"):
        assert getattr(out, f).item() == scalars[f].item(), f
    # a ZeRO-3 tree of 4 ranks, which used to raise at another size, is
    # re-packed for 2 (fsdp_reshard_params): rank 0 gets w[:5]
    w = np.arange(10, dtype=np.float32)
    saved = {ck.FSDP_ROWS: {"float32": np.concatenate(
                 [w, np.zeros(2, np.float32)]).reshape(4, 3)},
             "keys": ["w"], "shapes": [[10]], "dtypes": ["float32"]}
    fp = ck.fsdp_params(saved, to_size=2)
    assert (fp.meta.rank, fp.meta.size) == (0, 2)
    np.testing.assert_array_equal(fp.shards["float32"].numpy(), w[:5])
    zero3 = {"shard": {"size": 4}, "inner": {
        "count": np.full(4, 1, np.int32),
        "mu": {"float32": saved[ck.FSDP_ROWS]["float32"]}}}
    st = ck.consolidate_opt_state(zero3, saved, to_size=2)
    assert st["shard"] == {"rank": 0, "size": 2}
    np.testing.assert_array_equal(st["inner"]["mu"]["float32"].numpy(),
                                  w[:5])


def test_fsdp_params_roundtrip_at_the_same_size(tmp_path):
    """ZeRO-3 parameters saved by a world of one come back as the same
    shards and metadata."""
    hvd.init(device="cpu")
    try:
        params = {"a": torch.randn(5, 3), "b": torch.randn(4)}
        fp = hvd.fsdp_pack_params(params)
        tx = hvd.DistributedOptimizer(hvd.adam(1e-3), shard_params=True)
        st = tx.init(fp)
        ck.save(str(tmp_path), 1, {"params": fp, "opt": st})
        tree = ck.restore(str(tmp_path), 1)
        back = ck.fsdp_params(tree["params"])
        assert back.meta == fp.meta
        for k, v in fp.shards.items():
            assert torch.equal(back.shards[k], v)
        st2 = ck.consolidate_opt_state(tree["opt"], tree["params"])
        assert st2["shard"] == st["shard"]
        assert st2["inner"]["count"] == 0
        assert torch.equal(st2["inner"]["mu"]["float32"],
                           st["inner"]["mu"]["float32"])
    finally:
        hvd.shutdown()


@pytest.mark.parametrize("to_size", [1, 3, 8])
def test_reshard_matches_jax_with_bf16_and_f32_groups(to_size):
    """Two groups, one of them bf16 (``|V2`` on the host, as restored):
    every array bit-equal to the JAX package's re-pack, the bf16
    residual's sum and divide rounded as XLA rounds them."""
    r = np.random.RandomState(to_size)
    bf = lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16))  # noqa: E731
    v2 = lambda a: (np.asarray(a).view(np.int16).view("V2")  # noqa: E731
                    if np.asarray(a).dtype.name == "bfloat16"
                    else np.asarray(a))
    n = 4
    params = {"a": bf(r.randn(301)), "b": r.randn(10).astype(np.float32)}
    rows = {"bfloat16": lambda w: bf(r.randn(n, w) * 3),
            "float32": lambda w: r.randn(n, w).astype(np.float32)}
    adam = optax.ScaleByAdamState(
        count=np.full(n, 2, np.int32),
        mu={"bfloat16": rows["bfloat16"](76), "float32": rows["float32"](3)},
        nu={"bfloat16": rows["bfloat16"](76), "float32": rows["float32"](3)})
    jstate = _EFState((adam, optax.EmptyState()),
                      {"bfloat16": rows["bfloat16"](304),
                       "float32": rows["float32"](12)})
    want = jreshard(jstate, params, to_size=to_size)
    port = {"shard": {"size": n},
            "inner": {"count": adam.count,
                      "mu": {k: v2(v) for k, v in adam.mu.items()},
                      "nu": {k: v2(v) for k, v in adam.nu.items()}},
            "residual": {k: v2(v) for k, v in jstate.residual.items()}}
    got = reshard_optimizer_state(port, {k: v2(v) for k, v in params.items()},
                                  to_size=to_size)
    assert got["shard"] == {"size": to_size}
    _assert_same(got["inner"]["count"], np.asarray(want.inner[0].count))
    for part, w in (("mu", want.inner[0].mu), ("nu", want.inner[0].nu),
                    ("residual", want.residual)):
        tree = got[part] if part == "residual" else got["inner"][part]
        _assert_same(tree, {k: v2(v) for k, v in w.items()}, part)


# --------------------------------------------------------------------------
# the state kinds of bucketed overlap, PowerSGD and backward_passes_per_step


def _jax_run(tx, p, grads, n=1, shard=False, state=None):
    """``tx``'s state and parameters after steps of ``grads`` (the same on
    every rank) in a bound-axis step on an ``n``-device mesh."""
    from jax.sharding import PartitionSpec as P

    from horovod_tpu.ops.collective import _smap

    jhvd.init(devices=jax.devices()[:n])
    try:
        mesh, ax = jhvd.mesh(), jhvd.data_axis()
        s = tx.init(p) if state is None else state
        spec = P(ax) if shard else P()

        def step(pp, ss, gg):
            u, ss = tx.update(gg, ss, pp)
            return optax.apply_updates(pp, u), ss

        f = jax.jit(_smap(step, mesh, (P(), spec, P()), (P(), spec)))
        for g in grads:
            p, s = f(p, s, g)
        return (jax.tree_util.tree_map(np.asarray, p),
                jax.tree_util.tree_map(np.asarray, s))
    finally:
        jhvd.shutdown()


def _port_run(tx, params, state, grads):
    params = {k: torch.from_numpy(np.array(v)) for k, v in params.items()}
    for g in grads:
        u, state = tx.update({k: torch.from_numpy(np.array(v))
                              for k, v in g.items()}, state, params)
        params = {k: params[k] + u[k] for k in params}
    return {k: v.numpy() for k, v in params.items()}, state


def _flat_grads(r, params, scale=1.0):
    return {k: (r.randn(*v.shape) * scale).astype(np.float32)
            for k, v in params.items()}


@pytest.fixture()
def world_of_one(monkeypatch):
    for k in ("HOROVOD_RANK", "HOROVOD_SIZE", "RANK", "WORLD_SIZE",
              "HOROVOD_BUCKET_BYTES", "HOROVOD_OVERLAP"):
        monkeypatch.delenv(k, raising=False)
    hvd.init(device="cpu")
    yield
    hvd.shutdown()


#: jitted optax Adam contracts into FMAs, the port's rounds each operation
#: (tests/test_torch_optim.py's per-step Adam bar)
ADAM_RTOL, ADAM_ATOL = 1e-6, 1e-7


def test_jax_bucketed_zero1_state_restores_and_continues(tmp_path,
                                                         world_of_one):
    """ZeRO-1 + fp16 + EF + overlap (4096-byte buckets) trained by the JAX
    package at N = 2 and saved; the port restores it into a world of one
    (``consolidate_opt_state(..., bucket_bytes=)``: re-packed 2 -> 1) and
    continues 2 steps as the JAX package continues from its own
    ``reshard_optimizer_state`` at N = 1."""
    r = np.random.RandomState(11)
    params = {"b": np.zeros(33, np.float32),
              "w": (r.randn(64, 33) * 0.1).astype(np.float32)}
    kw = dict(compression=jhvd.Compression.fp16, error_feedback=True,
              shard_optimizer=True, overlap=True, bucket_bytes=4096)
    p2, s2 = _jax_run(jhvd.DistributedOptimizer(optax.adam(1e-2), **kw),
                      params, [_flat_grads(r, params) for _ in range(2)],
                      n=2, shard=True)
    assert len(s2.residual) >= 2 and all("#" in k for k in s2.residual)
    jck.save(str(tmp_path), 2, {"params": p2, "opt": s2})
    tree = ck.restore(str(tmp_path), 2)
    st = ck.consolidate_opt_state(tree["opt"], tree["params"],
                                  bucket_bytes=4096)
    assert st["shard"] == {"rank": 0, "size": 1}
    assert sorted(st["residual"]) == sorted(s2.residual)
    more = [_flat_grads(r, params) for _ in range(2)]
    s1 = jreshard(s2, p2, to_size=1, bucket_bytes=4096)
    pj, sj = _jax_run(jhvd.DistributedOptimizer(optax.adam(1e-2), **kw), p2,
                      more, n=1, shard=True, state=s1)
    tx = hvd.DistributedOptimizer(hvd.adam(1e-2), compression=hvd.Compression.fp16,
                                  error_feedback=True, shard_optimizer=True,
                                  bucket_bytes=4096)
    pp, sp = _port_run(tx, tree["params"], st, more)
    for k in params:
        np.testing.assert_allclose(pp[k], pj[k], rtol=ADAM_RTOL,
                                   atol=ADAM_ATOL)
    for k, v in sj.residual.items():
        np.testing.assert_allclose(sp["residual"][k].numpy(), v[0],
                                   rtol=ADAM_RTOL, atol=ADAM_ATOL)
    assert sp["inner"]["count"] == int(sj.inner[0].count[0]) == 4


def test_jax_powersgd_state_restores_and_continues(tmp_path, world_of_one):
    """A ``_PowerSGDState`` (allreduce mode) the JAX package wrote after 2
    steps: the port restores it (``Q`` and all) and continues 2 steps as
    the JAX package continues, within the PowerSGD bar (rtol 1e-4 /
    atol 1e-5)."""
    from horovod_tpu.optim import _PowerSGDState

    r = np.random.RandomState(12)
    params = {"dense": {"kernel": (r.randn(64, 48) * 0.1).astype(np.float32),
                        "bias": np.zeros(48, np.float32)}}
    flat = {"dense/kernel": params["dense"]["kernel"],
            "dense/bias": params["dense"]["bias"]}
    jtx = jhvd.DistributedOptimizer(optax.adam(1e-2),
                                    compression=jhvd.Compression.powersgd(2),
                                    error_feedback=True)
    nested = lambda g: {"dense": {"kernel": g["dense/kernel"],  # noqa: E731
                                  "bias": g["dense/bias"]}}
    grads = [_flat_grads(r, flat) for _ in range(4)]
    pj2, sj2 = _jax_run(jtx, params, [nested(g) for g in grads[:2]])
    assert isinstance(sj2, _PowerSGDState)
    jck.save(str(tmp_path), 2, {"params": pj2, "opt": sj2})
    tree = ck.restore(str(tmp_path), 2)
    st = ck.consolidate_opt_state(tree["opt"], tree["params"])
    assert set(st) == {"inner", "residual", "q"} and st["inner"]["count"] == 2
    assert st["q"]["dense/bias"] is None and tuple(
        st["q"]["dense/kernel"].shape) == (48, 2)
    pj, sj = _jax_run(jtx, pj2, [nested(g) for g in grads[2:]], state=sj2)
    tx = hvd.DistributedOptimizer(hvd.adam(1e-2),
                                  compression=hvd.Compression.powersgd(2),
                                  error_feedback=True)
    from horovod_tpu_torch.models.convert import flatten_tree

    pp, sp = _port_run(tx, flatten_tree(tree["params"]), st, grads[2:])
    for k, v in flatten_tree(pj).items():
        np.testing.assert_allclose(pp[k], v, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(sp["q"]["dense/kernel"].numpy(),
                               sj.q["dense"]["kernel"], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("inner", ["identity", "int8_ef"])
def test_jax_multisteps_state_restores_and_continues(tmp_path, world_of_one,
                                                     inner):
    """optax's ``MultiStepsState`` (k = 3) the JAX package wrote in the
    middle of an accumulation: the port restores it and continues 4
    steps bit for bit as the JAX package continues (inner identity, with
    int8 + EF or without)."""
    r = np.random.RandomState(13)
    params = {"w": (r.randn(40, 30) * 0.1).astype(np.float32),
              "e": r.randn(1500).astype(np.float32)}
    kw = ({} if inner == "identity" else
          dict(compression=jhvd.Compression.int8, error_feedback=True))
    jtx = jhvd.DistributedOptimizer(optax.identity(),
                                    backward_passes_per_step=3, **kw)
    grads = [_flat_grads(r, params, 1e-2) for _ in range(6)]
    pj2, sj2 = _jax_run(jtx, params, grads[:2])
    assert type(sj2).__name__ == "MultiStepsState" and int(sj2.mini_step) == 2
    jck.save(str(tmp_path), 2, {"params": pj2, "opt": sj2})
    tree = ck.restore(str(tmp_path), 2)
    st = ck.consolidate_opt_state(tree["opt"], tree["params"])
    assert type(st).__name__ == "MultiStepsState" and int(st.mini_step) == 2
    pj, sj = _jax_run(jtx, pj2, grads[2:], state=sj2)
    tkw = ({} if inner == "identity" else
           dict(compression=hvd.Compression.int8, error_feedback=True))
    tx = hvd.DistributedOptimizer(W._identity(), backward_passes_per_step=3,
                                  **tkw)
    pp, sp = _port_run(tx, tree["params"], st, grads[2:])
    for k in params:
        assert np.array_equal(pp[k], pj[k]), k
        assert np.array_equal(sp.acc_grads[k].numpy(), sj.acc_grads[k]), k
    assert (int(sp.mini_step), int(sp.gradient_step)) == (
        int(sj.mini_step), int(sj.gradient_step)) == (0, 2)
    if inner != "identity":
        for k, v in sj.inner_opt_state.residual.items():
            assert np.array_equal(sp.inner_opt_state["residual"][k].numpy(), v)


def test_the_ports_new_states_restore_in_jax(tmp_path, world_of_one):
    """The port saves a MultiSteps-wrapped PowerSGD state and a bucketed
    ZeRO-1 state; the JAX package restores the files, optax's own
    ``MultiStepsState`` among them, with the port's values."""
    r = np.random.RandomState(14)
    params = {"w": torch.from_numpy((r.randn(64, 48) * 0.1).astype(
        np.float32)), "b": torch.zeros(48)}
    psgd = hvd.DistributedOptimizer(hvd.adam(1e-2),
                                    compression=hvd.Compression.powersgd(2),
                                    error_feedback=True,
                                    backward_passes_per_step=2)
    zero1 = hvd.DistributedOptimizer(hvd.adam(1e-2), shard_optimizer=True,
                                     compression=hvd.Compression.int8,
                                     error_feedback=True, bucket_bytes=4096)
    states = {}
    for name, tx in (("psgd", psgd), ("zero1", zero1)):
        _, states[name] = _port_run(
            tx, {k: v.numpy() for k, v in params.items()}, tx.init(params),
            [_flat_grads(r, params) for _ in range(3)])
    ck.save(str(tmp_path), 3, states)
    back = jck.restore(str(tmp_path), 3)
    ms = back["psgd"]
    assert isinstance(ms, optax.MultiStepsState)
    assert (int(ms.mini_step), int(ms.gradient_step)) == (1, 1)
    np.testing.assert_array_equal(ms.acc_grads["w"],
                                  states["psgd"].acc_grads["w"].numpy())
    np.testing.assert_array_equal(
        ms.inner_opt_state["q"]["w"],
        states["psgd"].inner_opt_state["q"]["w"].numpy())
    assert ms.inner_opt_state["q"]["b"] is None
    z = back["zero1"]
    assert z["shard"] == {"size": 1} and len(z["residual"]) >= 2
    for k, v in states["zero1"]["residual"].items():
        np.testing.assert_array_equal(z["residual"][k][0], v.numpy())
        np.testing.assert_array_equal(z["inner"]["mu"][k][0],
                                      states["zero1"]["inner"]["mu"][k].numpy())


# --------------------------------------------------------------------------
# the numerics guard's state (NumericsGuardState) in both directions


def _jax_guarded_zero1(n, params, grads):
    """A guarded ZeRO-1 + int8 + EF Adam state (``loss_scale=8.0``) after
    ``grads`` (the same on every rank) on an ``n``-device mesh, the
    guard's scalars replicated (``numerics.shard_state_spec``)."""
    from jax.sharding import PartitionSpec as P

    from horovod_tpu.ops.collective import _smap
    from horovod_tpu.resilience import numerics as jnum

    jhvd.init(devices=jax.devices()[:n])
    try:
        mesh, ax = jhvd.mesh(), jhvd.data_axis()
        tx = jhvd.DistributedOptimizer(
            optax.adam(1e-2), shard_optimizer=True,
            compression=jhvd.Compression.int8, error_feedback=True,
            numerics_guard=True, loss_scale=8.0)
        p = {k: jnp.asarray(v) for k, v in params.items()}
        s = tx.init(p)
        spec = jnum.shard_state_spec(P(ax))

        def step(pp, ss, gg):
            u, ss = tx.update(gg, ss, pp)
            return optax.apply_updates(pp, u), ss

        f = jax.jit(_smap(step, mesh, (P(), spec, P()), (P(), spec)))
        for g in grads:
            p, s = f(p, s, {k: jnp.asarray(v) for k, v in g.items()})
        return jax.tree_util.tree_map(np.asarray, s)
    finally:
        jhvd.shutdown()


def _guard_inputs():
    r = np.random.RandomState(15)
    params = {"w": (r.randn(40, 30) * 0.1).astype(np.float32),
              "e": (r.randn(1500) * 0.1).astype(np.float32)}
    grads = [_flat_grads(r, params, 8.0) for _ in range(3)]
    grads[1]["w"][3, 4] = np.nan        # the second step is BAD
    return params, grads


def _assert_guard_scalars(got, want):
    """Every scalar field of two NumericsGuardStates bit-equal (host
    arrays or tensors), ``inner`` and ``rank_norms`` aside."""
    for f in got._fields:
        if f in ("inner", "rank_norms"):
            continue
        a, b = getattr(got, f), getattr(want, f)
        if f == "norms":
            assert set(a) == set(b)
            for k in b:
                _assert_same(_np_any(a[k]), np.asarray(b[k]), f)
        else:
            _assert_same(_np_any(a), np.asarray(b), f)


def _np_any(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def test_guard_state_restores_across_the_packages(tmp_path, world_of_one):
    """A guarded ZeRO-1 state the JAX package wrote at N = 2 (a BAD step
    among its three, the scale backed off to 4) restores in the port and
    consolidates to a world of one: the verdict and the scalars are the
    JAX package's ``reshard_optimizer_state``'s, the inner rows too, bit
    for bit; it continues as a guarded state. The port's own guarded
    state, saved, restores in the JAX package as its
    ``NumericsGuardState``, whose verdict is the port's."""
    from horovod_tpu.resilience import numerics as jnum
    from horovod_tpu_torch.resilience import numerics as tnum

    params, grads = _guard_inputs()
    jst = _jax_guarded_zero1(2, params, grads)
    assert jnum.verdict(jst)["bad_count"] == 1
    jck.save(str(tmp_path / "jax"), 3, {"opt": jst})
    want = jreshard(jst, params, to_size=1)
    tree = ck.restore(str(tmp_path / "jax"), 3)
    assert type(tree["opt"]).__name__ == "NumericsGuardState"
    tparams = {k: torch.from_numpy(v) for k, v in params.items()}
    st = ck.consolidate_opt_state(tree["opt"], tparams, to_size=1)
    assert isinstance(st, tnum.NumericsGuardState)
    assert tnum.verdict(st) == jnum.verdict(want)
    _assert_guard_scalars(st, want)
    assert st.inner["shard"] == {"rank": 0, "size": 1}
    assert int(st.inner["inner"]["count"]) == int(want.inner.inner[0].count[0])
    for part, w in (("mu", want.inner.inner[0].mu),
                    ("nu", want.inner.inner[0].nu)):
        _assert_same(st.inner["inner"][part]["float32"].numpy(),
                     np.asarray(w["float32"])[0], part)
    _assert_same(st.inner["residual"]["float32"].numpy(),
                 np.asarray(want.inner.residual["float32"])[0], "residual")
    tx = hvd.DistributedOptimizer(hvd.adam(1e-2), shard_optimizer=True,
                                  compression=hvd.Compression.int8,
                                  error_feedback=True, loss_scale=8.0)
    _, st2 = _port_run(tx, params, st, grads[:1])
    assert tnum.verdict(st2)["count"] == 4
    # the port's guarded state (continued one step) into the JAX package
    ck.save(str(tmp_path / "port"), 4, {"opt": st2})
    back = jck.restore(str(tmp_path / "port"), 4)["opt"]
    assert isinstance(back, jnum.NumericsGuardState)
    assert jnum.verdict(back) == tnum.verdict(st2)
    np.testing.assert_array_equal(
        back.inner["inner"]["mu"]["float32"][0],
        st2.inner["inner"]["mu"]["float32"].numpy())


def test_guard_state_reshard_2_1_2_keeps_the_scalars(tmp_path):
    """``reshard_optimizer_state`` 2 -> 1 -> 2 of the JAX package's
    guarded ZeRO-1 state as the port restores it (``tests/test_zero.py``'s
    8 -> 4 -> 8 case at the port's sizes): the guard's scalars bit-equal
    at every stop, ``rank_norms`` re-created as zeros at each new size,
    the inner rows bit-equal to the JAX package's own 2 -> 1 -> 2."""
    from horovod_tpu_torch.models.convert import opt_state_from_jax

    params, grads = _guard_inputs()
    jst = _jax_guarded_zero1(2, params, grads)
    jck.save(str(tmp_path), 3, {"opt": jst})
    st = opt_state_from_jax(ck.restore(str(tmp_path), 3)["opt"])
    j1 = jreshard(jst, params, to_size=1)
    j2 = jreshard(j1, params, to_size=2)
    t1 = reshard_optimizer_state(st, params, to_size=1)
    t2 = reshard_optimizer_state(t1, params, to_size=2)
    for got, want, n in ((t1, j1, 1), (t2, j2, 2)):
        _assert_guard_scalars(got, jst)
        _assert_guard_scalars(got, want)
        _assert_same(np.asarray(got.rank_norms), np.zeros(n, np.float32),
                     "rank_norms")
        assert got.inner["shard"] == {"size": n}
        for part in ("mu", "nu"):
            _assert_same(got.inner["inner"][part]["float32"],
                         np.asarray(getattr(want.inner.inner[0], part)
                                    ["float32"]), part)
        _assert_same(got.inner["residual"]["float32"],
                     np.asarray(want.inner.residual["float32"]), "residual")
