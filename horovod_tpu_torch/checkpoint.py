"""Checkpoint save and restore.

Counterpart of ``horovod_tpu/checkpoint.py``, function for function, and
the same files on disk: ``step_N/arrays.npz`` (array leaf ``i`` as member
``a{i}``) and ``step_N/tree.pkl`` = ``{"treedef": ..., "meta": [("array",
"a{i}") | ("obj", leaf)]}``, the treedef pickled as JAX's
(:mod:`horovod_tpu_torch.pytree`), so each package restores what the
other wrote. Leaves are taken in JAX's flatten order; tensors,
``np.ndarray`` and ``np.generic`` are array leaves, every other leaf is
pickled as it is. A bf16 tensor is written as the JAX package writes a
bf16 array, its two bytes a value as ``<V2``, and comes back, as in the
JAX package, as a ``|V2`` array (:func:`horovod_tpu_torch.training
.host_tensor` views it as bf16 again).

- :func:`save` — rank 0 writes, staged in a temp directory and renamed
  into place; a ZeRO-1 state in the tree (``state["shard"]`` naming this
  rank's row) is first gathered into the consolidated view the JAX
  package writes (one ``all_gather`` per array, on every rank), and
  :class:`~horovod_tpu_torch.optim.FsdpParams` into its ``[N, s]`` rows;
- :func:`restore` — rank 0 reads, and broadcasts the structure and then
  each array (as bytes), so a rank never reads its own filesystem;
- :func:`consolidate_opt_state` — a restored optimizer state made this
  rank's state again, re-packed for the world's size
  (:func:`~horovod_tpu_torch.optim.reshard_optimizer_state`);
  :func:`fsdp_params` the same for ZeRO-3 parameters at the same size;
- :func:`latest_step` / :func:`valid_steps` — resume discovery that
  skips torn (CRC) and non-finite checkpoints;
- :class:`CheckpointManager` — keep-last-N rotation and the asynchronous
  save, whose host snapshot is taken at the call;
- :func:`attach_data_state` / :func:`detach_data_state` — the loaders'
  cursors ride the payload under ``"data_cursor"``.
"""

from __future__ import annotations

import io
import logging
import os
import re
import shutil
import tempfile
import threading
import zipfile
import zlib
from typing import Any, Optional

import numpy as np
import torch

from horovod_tpu_torch import basics, pytree
from horovod_tpu_torch.ops import collective as C
from horovod_tpu_torch.optim import (  # noqa: F401
    FSDP_ROWS, FsdpParams, MultiStepsState, _fsdp_meta, _map_state,
    fsdp_reshard_params, is_zero1_rows, reshard_optimizer_state,
)
from horovod_tpu_torch.resilience.numerics import (  # noqa: F401
    CKPT_FINITE_ENV, NumericsGuardState, array_finite,
    checkpoint_finite_check_enabled,
)
from horovod_tpu_torch.training import (
    BF16_ON_HOST, host_array, host_snapshot, host_tensor,
)

_STEP_RE = re.compile(r"^step_(\d+)$")

logger = logging.getLogger("horovod_tpu_torch.checkpoint")


def _is_writer() -> bool:
    """Rank 0 writes. Before ``hvd.init`` the launcher's identity env
    decides; a standalone process is its own rank 0."""
    if basics.is_initialized():
        return basics.rank() == 0
    return int(os.environ.get(
        "HVD_PROCESS_ID", os.environ.get("HOROVOD_RANK", "0"))) == 0


def _multi() -> bool:
    return basics.is_initialized() and basics.size() > 1


def _step_dir(directory: str, step: int) -> str:
    return os.path.join(directory, f"step_{step}")


def _is_array(x) -> bool:
    return isinstance(x, (torch.Tensor, np.ndarray, np.generic))


def attach_data_state(payload: dict, cursors: Optional[dict] = None) -> dict:
    """``payload`` with the loaders' cursors under ``"data_cursor"``
    (``cursors`` verbatim when given, else the live registry's export);
    unchanged when no loader is registered."""
    if cursors is None:
        from horovod_tpu_torch.data import sampler

        cursors = sampler.export_state()
    if not cursors:
        return payload
    out = dict(payload)
    out["data_cursor"] = cursors
    return out


def detach_data_state(payload: Any) -> Any:
    """Restore a ``"data_cursor"`` riding ``payload`` into the loader
    registry (pending until the loader registers) and return the payload
    without it. Non-dict payloads pass through."""
    if not isinstance(payload, dict) or "data_cursor" not in payload:
        return payload
    payload = dict(payload)
    cursors = payload.pop("data_cursor")
    try:
        from horovod_tpu_torch.data import sampler

        # npz round-trips ints as 0-d arrays: coerce back
        sampler.restore_state({
            str(name): {str(k): int(v) for k, v in cur.items()}
            for name, cur in dict(cursors).items()})
    except Exception:
        logger.warning("data-cursor restore failed", exc_info=True)
    return payload


# --------------------------------------------------------------------------
# sharded states: gathered before the write, one rank's row after restore


def _rows(x, n: int):
    """Every rank's ``x`` stacked on a new leading axis: a tensor through
    one ``all_gather``, a Python int or float tiled (every rank steps
    together, so they agree), as the JAX package's per-rank state holds
    them (``count`` is int32 ``[N]``)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().reshape(1, *x.shape)
        return C.allgather(x.contiguous()) if n > 1 else x
    if isinstance(x, bool) or not isinstance(x, (int, float)):
        return x
    return np.full((n,), x, np.int32 if isinstance(x, int) else np.float32)


def _gather_sharded(tree):
    """``tree`` with each ZeRO-1 state replaced by its consolidated view
    and each :class:`FsdpParams` by ``{FSDP_ROWS: {group: [N, s]},
    "keys", "shapes", "dtypes"}``. Collective when the world has more
    than one rank and the tree holds such a state."""
    if isinstance(tree, FsdpParams):
        n = tree.meta.size
        out = {FSDP_ROWS: {k: _rows(v, n) for k, v in tree.shards.items()},
               "keys": list(tree.meta.keys),
               "shapes": [list(s) for s in tree.meta.shapes],
               "dtypes": [str(d).replace("torch.", "")
                          for d in tree.meta.dtypes]}
        if tree.meta.bucket_bytes:
            out["bucket_bytes"] = tree.meta.bucket_bytes
        return out
    if isinstance(tree, dict):
        shard = tree.get("shard")
        if isinstance(shard, dict) and set(shard) == {"rank", "size"} \
                and "inner" in tree:
            n = int(shard["size"])
            if n != _world()[1]:
                raise ValueError(f"a ZeRO-1 state of a world of {n} cannot be "
                                 "gathered in this world")
            out = {k: _map_state(lambda x: _rows(x, n), v)
                   for k, v in tree.items() if k != "shard"}
            out["shard"] = {"size": n}
            return out
        return {k: _gather_sharded(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        items = [_gather_sharded(v) for v in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") \
            else type(tree)(items)
    return tree


def _holds_sharded(tree) -> bool:
    """Whether :func:`_gather_sharded` of ``tree`` enters a collective: the
    world has more than one rank and the tree holds a ZeRO-1 state or an
    :class:`FsdpParams`."""
    if _world()[1] == 1:
        return False
    if isinstance(tree, FsdpParams):
        return True
    if isinstance(tree, dict):
        shard = tree.get("shard")
        if isinstance(shard, dict) and set(shard) == {"rank", "size"} \
                and "inner" in tree:
            return True
        return any(_holds_sharded(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return any(_holds_sharded(v) for v in tree)
    return False


def _world() -> tuple:
    """``(rank, size)``, a world of one before ``hvd.init``."""
    if basics.is_initialized():
        return basics.rank(), basics.size()
    return 0, 1


def _device_of(params) -> torch.device:
    for v in (params.values() if isinstance(params, dict) else ()):
        if isinstance(v, torch.Tensor):
            return v.device
    return basics.device() if basics.is_initialized() else torch.device("cpu")


def _tensors(tree, device):
    """Every host array leaf of ``tree`` as a tensor on ``device``."""
    return _map_state(lambda x: host_tensor(x).to(device)
                      if isinstance(x, (np.ndarray, np.generic)) else x, tree)


def _from_jax_state(state):
    """A state the JAX package wrote in the port's layout
    (:func:`~horovod_tpu_torch.models.convert.opt_state_from_jax`: a ZeRO-1
    state as its consolidated view)."""
    from horovod_tpu_torch.models.convert import opt_state_from_jax

    return opt_state_from_jax(state)


def consolidate_opt_state(opt_state, params, *,
                          to_size: Optional[int] = None,
                          bucket_bytes: Optional[int] = None):
    """A restored optimizer state made this rank's state again.

    A ZeRO-1 state comes back from :func:`restore` as its consolidated
    view (every rank's row, the JAX package's layout; a state the JAX
    package wrote is read the same way): it is re-packed for ``to_size``
    ranks (default the world's size) with
    :func:`~horovod_tpu_torch.optim.reshard_optimizer_state`, against
    ``params``, the tree the state was built on (``model.jax_params()``,
    host arrays, or ZeRO-3 parameters, restored or live), and this rank's
    row is returned as the rank-local state. A ``NumericsGuardState``
    (the numerics guard's, either package's) is consolidated through its
    ``inner``, its scalars kept. Any other state comes back
    with its arrays as tensors. Tensors go to the parameters' device. A
    ZeRO-3 state moves to another world size the same way, against its
    parameters' consolidated rows (a bucketed pack's ``bucket_bytes``
    taken from them); :func:`fsdp_params` re-packs the rows."""
    opt_state = _from_jax_state(opt_state)
    dev = _device_of(params)
    if isinstance(opt_state, NumericsGuardState):
        # the inner state made this rank's; the guard's scalars are the
        # same on every rank and at every world size, and go to the
        # device as they are (rank_norms, one step deep, restarts at
        # zeros when the size changes), as the JAX package re-packs it
        n_new = int(to_size) if to_size is not None else _world()[1]
        st = opt_state._replace(
            inner=consolidate_opt_state(opt_state.inner, params,
                                        to_size=to_size,
                                        bucket_bytes=bucket_bytes),
            rank_norms=(opt_state.rank_norms
                        if tuple(np.shape(opt_state.rank_norms)) == (n_new,)
                        else np.zeros((n_new,), np.float32)))
        return st._replace(**{f: _tensors(getattr(st, f), dev)
                              for f in st._fields if f != "inner"})
    if type(opt_state).__name__ == "MultiStepsState":
        return MultiStepsState(
            torch.as_tensor(np.asarray(opt_state.mini_step, np.int32)),
            torch.as_tensor(np.asarray(opt_state.gradient_step, np.int32)),
            consolidate_opt_state(opt_state.inner_opt_state, params,
                                  to_size=to_size, bucket_bytes=bucket_bytes),
            _tensors(opt_state.acc_grads, dev), opt_state.skip_state)
    if not is_zero1_rows(opt_state):
        return _tensors(opt_state, dev)
    rank, size = _world()
    n_new = int(to_size) if to_size is not None else size
    if not 0 <= rank < n_new:
        raise ValueError(f"rank {rank} has no row in a world of {n_new}")
    if isinstance(params, dict) and FSDP_ROWS in params:
        if bucket_bytes is None:
            bucket_bytes = params.get("bucket_bytes")
        params = {k: torch.empty(s, dtype=getattr(torch, d), device="meta")
                  for k, s, d in zip(params["keys"], params["shapes"],
                                     params["dtypes"])}
    rows = reshard_optimizer_state(opt_state, params, to_size=n_new,
                                   bucket_bytes=bucket_bytes)

    def row(x):
        if not isinstance(x, (np.ndarray, torch.Tensor)):
            return x
        r = host_array(x[rank])
        if r.ndim == 0 and r.dtype.kind in "iu":
            return int(r)           # the port's count is a Python int
        return host_tensor(r).to(dev)

    out = {k: _map_state(row, v) for k, v in rows.items() if k != "shard"}
    out["shard"] = {"rank": rank, "size": n_new}
    return out


def rank_state(state: Any, *, to_size: Optional[int] = None) -> Any:
    """A restored or host-snapshotted state made this rank's again, what
    the preemption loop's resume and the elastic driver's rollback hand
    the step: a dict carrying ``params`` and ``opt_state`` gets its
    optimizer state consolidated for ``to_size`` ranks (default the
    world's size; :func:`consolidate_opt_state`), and every host array
    leaf becomes a tensor on the world's device (the CPU before
    ``hvd.init``). ZeRO-3 parameters are re-packed by
    :func:`fsdp_params`, not here."""
    if isinstance(state, dict) and "opt_state" in state \
            and "params" in state:
        state = dict(state)
        state["opt_state"] = consolidate_opt_state(
            state["opt_state"], state["params"], to_size=to_size)
    dev = basics.device() if basics.is_initialized() else torch.device("cpu")
    return _tensors(state, dev)


def fsdp_params(saved: dict, *, to_size: Optional[int] = None) -> FsdpParams:
    """This rank's :class:`~horovod_tpu_torch.optim.FsdpParams` from the
    consolidated rows :func:`save` wrote for one, re-packed for ``to_size``
    ranks (default the world's size;
    :func:`~horovod_tpu_torch.optim.fsdp_reshard_params`): this rank's
    row of each group, on the world's device, with the pack's
    ``bucket_bytes``."""
    rank, size = _world()
    n = int(to_size) if to_size is not None else size
    saved = fsdp_reshard_params(saved, to_size=n)
    rows = saved[FSDP_ROWS]
    dtypes = [getattr(torch, d) for d in saved["dtypes"]]
    meta = _fsdp_meta(saved["keys"], saved["shapes"], dtypes, rank, n,
                      bucket_bytes=saved.get("bucket_bytes"))
    dev = basics.device() if basics.is_initialized() else torch.device("cpu")
    return FsdpParams({k: host_tensor(host_array(v[rank])).to(dev)
                       for k, v in rows.items()}, meta)


# --------------------------------------------------------------------------
# save and restore


def save(directory: str, step: int, state: Any, *, force: bool = False,
         fence: bool = True) -> str:
    """Write ``state`` (a tree of tensors, arrays and picklable leaves)
    for ``step``.

    ZeRO-1 states and ZeRO-3 parameters in the tree are first gathered on
    every rank (:func:`_gather_sharded`), so with such a state every rank
    must call. Only rank 0 writes. With ``fence=True`` every rank then
    learns the writer's status, so a failed write raises on every rank
    (a collective); ``fence=False`` skips it. The write is atomic: staged
    in a temp directory, renamed into place."""
    state = _gather_sharded(state)
    path = _step_dir(directory, step)
    err: Optional[BaseException] = None
    if _is_writer():
        try:
            _write_checkpoint(directory, path, step, state, force)
        except BaseException as e:
            err = e
    err_msg = repr(err) if err is not None else None
    status = _sync_status(err_msg) if fence else err_msg
    if err is not None:
        raise err
    if status is not None:
        raise RuntimeError(f"checkpoint write failed on rank 0: {status}")
    return path


def _savez(file: str, arrays: dict) -> None:
    """``np.savez(file, **arrays)``, but a bf16 leaf (``|V2``) is written
    with the ``<V2`` descriptor ``np.savez`` gives a bf16 array, so the
    members are the JAX package's byte for byte."""
    with zipfile.ZipFile(file, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for key, val in arrays.items():
            with zf.open(key + ".npy", "w", force_zip64=True) as fid:
                if val.dtype == BF16_ON_HOST:
                    np.lib.format.write_array_header_1_0(fid, {
                        "descr": "<V2", "fortran_order": False,
                        "shape": val.shape})
                    fid.write(np.ascontiguousarray(val).tobytes())
                else:
                    np.lib.format.write_array(fid, np.asanyarray(val),
                                              allow_pickle=True)


def _write_checkpoint(directory, path, step, state, force):
    if os.path.exists(path):
        if not force:
            raise FileExistsError(f"checkpoint already exists: {path}")
        shutil.rmtree(path)
    os.makedirs(directory, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=directory, prefix=f".tmp_step_{step}_")
    try:
        leaves, treedef = pytree.flatten(state)
        arrays, meta = {}, []
        for i, leaf in enumerate(leaves):
            if _is_array(leaf):
                arrays[f"a{i}"] = host_array(leaf) if isinstance(
                    leaf, torch.Tensor) else np.asarray(leaf)
                meta.append(("array", f"a{i}"))
            else:
                meta.append(("obj", leaf))
        _savez(os.path.join(tmp, "arrays.npz"), arrays)
        with open(os.path.join(tmp, "tree.pkl"), "wb") as f:
            pytree.dump({"treedef": treedef, "meta": meta}, f)
        os.rename(tmp, path)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def _broadcast_array(a: Optional[np.ndarray], shape, dtype: str,
                     root: int) -> np.ndarray:
    """Root's array on every rank, sent as its bytes (``uint8``), which
    carries any dtype, ``|V2`` included, and viewed back."""
    dtype = np.dtype(dtype)
    n = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
    if a is not None:
        buf = torch.from_numpy(
            np.ascontiguousarray(a).reshape(-1).view(np.uint8))
    else:
        buf = torch.empty(n, dtype=torch.uint8)
    out = C.broadcast(buf.to(basics.device()), root)
    return out.cpu().numpy().view(dtype).reshape(shape)


def broadcast_host_tree(tree: Any, root: int = 0, *,
                        error: Optional[str] = None,
                        what: str = "broadcast") -> Any:
    """``root``'s tree of host arrays (numpy, bf16 as ``|V2``) and
    picklable leaves on every rank: the structure and the object leaves
    as one ``pytree.dump`` (its stand-in classes travel by name) through
    ``broadcast_object``, then each array as its bytes. ``error`` given on
    ``root``: the other ranks raise ``RuntimeError("<what> failed on rank
    <root>: <error>")`` instead (the root raises its own). Collective;
    the other ranks' ``tree`` is ignored."""
    is_root = basics.rank() == root
    arrays, payload = [], None
    if is_root and error is not None:
        payload = {"ok": False, "error": error}
    elif is_root:
        leaves, treedef = pytree.flatten(tree)
        meta = []
        for leaf in leaves:
            if isinstance(leaf, (np.ndarray, np.generic)):
                a = np.asarray(leaf)
                meta.append(("array", (a.shape, a.dtype.str)))
                arrays.append(a)
            else:
                meta.append(("obj", leaf))
        buf = io.BytesIO()
        pytree.dump({"treedef": treedef, "meta": meta}, buf)
        payload = {"ok": True, "tree": buf.getvalue()}
    payload = C.broadcast_object(payload, root)
    if not payload["ok"]:
        raise RuntimeError(f"{what} failed on rank {root}: "
                           f"{payload['error']}")
    d = pytree.load(io.BytesIO(payload["tree"]))
    mine = iter(arrays)
    return pytree.unflatten(d["treedef"], [
        v if kind == "obj" else _broadcast_array(
            next(mine) if is_root else None, v[0], v[1], root)
        for kind, v in d["meta"]])


def restore(directory: str, step: Optional[int] = None, *,
            broadcast_root: int = 0) -> Any:
    """Load a checkpoint on ``broadcast_root`` only and broadcast it
    (:func:`broadcast_host_tree`), so every rank resumes from the same
    state even when only the root's filesystem holds it. Arrays come back
    as numpy (bf16 as ``|V2``); sharded states in their consolidated view
    (:func:`consolidate_opt_state`, :func:`fsdp_params`)."""
    multi = _multi()
    i_am_root = not multi or basics.rank() == broadcast_root
    tree, err = None, None
    if i_am_root:
        try:
            if step is None:
                step = latest_step(directory)
                if step is None:
                    raise FileNotFoundError(f"no checkpoints under {directory}")
            path = _step_dir(directory, step)
            with open(os.path.join(path, "tree.pkl"), "rb") as f:
                d = pytree.load(f)
            with np.load(os.path.join(path, "arrays.npz")) as arrays:
                tree = pytree.unflatten(d["treedef"], [
                    arrays[v] if kind == "array" else v
                    for kind, v in d["meta"]])
        except BaseException as e:
            err = e
    if not multi:
        if err is not None:
            raise err
        return tree
    try:
        return broadcast_host_tree(
            tree, broadcast_root, what="checkpoint restore",
            error=repr(err) if err is not None else None)
    except RuntimeError:
        if err is not None:
            raise err
        raise


def state_nbytes(state: Any) -> int:
    """Raw array bytes a checkpoint of ``state`` holds (the ``.npz``
    members' payload, before zip framing). A sharded state counts as it
    is given: pass the restored tree for what a save of it wrote."""
    leaves, _ = pytree.flatten(state)
    return sum(x.numel() * x.element_size() if isinstance(x, torch.Tensor)
               else np.asarray(x).nbytes for x in leaves if _is_array(x))


# --------------------------------------------------------------------------
# validity


def is_valid_checkpoint(path: str) -> bool:
    """Is ``path`` a loadable ``step_N`` directory? ``tree.pkl`` must
    unpickle, every ``.npz`` member must read back intact (zipfile checks
    each member's CRC as it decompresses), and no float leaf may hold
    NaN/Inf (unless ``HOROVOD_CHECKPOINT_FINITE_CHECK=0``)."""
    return _checkpoint_invalid_reason(path) is None


def _stream_members(npz: str) -> None:
    with zipfile.ZipFile(npz) as zf:
        for name in zf.namelist():
            with zf.open(name) as m:
                while m.read(1 << 20):
                    pass


def _checkpoint_invalid_reason(path: str) -> Optional[str]:
    """None for a valid checkpoint, else ``"corrupt"`` (unreadable, torn,
    a CRC failure) or ``"nonfinite"`` (intact, rejected only by the
    finiteness sweep)."""
    tree = os.path.join(path, "tree.pkl")
    npz = os.path.join(path, "arrays.npz")
    if not (os.path.isfile(tree) and os.path.isfile(npz)):
        return "corrupt"
    try:
        with open(tree, "rb") as f:
            pytree.load(f)
    except Exception as e:
        logger.warning("checkpoint %s: tree.pkl unreadable (%s)", path, e)
        return "corrupt"
    if not checkpoint_finite_check_enabled():
        # stream every member through the CRC check: no array is built
        try:
            _stream_members(npz)
        except (zipfile.BadZipFile, zlib.error, EOFError, OSError,
                ValueError) as e:
            logger.warning("checkpoint %s is corrupt (%s)", path, e)
            return "corrupt"
        return None
    try:
        with np.load(npz) as z:
            for k in z.files:
                try:
                    a = z[k]    # a full member read: zipfile checks the CRC
                except (zipfile.BadZipFile, zlib.error, EOFError,
                        OSError) as e:
                    logger.warning("checkpoint %s member %s is corrupt (%s)",
                                   path, k, e)
                    return "corrupt"
                except Exception as e:
                    # a member np.load cannot build (an object array): its
                    # bytes still pass the CRC check
                    logger.debug("finiteness sweep skipped member %s: %s",
                                 k, e)
                    try:
                        with z.zip.open(k + ".npy") as m:
                            while m.read(1 << 20):
                                pass
                    except Exception as e2:
                        logger.warning("checkpoint %s member %s is corrupt "
                                       "(%s)", path, k, e2)
                        return "corrupt"
                    continue
                if not array_finite(a):
                    logger.warning("checkpoint %s carries non-finite values "
                                   "in %s; treating it as invalid", path, k)
                    return "nonfinite"
    except (zipfile.BadZipFile, OSError, ValueError, EOFError):
        return "corrupt"
    return None


def _step_listing(directory: str) -> list:
    if not os.path.isdir(directory):
        return []
    return sorted(int(m.group(1)) for name in os.listdir(directory)
                  if (m := _STEP_RE.match(name)))


def _warn_all_nonfinite(directory: str, reasons: list) -> None:
    """Every candidate was rejected, and only by the finiteness sweep: a
    model that stores non-finite leaves on purpose; say how to opt out."""
    if reasons and all(r == "nonfinite" for r in reasons):
        logger.error(
            "ALL %d checkpoints under %s were rejected solely by the "
            "non-finite sweep — resume will restart from scratch. If your "
            "model legitimately stores non-finite leaves (additive -inf "
            "mask buffers, inf best-loss trackers), set "
            "%s=0.", len(reasons), directory, CKPT_FINITE_ENV)


def valid_steps(directory: str) -> list:
    """Ascending steps of the valid checkpoints under ``directory``; the
    others are skipped with a warning."""
    steps, reasons = [], []
    for s in _step_listing(directory):
        reason = _checkpoint_invalid_reason(_step_dir(directory, s))
        if reason is None:
            steps.append(s)
        else:
            reasons.append(reason)
            logger.warning("skipping %s checkpoint %s", reason,
                           _step_dir(directory, s))
    if not steps:
        _warn_all_nonfinite(directory, reasons)
    return steps


def latest_step(directory: str) -> Optional[int]:
    """The newest step with a valid checkpoint (walked newest first,
    stopping at the first valid one), or None."""
    reasons = []
    for s in reversed(_step_listing(directory)):
        reason = _checkpoint_invalid_reason(_step_dir(directory, s))
        if reason is None:
            return s
        reasons.append(reason)
        logger.warning("skipping %s checkpoint %s", reason,
                       _step_dir(directory, s))
    _warn_all_nonfinite(directory, reasons)
    return None


def _sync_status(err_msg: Optional[str]) -> Optional[str]:
    """The writer's status on every rank (a collective in a world of
    more than one), so a failed write never strands the others."""
    if _multi():
        return C.broadcast_object(err_msg, 0)
    return err_msg


class CheckpointManager:
    """Keep-last-N rotation over :func:`save` / :func:`restore`.

    ``save(..., asynchronous=True)`` gathers sharded states and takes the
    host snapshot at the call (the checkpoint holds the state at the
    call), then writes and rotates on a non-daemon thread, so training
    goes on while it writes. :meth:`wait_until_finished` joins it and
    fences the writer's status across ranks; the next ``save`` /
    ``restore`` calls it first. Like every fence here it is a collective
    in a world of more than one: every rank calls it, in the same order."""

    def __init__(self, directory: str, *, max_to_keep: int = 3):
        self.directory = directory
        self.max_to_keep = max_to_keep
        self._pending = None  # (thread | None, [err]) of the save in flight

    def save(self, step: int, state: Any, *, force: bool = False,
             asynchronous: bool = False) -> str:
        self.wait_until_finished()
        if not asynchronous:
            path = save(self.directory, step, state, force=force)
            self._rotate()
            return path
        path = _step_dir(self.directory, step)
        thread, err_box = None, []
        try:
            state = _gather_sharded(state)      # every rank
        except BaseException as e:
            err_box.append(e)
        if _is_writer() and not err_box:
            # a snapshot error goes through err_box and the fence too: a
            # writer that raised here would strand the others there
            try:
                snapshot = host_snapshot(state)
            except BaseException as e:
                err_box.append(e)
            else:
                def work():
                    try:
                        _write_checkpoint(self.directory, path, step,
                                          snapshot, force)
                        self._rotate()
                    except BaseException as e:  # raised at the fence
                        err_box.append(e)

                # non-daemon: an interpreter that exits without waiting
                # still joins it, so the last checkpoint's rename lands
                thread = threading.Thread(target=work, daemon=False,
                                          name=f"hvd-ckpt-save-{step}")
                thread.start()
        self._pending = (thread, err_box)
        return path

    def wait_until_finished(self) -> None:
        """Block until the save in flight (if any) ends, then fence the
        writer's status across ranks: a failed write raises on every
        rank. A collective in a world of more than one."""
        if self._pending is None:
            return
        thread, err_box = self._pending
        self._pending = None
        if thread is not None:
            thread.join()
        err = err_box[0] if err_box else None
        status = _sync_status(repr(err) if err is not None else None)
        if err is not None:
            raise err
        if status is not None:
            raise RuntimeError(f"checkpoint write failed on rank 0: {status}")

    def _rotate(self) -> None:
        if not (_is_writer() and self.max_to_keep):
            return
        for old in _step_listing(self.directory)[: -self.max_to_keep]:
            shutil.rmtree(_step_dir(self.directory, old), ignore_errors=True)

    def restore(self, step: Optional[int] = None) -> Any:
        self.wait_until_finished()
        return restore(self.directory, step)

    def latest_step(self) -> Optional[int]:
        self.wait_until_finished()
        return latest_step(self.directory)
