"""Storage backends for the data plane.

Counterpart of ``horovod_tpu/data/store.py``, copied whole: the same
shard files, manifest and CRCs, so either package reads a store the
other wrote, and the same quarantine and substitution rule.

Two layers:

- the estimator stores (reference ``horovod/spark/common/store.py``
  0.19.2 — a ``Store`` stages intermediate training data, checkpoints,
  and run state on a filesystem every worker can reach: ``LocalStore`` /
  ``HDFSStore``);
- :class:`ArrayShardStore` — the fault-isolated training-data store the
  input plane (:class:`horovod_tpu_torch.data.ResumableLoader`) reads from:
  row-range shards of numpy arrays with a CRC-carrying manifest, each
  read verified, transient failures retried through the shared
  :class:`~horovod_tpu_torch.resilience.retry.RetryPolicy` (scope ``DATA`` →
  ``HOROVOD_RETRY_DATA_*`` env), and a shard whose corruption survives
  the retry budget **quarantined** — its samples deterministically
  substituted from healthy shards, the skip surfaced in metrics
  (``data_samples_substituted``) and health (SUSPECT naming the shard),
  never silently ignored and never a crash. The
  ``HOROVOD_CHAOS=shard_corrupt=<shard>:<k>`` charge drives the whole
  path deterministically in tier-1.
"""

from __future__ import annotations

import io
import json
import logging
import os
import shutil
import threading
import zlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from horovod_tpu_torch.observability import metrics as _metrics

logger = logging.getLogger("horovod_tpu_torch.data")


class Store:
    """Abstract storage endpoint (reference ``spark/common/store.py:40-147``)."""

    def get_run_path(self, run_id: str) -> str:
        raise NotImplementedError

    def get_train_data_path(self, run_id: str) -> str:
        return os.path.join(self.get_run_path(run_id), "train_data.parquet")

    def get_val_data_path(self, run_id: str) -> str:
        return os.path.join(self.get_run_path(run_id), "val_data.parquet")

    def get_checkpoint_path(self, run_id: str) -> str:
        return os.path.join(self.get_run_path(run_id), "checkpoint")

    def get_logs_path(self, run_id: str) -> str:
        return os.path.join(self.get_run_path(run_id), "logs")

    def exists(self, path: str) -> bool:
        raise NotImplementedError

    def make_dirs(self, path: str) -> None:
        raise NotImplementedError

    def delete(self, path: str) -> None:
        raise NotImplementedError

    # -- dataframe staging --------------------------------------------------

    def write_dataframe(self, df, path: str) -> None:
        """Stage a pandas DataFrame as parquet at `path`."""
        raise NotImplementedError

    def read_dataframe(self, path: str):
        raise NotImplementedError


class LocalStore(Store):
    """Filesystem store (reference ``spark/common/store.py:149-216``
    ``LocalStore``)."""

    def __init__(self, prefix_path: str):
        self.prefix_path = os.path.abspath(prefix_path)

    def get_run_path(self, run_id: str) -> str:
        return os.path.join(self.prefix_path, run_id)

    def exists(self, path: str) -> bool:
        return os.path.exists(path)

    def make_dirs(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)

    def delete(self, path: str) -> None:
        if os.path.isdir(path):
            shutil.rmtree(path)
        elif os.path.exists(path):
            os.remove(path)

    def write_dataframe(self, df, path: str) -> None:
        self.make_dirs(os.path.dirname(path))
        df.to_parquet(path, index=False)

    def read_dataframe(self, path: str):
        import pandas as pd

        return pd.read_parquet(path)


class HDFSStore(Store):
    """HDFS store (reference ``spark/common/store.py:219-377``). Requires an
    HDFS client library (libhdfs), which this environment does not have; constructing raises
    with the parity note."""

    def __init__(self, prefix_path: str, host: Optional[str] = None,
                 port: Optional[int] = None, user: Optional[str] = None):
        try:
            import pyarrow.fs as pafs

            self._fs = pafs.HadoopFileSystem(
                host=host or "default", port=port or 0, user=user
            )
        except Exception as e:  # pragma: no cover - no libhdfs here
            raise ImportError(
                "HDFSStore needs a reachable libhdfs (reference "
                "spark/common/store.py:219-377); use LocalStore on a shared "
                "mount instead"
            ) from e
        self.prefix_path = prefix_path

    def get_run_path(self, run_id: str) -> str:  # pragma: no cover
        return os.path.join(self.prefix_path, run_id)

    def exists(self, path: str) -> bool:  # pragma: no cover
        import pyarrow.fs as pafs

        return self._fs.get_file_info(path).type != pafs.FileType.NotFound

    def make_dirs(self, path: str) -> None:  # pragma: no cover
        self._fs.create_dir(path, recursive=True)

    def delete(self, path: str) -> None:  # pragma: no cover
        self._fs.delete_dir_contents(path)


# ---------------------------------------------------------- sharded arrays


MANIFEST_NAME = "manifest.json"

#: shard-array caches kept hot per store (the working set of a sequential
#: epoch touches shards in permutation order, so a handful suffices)
CACHE_SHARDS_ENV = "HOROVOD_DATA_CACHE_SHARDS"


class ShardCorruptError(Exception):
    """A shard's bytes failed CRC verification. Classified transient for
    the retry layer (a torn concurrent write or flaky read heals on
    retry); corruption that survives the retry budget becomes a
    quarantine, not an exception."""


class DataUnavailableError(RuntimeError):
    """Every shard is quarantined — there is no healthy row left to
    substitute from; degrading further would mean training on nothing."""


class ArrayShardStore:
    """CRC-verified, retry-isolated, quarantine-capable shard reader.

    Layout (written by :meth:`write`): ``shard-00000.npz`` … holding each
    array's row range under keys ``a0..ak``, plus ``manifest.json`` with
    per-shard ``{file, start, rows, crc}`` (crc32 of the file bytes).

    Reads go through :meth:`read_shard`: bytes → chaos
    (``shard_corrupt``) → CRC check → ``np.load``. A CRC mismatch raises
    :class:`ShardCorruptError` and is retried on the shared
    ``RetryPolicy`` backoff schedule (scope ``DATA``); exhaustion
    **quarantines** the shard — ``health.record_data_corruption`` (→
    SUSPECT naming the shard), ``data_shards_quarantined`` /
    ``data_quarantined_shards`` metrics, a flight-recorder ``data``
    event — and :meth:`gather` substitutes its rows deterministically
    from healthy shards (``idx → healthy_rows[idx % n_healthy]``),
    counting every substitution in ``data_samples_substituted``.
    """

    def __init__(self, directory: str, *, retry_policy=None):
        self.directory = os.path.abspath(directory)
        with open(os.path.join(self.directory, MANIFEST_NAME)) as f:
            self.manifest = json.load(f)
        self.n = int(self.manifest["n"])
        self.n_arrays = int(self.manifest["arrays"])
        self._shards: List[dict] = list(self.manifest["shards"])
        self._starts = np.array(
            [int(s["start"]) for s in self._shards], dtype=np.int64
        )
        if retry_policy is None:
            from horovod_tpu_torch.resilience.retry import policy_from_env

            retry_policy = policy_from_env(
                "DATA", max_attempts=3, base_delay=0.01, max_delay=0.2,
            )
        self._retry = retry_policy
        self._lock = threading.Lock()
        self._cache: "Dict[int, Tuple[np.ndarray, ...]]" = {}
        self._cache_order: List[int] = []
        self._reads: Dict[int, int] = {}
        self._quarantined: set = set()
        self._healthy_rows_cache: Optional[np.ndarray] = None

    # ---------------------------------------------------------------- write

    @staticmethod
    def write(directory: str, arrays, rows_per_shard: int) -> dict:
        """Stage `arrays` (one array or a tuple sharing dim 0) as CRC'd
        row-range shards under `directory`; returns the manifest."""
        arrs = tuple(arrays) if isinstance(arrays, (tuple, list)) \
            else (arrays,)
        n = arrs[0].shape[0]
        for a in arrs[1:]:
            if a.shape[0] != n:
                raise ValueError(
                    f"arrays disagree on dim 0: {a.shape[0]} != {n}"
                )
        if rows_per_shard < 1:
            raise ValueError("rows_per_shard must be >= 1")
        os.makedirs(directory, exist_ok=True)
        shards = []
        for i, start in enumerate(range(0, n, rows_per_shard)):
            rows = min(rows_per_shard, n - start)
            fname = f"shard-{i:05d}.npz"
            path = os.path.join(directory, fname)
            payload = {
                f"a{k}": np.asarray(a[start:start + rows])
                for k, a in enumerate(arrs)
            }
            buf = io.BytesIO()
            np.savez(buf, **payload)
            data = buf.getvalue()
            with open(path, "wb") as f:
                f.write(data)
            shards.append({
                "file": fname, "start": int(start), "rows": int(rows),
                "crc": int(zlib.crc32(data)),
            })
        manifest = {
            "version": 1, "n": int(n), "arrays": len(arrs),
            # per-array dtype + trailing shape: empty gathers (and shape
            # probes) answer from metadata instead of a shard read
            "dtypes": [np.dtype(a.dtype).str for a in arrs],
            "row_shapes": [list(a.shape[1:]) for a in arrs],
            "shards": shards,
        }
        with open(os.path.join(directory, MANIFEST_NAME), "w") as f:
            json.dump(manifest, f)
        return manifest

    # ----------------------------------------------------------------- read

    @property
    def n_rows(self) -> int:
        return self.n

    @property
    def n_shards(self) -> int:
        return len(self._shards)

    def quarantined(self) -> List[int]:
        """Quarantined shard ids, ascending."""
        with self._lock:
            return sorted(self._quarantined)

    def shard_of(self, index: int) -> int:
        """The shard holding row `index`."""
        return int(
            np.searchsorted(self._starts, int(index), side="right") - 1
        )

    def _cache_cap(self) -> int:
        return max(1, int(os.environ.get(CACHE_SHARDS_ENV, "8")))

    def _read_shard_once(self, i: int) -> Tuple[np.ndarray, ...]:
        meta = self._shards[i]
        with open(os.path.join(self.directory, meta["file"]), "rb") as f:
            data = f.read()
        data = self._maybe_corrupt(i, data)
        crc = zlib.crc32(data)
        if crc != int(meta["crc"]):
            raise ShardCorruptError(
                f"shard {i} ({meta['file']}): crc {crc:#010x} != manifest "
                f"{int(meta['crc']):#010x}"
            )
        loaded = np.load(io.BytesIO(data))
        return tuple(loaded[f"a{k}"] for k in range(self.n_arrays))

    def _maybe_corrupt(self, i: int, data: bytes) -> bytes:
        from horovod_tpu_torch.resilience import chaos as _chaos

        if not _chaos.enabled():
            return data
        charge = _chaos.shard_corrupt()
        if charge is None or charge[0] != i:
            return data
        with self._lock:
            count = self._reads.get(i, 0)
            self._reads[i] = count + 1
        if count < charge[1]:
            return data
        _chaos.record_injection("shard_corrupt")
        # flip one payload byte: CRC must catch it
        mid = len(data) // 2
        return data[:mid] + bytes([data[mid] ^ 0xFF]) + data[mid + 1:]

    def read_shard(self, i: int) -> Optional[Tuple[np.ndarray, ...]]:
        """Shard `i`'s arrays, CRC-verified and cached; None when the
        shard is (or just became) quarantined."""
        with self._lock:
            if i in self._quarantined:
                return None
            cached = self._cache.get(i)
        if cached is not None:
            return cached
        try:
            arrays = self._call_with_retry(i)
        except ShardCorruptError as e:
            self._quarantine(i, str(e))
            return None
        with self._lock:
            if i not in self._cache:
                # a concurrent miss on the same shard may have raced us
                # here: one insertion only, or _cache_order accumulates
                # a ghost duplicate that shrinks the effective capacity
                self._cache[i] = arrays
                self._cache_order.append(i)
                while len(self._cache_order) > self._cache_cap():
                    old = self._cache_order.pop(0)
                    self._cache.pop(old, None)
        return arrays

    def _call_with_retry(self, i: int) -> Tuple[np.ndarray, ...]:
        """Retry on the shared policy's backoff schedule, but own the
        exhaustion outcome: a shard that stays corrupt is a *quarantine*
        (SUSPECT, degrade-don't-crash), not the retry layer's generic
        DEGRADED — so this walks ``policy.delays()`` directly instead of
        ``policy.call()`` (whose exhaustion hook marks DEGRADED)."""
        import time as _time

        from horovod_tpu_torch.resilience import health as _health

        last: Optional[BaseException] = None
        for delay in list(self._retry.delays()) + [None]:
            try:
                return self._read_shard_once(i)
            except (ShardCorruptError, OSError) as e:
                last = e
                if _metrics.enabled():
                    _metrics.counter(
                        "data_shard_retries",
                        help="shard reads retried after CRC/IO failure",
                        shard=i,
                    ).inc()
                _health.record_retry(self._retry.scope)
                if delay is None:
                    break
                _time.sleep(delay)
        if isinstance(last, ShardCorruptError):
            raise last
        raise ShardCorruptError(f"shard {i}: {last!r}")

    def _quarantine(self, i: int, reason: str) -> None:
        from horovod_tpu_torch.resilience import health as _health

        with self._lock:
            if i in self._quarantined:
                return
            self._quarantined.add(i)
            self._cache.pop(i, None)
            self._healthy_rows_cache = None
            n_q = len(self._quarantined)
        logger.error(
            "data: quarantining corrupt shard %d (%s); its samples will "
            "be substituted from healthy shards", i, reason,
        )
        _health.record_data_corruption(self._shards[i]["file"], reason)
        if _metrics.enabled():
            _metrics.counter(
                "data_shards_quarantined",
                help="data shards quarantined after unrecoverable "
                     "corruption",
                shard=i,
            ).inc()
            _metrics.gauge(
                "data_quarantined_shards",
                help="data shards currently quarantined",
            ).set(n_q)
        try:
            from horovod_tpu_torch.observability import flight as _flight

            _flight.record(
                "data", event="shard_quarantined", shard=int(i),
                file=self._shards[i]["file"],
            )
        except Exception as e:
            logger.debug("flight shard-quarantine event skipped: %s", e)

    # --------------------------------------------------------------- gather

    def _healthy_rows(self) -> np.ndarray:
        """Row indices living in non-quarantined shards, ascending (the
        substitution pool)."""
        with self._lock:
            if self._healthy_rows_cache is not None:
                return self._healthy_rows_cache
            quarantined = set(self._quarantined)
        spans = [
            np.arange(s["start"], s["start"] + s["rows"])
            for i, s in enumerate(self._shards) if i not in quarantined
        ]
        pool = (
            np.concatenate(spans) if spans
            else np.empty((0,), dtype=np.int64)
        )
        with self._lock:
            if self._quarantined != quarantined:
                # a concurrent _quarantine invalidated the pool we just
                # built — storing it would resurrect the bad shard's
                # rows as substitution targets; serve the stale copy
                # once (harmless: those reads already raced) but leave
                # the cache invalidated for the next call
                return pool
            self._healthy_rows_cache = pool
        return pool

    def _shards_of(self, idx: np.ndarray) -> np.ndarray:
        """Vectorized :meth:`shard_of` (the per-batch hot path)."""
        return np.searchsorted(self._starts, idx, side="right") - 1

    def gather(self, indices: Sequence[int]) -> Tuple[np.ndarray, ...]:
        """Rows `indices` across every array, in order. Indices landing in
        a quarantined shard are substituted deterministically
        (``healthy_rows[idx % n_healthy]``) and counted
        (``data_samples_substituted``) — batch shapes stay static, the
        skip is never silent, and the remap is a pure function of the
        index (given the quarantine set) so replay/resume reproduce it."""
        idx = np.asarray(indices, dtype=np.int64)
        if idx.size == 0:
            dtypes = self.manifest.get("dtypes")
            shapes = self.manifest.get("row_shapes")
            if dtypes and shapes:
                return tuple(
                    np.empty((0, *shapes[k]), dtype=np.dtype(dtypes[k]))
                    for k in range(self.n_arrays)
                )
            return tuple(np.empty((0,)) for _ in range(self.n_arrays))
        if idx.min() < 0 or idx.max() >= self.n:
            raise IndexError(
                f"indices out of range [0, {self.n}): "
                f"[{idx.min()}, {idx.max()}]"
            )
        # substitution resolves lazily — reading a shard may quarantine
        # it (and a substitution target can go bad mid-gather), so loop
        # until the resolved set reads clean; bounded by the shard count
        # since every retry permanently removes at least one shard
        resolved = idx.copy()
        sub_mask = np.zeros(idx.shape, dtype=bool)
        shard_data: Dict[int, Optional[Tuple[np.ndarray, ...]]] = {}
        for _attempt in range(self.n_shards + 1):
            shards = self._shards_of(resolved)
            shard_data = {
                int(s): self.read_shard(int(s))
                for s in np.unique(shards)
            }
            bad = sorted(s for s, d in shard_data.items() if d is None)
            if not bad:
                break
            pool = self._healthy_rows()
            if pool.size == 0:
                raise DataUnavailableError(
                    "every data shard is quarantined; no healthy rows "
                    "left to substitute from"
                )
            mask = np.isin(shards, np.asarray(bad))
            sub_mask |= mask  # counted once per position, not per retry
            resolved[mask] = pool[idx[mask] % pool.size]
        else:  # pragma: no cover - defensive: cannot shrink forever
            raise DataUnavailableError(
                "shard substitution did not converge"
            )
        n_sub = int(sub_mask.sum())
        if _metrics.enabled() and n_sub:
            _metrics.counter(
                "data_samples_substituted",
                help="samples remapped off quarantined shards",
            ).inc(n_sub)
        shards = self._shards_of(resolved)
        local = resolved - self._starts[shards]
        pos_by_shard = {
            int(s): np.nonzero(shards == s)[0]
            for s in np.unique(shards)
        }
        out = []
        for k in range(self.n_arrays):
            sample = next(iter(shard_data.values()))[k]
            outk = np.empty(
                (resolved.size,) + sample.shape[1:], dtype=sample.dtype)
            for s, pos in pos_by_shard.items():
                outk[pos] = shard_data[s][k][local[pos]]
            out.append(outk)
        return tuple(out)

