"""Continuous-batching transformer inference engine on subscribed weights.

Counterpart of ``horovod_tpu/serving/engine.py``: weights stream in
through :class:`~horovod_tpu_torch.serving.subscriber.WeightSubscriber`
(train → publish → **serve**), and this engine turns them into tokens
under request traffic:

- **Paged KV cache**: every layer's cache is one preallocated pool of
  fixed-size pages ``[num_pages, page_size, H_kv, D]`` that the engine
  owns and passes to each forward, which writes it in place; sequences
  own pages through per-slot page tables, so one forward shape serves
  any batch composition. Decode attention is
  :func:`horovod_tpu_torch.ops.flash_attention.paged_decode_attention`.
- **Continuous batching**: requests join the batched decode at any
  iteration boundary and finished sequences free their slot and pages
  at the boundary they finish. Prefill is chunked (``prefill_chunk``
  tokens an iteration) into the same schedule.
- **Weight arms**: one parameter set per rollout arm (``stable``, and
  ``canary`` while a :class:`~horovod_tpu_torch.serving.rollout.
  GenerationRollout` evaluates a new generation). Parameters are an
  argument of the forward (``torch.func.functional_call`` of one
  parameterless ``meta`` twin of the model), so arms share the model and
  the page pool.
- **Speculative decoding**: a draft made of the target's first
  ``draft_depth`` blocks proposes ``spec_lookahead`` greedy tokens on its
  own page pool; the target verifies them in one forward; greedy
  acceptance keeps the stream token-identical to plain decode.
- **Tensor parallelism** (``tp_axis``): each rank of that axis of the
  process's mesh (:func:`horovod_tpu_torch.parallel.build_mesh`) holds
  its column and row slices of the weights by
  :func:`~horovod_tpu_torch.models.transformer.transformer_param_specs`
  and its head block of every page pool; a block is two ``psum``\\ s
  around :func:`~horovod_tpu_torch.ops.flash_attention.
  tp_paged_decode_attention`, and a sharded embedding or vocabulary
  adds one all-gather each. Every rank runs the same scheduler on the
  same submissions: the control plane is replicated and makes no
  collective.

Logits stay on the device; only the rows the scheduler consumes come to
the host, where every token is chosen (the sequences' seeded samplers).
The engine runs on ``device`` (by default this process's device once
``init`` has run, else ``cuda:0``) and never moves to another on its own.

Degrade-don't-crash composes end to end: a stalled subscriber keeps the
engine serving generation ``G−k`` while :func:`note_subscriber_health`
flips ``/health`` to 503 with the lag in the reason; in-flight sequences
are never dropped.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from horovod_tpu_torch.models.convert import flatten_tree
from horovod_tpu_torch.models.layers import layer_norm
from horovod_tpu_torch.observability import metrics as _metrics
from horovod_tpu_torch.observability import reqtrace as _reqtrace
from horovod_tpu_torch.resilience import chaos as _chaos
from horovod_tpu_torch.serving.scheduler import (
    ContinuousBatchingScheduler,
    QueueFull,
    Request,
)

__all__ = [
    "InferenceEngine",
    "note_subscriber_health",
    "PAGE_SIZE_ENV",
    "PAGES_ENV",
    "MAX_BATCH_ENV",
    "PREFILL_CHUNK_ENV",
    "MAX_QUEUE_ENV",
    "PREFIX_CACHE_ENV",
    "SPEC_LOOKAHEAD_ENV",
    "SPEC_DRAFT_DEPTH_ENV",
    "TP_AXIS_ENV",
]

logger = logging.getLogger("horovod_tpu_torch.serving")

PAGE_SIZE_ENV = "HOROVOD_ENGINE_PAGE_SIZE"
PAGES_ENV = "HOROVOD_ENGINE_PAGES"
MAX_BATCH_ENV = "HOROVOD_ENGINE_MAX_BATCH"
PREFILL_CHUNK_ENV = "HOROVOD_ENGINE_PREFILL_CHUNK"
MAX_QUEUE_ENV = "HOROVOD_ENGINE_MAX_QUEUE"
#: "1" (default) aliases cached prompt pages at admission; "0" disables
PREFIX_CACHE_ENV = "HOROVOD_PREFIX_CACHE"
#: draft tokens proposed per speculative iteration (>= 1)
SPEC_LOOKAHEAD_ENV = "HOROVOD_SPEC_LOOKAHEAD"
#: transformer blocks in the derived draft model; 0 (default) = no
#: draft, speculative decoding off
SPEC_DRAFT_DEPTH_ENV = "HOROVOD_SPEC_DRAFT_DEPTH"
#: mesh axis name to tensor-parallel the serving path over (unset = off)
TP_AXIS_ENV = "HOROVOD_TP_AXIS"


def _env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, str(default)))


def note_subscriber_health(sub) -> None:
    """Publish the serving-side staleness view and feed the health plane:
    ``serving_subscriber_lag`` / ``serving_staleness_seconds`` gauges,
    and a ``stale()`` subscriber flips ``/health`` to 503 with the lag in
    the reason (:func:`horovod_tpu_torch.resilience.health.
    record_serving_stale`) until the weights are fresh again."""
    from horovod_tpu_torch.resilience import health as _health

    lag = sub.lag()
    age = sub.staleness_seconds()
    if _metrics.enabled():
        _metrics.gauge(
            "serving_subscriber_lag",
            help="generations between the observed head and what the "
                 "engine serves",
        ).set(lag)
        if age is not None:
            _metrics.gauge(
                "serving_staleness_seconds",
                help="wall-clock age of the weights the engine serves",
            ).set(age)
    if sub.stale():
        _health.record_serving_stale(lag, age)
    else:
        _health.record_serving_fresh()


class _Arm:
    def __init__(self, generation: int, params: Any):
        self.generation = generation
        self.params = params
        self.draining = False


class InferenceEngine:
    """Serve a :class:`~horovod_tpu_torch.models.transformer.TransformerLM`
    under continuous batching on a paged KV cache.

    ``model`` gives the configuration (its own parameters are not used);
    weights arrive via :meth:`set_weights` (or :meth:`poll_weights` from
    an attached subscriber); requests via :meth:`submit`; :meth:`step`
    runs one iteration boundary (admission → chunked prefill →
    speculative pass → batched decode) and :meth:`run_until_idle` drains
    everything queued. :attr:`pass_seconds` sums the host seconds of the
    passes that ran, by kind (``prefill``, ``spec``, ``decode``); a pass
    ends in the host read of the logits rows it consumes, so its seconds
    span its device work.

    Greedy decoding through this engine is token-identical to
    :func:`horovod_tpu_torch.models.transformer.generate` for any ragged
    batch and any join/leave order, and to the JAX package's engine on
    the same weights (up to ties the two frameworks' sums break
    differently).
    """

    def __init__(self, model, *, page_size: Optional[int] = None,
                 num_pages: Optional[int] = None,
                 max_batch: Optional[int] = None,
                 prefill_chunk: Optional[int] = None,
                 max_queue: Optional[int] = None,
                 max_seq_len: Optional[int] = None,
                 subscriber=None, eos_token: Optional[int] = None,
                 prefix_cache: Optional[bool] = None,
                 draft_model=None,
                 draft_depth: Optional[int] = None,
                 spec_lookahead: Optional[int] = None,
                 tp_axis: Optional[str] = None,
                 device=None):
        from horovod_tpu_torch.basics import default_device
        from horovod_tpu_torch.models.transformer import TransformerLM

        self.device = default_device(device)
        self._model = model
        self.page_size = int(page_size if page_size is not None
                             else _env_int(PAGE_SIZE_ENV, 16))
        self.num_pages = int(num_pages if num_pages is not None
                             else _env_int(PAGES_ENV, 64))
        self.max_batch = int(max_batch if max_batch is not None
                             else _env_int(MAX_BATCH_ENV, 4))
        self.prefill_chunk = int(
            prefill_chunk if prefill_chunk is not None
            else _env_int(PREFILL_CHUNK_ENV, 16))
        max_queue = int(max_queue if max_queue is not None
                        else _env_int(MAX_QUEUE_ENV, 64))
        self.max_seq_len = int(max_seq_len if max_seq_len is not None
                               else model.max_len)
        if self.max_seq_len > model.max_len:
            raise ValueError(
                f"max_seq_len {self.max_seq_len} exceeds the model's "
                f"max_len {model.max_len}")
        # per-slot page budget, with the capacity rounded up to a whole
        # number of prefill chunks: prefill chunk starts are multiples of
        # prefill_chunk, so a chunk's masked pad tail can never be clamped
        # back INTO the slot's real pages (it either lands at positions the
        # next real write overwrites, or past the row's final frontier
        # where the causal mask hides it)
        pages = -(-self.max_seq_len // self.page_size)
        while (pages * self.page_size) % self.prefill_chunk:
            pages += 1
        self.pages_per_seq = pages
        if self.pages_per_seq > self.num_pages - 1:
            raise ValueError(
                f"page pool too small: one sequence can need "
                f"{self.pages_per_seq} pages, pool has "
                f"{self.num_pages - 1} allocatable (raise {PAGES_ENV} or "
                f"lower max_seq_len)")
        # tensor-parallel serving: each rank of the axis holds its weight
        # slices and its head block of the page pools; per-head attention
        # needs no cross-rank reduction, a block two psums
        self.tp_axis = (tp_axis if tp_axis is not None
                        else os.environ.get(TP_AXIS_ENV, "").strip() or None)
        self._tp = 1
        self._tp_rank = 0
        if self.tp_axis:
            from horovod_tpu_torch.parallel.mesh import current_mesh

            mesh = current_mesh()
            if self.tp_axis not in mesh.shape:
                raise ValueError(
                    f"tp_axis {self.tp_axis!r} is not an axis of the "
                    f"active mesh (axes: {tuple(mesh.shape)})")
            tp = mesh.shape[self.tp_axis]
            h_kv = model.kv_heads or model.heads
            if model.heads % tp or h_kv % tp:
                raise ValueError(
                    f"heads={model.heads} / kv_heads={h_kv} not divisible "
                    f"by tp axis {self.tp_axis!r} size {tp}")
            self._tp = tp
            self._tp_rank = mesh.axis_index(self.tp_axis)
        self.prefix_caching = bool(
            prefix_cache if prefix_cache is not None
            else _env_int(PREFIX_CACHE_ENV, 1))
        self._sched = ContinuousBatchingScheduler(
            num_pages=self.num_pages, page_size=self.page_size,
            max_batch=self.max_batch, pages_per_seq=self.pages_per_seq,
            max_queue=max_queue, prefill_chunk=self.prefill_chunk,
            prefix_cache=self.prefix_caching,
            namespace_of=self._arm_namespace)
        self._subscriber = subscriber
        self.eos_token = eos_token
        # fleet-tier identity: set by FleetReplica so chaos charges can
        # target one replica (``slow_decode=<s>:<arm>@<replica>``) and
        # reqtrace can attribute spans to the engine that served them
        self.replica: Optional[str] = None
        self._arms: Dict[str, _Arm] = {}
        self._drain_seq = 0
        # the forward: one parameterless twin of the model, its weights
        # an argument (functional_call)
        self._dec = TransformerLM(**model.config(), device="meta")
        self._cache = None  # built on the first weights
        self._step_count = 0
        self.pass_seconds: Dict[str, float] = {}

        # --- speculative decoding: the default draft is the target
        # truncated to its first `draft_depth` blocks — block names are
        # positional (`block0`..`block{d-1}`), so the draft's parameters
        # are a pure SUBSET of every published tree and a new generation
        # fences draft + target together for free.
        self.spec_lookahead = int(
            spec_lookahead if spec_lookahead is not None
            else _env_int(SPEC_LOOKAHEAD_ENV, 4))
        d = int(draft_depth if draft_depth is not None
                else _env_int(SPEC_DRAFT_DEPTH_ENV, 0))
        self._draft_dec = None
        if draft_model is not None:
            self._draft_dec = TransformerLM(**draft_model.config(),
                                            device="meta")
        elif d > 0:
            if d > int(model.depth):
                raise ValueError(
                    f"draft_depth {d} exceeds the target model's depth "
                    f"{model.depth}")
            self._draft_dec = TransformerLM(**model.config(depth=d),
                                            device="meta")
        if self._draft_dec is not None and self.tp_axis:
            raise ValueError("speculative decoding under tp_axis is not "
                             "supported: the draft is a dense model")
        self._draft_arms: Dict[str, _Arm] = {}
        self._draft_cache = None
        if self._draft_dec is not None and self.spec_lookahead < 1:
            raise ValueError(
                f"spec_lookahead must be >= 1 with a draft model, "
                f"got {self.spec_lookahead}")

    # ------------------------------------------------------------- weights

    def _arm_namespace(self, arm: str) -> Optional[int]:
        """Prefix-cache namespace for `arm`: the weight generation its
        sequences decode under. Cached KV is only reusable under the
        exact weights that wrote it — aliasing across generations would
        silently mix models. None (arm not installed) disables caching
        for the request."""
        a = self._arms.get(arm)
        return None if a is None else int(a.generation)

    def _weights(self, module, flat: dict) -> dict:
        """``flat`` (flax paths) as ``module``'s parameters on the
        engine's device, owned, Dense kernels and embedding tables
        already in the compute dtype (what each forward would cast them
        to)."""
        from horovod_tpu_torch.models.convert import torch_weights
        from horovod_tpu_torch.models.layers import Dense, Embed

        w = torch_weights(module, flat, self.device)
        lowp = {f"{name}.{p}" for name, m in module.named_modules()
                if isinstance(m, (Dense, Embed))
                for p, _ in m.named_parameters(recurse=False)}
        # owned copies: a leaf may be a live training parameter
        return {k: v.to(module.dtype, copy=True) if k in lowp
                else v.clone() for k, v in w.items()}

    def _draft_subset(self, weights: dict) -> dict:
        """The draft's parameters out of a target parameter dict (shared
        tensors: the names are the same)."""
        out = {}
        for name, p in self._draft_dec.named_parameters():
            w = weights.get(name)
            if w is None or tuple(w.shape) != tuple(p.shape):
                raise ValueError(
                    f"draft parameter {name!r} expects shape "
                    f"{tuple(p.shape)}, the tree carries "
                    f"{None if w is None else tuple(w.shape)} — the draft "
                    f"must be a truncation of the target")
            out[name] = w
        return out

    def set_weights(self, tree: Any, *, generation: int = 0,
                    arm: str = "stable") -> None:
        """Install a weight tree for `arm` (moved to the engine's device
        once here, not per step). Trees shaped like a loop state
        (``{"params": ...}``) are unwrapped the same way the publisher's
        ``extract`` does."""
        from horovod_tpu_torch.serving.publisher import default_extract

        flat = flatten_tree(default_extract(tree))
        if self.tp_axis:
            params = self._tp_place_params(flat)
        else:
            params = self._weights(self._dec, flat)
        self._park_if_busy(arm)
        self._arms[arm] = _Arm(int(generation), params)
        if self._cache is None:
            self._cache = self._dec.paged_cache(
                self.num_pages, self.page_size, self.device,
                heads_div=self._tp)
        if self._draft_dec is not None:
            # draft rides the same chain: every published generation
            # derives its draft at install time, so draft and target
            # can never be fenced apart by the rollout state machine
            self._draft_arms[arm] = _Arm(int(generation),
                                         self._draft_subset(params))
            self._init_draft_cache()
        if _metrics.enabled():
            _metrics.gauge(
                "serving_engine_generation",
                help="weight generation each rollout arm serves",
                arm=arm,
            ).set(int(generation))

    def set_draft_weights(self, tree: Any, *, generation: int = 0,
                          arm: str = "stable") -> None:
        """Install draft params for `arm` explicitly (callers publishing
        the draft separately). Speculative decoding only runs while the
        draft's generation matches the target arm's — a lagging draft
        falls back to plain decode rather than ever verifying a canary
        against stale proposals."""
        from horovod_tpu_torch.serving.publisher import default_extract

        if self._draft_dec is None:
            raise ValueError(
                "engine has no draft model (set draft_depth or "
                f"{SPEC_DRAFT_DEPTH_ENV})")
        flat = flatten_tree(default_extract(tree))
        keys = set(self._draft_dec.jax_params())
        missing = sorted(keys - set(flat))
        if missing:
            raise ValueError(
                f"draft model needs parameters {missing[:3]} the tree does "
                f"not carry — the draft must be a truncation of the target")
        self._draft_arms[arm] = _Arm(
            int(generation),
            self._weights(self._draft_dec, {k: flat[k] for k in keys}))
        self._init_draft_cache()

    def _init_draft_cache(self) -> None:
        if self._draft_cache is None:
            self._draft_cache = self._draft_dec.paged_cache(
                self.num_pages, self.page_size, self.device)

    def arm_generation(self, arm: str) -> Optional[int]:
        a = self._arms.get(arm)
        return None if a is None else a.generation

    def arm_params(self, arm: str) -> Optional[Any]:
        a = self._arms.get(arm)
        return None if a is None else a.params

    def _park_if_busy(self, arm: str) -> None:
        """An arm being replaced while it still has in-flight sequences
        parks its old params under a private drain label — a sequence's
        KV cache was built under its weights, so swapping them mid-decode
        would emit incoherent tokens. The parked arm releases itself at
        the step boundary its last sequence finishes."""
        old = self._arms.get(arm)
        if old is None or not self._sched.active(arm):
            return
        self._drain_seq += 1  # unique label even if the same (arm,
        # generation) parks twice across vetoes
        label = f"{arm}-drain-{self._drain_seq}-g{old.generation}"
        old.draining = True
        self._arms[label] = old
        # the draft parks alongside its target: draining sequences keep
        # speculating on the generation they decode under
        od = self._draft_arms.get(arm)
        if od is not None:
            self._draft_arms[label] = od
        moved = self._sched.move_active_to_drain(arm, label)
        logger.info(
            "arm %r replaced with %d sequence(s) in flight; draining "
            "them on generation %d as %r", arm, moved, old.generation,
            label)

    def promote_canary(self) -> None:
        """Canary becomes stable (the rollout controller's promotion).
        In-flight canary sequences are relabeled — the params they decode
        against ARE the promoted ones, so their tokens are unaffected and
        they must not be stranded on an arm that no longer exists. The
        OLD stable arm's in-flight sequences keep their own weights: they
        park under a drain label and finish coherently."""
        arm = self._arms.pop("canary", None)
        if arm is None:
            return
        darm = self._draft_arms.pop("canary", None)
        self._park_if_busy("stable")
        arm.draining = False
        self._arms["stable"] = arm
        if darm is not None:
            self._draft_arms["stable"] = darm
        else:
            # the promoted generation has no draft: leaving the old
            # stable draft behind would fence-fail anyway; drop it
            self._draft_arms.pop("stable", None)
        self._sched.relabel_arm("canary", "stable")
        if _metrics.enabled():
            _metrics.gauge(
                "serving_engine_generation",
                help="weight generation each rollout arm serves",
                arm="stable",
            ).set(arm.generation)

    def retire_arm(self, arm: str) -> None:
        """Stop routing to `arm` but keep its params until every in-flight
        sequence on it finished — a rollback never drops work mid-decode.
        Requests still *queued* for the arm have produced no tokens yet,
        so they simply re-route to stable."""
        a = self._arms.get(arm)
        if a is not None:
            a.draining = True
        if arm != "stable":
            self._sched.relabel_queued_only(arm, "stable")

    def poll_weights(self) -> Optional[int]:
        """Standalone (no rollout controller) weight refresh: poll the
        attached subscriber into the stable arm and feed the health
        plane. Returns the new generation when one arrived."""
        if self._subscriber is None:
            return None
        fresh = self._subscriber.poll()
        note_subscriber_health(self._subscriber)
        if fresh is None:
            return None
        gen = self._subscriber.generation
        self.set_weights(fresh, generation=gen, arm="stable")
        return gen

    # ----------------------------------------------------- tensor parallel

    def _tp_place_params(self, flat: dict) -> dict:
        """This rank's slices of a flax-path tree by
        :func:`~horovod_tpu_torch.models.transformer.transformer_param_specs`
        (qkv/``q_proj``/``kv_proj``/mlp_up column-split, proj/mlp_down
        row-split, the embedding tables and lm_head on their feature and
        vocabulary dims), in the compute dtype except the LayerNorms and
        the learned position table. A spec'd dim the axis size does not
        divide stays whole (replicated), as in the JAX package. The fused
        ``qkv`` (``[q | k | v]``) and ``kv_proj`` (``[k | v]``) kernels are
        sliced per third (half), head-aligned. Kernels are held in
        PyTorch's ``[out, in]`` layout, as the dense model's Dense layers
        hold them."""
        from horovod_tpu_torch.models.transformer import (
            transformer_param_specs,
        )
        from horovod_tpu_torch.serving.protocol import _tensor

        n, r, m = self._tp, self._tp_rank, self._model
        dt = m.dtype
        leaves = {k: _tensor(v, self.device) for k, v in flat.items()}
        specs = transformer_param_specs(leaves)
        out = {}
        for k, x in leaves.items():
            dim = specs[k]
            if dim is not None and x.shape[dim] % n:
                dim = None
            parts = 1
            if k.endswith("qkv/kernel"):
                parts = 3
            elif k.endswith("kv_proj/kernel"):
                parts = 2
            elif k.endswith("mlp_up/bias"):
                dim = 0               # the column split's bias
            if dim is not None:
                w = x.shape[dim] // (n * parts)
                x = torch.cat([x.narrow(dim, j * n * w + r * w, w)
                               for j in range(parts)], dim=dim)
            if "/ln" not in k and not k.startswith("ln") \
                    and k != "pos_embed":
                x = x.to(dt)
            if k.endswith("/kernel"):
                x = x.t()             # PyTorch's [out, in], as Dense holds it
            # owned copies: a leaf may be a live training parameter
            out[k] = x.contiguous().clone()
        out["_sharded"] = {k: specs[k] is not None
                           and flat[k].shape[specs[k]] % n == 0
                           for k in ("tok_embed/embedding", "lm_head/kernel",
                                     "pos_embed") if k in specs}
        return out

    def _gather_last(self, x):
        """All-gather ``x``'s last dim over the tp axis (rank order)."""
        import torch.distributed as dist

        from horovod_tpu_torch.parallel.mesh import current_mesh

        x = x.contiguous()
        buf = torch.empty((self._tp * x.shape[0], *x.shape[1:]),
                          dtype=x.dtype, device=x.device)
        # the renamed pair: all_gather_single where this torch has it
        name = ("all_gather_single" if hasattr(dist, "all_gather_single")
                else "all_gather_into_tensor")
        getattr(dist, name)(buf, x, group=current_mesh().group(self.tp_axis))
        buf = buf.reshape(self._tp, *x.shape)
        return torch.movedim(buf, 0, -2).reshape(*x.shape[:-1], -1)

    def _tp_block(self, p: dict, i: int, x, positions, table, cache):
        """One decode block on this rank's slices: attention over its
        head block, then ``psum`` #1 after the row-split projection and
        ``psum`` #2 after the row-split mlp_down (its replicated bias
        added once, after the sum)."""
        from horovod_tpu_torch.models.transformer import apply_rope, write_cache
        from horovod_tpu_torch.ops.flash_attention import (
            tp_paged_decode_attention,
        )
        from horovod_tpu_torch.parallel import spmd

        m, n = self._model, self._tp
        dt, pre = m.dtype, f"block{i}/"
        b, t = x.shape[:2]
        hd = m.dim // m.heads
        h_loc, hkv_loc = m.heads // n, (m.kv_heads or m.heads) // n
        h = layer_norm(x, p[pre + "ln1/scale"], p[pre + "ln1/bias"], dt)
        if pre + "qkv/kernel" in p:
            q, k, v = F.linear(h, p[pre + "qkv/kernel"]).split(h_loc * hd,
                                                               dim=-1)
        else:
            q = F.linear(h, p[pre + "q_proj/kernel"])
            k, v = F.linear(h, p[pre + "kv_proj/kernel"]).split(
                hkv_loc * hd, dim=-1)
        q = q.reshape(b, t, h_loc, hd)
        k = k.reshape(b, t, hkv_loc, hd)
        v = v.reshape(b, t, hkv_loc, hd)
        if m.use_rope:
            q = apply_rope(q, positions, base=m.rope_base)
            k = apply_rope(k, positions, base=m.rope_base)
        start = write_cache(cache, k, v, positions, table)
        att = tp_paged_decode_attention(
            q, cache[0], cache[1], table, start, page_size=self.page_size,
            axis=self.tp_axis)
        x = x + spmd.psum(F.linear(att.reshape(b, t, -1),
                                   p[pre + "proj/kernel"]), self.tp_axis)
        h = layer_norm(x, p[pre + "ln2/scale"], p[pre + "ln2/bias"], dt)
        h = F.gelu(F.linear(h, p[pre + "mlp_up/kernel"],
                            p[pre + "mlp_up/bias"]), approximate="tanh")
        down = spmd.psum(F.linear(h, p[pre + "mlp_down/kernel"]),
                         self.tp_axis)
        return x + (down + p[pre + "mlp_down/bias"])

    def _tp_forward(self, p: dict, tokens, positions, table, cache):
        m = self._model
        dt = m.dtype
        sharded = p["_sharded"]
        x = F.embedding(tokens, p["tok_embed/embedding"])
        if not m.use_rope:
            pos = p["pos_embed"][positions.clamp(0, m.max_len - 1)].to(dt)
            if sharded.get("tok_embed/embedding") != sharded.get("pos_embed"):
                raise ValueError("tok_embed and pos_embed must both split "
                                 "(or neither) over the tp axis")
            x = x + pos
        if sharded.get("tok_embed/embedding"):
            x = self._gather_last(x)
        for i in range(m.depth):
            x = self._tp_block(p, i, x, positions, table, cache[i])
        h = layer_norm(x, p["ln_f/scale"], p["ln_f/bias"], dt)
        logits = F.linear(h, p["lm_head/kernel"])
        if sharded.get("lm_head/kernel"):
            logits = self._gather_last(logits)
        return logits.float()

    # ------------------------------------------------------------ requests

    def submit(self, req_or_prompt, max_new_tokens: Optional[int] = None,
               *, rid=None, temperature: float = 0.0,
               arm: str = "stable") -> Request:
        """Queue a request (a prebuilt :class:`Request` or a prompt
        array). Raises :class:`QueueFull` under admission backpressure and
        ``ValueError`` for prompts that can never fit one sequence's page
        budget."""
        if isinstance(req_or_prompt, Request):
            req = req_or_prompt
        else:
            if max_new_tokens is None:
                raise ValueError("submit(prompt) needs max_new_tokens")
            req = Request(
                rid if rid is not None else f"req-{id(req_or_prompt)}",
                req_or_prompt, max_new_tokens, temperature=temperature,
                arm=arm)
        total = req.prompt.size + req.max_new_tokens
        if total > self.max_seq_len:
            raise ValueError(
                f"request {req.rid!r}: prompt + max_new_tokens = {total} "
                f"exceeds max_seq_len {self.max_seq_len}")
        self._sched.submit(req)
        return req

    @property
    def scheduler(self) -> ContinuousBatchingScheduler:
        return self._sched

    # ---------------------------------------------------------- iteration

    def step(self) -> bool:
        """One iteration boundary: chaos intake → admission → one chunked
        prefill pass, one speculative pass, and one decode pass per
        active arm. Returns True when any compute ran (False = fully
        idle)."""
        self._step_count += 1
        self._chaos_burst()
        if _chaos.take_cache_evict(self._step_count):
            victims, dropped = self._sched.chaos_evict()
            logger.warning(
                "chaos cache_evict at pass %d: dropped %d cached "
                "page(s), %d victim sequence(s) re-prefilling",
                self._step_count, dropped, victims)
        if not self._arms:
            return False  # no weights yet; requests keep queueing
        self._sched.admit()
        ran = False
        for arm in self._sched.arms_active():
            a = self._arms.get(arm)
            if a is None:
                for seq in self._sched.active(arm):
                    self._sched.finish(
                        seq, error=f"no weights for arm {arm!r}")
                continue
            t0 = time.perf_counter()
            ran |= self._clock("prefill", t0, self._prefill_pass(arm, a))
            t0 = time.perf_counter()
            handled = self._spec_pass(arm, a)
            ran |= self._clock("spec", t0, bool(handled))
            t0 = time.perf_counter()
            ran |= self._clock("decode", t0, self._decode_pass(
                arm, a, exclude=handled))
        # a retired arm with nothing left in flight releases its params
        for name in [n for n, a in self._arms.items() if a.draining]:
            if not self._sched.active(name):
                del self._arms[name]
                self._draft_arms.pop(name, None)
        return ran

    def _clock(self, kind: str, t0: float, ran: bool) -> bool:
        """Add the pass begun at ``t0`` to :attr:`pass_seconds` if it
        ran; returns ``ran``."""
        if ran:
            self.pass_seconds[kind] = self.pass_seconds.get(kind, 0.0) + (
                time.perf_counter() - t0)
        return ran

    def run_until_idle(self, max_iters: int = 10000) -> None:
        """Drive :meth:`step` until queue and slots are empty (tests and
        batch-style callers); raises past `max_iters` instead of spinning
        forever on a scheduling bug."""
        for _ in range(max_iters):
            if self._sched.idle():
                return
            if not self._arms:
                raise RuntimeError(
                    "engine has work queued but no weights installed — "
                    "call set_weights() or poll_weights() first")
            self.step()
        raise RuntimeError(
            f"engine did not drain within {max_iters} iterations")

    def _chaos_burst(self) -> None:
        """``HOROVOD_CHAOS=request_burst=N``: N synthetic requests slam
        the queue at one iteration boundary — the deterministic
        queue-overflow drill. Rejections are the point; they are counted
        by admission control."""
        n = _chaos.take_request_burst()
        for i in range(n):
            try:
                self.submit(
                    Request(f"chaos-burst-{i}", [1, 1], 1))
            except (QueueFull, ValueError) as e:
                logger.debug("chaos burst request rejected: %s", e)

    # ------------------------------------------------------------- passes

    def _maybe_slow(self, arm: str) -> None:
        """``HOROVOD_CHAOS=slow_decode=<s>[:<arm>[@<replica>]]``: sleep
        before this pass when the charge targets `arm` (drain labels
        inherit their source arm's scope) and, when a ``@<replica>``
        suffix is present, only on the engine whose fleet ``replica`` id
        matches. Host-side only: tokens are unaffected, so a drill keeps
        token parity with a clean run."""
        charge = _chaos.slow_decode()
        if charge is None:
            return
        secs, target = charge
        if secs <= 0:
            return
        if target is not None:
            base, _, rep = target.partition("@")
            if rep and rep != (self.replica or ""):
                return
            if (base and arm != base
                    and not arm.startswith(f"{base}-drain")):
                return
        _chaos.record_injection("slow_decode")
        time.sleep(secs)

    def _forward(self, module, params, cache, tokens, positions, table):
        """One forward of the paged decode model on the engine's device:
        logits ``[b, T, vocab]`` (f32), the cache written in place."""
        dev = self.device
        tok = torch.from_numpy(tokens).to(dev, torch.int64)
        pos = torch.from_numpy(positions).to(dev, torch.int64)
        tab = torch.from_numpy(table).to(dev, torch.int64)
        with torch.no_grad():
            if self.tp_axis:
                return self._tp_forward(params, tok, pos, tab, cache)
            return torch.func.functional_call(
                module, params, (tok, pos), {"cache": cache,
                                             "page_table": tab})

    def _count(self, kind: str) -> None:
        if _metrics.enabled():
            _metrics.counter(
                "serving_engine_steps",
                help="engine forward passes, by phase",
                kind=kind,
            ).inc()

    def _run(self, params, tokens, positions, table, kind: str):
        logits = self._forward(self._dec, params, self._cache, tokens,
                               positions, table)
        self._count(kind)
        return logits

    def _run_draft(self, params, tokens, positions, table, kind: str):
        logits = self._forward(self._draft_dec, params, self._draft_cache,
                               tokens, positions, table)
        self._count(kind)
        return logits

    @staticmethod
    def _rows(logits, slots, ts=None) -> np.ndarray:
        """The consumed logits rows on the host: ``logits[slots, ts]``
        (``ts`` None: every position of each slot)."""
        idx = torch.as_tensor(slots, device=logits.device)
        if ts is None:
            return logits[idx].cpu().numpy()
        return logits[idx, torch.as_tensor(ts, device=logits.device)] \
            .cpu().numpy()

    def _prefill_pass(self, arm: str, a: _Arm) -> bool:
        rows = [s for s in self._sched.active(arm) if s.prefilling]
        if not rows:
            return False
        self._maybe_slow(arm)
        t0 = time.monotonic()
        b, c = self.max_batch, self.prefill_chunk
        tokens = np.zeros((b, c), np.int32)
        positions = np.zeros((b, c), np.int32)
        table = np.zeros((b, self.pages_per_seq), np.int32)  # trash rows
        real_table = self._sched.page_table_rows()
        rems: List[int] = []
        for s in rows:
            # prefill_src is the prompt, or prompt + replayed generated
            # tokens after a forced cache eviction; a prefix-cache hit
            # pre-advanced done_prompt past the aliased pages
            rem = min(c, s.prefill_len - s.done_prompt)
            tokens[s.slot, :rem] = s.prefill_src[
                s.done_prompt:s.done_prompt + rem]
            positions[s.slot] = s.done_prompt + np.arange(c, dtype=np.int32)
            table[s.slot] = real_table[s.slot]
            rems.append(rem)
        logits = self._run(a.params, tokens, positions, table, "prefill")
        da = self._draft_arms.get(arm)
        if da is not None:
            # mirror the writes into the draft cache so proposals can
            # attend to the prompt (same tokens, positions, tables)
            self._run_draft(da.params, tokens, positions, table,
                            "draft_prefill")
        if _metrics.enabled():
            _metrics.counter(
                "serving_prefill_tokens",
                help="prompt tokens written to the paged cache",
            ).inc(sum(rems))
        # the row's first sampled token comes from ITS last real position
        # in this chunk, exactly like generate()'s last-logits gather. A
        # replay (post-eviction rebuild) with tokens already sampled
        # consumes nothing: its next token resumes from last_token in the
        # decode pass.
        done = [(s, rem) for s, rem in zip(rows, rems)
                if s.done_prompt + rem >= s.prefill_len and not s.generated]
        pulled = (self._rows(logits, [s.slot for s, _ in done],
                             [rem - 1 for _, rem in done]) if done else [])
        first = {id(s): row for (s, _), row in zip(done, pulled)}
        for s, rem in zip(rows, rems):
            s.done_prompt += rem
            _reqtrace.on_prefill_chunk(s, rem, t0, a.generation)
            if id(s) in first:
                self._consume_logits(s, first[id(s)], a.generation)
        return True

    def _spec_pass(self, arm: str, a: _Arm) -> set:
        """Speculative decode for every eligible row: the draft proposes
        ``spec_lookahead`` greedy tokens (K single-token forwards on its
        own paged cache), the target verifies all of them in ONE
        ``[b, K+1]`` forward, and the longest agreeing prefix plus the
        target's own next token are emitted. Greedy acceptance makes the
        emitted stream token-identical to sequential decode: every
        emitted token is the target's argmax given exactly the tokens
        before it. A rejected tail costs nothing to roll back — its KV
        sits past the row's frontier, where paged_decode_attention zeroes
        before the matmuls, and the next writes overwrite it.

        Eligible: greedy rows with at least K+1 tokens of budget left
        (the verify forward must stay inside the page reservation), on
        an arm whose draft generation MATCHES the target's. Returns the
        ids of handled sequences."""
        handled: set = set()
        if self._draft_dec is None:
            return handled
        da = self._draft_arms.get(arm)
        if da is None or da.generation != a.generation:
            return handled
        K = self.spec_lookahead
        rows = [s for s in self._sched.active(arm)
                if not s.prefilling and s.last_token is not None
                and s.req.temperature <= 0.0
                and s.req.max_new_tokens - len(s.generated) >= K + 1]
        if not rows:
            return handled
        self._maybe_slow(arm)
        b = self.max_batch
        real_table = self._sched.page_table_rows()
        table = np.zeros((b, self.pages_per_seq), np.int32)
        base: Dict[int, int] = {}
        for s in rows:
            table[s.slot] = real_table[s.slot]
            base[id(s)] = s.length
        slots = [s.slot for s in rows]
        # --- proposal: K sequential draft forwards (writes the draft's
        # own KV as it goes, so token j attends to tokens < j)
        drafts = np.zeros((b, K), np.int32)
        cur = np.zeros((b, 1), np.int32)
        pos = np.zeros((b, 1), np.int32)
        for s in rows:
            cur[s.slot, 0] = s.last_token
            pos[s.slot, 0] = base[id(s)]
        for j in range(K + 1):
            dl = self._run_draft(da.params, cur, pos, table,
                                 "draft_propose")
            # the K+1'th forward only WRITES d_K's draft KV (logits
            # unused): on full acceptance the next round's frontier sits
            # past it, and a draft cache hole there would desync the
            # draft from the target
            if j < K:
                got = self._rows(dl, slots, [0] * len(slots))
                for s, row in zip(rows, got):
                    nxt = int(np.argmax(row))
                    drafts[s.slot, j] = nxt
                    cur[s.slot, 0] = nxt
            pos = pos + 1
        # --- verify: ONE batched [b, K+1] target forward over
        # [last_token, d_1 .. d_K]; row i's logits are the target's
        # next-token distribution after the first i+1 of those
        vtok = np.zeros((b, K + 1), np.int32)
        vpos = np.zeros((b, K + 1), np.int32)
        for s in rows:
            vtok[s.slot, 0] = s.last_token
            vtok[s.slot, 1:] = drafts[s.slot]
            vpos[s.slot] = base[id(s)] + np.arange(K + 1, dtype=np.int32)
        logits = self._run(a.params, vtok, vpos, table, "spec_verify")
        verify = self._rows(logits, slots)
        for s, row in zip(rows, verify):
            handled.add(id(s))
            m = 0
            while (m < K and np.all(np.isfinite(row[m]))
                   and int(np.argmax(row[m])) == int(drafts[s.slot, m])):
                m += 1
            # emit the m accepted tokens plus the target's bonus token
            # at the first divergence (sequential-greedy semantics: stop
            # early if the sequence finishes on budget/EOS/non-finite)
            for i in range(m + 1):
                self._consume_logits(s, row[i], a.generation)
                if s.req.done:
                    break
            if _metrics.enabled():
                _metrics.counter(
                    "spec_proposed",
                    help="draft tokens proposed to the target verifier",
                ).inc(K)
                _metrics.counter(
                    "spec_accepted",
                    help="draft tokens the target verifier accepted",
                ).inc(m)
                if m < K:
                    _metrics.counter(
                        "spec_rollbacks",
                        help="speculative iterations whose tail was "
                             "rejected (frontier rolled back)",
                    ).inc()
            _reqtrace.on_spec_verify(s, K, m, a.generation)
        return handled

    def _decode_pass(self, arm: str, a: _Arm,
                     exclude: Optional[set] = None) -> bool:
        rows = [s for s in self._sched.active(arm)
                if not s.prefilling and s.last_token is not None
                and (exclude is None or id(s) not in exclude)]
        if not rows:
            return False
        self._maybe_slow(arm)
        b = self.max_batch
        tokens = np.zeros((b, 1), np.int32)
        positions = np.zeros((b, 1), np.int32)
        table = np.zeros((b, self.pages_per_seq), np.int32)
        real_table = self._sched.page_table_rows()
        for s in rows:
            tokens[s.slot, 0] = s.last_token
            positions[s.slot, 0] = s.length
            table[s.slot] = real_table[s.slot]
        logits = self._run(a.params, tokens, positions, table, "decode")
        got = self._rows(logits, [s.slot for s in rows], [0] * len(rows))
        for s, row in zip(rows, got):
            self._consume_logits(s, row, a.generation)
        return True

    def _consume_logits(self, s, row_logits: np.ndarray,
                        generation: int = -1) -> None:
        """Sample one token for `s` from its ``[vocab]`` logits row (on
        the host) and retire the sequence when it is done (budget
        reached, EOS, or non-finite logits — the canary regression
        signal)."""
        if not np.all(np.isfinite(row_logits)):
            self._sched.finish(seq=s, error="non-finite logits")
            return
        first = not s.generated
        tok = s.sample(row_logits)
        s.generated.append(tok)
        s.last_token = tok
        # TTFT closes on the first sampled token; every later one is a
        # TPOT cadence point — tagged with the weight generation that
        # actually decoded it, so gate windows never mix generations
        if first:
            _reqtrace.on_first_token(s, generation)
        else:
            _reqtrace.on_token(s, generation)
        if _metrics.enabled():
            _metrics.counter(
                "serving_tokens_generated",
                help="tokens sampled by the engine",
            ).inc()
        if (len(s.generated) >= s.req.max_new_tokens
                or (self.eos_token is not None and tok == self.eos_token)):
            self._sched.finish(seq=s)
