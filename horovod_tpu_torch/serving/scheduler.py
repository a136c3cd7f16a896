"""Continuous-batching request scheduler and paged KV-cache allocator.

Counterpart of ``horovod_tpu/serving/scheduler.py`` (stdlib + numpy, the
same decisions on the same request trace).

The scheduling model is Orca's iteration-level scheduling (Yu et al.,
OSDI '22) over vLLM-style paged memory (Kwon et al., SOSP '23), sized for
determinism rather than peak throughput:

- Requests queue FIFO; a full queue rejects at :meth:`submit` — the
  admission-control backpressure the ``request_burst`` chaos charge
  exercises.
- A sequence joins the batch at any iteration boundary: admission takes a
  free batch **slot** plus a *conservative* page reservation — every page
  the sequence could ever need (``ceil((prompt + max_new) / page_size)``)
  is claimed up front, so an admitted sequence can never be evicted
  mid-flight and the page pool can never over-commit. When the head of
  the queue does not fit, admission stops (head-of-line, deterministic)
  and the queue depth is the backpressure signal.
- A finished sequence frees its slot and pages at the same boundary it
  finishes — the next admission sees them immediately.

Page 0 of the pool is the **trash page**: batch rows that are inactive in
a given compiled step (empty slots, rows in the other rollout arm, the
masked tail of a ragged prefill chunk) route their cache writes there via
an all-zero page table, keeping every shape static without a write mask.
Nothing ever reads it — the causal mask in
:func:`horovod_tpu_torch.ops.flash_attention.decode_attention` makes positions
past a row's frontier unobservable.

**Automatic prefix caching** rides the same pool: a finished sequence's
*full prompt pages* (page index < ``prompt_len // page_size`` — the only
pages holding pure prompt KV, no pad tail and no decode writes) enter a
refcounted index keyed by chained block hashes, namespaced by the weight
generation that wrote them. Admission walks the new prompt's chain and
**aliases** every resident page it matches into the sequence's page
table (page tables are a pure gather, so N sequences can read one page),
reserving and prefilling only the non-shared tail. Sharing is
whole-page: a divergent continuation always lands in the sequence's own
freshly reserved tail pages, so copy-on-write never has to copy — a
shared page is never written by anyone. Eviction frees only
refcount-0 pages, least-recently-released first, and only when
admission actually runs short. The hit is rounded down to a multiple of
``lcm(page_size, prefill_chunk)`` (chunk starts must stay multiples of
``prefill_chunk`` so a chunk's clamped pad tail can never fold back
into a real page) and capped strictly below the prompt end (the last
prompt token always prefills — it produces the first-token logits), so
served tokens are BIT-identical to the uncached engine.

stdlib + numpy only; the engine owns everything torch.
"""

from __future__ import annotations

import hashlib
import threading
import time
from collections import OrderedDict, deque
from math import gcd
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from horovod_tpu_torch.observability import flight as _flight
from horovod_tpu_torch.observability import metrics as _metrics
from horovod_tpu_torch.observability import reqtrace as _reqtrace

__all__ = ["QueueFull", "Request", "Sequence", "PrefixCache",
           "prefix_digests", "ContinuousBatchingScheduler",
           "DEFAULT_BACKPRESSURE_TPOT"]


class QueueFull(RuntimeError):
    """The request queue is at ``max_queue`` — admission control rejected
    the request instead of growing without bound. Serve-side backpressure:
    the caller sheds load or retries later.

    ``retry_after_s`` is a deterministic backoff hint (queue depth ×
    the windowed TPOT median — roughly how long the backlog ahead of
    the caller takes to move) so callers pace their retries
    proportionally instead of hammering a saturated engine."""

    def __init__(self, msg: str = "",
                 retry_after_s: Optional[float] = None):
        super().__init__(msg)
        self.retry_after_s = retry_after_s


# TPOT stand-in for the backpressure hint before any token has decoded
# (a cold engine has no window yet but a full queue still needs a hint)
DEFAULT_BACKPRESSURE_TPOT = 0.02


def prefix_digests(prompt, page_size: int,
                   limit: Optional[int] = None) -> List[str]:
    """Chained block digests for every FULL ``page_size`` block of
    `prompt` — digest *i* commits to all tokens up to and including
    block *i*, so matching digest *i* proves the whole prefix matches.

    Content-only (no weight generation): the fleet router uses these to
    score prefix locality against a replica's advertised summary without
    knowing which generation the replica serves; the cache index adds
    its own generation namespace on top."""
    toks = np.asarray(prompt, np.int32).reshape(-1)
    nblocks = int(toks.size) // int(page_size)
    if limit is not None:
        nblocks = min(nblocks, int(limit))
    out: List[str] = []
    h = b"hvd-prefix-v1"
    for i in range(nblocks):
        block = toks[i * page_size:(i + 1) * page_size]
        h = hashlib.blake2b(
            h + block.tobytes(), digest_size=16).digest()
        out.append(h.hex())
    return out


class PrefixCache:
    """Refcounted prefix-page index over the paged KV pool.

    Pure bookkeeping (the pages themselves live in the engine's pool):
    maps ``(namespace, chain-digest) → page`` for pages whose KV is a
    verbatim full prompt block written under weight generation
    ``namespace``. A page is in exactly one of three states:

    - **shared** — refcount ≥ 1: aliased into one or more live
      sequences' page tables. Never evictable, never written.
    - **resident** — refcount 0 but still indexed: a future admission
      may alias it. Sits in the LRU (ordered by release recency) and is
      reclaimed only when admission runs short of free pages.
    - gone — evicted back to the scheduler's free list.

    Callers hold the scheduler lock; this class adds no locking."""

    def __init__(self, page_size: int, prefill_chunk: int):
        self.page_size = int(page_size)
        self.prefill_chunk = int(prefill_chunk)
        #: hit granularity: chunk starts must remain multiples of
        #: prefill_chunk (pad-tail clamp invariant), page ownership is
        #: whole pages — so hits advance in lcm(page, chunk) tokens
        self.align_tokens = (self.page_size * self.prefill_chunk
                            // gcd(self.page_size, self.prefill_chunk))
        self.align_pages = self.align_tokens // self.page_size
        self._by_key: Dict[Tuple[int, str], int] = {}
        self._key_of: Dict[int, Tuple[int, str]] = {}
        self._ref: Dict[int, int] = {}
        self._lru: "OrderedDict[int, bool]" = OrderedDict()

    # ------------------------------------------------------------ queries

    def lookup(self, namespace: int, digests: List[str]) -> List[int]:
        """Longest resident run of chained blocks, as pool pages (NOT
        yet acquired — callers :meth:`acquire` before any eviction can
        run, or the hit itself could be reclaimed)."""
        pages: List[int] = []
        for d in digests:
            p = self._by_key.get((int(namespace), d))
            if p is None:
                break
            pages.append(p)
        return pages

    def max_hit_pages(self, prompt_len: int) -> int:
        """Largest usable hit for a prompt: a multiple of the alignment
        run, strictly below the prompt end (the final prompt token must
        prefill to produce the first-token logits)."""
        runs = (int(prompt_len) - 1) // self.align_tokens
        return runs * self.align_pages

    def usable_hit(self, namespace: int, digests: List[str],
                   prompt_len: int) -> List[int]:
        run = self.lookup(namespace, digests)
        n = min(len(run), self.max_hit_pages(prompt_len))
        n -= n % self.align_pages
        return run[:n]

    # --------------------------------------------------------- refcounts

    def acquire(self, pages: List[int]) -> None:
        for p in pages:
            self._ref[p] = self._ref.get(p, 0) + 1
            self._lru.pop(p, None)

    def release(self, pages: List[int]) -> None:
        for p in pages:
            n = self._ref.get(p, 0) - 1
            if n > 0:
                self._ref[p] = n
                continue
            self._ref.pop(p, None)
            if p in self._key_of:
                # most-recently released goes to the LRU tail
                self._lru[p] = True
                self._lru.move_to_end(p)

    def insert(self, namespace: int, digest: str, page: int) -> bool:
        """Index `page` as the block behind `digest`; False when the
        block is already resident (the caller keeps ownership of its
        duplicate copy and frees it)."""
        key = (int(namespace), digest)
        if key in self._by_key:
            return False
        self._by_key[key] = page
        self._key_of[page] = key
        self._lru[page] = True
        return True

    # ---------------------------------------------------------- eviction

    def evictable(self) -> int:
        return len(self._lru)

    def evict(self, n: int) -> List[int]:
        """Reclaim up to `n` refcount-0 pages, least-recently-released
        first. Deterministic: the LRU order is a pure function of the
        admit/finish sequence."""
        out: List[int] = []
        while self._lru and len(out) < n:
            p, _ = self._lru.popitem(last=False)
            self._by_key.pop(self._key_of.pop(p), None)
            out.append(p)
        return out

    # ------------------------------------------------------------- views

    def resident_pages(self) -> int:
        """Indexed pages (shared + idle) — pool pages the cache holds."""
        return len(self._key_of)

    def shared_page_count(self) -> int:
        """Indexed pages aliased by at least one live sequence."""
        return sum(1 for p in self._ref if p in self._key_of)

    def block_summary(self, limit: int = 64) -> List[str]:
        """Content digests of resident blocks (generation-free), for
        the fleet status blob. Sorted for deterministic publication."""
        digs = sorted(k[1] for k in self._by_key)
        return digs[:int(limit)]


class Request:
    """One generation request.

    - `rid`: caller's id (routing hash + metrics correlation).
    - `prompt`: 1-D int tokens.
    - `max_new_tokens`: tokens to generate (the sequence finishes earlier
      on `eos_token` when the engine has one).
    - `temperature`: 0 = greedy argmax; > 0 samples ``logits/temperature``
      with a deterministic per-request PRNG seeded from `rid`.
    - `arm`: rollout arm serving this request (``"stable"`` unless a
      :class:`~horovod_tpu_torch.serving.rollout.GenerationRollout` routed it
      to the canary).
    """

    def __init__(self, rid, prompt, max_new_tokens: int, *,
                 temperature: float = 0.0, arm: str = "stable"):
        self.rid = rid
        self.prompt = np.asarray(prompt, np.int32).reshape(-1)
        if self.prompt.size < 1:
            raise ValueError("prompt must carry at least one token")
        if max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {max_new_tokens}")
        self.max_new_tokens = int(max_new_tokens)
        self.temperature = float(temperature)
        self.arm = arm
        self.submitted_at = time.monotonic()
        # filled in when the sequence finishes
        self.tokens: Optional[np.ndarray] = None  # prompt + generated
        self.generated: Optional[List[int]] = None
        self.error: Optional[str] = None
        self.finished_at: Optional[float] = None
        self._done = threading.Event()

    @property
    def done(self) -> bool:
        return self._done.is_set()

    def latency_seconds(self) -> Optional[float]:
        if self.finished_at is None:
            return None
        return self.finished_at - self.submitted_at

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._done.wait(timeout)


class Sequence:
    """In-flight decoding state for one admitted request.

    ``arm`` is the engine weight arm this sequence decodes against —
    pinned at admission and only ever moved to an arm holding the SAME
    params (promotion relabels, drain labels): a sequence must never
    change weights mid-decode, its KV cache was built under them.
    ``req.arm`` stays the user-facing label (metrics, routing)."""

    def __init__(self, req: Request, slot: int, pages: List[int]):
        self.req = req
        self.arm = req.arm
        self.slot = slot
        self.pages = pages
        self.prompt_len = int(req.prompt.size)
        self.done_prompt = 0        # prefill tokens written to the cache
        self.generated: List[int] = []
        self.last_token: Optional[int] = None  # sampled, not yet cached
        self._rng: Optional[np.random.RandomState] = None
        # --- prefix-cache state ---
        #: leading pages of ``pages`` aliased from the prefix cache
        #: (never written by this sequence; decref'd at finish)
        self.shared_count = 0
        #: weight-generation namespace captured at admission (None =
        #: caching off for this sequence)
        self.prefix_ns: Optional[int] = None
        #: chained digests of the prompt's full blocks (insert keys)
        self.prefix_chain: Optional[List[str]] = None
        #: what the prefill passes write — the prompt, unless a forced
        #: cache eviction restarted the sequence (then prompt + every
        #: generated-but-uncached token gets rewritten, bit-identically)
        self.prefill_src: np.ndarray = req.prompt
        self.prefill_len: int = self.prompt_len

    @property
    def length(self) -> int:
        """Tokens currently written to the kv cache."""
        if self.done_prompt < self.prefill_len:
            return self.done_prompt
        # prompt + every generated token except the freshly sampled one
        return self.prompt_len + max(0, len(self.generated) - 1)

    @property
    def prefilling(self) -> bool:
        return self.done_prompt < self.prefill_len

    def restart_prefill(self) -> None:
        """Rebuild this sequence's whole KV from position 0 (the forced
        cache-eviction drill evicted pages it was aliasing): replay the
        prompt plus every generated token that already had KV written.
        ``last_token`` (sampled, not yet cached) survives, so decoding
        resumes exactly where it stopped — bit-identically, since the
        replayed writes are the same tokens at the same positions."""
        tail = np.asarray(self.generated[:-1] if self.generated else [],
                          np.int32)
        self.prefill_src = np.concatenate([self.req.prompt, tail])
        self.prefill_len = int(self.prefill_src.size)
        self.done_prompt = 0

    def sample(self, logits: np.ndarray) -> int:
        """Greedy argmax or temperature sampling of one next token from a
        ``[vocab]`` logits row — deterministic per request (the PRNG seeds
        from a crc32 of `rid`, like the rollout router: Python's built-in
        ``hash`` is salted per process, which would break cross-process /
        cross-restart replayability)."""
        if self.req.temperature <= 0.0:
            return int(np.argmax(logits))
        if self._rng is None:
            import zlib

            self._rng = np.random.RandomState(
                zlib.crc32(str(self.req.rid).encode()) or 1)
        z = logits.astype(np.float64) / self.req.temperature
        z -= z.max()
        p = np.exp(z)
        p /= p.sum()
        return int(self._rng.choice(p.size, p=p))


class _CancelShim:
    """Minimal Sequence stand-in for cancelling a never-admitted
    request — the reqtrace finish path reads only ``.req``."""

    __slots__ = ("req",)

    def __init__(self, req: Request):
        self.req = req


class ContinuousBatchingScheduler:
    """Slots, queue, and the page-pool free list.

    All methods are lock-safe: :meth:`submit` may be called from serving
    threads while the engine loop runs :meth:`admit` / :meth:`finish`.
    """

    def __init__(self, *, num_pages: int, page_size: int, max_batch: int,
                 pages_per_seq: int, max_queue: int,
                 prefill_chunk: Optional[int] = None,
                 prefix_cache: bool = False,
                 namespace_of: Optional[Callable[[str],
                                                 Optional[int]]] = None):
        if num_pages < 2:
            raise ValueError(
                f"num_pages must be >= 2 (page 0 is the trash page), "
                f"got {num_pages}")
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        self.max_batch = int(max_batch)
        self.pages_per_seq = int(pages_per_seq)
        self.max_queue = int(max_queue)
        self._lock = threading.Lock()
        # page 0 reserved as the trash page for masked writes
        self._free_pages: List[int] = list(range(1, self.num_pages))
        self._queue: deque = deque()
        self._slots: List[Optional[Sequence]] = [None] * self.max_batch
        #: prefix cache (None = off): hits alias resident pages at
        #: admission, full prompt pages are indexed at finish
        self._prefix: Optional[PrefixCache] = PrefixCache(
            self.page_size,
            prefill_chunk if prefill_chunk is not None
            else self.page_size) if prefix_cache else None
        #: arm → weight-generation namespace (the engine's resolver);
        #: returning None disables caching for that request
        self._namespace_of = namespace_of if namespace_of is not None \
            else (lambda arm: 0)

    # -------------------------------------------------------------- intake

    def submit(self, req: Request) -> None:
        """Queue a request; raises :class:`QueueFull` past ``max_queue``
        (counted as ``serving_admission_rejected{reason=queue_full}``) and
        rejects prompts that can never fit the per-sequence page budget."""
        pages_needed = self._pages_for(req)
        if pages_needed > self.pages_per_seq:
            self._reject(req, "too_long",
                         f"needs {pages_needed} pages, per-sequence "
                         f"capacity is {self.pages_per_seq}")
            raise ValueError(
                f"request {req.rid!r} needs {pages_needed} pages "
                f"({req.prompt.size} prompt + {req.max_new_tokens} new "
                f"tokens), capacity is {self.pages_per_seq} pages of "
                f"{self.page_size}")
        with self._lock:
            full = len(self._queue) >= self.max_queue
            if not full:
                self._queue.append(req)
        if full:
            # outside the lock: the reject path records metrics + a
            # flight event (periodic sidecar I/O) — under overload, when
            # rejections spike, that must not stall concurrent
            # submit/admit/finish callers
            hint = self.backpressure_hint(req)
            self._reject(req, "queue_full",
                         f"queue at max_queue={self.max_queue}; retry "
                         f"after ~{hint:.3f}s")
            raise QueueFull(
                f"request queue full ({self.max_queue}); shed load or "
                f"retry in ~{hint:.3f}s", retry_after_s=hint)
        # per-request lifecycle opens here (trace lane, flight
        # req_begin, the queue-wait clock) — outside the lock, like the
        # reject path
        _reqtrace.on_enqueue(req)
        if _metrics.enabled():
            _metrics.gauge(
                "serving_queue_depth",
                help="requests queued awaiting a slot + page reservation",
            ).set(self.queue_depth())

    def _reject(self, req: Request, reason: str, detail: str) -> None:
        req.error = f"rejected: {detail}"
        req.finished_at = time.monotonic()
        req._done.set()
        # flight ring: shed load is an admission decision the post-mortem
        # record keeps (was the engine rejecting before it died?)
        _flight.record("serve", what="reject", reason=reason)
        _reqtrace.on_reject(req, reason)
        if _metrics.enabled():
            _metrics.counter(
                "serving_admission_rejected",
                help="requests refused by admission control",
                reason=reason,
            ).inc()

    def _pages_for(self, req: Request) -> int:
        total = req.prompt.size + req.max_new_tokens
        return -(-int(total) // self.page_size)

    def backpressure_hint(self, req: Optional[Request] = None) -> float:
        """Deterministic retry-after estimate for a rejected caller:
        queue depth × the windowed TPOT median (how long the backlog
        ahead will roughly take to move one decode step each). When
        `req` is given and the prefix cache would credit part of its
        reservation, the hint scales by the post-credit fraction — a
        mostly-cached prompt frees up to admit much sooner than its
        worst-case reservation suggests (floored at one TPOT: it still
        needs a slot). Also published as the
        ``fleet_backpressure_hint_seconds`` gauge so the router /
        dashboards see the same number the caller got."""
        tpot = _reqtrace.recent_tpot(DEFAULT_BACKPRESSURE_TPOT)
        hint = max(1, self.queue_depth()) * float(tpot)
        if req is not None and self._prefix is not None:
            ns = self._namespace_of(req.arm)
            if ns is not None:
                worst = self._pages_for(req)
                with self._lock:
                    hit = len(self._prefix.usable_hit(
                        ns, prefix_digests(req.prompt, self.page_size),
                        int(req.prompt.size)))
                hint = max(hint * (worst - hit) / max(1, worst),
                           float(tpot))
        if _metrics.enabled():
            _metrics.gauge(
                "fleet_backpressure_hint_seconds",
                help="retry-after hint handed to rejected callers "
                     "(queue depth x windowed TPOT median)",
            ).set(hint)
        return hint

    def cancel(self, req: Request, reason: str = "cancelled") -> bool:
        """Withdraw a request at an iteration boundary: queued requests
        leave the queue outright; an in-flight sequence retires with
        `reason` as its error, freeing its slot and pages. Returns False
        when the request is unknown or already finished. The reason is
        normalized to start with ``"cancelled"`` — reqtrace keeps such
        completions out of the arm windows and the error-rate SLO (a
        hedge loser withdrawn by the fleet router was never a served
        outcome). Callers must only cancel between engine steps: an
        in-flight retire mid-pass would invalidate the pass's captured
        batch rows."""
        if not reason.startswith("cancelled"):
            reason = f"cancelled: {reason}"
        with self._lock:
            queued = req in self._queue
            if queued:
                self._queue.remove(req)
                seq = None
            else:
                seq = next((s for s in self._slots
                            if s is not None and s.req is req), None)
        if queued:
            req.generated = []
            req.tokens = np.asarray(req.prompt, np.int32)
            req.error = reason
            req.finished_at = time.monotonic()
            req._done.set()
            if _metrics.enabled():
                _metrics.counter(
                    "serving_requests",
                    help="generation requests completed, by rollout arm "
                         "and outcome",
                    arm=req.arm, outcome="cancelled",
                ).inc()
            # close the reqtrace lifecycle without a Sequence — only
            # ``seq.req`` is read on the finish path
            _reqtrace.on_finish(_CancelShim(req), error=reason)
            self._record_gauges()
            return True
        if seq is None or req.done:
            return False
        self.finish(seq, error=reason)
        return True

    # ----------------------------------------------------------- admission

    def admit(self) -> List[Sequence]:
        """Move queued requests into free slots while their full page
        reservation fits — head-of-line order, so admission is
        deterministic and a too-big head request backpressures the queue
        rather than being overtaken.

        With the prefix cache on, the head request's chained block
        digests are matched against the index first: matched pages are
        **aliased** (refcount bump, ``done_prompt`` pre-advanced past
        them) and the reservation only covers the non-shared tail — a
        fully-cached prompt admits with a near-zero page bill instead of
        backpressuring at high occupancy. When the tail still does not
        fit, refcount-0 resident pages are LRU-evicted on demand before
        giving up."""
        admitted: List[Sequence] = []
        evicted = 0
        hits = 0
        misses = 0
        with self._lock:
            while self._queue:
                slot = next(
                    (i for i, s in enumerate(self._slots) if s is None),
                    None)
                if slot is None:
                    break
                req = self._queue[0]
                worst = self._pages_for(req)
                hit_pages: List[int] = []
                chain: Optional[List[str]] = None
                ns: Optional[int] = None
                if self._prefix is not None:
                    ns = self._namespace_of(req.arm)
                    if ns is not None:
                        chain = prefix_digests(req.prompt, self.page_size)
                        hit_pages = self._prefix.usable_hit(
                            ns, chain, int(req.prompt.size))
                        # pin the hit BEFORE any eviction can run, or
                        # the eviction below could reclaim it
                        self._prefix.acquire(hit_pages)
                need = worst - len(hit_pages)
                if need > len(self._free_pages) \
                        and self._prefix is not None:
                    got = self._prefix.evict(
                        need - len(self._free_pages))
                    if got:
                        evicted += len(got)
                        self._free_pages = sorted(
                            self._free_pages + got)
                if need > len(self._free_pages):
                    if hit_pages:
                        self._prefix.release(hit_pages)
                    break  # page-pool backpressure
                self._queue.popleft()
                pages = list(hit_pages) + [
                    self._free_pages.pop(0) for _ in range(need)]
                seq = Sequence(req, slot, pages)
                if hit_pages:
                    seq.shared_count = len(hit_pages)
                    seq.done_prompt = len(hit_pages) * self.page_size
                    hits += 1
                elif ns is not None:
                    misses += 1
                seq.prefix_ns = ns
                seq.prefix_chain = chain
                self._slots[slot] = seq
                admitted.append(seq)
        if admitted:
            _flight.record(
                "serve", what="admit", n=len(admitted),
                queue=self.queue_depth(),
            )
            for seq in admitted:
                _reqtrace.on_admit(seq)
                if seq.shared_count:
                    _reqtrace.on_prefix_hit(
                        seq, seq.shared_count * self.page_size)
            if _metrics.enabled():
                _metrics.counter(
                    "serving_sequences_admitted",
                    help="sequences that joined the continuous batch",
                ).inc(len(admitted))
        if _metrics.enabled():
            if hits:
                _metrics.counter(
                    "serving_prefix_hits",
                    help="admissions that aliased cached prefix pages",
                ).inc(hits)
            if misses:
                _metrics.counter(
                    "serving_prefix_misses",
                    help="cache-eligible admissions with no usable "
                         "prefix hit",
                ).inc(misses)
            if evicted:
                _metrics.counter(
                    "serving_prefix_evictions",
                    help="refcount-0 cached pages reclaimed (LRU on "
                         "admission pressure, or the cache_evict_at_pass "
                         "chaos charge)",
                ).inc(evicted)
        self._record_gauges()
        return admitted

    def finish(self, seq: Sequence, *, error: Optional[str] = None) -> None:
        """Retire a sequence at an iteration boundary: result (or error)
        onto the request, slot and pages freed immediately.

        With the prefix cache on, an error-free sequence donates its
        FULL prompt pages (index < ``prompt_len // page_size`` — the
        only pages holding pure prompt KV: the last partial page carries
        the pad tail and decode writes) to the index instead of the free
        list; aliased pages are decref'd, dropping to the LRU when no
        other live sequence shares them."""
        req = seq.req
        req.generated = list(seq.generated)
        req.tokens = np.concatenate(
            [req.prompt, np.asarray(seq.generated, np.int32)])
        req.error = error
        req.finished_at = time.monotonic()
        with self._lock:
            self._slots[seq.slot] = None
            shared = seq.pages[:seq.shared_count]
            free = []
            cacheable = (
                self._prefix is not None and seq.prefix_ns is not None
                and seq.prefix_chain is not None and error is None
                and seq.done_prompt >= seq.prefill_len)
            if cacheable:
                nfull = min(seq.prompt_len // self.page_size,
                            len(seq.prefix_chain))
                for i in range(seq.shared_count, nfull):
                    if not self._prefix.insert(
                            seq.prefix_ns, seq.prefix_chain[i],
                            seq.pages[i]):
                        free.append(seq.pages[i])  # duplicate content
                free.extend(seq.pages[max(seq.shared_count, nfull):])
            else:
                free.extend(seq.pages[seq.shared_count:])
            if shared and self._prefix is not None:
                self._prefix.release(shared)
            # keep the free list sorted so page assignment is a pure
            # function of the admission order (deterministic replays)
            self._free_pages = sorted(self._free_pages + free)
        req._done.set()
        if _metrics.enabled():
            _metrics.counter(
                "serving_requests",
                help="generation requests completed, by rollout arm and "
                     "outcome",
                arm=req.arm,
                outcome="cancelled" if error
                and error.startswith("cancelled")
                else ("error" if error else "ok"),
            ).inc()
        # the one completion observation path: reqtrace closes the
        # request's span lifecycle, lands the e2e/TTFT/TPOT histograms
        # (including the old serving_request_latency_seconds alias), and
        # appends to the per-arm window the rollout/SLO gates read
        _reqtrace.on_finish(seq, error=error)
        self._record_gauges()

    # -------------------------------------------------------------- views

    def active(self, arm: Optional[str] = None) -> List[Sequence]:
        with self._lock:
            seqs = [s for s in self._slots if s is not None]
        if arm is not None:
            seqs = [s for s in seqs if s.arm == arm]
        return seqs

    def arms_active(self) -> List[str]:
        seen: Dict[str, bool] = {}
        for s in self.active():
            seen.setdefault(s.arm, True)
        return list(seen)

    def queue_depth(self) -> int:
        with self._lock:
            return len(self._queue)

    def relabel_arm(self, src: str, dst: str) -> None:
        """Move every queued request and in-flight sequence from arm `src`
        to `dst`. Legal ONLY when `dst` holds the same params as `src`
        (promotion: identical weights under a new label) — a sequence must
        never change weights mid-decode."""
        moved: List[Request] = []
        with self._lock:
            for req in self._queue:
                if req.arm == src:
                    req.arm = dst
                    moved.append(req)
            for s in self._slots:
                if s is not None and s.arm == src:
                    s.arm = dst
                    s.req.arm = dst
                    moved.append(s.req)
        for req in moved:
            _reqtrace.on_relabel(req, src, dst)

    def relabel_queued_only(self, src: str, dst: str) -> None:
        """Re-route queued `src` requests to `dst` without touching
        in-flight sequences (the rollback path: admitted canary work
        drains on its own weights)."""
        moved: List[Request] = []
        with self._lock:
            for req in self._queue:
                if req.arm == src:
                    req.arm = dst
                    moved.append(req)
        for req in moved:
            _reqtrace.on_relabel(req, src, dst)

    def move_active_to_drain(self, src: str, drain_label: str) -> int:
        """Re-bind in-flight `src` sequences to `drain_label` — the SAME
        params parked under a private label so they finish coherently
        while `src` is handed to a new weight generation. ``req.arm`` (the
        metrics/routing label) is untouched. Returns how many moved."""
        n = 0
        with self._lock:
            for s in self._slots:
                if s is not None and s.arm == src:
                    s.arm = drain_label
                    n += 1
        return n

    def pages_in_use(self) -> int:
        """Distinct pages held by *active* sequences (aliased pages
        count once — that is the sharing win). Pages resident only in
        the prefix cache are neither in use nor free; see
        :meth:`cached_page_count`."""
        with self._lock:
            return len({p for s in self._slots if s is not None
                        for p in s.pages})

    def free_page_count(self) -> int:
        with self._lock:
            return len(self._free_pages)

    def cached_page_count(self) -> int:
        """Pages held by the prefix-cache index (shared + idle)."""
        with self._lock:
            return 0 if self._prefix is None \
                else self._prefix.resident_pages()

    def prefix_summary(self, limit: int = 64) -> List[str]:
        """Content block digests of the resident prefix cache — the
        locality signal a fleet replica advertises in its status blob."""
        with self._lock:
            return [] if self._prefix is None \
                else self._prefix.block_summary(limit)

    def chaos_evict(self) -> Tuple[int, int]:
        """``HOROVOD_CHAOS=cache_evict_at_pass=K``'s forced mid-flight
        eviction: drop EVERY refcount-0 cached page, then tear shared
        pages out from under live sequences — each victim swaps its
        aliased pages for fresh owned ones and restarts prefill from
        position 0, rewriting the same KV bit-identically (the drill's
        whole point: tokens must not change). Returns
        ``(victims, pages_dropped)``. Must only run at an iteration
        boundary — mid-pass it would invalidate captured batch rows."""
        victims = 0
        dropped = 0
        with self._lock:
            if self._prefix is None:
                return (0, 0)
            got = self._prefix.evict(self._prefix.evictable())
            dropped += len(got)
            self._free_pages = sorted(self._free_pages + got)
            for s in self._slots:
                if s is None or not s.shared_count:
                    continue
                if len(self._free_pages) < s.shared_count:
                    continue  # no replacement pages: leave it aliased
                shared = s.pages[:s.shared_count]
                repl = [self._free_pages.pop(0)
                        for _ in range(s.shared_count)]
                s.pages = repl + s.pages[s.shared_count:]
                s.shared_count = 0
                s.restart_prefill()
                self._prefix.release(shared)
                victims += 1
            # pages the victims released may have hit refcount 0 — the
            # drill drops those too
            got = self._prefix.evict(self._prefix.evictable())
            dropped += len(got)
            self._free_pages = sorted(self._free_pages + got)
        if dropped and _metrics.enabled():
            _metrics.counter(
                "serving_prefix_evictions",
                help="refcount-0 cached pages reclaimed (LRU on "
                     "admission pressure, or the cache_evict_at_pass "
                     "chaos charge)",
            ).inc(dropped)
        return (victims, dropped)

    def idle(self) -> bool:
        with self._lock:
            return not self._queue and all(
                s is None for s in self._slots)

    def page_table_rows(self) -> np.ndarray:
        """``[max_batch, pages_per_seq]`` int32 page table for the current
        batch composition: admitted rows get their pages (tail-padded with
        the trash page), empty slots are all-trash."""
        table = np.zeros((self.max_batch, self.pages_per_seq), np.int32)
        with self._lock:
            for i, s in enumerate(self._slots):
                if s is not None:
                    table[i, :len(s.pages)] = np.asarray(s.pages, np.int32)
        return table

    def _record_gauges(self) -> None:
        if not _metrics.enabled():
            return
        _metrics.gauge(
            "serving_queue_depth",
            help="requests queued awaiting a slot + page reservation",
        ).set(self.queue_depth())
        _metrics.gauge(
            "serving_active_sequences",
            help="sequences currently holding a batch slot",
        ).set(len(self.active()))
        _metrics.gauge(
            "serving_pages_in_use",
            help="kv-cache pages currently reserved by admitted sequences",
        ).set(self.pages_in_use())
        _metrics.gauge(
            "serving_page_pool_pages",
            help="allocatable kv-cache pages in the pool (excludes the "
                 "trash page)",
        ).set(self.num_pages - 1)
        if self._prefix is not None:
            with self._lock:
                shared = self._prefix.shared_page_count()
                resident = self._prefix.resident_pages()
            _metrics.gauge(
                "serving_prefix_pages_shared",
                help="cached pages aliased by at least one live "
                     "sequence",
            ).set(shared)
            _metrics.gauge(
                "serving_prefix_pages_resident",
                help="pool pages held by the prefix-cache index "
                     "(shared + idle)",
            ).set(resident)
