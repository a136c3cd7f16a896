"""The shared retry/backoff policy: exponential backoff + jitter + deadline.

Counterpart of ``horovod_tpu/resilience/retry.py``, copied whole.

One policy object serves every transient-failure site in the stack — the
rendezvous KV client's server-startup race, the launcher's bounded worker
restarts, and the eager-collective dispatch path — so backoff behavior and
its observability (``resilience_retries{scope=...}`` /
``resilience_retry_exhausted{scope=...}`` counters, health feed) cannot
drift between layers.

Deterministic by construction when seeded: :meth:`RetryPolicy.delays` is a
pure function of the policy fields (the jitter RNG is a private
``random.Random(seed)``), so tier-1 tests assert exact delay sequences
instead of sleeping.

stdlib-only; see the package docstring.
"""

from __future__ import annotations

import dataclasses
import os
import random
import time
from typing import Callable, Iterator, Optional, Tuple, Type, Union

from horovod_tpu_torch.resilience import health as _health

__all__ = ["TransientError", "RetryError", "RetryPolicy", "policy_from_env"]


class TransientError(Exception):
    """A failure the caller believes is transient (chaos injection raises
    this; classifiers may map backend errors onto it)."""


class RetryError(Exception):
    """All attempts failed. ``__cause__`` is the last underlying error;
    ``attempts`` records how many were made."""

    def __init__(self, msg: str, attempts: int):
        super().__init__(msg)
        self.attempts = attempts


Retriable = Union[
    Tuple[Type[BaseException], ...],
    Type[BaseException],
    Callable[[BaseException], bool],
]


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Exponential backoff with jitter under a total deadline.

    Attempt ``k`` (0-based) sleeps ``min(base_delay * multiplier**k,
    max_delay) + U[0, jitter) * that`` before retrying; at most
    ``max_attempts`` attempts are made and no sleep is started past
    ``deadline`` seconds after the first attempt began.
    """

    scope: str = "generic"
    max_attempts: int = 5
    base_delay: float = 0.05
    max_delay: float = 2.0
    multiplier: float = 2.0
    #: jitter fraction: each delay is scaled by ``1 + U[0, jitter)``
    jitter: float = 0.1
    #: total seconds across all attempts (None = attempts-bounded only)
    deadline: Optional[float] = None
    #: seed for the jitter RNG (tests); None = nondeterministic
    seed: Optional[int] = None

    def delays(self) -> Iterator[float]:
        """The sleep before each retry (``max_attempts - 1`` values)."""
        rng = random.Random(self.seed)
        d = self.base_delay
        for _ in range(max(0, self.max_attempts - 1)):
            capped = min(d, self.max_delay)
            yield capped * (1.0 + (rng.random() * self.jitter
                                   if self.jitter else 0.0))
            d *= self.multiplier

    def call(self, fn: Callable, *args,
             retriable: Retriable = (TransientError,),
             on_retry: Optional[Callable[[BaseException, int], None]] = None,
             sleep: Callable[[float], None] = time.sleep,
             **kwargs):
        """Run ``fn(*args, **kwargs)``, retrying failures that match
        `retriable` (an exception class/tuple, or a predicate) under the
        backoff schedule. Non-matching failures propagate immediately.
        Exhaustion raises :class:`RetryError` from the last failure and
        marks the health monitor DEGRADED."""
        if callable(retriable) and not isinstance(retriable, type):
            matches = retriable
        else:
            matches = lambda e: isinstance(e, retriable)  # noqa: E731
        t0 = time.monotonic()
        attempts = 0
        last: Optional[BaseException] = None
        for delay in list(self.delays()) + [None]:
            attempts += 1
            try:
                return fn(*args, **kwargs)
            except BaseException as e:
                if not matches(e):
                    raise
                last = e
                if delay is None:
                    break  # attempts exhausted
                if (
                    self.deadline is not None
                    and time.monotonic() - t0 + delay > self.deadline
                ):
                    break  # the next sleep would blow the total deadline
                _health.record_retry(self.scope)
                if on_retry is not None:
                    on_retry(e, attempts)
                sleep(delay)
        _health.record_retry_exhausted(self.scope)
        raise RetryError(
            f"{self.scope}: {attempts} attempt(s) failed; last error: "
            f"{last!r}",
            attempts,
        ) from last


def _env_float(name: str) -> Optional[float]:
    v = os.environ.get(name)
    return float(v) if v else None


def policy_from_env(scope: str, **defaults) -> RetryPolicy:
    """A :class:`RetryPolicy` for `scope` with env overrides layered over
    `defaults`: ``HOROVOD_RETRY_<SCOPE>_<FIELD>`` (scope upper-cased,
    non-alnum → ``_``) beats ``HOROVOD_RETRY_<FIELD>`` beats the default.
    Fields: ``MAX_ATTEMPTS``, ``BASE_DELAY``, ``MAX_DELAY``, ``MULTIPLIER``,
    ``JITTER``, ``DEADLINE``."""
    sc = "".join(c if c.isalnum() else "_" for c in scope.upper())
    fields = {
        "max_attempts": int,
        "base_delay": float,
        "max_delay": float,
        "multiplier": float,
        "jitter": float,
        "deadline": float,
    }
    kw = dict(defaults)
    for field, cast in fields.items():
        env = _env_float(f"HOROVOD_RETRY_{sc}_{field.upper()}")
        if env is None:
            env = _env_float(f"HOROVOD_RETRY_{field.upper()}")
        if env is not None:
            kw[field] = cast(env)
    return RetryPolicy(scope=scope, **kw)
