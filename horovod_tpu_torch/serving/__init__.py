"""horovod_tpu_torch.serving: the training → serving plane.

Counterpart of ``horovod_tpu/serving``. Two halves:

- **Weight handoff**: a live training run publishes consolidated weights
  to the rendezvous KV as generation-numbered, CRC-checksummed,
  commit-last manifests (full keyframes every K generations with
  blockwise-int8 deltas in between, quantized by the ``quantize``
  kernel), and any number of serving processes rebuild them with
  :func:`subscribe_weights`, surviving publisher crashes, KV restarts
  (the server's write-ahead log), elastic resizes (the generation fence)
  and their own lag (keyframe resync + the staleness watermark). The
  payload is the JAX package's: either package reads the other's.
- **Inference plane**: :class:`InferenceEngine` serves the subscribed
  weights under continuous batching on a paged KV cache (with a prefix
  cache, speculative decoding and a tensor-parallel mode),
  :class:`GenerationRollout` canaries each new generation on a traffic
  slice, and :class:`FleetRouter` fronts N replicas with health-aware
  routing, hedged retries, failover and :class:`FleetRollout`, one
  fleet-wide, KV-coordinated rollout decision.

The engine modules import lazily; ``import horovod_tpu_torch.serving``
loads only the handoff surface.
"""

from horovod_tpu_torch.serving.protocol import ChainError  # noqa: F401
from horovod_tpu_torch.serving.publisher import (  # noqa: F401
    PublishAborted,
    PublishError,
    PublishRejected,
    WeightPublisher,
    active_publishers,
    flush_on_preempt,
)
from horovod_tpu_torch.serving.subscriber import (  # noqa: F401
    WeightSubscriber,
    subscribe_weights,
)

__all__ = [
    "ChainError",
    "ContinuousBatchingScheduler",
    "FleetReplica",
    "FleetRequest",
    "FleetRollout",
    "FleetRouter",
    "FleetSaturated",
    "GenerationRollout",
    "InferenceEngine",
    "PublishAborted",
    "PublishError",
    "PublishRejected",
    "QueueFull",
    "Request",
    "WeightPublisher",
    "WeightSubscriber",
    "active_publishers",
    "flush_on_preempt",
    "note_subscriber_health",
    "subscribe_weights",
]

_LAZY = {
    "InferenceEngine": ("horovod_tpu_torch.serving.engine", "InferenceEngine"),
    "note_subscriber_health": (
        "horovod_tpu_torch.serving.engine", "note_subscriber_health"),
    "GenerationRollout": (
        "horovod_tpu_torch.serving.rollout", "GenerationRollout"),
    "ContinuousBatchingScheduler": (
        "horovod_tpu_torch.serving.scheduler", "ContinuousBatchingScheduler"),
    "Request": ("horovod_tpu_torch.serving.scheduler", "Request"),
    "QueueFull": ("horovod_tpu_torch.serving.scheduler", "QueueFull"),
    "FleetReplica": ("horovod_tpu_torch.serving.fleet", "FleetReplica"),
    "FleetRequest": ("horovod_tpu_torch.serving.fleet", "FleetRequest"),
    "FleetRollout": ("horovod_tpu_torch.serving.fleet", "FleetRollout"),
    "FleetRouter": ("horovod_tpu_torch.serving.fleet", "FleetRouter"),
    "FleetSaturated": ("horovod_tpu_torch.serving.fleet", "FleetSaturated"),
}


def __getattr__(name):
    # the engine, rollout and fleet load on first use; `import
    # horovod_tpu_torch.serving` stays the handoff surface
    entry = _LAZY.get(name)
    if entry is None:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}")
    import importlib

    mod = importlib.import_module(entry[0])
    val = getattr(mod, entry[1])
    globals()[name] = val
    return val
