"""The input plane of the port (counterpart of ``horovod_tpu/data/``):
:mod:`~horovod_tpu_torch.data.sampler`'s pure-function
:class:`GlobalSampleIndex` and the loaders' cursor registry, the
cursor-checkpointed :class:`ResumableLoader` that places each rank's
batches on its GPU, and the estimator stores with the CRC-verified,
quarantine-capable :class:`ArrayShardStore`."""

from horovod_tpu_torch.data import sampler  # noqa: F401
from horovod_tpu_torch.data.sampler import (  # noqa: F401
    GlobalSampleIndex,
    mix_seed,
)
from horovod_tpu_torch.data.store import (  # noqa: F401
    ArrayShardStore,
    DataUnavailableError,
    HDFSStore,
    LocalStore,
    ShardCorruptError,
    Store,
)
from horovod_tpu_torch.data.loader import (  # noqa: F401
    ResumableLoader,
    ShardedLoader,
    shard_indices,
)
