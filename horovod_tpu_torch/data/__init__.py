"""The input plane of the port: so far the sample index and the loaders'
cursor registry (:mod:`~horovod_tpu_torch.data.sampler`), which
checkpoints carry."""

from horovod_tpu_torch.data import sampler  # noqa: F401
from horovod_tpu_torch.data.sampler import (  # noqa: F401
    GlobalSampleIndex,
    mix_seed,
)
