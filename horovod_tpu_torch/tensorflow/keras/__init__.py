"""``horovod_tpu_torch.tensorflow.keras``: import-path parity with the
reference's ``horovod.tensorflow.keras`` (counterpart of
``horovod_tpu/tensorflow/keras/__init__.py``).

Keras 3 unified the standalone-keras and tf.keras stacks, so this module
and :mod:`horovod_tpu_torch.keras` are the same implementation."""

from horovod_tpu_torch.keras import *  # noqa: F401,F403
from horovod_tpu_torch.keras import (  # noqa: F401
    DistributedOptimizer,
    create_distributed_optimizer,
    load_model,
    callbacks,
)
