"""Import-path alias for the reference's ``horovod.spark.torch``
(``TorchEstimator``/``TorchModel``; counterpart of
``horovod_tpu/spark/torch.py``); see :mod:`horovod_tpu_torch.spark.keras`."""

from horovod_tpu_torch.spark import TorchEstimator  # noqa: F401
from horovod_tpu_torch.estimator import TorchModel  # noqa: F401
from horovod_tpu_torch.data.store import HDFSStore, LocalStore, Store  # noqa: F401
