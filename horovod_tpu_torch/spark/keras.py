"""Import-path alias for the reference's ``horovod.spark.keras``
(``KerasEstimator``/``KerasModel``; counterpart of
``horovod_tpu/spark/keras.py``): the Spark-facing estimator (accepts Spark
or pandas DataFrames) from :mod:`horovod_tpu_torch.spark`; the Spark-free
engine is :mod:`horovod_tpu_torch.estimator`."""

from horovod_tpu_torch.spark import KerasEstimator  # noqa: F401
from horovod_tpu_torch.estimator import KerasModel  # noqa: F401
from horovod_tpu_torch.data.store import HDFSStore, LocalStore, Store  # noqa: F401
