"""horovod_tpu_torch: the PyTorch/CUDA port of horovod_tpu.

``import horovod_tpu_torch as hvd``. One process per GPU over one
``torch.distributed`` process group (NCCL on the GPU; gloo when a test
asks for ``hvd.init(device="cpu")``). The int8 wire, the fused Adam
update, the flash-attention forward and the Adasum combine run on
hand-written Hopper kernels (:mod:`horovod_tpu_torch.ops.kernels`),
built at first use. ``init(native_core=True)`` attaches the native
control-plane core, which negotiates and fuses the named async ops.
Horovod's own PyTorch API (``DistributedOptimizer`` over a
``torch.optim`` optimizer, ``SyncBatchNorm``) is
``horovod_tpu_torch.torch``.
"""

__version__ = "0.1.0"

from horovod_tpu_torch.basics import (  # noqa: F401
    ccl_built,
    cross_rank,
    cross_size,
    ddl_built,
    device,
    gloo_built,
    gloo_enabled,
    gpu_available,
    health,
    health_state,
    init,
    is_homogeneous,
    is_initialized,
    local_rank,
    local_size,
    mpi_built,
    mpi_enabled,
    mpi_threads_supported,
    nccl_built,
    num_rank_is_power_2,
    process_rank,
    process_size,
    rank,
    shutdown,
    size,
    xla_built,
)
from horovod_tpu_torch.compression import Compression  # noqa: F401
from horovod_tpu_torch.ops.collective import (  # noqa: F401
    Adasum,
    Average,
    Max,
    Min,
    ReduceOp,
    Sum,
    allgather,
    allgather_async,
    allgather_object,
    allreduce,
    allreduce_,
    allreduce_async,
    allreduce_async_,
    alltoall,
    alltoall_async,
    broadcast,
    broadcast_,
    broadcast_async,
    broadcast_async_,
    broadcast_object,
    grouped_allgather,
    grouped_allreduce,
    grouped_allreduce_async,
    join,
    poll,
    reducescatter,
    reducescatter_async,
    synchronize,
)
from horovod_tpu_torch.optim import (  # noqa: F401
    DistributedGradientTape,
    DistributedOptimizer,
    FsdpParams,
    adam,
    adamw,
    broadcast_optimizer_state,
    broadcast_parameters,
    fsdp_gather_params,
    fsdp_pack_params,
    fsdp_reshard_params,
    fsdp_unpack_params,
    fused_adam,
    reshard_optimizer_state,
)
from horovod_tpu_torch.ops.flash_attention import flash_attention  # noqa: F401
from horovod_tpu_torch.training import (  # noqa: F401
    InstrumentedStep,
    instrument_step,
    lm_xent,
    make_loader_step,
    make_train_step,
    shard_batch,
    softmax_xent,
)
from horovod_tpu_torch.basics import flush_timeline  # noqa: F401
from horovod_tpu_torch.serving import subscribe_weights  # noqa: F401
from horovod_tpu_torch import profiler  # noqa: F401
from horovod_tpu_torch import tuning  # noqa: F401
from horovod_tpu_torch import observability  # noqa: F401
from horovod_tpu_torch.observability import metrics  # noqa: F401
