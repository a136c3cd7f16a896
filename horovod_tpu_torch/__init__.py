"""horovod_tpu_torch: the PyTorch/CUDA port of horovod_tpu.

``import horovod_tpu_torch as hvd``. One process per GPU over one
``torch.distributed`` process group (NCCL on the GPU; gloo when a test
asks for ``hvd.init(device="cpu")``). The int8 gradient wire, the fused
Adam update and the flash-attention forward run on hand-written Hopper
kernels (:mod:`horovod_tpu_torch.ops.kernels`), built at first use.
"""

from horovod_tpu_torch.basics import (  # noqa: F401
    device,
    init,
    is_initialized,
    local_rank,
    local_size,
    rank,
    shutdown,
    size,
)
from horovod_tpu_torch.compression import Compression  # noqa: F401
from horovod_tpu_torch.ops.collective import (  # noqa: F401
    Average,
    Max,
    Min,
    ReduceOp,
    Sum,
    allgather,
    allreduce,
    alltoall,
    broadcast,
    reducescatter,
)
from horovod_tpu_torch.optim import (  # noqa: F401
    DistributedOptimizer,
    adam,
    adamw,
    broadcast_optimizer_state,
    broadcast_parameters,
    fused_adam,
)
from horovod_tpu_torch.ops.flash_attention import flash_attention  # noqa: F401
from horovod_tpu_torch.training import (  # noqa: F401
    lm_xent,
    make_train_step,
    shard_batch,
    softmax_xent,
)
