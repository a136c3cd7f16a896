"""Process meshes and the parallelism strategies over them (DP/TP/PP/SP/EP).

Counterpart of ``horovod_tpu/parallel``: a named-axis mesh of
``torch.distributed`` sub-groups (:mod:`.mesh`), the per-axis primitives
the strategies are written in (:mod:`.spmd`), sequence parallelism
(:mod:`.ring_attention`), pipelines (:mod:`.pipeline`) and experts
(:mod:`.moe`). Tensor parallelism's block is
:func:`horovod_tpu_torch.models.transformer.tp_block_apply`.
"""

from horovod_tpu_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS,
    MODEL_AXIS,
    PIPELINE_AXIS,
    SEQUENCE_AXIS,
    EXPERT_AXIS,
    FSDP_AXIS,
    TP_AXIS,
    CROSS_AXIS,
    LOCAL_AXIS,
    MeshConfig,
    build_mesh,
    build_host_mesh,
)
from horovod_tpu_torch.parallel.ring_attention import (  # noqa: F401
    ring_attention,
    ulysses_attention,
    zigzag_permutation,
    zigzag_ring_attention,
)
from horovod_tpu_torch.parallel.pipeline import (  # noqa: F401
    make_interleaved_stage_params,
    make_stage_params,
    pipeline_apply,
    pipeline_apply_interleaved,
)
from horovod_tpu_torch.parallel.moe import (  # noqa: F401
    expert_parallel_moe,
    top1_dispatch,
    top2_dispatch,
)
