"""Models of the port (counterparts of ``horovod_tpu/models``)."""

from horovod_tpu_torch.models.resnet import (  # noqa: F401
    BottleneckBlock,
    ResNet,
    ResNet18,
    ResNet34,
    ResNet50,
    ResNet101,
    ResNet152,
    ResNetBlock,
)
from horovod_tpu_torch.models.transformer import (  # noqa: F401
    TransformerBlock,
    TransformerLM,
    TransformerSmall,
    TransformerTiny,
    apply_rope,
    default_attention,
)
