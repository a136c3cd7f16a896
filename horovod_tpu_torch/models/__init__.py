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
