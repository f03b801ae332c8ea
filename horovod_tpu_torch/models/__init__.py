"""Models of the port: the exports of ``horovod_tpu.models`` for the
Transformer LM and the image models."""

from horovod_tpu_torch.models.inception import InceptionV3  # noqa: F401
from horovod_tpu_torch.models.mnist import MnistCNN  # noqa: F401
from horovod_tpu_torch.models.norm import (  # noqa: F401
    BatchNorm,
    BatchStatsNorm,
    ema_batch_stats,
)
from horovod_tpu_torch.models.resnet import (  # noqa: F401
    ResNet,
    ResNet18,
    ResNet34,
    ResNet50,
    ResNet101,
    ResNet152,
)
from horovod_tpu_torch.models.transformer import (  # noqa: F401
    DecodeContext,
    TransformerLM,
    fused_next_token_loss,
    next_token_loss,
)
from horovod_tpu_torch.models.vgg import VGG11, VGG16, VGG19  # noqa: F401

__all__ = ["TransformerLM", "DecodeContext", "next_token_loss",
           "fused_next_token_loss", "MnistCNN",
           "BatchNorm", "BatchStatsNorm", "ema_batch_stats", "ResNet", "ResNet18", "ResNet34", "ResNet50",
           "ResNet101", "ResNet152", "VGG11", "VGG16", "VGG19",
           "InceptionV3"]
