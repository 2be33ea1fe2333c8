from . import layers
from .resnet import ResNet, Bottleneck, resnet10, resnet50, resnet101, build_backbone
from .deeplab_v2 import DeepLabV2, ASPPClassifier
from .flaw_detector import FlawDetector, IBNorm, flaw_detector_criterion
from .convert import from_jax
from .discriminator import FCDiscriminator, fc_discriminator_criterion
from .rotation import RotationClassifier
from .pspnet import PSPNet, PSPModule, PixelShuffleBlock, UpsampleDecoder
from . import cct_decoders
