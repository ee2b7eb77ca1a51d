"""The port's models. Importing the package registers ``cod``,
``baseline`` and ``DQnet`` in ``core.registry.MODELS``; it also exports the
modules no model calls and the offline depther, as
``dgtd_tpu/models/__init__.py`` does."""

from .cod import baseline, cod  # noqa: F401
from .dqnet import DQnet, DQnetNet  # noqa: F401
from .mprnet import ORB, Decoder, DownSample, Encoder, ORSNet, SkipUpSample, UpSample  # noqa: F401
from .window_fusion import NewWindowFusion, WindowFusion, window_partition, window_reverse  # noqa: F401
from .dinov2 import DINOV2_ARCHS, DinoViT  # noqa: F401
from .dpt import DinoDPTDepther, DPTHead  # noqa: F401
