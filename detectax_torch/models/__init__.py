from detectax_torch.models.backbones import build_backbone  # noqa: F401
from detectax_torch.models.fcos import FCOS  # noqa: F401
from detectax_torch.models.centernet import (  # noqa: F401
    CenterNetFPNSingle,
    CenterNetS8,
    HourglassNet,
    StackedHourglass,
)
from detectax_torch.models.retinanet import RetinaNet  # noqa: F401
