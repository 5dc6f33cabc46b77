from detectax_torch.models.backbones import build_backbone  # noqa: F401
from detectax_torch.models.fcos import FCOS  # noqa: F401
