"""CenterNet family on a ResNet-style backbone (stride-8 single map).

Port of `detectax/models/centernet.py::CenterNetS8` and
`CenterNetFPNSingle`; the two hourglass models of that file are not ported
yet.

* `CenterNetS8` — backbone → top-down FPN collapsed to one stride-8 map →
  shared towers → ``n_scales`` per-scale head conv pairs → output
  ``[B, H/8, W/8, S, 4+nc]`` with layout ``[sigmoid reg(4), cls(nc)]``.
  Each tower is computed once and feeds every scale's heads.
* `CenterNetFPNSingle` — the same neck and towers, one cls(nc+1) +
  reg(4+1) head pair, output ``[B, H/8, W/8, 4+1+(nc+1)]`` with layout
  ``[ltrb(4), cen(1), cls(nc+1)]`` (heatmap variant; class index 0 is the
  objectness slot).

Both take images ``[B, H, W, 3]`` and return float32 in the JAX package's
channel-last layouts; inside they run NCHW, computing in ``dtype``
(float32 or bfloat16; the parameters stay float32). Sub-modules are named
after the Flax parameter tree, so `detectax_torch.tools.from_flax` maps
weights name for name.
"""
from __future__ import annotations

import torch
from torch import nn

from detectax_torch.models.backbones import build_backbone
from detectax_torch.models.fpn import S8CollapseFPN
from detectax_torch.models.heads import ConvTower, HeadConv
from detectax_torch.models.layers import init_parameters


class _S8Trunk(nn.Module):
    """Backbone, collapsed FPN and the two towers shared by both models.
    ``generator`` seeds the initial weights (default: a fresh generator
    seeded with 0); ``freeze_bn`` keeps the backbone's BatchNorm on its
    running statistics under ``train=True``."""

    def __init__(self, num_classes: int, backbone: str, features: int,
                 freeze_bn: bool, dtype: torch.dtype):
        super().__init__()
        self.num_classes = int(num_classes)
        self.backbone_name = backbone
        self.features = int(features)
        self.freeze_bn = bool(freeze_bn)
        self.compute_dtype = dtype
        self.backbone = build_backbone(backbone, dtype)
        self.fpn = S8CollapseFPN(self.backbone.out_channels, features,
                                 dtype=dtype)
        self.cls_tower = ConvTower(features, features, dtype=dtype)
        self.reg_tower = ConvTower(features, features, dtype=dtype)

    def _init(self, generator: torch.Generator | None) -> None:
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        init_parameters(self, generator)

    def _towers(self, x: torch.Tensor, train: bool):
        x = x.permute(0, 3, 1, 2).contiguous()
        feat = self.fpn(self.backbone(x, train and not self.freeze_bn))
        return self.cls_tower(feat), self.reg_tower(feat)


class CenterNetS8(_S8Trunk):
    family = "centernet_s8"

    def __init__(self, num_classes: int, n_scales: int = 5,
                 backbone: str = "resnet50", features: int = 256,
                 freeze_bn: bool = False,
                 generator: torch.Generator | None = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__(num_classes, backbone, features, freeze_bn, dtype)
        self.n_scales = int(n_scales)
        for s in range(1, self.n_scales + 1):
            self.add_module(
                f"cls_head_{s}",
                HeadConv(features, self.num_classes, focal_bias=True,
                         dtype=dtype))
            self.add_module(f"reg_head_{s}",
                            HeadConv(features, 4, dtype=dtype))
        self._init(generator)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        cf, rf = self._towers(x, train)
        slots = []
        for s in range(1, self.n_scales + 1):
            reg = torch.sigmoid(getattr(self, f"reg_head_{s}")(rf))
            cls = getattr(self, f"cls_head_{s}")(cf)
            slots.append(torch.cat([reg, cls], dim=1))  # [B, 4+nc, h, w]
        out = torch.stack(slots, dim=1)                 # [B, S, 4+nc, h, w]
        return out.permute(0, 3, 4, 1, 2).contiguous().float()


class CenterNetFPNSingle(_S8Trunk):
    """Single stride-8 map heatmap variant. ``num_classes`` counts the real
    classes; the class head has one more channel, the objectness slot."""

    family = "centernet_heatmap"

    def __init__(self, num_classes: int, backbone: str = "resnet50",
                 features: int = 256, freeze_bn: bool = False,
                 generator: torch.Generator | None = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__(num_classes, backbone, features, freeze_bn, dtype)
        # reg head: 4 ltrb + 1 centerness; cls head: nc+1
        self.reg_head = HeadConv(features, 5, dtype=dtype)
        self.cls_head = HeadConv(features, self.num_classes + 1,
                                 focal_bias=True, dtype=dtype)
        self._init(generator)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        cf, rf = self._towers(x, train)
        out = torch.cat([self.reg_head(rf), self.cls_head(cf)], dim=1)
        return out.permute(0, 2, 3, 1).contiguous().float()
