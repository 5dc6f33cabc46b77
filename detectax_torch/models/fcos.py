"""FCOS detector family (three assignment/head variants).

Port of `detectax/models/fcos.py`, one shared-skeleton module:

* ``variant="fcos"`` — reg head 5ch (ltrb + centerness in the reg head),
  cls head nc ch. Per-level layout ``[reg(5), cls(nc)]`` i.e.
  ``[t,b,l,r,cen,classes]``.
* ``variant="center"`` — cen(1) + cls(nc) from the cls tower, reg(4)
  linear. Layout ``[reg(4), cen(1), cls(nc)]``.
* ``variant="center_v1"`` — same heads but the reg output is
  sigmoid-activated (offset+scale parameterization).

All variants share: backbone C3-C5 taps → FPN P3-P7 → cross-level shared
4-layer towers → per-level head convs with focal bias init on class logits.

The module takes images ``[B, H, W, 3]`` and returns one
``[B, h, w, 5 + nc]`` float32 tensor per level — the JAX package's layouts;
inside it runs NCHW, computing in ``dtype`` (float32 or bfloat16; the
parameters stay float32, images enter and outputs leave in float32).
"""
from __future__ import annotations

import torch
from torch import nn

from detectax_torch.models.backbones import build_backbone
from detectax_torch.models.fpn import FPN
from detectax_torch.models.heads import ConvTower, HeadConv
from detectax_torch.models.layers import init_parameters

VARIANTS = ("fcos", "center", "center_v1")
N_LEVELS = 5


class FCOS(nn.Module):
    """``generator`` seeds the initial weights (default: a fresh generator
    seeded with 0, so two constructions agree). ``freeze_bn`` keeps the
    backbone's BatchNorm on its running statistics under ``train=True``
    (they then neither enter the batch's statistics nor move)."""

    family = "fcos"

    def __init__(self, num_classes: int, variant: str = "fcos",
                 backbone: str = "resnet50", features: int = 256,
                 freeze_bn: bool = False,
                 generator: torch.Generator | None = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if variant not in VARIANTS:
            raise ValueError(f"unknown FCOS variant {variant!r}; "
                             f"options: {VARIANTS}")
        self.num_classes = int(num_classes)
        self.variant = variant
        self.backbone_name = backbone
        self.features = int(features)
        self.freeze_bn = bool(freeze_bn)
        self.compute_dtype = dtype

        self.backbone = build_backbone(backbone, dtype)
        self.fpn = FPN(self.backbone.out_channels, features, dtype=dtype)
        self.cls_tower = ConvTower(features, features, dtype=dtype)
        self.reg_tower = ConvTower(features, features, dtype=dtype)
        for i in range(1, N_LEVELS + 1):
            self.add_module(
                f"reg_head_{i}",
                HeadConv(features, 5 if variant == "fcos" else 4,
                         dtype=dtype))
            if variant != "fcos":
                self.add_module(
                    f"cen_head_{i}",
                    HeadConv(features, 1, focal_bias=True, dtype=dtype))
            self.add_module(
                f"cls_head_{i}",
                HeadConv(features, self.num_classes, focal_bias=True,
                         dtype=dtype))
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        init_parameters(self, generator)

    def forward(self, x: torch.Tensor, train: bool = False):
        x = x.permute(0, 3, 1, 2).contiguous()
        taps = self.backbone(x, train and not self.freeze_bn)
        outs = []
        for i, p in enumerate(self.fpn(taps), start=1):
            cf = self.cls_tower(p)
            rf = self.reg_tower(p)
            reg = getattr(self, f"reg_head_{i}")(rf)
            cls = getattr(self, f"cls_head_{i}")(cf)
            if self.variant == "fcos":
                parts = [reg, cls]
            else:
                if self.variant == "center_v1":
                    reg = torch.sigmoid(reg)
                parts = [reg, getattr(self, f"cen_head_{i}")(cf), cls]
            out = torch.cat(parts, dim=1).permute(0, 2, 3, 1)
            outs.append(out.contiguous().float())
        return outs
