"""RetinaNet detector (anchor-based).

Port of `detectax/models/retinanet.py`: backbone C3-C5 → FPN P3-P7 →
cross-level shared 4-layer towers → per-level anchor heads.

Head layout: by default one shared-per-level conv a head, with ``A * nc``
(class) and ``A * 4`` (regression) output channels, whose channel
``a * nc + c`` is (anchor a, class c) — the JAX package reshapes its NHWC
output ``[b, h, w, A * nc] → [b, h, w, A, nc]``, so the port permutes NCHW
to NHWC *before* the same reshape. ``per_anchor_heads=True`` is the
reference's parameterization: one separate 3x3 conv a (level, anchor) and
head kind, 90 convs in all with five levels and nine anchors.

The module takes images ``[B, H, W, 3]`` float32 and returns a list of 5
float32 tensors ``[B, h_l, w_l, A, 4 + nc]`` laid out ``[reg(4),
cls(nc)]``, the regression anchor-relative (`ops.assign.
retinanet_assign_level`). Inside it runs NCHW, computing in ``dtype``
(float32 or bfloat16; the parameters stay float32). Sub-modules are named
after the Flax parameter tree (``cls_head_{i}``, ``cls_head_{i}_anchor_
{a}``, ...), so `detectax_torch.tools.from_flax` maps weights name for
name.
"""
from __future__ import annotations

import torch
from torch import nn

from detectax_torch.models.backbones import build_backbone
from detectax_torch.models.fpn import FPN
from detectax_torch.models.heads import ConvTower, HeadConv
from detectax_torch.models.layers import init_parameters

N_LEVELS = 5


class RetinaNet(nn.Module):
    """``generator`` seeds the initial weights (default: a fresh generator
    seeded with 0); ``freeze_bn`` keeps the backbone's BatchNorm on its
    running statistics under ``train=True``."""

    family = "retinanet"

    def __init__(self, num_classes: int, n_anchors: int = 9,
                 backbone: str = "resnet50", features: int = 256,
                 per_anchor_heads: bool = False, freeze_bn: bool = False,
                 generator: torch.Generator | None = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_classes = int(num_classes)
        self.n_anchors = int(n_anchors)
        self.backbone_name = backbone
        self.features = int(features)
        self.per_anchor_heads = bool(per_anchor_heads)
        self.freeze_bn = bool(freeze_bn)
        self.compute_dtype = dtype

        self.backbone = build_backbone(backbone, dtype)
        self.fpn = FPN(self.backbone.out_channels, features, dtype=dtype)
        self.cls_tower = ConvTower(features, features, dtype=dtype)
        self.reg_tower = ConvTower(features, features, dtype=dtype)
        nc, na = self.num_classes, self.n_anchors
        for i in range(1, N_LEVELS + 1):
            if self.per_anchor_heads:
                for a in range(1, na + 1):
                    self.add_module(
                        f"cls_head_{i}_anchor_{a}",
                        HeadConv(features, nc, focal_bias=True, dtype=dtype))
                    self.add_module(f"reg_head_{i}_anchor_{a}",
                                    HeadConv(features, 4, dtype=dtype))
            else:
                self.add_module(
                    f"cls_head_{i}",
                    HeadConv(features, na * nc, focal_bias=True, dtype=dtype))
                self.add_module(f"reg_head_{i}",
                                HeadConv(features, na * 4, dtype=dtype))
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        init_parameters(self, generator)

    def _heads(self, i: int, cf: torch.Tensor, rf: torch.Tensor):
        """(cls ``[B, h, w, A, nc]``, reg ``[B, h, w, A, 4]``) of level i."""
        b, _, h, w = cf.shape
        na = self.n_anchors
        if self.per_anchor_heads:
            cls = torch.stack([
                getattr(self, f"cls_head_{i}_anchor_{a}")(cf)
                for a in range(1, na + 1)], dim=1)   # [B, A, nc, h, w]
            reg = torch.stack([
                getattr(self, f"reg_head_{i}_anchor_{a}")(rf)
                for a in range(1, na + 1)], dim=1)   # [B, A, 4, h, w]
            return cls.permute(0, 3, 4, 1, 2), reg.permute(0, 3, 4, 1, 2)
        # NHWC first, then the JAX package's reshape: channel a * nc + c
        # is (anchor a, class c)
        cls = getattr(self, f"cls_head_{i}")(cf).permute(0, 2, 3, 1)
        reg = getattr(self, f"reg_head_{i}")(rf).permute(0, 2, 3, 1)
        return (cls.reshape(b, h, w, na, self.num_classes),
                reg.reshape(b, h, w, na, 4))

    def forward(self, x: torch.Tensor, train: bool = False):
        x = x.permute(0, 3, 1, 2).contiguous()
        taps = self.backbone(x, train and not self.freeze_bn)
        outs = []
        for i, p in enumerate(self.fpn(taps), start=1):
            cls, reg = self._heads(i, self.cls_tower(p), self.reg_tower(p))
            outs.append(torch.cat([reg, cls], dim=-1).float().contiguous())
        return outs
