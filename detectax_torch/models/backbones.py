"""Backbone zoo (torch, NCHW inside).

Port of `detectax/models/backbones.py`: ResNet-50/101/152, ResNeXt-50/101
(grouped convolutions), MobileNetV2 and the tiny test trunk. Each backbone
maps an NCHW image batch to the C3/C4/C5 taps (strides 8/16/32) and names
its tap widths in ``out_channels``. ``flax_name`` is the name the Flax
parameter tree gives the trunk inside a detector. ``dtype`` is the compute
dtype of every layer (the parameters stay float32).
"""
from __future__ import annotations

import os
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from detectax_torch.models.layers import (
    BatchNorm,
    Conv,
    ConvBN,
    bn_f32_stats,
)
from detectax_torch.ops.pool import max_pool_3x3_s2


class BottleneckBlock(nn.Module):
    """ResNet bottleneck: 1x1 -> 3x3 -> 1x1(x4), BN+ReLU.

    `stride_first=False` (default) puts the stride on the 3x3 (v1.5);
    `stride_first=True` puts it on the first 1x1 (Keras/original v1).
    `torch_pad` pads the 3x3 symmetrically (1,1) as torchvision does, where
    "SAME" pads a stride-2 3x3 (0,1) on an even side.
    """

    def __init__(self, in_features: int, features: int, stride: int = 1,
                 groups: int = 1, expansion: int = 4, project: bool = False,
                 stride_first: bool = False, conv_bias: bool = False,
                 torch_pad: bool = False, bn_eps: float = 1e-5,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        s1 = stride if stride_first else 1
        s3 = 1 if stride_first else stride
        out_ch = expansion * features
        pad3 = ((1, 1), (1, 1)) if torch_pad else "SAME"
        kw = dict(use_bias=conv_bias, bn_eps=bn_eps, dtype=dtype)
        self.proj = (
            ConvBN(in_features, out_ch, kernel=1, stride=stride, act=False,
                   **kw)
            if project else None
        )
        self.ConvBN_0 = ConvBN(in_features, features, kernel=1, stride=s1,
                               **kw)
        self.ConvBN_1 = ConvBN(features, features, kernel=3, stride=s3,
                               groups=groups, padding=pad3, **kw)
        self.ConvBN_2 = ConvBN(features, out_ch, kernel=1, act=False, **kw)
        self.out_features = out_ch

    def forward(self, x, train: bool = False):
        shortcut = x if self.proj is None else self.proj(x, train)
        h = self.ConvBN_0(x, train)
        h = self.ConvBN_1(h, train)
        h = self.ConvBN_2(h, train)
        return F.relu(h + shortcut)


class ResNet(nn.Module):
    """ResNet / ResNeXt trunk with C3/C4/C5 taps.

    `stage_sizes`: blocks per stage (C2..C5), e.g. (3,4,6,3) for ResNet-50.
    `groups=32, width_factor=2, expansion=2` yields ResNeXt 32x4d.
    `keras_compat` / `torch_compat` switch stride placement, padding, BN
    eps and conv bias to those zoos' conventions, so ported weights
    reproduce their features.

    `s2d_stem` evaluates the 7x7/s2 stem conv as a 4x4/s1 conv over
    space-to-depth input (`layers.S2DConv7x7`: the same function and
    parameters); ``None`` reads ``DETECTAX_S2D_STEM=1`` at every call, as
    the JAX package reads it at every trace. Either way a call whose input
    has an odd H or W takes the plain stem.
    """

    flax_name = "ResNet_0"

    def __init__(self, stage_sizes: Sequence[int] = (3, 4, 6, 3),
                 width: int = 64, groups: int = 1, width_factor: int = 1,
                 expansion: int = 4, keras_compat: bool = False,
                 torch_compat: bool = False, in_features: int = 3,
                 s2d_stem: bool | None = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if keras_compat and torch_compat:
            raise ValueError("keras_compat and torch_compat exclude each "
                             "other")
        self.compat_stem = keras_compat or torch_compat
        self.s2d_stem = s2d_stem
        bn_eps = 1.001e-5 if keras_compat else 1e-5
        # built able to take either evaluation; `forward` picks one a call
        if self.compat_stem:
            # explicit (3,3) pad + 7x7/2 VALID conv (torch convs carry no
            # bias), then (1,1) zero pad + 3x3/2 VALID max pool
            self.stem = ConvBN(in_features, width, kernel=7, stride=2,
                               padding=((3, 3), (3, 3)),
                               use_bias=keras_compat, bn_eps=bn_eps,
                               s2d=True, dtype=dtype)
        else:
            self.stem = ConvBN(in_features, width, kernel=7, stride=2,
                               s2d=True, dtype=dtype)
        self.block_names = []
        self.out_channels = {}
        ch = width
        for stage, n_blocks in enumerate(stage_sizes):
            feats = width * (2 ** stage) * width_factor
            for blk in range(n_blocks):
                block = BottleneckBlock(
                    ch, feats,
                    stride=2 if (blk == 0 and stage > 0) else 1,
                    groups=groups, expansion=expansion, project=(blk == 0),
                    stride_first=keras_compat, conv_bias=keras_compat,
                    torch_pad=torch_compat, bn_eps=bn_eps, dtype=dtype,
                )
                name = f"stage{stage + 2}_block{blk}"
                self.add_module(name, block)
                self.block_names.append((name, stage, blk == n_blocks - 1))
                ch = block.out_features
            if stage >= 1:
                self.out_channels[f"c{stage + 2}"] = ch

    def forward(self, x, train: bool = False):
        s2d = self.s2d_stem
        if s2d is None:
            s2d = os.environ.get("DETECTAX_S2D_STEM") == "1"
        s2d = s2d and x.shape[-2] % 2 == 0 and x.shape[-1] % 2 == 0
        h = self.stem(x, train, s2d=s2d)
        if self.compat_stem:
            # zero pad == -inf pad here: the input is post-ReLU
            h = F.max_pool2d(F.pad(h, (1, 1, 1, 1)), kernel_size=3, stride=2)
        else:
            # DETECTAX_POOL_VJP=1 swaps in the backward that splits a tied
            # window's gradient (ops/pool.py), as in the JAX package
            h = max_pool_3x3_s2(h)
        taps = {}
        for name, stage, last in self.block_names:
            h = getattr(self, name)(h, train)
            if last and stage >= 1:
                taps[f"c{stage + 2}"] = h
        return taps  # c3: stride 8, c4: stride 16, c5: stride 32


class InvertedResidual(nn.Module):
    """MobileNetV2 inverted residual block."""

    def __init__(self, in_features: int, features: int, stride: int = 1,
                 expand: int = 6, bn_eps: float = 1e-3,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        hidden = in_features * expand
        self.expand = (
            ConvBN(in_features, hidden, kernel=1, act="relu6", bn_eps=bn_eps,
                   dtype=dtype)
            if expand != 1 else None
        )
        self.depthwise = Conv(hidden, hidden, 3, stride=stride,
                              padding="SAME", use_bias=False, groups=hidden,
                              dtype=dtype)
        self.BatchNorm_0 = BatchNorm(
            hidden, epsilon=bn_eps, dtype=dtype,
            force_float32_reductions=bn_f32_stats())
        self.project = ConvBN(hidden, features, kernel=1, act=False,
                              bn_eps=bn_eps, dtype=dtype)
        self.residual = stride == 1 and in_features == features

    def forward(self, x, train: bool = False):
        h = x if self.expand is None else self.expand(x, train)
        h = F.relu6(self.BatchNorm_0(self.depthwise(h), train))
        h = self.project(h, train)
        return h + x if self.residual else h


# (expand, channels, repeats, first-stride) per group — standard MobileNetV2
MBV2_CONFIG = (
    (1, 16, 1, 1),
    (6, 24, 2, 2),
    (6, 32, 3, 2),
    (6, 64, 4, 2),
    (6, 96, 3, 1),
    (6, 160, 3, 2),
    (6, 320, 1, 1),
)


class MobileNetV2(nn.Module):
    """MobileNetV2 trunk with taps at stride 8 (after the 32-ch group),
    stride 16 (after the 96-ch group) and stride 32 (the final 1280-ch
    conv). BN eps 1e-3 is the Keras MobileNetV2 convention."""

    flax_name = "MobileNetV2_0"

    def __init__(self, width_mult: float = 1.0, bn_eps: float = 1e-3,
                 in_features: int = 3, dtype: torch.dtype = torch.float32):
        super().__init__()

        def c(ch):
            return max(8, int(ch * width_mult + 4) // 8 * 8)

        self.stem = ConvBN(in_features, c(32), kernel=3, stride=2,
                           act="relu6", bn_eps=bn_eps, dtype=dtype)
        self.block_names = []
        self.out_channels = {}
        ch = c(32)
        for gi, (exp, width, reps, s0) in enumerate(MBV2_CONFIG):
            for r in range(reps):
                name = f"group{gi}_block{r}"
                self.add_module(name, InvertedResidual(
                    ch, c(width), stride=s0 if r == 0 else 1, expand=exp,
                    bn_eps=bn_eps, dtype=dtype,
                ))
                tap = {2: "c3", 4: "c4"}.get(gi) if r == reps - 1 else None
                self.block_names.append((name, tap))
                ch = c(width)
                if tap:
                    self.out_channels[tap] = ch
        self.head_conv = ConvBN(ch, c(1280), kernel=1, act="relu6",
                                bn_eps=bn_eps, dtype=dtype)
        self.out_channels["c5"] = c(1280)

    def forward(self, x, train: bool = False):
        h = self.stem(x, train)
        taps = {}
        for name, tap in self.block_names:
            h = getattr(self, name)(h, train)
            if tap:
                taps[tap] = h
        taps["c5"] = self.head_conv(h, train)
        return taps


class TinyBackbone(nn.Module):
    """Minimal 3-tap trunk for tests and harnesses — not a reference model;
    it exists so machinery tests run in seconds."""

    flax_name = "TinyBackbone_0"

    def __init__(self, width: int = 16, in_features: int = 3,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        widths = (width, width, width * 2, width * 4, width * 8)
        ch = in_features
        for i, w in enumerate(widths):
            self.add_module(f"ConvBN_{i}", ConvBN(ch, w, kernel=3, stride=2,
                                                  dtype=dtype))
            ch = w
        self.out_channels = {"c3": widths[2], "c4": widths[3],
                             "c5": widths[4]}

    def forward(self, x, train: bool = False):
        h = self.ConvBN_1(self.ConvBN_0(x, train), train)
        c3 = self.ConvBN_2(h, train)
        c4 = self.ConvBN_3(c3, train)
        c5 = self.ConvBN_4(c4, train)
        return {"c3": c3, "c4": c4, "c5": c5}


BACKBONES = {
    "tiny": lambda **kw: TinyBackbone(**kw),
    "resnet50": lambda **kw: ResNet(stage_sizes=(3, 4, 6, 3), **kw),
    "resnet101": lambda **kw: ResNet(stage_sizes=(3, 4, 23, 3), **kw),
    "resnet152": lambda **kw: ResNet(stage_sizes=(3, 8, 36, 3), **kw),
    "resnext50": lambda **kw: ResNet(
        stage_sizes=(3, 4, 6, 3), groups=32, width_factor=2, expansion=2,
        **kw,
    ),
    "resnext101": lambda **kw: ResNet(
        stage_sizes=(3, 4, 23, 3), groups=32, width_factor=2, expansion=2,
        **kw,
    ),
    "mobilenetv2": lambda **kw: MobileNetV2(**kw),
}


def build_backbone(name: str,
                   dtype: torch.dtype = torch.float32) -> nn.Module:
    """Build a backbone by name, e.g. ``"resnet50"``, computing in
    ``dtype``.

    A ``:keras`` / ``:torch`` suffix (``"resnet50:keras"``,
    ``"resnext50:torch"``) builds the trunk with that zoo's exact
    conventions (stride placement, padding, BN eps, conv bias), so weights
    ported from it reproduce the pretrained features. MobileNetV2 is
    already Keras-geometry, so ``:keras`` is a no-op for it.
    """
    name = name.lower()
    compat = "none"
    if ":" in name:
        name, compat = name.split(":", 1)
    if name not in BACKBONES:
        raise ValueError(
            f"unknown backbone {name!r}; options: {sorted(BACKBONES)}"
        )
    if compat == "none" or (compat == "keras" and name == "mobilenetv2"):
        return BACKBONES[name](dtype=dtype)
    if not name.startswith("res"):
        raise ValueError(
            f"compat suffix {compat!r} unsupported for backbone {name!r}"
        )
    if compat == "keras":
        return BACKBONES[name](keras_compat=True, dtype=dtype)
    if compat == "torch":
        return BACKBONES[name](torch_compat=True, dtype=dtype)
    raise ValueError(f"unknown backbone compat {compat!r} (keras|torch)")
