"""The CenterNet family: on a ResNet-style backbone (stride-8 single map),
and the hourglass models.

Port of `detectax/models/centernet.py`: `CenterNetS8`,
`CenterNetFPNSingle`, `HourglassNet`, `BottleneckHGBlock` and
`StackedHourglass`.

* `CenterNetS8` — backbone → top-down FPN collapsed to one stride-8 map →
  shared towers → ``n_scales`` per-scale head conv pairs → output
  ``[B, H/8, W/8, S, 4+nc]`` with layout ``[sigmoid reg(4), cls(nc)]``.
  Each tower is computed once and feeds every scale's heads.
* `CenterNetFPNSingle` — the same neck and towers, one cls(nc+1) +
  reg(4+1) head pair, output ``[B, H/8, W/8, 4+1+(nc+1)]`` with layout
  ``[ltrb(4), cen(1), cls(nc+1)]`` (heatmap variant; class index 0 is the
  objectness slot).
* `HourglassNet` — a six-stage encoder-decoder of `HourglassConvBlock`s
  whose twelve stage outputs are re-laid to stride 8 and concatenated,
  output ``[B, H/8, W/8, 4, 5+nc]`` with layout ``[sigmoid reg(4),
  objectness(1), cls(nc)]`` (four scale slots).
* `StackedHourglass` — a stride-4 stem and ``n_stacks`` four-level
  hourglasses of `BottleneckHGBlock`s, output ``[B, H/4, W/4, 4+nc]``
  with layout ``[raw (t, b, l, r)(4), cls(nc)]``.

All take images ``[B, H, W, 3]`` and return float32 in the JAX package's
channel-last layouts; inside they run NCHW, computing in ``dtype``
(float32 or bfloat16; the parameters stay float32). Sub-modules are named
after the Flax parameter tree, so `detectax_torch.tools.from_flax` maps
weights name for name.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch import nn

from detectax_torch.models.backbones import build_backbone
from detectax_torch.models.fpn import S8CollapseFPN
from detectax_torch.models.heads import ConvTower, HeadConv
from detectax_torch.models.layers import (
    Conv,
    FocalBias,
    HourglassConvBlock,
    HourglassDownsample,
    depth_to_space_nchw,
    hourglass_bn,
    hourglass_conv,
    init_parameters,
    space_to_depth_nchw,
    upsample2x_nchw,
)
from detectax_torch.ops.pool import pad_same


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


def _seeded_init(module: nn.Module, generator: torch.Generator | None):
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    init_parameters(module, generator)


class HourglassNet(nn.Module):
    """The hourglass CenterNet: a stride-1 stem, six [`HourglassConvBlock`
    (+ residual from stage 2 on) → `HourglassDownsample`] encoder stages
    (channels ``nf`` → ``64·nf``), six [skip add → bilinear 2x →
    `HourglassConvBlock`] decoder stages, the twelve stage outputs re-laid
    to stride 8 (`space_to_depth` / `depth_to_space`, channels packed
    (dy, dx, c)) and concatenated — encoder outputs first, then decoder
    outputs, ``189·nf`` channels — then ``final_out`` (``n_features``) and
    a 3x3 head of ``4·(5+nc)`` channels reshaped to four slots."""

    family = "hourglass"

    def __init__(self, num_classes: int, n_filters: int = 16,
                 n_repeats: int = 2, n_features: int = 256,
                 separable: bool = True, batch_norm: bool = True,
                 norm_order: str = "norm_first",
                 generator: torch.Generator | None = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_classes = int(num_classes)
        self.n_filters = nf = int(n_filters)
        self.compute_dtype = dtype

        def blk(cin, f):
            return HourglassConvBlock(
                cin, f, 3, 1, n_repeats=n_repeats, separable=separable,
                batch_norm=batch_norm, norm_order=norm_order, dtype=dtype)

        self.cnn_block_0 = hourglass_conv(separable, 3, nf, 3, 1, dtype)
        for i in range(1, 7):
            width = nf * 2 ** (i - 1)
            self.add_module(f"cnn_block_{i}", blk(width, width))
            self.add_module(f"down_block_{i}", HourglassDownsample(
                width, 2 * width, 3, separable=separable,
                batch_norm=batch_norm, norm_order=norm_order, dtype=dtype))
        for i in range(1, 7):
            self.add_module(f"dec_block_{i}",
                            blk(nf * 2 ** (7 - i), nf * 2 ** (6 - i)))
        # 63·nf channels from the encoder outputs, 126·nf from the decoder's
        self.final_out = blk(189 * nf, n_features)
        self.head_out = Conv(n_features, 4 * (5 + self.num_classes), 3,
                             dtype=dtype)
        self.b_focal = FocalBias()
        _seeded_init(self, generator)

    @staticmethod
    def _to_s8(t: torch.Tensor, stride: int) -> torch.Tensor:
        if stride > 8:
            return depth_to_space_nchw(t, stride // 8)
        if stride < 8:
            return space_to_depth_nchw(t, 8 // stride)
        return t

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        h = self.cnn_block_0(x.permute(0, 3, 1, 2).contiguous())
        enc_in, enc_out = [], []
        for i in range(1, 7):
            c = getattr(self, f"cnn_block_{i}")(h, train)
            blk_in = c if i == 1 else h + c
            h = getattr(self, f"down_block_{i}")(blk_in, train)
            enc_in.append(blk_in)   # stride 2^(i-1)
            enc_out.append(h)       # stride 2^i
        d = h
        dec_outs = []
        for i in range(1, 7):
            if i > 1:               # dec_i's skip: the input of block 8-i
                d = enc_in[7 - i] + d
            d = upsample2x_nchw(d, "bilinear")
            d = getattr(self, f"dec_block_{i}")(d, train)
            dec_outs.append(d)      # stride 2^(6-i)
        feats = [self._to_s8(t, 2 ** (i + 1)) for i, t in enumerate(enc_out)]
        feats += [self._to_s8(t, 2 ** (5 - i)) for i, t in enumerate(dec_outs)]
        feat = self.final_out(torch.cat(feats, dim=1), train)
        head = self.head_out(feat)                       # [B, 4(5+nc), h, w]
        b, _, hh, ww = head.shape
        # NHWC first: the slots split the channel axis as the JAX package's
        # reshape of [b, h, w, 4·(5+nc)] does
        head = head.permute(0, 2, 3, 1).reshape(b, hh, ww, 4,
                                                5 + self.num_classes)
        reg = torch.sigmoid(head[..., :4])
        cls = self.b_focal(head[..., 4:])
        return torch.cat([reg, cls], dim=-1).float()


class BottleneckHGBlock(nn.Module):
    """``n_repeats`` of [BatchNorm → (separable) 1x1 to ``n_filters``
    (``bot_i``) → kxk (``cnn_i``) → 1x1 to ``2·n_filters`` (``out_i``) →
    ReLU], each repeat from the second on adding its input. The first
    repeat's BatchNorm runs over ``in_features``, the others over
    ``2·n_filters``."""

    def __init__(self, in_features: int, n_filters: int, kernel: int = 3,
                 n_repeats: int = 2, separable: bool = True,
                 batch_norm: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.n_repeats = int(n_repeats)
        self.batch_norm = bool(batch_norm)
        nf = int(n_filters)
        conv = functools.partial(hourglass_conv, separable, stride=1,
                                 dtype=dtype)
        for i in range(self.n_repeats):
            cin = in_features if i == 0 else 2 * nf
            if self.batch_norm:
                self.add_module(f"bn_{i}", hourglass_bn(cin, dtype))
            self.add_module(f"bot_{i}", conv(cin, nf, 1))
            self.add_module(f"cnn_{i}", conv(nf, nf, kernel))
            self.add_module(f"out_{i}", conv(nf, 2 * nf, 1))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        inp = x
        for i in range(self.n_repeats):
            h = inp
            if self.batch_norm:
                h = getattr(self, f"bn_{i}")(h, train)
            h = getattr(self, f"bot_{i}")(h)
            h = getattr(self, f"cnn_{i}")(h)
            h = getattr(self, f"out_{i}")(h)
            h = F.relu(h)
            inp = h if i == 0 else h + inp
        return inp


def _max_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """2x2 / stride-2 max pool with "SAME" padding (-inf on the high side
    of an odd size), over NCHW."""
    return F.max_pool2d(pad_same(x, 2, 2, value=float("-inf")), 2, 2)


class StackedHourglass(nn.Module):
    """Stem (7x7 / stride-2 (separable) conv, `BottleneckHGBlock`, 2x2 max
    pool: stride 4), then ``n_stacks`` hourglasses of four encoder levels
    [block(s) + residual → max pool] and four decoder levels [bilinear 2x
    + skip block → out block], then a 3x3 head of ``4+nc`` channels: raw
    (t, b, l, r) regression and the class logits plus `FocalBias`. Only
    the last stack is headed."""

    family = "stacked_hourglass"
    output_stride = 4

    def __init__(self, num_classes: int, n_filters: int = 128,
                 n_stacks: int = 1, n_repeats: int = 2,
                 separable: bool = True, batch_norm: bool = True,
                 generator: torch.Generator | None = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_classes = int(num_classes)
        self.n_filters = nf = int(n_filters)
        self.n_stacks = int(n_stacks)
        self.compute_dtype = dtype

        def blk(cin):
            return BottleneckHGBlock(cin, nf, 3, n_repeats=n_repeats,
                                     separable=separable,
                                     batch_norm=batch_norm, dtype=dtype)

        self.cnn_block_0 = hourglass_conv(separable, 3, nf, 7, 2, dtype)
        self.cnn_block_1 = blk(nf)
        for s in range(self.n_stacks):
            pre = f"stack_{s + 1}_"
            for name in ("enc_block_1", "enc_block_2", "enc_block_3",
                         "enc_block_4a", "enc_block_4b", "enc_block_4"):
                self.add_module(pre + name, blk(2 * nf))
            for lvl in range(1, 5):
                self.add_module(pre + f"dec_block_{lvl}", blk(2 * nf))
                self.add_module(pre + f"dec_out_{lvl}", blk(2 * nf))
        self.cnn_out = Conv(2 * nf, 4 + self.num_classes, 3, dtype=dtype)
        self.b_focal = FocalBias()
        _seeded_init(self, generator)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        h = self.cnn_block_0(x.permute(0, 3, 1, 2).contiguous())
        h = _max_pool_2x2(self.cnn_block_1(h, train))
        for s in range(self.n_stacks):
            blk = lambda name, s=s: getattr(self, f"stack_{s + 1}_{name}")
            e_in = []
            cur = h
            for lvl in range(1, 5):
                if lvl < 4:
                    c = blk(f"enc_block_{lvl}")(cur, train)
                else:
                    c = blk("enc_block_4a")(cur, train)
                    c = blk("enc_block_4b")(c, train)
                    c = blk("enc_block_4")(c, train)
                e_in.append(cur)
                cur = _max_pool_2x2(cur + c)
            d = cur
            for lvl in range(1, 5):
                up = upsample2x_nchw(d, "bilinear")
                skip = blk(f"dec_block_{lvl}")(e_in[4 - lvl], train)
                d = blk(f"dec_out_{lvl}")(skip + up, train)
            h = d
        head = self.cnn_out(h).permute(0, 2, 3, 1)       # [B, h, w, 4+nc]
        # the regression stays raw: (t, b, l, r) half-extents in stride
        # units, unbounded above 1
        cls = self.b_focal(head[..., 4:])
        return torch.cat([head[..., :4], cls], dim=-1).float()
