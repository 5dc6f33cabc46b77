"""Shared NN building blocks (torch ``nn.Module``s).

Port of `detectax/models/layers.py`. Public functions take and return the
JAX package's NHWC layout; modules run NCHW inside (the detector permutes
once at its input and once per output level). Sub-module names follow the
Flax parameter tree ("Conv_0", "BatchNorm_0", ...), so
`detectax_torch.tools.from_flax` maps a Flax tree onto a ``state_dict``
name for name.

The hourglass blocks of the JAX file (`SeparableConv`,
`HourglassConvBlock`, `HourglassDownsample`, `FocalBias`) take their input
channel count as a first argument, where Flax reads it off the input.
"""
from __future__ import annotations

import math
import os

import torch
import torch.nn.functional as F
from torch import nn

from detectax_torch.ops.pool import pad_same
from detectax_torch.parallel.mesh import all_reduce_sum, batch_stats_group

# Focal-prior bias log(0.01/0.99) used by every classification head.
FOCAL_BIAS = math.log(0.01 / 0.99)
# The standard deviation of a standard normal truncated to [-2, 2]
# (`jax.nn.initializers.variance_scaling`'s constant).
TRUNC_NORMAL_STD = 0.87962566103423978


def cast(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``t`` in ``dtype``: ``t`` itself where it already is (as
    ``Tensor.to`` returns it), so that a traced graph holds no cast, and
    no assertion of one, where the compute dtype is the parameters'."""
    return t if t.dtype == dtype else t.to(dtype)


def bn_f32_stats() -> bool:
    """Whether BatchNorm statistics reduce in float32 (the default).
    ``DETECTAX_BN_BF16_STATS=1`` reduces them in the compute dtype instead
    — the JAX package's switch of the same name, which has an effect under
    bf16 compute only. Read where a block with BatchNorm is built."""
    return os.environ.get("DETECTAX_BN_BF16_STATS", "0") != "1"


def bn_stat_subset() -> int:
    """Batch-subset divisor for BatchNorm statistics:
    ``DETECTAX_BN_STAT_SUBSET=k`` takes the batch statistics from the first
    ``B // k`` examples when ``B >= k`` (the full batch is still normalized
    and the running averages still move). 0 or 1: the whole batch. The JAX
    package's switch of the same name, read at every training forward."""
    try:
        return int(os.environ.get("DETECTAX_BN_STAT_SUBSET", "0"))
    except ValueError:
        return 0


def _global_moments(x: torch.Tensor, sub: int, red: torch.dtype,
                    dp) -> tuple[torch.Tensor, torch.Tensor]:
    """Mean and biased variance a channel over a data-parallel group's
    global batch, every rank holding ``x.shape[0]`` rows of it in rank
    order. Under `bn_stat_subset` ``k`` the rows that count are the first
    ``n // k`` of the global ``n`` (JAX's rule on the sharded batch); a
    rank that holds none of them adds zeros.

    Each rank weights its moments (mean of x and of x², reduced in
    ``red``) by its share of the counted rows, and one float32
    `all_reduce_sum` adds them, so at world size 1 the statistics are the
    ones computed without a group, bit for bit."""
    n_local = x.shape[0]
    n = n_local * dp.world_size
    rows = n // sub if sub > 1 and n >= sub else n
    take = min(max(rows - dp.rank * n_local, 0), n_local)
    xr = x[:take].to(red)
    if take:
        local = torch.stack([xr.mean(dim=(0, 2, 3)),
                             torch.square(xr).mean(dim=(0, 2, 3))])
        local = local.to(torch.float32) * (take / rows)
    else:
        # zeros that stay in the graph: the backward's all-reduce must run
        # on every rank, and autograd skips a node no parameter lies under
        local = torch.stack([xr.sum(dim=(0, 2, 3)),
                             torch.square(xr).sum(dim=(0, 2, 3))]
                            ).to(torch.float32)
    mean, mean2 = all_reduce_sum(local, dp).to(red).unbind(0)
    return mean, torch.clamp_min(mean2 - torch.square(mean), 0.0)


class BatchNorm(nn.Module):
    """BatchNorm over the channel dim of an NCHW tensor, with the Flax
    module's parameters (`weight`/`bias` = scale/bias, `running_mean`,
    `running_var`).

    ``train=True`` normalizes with the batch's statistics — mean and the
    *biased* variance ``max(E[x²] − E[x]², 0)``, reduced in float32 (in
    ``dtype`` when ``force_float32_reductions`` is off) over the first
    ``B // k`` examples under `bn_stat_subset` ``k`` — and moves the
    running averages to ``m·old + (1−m)·new`` with that same biased
    variance (``m = momentum``, 0.9 as in Flax). PyTorch's own
    ``F.batch_norm(training=True)`` stores the unbiased variance and means
    by momentum the weight of the new value, so it is not used here. The
    buffers are updated in place, outside autograd, and stay float32.
    While `parallel.mesh.batch_stats_over` holds a data-parallel group the
    statistics cover the group's global batch (`_global_moments`), so the
    running averages move alike on every rank.

    ``dtype`` is the compute dtype: as Flax's ``promote_dtype`` does, the
    input, mean, variance, scale and bias are all cast to it and the
    normalization runs in it (torch would otherwise promote a bf16 input
    against the float32 statistics and normalize in float32).
    """

    def __init__(self, features: int, epsilon: float = 1e-5,
                 momentum: float = 0.9, dtype: torch.dtype = torch.float32,
                 force_float32_reductions: bool = True):
        super().__init__()
        self.epsilon = float(epsilon)
        self.momentum = float(momentum)
        self.compute_dtype = dtype
        self.force_float32_reductions = bool(force_float32_reductions)
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        dtype = self.compute_dtype
        if train:
            sub = bn_stat_subset()
            red = torch.float32 if self.force_float32_reductions else dtype
            dp = batch_stats_group()
            if dp is not None:
                mean, var = _global_moments(x, sub, red, dp)
            else:
                xs = x
                if sub > 1 and x.shape[0] >= sub:
                    xs = x[: x.shape[0] // sub]
                xr = xs.to(red)
                mean = xr.mean(dim=(0, 2, 3))
                mean2 = torch.square(xr).mean(dim=(0, 2, 3))
                var = torch.clamp_min(mean2 - torch.square(mean), 0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(m).add_(
                    mean.to(torch.float32), alpha=1.0 - m)
                self.running_var.mul_(m).add_(
                    var.to(torch.float32), alpha=1.0 - m)
        elif dtype == torch.float32:
            return F.batch_norm(
                cast(x, dtype), self.running_mean, self.running_var,
                self.weight, self.bias, False, 0.0, self.epsilon,
            )
        else:
            mean, var = self.running_mean, self.running_var
        shape = (1, -1, 1, 1)
        xd, mean, var, scale, bias = (
            cast(t, dtype) for t in (x, mean, var, self.weight, self.bias))
        return ((xd - mean.view(shape))
                * torch.rsqrt(var.view(shape) + self.epsilon)
                * scale.view(shape) + bias.view(shape))


class Conv(nn.Conv2d):
    """``nn.Conv2d`` with the JAX package's padding vocabulary: "SAME"
    (XLA's, asymmetric under stride, see `ops.pool.same_pad`), "VALID", or
    explicit ``((top, bottom), (left, right))``.

    ``dtype`` is the compute dtype: the input, the weight and the bias are
    cast to it inside `forward` (Flax's ``promote_dtype``), so the
    parameters stay float32 and autograd carries the gradient back to
    them through the cast."""

    def __init__(self, in_features: int, features: int, kernel: int,
                 stride: int = 1, padding="SAME", use_bias: bool = True,
                 groups: int = 1, dtype: torch.dtype = torch.float32):
        super().__init__(in_features, features, kernel, stride=stride,
                         padding=0, bias=use_bias, groups=groups)
        self.compute_dtype = dtype
        if isinstance(padding, str):
            if padding not in ("SAME", "VALID"):
                raise ValueError(f"unknown padding {padding!r}")
            self.pad_mode = padding
        else:
            (t, b), (l, r) = padding
            self.pad_mode = (int(l), int(r), int(t), int(b))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = self.compute_dtype
        x = cast(x, dtype)
        if self.pad_mode == "SAME":
            x = pad_same(x, self.kernel_size[0], self.stride[0])
        elif self.pad_mode != "VALID":
            x = F.pad(x, self.pad_mode)
        bias = None if self.bias is None else cast(self.bias, dtype)
        return F.conv2d(x, cast(self.weight, dtype), bias, self.stride, 0,
                        self.dilation, self.groups)


def upsample2x(x: torch.Tensor, method: str = "nearest") -> torch.Tensor:
    """2x spatial upsampling of ``[B, H, W, C]``; `nearest` (FPN residual
    paths) or `bilinear` (half-pixel centres)."""
    h, w = x.shape[1:3]
    return upsample_to(x, (2 * h, 2 * w), method)


def _upsample_to_nchw(x: torch.Tensor, hw, method: str) -> torch.Tensor:
    h, w = x.shape[2:]
    hw = (int(hw[0]), int(hw[1]))
    if (h, w) == hw:
        return x
    if method == "nearest":
        if hw == (2 * h, 2 * w):
            return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
        # Non-2x shapes (a stride-2 level of odd size under its lateral):
        # the JAX package falls back to `jax.image.resize`, whose nearest
        # rule samples at floor((i + 0.5) * in / out) — torch calls that
        # "nearest-exact" ("nearest" would sample at floor(i * in / out)).
        return F.interpolate(x, size=hw, mode="nearest-exact")
    if method == "bilinear":
        # half-pixel centres, edges clamped; equals `jax.image.resize`
        # when upsampling (no antialiasing is involved in that direction)
        return F.interpolate(x, size=hw, mode="bilinear",
                             align_corners=False)
    raise ValueError(f"unknown upsample method {method!r}")


def upsample_to(x: torch.Tensor, hw: tuple,
                method: str = "nearest") -> torch.Tensor:
    """Upsample ``[B, H, W, C]`` to an exact spatial shape (robust when
    stride-2 levels bottom out at odd sizes and a plain 2x repeat would
    mismatch the lateral)."""
    return _upsample_to_nchw(
        x.permute(0, 3, 1, 2), hw, method
    ).permute(0, 2, 3, 1)


def upsample2x_nchw(x: torch.Tensor, method: str = "nearest") -> torch.Tensor:
    """`upsample2x` of an NCHW tensor."""
    h, w = x.shape[2:]
    return _upsample_to_nchw(x, (2 * h, 2 * w), method)


def space_to_depth_nchw(x: torch.Tensor, block: int) -> torch.Tensor:
    """[B, C, H, W] -> [B, C*b*b, H/b, W/b], the JAX package's
    `space_to_depth` on NCHW: the output channels are packed as (dy, dx,
    c) (torch's ``pixel_unshuffle`` packs (c, dy, dx))."""
    b, c, h, w = x.shape
    x = x.reshape(b, c, h // block, block, w // block, block)
    x = x.permute(0, 3, 5, 1, 2, 4)
    return x.reshape(b, block * block * c, h // block, w // block)


def depth_to_space_nchw(x: torch.Tensor, block: int) -> torch.Tensor:
    """[B, C, H, W] -> [B, C/(b*b), H*b, W*b] (inverse of
    `space_to_depth_nchw`)."""
    b, c, h, w = x.shape
    cs = c // (block * block)
    x = x.reshape(b, block, block, cs, h, w)
    x = x.permute(0, 3, 4, 1, 5, 2)
    return x.reshape(b, cs, h * block, w * block)


class S2DConv7x7(Conv):
    """A 7x7/s2 `Conv` evaluated as a 4x4/s1 conv over space-to-depth
    input: the JAX package's `_S2DConv7x7`, the same function of the same
    parameter (``weight [F, Cin, 7, 7]``, the Flax ``Conv_0/kernel``), so
    checkpoints and ported weights load unchanged.

    With 3 input channels the 7x7 conv fills a tensor-core MMA's
    contraction poorly; folding each 2x2 pixel neighbourhood into the
    channels gives Cin 12 and a 4x4 kernel. The kernel is repacked at every
    call (a pure function of the weight, so autograd carries the gradient
    back through it): padded to 8x8 on the high side for ``pad_low`` 2
    ("SAME" on an even side) or on the low side for ``pad_low`` 3 (the
    Keras / torch explicit (3, 3) stem), its taps ``t = 2a + dy`` packed as
    ``[F, (dy, dx, c), a, b]`` to match `space_to_depth_nchw`, and the
    space-to-depth input padded (1, 2) or (2, 1). The input's H and W must
    be even. ``forward(x, s2d=False)`` evaluates the plain 7x7 conv."""

    def __init__(self, in_features: int, features: int, padding="SAME",
                 use_bias: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__(in_features, features, 7, stride=2,
                         padding=padding, use_bias=use_bias, dtype=dtype)
        if padding == "SAME":
            self.pad_low = 2
        elif (not isinstance(padding, str)
              and tuple(map(tuple, padding)) == ((3, 3), (3, 3))):
            self.pad_low = 3
        else:
            raise ValueError(f"unsupported s2d stem padding {padding!r}")

    def s2d_kernel(self, dtype: torch.dtype) -> torch.Tensor:
        """The 4x4 kernel ``[F, 4 * Cin, 4, 4]`` over space-to-depth
        input, in ``dtype``."""
        w = cast(self.weight, dtype)
        f, c = w.shape[:2]
        # F.pad's order: (W low, W high, H low, H high)
        w8 = F.pad(w, (0, 1, 0, 1) if self.pad_low == 2 else (1, 0, 1, 0))
        # [f, c, a, dy, b, dx] -> [f, (dy, dx, c), a, b]
        w8 = w8.reshape(f, c, 4, 2, 4, 2).permute(0, 3, 5, 1, 2, 4)
        return w8.reshape(f, 4 * c, 4, 4)

    def forward(self, x: torch.Tensor, s2d: bool = True) -> torch.Tensor:
        if not s2d:
            return super().forward(x)
        if x.shape[-2] % 2 or x.shape[-1] % 2:
            raise ValueError(f"the s2d stem needs an even H and W, got "
                             f"{tuple(x.shape[-2:])}")
        dtype = self.compute_dtype
        lo, hi = (1, 2) if self.pad_low == 2 else (2, 1)
        xs = F.pad(space_to_depth_nchw(cast(x, dtype), 2), (lo, hi, lo, hi))
        bias = None if self.bias is None else cast(self.bias, dtype)
        return F.conv2d(xs, self.s2d_kernel(dtype), bias)


class ConvBN(nn.Module):
    """Conv + BatchNorm + optional ReLU over NCHW.

    `padding` may be "SAME", "VALID", or explicit ((t,b),(l,r)) — the
    latter reproduces the Keras/torch ZeroPadding+valid stem convention.
    `s2d=True` (7x7/s2 stems with "SAME" or ((3,3),(3,3)) padding only)
    builds the conv as `S2DConv7x7`: the same parameter, evaluated as a
    4x4/s1 conv over space-to-depth input; ``forward(..., s2d=False)``
    evaluates it as the plain 7x7 conv for that call (the ResNet stem
    decides per call, as the JAX package does). ``dtype`` is the compute
    dtype of both layers; `bn_f32_stats` is read here, when the block is
    built.
    """

    def __init__(self, in_features: int, features: int, kernel: int = 3,
                 stride: int = 1, use_bias: bool = False, act=True,
                 groups: int = 1, padding="SAME", s2d: bool = False,
                 bn_eps: float = 1e-5, dtype: torch.dtype = torch.float32):
        super().__init__()
        if s2d and not (kernel == 7 and stride == 2 and groups == 1):
            raise ValueError("s2d applies to 7x7 / stride-2 stems only")
        if act not in (True, False, "relu", "relu6"):
            raise ValueError(f"unknown activation {act!r}")
        self.act = act
        self.s2d = bool(s2d)
        if self.s2d:
            self.Conv_0 = S2DConv7x7(in_features, features, padding=padding,
                                     use_bias=use_bias, dtype=dtype)
        else:
            self.Conv_0 = Conv(in_features, features, kernel, stride=stride,
                               padding=padding, use_bias=use_bias,
                               groups=groups, dtype=dtype)
        self.BatchNorm_0 = BatchNorm(
            features, epsilon=bn_eps, dtype=dtype,
            force_float32_reductions=bn_f32_stats())

    def forward(self, x: torch.Tensor, train: bool = False,
                s2d: bool = True) -> torch.Tensor:
        h = self.Conv_0(x, s2d=s2d) if self.s2d else self.Conv_0(x)
        x = self.BatchNorm_0(h, train)
        if self.act == "relu6":
            return F.relu6(x)
        if self.act:
            return F.relu(x)
        return x


class SeparableConv(nn.Module):
    """Depthwise-separable conv (Keras SeparableConv2D): a ``kernel`` x
    ``kernel`` depthwise conv (``groups=in_features``, no bias, "SAME"
    padding, ``stride``) named ``depthwise``, then a 1x1 conv to
    ``features`` named ``pointwise`` (with a bias unless ``use_bias`` is
    off)."""

    def __init__(self, in_features: int, features: int, kernel: int = 3,
                 stride: int = 1, use_bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.depthwise = Conv(in_features, in_features, kernel,
                              stride=stride, use_bias=False,
                              groups=in_features, dtype=dtype)
        self.pointwise = Conv(in_features, features, 1, use_bias=use_bias,
                              dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.pointwise(self.depthwise(x))


def hourglass_bn(features: int, dtype: torch.dtype) -> BatchNorm:
    """The hourglass blocks' BatchNorm: momentum 0.9, epsilon 1e-5, the
    `bn_f32_stats` mode."""
    return BatchNorm(features, epsilon=1e-5, momentum=0.9, dtype=dtype,
                     force_float32_reductions=bn_f32_stats())


def hourglass_conv(separable: bool, in_features: int, features: int,
                   kernel: int, stride: int, dtype: torch.dtype):
    """A `SeparableConv`, or with ``separable`` off a plain `Conv`
    ("SAME")."""
    if separable:
        return SeparableConv(in_features, features, kernel, stride,
                             dtype=dtype)
    return Conv(in_features, features, kernel, stride=stride, dtype=dtype)


_NORM_ORDERS = ("norm_first", "norm_last")


class HourglassConvBlock(nn.Module):
    """``n_repeats`` of [BatchNorm (``norm_first``) → (separable) conv →
    BatchNorm (``norm_last``) → ReLU], each repeat from the second on
    adding its input. Repeat ``i`` holds ``bn_i`` and ``conv_i``; the first
    repeat's ``norm_first`` BatchNorm runs over ``in_features``, every
    other over ``features``."""

    def __init__(self, in_features: int, features: int, kernel: int = 3,
                 stride: int = 1, n_repeats: int = 1,
                 separable: bool = True, batch_norm: bool = True,
                 norm_order: str = "norm_first",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if norm_order not in _NORM_ORDERS:
            raise ValueError(f"unknown norm_order {norm_order!r}")
        self.n_repeats = int(n_repeats)
        self.batch_norm = bool(batch_norm)
        self.norm_first = norm_order == "norm_first"
        for i in range(self.n_repeats):
            cin = in_features if i == 0 else features
            if self.batch_norm:
                self.add_module(f"bn_{i}", hourglass_bn(
                    cin if self.norm_first else features, dtype))
            self.add_module(f"conv_{i}", hourglass_conv(
                separable, cin, features, kernel, stride, dtype))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        inp = x
        for i in range(self.n_repeats):
            h = inp
            if self.batch_norm and self.norm_first:
                h = getattr(self, f"bn_{i}")(h, train)
            h = getattr(self, f"conv_{i}")(h)
            if self.batch_norm and not self.norm_first:
                h = getattr(self, f"bn_{i}")(h, train)
            h = F.relu(h)
            inp = h if i == 0 else h + inp
        return inp


class HourglassDownsample(nn.Module):
    """BatchNorm (``norm_first``) → stride-2 (separable) conv → BatchNorm
    (``norm_last``) → ReLU. The sub-modules carry Flax's auto-names:
    ``BatchNorm_0`` and ``SeparableConv_0`` (or ``Conv_0``)."""

    def __init__(self, in_features: int, features: int, kernel: int = 3,
                 separable: bool = True, batch_norm: bool = True,
                 norm_order: str = "norm_first",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if norm_order not in _NORM_ORDERS:
            raise ValueError(f"unknown norm_order {norm_order!r}")
        self.batch_norm = bool(batch_norm)
        self.norm_first = norm_order == "norm_first"
        if self.batch_norm:
            self.BatchNorm_0 = hourglass_bn(
                in_features if self.norm_first else features, dtype)
        self.conv_name = "SeparableConv_0" if separable else "Conv_0"
        self.add_module(self.conv_name, hourglass_conv(
            separable, in_features, features, kernel, 2, dtype))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        h = x
        if self.batch_norm and self.norm_first:
            h = self.BatchNorm_0(h, train)
        h = getattr(self, self.conv_name)(h)
        if self.batch_norm and not self.norm_first:
            h = self.BatchNorm_0(h, train)
        return F.relu(h)


class FocalBias(nn.Module):
    """A trainable float32 scalar ``bias``, initialized to the focal
    prior, added to the class logits (cast to their dtype)."""

    def __init__(self, init_value: float = FOCAL_BIAS):
        super().__init__()
        self.init_value = float(init_value)
        self.bias = nn.Parameter(torch.tensor(self.init_value))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + cast(self.bias, x.dtype)


def init_parameters(module: nn.Module, generator: torch.Generator) -> None:
    """Seeded initial weights, the Flax modules' scheme: conv and dense
    kernels by Flax's ``lecun_normal()`` (``variance_scaling(1, "fan_in",
    "truncated_normal")``: a standard normal truncated to [-2, 2], scaled
    by sqrt(1/fan_in) / `TRUNC_NORMAL_STD` so that the variance is
    1/fan_in; fan_in = in/groups * kh * kw), their biases zero — or the
    focal prior where the conv is marked ``focal_bias`` — BatchNorm scale
    one, bias zero, running mean zero, running variance one, a `FocalBias`
    its initial value. The draw follows Flax's distribution, not
    ``jax.random``'s bits. The numbers are drawn on the generator's device
    and copied to the module's, so a seed gives the same weights wherever
    the module lies."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                fan_in = m.weight[0].numel()
                w = torch.empty(m.weight.shape, device=generator.device)
                nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0,
                                      generator=generator)
                m.weight.copy_(
                    w * (math.sqrt(1.0 / fan_in) / TRUNC_NORMAL_STD))
                if m.bias is not None:
                    m.bias.fill_(
                        FOCAL_BIAS if getattr(m, "focal_bias", False) else 0.0
                    )
            elif isinstance(m, BatchNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
                m.running_mean.zero_()
                m.running_var.fill_(1.0)
            elif isinstance(m, FocalBias):
                m.bias.fill_(m.init_value)
