"""Shared NN building blocks (torch ``nn.Module``s).

Port of `detectax/models/layers.py`. Public functions take and return the
JAX package's NHWC layout; modules run NCHW inside (the detector permutes
once at its input and once per output level). Sub-module names follow the
Flax parameter tree ("Conv_0", "BatchNorm_0", ...), so
`detectax_torch.tools.from_flax` maps a Flax tree onto a ``state_dict``
name for name.

The hourglass blocks of the JAX file are not ported yet.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from detectax_torch.ops.pool import pad_same

# Focal-prior bias log(0.01/0.99) used by every classification head.
FOCAL_BIAS = math.log(0.01 / 0.99)


class BatchNorm(nn.Module):
    """Inference BatchNorm over the channel dim of an NCHW tensor, with the
    Flax module's parameters (`weight`/`bias` = scale/bias, `running_mean`,
    `running_var`).

    ``train=True`` (batch statistics and the running-average update) is
    part of the training path, which is not ported yet: the argument is
    kept and raises.
    """

    def __init__(self, features: int, epsilon: float = 1e-5,
                 momentum: float = 0.9):
        super().__init__()
        self.epsilon = float(epsilon)
        self.momentum = float(momentum)
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if train:
            raise NotImplementedError(
                "BatchNorm training statistics are not ported yet; the "
                "port runs inference only (train=False)"
            )
        return F.batch_norm(
            x, self.running_mean, self.running_var, self.weight, self.bias,
            False, 0.0, self.epsilon,
        )


class Conv(nn.Conv2d):
    """``nn.Conv2d`` with the JAX package's padding vocabulary: "SAME"
    (XLA's, asymmetric under stride, see `ops.pool.same_pad`), "VALID", or
    explicit ``((top, bottom), (left, right))``."""

    def __init__(self, in_features: int, features: int, kernel: int,
                 stride: int = 1, padding="SAME", use_bias: bool = True,
                 groups: int = 1):
        super().__init__(in_features, features, kernel, stride=stride,
                         padding=0, bias=use_bias, groups=groups)
        if isinstance(padding, str):
            if padding not in ("SAME", "VALID"):
                raise ValueError(f"unknown padding {padding!r}")
            self.pad_mode = padding
        else:
            (t, b), (l, r) = padding
            self.pad_mode = (int(l), int(r), int(t), int(b))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.pad_mode == "SAME":
            x = pad_same(x, self.kernel_size[0], self.stride[0])
        elif self.pad_mode != "VALID":
            x = F.pad(x, self.pad_mode)
        return super().forward(x)


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


def space_to_depth(x: torch.Tensor, block: int) -> torch.Tensor:
    """[B, H, W, C] -> [B, H/b, W/b, C*b*b] (pixel-unshuffle, channels
    packed as (dy, dx, c))."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // block, block, w // block, block, c)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h // block, w // block, c * block * block)


def depth_to_space(x: torch.Tensor, block: int) -> torch.Tensor:
    """[B, H, W, C] -> [B, H*b, W*b, C/(b*b)] (inverse of space_to_depth)."""
    b, h, w, c = x.shape
    cs = c // (block * block)
    x = x.reshape(b, h, w, block, block, cs)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h * block, w * block, cs)


class ConvBN(nn.Module):
    """Conv + BatchNorm + optional ReLU over NCHW.

    `padding` may be "SAME", "VALID", or explicit ((t,b),(l,r)) — the
    latter reproduces the Keras/torch ZeroPadding+valid stem convention.
    `s2d=True` asks the JAX package for a space-to-depth evaluation of a
    7x7/s2 stem; that is the same function of the same parameters, and the
    port always evaluates it as the plain 7x7 conv it equals.
    """

    def __init__(self, in_features: int, features: int, kernel: int = 3,
                 stride: int = 1, use_bias: bool = False, act=True,
                 groups: int = 1, padding="SAME", s2d: bool = False,
                 bn_eps: float = 1e-5):
        super().__init__()
        if s2d and not (kernel == 7 and stride == 2 and groups == 1):
            raise ValueError("s2d applies to 7x7 / stride-2 stems only")
        if act not in (True, False, "relu", "relu6"):
            raise ValueError(f"unknown activation {act!r}")
        self.act = act
        self.Conv_0 = Conv(in_features, features, kernel, stride=stride,
                           padding=padding, use_bias=use_bias, groups=groups)
        self.BatchNorm_0 = BatchNorm(features, epsilon=bn_eps)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = self.BatchNorm_0(self.Conv_0(x), train)
        if self.act == "relu6":
            return F.relu6(x)
        if self.act:
            return F.relu(x)
        return x


def init_parameters(module: nn.Module, generator: torch.Generator) -> None:
    """Seeded initial weights, the Flax modules' scheme: conv kernels
    LeCun-normal (variance 1/fan_in), conv biases zero — or the focal prior
    where the conv is marked ``focal_bias`` — BatchNorm scale one, bias
    zero, running mean zero, running variance one."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, nn.Conv2d):
                fan_in = m.weight[0].numel()
                m.weight.normal_(0.0, math.sqrt(1.0 / fan_in),
                                 generator=generator)
                if m.bias is not None:
                    m.bias.fill_(
                        FOCAL_BIAS if getattr(m, "focal_bias", False) else 0.0
                    )
            elif isinstance(m, BatchNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
                m.running_mean.zero_()
                m.running_var.fill_(1.0)
