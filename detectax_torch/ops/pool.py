"""XLA-style "SAME" padding and the 3x3 / stride-2 stem max pool.

Port of the forward of `detectax/ops/pool.py::max_pool_3x3_s2`. The tied
backward of that file belongs to the training path and is not ported yet.

XLA pads a strided window asymmetrically, by the input size: the total is
``max((ceil(n/s) - 1) * s + k - n, 0)``, the low side takes the smaller
half. A 3x3 / stride-2 window pads (0, 1) on an even side and (1, 1) on an
odd side; the 7x7 / stride-2 stem pads (2, 3) on an even side. PyTorch's
own ``padding=`` is symmetric, so the port pads explicitly.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def same_pad(size: int, k: int, s: int) -> tuple[int, int]:
    """(low, high) padding of XLA "SAME" for one spatial dimension."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def pad_same(
    x: torch.Tensor, k: int, s: int, value: float = 0.0
) -> torch.Tensor:
    """Pad the two trailing (H, W) dims of an NCHW tensor as "SAME" would."""
    top, bottom = same_pad(x.shape[-2], k, s)
    left, right = same_pad(x.shape[-1], k, s)
    if top == bottom == left == right == 0:
        return x
    return F.pad(x, (left, right, top, bottom), value=value)


def max_pool_3x3_s2(x: torch.Tensor) -> torch.Tensor:
    """3x3 / stride-2 max pool with "SAME" padding (-inf outside) over the
    trailing (H, W) dims of an NCHW tensor."""
    return F.max_pool2d(
        pad_same(x, 3, 2, value=float("-inf")), kernel_size=3, stride=2
    )
