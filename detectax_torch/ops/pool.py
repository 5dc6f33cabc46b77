"""XLA-style "SAME" padding and the 3x3 / stride-2 stem max pool.

Port of `detectax/ops/pool.py::max_pool_3x3_s2`: the forward, and the
opt-in backward that splits a tied window's gradient (`tied_vjp=True`,
or ``DETECTAX_POOL_VJP=1`` where the caller passes none).

XLA pads a strided window asymmetrically, by the input size: the total is
``max((ceil(n/s) - 1) * s + k - n, 0)``, the low side takes the smaller
half. A 3x3 / stride-2 window pads (0, 1) on an even side and (1, 1) on an
odd side; the 7x7 / stride-2 stem pads (2, 3) on an even side. PyTorch's
own ``padding=`` is symmetric, so the port pads explicitly.
"""
from __future__ import annotations

import os

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


def _pool_fwd_raw(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(
        pad_same(x, 3, 2, value=float("-inf")), kernel_size=3, stride=2
    )


def _shift_pooled(a: torch.Tensor, dk: int, dl: int, fill: float):
    """``a[..., k+dk, l+dl]`` with `fill` outside, on the pooled grid (the
    two trailing dims); shifts are -1, 0 or +1."""
    for dim, d in ((-2, dk), (-1, dl)):
        if d:
            n = a.shape[dim]
            edge = torch.full_like(a.narrow(dim, 0, 1), fill)
            a = (torch.cat([a.narrow(dim, 1, n - 1), edge], dim=dim) if d > 0
                 else torch.cat([edge, a.narrow(dim, 0, n - 1)], dim=dim))
    return a


# window (p, q) covers rows {2p, 2p+1, 2p+2}: the parity terms
# (u=0, dk=0), (u=1, dk=0), (u=0, dk=+1); the same for columns
_ROW_TERMS = ((0, 0), (1, 0), (0, 1))


def pool_bwd_tied(x: torch.Tensor, y: torch.Tensor,
                  dy: torch.Tensor) -> torch.Tensor:
    """Backward of the 3x3 / stride-2 "SAME" max pool that splits a
    window's gradient ``dy / cnt`` over all ``cnt`` members equal to its
    maximum (PyTorch's own derivative gives all of it to one of them).
    x: ``[..., H, W]`` with H and W even; y, dy: ``[..., H/2, W/2]``.

    Input (2k+u, 2l+v) is covered by the windows (k - dk, l - dl) of its
    parity's terms, so on the four parity planes of x every (input,
    covering window) pair is a static shift of the pooled grid:
    ``dx = Σ [x == y] · dy / cnt``, written with ``y <= x`` (the maximum
    dominates its members)."""
    neg = float("-inf")
    xp = {(u, v): x[..., u::2, v::2] for u in (0, 1) for v in (0, 1)}
    cnt = None
    for u, dk in _ROW_TERMS:
        for v, dl in _ROW_TERMS:
            member = _shift_pooled(xp[(u, v)], dk, dl, neg)
            eq = (member >= y).to(torch.float32)
            cnt = eq if cnt is None else cnt + eq
    w = dy.to(torch.float32) / cnt

    dx = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    for (u, v), xuv in xp.items():
        acc = None
        for uu, dk in _ROW_TERMS:
            if uu != u:
                continue
            for vv, dl in _ROW_TERMS:
                if vv != v:
                    continue
                y_c = _shift_pooled(y, -dk, -dl, neg)
                w_c = _shift_pooled(w, -dk, -dl, 0.0)
                take = (y_c <= xuv).to(torch.float32) * w_c
                acc = take if acc is None else acc + take
        dx[..., u::2, v::2] = acc
    return dx.to(x.dtype)


class _MaxPoolS2Tied(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        y = _pool_fwd_raw(x)
        ctx.save_for_backward(x, y)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, y = ctx.saved_tensors
        return pool_bwd_tied(x, y, dy)


def max_pool_3x3_s2(x: torch.Tensor, *,
                    tied_vjp: bool | None = None) -> torch.Tensor:
    """3x3 / stride-2 max pool with "SAME" padding (-inf outside) over the
    trailing (H, W) dims of an NCHW tensor.

    ``tied_vjp=True`` selects the backward that splits a tied window's
    gradient (`pool_bwd_tied`); it needs even H and W, and odd sizes keep
    PyTorch's derivative, as does ``False``. ``None`` (the ResNet stem's
    call) reads ``DETECTAX_POOL_VJP=1``, as the JAX package does. The
    forward is the same either way."""
    if tied_vjp is None:
        tied_vjp = os.environ.get("DETECTAX_POOL_VJP") == "1"
    if tied_vjp and x.shape[-2] % 2 == 0 and x.shape[-1] % 2 == 0:
        return _MaxPoolS2Tied.apply(x)
    return _pool_fwd_raw(x)
