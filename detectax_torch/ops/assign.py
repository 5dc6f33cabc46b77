"""FCOS all-in-box label assignment — on the device, fixed shapes, batched.

Port of the FCOS part of `detectax/ops/assign.py` (`fcos_assign`,
`fcos_assign_level` and their helpers); the other assigners of that file
are not ported yet. Each level is a broadcast-and-reduce over a padded
ground-truth array. The JAX package writes the assignment for one image
and maps it over the batch; here the batch dimension is written out, so
every function takes a whole padded batch.

Inputs
------
* ``gt_yxhw``: ``[B, N, 4]`` normalized ``(y_cen, x_cen, h, w)`` boxes.
* ``gt_labels``: ``[B, N]`` integer class ids.
* ``gt_valid``: ``[B, N]`` bool padding mask.
* ``img_dim``: ``(H, W)`` of the *content* region in pixels;
  ``img_pad``: the padded canvas ``(H, W)`` (stride-divisible).

Collision semantics
-------------------
Where several boxes claim one cell, the winner is the **smallest-area**
box; among boxes of exactly equal area the one with the lowest index
(`_first_argmax`).
"""
from __future__ import annotations

from typing import Sequence

import torch

NEG_INF = -1e30
EPS = 1e-8

FCOS_STRIDES = (8, 16, 32, 64, 128)
FCOS_BIN_EDGES = (32.0, 64.0, 128.0, 256.0)


def _trunc_int(x: torch.Tensor) -> torch.Tensor:
    """Python ``int()`` semantics (truncate toward zero) as int32."""
    return torch.trunc(x).to(torch.int32)


def _bin_bounds(b_dim: Sequence[float], n_levels: int):
    """Per-level (lo, hi) bounds on max(box_h, box_w) in pixels: level 0
    takes ``max_side < b_dim[0]``, the top level takes ``>= b_dim[-1]``,
    middle levels take half-open ranges."""
    bounds = []
    for na in range(n_levels):
        lo = 0.0 if na == 0 else float(b_dim[na - 1])
        hi = float("inf") if na == n_levels - 1 else float(b_dim[na])
        bounds.append((lo, hi))
    return bounds


def _gt_pixels(gt_yxhw: torch.Tensor, img_dim):
    h, w = float(img_dim[0]), float(img_dim[1])
    y_c = gt_yxhw[..., 0] * h
    x_c = gt_yxhw[..., 1] * w
    bh = gt_yxhw[..., 2] * h
    bw = gt_yxhw[..., 3] * w
    return y_c, x_c, bh, bw


def _first_argmax(x: torch.Tensor) -> torch.Tensor:
    """Index of the first maximum along the last dimension, as
    ``jnp.argmax`` defines it. ``torch.argmax`` does not promise which of
    several equal maxima it returns, so the first is selected explicitly:
    the smallest index among the positions that equal the maximum."""
    n = x.shape[-1]
    idx = torch.arange(n, device=x.device)
    at_max = x == x.amax(dim=-1, keepdim=True)
    return torch.where(at_max, idx, n).amin(dim=-1)


def _select_rows(owner: torch.Tensor, *columns: torch.Tensor) -> list:
    """Row-select per-box values by ``owner`` index.

    ``owner [B, ...]`` indexes into per-box vectors ``[B, N]`` (or
    matrices ``[B, N, K]``). The JAX package does this with a one-hot
    matrix product at highest precision, because a gather is slow on its
    hardware; an index gather is exact and is what the card does well.
    The round trip of that product is kept: every column passes through
    float32, integer columns are rounded back and bool columns compared
    with 0.5, so the values agree bit for bit.

    Returns the selected columns in input order, each ``[B, ...]``
    (vectors) or ``[B, ..., K]`` (matrices).
    """
    batch = owner.shape[0]
    cells = owner.reshape(batch, -1).to(torch.int64)  # [B, C]
    out = []
    for c in columns:
        m = c.to(torch.float32)
        if c.ndim == 2:
            piece = torch.take_along_dim(m, cells, dim=1)
            piece = piece.reshape(owner.shape)
        else:
            piece = torch.take_along_dim(m, cells[..., None], dim=1)
            piece = piece.reshape(*owner.shape, c.shape[-1])
        if c.dtype == torch.bool:
            piece = piece > 0.5
        elif not c.dtype.is_floating_point:
            piece = torch.round(piece).to(c.dtype)
        out.append(piece)
    return out


def fcos_assign_level(
    gt_yxhw: torch.Tensor,
    gt_labels: torch.Tensor,
    gt_valid: torch.Tensor,
    *,
    img_dim: tuple,
    img_pad: tuple,
    num_classes: int,
    stride: int,
    bin_lo: float,
    bin_hi: float,
):
    """One FPN level of FCOS all-in-box assignment for a padded batch.

    Returns ``([B, hm, wm, 5+nc], n_targets [B])`` with channel layout
    ``[t, b, l, r, centerness, one_hot(nc)]`` (distances in stride units).
    """
    dev = gt_yxhw.device
    gt_yxhw = gt_yxhw.to(torch.float32)
    hm = int(img_pad[0]) // stride
    wm = int(img_pad[1]) // stride
    h_ratio = img_dim[0] / stride
    w_ratio = img_dim[1] / stride
    cy, cx, sh, sw = gt_yxhw.unbind(-1)  # [B, N] each

    _, _, bh, bw = _gt_pixels(gt_yxhw, img_dim)
    max_side = torch.maximum(bh, bw)
    in_bin = gt_valid.to(torch.bool) & (max_side >= bin_lo) \
        & (max_side < bin_hi)

    # Pixel corner coords (can be negative at image edges; the resulting
    # ltrb is clipped at 0 below).
    y_lo_px = (cy - 0.5 * sh) * img_dim[0]
    x_lo_px = (cx - 0.5 * sw) * img_dim[1]
    y_hi_px = (cy + 0.5 * sh) * img_dim[0]
    x_hi_px = (cx + 0.5 * sw) * img_dim[1]

    # Covered cell ranges [lo, hi) with the +1 / clip rules of the
    # reference (int() = truncate toward zero).
    y_lo_c = torch.clamp_min(_trunc_int((cy - sh / 2) * h_ratio) + 1, 0)
    x_lo_c = torch.clamp_min(_trunc_int((cx - sw / 2) * w_ratio) + 1, 0)
    y_hi_c = torch.clamp_max(_trunc_int((cy + sh / 2) * h_ratio) + 1, hm)
    x_hi_c = torch.clamp_max(_trunc_int((cx + sw / 2) * w_ratio) + 1, wm)

    deg_y = y_hi_c <= y_lo_c
    deg_x = x_hi_c <= x_lo_c
    y_cen_c = torch.clamp(_trunc_int((y_lo_c + y_hi_c) * 0.5), 0, hm - 1)
    x_cen_c = torch.clamp(_trunc_int((x_lo_c + x_hi_c) * 0.5), 0, wm - 1)

    jy = torch.arange(hm, dtype=torch.int32, device=dev)
    jx = torch.arange(wm, dtype=torch.int32, device=dev)
    jy_ = jy[None, :, None]  # [1, hm, 1] against [B, 1, N]
    jx_ = jx[None, :, None]
    cover_y = torch.where(
        deg_y[:, None, :],
        jy_ == y_cen_c[:, None, :],
        (jy_ >= y_lo_c[:, None, :]) & (jy_ < y_hi_c[:, None, :]),
    )  # [B, hm, N]
    cover_x = torch.where(
        deg_x[:, None, :],
        jx_ == x_cen_c[:, None, :],
        (jx_ >= x_lo_c[:, None, :]) & (jx_ < x_hi_c[:, None, :]),
    )  # [B, wm, N]
    cover = (
        cover_y[:, :, None, :] & cover_x[:, None, :, :]
        & in_bin[:, None, None, :]
    )  # [B, hm, wm, N]

    # Smallest-area owner per cell, lowest index among equal areas.
    area = bh * bw
    neg_area = torch.where(
        cover, -area[:, None, None, :],
        torch.full((), NEG_INF, dtype=torch.float32, device=dev))
    owner = _first_argmax(neg_area)  # [B, hm, wm]
    has = cover.any(dim=-1)

    gy = (torch.arange(hm, dtype=torch.float32, device=dev) + 0.5)[:, None]
    gx = (torch.arange(wm, dtype=torch.float32, device=dev) + 0.5)[None, :]
    one_hot = torch.nn.functional.one_hot(
        gt_labels.to(torch.int64), num_classes).to(torch.float32)
    (y_lo_o, x_lo_o, y_hi_o, x_hi_o, deg_y_o, deg_x_o, y_cen_o, x_cen_o,
     cls) = _select_rows(
        owner, y_lo_px, x_lo_px, y_hi_px, x_hi_px, deg_y, deg_x,
        y_cen_c, x_cen_c, one_hot,
    )
    t = torch.clamp_min(gy - y_lo_o / stride, 0.0)
    b = torch.clamp_min(y_hi_o / stride - gy, 0.0)
    l = torch.clamp_min(gx - x_lo_o / stride, 0.0)
    r = torch.clamp_min(x_hi_o / stride - gx, 0.0)

    one = torch.ones((), dtype=torch.float32, device=dev)
    ratio_y = torch.where(
        deg_y_o, one,
        (torch.minimum(t, b) + EPS) / (torch.maximum(t, b) + EPS),
    )
    ratio_x = torch.where(
        deg_x_o, one,
        (torch.minimum(l, r) + EPS) / (torch.maximum(l, r) + EPS),
    )
    cen = torch.sqrt(ratio_y * ratio_x)
    # Force centerness 1.0 at the owning box's centre cell.
    is_center = (jy[None, :, None] == y_cen_o) & (jx[None, None, :] == x_cen_o)
    cen = torch.where(is_center, one, cen)
    out = torch.cat(
        [torch.stack([t, b, l, r], dim=-1), cen[..., None], cls], dim=-1
    )
    out = out * has[..., None].to(torch.float32)
    return out, in_bin.sum(dim=-1, dtype=torch.int32)


def fcos_assign(
    gt_yxhw: torch.Tensor,
    gt_labels: torch.Tensor,
    gt_valid: torch.Tensor,
    *,
    img_dim: tuple,
    img_pad: tuple | None = None,
    num_classes: int,
    strides: Sequence[int] = FCOS_STRIDES,
    b_dim: Sequence[float] = FCOS_BIN_EDGES,
):
    """Full 5-level FCOS assignment of a padded batch. Returns (tuple of
    maps ``[B, hm, wm, 5+nc]``, ``[B, L]`` n_targets)."""
    if gt_yxhw.ndim != 3 or gt_yxhw.shape[-1] != 4:
        raise ValueError(
            f"gt_yxhw must be a padded batch [B, N, 4], got "
            f"{tuple(gt_yxhw.shape)}")
    img_pad = img_pad or img_dim
    outs, counts = [], []
    for (lo, hi), stride in zip(_bin_bounds(b_dim, len(strides)), strides):
        o, n = fcos_assign_level(
            gt_yxhw, gt_labels, gt_valid,
            img_dim=img_dim, img_pad=img_pad, num_classes=num_classes,
            stride=stride, bin_lo=lo, bin_hi=hi,
        )
        outs.append(o)
        counts.append(n)
    return tuple(outs), torch.stack(counts, dim=-1)
