"""Label assignment — on the device, fixed shapes, batched.

Port of `detectax/ops/assign.py`'s FCOS assigners — all-in-box
(`fcos_assign`), 3x3 center sampling (`fcos_center_assign`) and the
centroid-only offset+scale variant (`fcos_center_v1_assign`), each with
its one-level function and the helpers — and of the two assigners of the
ResNet-backbone CenterNet family (`centernet_scale_slot_assign`,
`centernet_heatmap_assign`), of the two hourglass models
(`stacked_hourglass_assign`, `hourglass_assign`) and RetinaNet's
anchor-IoU matching (`retinanet_assign`). Each is a broadcast-and-reduce
over a padded ground-truth array. The JAX package writes the assignment
for one image and maps it over the batch; here the batch dimension is
written out, so every function takes a whole padded batch.

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

from detectax_torch.ops.anchors import anchor_boxes_level
from detectax_torch.ops.boxes import pairwise_iou_center

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


def _axis_cover(lo_c: torch.Tensor, hi_c: torch.Tensor, n: int):
    """Cells of one axis that each box covers: the range ``[lo_c, hi_c)``
    or, where that is empty, the box's centre cell alone. ``lo_c`` /
    ``hi_c`` are ``[B, N]`` int cell bounds. Returns (cover ``[B, n, N]``,
    empty ``[B, N]``, centre cell ``[B, N]``)."""
    empty = hi_c <= lo_c
    cen_c = torch.clamp(_trunc_int((lo_c + hi_c) * 0.5), 0, n - 1)
    j = torch.arange(n, dtype=torch.int32, device=lo_c.device)[None, :, None]
    cover = torch.where(
        empty[:, None, :],
        j == cen_c[:, None, :],
        (j >= lo_c[:, None, :]) & (j < hi_c[:, None, :]),
    )
    return cover, empty, cen_c


def _smallest_owner(cover: torch.Tensor, area: torch.Tensor):
    """Per cell the covering box of smallest area, lowest index among equal
    areas. ``cover`` is ``[B, ..., N]`` bool, ``area`` ``[B, N]``. Returns
    (owner ``[B, ...]`` index, has ``[B, ...]`` bool)."""
    area = area.reshape(area.shape[0], *([1] * (cover.ndim - 2)), -1)
    neg_area = torch.where(
        cover, -area,
        torch.full((), NEG_INF, dtype=torch.float32, device=cover.device))
    return _first_argmax(neg_area), cover.any(dim=-1)


def _one_hot(gt_labels: torch.Tensor, num_classes: int) -> torch.Tensor:
    return torch.nn.functional.one_hot(
        gt_labels.to(torch.int64), num_classes).to(torch.float32)


def _check_batch(gt_yxhw: torch.Tensor) -> None:
    if gt_yxhw.ndim != 3 or gt_yxhw.shape[-1] != 4:
        raise ValueError(
            f"gt_yxhw must be a padded batch [B, N, 4], got "
            f"{tuple(gt_yxhw.shape)}")


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

    cover_y, deg_y, y_cen_c = _axis_cover(y_lo_c, y_hi_c, hm)  # [B, hm, N]
    cover_x, deg_x, x_cen_c = _axis_cover(x_lo_c, x_hi_c, wm)  # [B, wm, N]
    cover = (
        cover_y[:, :, None, :] & cover_x[:, None, :, :]
        & in_bin[:, None, None, :]
    )  # [B, hm, wm, N]
    area = bh * bw
    owner, has = _smallest_owner(cover, area)  # [B, hm, wm]
    jy = torch.arange(hm, dtype=torch.int32, device=dev)
    jx = torch.arange(wm, dtype=torch.int32, device=dev)

    gy = (torch.arange(hm, dtype=torch.float32, device=dev) + 0.5)[:, None]
    gx = (torch.arange(wm, dtype=torch.float32, device=dev) + 0.5)[None, :]
    one_hot = _one_hot(gt_labels, num_classes)
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
    _check_batch(gt_yxhw)
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


# ---------------------------------------------------------------------------
# FCOS-center: 3x3 (or centroid-only) center sampling
# ---------------------------------------------------------------------------


def fcos_center_assign_level(
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
    center_only: bool = False,
):
    """One level of 3x3 (or centroid-only) center-sampling assignment for
    a padded batch: center cell at ``int(c * ratio + 0.5)``, neighbourhood
    scores 1.0 (centre) / 0.5 (edge) / 0.25 (diagonal), the higher score
    taking the centerness channel; unclamped ltrb offsets and the one-hot
    class of the smallest covering box at each covered cell.

    Returns ``([B, hm, wm, 5+nc], n_targets [B])``, layout
    ``[t, b, l, r, cen, one_hot]``."""
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

    y_lo_px = (cy - 0.5 * sh) * img_dim[0]
    x_lo_px = (cx - 0.5 * sw) * img_dim[1]
    y_hi_px = (cy + 0.5 * sh) * img_dim[0]
    x_hi_px = (cx + 0.5 * sw) * img_dim[1]

    y_cen_c = _trunc_int(cy * h_ratio + 0.5)
    x_cen_c = _trunc_int(cx * w_ratio + 0.5)
    jy = torch.arange(hm, dtype=torch.int32, device=dev)
    jx = torch.arange(wm, dtype=torch.int32, device=dev)
    ady = (jy[None, :, None] - y_cen_c[:, None, :]).abs()  # [B, hm, N]
    adx = (jx[None, :, None] - x_cen_c[:, None, :]).abs()  # [B, wm, N]
    reach = 0 if center_only else 1
    cover = (
        (ady <= reach)[:, :, None, :] & (adx <= reach)[:, None, :, :]
        & in_bin[:, None, None, :]
    )  # [B, hm, wm, N]

    # centre score per (cell, box)
    ady = ady[:, :, None, :]
    adx = adx[:, None, :, :]
    score = torch.where(
        (ady == 0) & (adx == 0), 1.0,
        torch.where((ady == 1) & (adx == 1), 0.25, 0.5))
    cen = torch.where(cover, score, 0.0).amax(dim=-1)

    owner, has = _smallest_owner(cover, bh * bw)  # [B, hm, wm]
    gy = (torch.arange(hm, dtype=torch.float32, device=dev) + 0.5)[:, None]
    gx = (torch.arange(wm, dtype=torch.float32, device=dev) + 0.5)[None, :]
    y_lo_o, x_lo_o, y_hi_o, x_hi_o, cls = _select_rows(
        owner, y_lo_px, x_lo_px, y_hi_px, x_hi_px,
        _one_hot(gt_labels, num_classes),
    )
    t = gy - y_lo_o / stride
    b = y_hi_o / stride - gy
    l = gx - x_lo_o / stride
    r = x_hi_o / stride - gx

    has_f = has[..., None].to(torch.float32)
    out = torch.cat(
        [torch.stack([t, b, l, r], dim=-1) * has_f, cen[..., None],
         cls * has_f], dim=-1)
    return out, in_bin.sum(dim=-1, dtype=torch.int32)


def fcos_center_assign(
    gt_yxhw: torch.Tensor,
    gt_labels: torch.Tensor,
    gt_valid: torch.Tensor,
    *,
    img_dim: tuple,
    img_pad: tuple | None = None,
    num_classes: int,
    strides: Sequence[int] = FCOS_STRIDES,
    b_dim: Sequence[float] = FCOS_BIN_EDGES,
    center_only: bool = False,
):
    """5-level center-sampling assignment of a padded batch. Returns
    (tuple of maps ``[B, hm, wm, 5+nc]``, ``[B, L]`` n_targets)."""
    _check_batch(gt_yxhw)
    img_pad = img_pad or img_dim
    outs, counts = [], []
    for (lo, hi), stride in zip(_bin_bounds(b_dim, len(strides)), strides):
        o, n = fcos_center_assign_level(
            gt_yxhw, gt_labels, gt_valid,
            img_dim=img_dim, img_pad=img_pad, num_classes=num_classes,
            stride=stride, bin_lo=lo, bin_hi=hi, center_only=center_only,
        )
        outs.append(o)
        counts.append(n)
    return tuple(outs), torch.stack(counts, dim=-1)


# ---------------------------------------------------------------------------
# FCOS-center v1: centroid-only offset+scale
# ---------------------------------------------------------------------------


def fcos_center_v1_assign_level(
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
    box_scale: float,
):
    """One level of YOLO-style centroid-only assignment for a padded
    batch: at the centroid cell (``int(c_px / stride)``) the regression
    ``(y_off, x_off, h / box_scale, w / box_scale)``, centerness 1 and the
    one-hot class of the smallest box there.

    Returns ``([B, hm, wm, 5+nc], n_targets [B])``, layout
    ``[y_off, x_off, h_sc, w_sc, cen, one_hot]``."""
    dev = gt_yxhw.device
    gt_yxhw = gt_yxhw.to(torch.float32)
    hm = int(img_pad[0]) // stride
    wm = int(img_pad[1]) // stride

    y_c, x_c, bh, bw = _gt_pixels(gt_yxhw, img_dim)
    max_side = torch.maximum(bh, bw)
    in_bin = gt_valid.to(torch.bool) & (max_side >= bin_lo) \
        & (max_side < bin_hi)
    y_cell = _trunc_int(y_c / stride)
    x_cell = _trunc_int(x_c / stride)
    in_map = (y_cell >= 0) & (y_cell < hm) & (x_cell >= 0) & (x_cell < wm)
    in_bin = in_bin & in_map

    y_off = (y_c - y_cell.to(torch.float32) * stride) / stride
    x_off = (x_c - x_cell.to(torch.float32) * stride) / stride
    reg = torch.stack([y_off, x_off, bh / box_scale, bw / box_scale], dim=-1)

    jy = torch.arange(hm, dtype=torch.int32, device=dev)
    jx = torch.arange(wm, dtype=torch.int32, device=dev)
    cover = (
        (jy[None, :, None, None] == y_cell[:, None, None, :])
        & (jx[None, None, :, None] == x_cell[:, None, None, :])
        & in_bin[:, None, None, :]
    )  # [B, hm, wm, N]
    owner, has = _smallest_owner(cover, bh * bw)
    reg_o, cls = _select_rows(owner, reg, _one_hot(gt_labels, num_classes))
    has_f = has[..., None].to(torch.float32)
    out = torch.cat([reg_o * has_f, has_f, cls * has_f], dim=-1)
    return out, in_bin.sum(dim=-1, dtype=torch.int32)


def fcos_center_v1_assign(
    gt_yxhw: torch.Tensor,
    gt_labels: torch.Tensor,
    gt_valid: torch.Tensor,
    *,
    img_dim: tuple,
    img_pad: tuple | None = None,
    num_classes: int,
    strides: Sequence[int] = FCOS_STRIDES,
    b_dim: Sequence[float] = FCOS_BIN_EDGES,
    box_scales: Sequence[float] | None = None,
):
    """5-level centroid-only assignment of a padded batch. Per-level
    ``box_scales`` default to ``b_dim + [max(img_dim)]``. Returns (tuple
    of maps ``[B, hm, wm, 5+nc]``, ``[B, L]`` n_targets)."""
    _check_batch(gt_yxhw)
    img_pad = img_pad or img_dim
    if box_scales is None:
        box_scales = list(b_dim) + [float(max(img_dim))]
    outs, counts = [], []
    for (lo, hi), stride, sc in zip(
        _bin_bounds(b_dim, len(strides)), strides, box_scales
    ):
        o, n = fcos_center_v1_assign_level(
            gt_yxhw, gt_labels, gt_valid,
            img_dim=img_dim, img_pad=img_pad, num_classes=num_classes,
            stride=stride, bin_lo=lo, bin_hi=hi, box_scale=float(sc),
        )
        outs.append(o)
        counts.append(n)
    return tuple(outs), torch.stack(counts, dim=-1)


# ---------------------------------------------------------------------------
# CenterNet scale-slot assignment
# ---------------------------------------------------------------------------


def centernet_scale_slot_assign(
    gt_yxhw: torch.Tensor,
    gt_labels: torch.Tensor,
    gt_valid: torch.Tensor,
    *,
    img_dim: tuple,
    img_pad: tuple | None = None,
    num_classes: int,
    box_scales: Sequence[float] = (32.0, 64.0, 128.0, 256.0, 512.0),
    stride: int = 8,
    gaussian_cls: bool = False,
):
    """Single stride-8 map with S scale slots; centroid-only assignment of
    a padded batch.

    slot = first scale with ``max(h, w) < box_scales[s]`` (boxes larger
    than every scale go to the last slot); the image is center-padded into
    ``img_pad``, regression is ``(y_off/stride, x_off/stride, h/scale,
    w/scale)`` at the centroid cell. Returns (``[B, hm, wm, S, 4+nc]`` with
    layout ``[reg(4), one_hot(nc)]``, n_targets ``[B]``).

    ``gaussian_cls=True`` splats a CenterNet-style Gaussian (peak 1.0 at
    the centroid cell, sigma from box size) into the assigned slot's class
    channel instead of a lone one-hot cell; the loss keys positives on
    ``cls >= 1.0`` so regression stays centroid-only. Each box's Gaussian
    reaches its (slot, class) channel through a scatter with an ``amax``
    reduction — a maximum does not depend on the order of its terms, so
    the result is the same from run to run.
    """
    dev = gt_yxhw.device
    gt_yxhw = gt_yxhw.to(torch.float32)
    gt_valid = gt_valid.to(torch.bool)
    labels = gt_labels.to(torch.int64)
    img_pad = img_pad or img_dim
    hm = int(img_pad[0]) // stride
    wm = int(img_pad[1]) // stride
    pad_y = int((img_pad[0] - img_dim[0]) / 2.0)
    pad_x = int((img_pad[1] - img_dim[1]) / 2.0)
    n_slots = len(box_scales)
    batch = gt_yxhw.shape[0]

    y_c, x_c, bh, bw = _gt_pixels(gt_yxhw, img_dim)        # [B, N] each
    box_d = torch.maximum(bh, bw)
    scales = torch.tensor(list(box_scales), dtype=torch.float32, device=dev)
    fits = box_d[..., None] < scales                        # [B, N, S]
    slot = _first_argmax(fits.to(torch.int32))
    slot = torch.where(fits.any(dim=-1), slot, n_slots - 1)

    y_cell = _trunc_int((pad_y + y_c) / stride)
    x_cell = _trunc_int((pad_x + x_c) / stride)
    in_map = (y_cell >= 0) & (y_cell < hm) & (x_cell >= 0) & (x_cell < wm)
    valid = gt_valid & in_map

    y_off = (pad_y + y_c - y_cell.to(torch.float32) * stride) / stride
    x_off = (pad_x + x_c - x_cell.to(torch.float32) * stride) / stride
    slot_scale = scales[slot]
    reg = torch.stack([y_off, x_off, bh / slot_scale, bw / slot_scale],
                      dim=-1)                               # [B, N, 4]

    jy = torch.arange(hm, dtype=torch.int32, device=dev)
    jx = torch.arange(wm, dtype=torch.int32, device=dev)
    js = torch.arange(n_slots, dtype=torch.int64, device=dev)
    cover = (
        (jy[None, :, None, None, None] == y_cell[:, None, None, None, :])
        & (jx[None, None, :, None, None] == x_cell[:, None, None, None, :])
        & (js[None, None, None, :, None] == slot[:, None, None, None, :])
        & valid[:, None, None, None, :]
    )  # [B, hm, wm, S, N]
    area = bh * bw
    owner, has = _smallest_owner(cover, area)

    one_hot = torch.nn.functional.one_hot(labels, num_classes) \
        .to(torch.float32)
    reg_o, cls = _select_rows(owner, reg, one_hot)
    has_f = has[..., None].to(torch.float32)
    cls = cls * has_f
    if gaussian_cls:
        # per-box spatial Gaussian, peak 1.0 at its centroid cell
        gy = jy.to(torch.float32)[None, :, None, None]      # [1, hm, 1, 1]
        gx = jx.to(torch.float32)[None, None, :, None]      # [1, 1, wm, 1]
        sigma = torch.clamp_min(torch.sqrt(area) / (3.0 * stride), 1.0)
        d2 = (
            (gy - y_cell.to(torch.float32)[:, None, None, :]) ** 2
            + (gx - x_cell.to(torch.float32)[:, None, None, :]) ** 2
        )                                                   # [B, hm, wm, N]
        g = torch.exp(-d2 / (2.0 * sigma[:, None, None, :] ** 2))
        g = torch.where(valid[:, None, None, :], g, torch.zeros_like(g))
        # boxes grouped by slot * nc + label; invalid boxes go to a dump
        # channel. Channels start at 0, the floor of an empty group.
        sid = torch.where(valid, slot * num_classes + labels,
                          n_slots * num_classes)            # [B, N]
        seg = torch.zeros((batch, n_slots * num_classes + 1, hm, wm),
                          dtype=torch.float32, device=dev)
        seg.scatter_reduce_(
            1, sid[:, :, None, None].expand(-1, -1, hm, wm),
            g.permute(0, 3, 1, 2), "amax", include_self=True)
        gauss = seg[:, :-1].reshape(batch, n_slots, num_classes, hm, wm) \
            .permute(0, 3, 4, 1, 2)                         # [B,hm,wm,S,nc]
        cls = torch.maximum(cls, gauss)  # keep exact 1.0 peaks
    out = torch.cat([reg_o * has_f, cls], dim=-1)
    return out, valid.sum(dim=-1, dtype=torch.int32)


# ---------------------------------------------------------------------------
# Hourglass assignment
# ---------------------------------------------------------------------------


def stacked_hourglass_assign(
    gt_yxhw: torch.Tensor,
    gt_labels: torch.Tensor,
    gt_valid: torch.Tensor,
    *,
    img_dim: tuple,
    img_pad: tuple | None = None,
    num_classes: int,
    stride: int = 4,
):
    """Single-map centroid assignment of a padded batch for
    `models.StackedHourglass`: one ``[hm, wm, 4+nc]`` map an image; at each
    box's centroid cell, ``reg = (t, b, l, r)`` half-extents in stride
    units measured from the cell centre (``t = y_cell + 0.5 -
    y_lo/stride``), and a one-hot class. The smallest box owns a contested
    cell. Returns (``[B, hm, wm, 4+nc]``, n_targets ``[B]``)."""
    dev = gt_yxhw.device
    gt_yxhw = gt_yxhw.to(torch.float32)
    gt_valid = gt_valid.to(torch.bool)
    img_pad = img_pad or img_dim
    hm = int(img_pad[0]) // stride
    wm = int(img_pad[1]) // stride
    pad_y = int((img_pad[0] - img_dim[0]) / 2.0)
    pad_x = int((img_pad[1] - img_dim[1]) / 2.0)

    y_c, x_c, bh, bw = _gt_pixels(gt_yxhw, img_dim)        # [B, N] each
    y_lo = y_c - bh * 0.5
    y_hi = y_c + bh * 0.5
    x_lo = x_c - bw * 0.5
    x_hi = x_c + bw * 0.5

    y_cell = _trunc_int((pad_y + y_c) / stride)
    x_cell = _trunc_int((pad_x + x_c) / stride)
    in_map = (y_cell >= 0) & (y_cell < hm) & (x_cell >= 0) & (x_cell < wm)
    valid = gt_valid & in_map

    yc_f = y_cell.to(torch.float32)
    xc_f = x_cell.to(torch.float32)
    reg = torch.stack([
        yc_f + 0.5 - (pad_y + y_lo) / stride,
        (pad_y + y_hi) / stride - yc_f - 0.5,
        xc_f + 0.5 - (pad_x + x_lo) / stride,
        (pad_x + x_hi) / stride - xc_f - 0.5,
    ], dim=-1)                                              # [B, N, 4]

    jy = torch.arange(hm, dtype=torch.int32, device=dev)
    jx = torch.arange(wm, dtype=torch.int32, device=dev)
    cover = (
        (jy[None, :, None, None] == y_cell[:, None, None, :])
        & (jx[None, None, :, None] == x_cell[:, None, None, :])
        & valid[:, None, None, :]
    )  # [B, hm, wm, N]
    owner, has = _smallest_owner(cover, bh * bw)
    reg_o, cls = _select_rows(owner, reg, _one_hot(gt_labels, num_classes))
    has_f = has[..., None].to(torch.float32)
    out = torch.cat([reg_o * has_f, cls * has_f], dim=-1)
    return out, valid.sum(dim=-1, dtype=torch.int32)


def hourglass_assign(
    gt_yxhw: torch.Tensor,
    gt_labels: torch.Tensor,
    gt_valid: torch.Tensor,
    *,
    img_dim: tuple,
    img_pad: tuple | None = None,
    num_classes: int,
    box_scales: Sequence[float] | None = None,
    stride: int = 8,
):
    """Four-slot assignment of a padded batch with an explicit objectness
    channel, for `models.HourglassNet`: slot = the first scale with
    **both** ``h < scale`` and ``w < scale`` (else the last slot); the
    image is centre-padded into ``img_pad``; the regression is the
    stride-normalized fractional centroid offset and the box size over its
    slot's scale. Default scales ``[d/8, d/4, d/2, d]`` of the padded
    height ``d``. Returns (``[B, hm, wm, 4, 5+nc]`` with layout ``[y_off,
    x_off, h_sc, w_sc, objectness, one_hot]``, n_targets ``[B]``)."""
    dev = gt_yxhw.device
    gt_yxhw = gt_yxhw.to(torch.float32)
    gt_valid = gt_valid.to(torch.bool)
    img_pad = img_pad or img_dim
    if box_scales is None:
        d = float(img_pad[0])
        box_scales = [d / 8.0, d / 4.0, d / 2.0, d]
    hm = int(img_pad[0]) // stride
    wm = int(img_pad[1]) // stride
    pad_y = int((img_pad[0] - img_dim[0]) / 2.0)
    pad_x = int((img_pad[1] - img_dim[1]) / 2.0)
    n_slots = len(box_scales)

    y_c, x_c, bh, bw = _gt_pixels(gt_yxhw, img_dim)        # [B, N] each
    scales = torch.tensor([float(s) for s in box_scales],
                          dtype=torch.float32, device=dev)
    fits = (bh[..., None] < scales) & (bw[..., None] < scales)  # [B, N, S]
    slot = _first_argmax(fits.to(torch.int32))
    slot = torch.where(fits.any(dim=-1), slot, n_slots - 1)

    y_cell = _trunc_int((pad_y + y_c) / stride)
    x_cell = _trunc_int((pad_x + x_c) / stride)
    in_map = (y_cell >= 0) & (y_cell < hm) & (x_cell >= 0) & (x_cell < wm)
    valid = gt_valid & in_map & (bh >= 0) & (bw >= 0)

    y_off = (pad_y + y_c - y_cell.to(torch.float32) * stride) / stride
    x_off = (pad_x + x_c - x_cell.to(torch.float32) * stride) / stride
    slot_scale = scales[slot]
    reg = torch.stack([y_off, x_off, bh / slot_scale, bw / slot_scale],
                      dim=-1)                               # [B, N, 4]

    jy = torch.arange(hm, dtype=torch.int32, device=dev)
    jx = torch.arange(wm, dtype=torch.int32, device=dev)
    js = torch.arange(n_slots, dtype=torch.int64, device=dev)
    cover = (
        (jy[None, :, None, None, None] == y_cell[:, None, None, None, :])
        & (jx[None, None, :, None, None] == x_cell[:, None, None, None, :])
        & (js[None, None, None, :, None] == slot[:, None, None, None, :])
        & valid[:, None, None, None, :]
    )  # [B, hm, wm, S, N]
    owner, has = _smallest_owner(cover, bh * bw)
    reg_o, cls = _select_rows(owner, reg, _one_hot(gt_labels, num_classes))
    has_f = has[..., None].to(torch.float32)
    out = torch.cat([reg_o * has_f, has_f, cls * has_f], dim=-1)
    return out, valid.sum(dim=-1, dtype=torch.int32)


# ---------------------------------------------------------------------------
# CenterNet heatmap assignment
# ---------------------------------------------------------------------------


def centernet_heatmap_assign(
    gt_yxhw: torch.Tensor,
    gt_labels: torch.Tensor,
    gt_valid: torch.Tensor,
    *,
    img_dim: tuple,
    img_pad: tuple | None = None,
    num_classes: int,
    stride: int = 8,
    sigma: float = 0.25,
    spread: float = 8.0,
    heatmap_kind: str = "pseudo",
):
    """Single-map CenterNet assignment with a center-prior heatmap channel,
    for a padded batch.

    ltrb targets (full-box corners) are filled over the ``sigma``-shrunken
    box region; the center channel holds a normalized center-distance
    prior — the pseudo-Gaussian ``1/(d^spread)`` product, or a true
    Gaussian (``heatmap_kind="gaussian"``, σ = max(1, sqrt(box area in
    cells))). The center cell of the shrunken region is forced to 1.0.
    Returns (``[B, hm, wm, 5+nc]``, n_targets ``[B]``).
    """
    if heatmap_kind not in ("pseudo", "gaussian"):
        raise ValueError(f"unknown heatmap_kind {heatmap_kind!r}")
    dev = gt_yxhw.device
    gt_yxhw = gt_yxhw.to(torch.float32)
    gt_valid = gt_valid.to(torch.bool)
    img_pad = img_pad or img_dim
    hm = int(img_pad[0]) // stride
    wm = int(img_pad[1]) // stride
    h_ratio = img_dim[0] / stride
    w_ratio = img_dim[1] / stride
    h_lim = int(img_dim[0]) // stride
    w_lim = int(img_dim[1]) // stride
    cy, cx, sh, sw = gt_yxhw.unbind(-1)  # [B, N] each

    _, _, bh, bw = _gt_pixels(gt_yxhw, img_dim)
    y_lo_px = (cy - 0.5 * sh) * img_dim[0]
    x_lo_px = (cx - 0.5 * sw) * img_dim[1]
    y_hi_px = (cy + 0.5 * sh) * img_dim[0]
    x_hi_px = (cx + 0.5 * sw) * img_dim[1]

    # Shrunken-box cell region; the upper bound is clipped to
    # img_dim/stride, not img_pad/stride (kept from the reference).
    y_lo_c = torch.clamp_min(
        1 + _trunc_int((cy - sigma * sh / 2) * h_ratio), 0)
    x_lo_c = torch.clamp_min(
        1 + _trunc_int((cx - sigma * sw / 2) * w_ratio), 0)
    y_hi_c = torch.clamp_max(
        1 + _trunc_int((cy + sigma * sh / 2) * h_ratio), h_lim)
    x_hi_c = torch.clamp_max(
        1 + _trunc_int((cx + sigma * sw / 2) * w_ratio), w_lim)

    cover_y, _, y_cen_c = _axis_cover(y_lo_c, y_hi_c, hm)  # [B, hm, N]
    cover_x, _, x_cen_c = _axis_cover(x_lo_c, x_hi_c, wm)  # [B, wm, N]
    cover = (
        cover_y[:, :, None, :] & cover_x[:, None, :, :]
        & gt_valid[:, None, None, :]
    )  # [B, hm, wm, N]
    area = bh * bw
    owner, has = _smallest_owner(cover, area)
    jy = torch.arange(hm, dtype=torch.int32, device=dev)
    jx = torch.arange(wm, dtype=torch.int32, device=dev)

    gy = (torch.arange(hm, dtype=torch.float32, device=dev) + 0.5)[:, None]
    gx = (torch.arange(wm, dtype=torch.float32, device=dev) + 0.5)[None, :]
    one_hot = _one_hot(gt_labels, num_classes)
    (y_lo_o, x_lo_o, y_hi_o, x_hi_o, mu_y, mu_x, area_o,
     cls) = _select_rows(
        owner, y_lo_px, x_lo_px, y_hi_px, x_hi_px,
        y_cen_c.to(torch.float32), x_cen_c.to(torch.float32), area, one_hot,
    )
    t = torch.clamp_min(gy - y_lo_o / stride, 0.0)
    b = torch.clamp_min(y_hi_o / stride - gy, 0.0)
    l = torch.clamp_min(gx - x_lo_o / stride, 0.0)
    r = torch.clamp_min(x_hi_o / stride - gx, 0.0)

    # Center-prior heatmap around the owner's (shrunken-region) center cell.
    dy = gy - mu_y
    dx = gx - mu_x
    if heatmap_kind == "pseudo":
        # 1/(d^spread) per axis, normalized so the closest cell ~= 1. Grid
        # offsets of 0.5 keep |d| >= 0.5, and the per-box max over the
        # region is approximated by the value at the center cell
        # (|dy| = |dx| = 0.5).
        g = 1.0 / torch.pow(torch.abs(dy) + EPS, spread)
        g = g / torch.pow(torch.abs(dx) + EPS, spread)
        norm = 1.0 / 0.5 ** (2.0 * spread)
        cen = torch.clamp(g / norm, 0.0, 1.0)
    else:
        std = torch.clamp_min(torch.sqrt(area_o / (stride * stride)), 1.0)
        cen = torch.exp(-(dy * dy + dx * dx) / (2.0 * std * std))
    is_center = (jy[None, :, None].to(torch.float32) == mu_y) & (
        jx[None, None, :].to(torch.float32) == mu_x)
    cen = torch.where(is_center, torch.ones((), device=dev), cen)
    out = torch.cat(
        [torch.stack([t, b, l, r], dim=-1), cen[..., None], cls], dim=-1
    )
    out = out * has[..., None].to(torch.float32)
    return out, gt_valid.sum(dim=-1, dtype=torch.int32)


# ---------------------------------------------------------------------------
# RetinaNet anchor-IoU assignment
# ---------------------------------------------------------------------------


def retinanet_assign_level(
    gt_yxhw: torch.Tensor,
    gt_labels: torch.Tensor,
    gt_valid: torch.Tensor,
    *,
    img_dim: tuple,
    img_pad: tuple,
    num_classes: int,
    stride: int,
    anchors_hw: torch.Tensor,
    iou_thresh: float = 0.5,
):
    """One level of anchor-IoU matching for a padded batch.

    Anchors are centred at ``(cell_y * stride, cell_x * stride)`` with the
    per-anchor ``(h, w)`` of ``anchors_hw [A, 2]``; every anchor whose IoU
    with a valid box is above ``iou_thresh`` (strictly) is positive, owned
    by its box of largest IoU (the lowest index among equal IoUs).
    Regression is ``((a_y - gt_y)/a_h, (a_x - gt_x)/a_w, gt_h/a_h,
    gt_w/a_w)``. The IoU is `ops.boxes.pairwise_iou_center` in the JAX
    package's order of operations, so an anchor at IoU ~ 0.5 falls on the
    same side of the threshold.

    Returns ``([B, hm, wm, A, 4+nc], count [B])``: the count is the number
    of matched (box, anchor) pairs, not of positive anchors.
    """
    dev = gt_yxhw.device
    gt_yxhw = gt_yxhw.to(torch.float32)
    hm = int(img_pad[0]) // stride
    wm = int(img_pad[1]) // stride
    anchor_boxes = anchor_boxes_level(hm, wm, stride, anchors_hw,
                                      device=dev).reshape(-1, 4)  # [M, 4]
    n_anchor = anchors_hw.shape[0]

    y_c, x_c, bh, bw = _gt_pixels(gt_yxhw, img_dim)       # [B, N] each
    gt_boxes = torch.stack([y_c, x_c, bh, bw], dim=-1)    # [B, N, 4]
    iou = pairwise_iou_center(gt_boxes, anchor_boxes[None])  # [B, N, M]
    iou = torch.where(gt_valid.to(torch.bool)[:, :, None], iou,
                      torch.full((), -1.0, device=dev))
    matched = iou > iou_thresh
    best_gt = _first_argmax(iou.transpose(1, 2)).to(torch.int64)  # [B, M]
    has = matched.any(dim=1)                              # [B, M]

    def pick(v):
        return torch.take_along_dim(v, best_gt, dim=1)

    a_yx = anchor_boxes[:, :2]
    a_hw = anchor_boxes[:, 2:]
    reg = torch.cat([
        (a_yx - torch.stack([pick(y_c), pick(x_c)], dim=-1)) / a_hw,
        torch.stack([pick(bh), pick(bw)], dim=-1) / a_hw,
    ], dim=-1)
    cls = _one_hot(pick(gt_labels.to(torch.int64)), num_classes)
    has_f = has[..., None].to(torch.float32)
    out = torch.cat([reg * has_f, cls * has_f], dim=-1)
    out = out.reshape(gt_yxhw.shape[0], hm, wm, n_anchor, 4 + num_classes)
    return out, matched.sum(dim=(1, 2), dtype=torch.int32)


def retinanet_assign(
    gt_yxhw: torch.Tensor,
    gt_labels: torch.Tensor,
    gt_valid: torch.Tensor,
    *,
    img_dim: tuple,
    img_pad: tuple | None = None,
    num_classes: int,
    anchors_per_level: Sequence[torch.Tensor],
    strides: Sequence[int] = FCOS_STRIDES,
    iou_thresh: float = 0.5,
):
    """All-level anchor matching of a padded batch; ``anchors_per_level[l]``
    is ``[A, 2]`` (h, w). Returns (tuple of maps ``[B, hm, wm, A, 4+nc]``,
    count ``[B]`` of matched (box, anchor) pairs over the levels)."""
    _check_batch(gt_yxhw)
    img_pad = img_pad or img_dim
    outs, count = [], None
    for stride, anchors_hw in zip(strides, anchors_per_level):
        o, n = retinanet_assign_level(
            gt_yxhw, gt_labels, gt_valid,
            img_dim=img_dim, img_pad=img_pad, num_classes=num_classes,
            stride=stride, anchors_hw=anchors_hw, iou_thresh=iou_thresh,
        )
        outs.append(o)
        count = n if count is None else count + n
    return tuple(outs), count
