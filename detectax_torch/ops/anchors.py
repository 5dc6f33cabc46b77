"""RetinaNet anchors.

Port of `detectax/ops/anchors.py`: five levels keyed by the sorted
``anchor_sizes**2`` areas; per level, anchors enumerate aspect ratios
(outer loop) × scales (inner loop), with height ``sqrt(area / ratio)`` and
width ``area / height``, both multiplied by the scale. Anchor centres sit
at ``cell_index * stride`` (no half-cell offset).

`has_anchor_targets_np` is the host-side (numpy) predicate the RetinaNet
trainer filters its dataset with, a copy of the JAX package's.
"""
from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

DEFAULT_SIZES = (32.0, 64.0, 128.0, 256.0, 512.0)
DEFAULT_RATIOS = (0.5, 1.0, 2.0)
DEFAULT_SCALES = tuple(2.0 ** x for x in (0.0, 1.0 / 3.0, 2.0 / 3.0))
DEFAULT_STRIDES = (8, 16, 32, 64, 128)


def _shapes(anchor_sizes, aspect_ratios, anchor_scales) -> list[list]:
    """Per level, the (h, w) pairs in Python floats."""
    areas = sorted(float(s) ** 2 for s in anchor_sizes)
    per_level = []
    for area in areas:
        shapes = []
        for ratio in aspect_ratios:
            ah = math.sqrt(area / ratio)
            aw = area / ah
            for sc in anchor_scales:
                shapes.append((sc * ah, sc * aw))
        per_level.append(shapes)
    return per_level


def anchor_shapes_per_level(
    anchor_sizes: Sequence[float] = DEFAULT_SIZES,
    aspect_ratios: Sequence[float] = DEFAULT_RATIOS,
    anchor_scales: Sequence[float] = DEFAULT_SCALES,
) -> list[torch.Tensor]:
    """A list (one per level) of ``[A, 2]`` float32 anchor (h, w) tables,
    on the CPU (`anchor_boxes_level` moves them to its device)."""
    return [torch.tensor(s, dtype=torch.float32)
            for s in _shapes(anchor_sizes, aspect_ratios, anchor_scales)]


def anchor_boxes_level(hm: int, wm: int, stride: int,
                       anchors_hw: torch.Tensor, device=None) -> torch.Tensor:
    """Dense centre-format anchor boxes ``[hm, wm, A, 4] = (y, x, h, w)``
    on ``device`` (default: the table's)."""
    device = anchors_hw.device if device is None else device
    anchors_hw = anchors_hw.to(device=device, dtype=torch.float32)
    n_anchor = anchors_hw.shape[0]
    shape = (hm, wm, n_anchor)
    ay = (torch.arange(hm, dtype=torch.float32, device=device)
          * stride)[:, None, None]
    ax = (torch.arange(wm, dtype=torch.float32, device=device)
          * stride)[None, :, None]
    return torch.stack([
        ay.expand(shape), ax.expand(shape),
        anchors_hw[None, None, :, 0].expand(shape),
        anchors_hw[None, None, :, 1].expand(shape),
    ], dim=-1)


def decode_anchor_regression(reg: torch.Tensor,
                             anchor_boxes: torch.Tensor) -> torch.Tensor:
    """Invert the anchor encoding of `ops.assign.retinanet_assign_level`:
    ``reg[..., :2] = (anchor_yx - gt_yx) / anchor_hw`` and ``reg[..., 2:] =
    gt_hw / anchor_hw``, so ``gt_yx = anchor_yx - reg[..., :2] *
    anchor_hw``. Returns pixel corner boxes ``(y1, x1, y2, x2)``."""
    a_yx = anchor_boxes[..., :2]
    a_hw = anchor_boxes[..., 2:]
    c_yx = a_yx - reg[..., :2] * a_hw
    hw = reg[..., 2:] * a_hw
    return torch.cat([c_yx - hw * 0.5, c_yx + hw * 0.5], dim=-1)


def has_anchor_targets_np(
    boxes_xyxy_norm,
    canvas: tuple[int, int],
    *,
    anchor_sizes: Sequence[float] = DEFAULT_SIZES,
    aspect_ratios: Sequence[float] = DEFAULT_RATIOS,
    anchor_scales: Sequence[float] = DEFAULT_SCALES,
    strides: Sequence[int] = DEFAULT_STRIDES,
    iou_thresh: float = 0.5,
) -> bool:
    """Host-side (numpy) predicate: would anchor-IoU assignment give at
    least one positive for this image on a stretched canvas, under BOTH
    flip orientations?

    The anchor grid at ``k * stride`` is not mirror-symmetric (the mirror
    of the x=0 anchor column lands off the grid at ``wm * stride``), so a
    box matched only by an edge anchor could lose all its positives on a
    flipped step; the predicate checks the horizontally mirrored boxes
    too and asks for positives in both orientations."""
    boxes = np.asarray(boxes_xyxy_norm, np.float32).reshape(-1, 4)
    if len(boxes) == 0:
        return False
    ch, cw = canvas
    shapes = [np.asarray(a, np.float32) for a in
              _shapes(anchor_sizes, aspect_ratios, anchor_scales)]

    def any_positive(gx1, gy1, gx2, gy2):
        g_area = np.maximum(0.0, gx2 - gx1) * np.maximum(0.0, gy2 - gy1)
        for stride, anchors_hw in zip(strides, shapes):
            hm, wm = ch // stride, cw // stride
            ay = (np.arange(hm, dtype=np.float32) * stride)[:, None, None]
            ax = (np.arange(wm, dtype=np.float32) * stride)[None, :, None]
            ah = anchors_hw[None, None, :, 0]
            aw = anchors_hw[None, None, :, 1]
            # broadcast (hm, wm, A) fully before flattening
            sh = (hm, wm, len(anchors_hw))
            ay1 = np.broadcast_to(ay - ah / 2, sh).reshape(-1, 1)
            ax1 = np.broadcast_to(ax - aw / 2, sh).reshape(-1, 1)
            ay2 = np.broadcast_to(ay + ah / 2, sh).reshape(-1, 1)
            ax2 = np.broadcast_to(ax + aw / 2, sh).reshape(-1, 1)
            ih = np.maximum(
                0.0,
                np.minimum(ay2, gy2[None, :]) - np.maximum(ay1, gy1[None, :]),
            )
            iw = np.maximum(
                0.0,
                np.minimum(ax2, gx2[None, :]) - np.maximum(ax1, gx1[None, :]),
            )
            inter = ih * iw
            a_area = (ay2 - ay1) * (ax2 - ax1)
            iou = inter / np.maximum(a_area + g_area[None, :] - inter, 1e-8)
            if (iou > iou_thresh).any():
                return True
        return False

    # GT corners in pixels (stretch: normalized * canvas)
    gx1 = boxes[:, 0] * cw
    gy1 = boxes[:, 1] * ch
    gx2 = boxes[:, 2] * cw
    gy2 = boxes[:, 3] * ch
    if not any_positive(gx1, gy1, gx2, gy2):
        return False
    # horizontally mirrored orientation (the flip augment's geometry)
    return any_positive(cw - gx2, gy1, cw - gx1, gy2)
