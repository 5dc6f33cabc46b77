"""Box geometry — pure torch, one canonical copy.

Port of `detectax/ops/boxes.py`. All functions are shape-polymorphic over
leading batch dimensions and contain no data-dependent control flow.

Conventions
-----------
* "corners":  ``[..., 4] = (lo0, lo1, hi0, hi1)`` — axis-agnostic min/max
  corner pairs (works for xyxy and yxyx alike).
* "center":   ``[..., 4] = (c0, c1, s0, s1)`` — centroid + size.
* "ltrb":     per-cell distances ``(top, bottom, left, right)`` in feature
  stride units, the FCOS regression parameterization.
"""
from __future__ import annotations

import torch

EPS = 1e-8


def swap_xy(boxes: torch.Tensor) -> torch.Tensor:
    """Swap the two coordinate axes: (a1,b1,a2,b2) -> (b1,a1,b2,a2)."""
    return torch.stack(
        [boxes[..., 1], boxes[..., 0], boxes[..., 3], boxes[..., 2]],
        dim=-1,
    )


def corners_to_center(boxes: torch.Tensor) -> torch.Tensor:
    """(lo0,lo1,hi0,hi1) -> (c0,c1,s0,s1)."""
    lo = boxes[..., :2]
    hi = boxes[..., 2:]
    return torch.cat([(lo + hi) * 0.5, hi - lo], dim=-1)


def center_to_corners(boxes: torch.Tensor) -> torch.Tensor:
    """(c0,c1,s0,s1) -> (lo0,lo1,hi0,hi1)."""
    c = boxes[..., :2]
    s = boxes[..., 2:]
    return torch.cat([c - s * 0.5, c + s * 0.5], dim=-1)


def box_area_corners(boxes: torch.Tensor) -> torch.Tensor:
    wh = torch.clamp_min(boxes[..., 2:] - boxes[..., :2], 0.0)
    return wh[..., 0] * wh[..., 1]


def pairwise_iou_corners(
    boxes1: torch.Tensor, boxes2: torch.Tensor
) -> torch.Tensor:
    """Pairwise IoU of two corner-format box sets.

    Args:
      boxes1: ``[..., N, 4]``; boxes2: ``[..., M, 4]``.
    Returns:
      ``[..., N, M]`` IoU matrix.
    """
    b1 = boxes1[..., :, None, :]
    b2 = boxes2[..., None, :, :]
    lo = torch.maximum(b1[..., :2], b2[..., :2])
    hi = torch.minimum(b1[..., 2:], b2[..., 2:])
    inter_wh = torch.clamp_min(hi - lo, 0.0)
    inter = inter_wh[..., 0] * inter_wh[..., 1]
    area1 = box_area_corners(boxes1)[..., :, None]
    area2 = box_area_corners(boxes2)[..., None, :]
    union = area1 + area2 - inter
    return inter / (union + EPS)


def pairwise_iou_center(
    boxes1: torch.Tensor, boxes2: torch.Tensor
) -> torch.Tensor:
    """Pairwise IoU for center-format boxes."""
    return pairwise_iou_corners(
        center_to_corners(boxes1), center_to_corners(boxes2)
    )


def elementwise_iou_corners(
    boxes1: torch.Tensor, boxes2: torch.Tensor
) -> torch.Tensor:
    """IoU of corresponding boxes: ``[..., 4] x [..., 4] -> [...]``."""
    lo = torch.maximum(boxes1[..., :2], boxes2[..., :2])
    hi = torch.minimum(boxes1[..., 2:], boxes2[..., 2:])
    inter_wh = torch.clamp_min(hi - lo, 0.0)
    inter = inter_wh[..., 0] * inter_wh[..., 1]
    union = box_area_corners(boxes1) + box_area_corners(boxes2) - inter
    return inter / (union + EPS)


def cell_centers(
    h: int, w: int, offset: float = 0.5, device=None
) -> torch.Tensor:
    """Grid of feature-map cell centers ``[h, w, 2] = (y, x)`` in cell units.

    ``offset=0.5`` is the decode grid; ``offset=0.0`` the IoU-loss grid.
    """
    ys = torch.arange(h, dtype=torch.float32, device=device) + offset
    xs = torch.arange(w, dtype=torch.float32, device=device) + offset
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([gy, gx], dim=-1)


def ltrb_to_corners(ltrb: torch.Tensor, stride: float) -> torch.Tensor:
    """Decode per-cell (t,b,l,r) stride-unit distances ``[..., h, w, 4]``
    into pixel corner boxes ``(y1,x1,y2,x2)``: grid centers at cell+0.5,
    result scaled by stride."""
    h, w = ltrb.shape[-3], ltrb.shape[-2]
    grid = cell_centers(h, w, offset=0.5, device=ltrb.device)
    gy, gx = grid[..., 0], grid[..., 1]
    y1 = gy - ltrb[..., 0]
    y2 = gy + ltrb[..., 1]
    x1 = gx - ltrb[..., 2]
    x2 = gx + ltrb[..., 3]
    return stride * torch.stack([y1, x1, y2, x2], dim=-1)


def offset_scale_to_corners(
    reg: torch.Tensor, box_scale: float, stride: float
) -> torch.Tensor:
    """Decode (y_off, x_off, h/box_scale, w/box_scale) per-cell regression
    ``[..., h, w, 4]`` into pixel corner boxes ``(y1,x1,y2,x2)``: centers
    at ``(cell + offset) * stride``, sizes at ``pred * box_scale``."""
    h, w = reg.shape[-3], reg.shape[-2]
    grid = cell_centers(h, w, offset=0.0, device=reg.device)
    cy = (grid[..., 0] + reg[..., 0]) * stride
    cx = (grid[..., 1] + reg[..., 1]) * stride
    bh = reg[..., 2] * box_scale
    bw = reg[..., 3] * box_scale
    return torch.stack(
        [cy - bh * 0.5, cx - bw * 0.5, cy + bh * 0.5, cx + bw * 0.5],
        dim=-1,
    )


def flip_boxes_horizontal(boxes_xyxy: torch.Tensor) -> torch.Tensor:
    """Flip normalized corner boxes (x1,y1,x2,y2) left-right."""
    return torch.stack(
        [
            1.0 - boxes_xyxy[..., 2],
            boxes_xyxy[..., 1],
            1.0 - boxes_xyxy[..., 0],
            boxes_xyxy[..., 3],
        ],
        dim=-1,
    )
