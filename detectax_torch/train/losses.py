"""Loss compositions over the shared `ops.losses` library.

Port of `detectax/train/losses.py::fcos_loss` (which also serves the
single-map heatmap CenterNet, as one level) and `centernet_s8_loss`; the
other detectors' compositions of that file are not ported yet. Each
returns per-example-sum
scalars; the train step divides by the batch size, or by ``num_pos`` — the
number of positive cells in the batch, which the dict carries — under
``loss_norm="pos"``.

The classification term is the focal loss. On a CUDA tensor it is the
hand-written kernel (`detectax_torch.kernels.focal.focal_loss`), with no
switch to turn on; on a CPU tensor, or with ``kernels="plain"``, its plain
version `detectax_torch.ops.losses.focal_loss`. The class channels
``y[..., 5:]`` are strided views of the level maps: the kernel's wrapper
reads them in place by their row stride.
"""
from __future__ import annotations

from typing import Sequence

import torch

from detectax_torch.kernels.focal import focal_loss as focal_loss_kernel
from detectax_torch.ops.losses import focal_loss as focal_loss_plain
from detectax_torch.ops.losses import iou_loss, smooth_l1_loss


def _focal_fn(kernels):
    if kernels is None:
        return focal_loss_kernel   # plain on a CPU tensor, kernel on CUDA
    if kernels == "plain":
        return focal_loss_plain
    raise ValueError(f"kernels must be None or 'plain', got {kernels!r}")


def fcos_loss(
    y_true: Sequence[torch.Tensor],
    y_pred: Sequence[torch.Tensor],
    *,
    reg_type: str = "l1",
    cen_type: str = "l1",
    cls_lambda: float = 2.5,
    reg_lambda: float = 1.0,
    kernels=None,
) -> dict:
    """Multi-level FCOS loss. Layout per level: [reg(4), cen(1), cls(nc)].

    ``kernels="plain"`` runs the focal term on its plain version whatever
    the device (the reference the kernel path is held against)."""
    focal_loss = _focal_fn(kernels)
    cls_loss = 0.0
    reg_loss = 0.0
    cen_loss = 0.0
    num_pos = 0.0
    for yt, yp in zip(y_true, y_pred):
        obj = yt[..., 5:].amax(dim=-1)
        mask = (obj >= 1.0).to(torch.float32)
        num_pos = num_pos + mask.sum()
        cls_loss = cls_loss + focal_loss(yt[..., 5:], yp[..., 5:])
        if cen_type == "l1":
            # sigmoid(pred) against the target with an unmasked smooth-L1.
            # torch.sigmoid, NOT 1/(1+exp(-x)): the naive form's derivative
            # is 0*inf = NaN once a background logit drifts below ~-88 —
            # the unmasked L1 pushes background centerness there.
            cen_loss = cen_loss + smooth_l1_loss(
                yt[..., 4], torch.sigmoid(yp[..., 4]))
        else:
            cen_loss = cen_loss + focal_loss(yt[..., 4], yp[..., 4])
        if reg_type == "iou":
            reg_loss = reg_loss + iou_loss(yt[..., :4], yp[..., :4], mask)
        else:
            reg_loss = reg_loss + smooth_l1_loss(
                yt[..., :4], yp[..., :4], mask=mask)
    total = cls_lambda * cls_loss + reg_lambda * (reg_loss + cen_loss)
    return {
        "cls": cls_loss, "reg": reg_loss, "cen": cen_loss, "total": total,
        "num_pos": num_pos,
    }


def centernet_s8_loss(
    y_true: torch.Tensor,
    y_pred: torch.Tensor,
    *,
    cls_lambda: float = 1.0,
    reg_lambda: float = 1.0,
    kernels=None,
) -> dict:
    """Scale-slot loss over ``[B, h, w, S, 4+nc]`` maps: focal on the class
    channels, smooth-L1 on the regression masked to the positives.

    Positives are cells whose class target reaches 1.0 — identical to
    (obj > 0) for one-hot targets, and keeps regression centroid-only
    under `gaussian_cls` soft targets (tails < 1.0). ``kernels`` as in
    `fcos_loss`."""
    focal_loss = _focal_fn(kernels)
    obj = y_true[..., 4:].amax(dim=-1)
    mask = (obj >= 1.0 - 1e-6).to(torch.float32)
    cls_loss = focal_loss(y_true[..., 4:], y_pred[..., 4:])
    reg_loss = smooth_l1_loss(y_true[..., :4], y_pred[..., :4], mask=mask)
    total = cls_lambda * cls_loss + reg_lambda * reg_loss
    return {"cls": cls_loss, "reg": reg_loss, "total": total,
            "num_pos": mask.sum()}
