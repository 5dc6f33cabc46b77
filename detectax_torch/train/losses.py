"""Loss compositions over the shared `ops.losses` library.

Port of `detectax/train/losses.py`: `fcos_loss` (which also serves the
single-map heatmap CenterNet, as one level), `centernet_s8_loss`,
`hourglass_loss`, `stacked_hourglass_loss` and `retinanet_loss`. Each
returns per-example-sum scalars; the train step divides by the batch
size, or by ``num_pos`` — the number of positive cells in the batch,
which the dict carries — under ``loss_norm="pos"``.

The classification term is the focal loss. On a CUDA tensor it is the
hand-written kernel, with no switch to turn on: `fcos_loss` hands every
level's class channels (and, under ``cen_type="focal"``, every level's
centerness) to one call of `detectax_torch.kernels.focal.focal_loss_group`
— one forward and one backward launch a step — as `retinanet_loss` does
with its five levels' class channels, and `centernet_s8_loss`,
`stacked_hourglass_loss` and `hourglass_loss` (under ``loss_type="focal"``)
call `focal_loss`. On a CPU tensor, or with ``kernels="plain"``, they run
the plain versions (`focal_loss_group_plain`, which is
`detectax_torch.ops.losses.focal_loss` once a segment). The class channels
``y[..., 5:]`` (RetinaNet: ``y[..., 4:]``) are strided views of the level
maps: the kernel's wrapper reads them in place by their row stride.
"""
from __future__ import annotations

from typing import Sequence

import torch

from detectax_torch.kernels import focal as focal_kernels
from detectax_torch.ops.losses import focal_loss as focal_loss_plain
from detectax_torch.ops.losses import (
    iou_loss,
    sigmoid_bce_loss,
    smooth_l1_loss,
)


def _focal_fns(kernels):
    """(one-segment focal, grouped focal) for ``kernels``: the wrappers
    (plain on a CPU tensor, kernel on CUDA) or the plain versions."""
    if kernels is None:
        return focal_kernels.focal_loss, focal_kernels.focal_loss_group
    if kernels == "plain":
        return focal_loss_plain, focal_kernels.focal_loss_group_plain
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
    _, focal_group = _focal_fns(kernels)
    levels = list(zip(y_true, y_pred))
    # every focal term of the step in one call, added below in the order
    # the loop of the JAX package adds them
    segments = [(yt[..., 5:], yp[..., 5:]) for yt, yp in levels]
    if cen_type != "l1":
        segments += [(yt[..., 4], yp[..., 4]) for yt, yp in levels]
    sums = focal_group(segments).unbind(0) if segments else ()
    cls_loss = 0.0
    reg_loss = 0.0
    cen_loss = 0.0
    num_pos = 0.0
    for i, (yt, yp) in enumerate(levels):
        obj = yt[..., 5:].amax(dim=-1)
        mask = (obj >= 1.0).to(torch.float32)
        num_pos = num_pos + mask.sum()
        cls_loss = cls_loss + sums[i]
        if cen_type == "l1":
            # sigmoid(pred) against the target with an unmasked smooth-L1.
            # torch.sigmoid, NOT 1/(1+exp(-x)): the naive form's derivative
            # is 0*inf = NaN once a background logit drifts below ~-88 —
            # the unmasked L1 pushes background centerness there.
            cen_loss = cen_loss + smooth_l1_loss(
                yt[..., 4], torch.sigmoid(yp[..., 4]))
        else:
            cen_loss = cen_loss + sums[len(levels) + i]
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
    focal_loss, _ = _focal_fns(kernels)
    obj = y_true[..., 4:].amax(dim=-1)
    mask = (obj >= 1.0 - 1e-6).to(torch.float32)
    cls_loss = focal_loss(y_true[..., 4:], y_pred[..., 4:])
    reg_loss = smooth_l1_loss(y_true[..., :4], y_pred[..., :4], mask=mask)
    total = cls_lambda * cls_loss + reg_lambda * reg_loss
    return {"cls": cls_loss, "reg": reg_loss, "total": total,
            "num_pos": mask.sum()}


def hourglass_loss(
    y_true: torch.Tensor,
    y_pred: torch.Tensor,
    *,
    loss_type: str = "sigmoid",
    reg_lambda: float = 0.10,
    kernels=None,
) -> dict:
    """Hourglass loss over ``[B, h, w, 4, 5+nc]`` maps, channel 4 the
    objectness: sigmoid cross-entropy (``loss_type="sigmoid"``, no kernel)
    or the focal loss (``"focal"``) on ``[objectness, classes]``, and a
    plain (not smooth) L1 sum on the regression masked by the objectness
    target. ``num_pos`` is the sum of that mask. ``kernels`` as in
    `fcos_loss`."""
    if loss_type not in ("sigmoid", "focal"):
        raise ValueError(f"unknown loss_type {loss_type!r}")
    mask = y_true[..., 4]
    if loss_type == "sigmoid":
        cls_loss = sigmoid_bce_loss(y_true[..., 4:], y_pred[..., 4:])
    else:
        focal_loss, _ = _focal_fns(kernels)
        cls_loss = focal_loss(y_true[..., 4:], y_pred[..., 4:])
    reg_loss = (torch.abs(y_true[..., :4] - y_pred[..., :4])
                * mask[..., None]).sum()
    total = cls_loss + reg_lambda * reg_loss
    return {"cls": cls_loss, "reg": reg_loss, "total": total,
            "num_pos": mask.sum()}


def stacked_hourglass_loss(
    y_true: torch.Tensor,
    y_pred: torch.Tensor,
    *,
    cls_lambda: float = 2.5,
    reg_lambda: float = 1.0,
    kernels=None,
) -> dict:
    """Stacked-hourglass loss over ``[B, h, w, 4+nc]`` maps: focal on the
    class channels (read in place, ``4+nc`` columns a cell), smooth-L1 on
    the raw (t, b, l, r) regression masked by the cells with any class hit
    (``max(cls) > 0``), whose count is ``num_pos``. ``kernels`` as in
    `fcos_loss`."""
    focal_loss, _ = _focal_fns(kernels)
    mask = (y_true[..., 4:].amax(dim=-1) > 0).to(torch.float32)
    cls_loss = focal_loss(y_true[..., 4:], y_pred[..., 4:])
    reg_loss = smooth_l1_loss(y_true[..., :4], y_pred[..., :4], mask=mask)
    total = cls_lambda * cls_loss + reg_lambda * reg_loss
    return {"cls": cls_loss, "reg": reg_loss, "total": total,
            "num_pos": mask.sum()}


def retinanet_loss(
    y_true: Sequence[torch.Tensor],
    y_pred: Sequence[torch.Tensor],
    *,
    cls_lambda: float = 1.0,
    reg_lambda: float = 1.0,
    kernels=None,
) -> dict:
    """Anchor loss over five levels of ``[B, h, w, A, 4+nc]`` maps: focal
    on the class channels — all five levels in one `focal_loss_group`
    call, the sums added in the JAX loop's order — and smooth-L1 on the
    regression masked to the anchors with a positive class target
    (``max(cls) > 0``). ``num_pos`` counts those anchors. ``kernels`` as
    in `fcos_loss`."""
    _, focal_group = _focal_fns(kernels)
    levels = list(zip(y_true, y_pred))
    sums = focal_group([(yt[..., 4:], yp[..., 4:]) for yt, yp in levels])
    sums = sums.unbind(0)
    cls_loss = 0.0
    reg_loss = 0.0
    num_pos = 0.0
    for i, (yt, yp) in enumerate(levels):
        mask = (yt[..., 4:].amax(dim=-1) > 0).to(torch.float32)
        num_pos = num_pos + mask.sum()
        cls_loss = cls_loss + sums[i]
        reg_loss = reg_loss + smooth_l1_loss(
            yt[..., :4], yp[..., :4], mask=mask)
    total = cls_lambda * cls_loss + reg_lambda * reg_loss
    return {"cls": cls_loss, "reg": reg_loss, "total": total,
            "num_pos": num_pos}
