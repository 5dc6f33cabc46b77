"""Inference: forward → decode → fixed-shape NMS.

Port of the FCOS part of `detectax/infer/predict.py`: per-level decode
(`ops.boxes`), candidate selection and the shared deterministic NMS
(`ops.nms`). Everything static-shape; batch-first. The CenterNet, hourglass
and RetinaNet decoders wait for their model families.
"""
from __future__ import annotations

from typing import Sequence

import torch

from detectax_torch.ops import nms as nms_lib
from detectax_torch.ops.boxes import ltrb_to_corners, offset_scale_to_corners

FCOS_STRIDES = (8, 16, 32, 64, 128)


def fcos_decode(
    outputs: Sequence[torch.Tensor],
    *,
    strides: Sequence[int] = FCOS_STRIDES,
    use_centerness: bool = True,
):
    """FCOS ltrb decode: per level ltrb→corners at grid+0.5, scores =
    σ(cls) [× σ(cen)]. Returns (boxes [B,M,4] pixels yxyx, probs
    [B,M,nc])."""
    all_boxes, all_probs = [], []
    for out, stride in zip(outputs, strides):
        reg = out[..., :4]
        cen = out[..., 4]
        cls = out[..., 5:]
        boxes = ltrb_to_corners(reg, float(stride))
        probs = torch.sigmoid(cls)
        if use_centerness:
            probs = probs * torch.sigmoid(cen)[..., None]
        b = out.shape[0]
        all_boxes.append(boxes.reshape(b, -1, 4))
        all_probs.append(probs.reshape(b, -1, probs.shape[-1]))
    return torch.cat(all_boxes, dim=1), torch.cat(all_probs, dim=1)


def fcos_center_v1_decode(
    outputs: Sequence[torch.Tensor],
    *,
    strides: Sequence[int] = FCOS_STRIDES,
    box_scales: Sequence[float],
):
    """Offset+scale decode of the ``center_v1`` variant."""
    all_boxes, all_probs = [], []
    for out, stride, sc in zip(outputs, strides, box_scales):
        reg = out[..., :4]
        cen = out[..., 4]
        cls = out[..., 5:]
        boxes = offset_scale_to_corners(reg, float(sc), float(stride))
        probs = torch.sigmoid(cls) * torch.sigmoid(cen)[..., None]
        b = out.shape[0]
        all_boxes.append(boxes.reshape(b, -1, 4))
        all_probs.append(probs.reshape(b, -1, probs.shape[-1]))
    return torch.cat(all_boxes, dim=1), torch.cat(all_probs, dim=1)


def detections_from_dense(
    boxes: torch.Tensor,
    probs: torch.Tensor,
    *,
    top_k: int = 1024,
    iou_thresh: float = 0.5,
    score_thresh: float = 0.05,
    max_outputs: int = 100,
    class_aware: bool = True,
    mode: str = "hard",
    soft_sigma: float = 0.3,
    class_aware_candidates: bool = False,
    fused: bool | None = None,
    kernels=None,
):
    """Batched candidate selection + NMS over dense (boxes ``[B, M, 4]``,
    probs ``[B, M, C]``).

    ``fused`` selects the one-kernel selection+suppression path
    (`ops.nms.dense_nms`): no top-k stage — greedy NMS runs directly on
    the full dense set via iterative argmax, strictly more complete than
    any ``top_k`` truncation (identical when ``top_k >= M``). Default
    ``None`` enables it on a CUDA tensor for the hard / argmax-class
    configuration it covers; soft-NMS and combined-NMS candidate semantics
    always use the two-stage path, and so does a CPU tensor.

    ``class_aware_candidates=True`` ranks all M*C (box, class) pairs so one
    box can surface under several classes (combined-NMS semantics, the
    reference FCOS infer path). False ranks each box only under its argmax
    class.

    ``kernels`` is the structure override of `ops.nms`: ``False`` keeps
    the whole path free of the hand-written kernels (two-stage, [K, K]
    matrix), ``"plain"`` takes the structure of a CUDA tensor with each
    kernel replaced by its plain version.
    """
    # f32 from here on: NMS geometry needs the precision
    boxes = boxes.to(torch.float32)
    probs = probs.to(torch.float32)

    if fused is None:
        if kernels is False:
            fused = False  # kernel-free: two-stage everywhere
        elif mode == "hard" and not class_aware_candidates:
            fused = boxes.is_cuda or kernels == "plain"
        else:
            fused = False  # soft/combined: two-stage only

    if fused:
        return nms_lib.dense_nms(
            boxes, probs.amax(dim=-1),
            probs.argmax(dim=-1).to(torch.int32),
            iou_thresh=iou_thresh, score_thresh=score_thresh,
            max_outputs=max_outputs, class_aware=class_aware,
            kernels=kernels,
        )
    cb, cs, cc = nms_lib.select_top_k(
        boxes, probs, top_k, class_aware_candidates=class_aware_candidates
    )
    return nms_lib.nms(
        cb, cs, cc,
        iou_thresh=iou_thresh, score_thresh=score_thresh,
        max_outputs=max_outputs, class_aware=class_aware,
        mode=mode, soft_sigma=soft_sigma, kernels=kernels,
    )


def class_heatmap(probs: torch.Tensor, hw: tuple[int, int]) -> torch.Tensor:
    """Max class probability per cell for the heatmap dumps. probs:
    [M, nc] flattened from a single level of shape hw. Returns [h, w]."""
    return probs.amax(dim=-1).reshape(hw)
