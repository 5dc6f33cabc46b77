"""Inference: forward → decode → fixed-shape NMS.

Port of `detectax/infer/predict.py`: per-level decode (`ops.boxes`,
`ops.anchors`), the heatmap peak mask (`kernels.peak`), candidate
selection and the shared deterministic NMS (`ops.nms`). Everything
static-shape; batch-first.
"""
from __future__ import annotations

from typing import Sequence

import torch

from detectax_torch.kernels import peak as peak_lib
from detectax_torch.ops import anchors as anchor_lib
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


def centernet_s8_decode(
    output: torch.Tensor,
    *,
    box_scales: Sequence[float],
    stride: int = 8,
):
    """Scale-slot decode: output ``[B,h,w,S,4+nc]``, reg already
    sigmoid-activated by the model. Returns (boxes ``[B,S*h*w,4]``, probs
    ``[B,S*h*w,nc]``), slot-major."""
    b, _, _, s, _ = output.shape
    if len(box_scales) != s:
        raise ValueError(f"{len(box_scales)} box scales for {s} slots")
    all_boxes, all_probs = [], []
    for slot in range(s):
        reg = output[:, :, :, slot, :4]
        cls = output[:, :, :, slot, 4:]
        boxes = offset_scale_to_corners(
            reg, float(box_scales[slot]), float(stride))
        all_boxes.append(boxes.reshape(b, -1, 4))
        all_probs.append(torch.sigmoid(cls).reshape(b, -1, cls.shape[-1]))
    return torch.cat(all_boxes, dim=1), torch.cat(all_probs, dim=1)


def hourglass_decode(
    output: torch.Tensor,
    *,
    box_scales: Sequence[float],
    stride: int = 8,
):
    """Hourglass decode: output ``[B,h,w,4,5+nc]`` with sigmoid reg and the
    objectness logit in channel 4; score = σ(obj)·σ(cls). Returns (boxes
    ``[B,4*h*w,4]``, probs ``[B,4*h*w,nc]``), slot-major."""
    b, _, _, s, _ = output.shape
    if len(box_scales) != s:
        raise ValueError(f"{len(box_scales)} box scales for {s} slots")
    all_boxes, all_probs = [], []
    for slot in range(s):
        reg = output[:, :, :, slot, :4]
        obj = output[:, :, :, slot, 4]
        cls = output[:, :, :, slot, 5:]
        boxes = offset_scale_to_corners(
            reg, float(box_scales[slot]), float(stride))
        probs = torch.sigmoid(cls) * torch.sigmoid(obj)[..., None]
        all_boxes.append(boxes.reshape(b, -1, 4))
        all_probs.append(probs.reshape(b, -1, probs.shape[-1]))
    return torch.cat(all_boxes, dim=1), torch.cat(all_probs, dim=1)


def stacked_hourglass_decode(output: torch.Tensor, *, stride: int = 4):
    """Stacked-hourglass decode: output ``[B,h,w,4+nc]`` with raw (t,b,l,r)
    reg in stride units from the cell centre; corners = ``stride * (grid
    ∓ reg)``, scores = σ(cls). Default stride 4, the model's output
    stride."""
    b, h, w, _ = output.shape
    boxes = ltrb_to_corners(output[..., :4], float(stride))
    probs = torch.sigmoid(output[..., 4:].to(torch.float32))
    return boxes.reshape(b, -1, 4), probs.reshape(b, h * w, probs.shape[-1])


def centernet_heatmap_decode(
    output: torch.Tensor,
    *,
    stride: int = 8,
    use_centerness: bool = True,
    peak_mask: bool = True,
    skip_background: bool = True,
    kernels=None,
):
    """Single-map heatmap decode for `CenterNetFPNSingle`: output
    ``[B,h,w,4+1+C]`` with raw ltrb reg (stride units), a center-prior
    channel and C class logits (objectness slot at index 0, dropped when
    ``skip_background``).

    Pipeline: sigmoid → (×σ(center)) → 3x3 local-peak mask (the CenterNet
    maxpool-equals trick) → dense (boxes, probs) for
    `detections_from_dense` / plain top-k.

    The peak mask is the hand-written kernel `kernels.peak.peak_mask_scores`
    on a CUDA tensor (its plain version on a CPU tensor), taken on the
    ``[B,h,w,C]`` scores as they lie — no transposition around it.
    ``kernels="plain"`` runs the plain version whatever the device."""
    if kernels is None:
        mask_fn = peak_lib.peak_mask_scores
    elif kernels == "plain":
        mask_fn = peak_lib.peak_mask_scores_plain
    else:
        raise ValueError(f"kernels must be None or 'plain', got {kernels!r}")
    b, h, w, _ = output.shape
    reg = output[..., :4]
    cen = output[..., 4]
    cls = output[..., 5:]
    boxes = ltrb_to_corners(reg, float(stride))
    probs = torch.sigmoid(cls.to(torch.float32))
    if skip_background:
        probs = probs[..., 1:]
    if use_centerness:
        probs = probs * torch.sigmoid(cen.to(torch.float32))[..., None]
    if peak_mask:
        probs = mask_fn(probs)
    return boxes.reshape(b, -1, 4), probs.reshape(b, h * w, probs.shape[-1])


def retinanet_decode(
    outputs: Sequence[torch.Tensor],
    *,
    anchors_per_level: Sequence[torch.Tensor],
    strides: Sequence[int] = FCOS_STRIDES,
):
    """Anchor-relative decode of the five ``[B, h, w, A, 4+nc]`` maps: per
    level the anchor boxes, `ops.anchors.decode_anchor_regression` and the
    sigmoid of the class logits. Returns (boxes ``[B, M, 4]`` pixels yxyx,
    probs ``[B, M, nc]``), candidates ordered level-major, then cell, then
    anchor."""
    all_boxes, all_probs = [], []
    for out, stride, anchors_hw in zip(outputs, strides, anchors_per_level):
        b, h, w, _, _ = out.shape
        ab = anchor_lib.anchor_boxes_level(h, w, stride, anchors_hw,
                                           device=out.device)
        boxes = anchor_lib.decode_anchor_regression(out[..., :4], ab[None])
        cls = out[..., 4:]
        all_boxes.append(boxes.reshape(b, -1, 4))
        all_probs.append(torch.sigmoid(cls).reshape(b, -1, cls.shape[-1]))
    return torch.cat(all_boxes, dim=1), torch.cat(all_probs, dim=1)


def resolve_fused(
    fused: bool | None,
    device: torch.device,
    *,
    mode: str = "hard",
    class_aware_candidates: bool = False,
    kernels=None,
) -> bool:
    """The structure `detections_from_dense` takes on ``device``: ``fused``
    when given, else the one-kernel dense path for the hard / argmax-class
    configuration on a CUDA device (or under ``kernels="plain"``), and the
    two-stage path otherwise (always under ``kernels=False``). An export
    resolves it once for the device it traces on and records the value,
    as the JAX package's ``--fused auto`` resolves per platform."""
    if fused is not None:
        return bool(fused)
    if kernels is False:
        return False  # kernel-free: two-stage everywhere
    if mode == "hard" and not class_aware_candidates:
        return torch.device(device).type == "cuda" or kernels == "plain"
    return False  # soft/combined: two-stage only


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

    fused = resolve_fused(fused, boxes.device, mode=mode,
                          class_aware_candidates=class_aware_candidates,
                          kernels=kernels)
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
