"""Fixed-shape, deterministic NMS.

Port of `detectax/ops/nms.py`. One function (+ flags) covers batched
class-aware NMS, class-wise NMS with the soft-NMS option, and
class-agnostic NMS. Everything is static-shape: callers pre-select K
candidates with `select_top_k`, suppression runs over them, and results
come back padded to ``max_outputs`` with a validity mask.

Where the JAX package maps a function over the batch, the port writes the
batch dimension out: every function takes ``[B, K, ...]`` tensors, and an
unbatched ``[K, ...]`` input is accepted and returned unbatched.

Structure choice (``kernels`` argument of `nms` and `dense_nms`):

* ``None`` — on a CUDA tensor hard NMS over K >= `KERNEL_SUPPRESSION_MIN_K`
  candidates runs the hand-written sweep kernel
  (`detectax_torch.kernels.nms.nms_sweep`), which never forms the [K, K]
  IoU matrix; below that, for soft NMS, and on a CPU tensor the [K, K]
  matrix path runs.
* ``True`` — the kernel wrappers whatever K (on a CPU tensor a wrapper
  runs its plain version).
* ``False`` — no kernel: the [K, K] matrix path, and the plain version of
  the dense kernel.
* ``"plain"`` — the structure ``None`` picks on a CUDA tensor, with each
  kernel replaced by its plain PyTorch version, on any device. It exists
  to hold a kernel path against its plain twin end to end.

Ties are ordered as the JAX package orders them: sorts are stable, so
among equal scores the lower index comes first.
"""
from __future__ import annotations

import torch

from detectax_torch.kernels import nms as nms_kernels
from detectax_torch.ops.boxes import pairwise_iou_corners

# Candidate count from which hard-NMS suppression on a CUDA tensor runs as
# the sweep kernel instead of the loop over a precomputed [K, K] matrix
# (the JAX package's PALLAS_SUPPRESSION_MIN_K).
KERNEL_SUPPRESSION_MIN_K = 256

_KERNEL_CHOICES = (None, True, False, "plain")


def _check_kernels_arg(kernels) -> None:
    if not (kernels is None or isinstance(kernels, bool)
            or kernels == "plain"):
        raise ValueError(
            f"kernels must be one of {_KERNEL_CHOICES}, got {kernels!r}"
        )


def _unsqueeze_all(boxes: torch.Tensor, *rest):
    """(squeeze, tensors) with a batch dim added when ``boxes`` is
    ``[K, 4]`` and not ``[B, K, 4]``."""
    squeeze = boxes.ndim == 2
    tensors = (boxes, *rest)
    if squeeze:
        tensors = tuple(t.unsqueeze(0) for t in tensors)
    return squeeze, tensors


def _squeeze_dict(out: dict, squeeze: bool) -> dict:
    return {k: v[0] for k, v in out.items()} if squeeze else out


def _top_k(x: torch.Tensor, k: int):
    """Top-k along the last dim, lower index first among ties (the order
    `jax.lax.top_k` gives; `torch.topk` promises none)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[b, idx[b]]`` for ``x [B, K, ...]``, ``idx [B, N]``."""
    if x.ndim == 3:
        idx = idx[..., None].expand(-1, -1, x.shape[-1])
    return torch.gather(x, 1, idx)


def select_top_k(
    boxes: torch.Tensor,
    cls_scores: torch.Tensor,
    k: int,
    class_aware_candidates: bool = False,
):
    """Select the top-k candidate (box, score, class) triples.

    Args:
      boxes: ``[B, M, 4]`` corner boxes.
      cls_scores: ``[B, M, C]`` per-class probabilities.
      k: static number of candidates to keep.
      class_aware_candidates: if True, rank all ``M*C`` (box, class) pairs
        (combined-NMS semantics, a box can surface under several classes);
        if False, rank boxes by their max-prob class.

    Returns:
      (boxes ``[B, k, 4]``, scores ``[B, k]``, classes ``[B, k]`` int32);
      when fewer than k candidates exist the tail is padded with zero
      boxes, score -1 and class 0.
    """
    squeeze, (boxes, cls_scores) = _unsqueeze_all(boxes, cls_scores)
    _, m, c = cls_scores.shape
    if class_aware_candidates:
        flat = cls_scores.reshape(cls_scores.shape[0], m * c)
        k_eff = min(k, m * c)
        scores, idx = _top_k(flat, k_eff)
        box_idx = torch.div(idx, c, rounding_mode="floor")
        classes = (idx % c).to(torch.int32)
    else:
        best = cls_scores.amax(dim=-1)
        k_eff = min(k, m)
        scores, box_idx = _top_k(best, k_eff)
        classes = _take(cls_scores.argmax(dim=-1), box_idx).to(torch.int32)
    out_boxes = _take(boxes, box_idx)
    if k_eff < k:
        pad = k - k_eff
        out_boxes = torch.nn.functional.pad(out_boxes, (0, 0, 0, pad))
        scores = torch.nn.functional.pad(scores, (0, pad), value=-1.0)
        classes = torch.nn.functional.pad(classes, (0, pad))
    if squeeze:
        return out_boxes[0], scores[0], classes[0]
    return out_boxes, scores, classes


def _suppression_mask(iou: torch.Tensor, thresh: float) -> torch.Tensor:
    """Greedy hard-NMS keep mask ``[B, K]`` for score-descending candidates
    from their IoU matrix ``[B, K, K]``:
    ``keep[i] = no kept j < i has iou[j, i] > thresh``."""
    k = iou.shape[-1]
    idx = torch.arange(k, device=iou.device)
    keep = torch.ones(iou.shape[:2], dtype=torch.bool, device=iou.device)
    over = iou > thresh
    for i in range(k):
        row_sup = over[:, i] & (idx > i) & keep[:, i:i + 1]
        keep = keep & ~row_sup
    return keep


def _soft_nms_scores(
    iou: torch.Tensor, scores: torch.Tensor, sigma: float
) -> torch.Tensor:
    """Soft-NMS rescoring (Bodla et al. 2017), Gaussian decay:
    ``score *= exp(-iou^2 / sigma)`` against each selected box, applied in
    score order. Returns the decayed scores; callers threshold afterwards.
    """
    batch, k = scores.shape
    idx = torch.arange(k, device=scores.device)
    rows = torch.arange(batch, device=scores.device)
    done = torch.zeros((batch, k), dtype=torch.bool, device=scores.device)
    for _ in range(k):
        masked = torch.where(done, float("-inf"), scores)
        top = masked.amax(dim=-1, keepdim=True)
        # first index among the maxima, as argmax gives it
        i = torch.where(masked >= top, idx, k).amin(dim=-1)
        row = iou[rows, i]
        weight = torch.exp(-(row * row) / sigma)
        is_i = idx == i[:, None]
        scores = torch.where(~done & ~is_i, scores * weight, scores)
        done = done | is_i
    return scores


def _class_masked_iou(boxes_s, classes_s, class_aware: bool):
    iou = pairwise_iou_corners(boxes_s, boxes_s)
    if class_aware:
        same_class = classes_s[:, :, None] == classes_s[:, None, :]
        iou = iou * same_class.to(iou.dtype)
    return iou


def _sweep_fn(kernels, k: int, is_cuda: bool):
    """The sweep to run in place of the [K, K] matrix path, or None."""
    if kernels is True:
        return nms_kernels.nms_sweep
    if kernels is False or k < KERNEL_SUPPRESSION_MIN_K:
        return None
    if kernels == "plain":
        return nms_kernels.nms_sweep_plain
    return nms_kernels.nms_sweep if is_cuda else None


def nms(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    classes: torch.Tensor,
    *,
    iou_thresh: float = 0.5,
    score_thresh: float = 0.0,
    max_outputs: int = 100,
    class_aware: bool = True,
    mode: str = "hard",
    soft_sigma: float = 0.3,
    kernels=None,
):
    """Deterministic fixed-shape NMS over K pre-selected candidates.

    Args:
      boxes: ``[B, K, 4]`` corner boxes (any consistent axis order).
      scores: ``[B, K]``; classes: ``[B, K]`` int32.
      kernels: structure override, see the module docstring.

    Returns:
      dict of ``boxes [B, max_outputs, 4]``, ``scores``, ``classes``,
      ``valid`` (bool) ``[B, max_outputs]`` and ``num_valid [B]`` — sorted
      by final score descending. A candidate below ``score_thresh`` still
      suppresses others and is dropped afterwards.
    """
    _check_kernels_arg(kernels)
    if mode not in ("hard", "soft"):
        raise ValueError(f"unknown NMS mode {mode!r} (hard|soft)")
    squeeze, (boxes, scores, classes) = _unsqueeze_all(
        boxes, scores, classes
    )
    order = torch.sort(-scores, dim=-1, stable=True).indices
    boxes_s = _take(boxes, order)
    scores_s = _take(scores, order)
    classes_s = _take(classes, order)

    if mode == "soft":
        iou = _class_masked_iou(boxes_s, classes_s, class_aware)
        new_scores = _soft_nms_scores(iou, scores_s, soft_sigma)
        # Re-rank by decayed score; keep everything above threshold (boxes
        # decayed to <= 0 are dropped).
        reorder = torch.sort(-new_scores, dim=-1, stable=True).indices
        boxes_s = _take(boxes_s, reorder)
        classes_s = _take(classes_s, reorder)
        scores_s = _take(new_scores, reorder)
        keep = scores_s > max(score_thresh, 0.0)
    else:
        sweep = _sweep_fn(kernels, boxes_s.shape[1], boxes_s.is_cuda)
        if sweep is not None:
            # no [K, K] IoU matrix; class masking happens inside the sweep
            keep = sweep(
                boxes_s, iou_thresh,
                classes=classes_s if class_aware else None,
            )
        else:
            iou = _class_masked_iou(boxes_s, classes_s, class_aware)
            keep = _suppression_mask(iou, iou_thresh)
        keep = keep & (scores_s >= score_thresh)

    return _squeeze_dict(
        _compact(boxes_s, scores_s, classes_s, keep, max_outputs), squeeze
    )


def _compact(boxes_s, scores_s, classes_s, keep, max_outputs: int):
    """Compact kept entries to the front, pad to max_outputs (batched)."""
    k = boxes_s.shape[1]
    ar = torch.arange(k, device=keep.device)
    rank = torch.where(keep, torch.cumsum(keep, dim=-1) - 1, k)
    out_idx = torch.argsort(
        torch.where(keep, rank, k + ar), dim=-1
    )[:, :max_outputs]
    valid = _take(keep, out_idx)
    vf = valid.to(boxes_s.dtype)
    return {
        "boxes": _take(boxes_s, out_idx) * vf[..., None],
        "scores": _take(scores_s, out_idx) * vf,
        "classes": torch.where(valid, _take(classes_s, out_idx), -1),
        "valid": valid,
        # survivors actually returned (keep count clamped to max_outputs)
        "num_valid": torch.clamp_max(
            keep.sum(dim=-1, dtype=torch.int32), max_outputs
        ),
    }


def batched_nms(boxes, scores, classes, **kwargs):
    """`nms` over a leading batch axis (the shape of TF combined NMS)."""
    if boxes.ndim != 3:
        raise ValueError(f"batched_nms wants [B, K, 4] boxes, got "
                         f"{tuple(boxes.shape)}")
    return nms(boxes, scores, classes, **kwargs)


def dense_nms(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    classes: torch.Tensor,
    *,
    iou_thresh: float = 0.5,
    score_thresh: float = 0.0,
    max_outputs: int = 100,
    class_aware: bool = True,
    kernels=None,
):
    """Fused selection+suppression hard NMS over the FULL dense candidate
    set ``[B, M]`` — no top-k stage, no sort, no [M, M] matrix.

    Equivalent to ``nms(select_top_k(...), mode="hard")`` with ``top_k=M``
    (iterative argmax == stable descending sort for greedy NMS); strictly
    more complete than any top-k truncation. On a CUDA tensor this is one
    hand-written kernel (`detectax_torch.kernels.nms.dense_nms`); on a CPU
    tensor, or with ``kernels`` False or "plain", its plain version.
    """
    _check_kernels_arg(kernels)
    fn = (nms_kernels.dense_nms if kernels is None or kernels is True
          else nms_kernels.dense_nms_plain)
    return fn(
        boxes, scores, classes,
        iou_thresh=iou_thresh, score_thresh=score_thresh,
        max_outputs=max_outputs, class_aware=class_aware,
    )
