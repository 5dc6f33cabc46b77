"""The two NMS kernels of the serving path: wrappers and plain versions.

* `nms_sweep` — greedy suppression sweep over K score-sorted boxes.
  Replaces the TPU kernel
  ``detectax/ops/pallas/nms_kernel.py::suppression_mask_pallas``
  (`_nms_kernel`). CUDA source: ``csrc/nms_sweep.cu``.
* `dense_nms` — fused selection + suppression over the full dense set.
  Replaces ``detectax/ops/pallas/nms_kernel.py::dense_nms_pallas``
  (`_dense_nms_kernel`). CUDA source: ``csrc/dense_nms.cu``.

Both are bound by their chain of dependent rounds (one per surviving box),
not by the card's byte or arithmetic rates: an image's candidates are tens
of KB, and each image is one thread block on one SM. A round is that
block's pass over its candidates plus one barrier; on an H100 the pass, not
the barrier, sets a round's time (`PERF.md`, `kernels/probe.py`).
Images run in parallel, so a batch costs about what its longest image
costs; the sources say what each design does to keep a round at one pass
and one barrier.

Beside each wrapper stands its plain PyTorch version (`nms_sweep_plain`,
`dense_nms_plain`), the same arithmetic in the same order, vectorised over
the batch. A wrapper takes the plain version only for a tensor on the CPU;
for a CUDA tensor it launches the kernel or raises.

Every function takes a leading batch dimension; an unbatched input
(``[K, 4]``) is accepted and returned unbatched.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from detectax_torch.kernels import _common

_BIG = 1e9
# a block may use 227 KB of shared memory on Hopper
_MAX_SMEM = 232448
_SWEEP_BYTES_PER_BOX = 25  # float4 box + area + class + keep byte
_DENSE_STATIC_SMEM = 512   # the argmax stage's slots


@functools.cache
def load_kernels() -> ctypes.CDLL:
    """The built library with this module's argument types declared."""
    lib = _common.load_library()
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.detectax_nms_sweep.argtypes = [p, p, p, p, i, i, f, i, p]
    lib.detectax_nms_sweep.restype = i
    lib.detectax_dense_nms.argtypes = [p, p, p, p, p, p, p,
                                       i, i, i, f, f, i, i, p]
    lib.detectax_dense_nms.restype = i
    return lib


def _block_threads(n: int) -> int:
    return min(1024, max(32, _common.round_up(n, 32)))


def _same_device(ref: torch.Tensor, **tensors) -> None:
    for name, t in tensors.items():
        if t is not None and t.device != ref.device:
            raise ValueError(
                f"{name} lies on {t.device}, boxes on {ref.device}"
            )


def _batched(boxes: torch.Tensor, *rest):
    """Add the batch dimension an unbatched call left out."""
    if boxes.ndim not in (2, 3) or boxes.shape[-1] != 4:
        raise ValueError(f"boxes must be [K, 4] or [B, K, 4], got "
                         f"{tuple(boxes.shape)}")
    squeeze = boxes.ndim == 2
    out = [boxes, *rest]
    if squeeze:
        out = [None if t is None else t.unsqueeze(0) for t in out]
    for t in out[1:]:
        if t is not None and t.shape != out[0].shape[:2]:
            raise ValueError(
                f"expected shape {tuple(out[0].shape[:2])} beside boxes "
                f"{tuple(out[0].shape)}, got {tuple(t.shape)}"
            )
    return squeeze, out


# ---------------------------------------------------------------------------
# suppression sweep
# ---------------------------------------------------------------------------

def nms_sweep_plain(
    boxes: torch.Tensor,
    iou_thresh: float,
    valid: torch.Tensor | None = None,
    classes: torch.Tensor | None = None,
) -> torch.Tensor:
    """Plain version of `nms_sweep`: the greedy rule ``keep[j] &= not
    (keep[i] and j > i and iou(i, j) > thresh)`` walked over i, each IoU
    row computed on the fly (no [K, K] matrix). Area is not clamped, as in
    the kernel it stands beside."""
    squeeze, (b, v, c) = _batched(boxes, valid, classes)
    b = b.to(torch.float32)
    k = b.shape[1]
    y1, x1, y2, x2 = b.unbind(-1)
    area = (y2 - y1) * (x2 - x1)
    keep = (torch.ones(b.shape[:2], dtype=torch.bool, device=b.device)
            if v is None else v.to(torch.bool).clone())
    idx = torch.arange(k, device=b.device)
    for i in range(k):
        s = slice(i, i + 1)
        ih = torch.clamp_min(
            torch.minimum(y2, y2[:, s]) - torch.maximum(y1, y1[:, s]), 0.0)
        iw = torch.clamp_min(
            torch.minimum(x2, x2[:, s]) - torch.maximum(x1, x1[:, s]), 0.0)
        inter = ih * iw
        iou = inter / (area + area[:, s] - inter + 1e-8)
        sup = (iou > iou_thresh) & (idx > i) & keep[:, s]
        if c is not None:
            sup = sup & (c == c[:, s])
        keep = keep & ~sup
    return keep[0] if squeeze else keep


def nms_sweep(
    boxes: torch.Tensor,
    iou_thresh: float,
    valid: torch.Tensor | None = None,
    classes: torch.Tensor | None = None,
) -> torch.Tensor:
    """Keep mask (bool ``[B, K]``) for score-descending corner boxes
    ``[B, K, 4]``.

    ``classes`` (int ``[B, K]``): when given, suppression only acts between
    same-class candidates. ``valid`` (bool ``[B, K]``): padding that neither
    survives nor suppresses. On a CUDA tensor this launches the CUDA
    kernel; on a CPU tensor it runs `nms_sweep_plain`.
    """
    if not boxes.is_cuda:
        return nms_sweep_plain(boxes, iou_thresh, valid, classes)
    _same_device(boxes, valid=valid, classes=classes)
    squeeze, (b, v, c) = _batched(boxes, valid, classes)
    batch, k = b.shape[:2]
    if k * _SWEEP_BYTES_PER_BOX > _MAX_SMEM:
        raise ValueError(
            f"nms_sweep holds all K candidates in one block's shared "
            f"memory: K={k} needs {k * _SWEEP_BYTES_PER_BOX} bytes, the "
            f"limit is {_MAX_SMEM}"
        )
    keep = torch.empty((batch, k), dtype=torch.bool, device=b.device)
    if batch == 0 or k == 0:
        return keep[0] if squeeze else keep
    b = b.to(torch.float32).contiguous()
    c = None if c is None else c.to(torch.int32).contiguous()
    v = None if v is None else v.to(torch.bool).contiguous()
    if b.data_ptr() % 16:
        raise ValueError("boxes storage must be 16-byte aligned")
    lib = load_kernels()
    with torch.cuda.device(b.device):
        code = lib.detectax_nms_sweep(
            b.data_ptr(),
            None if c is None else c.data_ptr(),
            None if v is None else v.data_ptr(),
            keep.data_ptr(), batch, k, float(iou_thresh),
            _block_threads(k),
            torch.cuda.current_stream().cuda_stream,
        )
    _common.check_launch(code, "nms_sweep")
    _common.count_launch("nms_sweep")
    return keep[0] if squeeze else keep


# ---------------------------------------------------------------------------
# fused dense NMS
# ---------------------------------------------------------------------------

def _detections(boxes, scores, classes, valid, squeeze):
    out = {
        "boxes": boxes, "scores": scores, "classes": classes,
        "valid": valid, "num_valid": valid.sum(dim=-1, dtype=torch.int32),
    }
    return {k: v[0] for k, v in out.items()} if squeeze else out


def dense_nms_plain(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    classes: torch.Tensor | None = None,
    *,
    iou_thresh: float = 0.5,
    score_thresh: float = 0.0,
    max_outputs: int = 100,
    class_aware: bool = True,
) -> dict:
    """Plain version of `dense_nms`: ``max_outputs`` rounds of (argmax of
    the live scores with the lowest index winning ties, emit, kill the pick
    and all it overlaps). O(max_outputs * M), no [M, M] matrix, area not
    clamped."""
    squeeze, (b, s, c) = _batched(boxes, scores, classes)
    b = b.to(torch.float32)
    s = s.to(torch.float32)
    batch, m = s.shape
    dev = b.device
    y1, x1, y2, x2 = b.unbind(-1)
    area = (y2 - y1) * (x2 - x1)
    live = torch.where(s >= score_thresh, s, -_BIG)
    cls = (torch.zeros((batch, m), dtype=torch.int32, device=dev)
           if c is None else c.to(torch.int32))
    by_class = class_aware and c is not None
    idx = torch.arange(m, device=dev)
    rows = torch.arange(batch, device=dev)

    ob = torch.zeros((batch, max_outputs, 4), dtype=torch.float32, device=dev)
    os_ = torch.zeros((batch, max_outputs), dtype=torch.float32, device=dev)
    oc = torch.full((batch, max_outputs), -1, dtype=torch.int32, device=dev)
    ov = torch.zeros((batch, max_outputs), dtype=torch.bool, device=dev)
    for t in range(max_outputs if m else 0):
        smax = live.max(dim=1).values
        picked = smax > -_BIG * 0.5
        sel = torch.where(live >= smax[:, None], idx, m).min(dim=1).values
        bb = b[rows, sel]  # [B, 4]
        ih = torch.clamp_min(
            torch.minimum(y2, bb[:, 2:3]) - torch.maximum(y1, bb[:, 0:1]),
            0.0)
        iw = torch.clamp_min(
            torch.minimum(x2, bb[:, 3:4]) - torch.maximum(x1, bb[:, 1:2]),
            0.0)
        inter = ih * iw
        iou = inter / (area + area[rows, sel][:, None] - inter + 1e-8)
        sup = iou > iou_thresh
        csel = cls[rows, sel]
        if by_class:
            sup = sup & (cls == csel[:, None])
        dead = (sup & picked[:, None]) | (idx == sel[:, None])
        live = torch.where(dead, -_BIG, live)
        ob[:, t] = torch.where(picked[:, None], bb, 0.0)
        os_[:, t] = torch.where(picked, smax, 0.0)
        oc[:, t] = torch.where(picked, csel, -1)
        ov[:, t] = picked
    return _detections(ob, os_, oc, ov, squeeze)


def dense_nms(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    classes: torch.Tensor | None = None,
    *,
    iou_thresh: float = 0.5,
    score_thresh: float = 0.0,
    max_outputs: int = 100,
    class_aware: bool = True,
) -> dict:
    """Fused selection + suppression greedy NMS over dense candidates.

    Args:
      boxes: ``[B, M, 4]`` corner boxes (unsorted — the kernel selects).
      scores: ``[B, M]``; candidates below ``score_thresh`` never surface.
      classes: optional int ``[B, M]``, reported for survivors; when
        ``class_aware`` is also True, suppression only acts within a class.

    Returns the detection dict of `detectax_torch.ops.nms.nms`
    (boxes/scores/classes/valid ``[B, max_outputs]`` + num_valid),
    survivors in pick (score) order. On a CUDA tensor this launches the
    CUDA kernel; on a CPU tensor it runs `dense_nms_plain`.
    """
    kw = dict(iou_thresh=iou_thresh, score_thresh=score_thresh,
              max_outputs=max_outputs, class_aware=class_aware)
    if not boxes.is_cuda:
        return dense_nms_plain(boxes, scores, classes, **kw)
    _same_device(boxes, scores=scores, classes=classes)
    squeeze, (b, s, c) = _batched(boxes, scores, classes)
    batch, m = s.shape
    if m * 4 + _DENSE_STATIC_SMEM > _MAX_SMEM:
        raise ValueError(
            f"dense_nms holds the live scores of all M candidates in one "
            f"block's shared memory: M={m} needs {m * 4} bytes, the limit "
            f"is {_MAX_SMEM - _DENSE_STATIC_SMEM}"
        )
    dev = b.device
    if batch == 0 or max_outputs == 0 or m == 0:
        # nothing to launch: every output column is empty
        return _detections(
            torch.zeros((batch, max_outputs, 4), device=dev),
            torch.zeros((batch, max_outputs), device=dev),
            torch.full((batch, max_outputs), -1, dtype=torch.int32,
                       device=dev),
            torch.zeros((batch, max_outputs), dtype=torch.bool, device=dev),
            squeeze,
        )
    ob = torch.empty((batch, max_outputs, 4), dtype=torch.float32, device=dev)
    os_ = torch.empty((batch, max_outputs), dtype=torch.float32, device=dev)
    oc = torch.empty((batch, max_outputs), dtype=torch.int32, device=dev)
    ov = torch.empty((batch, max_outputs), dtype=torch.bool, device=dev)
    b = b.to(torch.float32).contiguous()
    s = s.to(torch.float32).contiguous()
    c = None if c is None else c.to(torch.int32).contiguous()
    if b.data_ptr() % 16 or ob.data_ptr() % 16:
        raise ValueError("boxes storage must be 16-byte aligned")
    lib = load_kernels()
    with torch.cuda.device(dev):
        code = lib.detectax_dense_nms(
            b.data_ptr(), s.data_ptr(),
            None if c is None else c.data_ptr(),
            ob.data_ptr(), os_.data_ptr(), oc.data_ptr(), ov.data_ptr(),
            batch, m, int(max_outputs), float(iou_thresh),
            float(score_thresh), int(bool(class_aware)),
            _block_threads(m),
            torch.cuda.current_stream().cuda_stream,
        )
    _common.check_launch(code, "dense_nms")
    _common.count_launch("dense_nms")
    return _detections(ob, os_, oc, ov, squeeze)
