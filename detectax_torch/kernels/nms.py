"""The two NMS kernels of the serving path: wrappers and plain versions.

* `nms_sweep` — greedy suppression over K score-sorted boxes. Replaces the
  TPU kernel ``detectax/ops/pallas/nms_kernel.py::suppression_mask_pallas``
  (`_nms_kernel`). CUDA source: ``csrc/nms_sweep.cu``: a bitmask of the
  pairwise suppressions built by tiles over the whole card, then a sweep
  over it, one warp an image, whose chain is K steps in registers.
* `dense_nms` — fused selection + suppression over the full dense set.
  Replaces ``detectax/ops/pallas/nms_kernel.py::dense_nms_pallas``
  (`_dense_nms_kernel`). CUDA source: ``csrc/dense_nms.cu``: one
  thread-block cluster an image, its candidates split over the cluster's
  blocks and held on chip; a round pushes every warp's best to every
  block through distributed shared memory, with no cluster barrier.

Both are bound by a chain of dependent steps, not by the card's byte or
arithmetic rates: an image's candidates are tens of KB. The sources say
what each design does to shorten the chain; `PERF.md` and
``kernels/probe.py`` give the cost of an empty step.

Beside each wrapper stands its plain PyTorch version (`nms_sweep_plain`,
`dense_nms_plain`), the same arithmetic in the same order, vectorised over
the batch; `suppression_bits_plain` and `sweep_bits_plain` are the plain
model of the sweep's two launches. A wrapper checks and batches its
arguments and calls its operator (``detectax_torch::nms_sweep``,
``detectax_torch::dense_nms``: `kernels.ops`, where the launches live),
which takes the plain version only for a tensor on the CPU; for a CUDA
tensor it launches the kernel or raises. `_sweep_plan` and `_dense_plan`
are the launch shapes, pure
functions of K and M, each in tiers with no upper bound of its own:

* `nms_sweep` up to K = 14,464 runs the ring sweep (two or more 64-row
  tiles of the mask in shared memory, the removed set in a warp's
  registers); above, the wide sweep (one block an image, the removed set
  in shared memory, the mask read from device memory). The scratch mask is
  K^2 / 8 bytes an image, and only its allocation limits K.
* `dense_nms` up to M = 65,536 holds an image's candidates in the
  registers of one cluster; up to about 144,000 it stages them in the
  cluster's shared memory (24 bytes a candidate); above, it reads them
  from device memory, with the live scores in [B, M] floats of scratch.

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

# the sweep: 64 x 64 tiles of the bitmask, one 64-row tile a ring stage
_TILE = 64
_SWEEP_MAX_STAGES = 4
_SWEEP_MAX_SLOTS = 8     # removed words a lane holds in registers
_MBAR_BYTES = 8

# dense NMS: a cluster of blocks an image, candidates held in registers
_DENSE_MAX_CLUSTER = 16  # above 8 the card needs the non-portable size
_DENSE_MAX_THREADS = 512
_DENSE_PER = (1, 2, 4, 8)  # candidates a thread holds
# (largest M, blocks a cluster), in order
_DENSE_CLUSTERS = ((12288, 8), (_DENSE_MAX_CLUSTER * _DENSE_MAX_THREADS
                                * _DENSE_PER[-1], _DENSE_MAX_CLUSTER))
# a 32-byte slot per (block, warp) of the cluster for both round
# parities, and their two mbarriers
_DENSE_STATIC_SMEM = (2 * _DENSE_MAX_CLUSTER * (_DENSE_MAX_THREADS // 32)
                      * 32 + 2 * _MBAR_BYTES)
# above the register tier: a candidate staged in shared memory is its box,
# live score and class
_DENSE_STAGED_BYTES = 24
# the wide sweep: the removed set of W words in shared memory beside the
# diagonal words of a tile and the kept word
_SWEEP_WIDE_THREADS = 256
_SWEEP_WIDE_STATIC_SMEM = _TILE * 8 + 8


@functools.cache
def load_kernels() -> ctypes.CDLL:
    """The built library with this module's argument types declared."""
    lib = _common.load_library()
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.detectax_nms_mask.argtypes = [p, p, p, i, i, f, p]
    lib.detectax_nms_mask.restype = i
    lib.detectax_nms_sweep.argtypes = [p, p, p, p, p, i, i, f, i, p]
    lib.detectax_nms_sweep.restype = i
    lib.detectax_dense_nms.argtypes = [p, p, p, p, p, p, p,
                                       i, i, i, f, f, i, i, i, i, p]
    lib.detectax_dense_nms.restype = i
    lib.detectax_dense_nms_mem.argtypes = [p, p, p, p, p, p, p, p,
                                           i, i, i, f, f, i, i, i, i, p]
    lib.detectax_dense_nms_mem.restype = i
    return lib


def _words(k: int) -> int:
    return -(-k // _TILE)


def _sweep_plan(k: int) -> dict:
    """Launch shape of `nms_sweep` for K boxes an image: the mask's grid
    (``tiles`` of 64 x 64 an image, 128 threads each), then the sweep.

    ``tier="ring"`` (K <= 14,464): one warp an image, a ring of ``stages``
    row tiles of ``tile_bytes`` in shared memory, the removed set in
    ``slots`` registers a lane. ``tier="wide"`` (above): one block of 256
    threads an image, the removed set of ``words`` words in shared memory
    and the mask read from device memory. Raises for K < 1 only: the wide
    tier's shared memory holds the removed set up to K = 1,855,360, whose
    scratch of K^2 / 8 bytes (430 GB) no card holds."""
    if k < 1:
        raise ValueError(f"nms_sweep needs K >= 1 boxes an image, got {k}")
    words = _words(k)
    tile_bytes = _TILE * words * 8
    stages = min(words, _SWEEP_MAX_STAGES,
                 _MAX_SMEM // (tile_bytes + _MBAR_BYTES))
    slots = -(-words // 32)
    plan = {
        "words": words, "tiles": words * (words + 1) // 2,
        "mask_threads": 2 * _TILE,
        "mask_bytes": _TILE * words * words * 8,  # an image's scratch
    }
    if stages >= min(words, 2) and slots <= _SWEEP_MAX_SLOTS:
        plan.update(tier="ring", slots=slots, sweep_threads=32,
                    stages=stages, tile_bytes=tile_bytes,
                    smem_bytes=stages * (tile_bytes + _MBAR_BYTES))
        return plan
    smem = words * 8
    if smem + _SWEEP_WIDE_STATIC_SMEM > _MAX_SMEM:
        raise ValueError(
            f"nms_sweep keeps the removed set of ceil(K/64) words in one "
            f"block's shared memory: K={k} needs {smem} bytes beside "
            f"{plan['mask_bytes']} bytes of scratch an image")
    plan.update(tier="wide", sweep_threads=_SWEEP_WIDE_THREADS, stages=0,
                smem_bytes=smem)
    return plan


def _dense_plan(m: int) -> dict:
    """Launch shape of `dense_nms` for M candidates an image: ``cluster``
    blocks of ``threads`` threads, each block over a contiguous ``slice``
    of ceil(M / cluster) candidates, each thread over ``per`` of them.

    ``tier="registers"`` (M <= 65,536): a thread holds its candidates in
    registers, ``per`` in {1, 2, 4, 8}. ``tier="shared"``: 16 blocks of 512
    threads stage their slices in ``smem_bytes`` of shared memory (24 bytes
    a candidate, up to about 144,000 an image). ``tier="device"`` (above):
    the same blocks read their slices from device memory, the live scores
    in scratch. Raises for M < 1 only."""
    if m < 1:
        raise ValueError(f"dense_nms needs M >= 1 candidates an image, "
                         f"got {m}")
    cluster = next((c for top, c in _DENSE_CLUSTERS if m <= top), None)
    if cluster is not None:
        slice_ = -(-m // cluster)
        for per in _DENSE_PER:
            threads = max(32, _common.round_up(-(-slice_ // per), 32))
            if threads <= _DENSE_MAX_THREADS:
                break
        return {"tier": "registers", "cluster": cluster, "slice": slice_,
                "per": per, "threads": threads,
                "smem_bytes": _DENSE_STATIC_SMEM}
    slice_ = -(-m // _DENSE_MAX_CLUSTER)
    staged = _DENSE_STATIC_SMEM + _DENSE_STAGED_BYTES * slice_
    shared = staged <= _MAX_SMEM
    return {"tier": "shared" if shared else "device",
            "cluster": _DENSE_MAX_CLUSTER, "slice": slice_,
            "per": -(-slice_ // _DENSE_MAX_THREADS),
            "threads": _DENSE_MAX_THREADS,
            "smem_bytes": staged if shared else _DENSE_STATIC_SMEM}


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


def suppression_bits_plain(
    boxes: torch.Tensor,
    iou_thresh: float,
    classes: torch.Tensor | None = None,
) -> torch.Tensor:
    """Plain model of `nms_sweep`'s first launch: the suppression bitmask,
    int64 ``[B, K, W]`` (W = ceil(K / 64), words as bit patterns). Bit b of
    word w in row i is set iff j = 64 w + b > i, the classes match (when
    given) and IoU(i, j) > thresh, the IoU computed in `nms_sweep_plain`'s
    order. Forms the [B, K, K] matrix: for tests and checks only."""
    squeeze, (b, c) = _batched(boxes, classes)
    b = b.to(torch.float32)
    batch, k = b.shape[:2]
    words = _words(k)
    y1, x1, y2, x2 = (t.unsqueeze(1) for t in b.unbind(-1))  # j on the last
    area = (y2 - y1) * (x2 - x1)
    col = lambda t: t.transpose(1, 2)                        # i on the middle
    ih = torch.clamp_min(
        torch.minimum(y2, col(y2)) - torch.maximum(y1, col(y1)), 0.0)
    iw = torch.clamp_min(
        torch.minimum(x2, col(x2)) - torch.maximum(x1, col(x1)), 0.0)
    inter = ih * iw
    iou = inter / (area + col(area) - inter + 1e-8)
    idx = torch.arange(k, device=b.device)
    hit = (iou > iou_thresh) & (idx > idx[:, None])
    if c is not None:
        hit = hit & (c[:, None, :] == c[:, :, None])
    padded = torch.zeros((batch, k, words * _TILE), dtype=torch.int64,
                         device=b.device)
    padded[..., :k] = hit.to(torch.int64)
    shifts = torch.arange(_TILE, dtype=torch.int64, device=b.device)
    # distinct bits: the sum is their OR, bit 63 included
    bits = (padded.view(batch, k, words, _TILE) << shifts).sum(-1)
    return bits[0] if squeeze else bits


def sweep_bits_plain(
    bits: torch.Tensor, valid: torch.Tensor | None = None
) -> torch.Tensor:
    """Plain model of `nms_sweep`'s second launch: walk the rows of the
    bitmask of `suppression_bits_plain` in order; row i is kept iff it is
    valid and its bit is clear in the removed set, which then takes its
    row. Keep mask bool ``[B, K]``."""
    squeeze = bits.ndim == 2
    if squeeze:
        bits = bits.unsqueeze(0)
        valid = None if valid is None else valid.unsqueeze(0)
    batch, k, words = bits.shape
    keep = (torch.ones((batch, k), dtype=torch.bool, device=bits.device)
            if valid is None else valid.to(torch.bool).clone())
    removed = torch.zeros((batch, words), dtype=torch.int64,
                          device=bits.device)
    for i in range(k):
        w, b = divmod(i, _TILE)
        kept = keep[:, i] & (((removed[:, w] >> b) & 1) == 0)
        keep[:, i] = kept
        removed = torch.where(kept[:, None], removed | bits[:, i], removed)
    return keep[0] if squeeze else keep


def suppression_bits(
    boxes: torch.Tensor,
    iou_thresh: float,
    classes: torch.Tensor | None = None,
) -> torch.Tensor:
    """The bitmask of `suppression_bits_plain` from `nms_sweep`'s mask
    kernel alone (words below the diagonal tiles zero), so that it can be
    held against the plain model word for word. On a CPU tensor it runs
    `suppression_bits_plain`. Not on any serving path."""
    if not boxes.is_cuda:
        return suppression_bits_plain(boxes, iou_thresh, classes)
    _same_device(boxes, classes=classes)
    squeeze, (b, c) = _batched(boxes, classes)
    batch, k = b.shape[:2]
    plan = _sweep_plan(k)
    words = plan["words"]
    mask = torch.zeros((batch, _TILE * words, words), dtype=torch.int64,
                       device=b.device)
    b = b.to(torch.float32).contiguous()
    c = None if c is None else c.to(torch.int32).contiguous()
    if batch:
        with torch.cuda.device(b.device):
            code = load_kernels().detectax_nms_mask(
                b.data_ptr(), None if c is None else c.data_ptr(),
                mask.data_ptr(), batch, k, float(iou_thresh),
                torch.cuda.current_stream().cuda_stream,
            )
        _common.check_launch(code, "nms_mask")
        _common.count_launch("nms_mask")
    bits = mask[:, :k]
    return bits[0] if squeeze else bits


def nms_sweep(
    boxes: torch.Tensor,
    iou_thresh: float,
    valid: torch.Tensor | None = None,
    classes: torch.Tensor | None = None,
) -> torch.Tensor:
    """Keep mask (bool ``[B, K]``) for score-descending corner boxes
    ``[B, K, 4]``, any K (`_sweep_plan`'s tiers).

    ``classes`` (int ``[B, K]``): when given, suppression only acts between
    same-class candidates. ``valid`` (bool ``[B, K]``): padding that neither
    survives nor suppresses. On a CUDA tensor this launches the mask and
    sweep kernels (one entry point, ``B * 64 W * W`` words of scratch); on
    a CPU tensor it runs `nms_sweep_plain`.
    """
    _same_device(boxes, valid=valid, classes=classes)
    squeeze, (b, v, c) = _batched(boxes, valid, classes)
    keep = torch.ops.detectax_torch.nms_sweep(b, float(iou_thresh), v, c)
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
    CUDA kernel, one cluster of blocks an image as `_dense_plan` sizes it
    (any M: the candidates in registers, shared memory or device memory);
    on a CPU tensor it runs `dense_nms_plain`.
    """
    _same_device(boxes, scores=scores, classes=classes)
    squeeze, (b, s, c) = _batched(boxes, scores, classes)
    out = torch.ops.detectax_torch.dense_nms(
        b, s, c, float(iou_thresh), float(score_thresh), int(max_outputs),
        bool(class_aware))
    return _detections(*out, squeeze)
