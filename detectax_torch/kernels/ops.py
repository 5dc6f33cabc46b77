"""The kernels as PyTorch custom operators.

``detectax_torch::dense_nms``, ``detectax_torch::nms_sweep`` and
``detectax_torch::peak`` wrap the three kernels of the serving graph, and
``detectax_torch::focal_group`` with ``detectax_torch::focal_group_bwd``
(its registered autograd) the focal kernel of the training step, so that
tracing (``torch.export``) and CUDA-graph capture can pass through them: a
``ctypes`` call on ``data_ptr()`` cannot be traced, an operator with a
fake implementation can. Each operator has

* a CUDA implementation: the kernel's launch (the plan, the 16-byte
  alignment checks, `_common.check_launch` and `_common.count_launch`), so
  that a replayed exported program counts its launches as the live path
  does;
* a CPU implementation: the kernel's plain version;
* a fake implementation giving the output shapes, all static.

On any other device an operator has no implementation and raises. The
public wrappers (`kernels.nms.dense_nms`, `kernels.nms.nms_sweep`,
`kernels.peak.peak_scores`, `kernels.peak.peak_mask_scores`) keep their
signatures: they check and batch their arguments, call the operator and
build their result around its tuple (an operator returns no dict). So do
`kernels.focal.focal_loss_group` and `focal_loss`, which take the plain
version with autograd, not the operator, for CPU logits that need a
gradient.

Importing this module registers the operators; `detectax_torch.kernels`
imports it, so any kernel module does. `torch.export.load` needs the
namespace registered before it reads a program that calls one.
"""
from __future__ import annotations

from typing import Optional

import torch

from detectax_torch.kernels import _common
from detectax_torch.kernels import focal as _focal
from detectax_torch.kernels import nms as _nms
from detectax_torch.kernels import peak as _peak

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# dense_nms: fused selection + suppression, [B, M] candidates an image
# ---------------------------------------------------------------------------

@torch.library.custom_op("detectax_torch::dense_nms", mutates_args=(),
                         device_types="cpu")
def dense_nms(boxes: Tensor, scores: Tensor, classes: Optional[Tensor],
              iou_thresh: float, score_thresh: float, max_outputs: int,
              class_aware: bool) -> tuple[Tensor, Tensor, Tensor, Tensor]:
    """Boxes ``[B, M, 4]``, scores ``[B, M]``, classes int ``[B, M]`` or
    None -> (boxes f32 ``[B, max_outputs, 4]``, scores f32, classes int32,
    valid bool ``[B, max_outputs]``). The CPU implementation is
    `kernels.nms.dense_nms_plain`."""
    out = _nms.dense_nms_plain(
        boxes, scores, classes, iou_thresh=iou_thresh,
        score_thresh=score_thresh, max_outputs=max_outputs,
        class_aware=class_aware)
    return out["boxes"], out["scores"], out["classes"], out["valid"]


@dense_nms.register_kernel("cuda")
def _dense_nms_cuda(boxes, scores, classes, iou_thresh, score_thresh,
                    max_outputs, class_aware):
    batch, m = scores.shape
    dev = boxes.device
    if batch == 0 or max_outputs == 0 or m == 0:
        # nothing to launch: every output column is empty
        return (torch.zeros((batch, max_outputs, 4), device=dev),
                torch.zeros((batch, max_outputs), device=dev),
                torch.full((batch, max_outputs), -1, dtype=torch.int32,
                           device=dev),
                torch.zeros((batch, max_outputs), dtype=torch.bool,
                            device=dev))
    plan = _nms._dense_plan(m)
    ob = torch.empty((batch, max_outputs, 4), dtype=torch.float32, device=dev)
    os_ = torch.empty((batch, max_outputs), dtype=torch.float32, device=dev)
    oc = torch.empty((batch, max_outputs), dtype=torch.int32, device=dev)
    ov = torch.empty((batch, max_outputs), dtype=torch.bool, device=dev)
    b = boxes.to(torch.float32).contiguous()
    s = scores.to(torch.float32).contiguous()
    c = None if classes is None else classes.to(torch.int32).contiguous()
    if b.data_ptr() % 16 or ob.data_ptr() % 16:
        raise ValueError("boxes storage must be 16-byte aligned")
    lib = _nms.load_kernels()
    common = (b.data_ptr(), s.data_ptr(), None if c is None else c.data_ptr())
    outs = (ob.data_ptr(), os_.data_ptr(), oc.data_ptr(), ov.data_ptr(),
            batch, m, int(max_outputs), float(iou_thresh),
            float(score_thresh), int(bool(class_aware)),
            plan["cluster"], plan["threads"])
    live = (torch.empty((batch, m), dtype=torch.float32, device=dev)
            if plan["tier"] == "device" else None)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        if plan["tier"] == "registers":
            code = lib.detectax_dense_nms(*common, *outs, plan["per"], stream)
        else:
            code = lib.detectax_dense_nms_mem(
                *common, None if live is None else live.data_ptr(), *outs,
                int(plan["tier"] == "shared"), stream)
    _common.check_launch(code, "dense_nms")
    _common.count_launch("dense_nms")
    return ob, os_, oc, ov


@dense_nms.register_fake
def _dense_nms_fake(boxes, scores, classes, iou_thresh, score_thresh,
                    max_outputs, class_aware):
    batch = boxes.shape[0]
    return (boxes.new_empty((batch, max_outputs, 4), dtype=torch.float32),
            boxes.new_empty((batch, max_outputs), dtype=torch.float32),
            boxes.new_empty((batch, max_outputs), dtype=torch.int32),
            boxes.new_empty((batch, max_outputs), dtype=torch.bool))


# ---------------------------------------------------------------------------
# nms_sweep: greedy suppression over [B, K] score-sorted boxes
# ---------------------------------------------------------------------------

@torch.library.custom_op("detectax_torch::nms_sweep", mutates_args=(),
                         device_types="cpu")
def nms_sweep(boxes: Tensor, iou_thresh: float, valid: Optional[Tensor],
              classes: Optional[Tensor]) -> Tensor:
    """Boxes ``[B, K, 4]``, valid bool ``[B, K]`` or None, classes int
    ``[B, K]`` or None -> keep mask bool ``[B, K]``. The CPU
    implementation is `kernels.nms.nms_sweep_plain`."""
    return _nms.nms_sweep_plain(boxes, iou_thresh, valid, classes)


@nms_sweep.register_kernel("cuda")
def _nms_sweep_cuda(boxes, iou_thresh, valid, classes):
    batch, k = boxes.shape[:2]
    keep = torch.empty((batch, k), dtype=torch.bool, device=boxes.device)
    if batch == 0 or k == 0:
        return keep
    b = boxes.to(torch.float32).contiguous()
    c = None if classes is None else classes.to(torch.int32).contiguous()
    v = None if valid is None else valid.to(torch.bool).contiguous()
    if b.data_ptr() % 16:
        raise ValueError("boxes storage must be 16-byte aligned")
    words = _nms._words(k)
    # the scratch first: past what a card holds, its allocation raises
    mask = torch.empty((batch, _nms._TILE * words, words), dtype=torch.int64,
                       device=b.device)
    plan = _nms._sweep_plan(k)
    lib = _nms.load_kernels()
    with torch.cuda.device(b.device):
        code = lib.detectax_nms_sweep(
            b.data_ptr(),
            None if c is None else c.data_ptr(),
            None if v is None else v.data_ptr(),
            mask.data_ptr(), keep.data_ptr(), batch, k, float(iou_thresh),
            plan["stages"], torch.cuda.current_stream().cuda_stream,
        )
    _common.check_launch(code, "nms_sweep")
    _common.count_launch("nms_sweep")
    return keep


@nms_sweep.register_fake
def _nms_sweep_fake(boxes, iou_thresh, valid, classes):
    return boxes.new_empty(boxes.shape[:2], dtype=torch.bool)


# ---------------------------------------------------------------------------
# peak: optional sigmoid + 3x3 local-peak mask
# ---------------------------------------------------------------------------

@torch.library.custom_op("detectax_torch::peak", mutates_args=(),
                         device_types="cpu")
def peak(x: Tensor, apply_sigmoid: bool) -> Tensor:
    """A ``[B, h, w, C]`` map (or ``[H, W, P]`` planes) -> the float32
    map of the same shape masked to its 3x3 local peaks, the sigmoid
    applied first when ``apply_sigmoid``. The CPU implementation is
    `kernels.peak.peak_scores_plain` / `peak_mask_scores_plain`."""
    if apply_sigmoid:
        return _peak.peak_scores_plain(x)
    return _peak.peak_mask_scores_plain(x)


@peak.register_kernel("cuda")
def _peak_cuda(x, apply_sigmoid):
    shape = tuple(x.shape)
    batch, (h, w, c) = (1 if x.ndim == 3 else shape[0]), shape[-3:]
    t, _, _, stride = _common.as_rows(x.detach().to(torch.float32))
    out = torch.empty(shape, dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    plan = _peak._peak_plan(h, w, c, batch)
    lib = _peak.load_kernels()
    with torch.cuda.device(x.device):
        code = lib.detectax_peak(
            t.data_ptr(), stride, batch, h, w, c, plan["rows"],
            plan["col_tile"], plan["chan_tile"], int(apply_sigmoid),
            out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    _common.check_launch(code, "peak")
    _common.count_launch("peak")
    return out


@peak.register_fake
def _peak_fake(x, apply_sigmoid):
    return x.new_empty(x.shape, dtype=torch.float32)


# ---------------------------------------------------------------------------
# focal_group: sum-reduced sigmoid focal loss of up to 32 segments
# ---------------------------------------------------------------------------

@torch.library.custom_op("detectax_torch::focal_group", mutates_args=(),
                         device_types="cpu")
def focal_group(labels: list[Tensor], logits: list[Tensor],
                weights: list[Optional[Tensor]], alpha: float,
                gamma: float) -> Tensor:
    """Segments ``(labels[i], logits[i], weights[i])`` (any shapes; each
    weight None or broadcastable to its logits) -> their ``[S]`` float32
    focal sums. The segments are read where they lie (strided views
    included). The CPU implementation is
    `kernels.focal.focal_loss_group_plain`."""
    return _focal.focal_loss_group_plain(
        list(zip(labels, logits, weights)), alpha=alpha, gamma=gamma)


@focal_group.register_kernel("cuda")
def _focal_group_cuda(labels, logits, weights, alpha, gamma):
    return _focal.launch_fwd(labels, logits, weights, alpha, gamma)


@focal_group.register_fake
def _focal_group_fake(labels, logits, weights, alpha, gamma):
    return logits[0].new_empty((len(logits),), dtype=torch.float32)


@torch.library.custom_op("detectax_torch::focal_group_bwd", mutates_args=(),
                         device_types="cpu")
def focal_group_bwd(labels: list[Tensor], logits: list[Tensor],
                    weights: list[Optional[Tensor]], grad_out: Tensor,
                    alpha: float, gamma: float) -> list[Tensor]:
    """dL/dlogits of each segment times ``grad_out[i]``, contiguous, in its
    logits' shape and dtype. The CPU implementation is
    `kernels.focal.focal_grad_group_plain` (the closed form)."""
    return _focal.focal_grad_group_plain(labels, logits, weights, grad_out,
                                         alpha, gamma)


@focal_group_bwd.register_kernel("cuda")
def _focal_group_bwd_cuda(labels, logits, weights, grad_out, alpha, gamma):
    return _focal.launch_bwd(labels, logits, weights, grad_out, alpha, gamma)


@focal_group_bwd.register_fake
def _focal_group_bwd_fake(labels, logits, weights, grad_out, alpha, gamma):
    return [x.new_empty(x.shape) for x in logits]


def _focal_setup(ctx, inputs, output):
    labels, logits, weights, alpha, gamma = inputs
    n = len(logits)
    ctx.save_for_backward(*labels, *logits, *weights)
    ctx.n, ctx.alpha, ctx.gamma = n, alpha, gamma
    # a list holding a None is one leaf of the inputs' structure, a list of
    # tensors one leaf a tensor: the backward's answer must have the same
    ctx.weight_leaves = all(w is not None for w in weights)


def _focal_backward(ctx, grad):
    saved, n = ctx.saved_tensors, ctx.n
    labels, logits, weights = saved[:n], saved[n:2 * n], saved[2 * n:]
    dlogits = focal_group_bwd(list(labels), list(logits), list(weights),
                              grad, ctx.alpha, ctx.gamma)
    # labels and weights get no gradient
    return ([None] * n, list(dlogits),
            [None] * n if ctx.weight_leaves else None, None, None)


focal_group.register_autograd(_focal_backward, setup_context=_focal_setup)
