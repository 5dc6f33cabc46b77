"""The focal-loss kernel of the training path: wrappers and plain versions.

`focal_loss_group` — sum-reduced stable sigmoid focal loss of several
segments (label/logit pairs of any shapes) in one forward launch, one sum
a segment, with the closed-form gradient of every segment in one backward
launch. `focal_loss` is its one-segment case. They replace the TPU kernel
``detectax/ops/pallas/focal.py::focal_loss_pallas`` (`_focal_kernel` and
the analytic `_bwd`), which the JAX package calls once per FCOS level.
CUDA source: ``csrc/focal.cu`` (`focal_group_fwd`: one pass over every
segment to one partial sum a block, and the last block to finish adds the
partials; `focal_group_bwd`: one pass that writes every segment's
dL/dlogits).

Bound by bytes (8-12 in and, backward, 4 out an element against a few
dozen float operations), and at the training shapes — a few MB a step —
by the latency of a launch, hence one launch each way for all segments.
The source says what the design does about it. Sums are formed without
atomics on floats, in an order that depends on the segments' sizes alone
(`_focal_plan`), so two runs on the same input give the same bits.

Layout: labels and logits are read where they lie. A tensor whose last
dimension has unit stride and whose leading dimensions collapse onto one
row stride (a contiguous tensor, or the class channels ``y[..., 5:]`` of a
contiguous map) is handed to the kernel as ``[rows, cols]`` with that row
stride; any other layout is made contiguous first. ``weights`` is broadcast
to the logits' shape and made contiguous (one float an element). A segment
whose columns, strides and pointers allow it is read 16 bytes at a time.

Beside the wrappers stand the plain versions: `focal_loss_plain` (the
formula of `detectax_torch.ops.losses.focal_loss`, gradient by autograd),
`focal_loss_group_plain` (it, once a segment) and `focal_grad_plain` (the
closed form in tensor ops). A wrapper takes the plain version only for
tensors on the CPU; for CUDA tensors it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Sequence

import torch

from detectax_torch.kernels import _common
from detectax_torch.ops.losses import _stable_bce_terms
from detectax_torch.ops.losses import focal_loss as focal_loss_plain

THREADS = 256        # threads a block (csrc/focal.cu kThreads)
MAX_SEGMENTS = 32    # segments a launch (csrc/focal.cu kMaxSegments)
BLOCKS_PER_SM = 2    # the grid's size in blocks is about SMS x this


@functools.cache
def load_kernels() -> ctypes.CDLL:
    """The built library with this module's argument types declared."""
    lib = _common.load_library()
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.detectax_focal_group_fwd.argtypes = [i, p, p, f, f, p, p, p, p]
    lib.detectax_focal_group_fwd.restype = i
    lib.detectax_focal_group_bwd.argtypes = [i, p, p, f, f, p, p]
    lib.detectax_focal_group_bwd.restype = i
    return lib


def focal_grad_plain(
    labels: torch.Tensor,
    logits: torch.Tensor,
    *,
    weights: torch.Tensor | None = None,
    alpha: float = 0.25,
    gamma: float = 2.0,
) -> torch.Tensor:
    """Plain version of the backward kernel: d(sum focal loss)/d(logits)
    in closed form.

    For z=1: L = α (1-p)^γ ce_pos, dL/dx = -α (1-p)^γ (γ p ce_pos + (1-p)).
    For z=0: L = (1-α) p^γ ce_neg, dL/dx = (1-α) p^γ (γ (1-p) ce_neg + p).
    (ce_pos = -log p, ce_neg = -log(1-p), dp/dx = p(1-p).)
    """
    z = labels.to(torch.float32)
    x = logits.to(torch.float32)
    ce_pos, ce_neg = _stable_bce_terms(x)
    p = torch.sigmoid(x)
    dpos = -alpha * torch.pow(1.0 - p, gamma) * (
        gamma * p * ce_pos + (1.0 - p))
    dneg = (1.0 - alpha) * torch.pow(p, gamma) * (
        gamma * (1.0 - p) * ce_neg + p)
    grad = z * dpos + (1.0 - z) * dneg
    if weights is not None:
        grad = grad * weights.to(torch.float32)
    return grad


def focal_loss_group_plain(
    segments: Sequence[tuple],
    *,
    alpha: float = 0.25,
    gamma: float = 2.0,
) -> torch.Tensor:
    """Plain version of `focal_loss_group`: `focal_loss_plain` once a
    segment, stacked into a ``[S]`` float32 tensor."""
    segs = [_unpack(s) for s in segments]
    if not segs:
        raise ValueError("focal_loss_group needs at least one segment")
    return torch.stack([
        focal_loss_plain(z, x, alpha=alpha, gamma=gamma, weights=w)
        for z, x, w in segs])


def _focal_plan(sizes: Sequence[tuple[int, int]]) -> list[tuple[int, int, int]]:
    """(first block, blocks, rows a block) of each segment, from the
    segments' ``(rows, cols)`` alone.

    The grid is about ``_common.SMS * BLOCKS_PER_SM`` blocks, shared among the
    segments by their element counts; a segment gets at least one block if
    it has an element, and no more blocks than it has rows or than it has
    ``THREADS`` elements. Block j of a segment walks rows ``[j * rpb,
    min((j + 1) * rpb, rows))``; its blocks are ``[first, first + blocks)``
    and follow the previous segment's. A segment with no element has no
    block."""
    total = sum(rows * cols for rows, cols in sizes)
    grid = _common.SMS * BLOCKS_PER_SM
    plan, first = [], 0
    for rows, cols in sizes:
        n = rows * cols
        if n == 0:
            plan.append((first, 0, 0))
            continue
        want = -(-grid * n // total)
        blocks = max(1, min(want, rows, -(-n // THREADS)))
        rows_per_block = -(-rows // blocks)
        blocks = -(-rows // rows_per_block)
        plan.append((first, blocks, rows_per_block))
        first += blocks
    return plan


class _Segment(NamedTuple):
    z: torch.Tensor                 # labels as [rows, cols] at z_stride
    z_stride: int
    x: torch.Tensor                 # logits as [rows, cols] at x_stride
    x_stride: int
    w: torch.Tensor | None          # weights, contiguous [rows, cols]
    rows: int
    cols: int


def _unpack(segment) -> tuple:
    if len(segment) == 2:
        return segment[0], segment[1], None
    if len(segment) == 3:
        return tuple(segment)
    raise ValueError("a segment is (labels, logits) or (labels, logits, "
                     f"weights), got {len(segment)} items")


def _prepare(labels, logits, weights) -> _Segment:
    if labels.shape != logits.shape:
        raise ValueError(f"labels {tuple(labels.shape)} and logits "
                         f"{tuple(logits.shape)} differ in shape")
    for name, t in (("labels", labels), ("weights", weights)):
        if t is not None and t.device != logits.device:
            raise ValueError(
                f"{name} lies on {t.device}, logits on {logits.device}")
    z, rows, cols, z_stride = _common.as_rows(labels.to(torch.float32))
    x, _, _, x_stride = _common.as_rows(logits.detach().to(torch.float32))
    w = None
    if weights is not None:
        w = torch.broadcast_to(
            weights.to(torch.float32), logits.shape).contiguous()
    return _Segment(z, z_stride, x, x_stride, w, rows, cols)


def _reads_16_bytes(seg: _Segment, dlogits: torch.Tensor | None) -> bool:
    """Whether every row of the segment starts on 16 bytes in every tensor
    the kernel touches, so that it can move four floats at once."""
    ptrs = [seg.z.data_ptr(), seg.x.data_ptr()]
    ptrs += [t.data_ptr() for t in (seg.w, dlogits) if t is not None]
    return (seg.cols % 4 == 0 and seg.z_stride % 4 == 0
            and seg.x_stride % 4 == 0 and all(p % 16 == 0 for p in ptrs))


def _table(segs: Sequence[_Segment], dlogits=None):
    """The segment table as the C side takes it: 8 int64 and 4 pointers a
    segment (csrc/focal.cu::fill_table), and the grid's block count."""
    plan = _focal_plan([(s.rows, s.cols) for s in segs])
    dlogits = dlogits or [None] * len(segs)
    desc, ptrs = [], []
    for seg, d, (first, blocks, rows_per_block) in zip(segs, dlogits, plan):
        desc += [seg.z_stride, seg.x_stride, seg.rows, seg.cols,
                 int(_reads_16_bytes(seg, d)), first, blocks, rows_per_block]
        ptrs += [seg.z.data_ptr(), seg.x.data_ptr(),
                 None if seg.w is None else seg.w.data_ptr(),
                 None if d is None else d.data_ptr()]
    total = plan[-1][0] + plan[-1][1]
    return ((ctypes.c_int64 * len(desc))(*desc),
            (ctypes.c_void_p * len(ptrs))(*ptrs), total)


# One ticket counter for each (device, stream): the forward's last block
# leaves it at 0, so it is zeroed once, when it is made.
_COUNTERS: dict[tuple[int, int], torch.Tensor] = {}


def _counter(device: torch.device, stream: int) -> torch.Tensor:
    key = (device.index, stream)
    if key not in _COUNTERS:
        _COUNTERS[key] = torch.zeros(1, dtype=torch.int32, device=device)
    return _COUNTERS[key]


class _FocalGroup(torch.autograd.Function):
    """One forward and one backward launch for all segments. Labels and
    weights get no gradient."""

    @staticmethod
    def forward(ctx, alpha, gamma, *flat):
        segs = [_prepare(*flat[i:i + 3]) for i in range(0, len(flat), 3)]
        device = segs[0].x.device
        ctx.save_for_backward(*[t for s in segs for t in (s.z, s.x, s.w)])
        ctx.layout = [(s.z_stride, s.x_stride, s.rows, s.cols) for s in segs]
        ctx.shapes = [(flat[i + 1].shape, flat[i + 1].dtype)
                      for i in range(0, len(flat), 3)]
        ctx.alpha, ctx.gamma = alpha, gamma
        out = torch.empty(len(segs), dtype=torch.float32, device=device)
        desc, ptrs, blocks = _table(segs)
        if blocks == 0:
            return out.zero_()
        lib = load_kernels()
        partials = torch.empty(blocks, dtype=torch.float32, device=device)
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream().cuda_stream
            code = lib.detectax_focal_group_fwd(
                len(segs), desc, ptrs, alpha, gamma, partials.data_ptr(),
                _counter(device, stream).data_ptr(), out.data_ptr(), stream)
        _common.check_launch(code, "focal_fwd")
        _common.count_launch("focal_fwd")
        return out

    @staticmethod
    def backward(ctx, grad_out):
        saved = ctx.saved_tensors
        segs = [_Segment(saved[3 * i], zs, saved[3 * i + 1], xs,
                         saved[3 * i + 2], rows, cols)
                for i, (zs, xs, rows, cols) in enumerate(ctx.layout)]
        device = segs[0].x.device
        dlogits = [torch.empty((s.rows, s.cols), dtype=torch.float32,
                               device=device) for s in segs]
        desc, ptrs, blocks = _table(segs, dlogits)
        if blocks:
            g = grad_out.to(torch.float32).contiguous()
            lib = load_kernels()
            with torch.cuda.device(device):
                code = lib.detectax_focal_group_bwd(
                    len(segs), desc, ptrs, ctx.alpha, ctx.gamma,
                    g.data_ptr(), torch.cuda.current_stream().cuda_stream)
            _common.check_launch(code, "focal_bwd")
            _common.count_launch("focal_bwd")
        grads = [None, None]
        for d, (shape, dtype) in zip(dlogits, ctx.shapes):
            grads += [None, d.reshape(shape).to(dtype), None]
        return tuple(grads)


def focal_loss_group(
    segments: Sequence[tuple],
    *,
    alpha: float = 0.25,
    gamma: float = 2.0,
) -> torch.Tensor:
    """Sum-reduced stable sigmoid focal loss of each segment, as a ``[S]``
    float32 tensor differentiable in every segment's logits.

    A segment is ``(labels, logits)`` or ``(labels, logits, weights)``:
    labels and logits of one shape (any shape; segments may differ),
    ``weights`` broadcastable to it and multiplying each element's loss.
    On CUDA tensors this is ONE forward launch for all segments, and
    `backward` one backward launch (at most ``MAX_SEGMENTS`` segments a
    call); on CPU tensors it runs `focal_loss_group_plain`."""
    segs = [_unpack(s) for s in segments]
    if not segs:
        raise ValueError("focal_loss_group needs at least one segment")
    devices = {x.device for _, x, _ in segs}
    if len(devices) > 1:
        raise ValueError(f"segments lie on several devices: {devices}")
    if not segs[0][1].is_cuda:
        return focal_loss_group_plain(segs, alpha=alpha, gamma=gamma)
    if len(segs) > MAX_SEGMENTS:
        raise ValueError(f"focal_loss_group takes at most {MAX_SEGMENTS} "
                         f"segments a call, got {len(segs)}")
    flat = [t for s in segs for t in s]
    return _FocalGroup.apply(float(alpha), float(gamma), *flat)


def focal_loss(
    labels: torch.Tensor,
    logits: torch.Tensor,
    *,
    weights: torch.Tensor | None = None,
    alpha: float = 0.25,
    gamma: float = 2.0,
) -> torch.Tensor:
    """Sum-reduced stable sigmoid focal loss (float32 scalar),
    differentiable in ``logits``: the one-segment case of
    `focal_loss_group`.

    ``weights``, when given, is broadcastable to ``logits.shape`` and
    multiplies each element's loss. On a CUDA tensor this launches the
    forward kernel, and `backward` the backward kernel; on a CPU tensor it
    runs `focal_loss_plain`.
    """
    if not logits.is_cuda:
        return focal_loss_plain(labels, logits, alpha=alpha, gamma=gamma,
                                weights=weights)
    return _FocalGroup.apply(float(alpha), float(gamma), labels, logits,
                             weights).reshape(())
