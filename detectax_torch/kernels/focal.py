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
atomics on floats, in an order that depends on the segments' (rows, cols)
alone — the grid (`_focal_plan`) and the walk that hands elements to
threads (`_walk_unit`, modelled by `focal_walk_plain`) — so the same values
give the same bits whatever their strides and alignment, run after run.

Layout: labels and logits are read where they lie. A tensor whose last
dimension has unit stride and whose leading dimensions collapse onto one
row stride (a contiguous tensor, or the class channels ``y[..., 5:]`` of a
contiguous map) is handed to the kernel as ``[rows, cols]`` with that row
stride; any other layout is made contiguous first. ``weights`` is broadcast
to the logits' shape and made contiguous (one float an element). A segment
whose columns are a multiple of 4 is walked four floats a thread at a
time, read with 16-byte loads where every pointer and row stride allows,
else with 4-byte loads of the same floats in the same order.

Beside the wrappers stand the plain versions: `focal_loss_plain` (the
formula of `detectax_torch.ops.losses.focal_loss`, gradient by autograd),
`focal_loss_group_plain` (it, once a segment), `focal_grad_plain` (the
closed form in tensor ops) and `focal_grad_group_plain` (it, once a
segment). A wrapper takes the plain version only for tensors on the CPU;
for CUDA tensors it launches the kernel or raises.

The launches (`launch_fwd`, `launch_bwd`) are the CUDA implementations of
the ``torch.library`` operators ``detectax_torch::focal_group`` and
``detectax_torch::focal_group_bwd`` (`kernels/ops.py`), which the wrappers
call, so that tracing (``torch.export``) and CUDA-graph capture pass
through the training step's focal loss.
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


# how csrc/focal.cu walks a segment (kScalar, kQuad16, kQuad4)
_SCALAR, _QUAD16, _QUAD4 = 0, 1, 2


def _walk_unit(cols: int) -> int:
    """Floats a thread takes at a time: 4 when ``cols`` is a multiple of
    4, else 1. A function of ``cols`` alone, so the order of every sum is
    too."""
    return 4 if cols % 4 == 0 else 1


def _walk_mode(seg: _Segment, dlogits: torch.Tensor | None) -> int:
    """The kernel's walk of the segment: one float a unit, or four read by
    one 16-byte load where every row of every tensor the kernel touches
    starts on 16 bytes, else four read by 4-byte loads."""
    if _walk_unit(seg.cols) == 1:
        return _SCALAR
    ptrs = [seg.z.data_ptr(), seg.x.data_ptr()]
    ptrs += [t.data_ptr() for t in (seg.w, dlogits) if t is not None]
    aligned = (seg.z_stride % 4 == 0 and seg.x_stride % 4 == 0
               and all(p % 16 == 0 for p in ptrs))
    return _QUAD16 if aligned else _QUAD4


def focal_walk_plain(rows: int, cols: int, mode: int) -> list[list[int]]:
    """Plain model of the forward kernel's walk of one segment: for each
    (block, thread) of the segment's blocks (`_focal_plan` of it alone),
    the flat indices ``row * cols + col`` of the elements it adds, in the
    order it adds them. ``mode`` is the walk (`_walk_mode`); the two quad
    modes differ in the width of their loads only, so they give the same
    lists. For tests of the order's independence of alignment."""
    unit = 1 if mode == _SCALAR else 4
    if mode != _SCALAR and cols % 4:
        raise ValueError(f"a quad walk needs cols % 4 == 0, got {cols}")
    (_, blocks, rows_per_block), = _focal_plan([(rows, cols)])
    units = cols // unit
    k_rows = 4 // unit
    per_group = 1 if units >= THREADS else THREADS // units
    order = []
    for b in range(blocks):
        r0, r1 = b * rows_per_block, min((b + 1) * rows_per_block, rows)
        for t in range(THREADS):
            dr, c0 = divmod(t, units)
            seq = []
            if dr < per_group:
                for c in range(c0, units, THREADS):
                    for base in range(r0 + dr, r1, k_rows * per_group):
                        for k in range(k_rows):
                            row = base + k * per_group
                            if row < r1:
                                seq += [row * cols + c * unit + e
                                        for e in range(unit)]
            order.append(seq)
    return order


def _table(segs: Sequence[_Segment], dlogits=None):
    """The segment table as the C side takes it: 8 int64 and 4 pointers a
    segment (csrc/focal.cu::fill_table), and the grid's block count."""
    plan = _focal_plan([(s.rows, s.cols) for s in segs])
    dlogits = dlogits or [None] * len(segs)
    desc, ptrs = [], []
    for seg, d, (first, blocks, rows_per_block) in zip(segs, dlogits, plan):
        desc += [seg.z_stride, seg.x_stride, seg.rows, seg.cols,
                 _walk_mode(seg, d), first, blocks, rows_per_block]
        ptrs += [seg.z.data_ptr(), seg.x.data_ptr(),
                 None if seg.w is None else seg.w.data_ptr(),
                 None if d is None else d.data_ptr()]
    total = plan[-1][0] + plan[-1][1]
    return ((ctypes.c_int64 * len(desc))(*desc),
            (ctypes.c_void_p * len(ptrs))(*ptrs), total)


# One ticket counter for each (device, stream): the forward's last block
# leaves it at 0, so it is zeroed once, when it is made. Under CUDA-graph
# capture a launch takes a counter of its own instead, made and zeroed by
# nodes of the graph, so that every replay starts from 0 and no counter
# made outside the capture is written by a replay.
_COUNTERS: dict[tuple[int, int], torch.Tensor] = {}


def _counter(device: torch.device, stream: int) -> torch.Tensor:
    if torch.cuda.is_current_stream_capturing():
        return torch.zeros(1, dtype=torch.int32, device=device)
    key = (device.index, stream)
    if key not in _COUNTERS:
        _COUNTERS[key] = torch.zeros(1, dtype=torch.int32, device=device)
    return _COUNTERS[key]


def launch_fwd(labels, logits, weights, alpha: float,
               gamma: float) -> torch.Tensor:
    """The forward kernel over the segments ``(labels[i], logits[i],
    weights[i])``, read where they lie: their ``[S]`` float32 sums. The
    CUDA implementation of the ``detectax_torch::focal_group`` operator
    (`kernels/ops.py`)."""
    segs = [_prepare(z, x, w) for z, x, w in zip(labels, logits, weights)]
    device = segs[0].x.device
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


def launch_bwd(labels, logits, weights, grad_out: torch.Tensor,
               alpha: float, gamma: float) -> list[torch.Tensor]:
    """The backward kernel: each segment's dL/dlogits times
    ``grad_out[i]``, contiguous, in its logits' shape and dtype. The CUDA
    implementation of ``detectax_torch::focal_group_bwd``."""
    segs = [_prepare(z, x, w) for z, x, w in zip(labels, logits, weights)]
    device = segs[0].x.device
    dlogits = [torch.empty((s.rows, s.cols), dtype=torch.float32,
                           device=device) for s in segs]
    desc, ptrs, blocks = _table(segs, dlogits)
    if blocks:
        g = grad_out.to(torch.float32).contiguous()
        lib = load_kernels()
        with torch.cuda.device(device):
            code = lib.detectax_focal_group_bwd(
                len(segs), desc, ptrs, alpha, gamma, g.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
        _common.check_launch(code, "focal_bwd")
        _common.count_launch("focal_bwd")
    return [d.reshape(x.shape).to(x.dtype) for d, x in zip(dlogits, logits)]


def focal_grad_group_plain(labels, logits, weights, grad_out: torch.Tensor,
                           alpha: float, gamma: float) -> list[torch.Tensor]:
    """Plain version of `launch_bwd`: `focal_grad_plain` of each segment
    times ``grad_out[i]``, contiguous, in its logits' shape and dtype."""
    return [(focal_grad_plain(z, x, weights=w, alpha=alpha, gamma=gamma)
             * grad_out[i].to(torch.float32)).to(x.dtype).contiguous()
            for i, (z, x, w) in enumerate(zip(labels, logits, weights))]


def _plain_with_autograd(logits: Sequence[torch.Tensor]) -> bool:
    """CPU logits that need a gradient take the plain version with autograd
    (the formula `jax.grad` differentiates); every other call goes through
    the operator, whose CPU implementation is that plain version's forward
    and whose backward is the closed form."""
    return (not logits[0].is_cuda and torch.is_grad_enabled()
            and any(x.requires_grad for x in logits))


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
    It calls the ``detectax_torch::focal_group`` operator, whose autograd
    is ``focal_group_bwd`` (`kernels/ops.py`): on CUDA tensors ONE forward
    launch for all segments, and `backward` one backward launch (at most
    ``MAX_SEGMENTS`` segments a call); on CPU tensors the operator runs
    `focal_loss_group_plain` and, backward, `focal_grad_group_plain`. CPU
    logits that need a gradient take `focal_loss_group_plain` with
    autograd instead."""
    segs = [_unpack(s) for s in segments]
    if not segs:
        raise ValueError("focal_loss_group needs at least one segment")
    devices = {x.device for _, x, _ in segs}
    if len(devices) > 1:
        raise ValueError(f"segments lie on several devices: {devices}")
    labels, logits, weights = (list(t) for t in zip(*segs))
    if _plain_with_autograd(logits):
        return focal_loss_group_plain(segs, alpha=alpha, gamma=gamma)
    if logits[0].is_cuda and len(segs) > MAX_SEGMENTS:
        raise ValueError(f"focal_loss_group takes at most {MAX_SEGMENTS} "
                         f"segments a call, got {len(segs)}")
    return torch.ops.detectax_torch.focal_group(
        labels, logits, weights, float(alpha), float(gamma))


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
    forward kernel, and `backward` the backward kernel (through the
    operator); on a CPU tensor it runs `focal_loss_plain` (with autograd
    where the logits need a gradient, else through the operator).
    """
    if _plain_with_autograd([logits]):
        return focal_loss_plain(labels, logits, alpha=alpha, gamma=gamma,
                                weights=weights)
    return torch.ops.detectax_torch.focal_group(
        [labels], [logits], [weights], float(alpha),
        float(gamma)).reshape(())
