"""The focal-loss kernel of the training path: wrapper and plain versions.

`focal_loss` — sum-reduced stable sigmoid focal loss with its closed-form
gradient. Replaces the TPU kernel
``detectax/ops/pallas/focal.py::focal_loss_pallas`` (`_focal_kernel` and
the analytic `_bwd`). CUDA source: ``csrc/focal.cu`` (`focal_fwd`: one pass
over the elements to one partial sum a block, then an ordered reduction of
the partials; `focal_bwd`: one pass that writes dL/dlogits).

Bound by bytes (8-12 in and, backward, 4 out an element against a few
dozen float operations), and at the training shapes — a few MB a level —
by the latency of its launches. The source says what the design does
about it. Sums are formed without atomics in an order that depends on the
element count alone, so two runs on the same input give the same bits.

Layout: labels and logits are read where they lie. A tensor whose last
dimension has unit stride and whose leading dimensions collapse onto one
row stride (a contiguous tensor, or the class channels ``y[..., 5:]`` of a
contiguous map) is handed to the kernel as ``[rows, cols]`` with that row
stride; any other layout is made contiguous first. ``weights`` is broadcast
to the logits' shape and made contiguous (one float an element).

Beside the wrapper stand the plain versions: `focal_loss_plain` (the
formula of `detectax_torch.ops.losses.focal_loss`, gradient by autograd)
and `focal_grad_plain` (the closed form in tensor ops). The wrapper takes
the plain version only for a tensor on the CPU; for a CUDA tensor it
launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from detectax_torch.kernels import _common
from detectax_torch.ops.losses import _stable_bce_terms
from detectax_torch.ops.losses import focal_loss as focal_loss_plain


@functools.cache
def load_kernels() -> ctypes.CDLL:
    """The built library with this module's argument types declared."""
    lib = _common.load_library()
    p, i64, f = ctypes.c_void_p, ctypes.c_int64, ctypes.c_float
    lib.detectax_focal_blocks.argtypes = [i64]
    lib.detectax_focal_blocks.restype = ctypes.c_int
    lib.detectax_focal_fwd.argtypes = [p, i64, p, i64, p, i64, i64, f, f,
                                       p, p, p]
    lib.detectax_focal_fwd.restype = ctypes.c_int
    lib.detectax_focal_bwd.argtypes = [p, i64, p, i64, p, p, i64, i64, f, f,
                                       p, p]
    lib.detectax_focal_bwd.restype = ctypes.c_int
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


def _prepare(labels, logits, weights):
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
    if rows * max(z_stride, x_stride, cols) > _common.MAX_OFFSET:
        raise ValueError(
            f"focal_loss indexes with 32-bit offsets: {rows} rows at stride "
            f"{max(z_stride, x_stride, cols)} do not fit")
    return z, z_stride, x, x_stride, w, rows, cols


class _FocalLoss(torch.autograd.Function):
    """The two launches. Labels and weights get no gradient."""

    @staticmethod
    def forward(ctx, labels, logits, weights, alpha, gamma):
        z, zs, x, xs, w, rows, cols = _prepare(labels, logits, weights)
        ctx.save_for_backward(z, x, w)
        ctx.layout = (zs, xs, rows, cols, alpha, gamma, logits.shape,
                      logits.dtype)
        out = torch.zeros((), dtype=torch.float32, device=x.device)
        if rows * cols == 0:
            return out
        lib = load_kernels()
        partials = torch.empty(lib.detectax_focal_blocks(rows * cols),
                               dtype=torch.float32, device=x.device)
        with torch.cuda.device(x.device):
            code = lib.detectax_focal_fwd(
                z.data_ptr(), zs, x.data_ptr(), xs,
                None if w is None else w.data_ptr(), rows, cols,
                alpha, gamma, partials.data_ptr(), out.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
        _common.check_launch(code, "focal_fwd")
        _common.count_launch("focal_fwd")
        return out

    @staticmethod
    def backward(ctx, grad_out):
        z, x, w = ctx.saved_tensors
        zs, xs, rows, cols, alpha, gamma, shape, dtype = ctx.layout
        dlogits = torch.empty((rows, cols), dtype=torch.float32,
                              device=x.device)
        if rows * cols:
            g = grad_out.to(torch.float32).contiguous()
            lib = load_kernels()
            with torch.cuda.device(x.device):
                code = lib.detectax_focal_bwd(
                    z.data_ptr(), zs, x.data_ptr(), xs,
                    None if w is None else w.data_ptr(), g.data_ptr(),
                    rows, cols, alpha, gamma, dlogits.data_ptr(),
                    torch.cuda.current_stream().cuda_stream)
            _common.check_launch(code, "focal_bwd")
            _common.count_launch("focal_bwd")
        return None, dlogits.reshape(shape).to(dtype), None, None, None


def focal_loss(
    labels: torch.Tensor,
    logits: torch.Tensor,
    *,
    weights: torch.Tensor | None = None,
    alpha: float = 0.25,
    gamma: float = 2.0,
) -> torch.Tensor:
    """Sum-reduced stable sigmoid focal loss (float32 scalar),
    differentiable in ``logits``.

    ``weights``, when given, is broadcastable to ``logits.shape`` and
    multiplies each element's loss. On a CUDA tensor this launches the
    forward kernel, and `backward` the backward kernel; on a CPU tensor it
    runs `focal_loss_plain`.
    """
    if not logits.is_cuda:
        return focal_loss_plain(labels, logits, alpha=alpha, gamma=gamma,
                                weights=weights)
    return _FocalLoss.apply(labels, logits, weights, float(alpha),
                            float(gamma))
