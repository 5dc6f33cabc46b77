"""The peak-decode kernel of the CenterNet heatmap path: wrapper and plain
versions.

`peak_scores` (sigmoid inside) and `peak_mask_scores` (scores given) keep a
score where it is >= each of its 8 neighbours in its own class plane and
write 0 elsewhere — the maxpool-equals test that stands in for NMS on a
centre heatmap. They replace the TPU kernel
``detectax/ops/pallas/peak_decode.py::_peak_call`` (`peak_scores_pallas`,
`peak_mask_scores_pallas`). CUDA source: ``csrc/peak.cu`` (one thread an
element, one launch for all planes of the batch).

Layout: the map is taken as the decode has it, ``[B, h, w, C]``
channel-last, or as ``[H, W, P]`` — the layout the TPU kernel takes, P
folded planes — which is the case B = 1. It is read where it lies when
its last dimension has unit stride and the leading ones collapse onto one
cell stride (a contiguous map, or the class channels ``probs[..., 1:]`` of
a wider one); any other layout is made contiguous first. The result is a
new contiguous float32 tensor of the input's shape.

Contract at the edges, the same in the kernel and the plain versions: a
neighbour outside the map counts as -1 (not -inf), so a border cell below
-1 is no peak; the test is >=, so every cell of a plateau is kept and an
all-zero plane stays zero; a NaN anywhere in a 3x3 neighbourhood makes its
centre 0 (the plain versions' ``torch.maximum`` propagates NaN, and the
kernel tests ``neighbour <= centre``, which a NaN fails); +-inf compare as
numbers. There is no gradient: this is decode only.

Beside the wrappers stand the plain versions `peak_scores_plain` and
`peak_mask_scores_plain`: pad with -1, maximum of the eight shifted
slices, select. A wrapper takes its plain version only for a tensor on the
CPU; for a CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from detectax_torch.kernels import _common


@functools.cache
def load_kernels() -> ctypes.CDLL:
    """The built library with this module's argument types declared."""
    lib = _common.load_library()
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.detectax_peak.argtypes = [p, i64, i64, i64, i64, i64, ctypes.c_int,
                                  p, p]
    lib.detectax_peak.restype = ctypes.c_int
    return lib


def _check_map(t: torch.Tensor) -> None:
    if t.ndim not in (3, 4):
        raise ValueError(
            "expected a [B, h, w, C] map or [H, W, P] folded planes, got "
            f"shape {tuple(t.shape)}")


def neighbour_max(p: torch.Tensor) -> torch.Tensor:
    """Maximum of each cell's 8 neighbours in its ``[h, w]`` plane, a
    neighbour outside the map counting as -1."""
    h, w = p.shape[-3], p.shape[-2]
    padded = F.pad(p, (0, 0, 1, 1, 1, 1), value=-1.0)
    nmax = None
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            shifted = padded[..., 1 + dy:1 + dy + h, 1 + dx:1 + dx + w, :]
            nmax = shifted if nmax is None else torch.maximum(nmax, shifted)
    return nmax


def _mask_to_peaks(p: torch.Tensor) -> torch.Tensor:
    return torch.where(p >= neighbour_max(p), p,
                       torch.zeros((), dtype=p.dtype, device=p.device))


def peak_scores_plain(logits: torch.Tensor) -> torch.Tensor:
    """Plain version of `peak_scores`: ``1 / (1 + exp(-x))`` as the kernel
    writes it, then the peak mask."""
    _check_map(logits)
    x = logits.to(torch.float32)
    return _mask_to_peaks(1.0 / (1.0 + torch.exp(-x)))


def peak_mask_scores_plain(scores: torch.Tensor) -> torch.Tensor:
    """Plain version of `peak_mask_scores`."""
    _check_map(scores)
    return _mask_to_peaks(scores.to(torch.float32))


def _launch(t: torch.Tensor, apply_sigmoid: bool) -> torch.Tensor:
    _check_map(t)
    shape = tuple(t.shape)
    batch, (h, w, c) = (1 if t.ndim == 3 else shape[0]), shape[-3:]
    x, cells, _, stride = _common.as_rows(t.detach().to(torch.float32))
    out = torch.empty(shape, dtype=torch.float32, device=t.device)
    if out.numel() == 0:
        return out
    if cells * max(stride, c) > _common.MAX_OFFSET:
        raise ValueError(
            f"the peak kernel indexes elements with 32 bits: {cells} cells "
            f"at stride {max(stride, c)} do not fit")
    lib = load_kernels()
    with torch.cuda.device(t.device):
        code = lib.detectax_peak(
            x.data_ptr(), stride, batch, h, w, c, int(apply_sigmoid),
            out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    _common.check_launch(code, "peak")
    _common.count_launch("peak")
    return out


def peak_scores(logits: torch.Tensor) -> torch.Tensor:
    """Class logits ``[B, h, w, C]`` (or ``[H, W, P]``) -> sigmoid scores
    masked to their 3x3 local peaks, zeros elsewhere. Launches the kernel
    on a CUDA tensor; runs `peak_scores_plain` on a CPU tensor."""
    if not logits.is_cuda:
        return peak_scores_plain(logits)
    return _launch(logits, True)


def peak_mask_scores(scores: torch.Tensor) -> torch.Tensor:
    """Pre-computed scores (e.g. sigma(cls) * sigma(cen)) ``[B, h, w, C]``
    (or ``[H, W, P]``) -> the same maps masked to their 3x3 local peaks.
    Same kernel, sigmoid skipped. Launches the kernel on a CUDA tensor;
    runs `peak_mask_scores_plain` on a CPU tensor."""
    if not scores.is_cuda:
        return peak_mask_scores_plain(scores)
    return _launch(scores, False)
