"""The peak-decode kernel of the CenterNet heatmap path: wrapper and plain
versions.

`peak_scores` (sigmoid inside) and `peak_mask_scores` (scores given) keep a
score where it is >= each of its 8 neighbours in its own class plane and
write 0 elsewhere — the maxpool-equals test that stands in for NMS on a
centre heatmap. They replace the TPU kernel
``detectax/ops/pallas/peak_decode.py::_peak_call`` (`peak_scores_pallas`,
`peak_mask_scores_pallas`). CUDA source: ``csrc/peak.cu`` (one block a
band of rows of an image, staged once into shared memory with its halo;
one launch for all planes of the batch). The bands, and the column and
channel tiles where a row does not fit, are `_peak_plan`, a pure function
of the shape.

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
slices, select. `peak_bands_plain` is the plain model of the kernel's
decomposition (one staged band, tile and halo at a time, as `_peak_plan`
cuts them). A wrapper calls the operator ``detectax_torch::peak``
(`kernels.ops`, where the launch lives), which takes the plain version
only for a tensor on the CPU; for a CUDA tensor it launches the kernel or
raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from detectax_torch.kernels import _common

STAGE_BYTES = 48 * 1024    # a block's staging (csrc/peak.cu kMaxSmemBytes)


@functools.cache
def load_kernels() -> ctypes.CDLL:
    """The built library with this module's argument types declared."""
    lib = _common.load_library()
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.detectax_peak.argtypes = [p, i64, i64, i64, i64, i64, i64, i64, i64,
                                  ctypes.c_int, p, p]
    lib.detectax_peak.restype = ctypes.c_int
    return lib


def _peak_plan(h: int, w: int, c: int, batch: int = 1) -> dict:
    """How the kernel cuts a ``[batch, h, w, c]`` map into blocks.

    A block stages ``(rows + 2) x (col_tile + 2)`` cells of ``chan_tile``
    floats (its band with a halo row and cell on every side) into at most
    ``STAGE_BYTES`` of shared memory. A cell's channels are tiled only when
    a 3 x 3 of cells would not fit, a row's cells only when three staged
    rows would not; then the band is as tall as fits, but short enough for
    ``_common.SMS`` blocks to be in flight where the map has the rows.
    Covers every shape with at least one element."""
    floats = STAGE_BYTES // 4
    chan_tile = c if 9 * c <= floats else floats // 9 // 4 * 4
    col_tile = (w if 3 * (w + 2) * chan_tile <= floats
                else max(1, floats // (3 * chan_tile) - 2))
    fit = max(1, floats // ((col_tile + 2) * chan_tile) - 2)
    col_tiles = -(-w // col_tile)
    chan_tiles = -(-c // chan_tile)
    rows = max(1, min(h, fit,
                      batch * h * col_tiles * chan_tiles // _common.SMS))
    bands = -(-h // rows)
    return {"rows": rows, "col_tile": col_tile, "chan_tile": chan_tile,
            "bands": bands, "col_tiles": col_tiles, "chan_tiles": chan_tiles,
            "blocks": batch * bands * col_tiles * chan_tiles,
            "smem_bytes": (rows + 2) * (col_tile + 2) * chan_tile * 4}


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


def peak_bands_plain(t: torch.Tensor, apply_sigmoid: bool = False
                     ) -> torch.Tensor:
    """Plain model of the kernel's decomposition: for each block of
    `_peak_plan`, stage its band, tile and halo (-1 outside the map, the
    sigmoid applied once a staged element), keep each output where its 8
    staged neighbours are all <= it. Equals `peak_mask_scores_plain` (and,
    with the sigmoid, `peak_scores_plain`) exactly; it exists to show that
    the cut covers the map once and that the halo is right."""
    _check_map(t)
    x = t.to(torch.float32)
    x4 = x if x.ndim == 4 else x.unsqueeze(0)
    batch, h, w, c = x4.shape
    out = torch.zeros_like(x4)
    if out.numel() == 0:
        return out.reshape(x.shape)
    plan = _peak_plan(h, w, c, batch)
    r, tw, tc = plan["rows"], plan["col_tile"], plan["chan_tile"]
    for y0 in range(0, h, r):
        for x0 in range(0, w, tw):
            for c0 in range(0, c, tc):
                rows, cols, cw = min(r, h - y0), min(tw, w - x0), min(tc, c - c0)
                staged = torch.full((batch, rows + 2, cols + 2, cw), -1.0)
                ya, yb = max(y0 - 1, 0), min(y0 + rows + 1, h)
                xa, xb = max(x0 - 1, 0), min(x0 + cols + 1, w)
                part = x4[:, ya:yb, xa:xb, c0:c0 + cw]
                if apply_sigmoid:
                    part = 1.0 / (1.0 + torch.exp(-part))
                staged[:, ya - y0 + 1:yb - y0 + 1,
                       xa - x0 + 1:xb - x0 + 1] = part
                p = staged[:, 1:rows + 1, 1:cols + 1]
                keep = torch.ones_like(p, dtype=torch.bool)
                for dy in (-1, 0, 1):
                    for dx in (-1, 0, 1):
                        if dy or dx:
                            q = staged[:, 1 + dy:1 + dy + rows,
                                       1 + dx:1 + dx + cols]
                            keep &= q <= p
                out[:, y0:y0 + rows, x0:x0 + cols, c0:c0 + cw] = torch.where(
                    keep, p, torch.zeros((), dtype=p.dtype))
    return out.reshape(x.shape)


def peak_scores(logits: torch.Tensor) -> torch.Tensor:
    """Class logits ``[B, h, w, C]`` (or ``[H, W, P]``) -> sigmoid scores
    masked to their 3x3 local peaks, zeros elsewhere. Launches the kernel
    on a CUDA tensor; runs `peak_scores_plain` on a CPU tensor (the
    operator ``detectax_torch::peak`` picks by device)."""
    _check_map(logits)
    return torch.ops.detectax_torch.peak(logits, True)


def peak_mask_scores(scores: torch.Tensor) -> torch.Tensor:
    """Pre-computed scores (e.g. sigma(cls) * sigma(cen)) ``[B, h, w, C]``
    (or ``[H, W, P]``) -> the same maps masked to their 3x3 local peaks.
    Same kernel, sigmoid skipped. Launches the kernel on a CUDA tensor;
    runs `peak_mask_scores_plain` on a CPU tensor (the operator
    ``detectax_torch::peak`` picks by device)."""
    _check_map(scores)
    return torch.ops.detectax_torch.peak(scores, False)
