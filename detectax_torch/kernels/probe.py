"""Measurement aid for the NMS kernels; the serving path never imports it.

``csrc/barrier_probe.cu`` is the empty skeleton of both NMS kernels: a
chain of dependent rounds, each a shared-memory exchange and one
block-wide barrier. Timing it gives what a round costs before any work is
put into it, and so the floor of a one-block-per-image design
(``chip_smoke.py`` prints it beside the kernels' times).
"""
from __future__ import annotations

import ctypes

import torch

from detectax_torch.kernels import _common


def barrier_probe(rounds: int, blocks: int, device: torch.device,
                  threads: int = 1024) -> torch.Tensor:
    """Launch `rounds` dependent rounds of (exchange, barrier) in `blocks`
    blocks of `threads` threads. Not counted as a kernel launch."""
    out = torch.empty((blocks, threads), dtype=torch.int32, device=device)
    lib = _common.load_library()
    i, p = ctypes.c_int, ctypes.c_void_p
    lib.detectax_barrier_probe.argtypes = [i, i, i, p, p]
    lib.detectax_barrier_probe.restype = i
    with torch.cuda.device(device):
        code = lib.detectax_barrier_probe(
            int(rounds), int(blocks), int(threads), out.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    _common.check_launch(code, "barrier_probe")
    return out
