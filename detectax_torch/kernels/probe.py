"""Measurement aids for the kernels; the serving path never imports it.

``csrc/barrier_probe.cu`` holds the empty skeletons of the NMS kernels'
dependent steps; timing them gives what a step costs before any work is
put into it, and so the floor of each design (``chip_smoke.py`` prints it
beside the kernels' times):

* `barrier_probe`: rounds of one shared-memory exchange and one block-wide
  barrier, the round of a one-block-per-image design;
* `cluster_probe`: rounds across a thread-block cluster. ``mode`` 0 is a
  cluster barrier alone, 1 a round built on it (block exchange, slot,
  cluster barrier, read of every block's slot), 2 the round of
  ``csrc/dense_nms.cu`` (every warp's slot pushed to every block, one
  mbarrier wait a block);
* `chain_probe`: the sweep's chain in ``csrc/nms_sweep.cu``, one warp;
* `empty_launch`: a kernel that does nothing, the floor under every
  kernel's time.

None of them is counted as a kernel launch.
"""
from __future__ import annotations

import ctypes

import torch

from detectax_torch.kernels import _common

CLUSTER_MODES = ("barrier", "barrier_round", "exchange_round")


def _lib() -> ctypes.CDLL:
    lib = _common.load_library()
    i, p = ctypes.c_int, ctypes.c_void_p
    lib.detectax_barrier_probe.argtypes = [i, i, i, p, p]
    lib.detectax_barrier_probe.restype = i
    lib.detectax_cluster_probe.argtypes = [i, i, i, i, i, p, p]
    lib.detectax_cluster_probe.restype = i
    lib.detectax_chain_probe.argtypes = [i, i, p, p]
    lib.detectax_chain_probe.restype = i
    lib.detectax_empty_launch.argtypes = [p]
    lib.detectax_empty_launch.restype = i
    return lib


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def barrier_probe(rounds: int, blocks: int, device: torch.device,
                  threads: int = 1024) -> torch.Tensor:
    """`rounds` dependent rounds of (exchange, barrier) in `blocks` blocks
    of `threads` threads."""
    out = torch.empty((blocks, threads), dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        code = _lib().detectax_barrier_probe(
            int(rounds), int(blocks), int(threads), out.data_ptr(), _stream())
    _common.check_launch(code, "barrier_probe")
    return out


def cluster_probe(rounds: int, clusters: int, cluster: int,
                  device: torch.device, threads: int = 384,
                  mode: str = "exchange_round") -> torch.Tensor:
    """`rounds` dependent empty rounds of `mode` (one of `CLUSTER_MODES`)
    in `clusters` clusters of `cluster` blocks of `threads` threads."""
    out = torch.empty((clusters * cluster, threads), dtype=torch.int32,
                      device=device)
    with torch.cuda.device(device):
        code = _lib().detectax_cluster_probe(
            int(rounds), CLUSTER_MODES.index(mode), int(clusters),
            int(cluster), int(threads), out.data_ptr(), _stream())
    _common.check_launch(code, "cluster_probe")
    return out


def chain_probe(steps: int, blocks: int, device: torch.device) -> torch.Tensor:
    """`blocks` warps, each a chain of `steps` (rounded up to 64) sweep
    steps."""
    out = torch.empty((blocks, 32), dtype=torch.int64, device=device)
    with torch.cuda.device(device):
        code = _lib().detectax_chain_probe(
            _common.round_up(int(steps), 64), int(blocks), out.data_ptr(),
            _stream())
    _common.check_launch(code, "chain_probe")
    return out


def empty_launch(device: torch.device) -> None:
    """One launch of one warp that does nothing."""
    with torch.cuda.device(device):
        code = _lib().detectax_empty_launch(_stream())
    _common.check_launch(code, "empty_launch")
