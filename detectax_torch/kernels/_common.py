"""Shared helpers for the hand-written CUDA kernels.

The kernels are CUDA C++ for ``sm_90a`` under ``csrc/``, each with a plain
C interface. At first use every source is compiled by its own ``nvcc``
process (all started together), the objects are linked into one shared
library under ``build/``, and the library is loaded with ``ctypes``. No
PyTorch header is involved, so a build takes seconds. Nothing here runs at
import time: a machine without ``nvcc`` can import every module.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time

import torch

CSRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
LIB_NAME = "libdetectax_kernels.so"
DEFAULT_NVCC = "/usr/local/cuda/bin/nvcc"

# -fmad=false: keep a*b+c as a rounded multiply and a rounded add, as the
# plain PyTorch versions compute it — an FMA can flip an IoU that sits on
# the threshold, and keep sets are compared exactly.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-Xcompiler", "-fPIC",
)

# Launches per kernel: a wrapper adds one where it launches its kernel and
# nowhere else, so a run can show that it went through the kernels.
_LAUNCHES: dict[str, int] = {}

_lib: ctypes.CDLL | None = None
_build_seconds: float | None = None


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


MAX_OFFSET = 2 ** 31 - 1  # the elementwise kernels index with 32 bits


def as_rows(t: torch.Tensor) -> tuple[torch.Tensor, int, int, int]:
    """(tensor to keep alive, rows, cols, row stride) of a float32 tensor
    read as ``[rows, cols]``; copies only a layout that is not rows of
    unit-stride elements at one stride."""
    if t.ndim == 0:
        t = t.reshape(1)
    cols = t.shape[-1]
    collapses = t.stride(-1) == 1 and all(
        t.stride(i) == t.stride(i + 1) * t.shape[i + 1]
        for i in range(t.ndim - 2))
    if not collapses:
        t = t.contiguous()
    rows = t.numel() // cols if cols else 0
    stride = t.stride(-2) if t.ndim >= 2 else cols
    return t, rows, cols, stride


def count_launch(name: str) -> None:
    _LAUNCHES[name] = _LAUNCHES.get(name, 0) + 1


def launch_counts() -> dict[str, int]:
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    _LAUNCHES.clear()


def _find_nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [
        os.path.join(cuda_home, "bin", "nvcc") if cuda_home else None,
        shutil.which("nvcc"),
        DEFAULT_NVCC,
    ]
    for c in candidates:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        f"nvcc not found (looked at $CUDA_HOME/bin, $PATH and "
        f"{DEFAULT_NVCC}): the CUDA kernels of detectax_torch are "
        "built from source at first use"
    )


def build_library(verbose: bool = False) -> str:
    """Compile ``csrc/*.cu`` (one nvcc per source, in parallel) and link
    them into ``build/libdetectax_kernels.so``. Raises with nvcc's output
    on failure. Returns the library path."""
    global _build_seconds
    t0 = time.perf_counter()
    nvcc = _find_nvcc()
    sources = sorted(
        f for f in os.listdir(CSRC_DIR) if f.endswith(".cu")
    )
    if not sources:
        raise RuntimeError(f"no CUDA sources under {CSRC_DIR}")
    os.makedirs(BUILD_DIR, exist_ok=True)
    extra = ("-Xptxas", "-v") if verbose else ()
    procs = []
    for src in sources:
        # private object names: two processes may build at the same time
        obj = os.path.join(BUILD_DIR, f"{src[:-3]}.{os.getpid()}.o")
        cmd = [nvcc, *NVCC_FLAGS, *extra, "-c",
               os.path.join(CSRC_DIR, src), "-o", obj]
        procs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )))
    objs, failures, log = [], [], []
    for cmd, obj, proc in procs:
        out, _ = proc.communicate()
        log.append(out)
        if proc.returncode != 0:
            failures.append(f"$ {' '.join(cmd)}\n{out}")
        objs.append(obj)
    if failures:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
    lib_path = os.path.join(BUILD_DIR, LIB_NAME)
    # link to a private name, then rename: a reader never sees half a file
    tmp_path = f"{lib_path}.{os.getpid()}.tmp"
    cmd = [nvcc, "-shared", "-o", tmp_path, *objs]
    res = subprocess.run(cmd, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True)
    for obj in objs:
        os.remove(obj)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n$ {' '.join(cmd)}\n"
                           f"{res.stdout}")
    os.replace(tmp_path, lib_path)
    _build_seconds = time.perf_counter() - t0
    if verbose:
        print("".join(log))
    return lib_path


def _stale(lib_path: str) -> bool:
    if not os.path.isfile(lib_path):
        return True
    built = os.path.getmtime(lib_path)
    return any(
        os.path.getmtime(os.path.join(CSRC_DIR, f)) > built
        for f in os.listdir(CSRC_DIR)
    )


def load_library(verbose: bool = False) -> ctypes.CDLL:
    """The kernels' shared library, built from ``csrc/`` when missing or
    older than a source. ``argtypes`` are declared by the wrapper modules."""
    global _lib
    if _lib is None:
        lib_path = os.path.join(BUILD_DIR, LIB_NAME)
        if _stale(lib_path):
            lib_path = build_library(verbose=verbose)
        _lib = ctypes.CDLL(lib_path)
        _lib.detectax_cuda_error_string.argtypes = [ctypes.c_int]
        _lib.detectax_cuda_error_string.restype = ctypes.c_char_p
    return _lib


def check_launch(code: int, what: str) -> None:
    """Raise when a kernel's C entry point returned a CUDA error code."""
    if code != 0:
        msg = load_library().detectax_cuda_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA launch failed ({code}: {msg})")


def build_seconds() -> float | None:
    """Wall seconds of the build this process ran (None: found it built)."""
    return _build_seconds
