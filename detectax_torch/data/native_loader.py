"""ctypes binding to the native (C++/libjpeg/OpenMP) image loader.

Port of `detectax/data/native_loader.py`, with the same public API and
argtypes: multithreaded JPEG decode + bilinear resize behind the C ABI of
`native/dx_image.cpp`, which both packages compile.

The port builds its own copy on first use, with the flags of
`native/Makefile`, into ``detectax_torch/kernels/build/libdx_image.so``
(git-ignored, beside the CUDA kernels' library); it never writes into
`native/`. The library is linked under a private name and renamed into
place, so processes building at once never load half a file, and it is
rebuilt when the source is newer. When the build fails (no compiler, no
``jpeglib.h`` or ``-ljpeg``), `available()` is False and
`unavailable_reason()` holds the compiler's output: callers that asked
for the native path can say why it is off.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading
import time

import numpy as np

_PORT_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(os.path.dirname(_PORT_DIR), "native", "dx_image.cpp")
BUILD_DIR = os.path.join(_PORT_DIR, "kernels", "build")
LIB_NAME = "libdx_image.so"

# native/Makefile: CXXFLAGS, LDFLAGS, LDLIBS
CXXFLAGS = ("-O3", "-fPIC", "-fopenmp", "-Wall", "-std=c++17")
LDFLAGS = ("-shared", "-fopenmp")
LDLIBS = ("-ljpeg",)

_lib = None
_reason: str | None = None
_build_seconds: float | None = None
_lib_lock = threading.Lock()


def _build(lib_path: str) -> None:
    """Compile `SOURCE` into ``lib_path``; raises with the compiler's
    output on failure."""
    global _build_seconds
    t0 = time.perf_counter()
    os.makedirs(os.path.dirname(lib_path), exist_ok=True)
    # link to a private name, then rename: a reader never sees half a file
    tmp_path = f"{lib_path}.{os.getpid()}.tmp"
    cmd = [os.environ.get("CXX", "g++"), *CXXFLAGS, *LDFLAGS, "-o",
           tmp_path, SOURCE, *LDLIBS]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=120)
    except (OSError, subprocess.SubprocessError) as e:
        raise RuntimeError(f"$ {' '.join(cmd)}\n{e}") from e
    if res.returncode != 0:
        if os.path.exists(tmp_path):
            os.remove(tmp_path)
        raise RuntimeError(f"$ {' '.join(cmd)}\n{res.stdout}{res.stderr}")
    os.replace(tmp_path, lib_path)
    _build_seconds = time.perf_counter() - t0


def _stale(lib_path: str) -> bool:
    return (not os.path.isfile(lib_path)
            or os.path.getmtime(SOURCE) > os.path.getmtime(lib_path))


def load_library():
    """Load (building if needed) the native library; None if unavailable,
    with the reason in `unavailable_reason()`."""
    global _lib, _reason
    with _lib_lock:
        if _lib is not None or _reason is not None:
            return _lib
        lib_path = os.path.join(BUILD_DIR, LIB_NAME)
        try:
            if _stale(lib_path):
                _build(lib_path)
            lib = ctypes.CDLL(lib_path)
        except (OSError, RuntimeError) as e:
            _reason = f"the native loader did not build or load: {e}"
            return None
        lib.dx_image_info.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.dx_image_info.restype = ctypes.c_int
        lib.dx_decode_resize.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_float),
        ]
        lib.dx_decode_resize.restype = ctypes.c_int
        lib.dx_decode_resize_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_float), ctypes.c_int,
        ]
        lib.dx_decode_resize_batch.restype = ctypes.c_int
        _lib = lib
        return _lib


def available() -> bool:
    return load_library() is not None


def unavailable_reason() -> str | None:
    """Why the library is not available (the compiler's output of a failed
    build), or None when it loaded or has not been asked for."""
    return _reason


def build_seconds() -> float | None:
    """Wall seconds of the build this process ran (None: found it built)."""
    return _build_seconds


def library_path() -> str | None:
    """Path of the loaded library (None when it is not loaded)."""
    return None if _lib is None else _lib._name


def _require():
    lib = load_library()
    if lib is None:
        raise RuntimeError(f"native loader unavailable: {_reason}")
    return lib


def image_info(path: str) -> tuple[int, int]:
    """(height, width) from the JPEG header."""
    lib = _require()
    w = ctypes.c_int()
    h = ctypes.c_int()
    rc = lib.dx_image_info(path.encode(), ctypes.byref(w), ctypes.byref(h))
    if rc != 0:
        raise IOError(f"dx_image_info failed ({rc}) for {path}")
    return h.value, w.value


def decode_resize(path: str, out_h: int, out_w: int) -> np.ndarray:
    """Decode a JPEG and bilinear-resize to [out_h, out_w, 3] float32."""
    lib = _require()
    out = np.empty((out_h, out_w, 3), np.float32)
    rc = lib.dx_decode_resize(
        path.encode(), out_h, out_w,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    if rc != 0:
        raise IOError(f"dx_decode_resize failed ({rc}) for {path}")
    return out


def decode_resize_batch(
    paths: list[str],
    out_hw: list[tuple[int, int]],
    num_threads: int = 0,
) -> list[np.ndarray]:
    """Decode+resize many JPEGs in parallel (OpenMP inside the library)."""
    lib = _require()
    n = len(paths)
    hs = np.asarray([hw[0] for hw in out_hw], np.int32)
    ws = np.asarray([hw[1] for hw in out_hw], np.int32)
    sizes = (hs.astype(np.int64) * ws * 3)
    offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64)
    buf = np.empty(int(sizes.sum()), np.float32)
    c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    failures = lib.dx_decode_resize_batch(
        c_paths, n,
        hs.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        ws.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        num_threads,
    )
    if failures:
        raise IOError(f"{failures}/{n} decodes failed")
    return [
        buf[offsets[i]:offsets[i] + sizes[i]].reshape(hs[i], ws[i], 3)
        for i in range(n)
    ]
