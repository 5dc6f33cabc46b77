"""Single-image decode + NMS latency, `bench.py`'s last line.

Five FCOS level outputs at 512 px (5,456 cells, 20 classes) drawn as
`bench.py` draws them (``default_rng(1)``, normal with scale 2), decoded by
`infer.predict.fcos_decode` and reduced by `detections_from_dense` with
top-k 1,024, 100 outputs and a 0.05 score threshold. On a CUDA tensor that
is the fused path, one `dense_nms` kernel launch a call, as the TPU takes
`dense_nms_pallas`.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from detectax_torch import runtime
from detectax_torch.bench._common import (
    device_label,
    launches_since,
    synchronize,
)
from detectax_torch.infer import predict as P
from detectax_torch.kernels import _common as kcommon

IMG = 512
NUM_CLASSES = 20
STRIDES = (8, 16, 32, 64, 128)
TOP_K, MAX_OUTPUTS, SCORE_THRESH = 1024, 100, 0.05
TARGET_MS = 10.0   # BASELINE.md's latency target, bench.py's vs_baseline


def decode_inputs(img: int = IMG, nc: int = NUM_CLASSES) -> list:
    """`bench.py::bench_decode_nms`'s level outputs ``[1, img/s, img/s,
    5 + nc]`` float32, as numpy."""
    rng = np.random.default_rng(1)
    return [rng.normal(scale=2.0, size=(1, img // s, img // s, 5 + nc))
            .astype(np.float32) for s in STRIDES]


def decode_and_nms(outs, kernels=None) -> dict:
    """The detections of the level outputs ``outs`` (tensors); ``kernels``
    is `detections_from_dense`'s override ("plain": the fused path on the
    plain version, as the tests take it on the CPU)."""
    boxes, probs = P.fcos_decode(outs)
    return P.detections_from_dense(
        boxes, probs, top_k=TOP_K, max_outputs=MAX_OUTPUTS,
        score_thresh=SCORE_THRESH, kernels=kernels)


def decode_line(iters: int) -> dict:
    """The latency line on the CUDA device (raising without one): one call
    to build the kernels and warm up (not timed), then ``iters`` calls
    closed by a synchronise, on the host clock. ``detail`` counts the
    kernel launches of the timed calls."""
    dev = runtime.resolve_device(None)
    outs = [torch.from_numpy(o).to(dev) for o in decode_inputs()]
    with torch.no_grad():
        dets = decode_and_nms(outs)
        synchronize(dev)
        before = kcommon.launch_counts()
        t0 = time.perf_counter()
        for _ in range(iters):
            dets = decode_and_nms(outs)
        synchronize(dev)
        dt = (time.perf_counter() - t0) / iters
    ms = dt * 1000
    return {
        "metric": f"decode_nms_latency_fcos_{IMG}px_k{TOP_K}",
        "value": round(ms, 3),
        "unit": "ms/image",
        "vs_baseline": round(TARGET_MS / ms, 1),
        "detail": {
            "iters": iters,
            "device": device_label(dev),
            "card": runtime.card_name_and_power(),
            "candidates": int(sum((IMG // s) ** 2 for s in STRIDES)),
            "launches": launches_since(before),
            "num_valid": int(dets["num_valid"][0]),
        },
    }
