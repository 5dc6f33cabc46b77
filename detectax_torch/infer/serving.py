"""Bucketed-batch serving front end.

Port of `detectax/infer/serving.py`. Serving stays static-shape serving: a
request of any size is greedily chunked into the largest batch bucket that
fits, the final partial chunk is zero-padded up to the smallest covering
bucket, and pad rows are dropped from the output. A fixed, small set of
batch shapes keeps every dispatch on shapes the device libraries have
already planned for (`warmup`), and keeps results independent of how
requests happen to be grouped.
"""
from __future__ import annotations

from typing import Callable, Mapping, Sequence

import numpy as np
import torch

from detectax_torch.runtime import resolve_device, set_tf32


class Predictor:
    """Run a detector over arbitrary-size request batches.

    ``bucket_fns`` maps batch size -> ``fn(images[b,H,W,3] f32 numpy) ->
    detection dict`` (numpy arrays or tensors), one per batch bucket — see
    `for_model`.
    """

    def __init__(self, bucket_fns: Mapping[int, Callable], *,
                 canvas: int, manifest: dict | None = None,
                 device: torch.device | None = None):
        if not bucket_fns:
            raise ValueError("need at least one batch bucket")
        self._fns = {int(b): f for b, f in bucket_fns.items()}
        self._buckets = sorted(self._fns)
        self.canvas = int(canvas)
        self.manifest = manifest or {}
        self.device = device

    @classmethod
    def for_model(cls, serving_fn: Callable, model: torch.nn.Module, *,
                  canvas: int, buckets: Sequence[int] = (1, 8),
                  device=None, manifest: dict | None = None):
        """Bucketed predictor over a live model.

        ``serving_fn(images tensor) -> detections`` is the graph of
        `infer.export.make_serving_fn` over ``model``. The model is moved
        to ``device`` (default CUDA; raises when there is none) and put in
        eval mode. The fp32 serving path runs with both TF32 switches off.
        """
        dev = resolve_device(device)
        set_tf32(False)
        model.to(dev).eval()

        def run(images: np.ndarray) -> dict:
            with torch.no_grad():
                return serving_fn(torch.from_numpy(images).to(dev))

        return cls({int(b): run for b in buckets}, canvas=canvas,
                   manifest=manifest, device=dev)

    def _plan(self, n: int) -> list[int]:
        """Greedy chunking: largest bucket <= remaining, else the smallest
        bucket covering the tail (padded)."""
        plan = []
        while n > 0:
            fit = [b for b in self._buckets if b <= n]
            if fit:
                b = fit[-1]
            else:
                b = next(x for x in self._buckets if x >= n)
            plan.append(b)
            n -= min(b, n)
        return plan

    def warmup(self) -> None:
        """Run every bucket once (zeros input) so the first real requests
        find kernels built and library plans made; waits for the device."""
        for b in self._buckets:
            self._fns[b](
                np.zeros((b, self.canvas, self.canvas, 3), np.float32)
            )
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # Detection-dict keys every serving graph returns (`ops.nms`
    # contract) — used to shape the n==0 early return.
    _DET_KEYS = ("boxes", "scores", "classes", "valid", "num_valid")

    def predict(self, images: np.ndarray) -> dict:
        """images: [n, canvas, canvas, 3] float32 (already preprocessed —
        see `infer.export.preprocess_images`). Returns the detection dict
        as numpy arrays with leading dim n (pad rows removed)."""
        images = np.asarray(images, dtype=np.float32)
        if images.ndim != 4 or images.shape[1:3] != (self.canvas,
                                                     self.canvas):
            raise ValueError(
                f"expected images [n, {self.canvas}, {self.canvas}, 3] "
                f"(the bundle's canvas), got {images.shape}; preprocess "
                "with infer.export.preprocess_images"
            )
        n = images.shape[0]
        if n == 0:
            # empty request: empty detection dict, no device dispatch
            return {k: np.zeros((0,), np.float32) for k in self._DET_KEYS}
        outs, taken = [], 0
        for b in self._plan(n):
            chunk = images[taken:taken + b]
            taken += chunk.shape[0]
            if chunk.shape[0] < b:
                pad = np.zeros(
                    (b - chunk.shape[0],) + chunk.shape[1:], np.float32
                )
                chunk = np.concatenate([chunk, pad])
            outs.append(self._fns[b](np.ascontiguousarray(chunk)))
        # one host copy per output after every chunk was enqueued
        outs = [{k: _to_numpy(v) for k, v in o.items()} for o in outs]
        return {
            k: np.concatenate([o[k] for o in outs])[:n]
            for k in outs[0]
        }


def _to_numpy(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)
