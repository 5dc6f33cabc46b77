#!/usr/bin/env python3
"""Benchmark of the PyTorch / CUDA port: ``python3 bench_torch.py``.

The counterpart of `bench.py`, on one CUDA device: one JSON line a metric,
under `bench.py`'s metric names, keys and formulas.

- ``train_images_per_sec_fcos_resnet50_384px_b16_bf16``: training images/s
  of the flagship step (FCOS ResNet-50 FPN, 384 px, batch 16, bf16
  compute; on-device assignment, forward, loss, backward, clip, SGD),
  min of 3 windows; ``mfu_pct`` is the step's convolution and matmul
  operations (`FlopCounterMode`, forward and backward) over the step time
  and 989 TFLOP/s, the H100 SXM's dense bf16 peak;
- ``..._bf16_bnsubset4``: the same step with ``DETECTAX_BN_STAT_SUBSET=4``
  (BatchNorm statistics from a quarter of the batch);
- ``..._bf16_freeze_bn``: the same step with BatchNorm on its running
  statistics;
- ``decode_nms_latency_fcos_512px_k1024``: one image's decode + NMS at
  512 px (the fused `dense_nms` kernel).

Each line's ``detail`` names the card and its power limit (``nvidia-smi``).
The environment knobs are `bench.py`'s: ``BENCH_IMG`` (384),
``BENCH_BATCH`` (16), ``BENCH_STEPS`` (30), ``BENCH_WINDOWS`` (3),
``BENCH_BACKBONE`` (resnet50), ``BENCH_SKIP_BEST_CONFIG=1`` (lines 1 only),
``BENCH_SKIP_NMS=1``, ``BENCH_NMS_ITERS`` (50).

Without a CUDA device, or when a first tiny operation on it fails, it
prints one ``bench_backend_unreachable`` line and exits 1; it has no CPU
branch.
"""
from __future__ import annotations

import json
import os
import sys

from detectax_torch import runtime
from detectax_torch.bench import _common, decode, train
from detectax_torch.bench._common import emit


def bench_train(img: int, batch: int, steps: int, windows: int,
                backbone: str, best_config: bool = True) -> list:
    """Lines 1, 1b and 1c (the last two unless ``best_config`` is off),
    each printed as it is measured."""
    name = f"train_images_per_sec_fcos_{backbone}_{img}px_b{batch}_bf16"
    args = (img, batch, steps, windows, backbone)
    lines = [emit(train.train_line(name, *args))]
    if best_config:
        # BatchNorm reads the switch at every training forward
        with _common.scoped_env({"DETECTAX_BN_STAT_SUBSET": "4"}):
            lines.append(emit(train.train_line(
                name + "_bnsubset4", *args,
                note="best-known live-stats config "
                     "(DETECTAX_BN_STAT_SUBSET=4; BASELINE.md r3 levers)")))
        lines.append(emit(train.train_line(
            name + "_freeze_bn", *args, freeze_bn=True,
            note="production fine-tuning config (--freeze_bn, "
                 "inference-mode BN; BASELINE.md r4 levers)")))
    return lines


def probe_backend() -> None:
    """`bench.py::_probe_backend`: one ``bench_backend_unreachable`` line
    and exit 1 unless a CUDA device answers a first tiny operation."""
    reason = _common.probe_cuda()
    if reason is None:
        return
    print(json.dumps({
        "metric": "bench_backend_unreachable",
        "value": 0,
        "unit": "error",
        "vs_baseline": 0,
        "detail": {
            "reason": reason,
            "cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES"),
        },
    }), flush=True)
    sys.exit(1)


def main() -> list:
    probe_backend()
    runtime.set_tf32(False)
    env = os.environ.get
    lines = bench_train(
        img=int(env("BENCH_IMG", "384")),
        batch=int(env("BENCH_BATCH", "16")),
        steps=int(env("BENCH_STEPS", "30")),
        windows=int(env("BENCH_WINDOWS", "3")),
        backbone=env("BENCH_BACKBONE", "resnet50"),
        best_config=env("BENCH_SKIP_BEST_CONFIG") != "1")
    if env("BENCH_SKIP_NMS") != "1":
        lines.append(emit(decode.decode_line(
            int(env("BENCH_NMS_ITERS", "50")))))
    return lines


if __name__ == "__main__":
    main()
