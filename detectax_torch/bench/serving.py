"""Serving throughput: images/s of the serving path at each batch bucket.

``python -m detectax_torch.bench.serving [--family fcos] [--backbone
mobilenetv2] [--canvas 384] [--buckets 1 8 16] [--iters 30]``

The counterpart of `benchmarks/serving_bench.py`: the model of
`cli.evaluate.build_family` (seeded weights, bf16 compute unless
``--no-bf16``) and the serving function of `infer.export.make_serving_fn`
(forward, decode, NMS: on the card the fused `dense_nms` kernel) on a
batch already on the device, ``uniform(-1, 1)`` from ``default_rng(0)``.
Each bucket: one call to build, one to warm up, then ``--iters`` calls
closed by a synchronise, on the host clock. One JSON line a bucket,
``serving_img_per_sec_<family>_<backbone>_<canvas>px_b<bucket>``, with the
card's name and power limit. It needs a CUDA device and has no CPU branch.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from detectax_torch import runtime
from detectax_torch.bench._common import (
    device_label,
    launches_since,
    require_cuda,
    synchronize,
)
from detectax_torch.cli.evaluate import FAMILIES, build_family
from detectax_torch.infer.export import make_serving_fn
from detectax_torch.kernels import _common as kcommon


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--family", default="fcos", choices=FAMILIES)
    p.add_argument("--backbone", default="mobilenetv2")
    p.add_argument("--canvas", type=int, default=384)
    p.add_argument("--num_classes", type=int, default=8)
    p.add_argument("--buckets", type=int, nargs="+", default=[1, 8, 16])
    p.add_argument("--iters", type=int, default=30)
    p.add_argument("--top_k", type=int, default=1024)
    p.add_argument("--bf16", action=argparse.BooleanOptionalAction,
                   default=True)
    # family knobs (cli.export_model's flags; the trainers' defaults)
    p.add_argument("--center", action="store_true")
    p.add_argument("--box_scales", type=float, nargs="+",
                   default=[32.0, 64.0, 128.0, 256.0, 512.0])
    p.add_argument("--anchor_sizes", type=float, nargs="+",
                   default=[20.0, 40.0, 80.0, 160.0, 320.0])
    p.add_argument("--n_filters", type=int, default=12)
    p.add_argument("--n_stacks", type=int, default=1)
    return p.parse_args(argv)


def build_serving(args: argparse.Namespace, device):
    """(model on ``device``, serving function) of the flags."""
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    model, decode = build_family(args.family, args.num_classes,
                                 args.backbone, args.canvas, args,
                                 dtype=dtype)
    model = model.to(device).eval()
    return model, make_serving_fn(model, decode, top_k=args.top_k)


def bucket_images(buckets, canvas: int, device) -> list:
    """One batch a bucket, ``[b, canvas, canvas, 3]`` float32 on
    ``device``: ``uniform(-1, 1)`` drawn in bucket order from
    ``default_rng(0)``."""
    rng = np.random.default_rng(0)
    return [torch.from_numpy(rng.uniform(-1, 1, (b, canvas, canvas, 3))
                             .astype(np.float32)).to(device)
            for b in buckets]


def bucket_line(fn, args, images: torch.Tensor) -> dict:
    b = images.shape[0]
    dev = images.device
    with torch.no_grad():
        for _ in range(2):   # build, then warm up
            fn(images)
        synchronize(dev)
        before = kcommon.launch_counts()
        t0 = time.perf_counter()
        for _ in range(args.iters):
            out = fn(images)
        synchronize(dev)
        dt = (time.perf_counter() - t0) / args.iters
    return {
        "metric": (f"serving_img_per_sec_{args.family}_{args.backbone}"
                   f"_{args.canvas}px_b{b}"),
        "value": round(b / dt, 1),
        "unit": "images/sec/chip",
        "detail": {
            "ms_per_batch": round(dt * 1000, 3),
            "iters": args.iters,
            "top_k": args.top_k,
            "dtype": "bfloat16" if args.bf16 else "float32",
            "device": device_label(dev),
            "card": runtime.card_name_and_power(),
            "launches": launches_since(before),
            "num_valid": out["num_valid"].tolist(),
        },
    }


def main(argv=None) -> list:
    args = parse_args(argv)
    dev = require_cuda("detectax_torch.bench.serving")
    runtime.set_tf32(False)
    _, fn = build_serving(args, dev)
    lines = []
    for images in bucket_images(args.buckets, args.canvas, dev):
        lines.append(bucket_line(fn, args, images))
        print(json.dumps(lines[-1]), flush=True)
    return lines


if __name__ == "__main__":
    main()
