"""Export a trained detector to a serving bundle (`torch.export` + weights).

Port of `detectax/cli/export_model.py`: freezes the eval pipeline
(forward → decode → NMS, the graph `cli.evaluate` measures) into one
`torch.export` program a batch bucket, with the weights as call
arguments, beside ``weights.npz`` and ``manifest.json`` (a v2 bundle of
`detectax_torch.infer.export`). A serving host replays it with
``load_bundle(dir, device=...)`` without the port's model code. After
exporting, the bundle is reloaded and verified against the live model on
a random batch (max |Δ| printed), so a bundle on disk is a bundle that ran.

    python -m detectax_torch.cli.export_model --family fcos \\
        --backbone resnet50 --ckpt_dir ckpt --num_classes 20 \\
        --out_dir bundle --buckets 1 8 [--device cpu]

Deviations from the JAX CLI: the program is bound to the device it was
exported on (``--device``, default CUDA), so ``--platforms`` takes one
entry, which must name that device; ``--weights w.npz`` takes the place
of ``--ckpt_dir``. On CUDA the programs launch the hand-written kernels
(``detectax_torch::dense_nms``, ``nms_sweep``, ``peak``); on the CPU
their plain versions.
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from detectax_torch.cli.evaluate import FAMILIES, TRAIN_GEOMETRY, build_family
from detectax_torch.infer.export import (
    compare_detections,
    load_bundle,
    make_serving_fn,
    save_bundle,
)
from detectax_torch.runtime import resolve_device, set_tf32
from detectax_torch.tools.from_flax import load_flax, load_weights
from detectax_torch.train.driver import restore_for_inference


def _check_platforms(platforms, device: torch.device) -> None:
    if platforms is None:
        return
    if len(platforms) > 1:
        raise SystemExit(
            f"--platforms {' '.join(platforms)}: a torch.export program is "
            "bound to the device it was exported on, so the port has no "
            "multi-platform artifact; export once per device (--device)")
    want = {"gpu": "cuda"}.get(platforms[0], platforms[0])
    if want != device.type:
        raise SystemExit(
            f"--platforms {platforms[0]} does not name the export device "
            f"{device}; pass --device {want}")


def main(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    p.add_argument("--family", choices=FAMILIES, default="fcos")
    p.add_argument("--backbone", default="resnet50")
    p.add_argument("--ckpt_dir", default="ckpt")
    p.add_argument("--weights", default=None,
                   help="export a weights file (the port's .npz or a Flax "
                        ".msgpack of a whole detector) instead of "
                        "--ckpt_dir")
    p.add_argument("--num_classes", type=int, default=20)
    p.add_argument("--canvas", type=int, default=None,
                   help="default: the family's training canvas")
    p.add_argument("--buckets", type=int, nargs="+", default=[1, 8])
    p.add_argument("--out_dir", required=True)
    p.add_argument("--top_k", type=int, default=1024)
    p.add_argument("--iou_thresh", type=float, default=0.5)
    p.add_argument("--cls_thresh", type=float, default=0.05)
    p.add_argument("--max_outputs", type=int, default=100)
    p.add_argument("--class_aware_candidates", action="store_true")
    p.add_argument("--center", action="store_true")
    p.add_argument("--box_scales", type=float, nargs="+",
                   default=[32.0, 64.0, 128.0, 256.0, 512.0])
    p.add_argument("--anchor_sizes", type=float, nargs="+",
                   default=[20.0, 40.0, 80.0, 160.0, 320.0])
    p.add_argument("--n_filters", type=int, default=12)
    p.add_argument("--n_stacks", type=int, default=1)
    p.add_argument("--ema", action="store_true")
    p.add_argument("--platforms", nargs="+", default=None,
                   help="one entry naming the export device (cuda or gpu, "
                        "cpu); more than one is refused")
    p.add_argument("--fused", choices=("auto", "on", "off"), default="auto",
                   help="dense one-kernel NMS path: 'auto' resolves for "
                        "the export device (on for CUDA), 'on'/'off' "
                        "force it; the manifest records the result")
    p.add_argument("--verify_tol", type=float, default=1e-4,
                   help="max |replayed - live| allowed by the post-export "
                        "self-verification; exceeded -> non-zero exit")
    p.add_argument("--device", default=None,
                   help="torch device to export on (default: cuda; no CPU "
                        "fallback)")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    _check_platforms(args.platforms, device)
    set_tf32(False)

    geo_mode, geo_pad, geo_norm, geo_canvas = TRAIN_GEOMETRY[args.family]
    if args.canvas is None:
        args.canvas = geo_canvas
    elif args.canvas != geo_canvas:
        print(
            f"WARNING: --canvas {args.canvas} != {args.family}'s training "
            f"canvas {geo_canvas}; the manifest records the family's "
            "default geometry — served accuracy degrades unless the "
            "checkpoint was actually trained at this canvas/geometry."
        )
    model, decode = build_family(
        args.family, args.num_classes, args.backbone, args.canvas, args
    )
    model.to(device)
    if args.weights:
        if args.ema:
            raise ValueError("--ema reads a checkpoint, not --weights")
        load_flax(model, *load_weights(args.weights))
        model.eval()
    else:
        model = restore_for_inference(args.ckpt_dir, model,
                                      use_ema=args.ema)
    nms = dict(top_k=args.top_k, iou_thresh=args.iou_thresh,
               score_thresh=args.cls_thresh, max_outputs=args.max_outputs,
               class_aware_candidates=args.class_aware_candidates)
    manifest = save_bundle(
        args.out_dir, model, canvas=args.canvas, buckets=args.buckets,
        center=args.center,
        box_scales=(args.box_scales if args.family == "centernet_s8"
                    else None),
        anchor_sizes=(args.anchor_sizes if args.family == "retinanet"
                      else None),
        manifest_extra={
            "family": args.family,
            "resize_mode": geo_mode,
            "pad_position": geo_pad,
            "normalize": geo_norm,
        },
        export_device=device,
        fused={"auto": None, "on": True, "off": False}[args.fused],
        **nms,
    )

    # verify: the replayed bundle == the live serving graph on a random
    # batch of the first bucket
    predictor = load_bundle(args.out_dir, device=device)
    b = manifest["buckets"][0]
    rng = np.random.default_rng(0)
    images = rng.uniform(-1, 1, (b, args.canvas, args.canvas, 3))
    images = images.astype(np.float32)
    got = predictor.predict(images)
    serving_fn = make_serving_fn(model, decode, fused=manifest["fused"],
                                 **nms)
    with torch.no_grad():
        want = {k: v.cpu().numpy() for k, v in
                serving_fn(torch.from_numpy(images).to(device)).items()}
    max_diff = max(
        float(np.max(np.abs(want[k].astype(np.float32)
                            - got[k].astype(np.float32))))
        if want[k].size else 0.0
        for k in got
    )
    exact_ok = max_diff <= args.verify_tol
    # selections can differ at near-ties; the semantic gate compares the
    # detection sets (infer.export.compare_detections)
    det_report = None
    if not exact_ok:
        det_report = compare_detections(
            want, got, score_tol=max(args.verify_tol, 1e-3),
            score_thresh=args.cls_thresh,
        )
    ok = exact_ok or det_report["ok"]
    print(json.dumps({
        "bundle": args.out_dir,
        "buckets": manifest["buckets"],
        "verify_max_abs_diff": max_diff,
        "verify_tol": args.verify_tol,
        "verify_exact_ok": exact_ok,
        "verify_detection_report": det_report,
        "verify_ok": ok,
    }))
    if not ok:
        raise SystemExit(
            f"export verification failed: max |replayed - live| = "
            f"{max_diff:g} > --verify_tol {args.verify_tol:g} AND the "
            f"detection-aware comparison found "
            f"{det_report['real_mismatches']} non-boundary mismatches"
        )
    return {
        "manifest": manifest,
        "verify_max_abs_diff": max_diff,
        "verify_detection_report": det_report,
    }


if __name__ == "__main__":
    main()
