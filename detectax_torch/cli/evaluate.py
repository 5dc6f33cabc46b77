"""Evaluate a trained detector: mAP@0.5 (+ COCO-style) over a dataset.

Port of `detectax/cli/evaluate.py`: restores a checkpoint (or a weights
file), runs forward + decode + NMS over the eval set under
`torch.no_grad`, and reports VOC/COCO mAP via `detectax_torch.eval`.

Preprocessing geometry (resize mode / pad position / pixel normalization)
defaults to each family's *training* configuration so mAP is measured on
the distribution the model saw; every knob is overridable.

On a CUDA device the NMS stage is the fused dense-NMS kernel (the
sweep kernel under ``--class_aware_candidates``) and the heatmap decode
runs the peak kernel; ``--plain_kernels`` runs each kernel's plain version
in the same structure instead (the reference the kernels are held
against). On the CPU (``--device cpu``) the NMS stage is the two-stage
path, as the JAX package takes it on the CPU.

    python -m detectax_torch.cli.evaluate --family fcos \\
        --dataset detbench --ckpt_dir ckpt --coco_metrics [--device cpu]
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from detectax_torch.cli._common import dataset_from_args
from detectax_torch.eval.detection_metrics import (
    MeanAPEvaluator,
    coco_evaluator,
)
from detectax_torch.infer import predict as P
from detectax_torch.infer.export import hourglass_decode_fn
from detectax_torch.models import (
    FCOS,
    CenterNetFPNSingle,
    CenterNetS8,
    HourglassNet,
    RetinaNet,
    StackedHourglass,
)
from detectax_torch.ops import anchors as anchor_lib
from detectax_torch.runtime import resolve_device, set_tf32
from detectax_torch.tools.from_flax import load_flax, load_weights
from detectax_torch.train.driver import restore_for_inference

FAMILIES = (
    "fcos", "fcos_center", "fcos_center_v1", "centernet_s8",
    "centernet_heatmap", "hourglass", "stacked_hourglass", "retinanet",
)

# Training-time preprocessing per family (mirrors the trainer CLIs: eval
# must match training geometry or mAP is misreported).
#   family: (resize_mode, pad_position, normalize, default_canvas)
TRAIN_GEOMETRY = {
    "fcos": ("resize_pad", "topleft", "tf", 384),
    "fcos_center": ("stretch", "topleft", "tf", 384),
    "fcos_center_v1": ("stretch", "topleft", "tf", 384),
    "centernet_s8": ("stretch", "center", "unit", 512),
    "centernet_heatmap": ("resize_pad", "topleft", "tf", 384),
    "hourglass": ("resize_pad", "center", "tf", 320),
    "stacked_hourglass": ("resize_pad", "center", "tf", 320),
    "retinanet": ("stretch", "topleft", "tf", 512),
}


def build_family(family, nc, backbone, canvas, args, kernels=None):
    """(model, decode) of ``family``; ``kernels="plain"`` makes the decode
    run the peak kernel's plain version."""
    if family in ("fcos", "fcos_center", "fcos_center_v1"):
        variant = {"fcos": "fcos", "fcos_center": "center",
                   "fcos_center_v1": "center_v1"}[family]
        model = FCOS(num_classes=nc, variant=variant, backbone=backbone)
        if family == "fcos_center_v1":
            scales = [32.0, 64.0, 128.0, 256.0, float(canvas)]
            decode = lambda outs: P.fcos_center_v1_decode(
                outs, box_scales=scales
            )
        else:
            decode = lambda outs: P.fcos_decode(
                outs, use_centerness=(family != "fcos") or args.center
            )
        return model, decode
    if family == "centernet_s8":
        scales = tuple(args.box_scales)
        model = CenterNetS8(num_classes=nc, n_scales=len(scales),
                            backbone=backbone)
        return model, lambda out: P.centernet_s8_decode(out, box_scales=scales)
    if family == "centernet_heatmap":
        model = CenterNetFPNSingle(num_classes=nc, backbone=backbone)
        return model, lambda out: P.centernet_heatmap_decode(
            out, kernels=kernels
        )
    if family == "hourglass":
        model = HourglassNet(num_classes=nc, n_filters=args.n_filters)
        return model, hourglass_decode_fn(family, canvas=canvas)
    if family == "stacked_hourglass":
        model = StackedHourglass(num_classes=nc, n_filters=args.n_filters,
                                 n_stacks=args.n_stacks)
        return model, hourglass_decode_fn(family,
                                          stride=model.output_stride)
    if family == "retinanet":
        anchors = anchor_lib.anchor_shapes_per_level(
            anchor_sizes=args.anchor_sizes)
        model = RetinaNet(
            num_classes=nc, n_anchors=anchors[0].shape[0],
            backbone=backbone,
            per_anchor_heads=getattr(args, "per_anchor_heads", False),
        )
        return model, lambda outs: P.retinanet_decode(
            outs, anchors_per_level=anchors)
    raise ValueError(f"unknown family {family}")


def main(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    p.add_argument("--family", choices=FAMILIES, default="fcos")
    p.add_argument("--index", default=None)
    p.add_argument("--dataset",
                   choices=("synthetic", "detbench", "detbench_v2",
                            "detbench_v2_crowd"),
                   default="synthetic",
                   help="'detbench*' evaluates on the committed eval split "
                        "(benchmarks/detbench_v1/v2/v2_crowd .json)")
    p.add_argument("--synthetic_n", type=int, default=64)
    p.add_argument("--backbone", default="resnet50")
    p.add_argument("--ckpt_dir", default="ckpt")
    p.add_argument("--weights", default=None,
                   help="evaluate a weights file (the port's .npz or a "
                        "Flax .msgpack of a whole detector) instead of "
                        "--ckpt_dir")
    p.add_argument("--canvas", type=int, default=None,
                   help="eval canvas (default: the family's training canvas)")
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--max_boxes", type=int, default=64)
    p.add_argument("--cls_thresh", type=float, default=0.05)
    p.add_argument("--iou_thresh", type=float, default=0.5)
    p.add_argument("--center", action="store_true")
    p.add_argument("--coco_metrics", action="store_true",
                   help="also report AP@[.5:.95]")
    p.add_argument("--box_scales", type=float, nargs="+",
                   default=[32.0, 64.0, 128.0, 256.0, 512.0])
    p.add_argument("--anchor_sizes", type=float, nargs="+",
                   default=[20.0, 40.0, 80.0, 160.0, 320.0],
                   help="must match training (train_retinanet_coco "
                        "reference default)")
    p.add_argument("--per_anchor_heads", action="store_true",
                   help="retinanet: separate 3x3 head conv per (level, "
                        "anchor) pair — must match training")
    p.add_argument("--n_filters", type=int, default=12,
                   help="hourglass width (must match training)")
    p.add_argument("--n_stacks", type=int, default=1,
                   help="stacked_hourglass stack count (must match training)")
    p.add_argument("--max_outputs", type=int, default=100)
    p.add_argument("--top_k", type=int, default=1024,
                   help="NMS candidate pool for the two-stage path; the "
                        "fused dense-NMS path (the default on CUDA) is "
                        "equivalent to top_k=M and ignores this")
    p.add_argument("--resize_mode", choices=("resize_pad", "stretch"),
                   default=None,
                   help="default: the family's training resize mode")
    p.add_argument("--pad_position", choices=("topleft", "center"),
                   default=None)
    p.add_argument("--normalize", choices=("tf", "unit", "none"),
                   default=None)
    p.add_argument("--class_aware_candidates", action="store_true",
                   help="rank all (box, class) pairs before NMS (TF "
                        "combined-NMS semantics, reference FCOS infer path)")
    p.add_argument("--ema", action="store_true",
                   help="evaluate the EMA-averaged weights (requires "
                        "training with --ema_decay)")
    p.add_argument("--data_parallel", action="store_true",
                   help="shard the eval batch over all devices (not "
                        "ported yet: ROADMAP.md queue 1, Parallelism)")
    p.add_argument("--plain_kernels", action="store_true",
                   help="run every kernel's plain version in the kernel "
                        "path's structure (the reference the kernels are "
                        "held against)")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; no CPU fallback)")
    p.add_argument("--out_json", default=None)
    args = p.parse_args(argv)

    if args.data_parallel:
        raise NotImplementedError(
            "--data_parallel is not ported yet (ROADMAP.md queue 1, "
            "Parallelism)")
    device = resolve_device(args.device)
    set_tf32(False)
    kernels = "plain" if args.plain_kernels else None

    geo_mode, geo_pad, geo_norm, geo_canvas = TRAIN_GEOMETRY[args.family]
    resize_mode = args.resize_mode or geo_mode
    pad_position = args.pad_position or geo_pad
    normalize = args.normalize or geo_norm
    if args.canvas is None:
        args.canvas = geo_canvas

    dataset = dataset_from_args(args, split="eval")
    nc = dataset.num_classes
    model, decode = build_family(args.family, nc, args.backbone,
                                 args.canvas, args, kernels=kernels)
    model.to(device)
    if args.weights:
        if args.ema:
            raise ValueError("--ema reads a checkpoint, not --weights")
        load_flax(model, *load_weights(args.weights))
        model.eval()
    else:
        model = restore_for_inference(args.ckpt_dir, model,
                                      use_ema=args.ema)

    from detectax_torch.data.pipeline import Loader

    loader = Loader(
        dataset, batch_size=args.batch_size, canvas=args.canvas,
        max_boxes=args.max_boxes, flip=False, shuffle=False,
        mode=resize_mode, pad_position=pad_position, normalize=normalize,
        prefetch=1, drop_remainder=False,
    )
    evaluator = (
        coco_evaluator(nc) if args.coco_metrics
        else MeanAPEvaluator(nc)
    )
    canvas = args.canvas

    def forward_decode_nms(images):
        with torch.no_grad():
            outs = model(images, train=False)
            boxes, probs = decode(outs)
            return P.detections_from_dense(
                boxes, probs, top_k=args.top_k, iou_thresh=args.iou_thresh,
                score_thresh=args.cls_thresh, max_outputs=args.max_outputs,
                class_aware_candidates=args.class_aware_candidates,
                kernels=kernels,
            )

    for batch in loader:
        images = torch.from_numpy(
            np.ascontiguousarray(batch["images"], np.float32)).to(device)
        dets = {k: v.cpu().numpy()
                for k, v in forward_decode_nms(images).items()}
        det_boxes = dets["boxes"]
        det_scores = dets["scores"]
        det_classes = dets["classes"]
        n_valid = dets["num_valid"]
        ex_valid = batch.get(
            "example_valid", np.ones(len(batch["images"]), bool)
        )
        for i in range(len(batch["images"])):
            if not ex_valid[i]:
                continue  # padding of the final partial batch
            n = int(n_valid[i])
            gt_v = batch["valid"][i]
            gt_yxhw = batch["boxes"][i][gt_v] * canvas
            gt_corners = np.stack(
                [
                    gt_yxhw[:, 0] - gt_yxhw[:, 2] / 2,
                    gt_yxhw[:, 1] - gt_yxhw[:, 3] / 2,
                    gt_yxhw[:, 0] + gt_yxhw[:, 2] / 2,
                    gt_yxhw[:, 1] + gt_yxhw[:, 3] / 2,
                ],
                axis=-1,
            ) if gt_v.any() else np.zeros((0, 4), np.float32)
            evaluator.add_image(
                det_boxes[i][:n], det_scores[i][:n], det_classes[i][:n],
                gt_corners, batch["labels"][i][gt_v],
            )

    summary = evaluator.summarize()
    print(json.dumps(summary, indent=2))
    if args.out_json:
        with open(args.out_json, "w") as f:
            json.dump(summary, f)
    return summary


if __name__ == "__main__":
    main()
