"""Single-image RetinaNet inference — port of
`detectax/cli/infer_retinanet.py` (the reference's flags: --cls_thresh
--iou_thresh --center --show_text --high_res --img_file).

Loads the weights — a checkpoint directory written by
`cli.train_retinanet_coco` (``--ckpt_dir``) or the port's weights file
(``--weights``, an ``.npz`` keyed by the Flax parameter path, see
`detectax_torch.tools.from_flax`) — decodes the anchor maps, runs
class-agnostic NMS (200 outputs, as the reference's ``cpu_nms``), writes
an overlay and a heatmap of every level's max class probability, and
prints a count of the detections by class.

    python -m detectax_torch.cli.infer_retinanet --img_file a.jpg \\
        --weights weights.npz [--high_res] [--device cpu]

``--high_res`` infers at twice ``--img_dims``. On a CUDA device the NMS is
the hand-written dense kernel; there is no switch for it.
"""
from __future__ import annotations

import argparse
import json
from collections import Counter

import numpy as np
import torch

from detectax_torch.data.pipeline import (
    _resize,
    decode_image,
    normalize_pixels,
)
from detectax_torch.infer import predict as P
from detectax_torch.infer.visualize import save_heatmap, visualize_detections
from detectax_torch.models import RetinaNet
from detectax_torch.ops import anchors as anchor_lib
from detectax_torch.runtime import resolve_device, set_tf32
from detectax_torch.tools.from_flax import load_flax, load_npz
from detectax_torch.train.driver import restore_for_inference


def main(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    p.add_argument("--img_file", required=True)
    p.add_argument("--cls_thresh", type=float, default=0.30)
    p.add_argument("--iou_thresh", type=float, default=0.50)
    p.add_argument("--center", action="store_true")
    p.add_argument("--show_text", action="store_true", default=True)
    p.add_argument("--high_res", action="store_true",
                   help="infer at 2x resolution")
    p.add_argument("--ckpt_dir", default="ckpt")
    p.add_argument("--weights", default=None,
                   help=".npz weights file keyed by the Flax path (takes "
                        "the place of --ckpt_dir)")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; no CPU fallback)")
    p.add_argument("--backbone", default="resnet101")
    p.add_argument("--num_classes", type=int, default=81)
    p.add_argument("--labels_json", default=None)
    p.add_argument("--img_dims", type=int, default=512)
    p.add_argument("--anchor_sizes", type=float, nargs="+",
                   default=[20.0, 40.0, 80.0, 160.0, 320.0])
    p.add_argument("--detect_out", default="detection.jpg")
    p.add_argument("--heatmap_out", default="heatmap.jpg")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    set_tf32(False)
    dims = args.img_dims * (2 if args.high_res else 1)
    id_to_label = None
    if args.labels_json:
        with open(args.labels_json) as f:
            id_to_label = {int(k): v for k, v in json.load(f).items()}

    anchors = anchor_lib.anchor_shapes_per_level(
        anchor_sizes=args.anchor_sizes)
    model = RetinaNet(
        num_classes=args.num_classes, n_anchors=anchors[0].shape[0],
        backbone=args.backbone,
    ).to(device)
    if args.weights:
        load_flax(model, *load_npz(args.weights))
        model.eval()
    else:
        restore_for_inference(args.ckpt_dir, model)

    raw = decode_image({"image_path": args.img_file})
    oh, ow = raw.shape[:2]
    img = normalize_pixels(
        _resize(raw, (dims, dims)), "tf")[None].astype(np.float32)

    with torch.no_grad():
        outs = model(torch.from_numpy(img).to(device), train=False)
        boxes, probs = P.retinanet_decode(outs, anchors_per_level=anchors)
        dets = P.detections_from_dense(
            boxes, probs, iou_thresh=args.iou_thresh,
            score_thresh=args.cls_thresh, max_outputs=200,
            class_aware=False,  # the reference's cpu_nms is class-agnostic
        )
        # every level's max class probability over anchors and classes,
        # repeated up to the P3 grid
        h3, w3 = outs[0].shape[1:3]
        level_maps = []
        for lvl in outs:
            m = torch.sigmoid(lvl[0][..., 4:]).amax(dim=(-1, -2))
            reps = (h3 // m.shape[0], w3 // m.shape[1])
            level_maps.append(m.repeat_interleave(reps[0], 0)
                              .repeat_interleave(reps[1], 1))
        hm = torch.stack(level_maps).amax(dim=0)
    dets = {k: v.cpu().numpy() for k, v in dets.items()}
    n = int(dets["num_valid"][0])
    scale = np.array([oh / dims, ow / dims] * 2, dtype=np.float32)
    classes = dets["classes"][0][:n]
    visualize_detections(
        raw, dets["boxes"][0][:n] * scale, classes, dets["scores"][0][:n],
        id_to_label, out_file=args.detect_out, show_text=args.show_text,
    )
    save_heatmap(hm.cpu().numpy(), out_file=args.heatmap_out, image=img[0])

    counts = Counter(int(c) for c in classes)
    for cls_id, cnt in sorted(counts.items()):
        name = id_to_label.get(cls_id, str(cls_id)) if id_to_label else cls_id
        print(f"{cnt} {name} detected")
    print(f"{n} detections -> {args.detect_out}")
    return dets


if __name__ == "__main__":
    main()
