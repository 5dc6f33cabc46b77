"""Single-image FCOS inference — port of `detectax/cli/infer_fcos.py`.

Loads the port's weights file (an ``.npz`` keyed by the Flax parameter
path, see `detectax_torch.tools.from_flax`), runs forward + decode +
class-aware NMS with combined-NMS candidates, writes `heatmap.jpg` and
`detection.jpg`, and rescales boxes back to the original image size.

    python -m detectax_torch.cli.infer_fcos --img_file a.jpg \\
        --weights weights.npz [--device cpu]
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from detectax_torch.data.pipeline import (
    _resize,
    decode_image,
    normalize_pixels,
)
from detectax_torch.infer import predict as P
from detectax_torch.infer.visualize import save_heatmap, visualize_detections
from detectax_torch.models import FCOS
from detectax_torch.runtime import resolve_device, set_tf32
from detectax_torch.tools.from_flax import load_flax, load_npz


def main(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    p.add_argument("--img_file", required=True)
    p.add_argument("--weights", required=True,
                   help=".npz weights file keyed by the Flax path")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; no CPU fallback)")
    p.add_argument("--backbone", default="resnet50")
    p.add_argument("--num_classes", type=int, default=20)
    p.add_argument("--labels_json", default=None,
                   help="optional json mapping id -> label name")
    p.add_argument("--img_dims", type=int, default=384)
    p.add_argument("--cls_thresh", type=float, default=0.3)
    p.add_argument("--iou_thresh", type=float, default=0.5)
    p.add_argument("--center", action="store_true",
                   help="multiply scores by the centerness branch")
    p.add_argument("--heatmap_out", default="heatmap.jpg")
    p.add_argument("--detect_out", default="detection.jpg")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    set_tf32(False)

    id_to_label = None
    if args.labels_json:
        with open(args.labels_json) as f:
            id_to_label = {int(k): v for k, v in json.load(f).items()}

    model = FCOS(num_classes=args.num_classes, backbone=args.backbone)
    load_flax(model, *load_npz(args.weights))
    model.to(device).eval()

    raw = decode_image({"image_path": args.img_file})
    oh, ow = raw.shape[:2]
    img = _resize(raw, (args.img_dims, args.img_dims))
    img = normalize_pixels(img, "tf")[None].astype(np.float32)

    with torch.no_grad():
        outs = model(torch.from_numpy(img).to(device), train=False)
        boxes, probs = P.fcos_decode(outs, use_centerness=args.center)
        # class_aware_candidates: combined-NMS semantics (a box may surface
        # under several classes), as the reference infer script has it.
        dets = P.detections_from_dense(
            boxes, probs, iou_thresh=args.iou_thresh,
            score_thresh=args.cls_thresh, max_outputs=100,
            class_aware_candidates=True,
        )
    dets = {k: v.cpu().numpy() for k, v in dets.items()}
    n = int(dets["num_valid"][0])
    # back to original resolution
    scale = np.array(
        [oh / args.img_dims, ow / args.img_dims] * 2, dtype=np.float32
    )
    visualize_detections(
        raw, dets["boxes"][0][:n] * scale,
        dets["classes"][0][:n], dets["scores"][0][:n],
        id_to_label, out_file=args.detect_out,
    )
    # multi-level max-prob heatmap at P3 resolution
    level_maps = []
    for lvl in outs:
        probs_lvl = torch.sigmoid(lvl[0][..., 5:]).amax(dim=-1).cpu().numpy()
        level_maps.append(_upsample_to(probs_lvl, outs[0].shape[1:3]))
    hm = np.stack(level_maps).max(0)
    save_heatmap(hm, out_file=args.heatmap_out, image=img[0],
                 title="max class prob (all levels)")
    print(f"{n} detections -> {args.detect_out}, heatmap -> {args.heatmap_out}")


def _upsample_to(hm: np.ndarray, hw):
    reps = (hw[0] // hm.shape[0], hw[1] // hm.shape[1])
    return np.repeat(np.repeat(hm, reps[0], 0), reps[1], 1)


if __name__ == "__main__":
    main()
