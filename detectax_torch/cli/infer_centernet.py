"""Single-image CenterNet inference (ResNet backbone, stride 8) — port of
`detectax/cli/infer_centernet.py`.

Loads the weights — a checkpoint directory written by one of the port's
trainers (``--ckpt_dir``) or the port's weights file (``--weights``, an
``.npz`` keyed by the Flax parameter path, see
`detectax_torch.tools.from_flax`) — decodes the scale-slot map
(``--variant s8``) or the peak-masked heatmap (``--variant heatmap``), runs
class-wise (soft-)NMS and writes overlay + heatmap jpgs.

    python -m detectax_torch.cli.infer_centernet --img_file a.jpg \\
        --variant heatmap --weights weights.npz [--device cpu]

On a CUDA device the heatmap variant's peak mask and the hard NMS run the
hand-written kernels; there is no switch for them.
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
from detectax_torch.models import CenterNetFPNSingle, CenterNetS8
from detectax_torch.runtime import resolve_device, set_tf32
from detectax_torch.tools.from_flax import load_flax, load_npz
from detectax_torch.train.driver import restore_for_inference


def main(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    p.add_argument("--img_file", required=True)
    p.add_argument("--ckpt_dir", default="ckpt")
    p.add_argument("--weights", default=None,
                   help=".npz weights file keyed by the Flax path (takes "
                        "the place of --ckpt_dir)")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; no CPU fallback)")
    p.add_argument("--backbone", default="resnet101")
    p.add_argument("--num_classes", type=int, default=1)
    p.add_argument("--variant", choices=("s8", "heatmap"), default="s8",
                   help="'s8' = scale-slot CenterNetS8; 'heatmap' = "
                        "single-map CenterNetFPNSingle (peak decode)")
    p.add_argument("--labels_json", default=None)
    p.add_argument("--img_dims", type=int, default=512)
    p.add_argument("--box_scales", type=float, nargs="+",
                   default=[32.0, 64.0, 128.0, 256.0, 512.0])
    p.add_argument("--cls_thresh", type=float, default=0.5)
    p.add_argument("--iou_thresh", type=float, default=0.213)
    p.add_argument("--soft_nms", action="store_true",
                   help="Gaussian soft-NMS rescoring")
    p.add_argument("--detect_out", default="detection.jpg")
    p.add_argument("--heatmap_out", default="heatmap.jpg")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    set_tf32(False)

    id_to_label = None
    if args.labels_json:
        with open(args.labels_json) as f:
            id_to_label = {int(k): v for k, v in json.load(f).items()}

    if args.variant == "heatmap":
        model = CenterNetFPNSingle(
            num_classes=args.num_classes, backbone=args.backbone)
        pixel_norm = "tf"  # this family trains with /127.5-1
    else:
        model = CenterNetS8(
            num_classes=args.num_classes, n_scales=len(args.box_scales),
            backbone=args.backbone)
        pixel_norm = "unit"
    model.to(device)
    if args.weights:
        load_flax(model, *load_npz(args.weights))
        model.eval()
    else:
        restore_for_inference(args.ckpt_dir, model)

    raw = decode_image({"image_path": args.img_file})
    oh, ow = raw.shape[:2]
    img = normalize_pixels(
        _resize(raw, (args.img_dims, args.img_dims)), pixel_norm
    )[None].astype(np.float32)

    with torch.no_grad():
        out = model(torch.from_numpy(img).to(device), train=False)
        if args.variant == "heatmap":
            boxes, probs = P.centernet_heatmap_decode(out)
            # [h,w,4+1+C]: max class prob (objectness slot 0 skipped)
            hm = torch.sigmoid(out[0][..., 6:]).amax(dim=-1)
        else:
            boxes, probs = P.centernet_s8_decode(
                out, box_scales=args.box_scales)
            hm = torch.sigmoid(out[0][..., 4:]).amax(dim=(-1, -2))
        dets = P.detections_from_dense(
            boxes, probs, iou_thresh=args.iou_thresh,
            score_thresh=args.cls_thresh, max_outputs=200,
            class_aware=True, mode="soft" if args.soft_nms else "hard",
        )
    dets = {k: v.cpu().numpy() for k, v in dets.items()}
    n = int(dets["num_valid"][0])
    scale = np.array(
        [oh / args.img_dims, ow / args.img_dims] * 2, dtype=np.float32
    )
    visualize_detections(
        raw, dets["boxes"][0][:n] * scale,
        dets["classes"][0][:n], dets["scores"][0][:n],
        id_to_label, out_file=args.detect_out,
    )
    save_heatmap(hm.cpu().numpy(), out_file=args.heatmap_out, image=img[0])
    print(f"{n} detections -> {args.detect_out}")
    return dets


if __name__ == "__main__":
    main()
