"""Train CenterNet ResNet-s8 on CrowdHuman — port of
`detectax/cli/train_centernet_crowdhuman.py`.

Reference config: 512 px center-padded, batch 16, box_scales
[32,64,128,256,512], ResNet-101, piecewise LR 0.01 -> /10 @20k -> /100
@25k, SGD momentum, 30000 steps, single "person" class.

    python -m detectax_torch.cli.train_centernet_crowdhuman \\
        --index crowdhuman.json [--device cpu]

On a CUDA device the classification loss runs the hand-written focal
kernel; there is no switch for it.
"""
from __future__ import annotations

import argparse

from detectax_torch.cli._common import (
    add_train_args,
    compute_dtype,
    config_from_args,
    dataset_from_args,
)
from detectax_torch.cli._eval_hooks import centernet_s8_eval_hook
from detectax_torch.models import CenterNetS8
from detectax_torch.ops import assign
from detectax_torch.runtime import resolve_device
from detectax_torch.train import losses as det_losses
from detectax_torch.train.driver import fit


def main(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    add_train_args(p, canvas=512, batch_size=16, init_lr=0.01,
                   backbone="resnet101", max_steps=30000)
    p.add_argument("--box_scales", type=float, nargs="+",
                   default=[32.0, 64.0, 128.0, 256.0, 512.0])
    p.add_argument("--lr_boundaries", type=int, nargs="+",
                   default=[20000, 25000])
    p.add_argument("--use_scale", action="store_true",
                   help="per-step random content scale: one square content "
                        "side ~ U(min_scale*base_dims, canvas) per batch, "
                        "stretched and center-padded")
    p.add_argument("--min_scale", type=float, default=0.7)
    p.add_argument("--gaussian_cls", action="store_true",
                   help="Gaussian-smoothed class targets (CenterNet "
                        "heatmap style) instead of the reference's lone "
                        "one-hot centroid cell — needed for from-scratch "
                        "training; regression stays centroid-only")
    p.add_argument("--base_dims", type=int, default=448,
                   help="reference base_rows/base_cols (=448)")
    args = p.parse_args(argv)
    resolve_device(args.device)  # fail before any work without a device

    dataset = dataset_from_args(args)
    nc = dataset.num_classes
    model = CenterNetS8(
        num_classes=nc, n_scales=len(args.box_scales),
        backbone=args.backbone, freeze_bn=args.freeze_bn,
        dtype=compute_dtype(args),
    )
    cfg = config_from_args(
        args,
        optimizer="sgd",
        schedule="piecewise",
        schedule_kwargs={
            "init_lr": args.init_lr,
            "boundaries": args.lr_boundaries,
            "scales": [0.1] * len(args.lr_boundaries),
        },
        pad_position="center",
        normalize="unit",  # this family divides by 255
        # images are parsed square (stretch) and center-padded to the canvas
        resize_mode="stretch",
    )
    if args.use_scale:
        cfg.jitter = (args.min_scale * args.base_dims, float(cfg.canvas))
        cfg.jitter_per_batch = True
    img = (cfg.canvas, cfg.canvas)

    def assign_fn(boxes, labels, valid):
        out, _ = assign.centernet_scale_slot_assign(
            boxes, labels, valid, img_dim=img, num_classes=nc,
            box_scales=tuple(args.box_scales),
            gaussian_cls=args.gaussian_cls,
        )
        return out

    hook = (
        centernet_s8_eval_hook(tuple(args.box_scales), dataset.id_to_label)
        if cfg.dump_visuals else None
    )
    return fit(cfg, model, dataset, assign_fn, det_losses.centernet_s8_loss,
               eval_hook=hook)


if __name__ == "__main__":
    main()
