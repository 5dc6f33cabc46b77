"""Train the single-map heatmap CenterNet (FPN-collapse variant) — port of
`detectax/cli/train_centernet_heatmap.py`.

Stride-8 single map, pseudo-Gaussian (or true Gaussian) center prior with
sigma-shrunken ltrb fills, `num_classes+1` class channels with an
objectness slot at index 0, focal + centerness + masked reg loss. Adam,
exponential schedule, 384 px, batch 16, ResNet-50.

    python -m detectax_torch.cli.train_centernet_heatmap --max_steps 100 \\
        [--device cpu]

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
from detectax_torch.models import CenterNetFPNSingle
from detectax_torch.ops import assign
from detectax_torch.runtime import resolve_device
from detectax_torch.train import losses as det_losses
from detectax_torch.train.driver import fit


def main(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    add_train_args(p, canvas=384, batch_size=16, init_lr=1e-3,
                   backbone="resnet50", max_steps=20000)
    p.add_argument("--sigma", type=float, default=0.25,
                   help="box-shrink factor for the ltrb fill region")
    p.add_argument("--heatmap_kind", choices=("pseudo", "gaussian"),
                   default="pseudo")
    p.add_argument("--reg_type", choices=("l1", "iou"), default="l1")
    args = p.parse_args(argv)
    if args.dump_visuals:
        raise NotImplementedError(
            "--dump_visuals: this trainer has no visual hook (neither has "
            "the JAX package's)")
    resolve_device(args.device)  # fail before any work without a device

    dataset = dataset_from_args(args)
    nc = dataset.num_classes
    model = CenterNetFPNSingle(num_classes=nc, backbone=args.backbone,
                               freeze_bn=args.freeze_bn,
                               dtype=compute_dtype(args))
    cfg = config_from_args(
        args,
        optimizer="adam",
        schedule="exponential",
        schedule_kwargs={"init_lr": args.init_lr},
    )
    img = (cfg.canvas, cfg.canvas)

    def assign_fn(boxes, labels, valid):
        # objectness slot at class index 0; real labels shift by +1
        out, _ = assign.centernet_heatmap_assign(
            boxes, labels + 1, valid, img_dim=img, num_classes=nc + 1,
            sigma=args.sigma, heatmap_kind=args.heatmap_kind,
        )
        return [out]  # single level; reuse the multi-level fcos loss

    def loss_fn(y_true, y_pred):
        return det_losses.fcos_loss(
            y_true, [y_pred], reg_type=args.reg_type, cen_type="l1"
        )

    return fit(cfg, model, dataset, assign_fn, loss_fn)


if __name__ == "__main__":
    main()
