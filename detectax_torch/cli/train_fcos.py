"""Train FCOS (all-in-box assignment) — port of `detectax/cli/train_fcos.py`.

Reference config: ResNet-50, batch 16, init_lr 5e-4 exponential decay
(rate 0.75 / 1000 steps, floor 1e-5), SGD momentum 0.9, global-norm clip
1.0, 20000 steps, 384 px.

    python -m detectax_torch.cli.train_fcos --max_steps 100 [--device cpu]

On a CUDA device the classification loss runs the hand-written focal
kernel; there is no switch for it.
"""
from __future__ import annotations

import argparse
import functools

from detectax_torch.cli._common import (
    add_train_args,
    compute_dtype,
    config_from_args,
    dataset_from_args,
)
from detectax_torch.cli._eval_hooks import fcos_eval_hook
from detectax_torch.models import FCOS
from detectax_torch.ops import assign
from detectax_torch.runtime import resolve_device
from detectax_torch.train import losses as det_losses
from detectax_torch.train.driver import fit


def main(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    add_train_args(p, canvas=384, batch_size=16, init_lr=5e-4,
                   backbone="resnet50", max_steps=20000)
    p.add_argument("--reg_type", choices=("l1", "iou"), default="l1")
    p.add_argument("--decay_rate", type=float, default=0.75)
    p.add_argument("--decay_steps", type=int, default=1000)
    p.add_argument("--min_lr", type=float, default=1e-5)
    p.add_argument("--weight_decay", type=float, default=0.0)
    args = p.parse_args(argv)
    resolve_device(args.device)  # fail before any work without a device

    dataset = dataset_from_args(args)
    nc = dataset.num_classes
    model = FCOS(num_classes=nc, variant="fcos", backbone=args.backbone,
                 freeze_bn=args.freeze_bn, dtype=compute_dtype(args))
    cfg = config_from_args(
        args,
        optimizer="sgd",
        schedule="exponential",
        schedule_kwargs={
            "init_lr": args.init_lr,
            "decay_rate": args.decay_rate,
            "decay_steps": args.decay_steps,
            "min_lr": args.min_lr,
        },
        weight_decay=args.weight_decay,
    )
    img = (cfg.canvas, cfg.canvas)

    def assign_fn(boxes, labels, valid):
        outs, _ = assign.fcos_assign(
            boxes, labels, valid, img_dim=img, num_classes=nc
        )
        return outs

    loss_fn = functools.partial(det_losses.fcos_loss, reg_type=args.reg_type)
    hook = fcos_eval_hook(nc, dataset.id_to_label) if cfg.dump_visuals else None
    return fit(cfg, model, dataset, assign_fn, loss_fn, eval_hook=hook)


if __name__ == "__main__":
    main()
