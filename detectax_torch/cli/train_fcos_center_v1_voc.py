"""Train FCOS-center v1 (YOLO-style centroid assignment, sigmoid reg) —
port of `detectax/cli/train_fcos_center_v1_voc.py`.

Reference config: box scales ``[32, 64, 128, 256, img_dims]``, SGD
momentum 0.9, init_lr 0.01 (exponential decay), 384 px, stretch resize;
focal on both the centerness and the classes (ten focal segments a step,
one forward and one backward launch of the focal kernel on a CUDA device),
masked smooth-L1 on the regression.

    python -m detectax_torch.cli.train_fcos_center_v1_voc --max_steps 100 \\
        [--dataset detbench] [--device cpu]
"""
from __future__ import annotations

import argparse

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
    add_train_args(p, canvas=384, batch_size=16, init_lr=0.01,
                   backbone="resnet50", max_steps=20000)
    args = p.parse_args(argv)
    resolve_device(args.device)  # fail before any work without a device

    dataset = dataset_from_args(args)
    nc = dataset.num_classes
    model = FCOS(num_classes=nc, variant="center_v1",
                 backbone=args.backbone, freeze_bn=args.freeze_bn,
                 dtype=compute_dtype(args))
    cfg = config_from_args(
        args,
        optimizer="sgd",
        schedule="exponential",
        schedule_kwargs={"init_lr": args.init_lr},
        resize_mode="stretch",
    )
    img = (cfg.canvas, cfg.canvas)

    def assign_fn(boxes, labels, valid):
        outs, _ = assign.fcos_center_v1_assign(
            boxes, labels, valid, img_dim=img, num_classes=nc
        )
        return outs

    def loss_fn(y_true, y_pred):
        # v1: focal on cen AND cls, masked smooth-L1 on reg
        return det_losses.fcos_loss(
            y_true, y_pred, reg_type="l1", cen_type="focal"
        )

    hook = fcos_eval_hook(nc, dataset.id_to_label) if cfg.dump_visuals else None
    return fit(cfg, model, dataset, assign_fn, loss_fn, eval_hook=hook)


if __name__ == "__main__":
    main()
