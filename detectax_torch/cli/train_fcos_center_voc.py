"""Train FCOS-center (3x3 center sampling) — port of
`detectax/cli/train_fcos_center_voc.py`.

Reference config: 384 px, fixed-resize path (stretch), Adam, piecewise LR
init until 8k then /10, ``cen_type="focal"`` (the centerness is a focal
term: ten focal segments a step, one forward and one backward launch of
the focal kernel on a CUDA device), centroid-only by default
(``--neighborhood`` assigns the 3x3 neighbourhood).

    python -m detectax_torch.cli.train_fcos_center_voc --max_steps 100 \\
        [--dataset detbench] [--device cpu]
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
    add_train_args(p, canvas=384, batch_size=16, init_lr=1e-3,
                   backbone="resnet50", max_steps=20000)
    p.add_argument("--center_only", action="store_true", default=True)
    p.add_argument("--neighborhood", dest="center_only", action="store_false",
                   help="assign the 3x3 neighborhood instead of centroid only")
    p.add_argument("--lr_boundary", type=int, default=8000)
    args = p.parse_args(argv)
    resolve_device(args.device)  # fail before any work without a device

    dataset = dataset_from_args(args)
    nc = dataset.num_classes
    model = FCOS(num_classes=nc, variant="center", backbone=args.backbone,
                 freeze_bn=args.freeze_bn, dtype=compute_dtype(args))
    cfg = config_from_args(
        args,
        optimizer="adam",
        schedule="piecewise",
        schedule_kwargs={
            "init_lr": args.init_lr,
            "boundaries": [args.lr_boundary],
            "scales": [0.1],
        },
        resize_mode="stretch",
    )
    img = (cfg.canvas, cfg.canvas)

    def assign_fn(boxes, labels, valid):
        outs, _ = assign.fcos_center_assign(
            boxes, labels, valid, img_dim=img, num_classes=nc,
            center_only=args.center_only,
        )
        return outs

    loss_fn = functools.partial(
        det_losses.fcos_loss, reg_type="l1", cen_type="focal"
    )
    hook = fcos_eval_hook(nc, dataset.id_to_label) if cfg.dump_visuals else None
    return fit(cfg, model, dataset, assign_fn, loss_fn, eval_hook=hook)


if __name__ == "__main__":
    main()
