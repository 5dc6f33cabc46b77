"""Train RetinaNet — port of `detectax/cli/train_retinanet_coco.py`.

Reference config: anchor sizes (20, 40, 80, 160, 320), 512 px stretched
(no letterbox), ResNet-101, batch 16, piecewise LR 0.01 -> /10 at 60,000
steps, SGD momentum, 90,000 steps.

    python -m detectax_torch.cli.train_retinanet_coco --max_steps 100 \\
        [--dataset detbench_v2 --backbone mobilenetv2] [--bf16] \\
        [--device cpu]

``--skip_zero_target`` (on by default) drops, once and up front, every
image whose anchor assignment gives no positive in either flip
orientation (`ops.anchors.has_anchor_targets_np`), and prints how many it
dropped. On a CUDA device the classification loss runs the hand-written
focal kernel, all five levels in one launch each way.
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
from detectax_torch.cli._eval_hooks import retinanet_eval_hook
from detectax_torch.models import RetinaNet
from detectax_torch.ops import anchors as anchor_lib
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
                   backbone="resnet101", max_steps=90000)
    p.add_argument("--anchor_sizes", type=float, nargs="+",
                   default=[20.0, 40.0, 80.0, 160.0, 320.0])
    p.add_argument("--iou_thresh", type=float, default=0.5)
    p.add_argument("--lr_boundaries", type=int, nargs="+", default=[60000])
    p.add_argument("--per_anchor_heads", action="store_true",
                   help="the reference's 90 separate head convs (slower)")
    p.add_argument("--skip_zero_target",
                   action=argparse.BooleanOptionalAction, default=True,
                   help="exclude images whose anchor assignment yields no "
                        "positives, filtered once up front (stretch "
                        "geometry makes the assignment deterministic)")
    args = p.parse_args(argv)
    resolve_device(args.device)  # fail before any work without a device

    dataset = dataset_from_args(args)
    if args.skip_zero_target:
        from detectax_torch.data.index import SubsetDataset

        keep = [
            i for i in range(len(dataset))
            if anchor_lib.has_anchor_targets_np(
                dataset[i]["boxes_xyxy"], (args.canvas, args.canvas),
                anchor_sizes=args.anchor_sizes,
                iou_thresh=args.iou_thresh,
            )
        ]
        dropped = len(dataset) - len(keep)
        if dropped:
            print(f"skip_zero_target: excluded {dropped}/{len(dataset)} "
                  "images with no anchor matches")
        if not keep:
            raise SystemExit("skip_zero_target removed every image — "
                             "check anchor_sizes vs object scales")
        dataset = SubsetDataset(dataset, keep)
    nc = dataset.num_classes
    anchors = anchor_lib.anchor_shapes_per_level(
        anchor_sizes=args.anchor_sizes)
    model = RetinaNet(
        num_classes=nc, n_anchors=anchors[0].shape[0],
        backbone=args.backbone, per_anchor_heads=args.per_anchor_heads,
        freeze_bn=args.freeze_bn, dtype=compute_dtype(args),
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
        resize_mode="stretch",
    )
    img = (cfg.canvas, cfg.canvas)

    def assign_fn(boxes, labels, valid):
        outs, _ = assign.retinanet_assign(
            boxes, labels, valid, img_dim=img, num_classes=nc,
            anchors_per_level=anchors, iou_thresh=args.iou_thresh,
        )
        return outs

    loss_fn = functools.partial(det_losses.retinanet_loss)
    hook = (retinanet_eval_hook(anchors, dataset.id_to_label)
            if cfg.dump_visuals else None)
    return fit(cfg, model, dataset, assign_fn, loss_fn, eval_hook=hook)


if __name__ == "__main__":
    main()
