"""Train the hourglass CenterNet — port of
`detectax/cli/train_hourglass_voc.py`.

Defaults: batch 96 in microbatches of 2, Adam with the epoch-decay
schedule, ``n_filters 12``, 320 px (canvases round up to multiples of 64
for the six-stage encoder) with a continuous 0.6-1.0x content-scale
jitter and centre padding, the hourglass photometric / geometric augment,
four size bins ``canvas / 2^x``, a sigmoid or focal class loss with
``reg_lambda 0.10``. ``--variant stacked`` trains `StackedHourglass`
instead: one stride-4 map, centroid assignment, focal + smooth-L1.
``--multi_scale`` trains on discrete canvas buckets (one a batch; the
assignment's scales follow each bucket) in place of the jitter.

    python -m detectax_torch.cli.train_hourglass_voc --max_steps 100 \\
        [--variant stacked --n_filters 64 --n_stacks 2] [--device cpu]

On a CUDA device the focal terms run the hand-written focal kernel; there
is no switch for it.
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
from detectax_torch.models import HourglassNet, StackedHourglass
from detectax_torch.ops import assign
from detectax_torch.runtime import resolve_device
from detectax_torch.train import losses as det_losses
from detectax_torch.train.driver import fit


def _round64(c: int) -> int:
    return ((c + 63) // 64) * 64


def main(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    add_train_args(p, canvas=320, batch_size=96, init_lr=1e-3,
                   max_steps=10000, microbatch=2)
    p.add_argument("--n_filters", type=int, default=12)
    p.add_argument(
        "--variant", choices=("hourglass", "stacked"), default="hourglass",
        help="'stacked' trains models.StackedHourglass: single stride-4 "
             "map, centroid assignment, focal + smooth-L1",
    )
    p.add_argument("--n_stacks", type=int, default=1,
                   help="stacked variant: number of hourglass stacks")
    p.add_argument("--loss_type", choices=("sigmoid", "focal"),
                   default="sigmoid")
    p.add_argument("--reg_lambda", type=float, default=0.10)
    p.add_argument("--lr_decay", type=float, default=0.90)
    p.add_argument("--steps_per_epoch", type=int, default=500)
    p.add_argument(
        "--multi_scale", type=int, nargs="+", default=None,
        help="discrete canvas buckets, e.g. 256 320 384 448; one bucket is "
             "chosen per batch",
    )
    args = p.parse_args(argv)
    if args.dump_visuals:
        raise NotImplementedError(
            "--dump_visuals: this trainer has no visual hook (neither has "
            "the JAX package's)")
    resolve_device(args.device)  # fail before any work without a device

    canvas = _round64(args.canvas)
    args.canvas = canvas
    buckets = ([_round64(c) for c in args.multi_scale]
               if args.multi_scale else None)

    dataset = dataset_from_args(args)
    nc = dataset.num_classes
    dtype = compute_dtype(args)
    if args.variant == "stacked":
        model = StackedHourglass(num_classes=nc, n_filters=args.n_filters,
                                 n_stacks=args.n_stacks, dtype=dtype)
    else:
        model = HourglassNet(num_classes=nc, n_filters=args.n_filters,
                             dtype=dtype)
    cfg = config_from_args(
        args,
        optimizer="adam",
        schedule="epoch",
        schedule_kwargs={
            "init_lr": args.init_lr,
            "decay": args.lr_decay,
            "steps_per_epoch": args.steps_per_epoch,
        },
        pad_position="center",
        augment="hourglass",
        jitter=(0.6 * canvas, canvas),
    )
    if buckets:
        cfg.canvas = buckets
        cfg.jitter = None  # discrete buckets replace continuous jitter

    if args.variant == "stacked":
        stride = model.output_stride

        def assign_fn(boxes, labels, valid, img_hw):
            out, _ = assign.stacked_hourglass_assign(
                boxes, labels, valid, img_dim=tuple(img_hw),
                num_classes=nc, stride=stride,
            )
            return out

        loss_fn = det_losses.stacked_hourglass_loss
    else:
        def assign_fn(boxes, labels, valid, img_hw):
            # the scale bins follow the (per-bucket) canvas
            scales = tuple(img_hw[0] / (2.0 ** x) for x in reversed(range(4)))
            out, _ = assign.hourglass_assign(
                boxes, labels, valid, img_dim=tuple(img_hw), num_classes=nc,
                box_scales=scales,
            )
            return out

        loss_fn = functools.partial(
            det_losses.hourglass_loss,
            loss_type=args.loss_type, reg_lambda=args.reg_lambda,
        )
    return fit(cfg, model, dataset, assign_fn, loss_fn)


if __name__ == "__main__":
    main()
