"""Shared CLI plumbing for the train entry points.

Port of `detectax/cli/_common.py`: the same flags and defaults, plus
``--device``.
"""
from __future__ import annotations

import argparse

import torch

from detectax_torch.train.driver import TrainConfig


def add_train_args(p: argparse.ArgumentParser, **defaults):
    d = lambda k, v: defaults.get(k, v)
    p.add_argument("--index", default=d("index", None),
                   help="dataset index json (default: synthetic dataset)")
    p.add_argument("--dataset",
                   choices=("synthetic", "detbench", "detbench_v2",
                            "detbench_v2_crowd"),
                   default=d("dataset", "synthetic"),
                   help="built-in dataset when --index is not given: "
                        "'synthetic' (smoke) or a DetBench split "
                        "(benchmarks/detbench_v1/v2/v2_crowd .json, or the "
                        "built-in specs where that directory is absent)")
    p.add_argument("--synthetic_n", type=int, default=d("synthetic_n", 128),
                   help="synthetic dataset size when --index is not given")
    p.add_argument("--batch_size", type=int, default=d("batch_size", 16))
    p.add_argument("--canvas", type=int, default=d("canvas", 384))
    p.add_argument("--max_boxes", type=int, default=d("max_boxes", 64))
    p.add_argument("--max_steps", type=int, default=d("max_steps", 20000))
    p.add_argument("--backbone", default=d("backbone", "resnet50"))
    p.add_argument("--init_lr", type=float, default=d("init_lr", 5e-4))
    p.add_argument("--loss_norm", choices=("batch", "pos"),
                   default=d("loss_norm", "batch"),
                   help="'batch': divide summed losses by batch size "
                        "(reference parity); 'pos': divide by positive-cell "
                        "count (FCOS-paper convention — use for "
                        "from-scratch training)")
    p.add_argument("--warmup_steps", type=int, default=d("warmup_steps", 0),
                   help="linear LR warmup steps (0 = off)")
    p.add_argument("--grad_clip", type=float, default=d("grad_clip", 1.0),
                   help="global-norm gradient clip (reference default 1.0; "
                        "raise for from-scratch pos-normalized training)")
    p.add_argument("--optimizer", choices=("sgd", "adam", "adamw"),
                   default=None,
                   help="override the family's reference optimizer "
                        "(default: whatever the mirrored trainer used)")
    p.add_argument("--ema_decay", type=float, default=d("ema_decay", 0.0),
                   help="parameter EMA decay (e.g. 0.999; 0 = off); "
                        "averaged weights saved in the checkpoint")
    p.add_argument("--microbatch", type=int, default=d("microbatch", None))
    p.add_argument("--ckpt_dir", default=d("ckpt_dir", "ckpt"))
    p.add_argument("--out_dir", default=d("out_dir", "outputs"))
    p.add_argument("--display_step", type=int, default=d("display_step", 50))
    p.add_argument("--step_save", type=int, default=d("step_save", 500))
    p.add_argument("--resume", action="store_true")
    p.add_argument("--dump_visuals", action="store_true",
                   help="write pred heatmap + overlay jpgs on display "
                        "steps (needs matplotlib; raises at start-up "
                        "without it)")
    p.add_argument("--seed", type=int, default=d("seed", 0))
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 compute (parameters stay float32)")
    p.add_argument("--init_backbone", default=d("init_backbone", None),
                   help="backbone weights to initialize from: the "
                        "port's .npz (detectax_torch.tools.from_flax."
                        "save_npz) or a Flax .msgpack of the JAX package "
                        "(benchmarks/runs/pretrain_r50/backbone.msgpack). "
                        "Pair with a compat backbone name "
                        "(--backbone resnet50:keras / resnext50:torch) so "
                        "the trunk geometry matches the ported zoo exactly")
    p.add_argument("--freeze_bn", action="store_true",
                   help="freeze backbone BatchNorm statistics during "
                        "training (best with pretrained backbones)")
    p.add_argument("--profile_steps", type=int, nargs=2, default=None,
                   metavar=("START", "STOP"),
                   help="capture a torch.profiler trace over this step "
                        "range")
    p.add_argument("--debug_nans", action="store_true",
                   help="enable autograd anomaly detection (fail fast on "
                        "NaN)")
    p.add_argument("--device", default=d("device", None),
                   help="torch device (default: cuda; no CPU fallback)")
    return p


def compute_dtype(args) -> torch.dtype:
    """The model's compute dtype: bfloat16 under ``--bf16`` (as the JAX
    trainers build their model with ``dtype=jnp.bfloat16``), else
    float32. The parameters, the checkpoint and the driver stay float32."""
    return torch.bfloat16 if args.bf16 else torch.float32


def dataset_from_args(args, split: str = "train"):
    if args.index:
        from detectax_torch.data.index import IndexDataset

        return IndexDataset(args.index)
    name = getattr(args, "dataset", "synthetic")
    if name.startswith("detbench"):
        from detectax_torch.data.detbench import DetBenchDataset, load_spec

        # sizes come from the committed spec for the selected benchmark
        return DetBenchDataset(split, spec=load_spec(name=name))
    from detectax_torch.data.synthetic import SyntheticDataset

    return SyntheticDataset(n=args.synthetic_n, img_size=args.canvas)


def config_from_args(args, **overrides) -> TrainConfig:
    cfg = TrainConfig(
        index=args.index,
        batch_size=args.batch_size,
        canvas=args.canvas,
        max_boxes=args.max_boxes,
        max_steps=args.max_steps,
        microbatch=args.microbatch,
        ckpt_dir=args.ckpt_dir,
        out_dir=args.out_dir,
        display_step=args.display_step,
        step_save=args.step_save,
        resume=args.resume,
        dump_visuals=args.dump_visuals,
        seed=args.seed,
        profile_steps=(
            tuple(args.profile_steps) if args.profile_steps else None
        ),
        debug_nans=args.debug_nans,
        init_backbone=args.init_backbone,
        loss_norm=args.loss_norm,
        warmup_steps=args.warmup_steps,
        grad_clip=args.grad_clip,
        ema_decay=args.ema_decay,
        device=args.device,
    )
    for k, v in overrides.items():
        setattr(cfg, k, v)
    # --optimizer wins over the trainer's reference default
    if getattr(args, "optimizer", None):
        cfg.optimizer = args.optimizer
    return cfg
