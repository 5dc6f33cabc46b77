"""DetBench driver: train and evaluate every detector family.

Port of `benchmarks/run_detbench.py`. Runs each family's trainer CLI on
the DetBench train split, then `detectax_torch.cli.evaluate` on the eval
split (256 images), and writes the per-family mAP table to
``runs_torch/RESULTS_<bench>.json`` (``RESULTS_detbench_v1.json`` for
v1). Each family runs as a subprocess, so that no CUDA state crosses from
one to the next. A results file that exists already is read first and
its other rows are kept, so a run can resume family by family.

The ``fcos_center`` and ``centernet_s8`` rows start from a crop-pretrained
MobileNetV2 trunk, ``--trunk`` (the port's own from
`detectax_torch.bench.pretrain_backbone` by default; a Flax ``.msgpack``
is read as well). A missing trunk fails those rows as a failed trainer
does; nothing falls back to a random init.

A row can be carried across runs that each stop before it ends. Stopped
by SIGTERM (``timeout``), the driver ends the trainer and writes the row
as ``{"error": "train stopped", "train_min": ...}`` with the newest
checkpoint's step. ``--resume`` then hands the trainers their own
``--resume``: each restarts from its newest checkpoint under the run
directory, and its row's ``train_min`` is the sum over the runs
(``train_min_calls``), and ``restarts`` lists the step of every run's
restart. As in the JAX package, a resumed trainer's loader restarts from
its seed, so every restart below ``--steps`` starts the batch order
again: step r + k sees batch k. ``resumed_from`` is the last such
restart. A run that restores at ``--steps`` trains no step and only
evaluates: it leaves ``resumed_from`` as it was and adds no minutes to
``train_min``. ``--seed N`` hands the trainers ``--seed N``. Neither flag
changes an evaluate argv; a row made with either records its ``seed``.

Usage (a CUDA device; exits 1 without one):
    python -m detectax_torch.bench.run_detbench [--families fcos ...]
        [--bench detbench|detbench_v2|detbench_v2_crowd] [--steps 4000]
        [--trunk runs_torch/pretrain_mbv2/backbone.npz] [--resume]
        [--seed N]
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import time
from typing import Callable

from detectax_torch.bench._common import require_cuda
from detectax_torch.train.checkpoint import CheckpointManager

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
RUNS = os.path.join(REPO, "runs_torch")
DEFAULT_TRUNK = os.path.join(RUNS, "pretrain_mbv2", "backbone.npz")
# where a family's arguments take the trunk
TRUNK = "<trunk>"

# Per-family training configurations, the JAX driver's: canvases and
# optimizers follow the reference trainers; steps and learning rates are
# sized for training on DetBench without ImageNet weights.
FAMILIES = {
    "fcos": {
        "train": "detectax_torch.cli.train_fcos",
        "args": ["--canvas", "384", "--init_lr", "0.01",
                 "--decay_steps", "4000"],
    },
    "fcos_center": {
        # sparse decayed-score supervision floors from a random init, so
        # the family is benchmarked from the crop-pretrained trunk with a
        # fine-tuning learning rate and frozen BatchNorm
        "train": "detectax_torch.cli.train_fcos_center_voc",
        "args": ["--canvas", "384", "--optimizer", "sgd",
                 "--init_lr", "0.001", "--lr_boundary", "3000",
                 "--warmup_steps", "100", "--freeze_bn",
                 "--init_backbone", TRUNK],
    },
    "fcos_center_v1": {
        "train": "detectax_torch.cli.train_fcos_center_v1_voc",
        "args": ["--canvas", "384", "--init_lr", "0.01"],
    },
    "centernet_s8": {
        # centroid-only point supervision does not leave the focal bias
        # from a random init: the reference's own operating point, a
        # pretrained trunk, lr 1e-3 and frozen BatchNorm
        "train": "detectax_torch.cli.train_centernet_crowdhuman",
        "args": ["--canvas", "512", "--init_lr", "0.001",
                 "--lr_boundaries", "3000", "3500", "--warmup_steps", "100",
                 "--freeze_bn", "--init_backbone", TRUNK],
    },
    "centernet_heatmap": {
        "train": "detectax_torch.cli.train_centernet_heatmap",
        "args": ["--canvas", "384", "--optimizer", "sgd",
                 "--init_lr", "0.01"],
    },
    "hourglass": {
        # a fixed architecture (no backbone); the reference's Adam
        "train": "detectax_torch.cli.train_hourglass_voc",
        "args": ["--canvas", "320", "--batch_size", "32",
                 "--n_filters", "12", "--steps_per_epoch", "1000",
                 "--init_lr", "1e-3"],
        "eval_extra": ["--n_filters", "12"],
    },
    "retinanet": {
        "train": "detectax_torch.cli.train_retinanet_coco",
        "args": ["--canvas", "512", "--init_lr", "0.01",
                 "--lr_boundaries", "3000"],
    },
    "stacked_hourglass": {
        # true stride-4 single map, centroid-only assignment, focal +
        # smooth-L1, trained through the hourglass CLI's --variant stacked
        "train": "detectax_torch.cli.train_hourglass_voc",
        "args": ["--canvas", "320", "--batch_size", "16",
                 "--variant", "stacked", "--n_filters", "64",
                 "--n_stacks", "2", "--steps_per_epoch", "1000",
                 "--init_lr", "1e-3"],
        "eval_extra": ["--n_filters", "64", "--n_stacks", "2"],
    },
}

# The dense-crowd split (640 px source, 48-128 objects an image) follows
# the reference's CrowdHuman configuration: 640 canvas, a per-batch
# content scale for CenterNetS8, K = 2,048 at evaluation. The hourglass
# families keep their 320 canvas.
CROWD_TRAIN_OVERRIDES = {
    "centernet_s8": ["--canvas", "640", "--use_scale",
                     "--min_scale", "0.7", "--base_dims", "448"],
    "retinanet": ["--canvas", "640"],
    "fcos": ["--canvas", "640"],
    "centernet_heatmap": ["--canvas", "640"],
}
# the evaluation canvas of the crowd split: the family's training canvas
CROWD_EVAL_OVERRIDES = {
    None: ["--canvas", "640", "--top_k", "2048"],
    "hourglass": ["--canvas", "320", "--top_k", "2048"],
    "stacked_hourglass": ["--canvas", "320", "--top_k", "2048"],
}

# Training without ImageNet weights: positive-count loss normalization,
# linear warmup and a clip sized for its gradients; a family's own
# arguments come after and override.
FROM_SCRATCH_ARGS = [
    "--loss_norm", "pos", "--warmup_steps", "300", "--grad_clip", "16",
]

Runner = Callable[[list, str], int]


class Stopped(Exception):
    """The driver was asked to stop (SIGTERM) while a family ran."""


def _stop(signum, frame):
    raise Stopped(signum)


def run(cmd: list, log_path: str) -> int:
    """Run ``cmd`` from the repository root, its output appended to
    ``log_path``; returns its exit code."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    with open(log_path, "a") as log:
        log.write("\n$ " + " ".join(cmd) + "\n")
        log.flush()
        return subprocess.run(
            cmd, cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT
        ).returncode


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--families", nargs="+", default=list(FAMILIES),
                   choices=list(FAMILIES))
    p.add_argument("--bench", default="detbench",
                   choices=("detbench", "detbench_v2", "detbench_v2_crowd"),
                   help="which committed benchmark spec to train and "
                        "evaluate on; other than v1, runs go to "
                        "runs_torch/detbench_<suffix>/ and "
                        "RESULTS_<bench>.json")
    p.add_argument("--steps", type=int, default=4000)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--backbone", default="mobilenetv2",
                   help="MobileNetV2 by default (the reference FCOS "
                        "inference backbone): ResNet-50 from a random init "
                        "needs far more steps to leave the focal bias")
    p.add_argument("--bf16", action=argparse.BooleanOptionalAction,
                   default=True)
    p.add_argument("--trunk", default=DEFAULT_TRUNK,
                   help="crop-pretrained trunk (.npz or Flax .msgpack) for "
                        "the fcos_center and centernet_s8 rows")
    p.add_argument("--resume", action="store_true",
                   help="hand each trainer --resume: it restarts from its "
                        "newest checkpoint, and the row's train_min adds "
                        "this run's minutes to the stopped run's")
    p.add_argument("--seed", type=int, default=None,
                   help="hand each trainer --seed N (the trainers' "
                        "default 0 otherwise)")
    p.add_argument("--run_root", default=os.path.join(RUNS, "detbench"))
    p.add_argument("--out", default=os.path.join(
        RUNS, "RESULTS_detbench_v1.json"))
    args = p.parse_args(argv)
    if args.bench != "detbench":
        suffix = args.bench.replace("detbench_", "")
        if args.run_root == os.path.join(RUNS, "detbench"):
            args.run_root = os.path.join(RUNS, f"detbench_{suffix}")
        if args.out == os.path.join(RUNS, "RESULTS_detbench_v1.json"):
            args.out = os.path.join(RUNS, f"RESULTS_{args.bench}.json")
    args.trunk = os.path.abspath(args.trunk)
    return args


def family_commands(fam: str, args) -> tuple[list, list]:
    """(train argv, evaluate argv) of one family, each starting with the
    interpreter."""
    cfg = FAMILIES[fam]
    fam_dir = os.path.join(args.run_root, fam)
    ckpt_dir = os.path.join(fam_dir, "ckpt")
    train_cmd = [
        sys.executable, "-u", "-m", cfg["train"],
        "--dataset", args.bench,
        "--max_steps", str(args.steps),
        "--backbone", args.backbone,
        "--ckpt_dir", ckpt_dir,
        "--out_dir", os.path.join(fam_dir, "out"),
        "--display_step", "100",
        "--step_save", "1000",
        *FROM_SCRATCH_ARGS,
        *[args.trunk if a == TRUNK else a for a in cfg["args"]],
    ]
    if "--batch_size" not in cfg["args"]:
        train_cmd += ["--batch_size", str(args.batch_size)]
    if args.bench == "detbench_v2_crowd":
        # the dense-crowd split: up to 128 objects an image
        train_cmd += ["--max_boxes", "128"]
        train_cmd += CROWD_TRAIN_OVERRIDES.get(fam, [])
    if args.bf16:
        train_cmd.append("--bf16")
    if args.resume:
        train_cmd.append("--resume")
    if args.seed is not None:
        train_cmd += ["--seed", str(args.seed)]
    eval_cmd = [
        sys.executable, "-u", "-m", "detectax_torch.cli.evaluate",
        "--family", fam,
        "--dataset", args.bench,
        "--backbone", args.backbone,
        "--ckpt_dir", ckpt_dir,
        "--coco_metrics",
        "--out_json", os.path.join(fam_dir, "eval.json"),
        *cfg.get("eval_extra", []),
    ]
    if args.bench == "detbench_v2_crowd":
        eval_cmd += ["--max_boxes", "128", "--max_outputs", "200"]
        eval_cmd += CROWD_EVAL_OVERRIDES.get(
            fam, CROWD_EVAL_OVERRIDES[None])
    return train_cmd, eval_cmd


def run_families(args, runner: Runner = run) -> dict:
    """Train and evaluate ``args.families`` one after another through
    ``runner(argv, log_path) -> exit code``, writing the results file
    after each family; returns the results. A `Stopped` raised while a
    family runs writes its row as stopped and is raised again."""
    results = {}
    if os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)

    for fam in args.families:
        fam_dir = os.path.join(args.run_root, fam)
        os.makedirs(fam_dir, exist_ok=True)
        log_path = os.path.join(fam_dir, "log.txt")
        ckpt_dir = os.path.join(fam_dir, "ckpt")
        train_cmd, eval_cmd = family_commands(fam, args)
        calls = []      # the minutes of the runs this one resumes
        trains = True
        carried = {}
        if args.resume or args.seed is not None:
            carried["seed"] = args.seed or 0
        if args.resume:
            prior = results.get(fam, {})
            calls = prior.get("train_min_calls", [prior["train_min"]]
                              if "train_min" in prior else [])
            step = CheckpointManager(ckpt_dir).latest_step()
            if step is not None:
                carried["restarts"] = prior.get(
                    "restarts", [prior["resumed_from"]]
                    if "resumed_from" in prior else []) + [step]
                # restored at --steps, the trainer takes no step and its
                # loader's restart orders no batch
                trains = step < args.steps
                if trains:
                    carried["resumed_from"] = step
                elif "resumed_from" in prior:
                    carried["resumed_from"] = prior["resumed_from"]

        def total(train_min):
            done = calls + [round(train_min, 1)] if trains else calls
            split = {"train_min_calls": done} if len(done) > 1 else {}
            return round(sum(done), 1), split

        t0 = time.time()
        train_min = None
        try:
            # the hourglass families have no --backbone-driven architecture
            print(f"[{fam}] training {args.steps} steps ...", flush=True)
            rc = runner(train_cmd, log_path)
            train_min = (time.time() - t0) / 60
            if rc != 0:
                print(f"[{fam}] TRAIN FAILED rc={rc} (see {log_path})",
                      flush=True)
                results[fam] = {"error": f"train rc={rc}"}
                _write(args.out, results)
                continue

            eval_json = os.path.join(fam_dir, "eval.json")
            print(f"[{fam}] evaluating ...", flush=True)
            rc = runner(eval_cmd, log_path)
        except Stopped:
            minutes, split = total(
                train_min if train_min is not None
                else (time.time() - t0) / 60)
            results[fam] = {
                "error": "train stopped" if train_min is None
                else "eval stopped",
                "train_min": minutes, **split,
                "checkpoint_step": CheckpointManager(ckpt_dir).latest_step(),
                **carried}
            print(f"[{fam}] STOPPED after {minutes:.1f} min of training",
                  flush=True)
            _write(args.out, results)
            raise
        if rc != 0 or not os.path.exists(eval_json):
            print(f"[{fam}] EVAL FAILED rc={rc} (see {log_path})",
                  flush=True)
            results[fam] = {"error": f"eval rc={rc}", "train_min": train_min}
            _write(args.out, results)
            continue
        with open(eval_json) as f:
            summary = json.load(f)
        summary["train_steps"] = args.steps
        summary["train_min"], split = total(train_min)
        summary.update(split)
        summary["backbone"] = args.backbone
        summary.update(carried)
        results[fam] = summary
        print(f"[{fam}] mAP@0.5={summary.get('mAP@0.5'):.4f} "
              f"({summary['train_min']:.1f} min train)", flush=True)
        _write(args.out, results)

    print(json.dumps(results, indent=2))
    return results


def _write(path, results):
    with open(path, "w") as f:
        json.dump(results, f, indent=2)


def main(argv=None) -> dict:
    args = parse_args(argv)
    require_cuda("detectax_torch.bench.run_detbench")
    signal.signal(signal.SIGTERM, _stop)
    try:
        return run_families(args)
    except Stopped:
        raise SystemExit(128 + signal.SIGTERM)


if __name__ == "__main__":
    main()
