"""FCOS-R50 on DetBench v1: train with the recipe of the JAX package's
ported-init row, then evaluate on the 256-image eval split.

The recipe (`BASELINE.md`, "FCOS-ResNet-50 ported-init row"): 384 px,
batch 16, `--freeze_bn`, the crop-pretrained trunk
`benchmarks/runs/pretrain_r50/backbone.msgpack`, SGD-momentum at 3e-3
decaying by 0.75 over the 3,000 steps (the per-100-step `lr` of
`benchmarks/runs/fcos_r50_pretrain_ft/log.txt`, which also shows no
warmup), float32 with TF32 off; the losses divided by the batch's positive
cells and the gradient clipped at global norm 16, the DetBench recipe of
`benchmarks/run_detbench.py` (`FROM_SCRATCH_ARGS`) — the scale of that
log's losses (total 2.28 at step 100 over 514 positives) is that of
`--loss_norm pos`. Then `cli.evaluate --family fcos --dataset detbench
--coco_metrics`. ``--bf16`` trains with bf16 compute, as the TPU row did
(its log's command line ends in ``--bf16``).

    python3 detbench_fcos_r50.py --out DIR [--max_steps 3000] [--bf16] \
        [--loss_norm pos|batch] [--grad_clip 16] [--trunk T] [--seed 0]

``--trunk`` takes another crop-pretrained ResNet-50 trunk (the port's own
``.npz`` from `detectax_torch.bench.pretrain_backbone --backbone
resnet50`, or a Flax ``.msgpack``); the TPU row's by default. ``--seed``
goes to the trainer's ``--seed`` (the heads' init and the loader's order;
0, the TPU row's, by default), so that rows at two seeds give the spread
of the detection training alone.

Writes ``DIR/result.json`` (the card, the wall times, the losses of every
display step and the eval summary) and ``DIR/train.log``; the checkpoint
and the DetBench cache go to a temporary directory that is removed at the
end unless ``--keep``. Runs on one CUDA device. `run` is the scaffolding:
the cache, the trainer, the evaluation and the result file.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
TRUNK = os.path.join(ROOT, "benchmarks", "runs", "pretrain_r50",
                     "backbone.msgpack")


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


class _Tee(io.TextIOBase):
    def __init__(self, *streams):
        self.streams = streams

    def write(self, s):
        for st in self.streams:
            st.write(s)
            st.flush()
        return len(s)


def run(out: str, *, name: str, dataset: str, train, evaluate_argv,
        result: dict, keep: bool = False) -> dict:
    """Fill the DetBench cache of ``dataset``, call ``train(ckpt_dir,
    out_dir)`` (a trainer CLI's ``main``; its summary), then `cli.evaluate`
    with ``evaluate_argv`` on the checkpoint; the console goes to
    ``out/train.log`` too. Adds the wall times, the summaries and the
    losses of every display step to ``result`` and writes it to
    ``out/result.json``."""
    import torch

    if not torch.cuda.is_available():
        raise SystemExit(f"{name} needs a CUDA device")
    sys.path.insert(0, ROOT)
    from detectax_torch.cli import evaluate
    from detectax_torch.data.detbench import DetBenchDataset, load_spec

    os.makedirs(out, exist_ok=True)
    work = tempfile.mkdtemp(prefix=f"{name}_")
    os.environ.setdefault("DETECTAX_DETBENCH_CACHE",
                          os.path.join(work, "cache"))
    ckpt = os.path.join(work, "ckpt")
    result = {"card": card(), "torch": torch.__version__,
              "cuda": torch.version.cuda, **result}
    log = open(os.path.join(out, "train.log"), "w")
    try:
        with contextlib.redirect_stdout(_Tee(sys.stdout, log)):
            t0 = time.time()
            spec = load_spec(name=dataset)
            DetBenchDataset("train", spec=spec)  # fill the cache first
            DetBenchDataset("eval", spec=spec)
            result["cache_s"] = time.time() - t0
            t1 = time.time()
            result["train"] = train(ckpt, out)
            result["train_s"] = time.time() - t1
            t2 = time.time()
            result["eval"] = evaluate.main([
                *evaluate_argv, "--ckpt_dir", ckpt,
                "--out_json", os.path.join(out, "eval.json"),
            ])
            result["eval_s"] = time.time() - t2
            result["wall_s"] = time.time() - t0
    finally:
        log.close()
        if not keep:
            shutil.rmtree(work, ignore_errors=True)
    with open(os.path.join(out, "metrics.jsonl")) as f:
        result["losses"] = [json.loads(line) for line in f]
    with open(os.path.join(out, "result.json"), "w") as f:
        json.dump(result, f, indent=1)
    short = {k: result[k] for k in ("card", "cache_s", "train_s", "eval_s",
                                    "wall_s")}
    short["mAP@0.5"] = result["eval"]["mAP@0.5"]
    short["mAP@[.5:.95]"] = result["eval"]["mAP@[.5:.95]"]
    print(json.dumps(short))
    return result


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--max_steps", type=int, default=3000)
    p.add_argument("--out", required=True,
                   help="directory for result.json, train.log, the loss "
                        "logs and eval.json")
    p.add_argument("--loss_norm", choices=("pos", "batch"), default="pos")
    p.add_argument("--grad_clip", type=float, default=16.0)
    p.add_argument("--bf16", action="store_true",
                   help="bf16 compute (the TPU row's); float32 otherwise")
    p.add_argument("--keep", action="store_true",
                   help="keep the checkpoint and cache directory")
    p.add_argument("--trunk", default=TRUNK,
                   help="the crop-pretrained trunk (.npz or Flax .msgpack)")
    p.add_argument("--seed", type=int, default=0,
                   help="the trainer's --seed")
    args = p.parse_args(argv)
    if not os.path.exists(args.trunk):
        raise SystemExit(f"the pretrained trunk {args.trunk} is missing")

    def train(ckpt, out):
        from detectax_torch.cli import train_fcos

        return train_fcos.main([
            "--dataset", "detbench", "--canvas", "384",
            "--batch_size", "16", "--max_steps", str(args.max_steps),
            "--init_lr", "3e-3", "--decay_steps", "3000",
            "--freeze_bn", "--init_backbone", args.trunk,
            "--loss_norm", args.loss_norm,
            "--grad_clip", str(args.grad_clip),
            "--display_step", "100", "--step_save", "1000",
            "--ckpt_dir", ckpt, "--out_dir", out,
            "--seed", str(args.seed),
            *(["--bf16"] if args.bf16 else []),
        ])

    return run(args.out, name="detbench_fcos_r50", dataset="detbench",
               train=train,
               evaluate_argv=["--family", "fcos", "--dataset", "detbench",
                              "--coco_metrics"],
               result={"max_steps": args.max_steps,
                       "loss_norm": args.loss_norm,
                       "grad_clip": args.grad_clip, "trunk": args.trunk,
                       "seed": args.seed,
                       "dtype": "bfloat16" if args.bf16 else "float32"},
               keep=args.keep)


if __name__ == "__main__":
    main()
