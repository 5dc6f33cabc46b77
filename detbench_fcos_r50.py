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
--coco_metrics`.

    python3 detbench_fcos_r50.py --out DIR [--max_steps 3000] \
        [--loss_norm pos|batch] [--grad_clip 16]

Writes ``DIR/result.json`` (the card, the wall times, the losses of every
display step and the eval summary) and ``DIR/train.log``; the checkpoint
and the DetBench cache go to a temporary directory that is removed at the
end unless ``--keep``. Runs on one CUDA device.
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


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--max_steps", type=int, default=3000)
    p.add_argument("--out", required=True,
                   help="directory for result.json, train.log, the loss "
                        "logs and eval.json")
    p.add_argument("--loss_norm", choices=("pos", "batch"), default="pos")
    p.add_argument("--grad_clip", type=float, default=16.0)
    p.add_argument("--keep", action="store_true",
                   help="keep the checkpoint and cache directory")
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("detbench_fcos_r50.py needs a CUDA device")
    if not os.path.exists(TRUNK):
        raise SystemExit(f"the pretrained trunk {TRUNK} is missing")
    sys.path.insert(0, ROOT)
    from detectax_torch.cli import evaluate, train_fcos

    os.makedirs(args.out, exist_ok=True)
    work = tempfile.mkdtemp(prefix="detbench_fcos_r50_")
    os.environ.setdefault("DETECTAX_DETBENCH_CACHE",
                          os.path.join(work, "cache"))
    ckpt = os.path.join(work, "ckpt")
    result = {"card": card(), "torch": torch.__version__,
              "cuda": torch.version.cuda, "max_steps": args.max_steps,
              "loss_norm": args.loss_norm, "grad_clip": args.grad_clip}
    log = open(os.path.join(args.out, "train.log"), "w")
    try:
        with contextlib.redirect_stdout(_Tee(sys.stdout, log)):
            t0 = time.time()
            from detectax_torch.data.detbench import DetBenchDataset

            DetBenchDataset("train")  # fill the cache before the clock
            DetBenchDataset("eval")
            result["cache_s"] = time.time() - t0
            t1 = time.time()
            summary = train_fcos.main([
                "--dataset", "detbench", "--canvas", "384",
                "--batch_size", "16", "--max_steps", str(args.max_steps),
                "--init_lr", "3e-3", "--decay_steps", "3000",
                "--freeze_bn", "--init_backbone", TRUNK,
                "--loss_norm", args.loss_norm,
                "--grad_clip", str(args.grad_clip),
                "--display_step", "100", "--step_save", "1000",
                "--ckpt_dir", ckpt, "--out_dir", args.out,
            ])
            result["train_s"] = time.time() - t1
            result["train"] = summary
            t2 = time.time()
            result["eval"] = evaluate.main([
                "--family", "fcos", "--dataset", "detbench",
                "--coco_metrics", "--ckpt_dir", ckpt,
                "--out_json", os.path.join(args.out, "eval.json"),
            ])
            result["eval_s"] = time.time() - t2
            result["wall_s"] = time.time() - t0
    finally:
        log.close()
        if not args.keep:
            shutil.rmtree(work, ignore_errors=True)
    with open(os.path.join(args.out, "metrics.jsonl")) as f:
        result["losses"] = [json.loads(line) for line in f]
    with open(os.path.join(args.out, "result.json"), "w") as f:
        json.dump(result, f, indent=1)
    keep = {k: result[k] for k in ("card", "cache_s", "train_s", "eval_s",
                                   "wall_s")}
    keep["mAP@0.5"] = result["eval"]["mAP@0.5"]
    keep["mAP@[.5:.95]"] = result["eval"]["mAP@[.5:.95]"]
    print(json.dumps(keep))


if __name__ == "__main__":
    main()
