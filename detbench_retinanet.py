"""RetinaNet-MobileNetV2 on DetBench v2: train with the TPU row's command,
then evaluate on the 256-image eval split.

The command is line 1 of `benchmarks/runs_v2/retinanet/log.txt` (the
JAX package's `cli.train_retinanet_coco`): DetBench v2, 4,000 steps,
MobileNetV2 from a fresh init, losses divided by the positive anchors,
300 warmup steps, clip 16, 512 px, lr 0.01 dropping tenfold at step
3,000, batch 16, bf16 compute; the anchor sizes (20, 40, 80, 160, 320) and
`--skip_zero_target` are the trainer's defaults. Then `cli.evaluate
--family retinanet --dataset detbench_v2 --backbone mobilenetv2
--coco_metrics`. The TPU row's `eval.json` (mAP@0.5 0.8045, AP@[.5:.95]
0.4572) and the losses and `num_pos` its log gives every 100 steps are the
yardsticks: `result.json` holds them beside this run's.

    python3 detbench_retinanet.py --out DIR [--max_steps 4000] [--keep]

Writes ``DIR/result.json`` (the card, the wall times, the losses of every
display step, the eval summary and the yardsticks) and ``DIR/train.log``;
the scaffolding is `detbench_fcos_r50.run`. Runs on one CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os

from detbench_fcos_r50 import ROOT, run
from detbench_logs import display_steps

TPU_RUN = os.path.join(ROOT, "benchmarks", "runs_v2", "retinanet")


def tpu_yardsticks(tpu_run: str = TPU_RUN) -> dict:
    """The TPU row's eval summary and, by step, the losses and `num_pos`
    of its log's first run (a log may hold the same run twice); the row
    is the directory ``tpu_run`` (`log.txt`, `eval.json`)."""
    steps = {step: {k: line[k] for k in ("cls", "reg", "total", "num_pos",
                                          "grad_norm")}
             for step, line in display_steps(
                 os.path.join(tpu_run, "log.txt"), first_run=True).items()}
    with open(os.path.join(tpu_run, "eval.json")) as f:
        summary = json.load(f)
    return {"eval": {k: summary[k] for k in ("mAP@0.5", "mAP@[.5:.95]")},
            "steps": steps}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--max_steps", type=int, default=4000)
    p.add_argument("--out", required=True,
                   help="directory for result.json, train.log, the loss "
                        "logs and eval.json")
    p.add_argument("--keep", action="store_true",
                   help="keep the checkpoint and cache directory")
    args = p.parse_args(argv)

    def train(ckpt, out):
        from detectax_torch.cli import train_retinanet_coco

        return train_retinanet_coco.main([
            "--dataset", "detbench_v2", "--max_steps", str(args.max_steps),
            "--backbone", "mobilenetv2", "--display_step", "100",
            "--step_save", "1000", "--loss_norm", "pos",
            "--warmup_steps", "300", "--grad_clip", "16", "--canvas", "512",
            "--init_lr", "0.01", "--lr_boundaries", "3000",
            "--batch_size", "16", "--bf16",
            "--ckpt_dir", ckpt, "--out_dir", out,
        ])

    tpu = tpu_yardsticks()
    result = run(
        args.out, name="detbench_retinanet", dataset="detbench_v2",
        train=train,
        evaluate_argv=["--family", "retinanet", "--dataset", "detbench_v2",
                       "--backbone", "mobilenetv2", "--coco_metrics"],
        result={"max_steps": args.max_steps, "dtype": "bfloat16",
                "tpu_yardsticks": tpu}, keep=args.keep)
    # this run's losses beside the TPU log's at its logged steps
    mine = {int(m["step"]): m for m in result["losses"]}
    side = {}
    for step, want in sorted(tpu["steps"].items()):
        if step in mine:
            side[step] = {k: (mine[step][k], want[k])
                          for k in ("num_pos", "cls", "total")}
    print(json.dumps({"port_vs_tpu_at_logged_steps": side,
                      "mAP@0.5": (result["eval"]["mAP@0.5"],
                                  tpu["eval"]["mAP@0.5"])}))
    result["port_vs_tpu_at_logged_steps"] = side
    with open(os.path.join(args.out, "result.json"), "w") as f:
        json.dump(result, f, indent=1)
    return result


if __name__ == "__main__":
    main()
