"""StackedHourglass on DetBench v2: train with the TPU row's command, then
evaluate on the 256-image eval split.

The command is line 1 of `benchmarks/runs_v2/stacked_hourglass/log.txt`
(the JAX package's `cli.train_hourglass_voc`): DetBench v2, 4,000 steps,
`--variant stacked --n_filters 64 --n_stacks 2`, 320 px, batch 16 (in the
trainer's default microbatches of 2), Adam at 1e-3 on the epoch schedule
(0.9 every 1,000 steps), losses divided by the positive cells, 300
warmup steps, clip 16, bf16 compute. Then `cli.evaluate --family
stacked_hourglass --dataset detbench_v2 --coco_metrics` with the width of
the training run (`--n_filters 64 --n_stacks 2`, the row's `eval_extra` in
`benchmarks/run_detbench.py`; the log's own evaluate line does not name
them). The TPU row's `eval.json` (mAP@0.5 0.8009, AP@[.5:.95] 0.4992) and
the losses and `num_pos` its log gives every 100 steps are the
yardsticks: `result.json` holds them beside this run's.

    python3 detbench_hourglass.py --out DIR [--max_steps 4000] \
        [--microbatch 2] [--keep]

``--microbatch`` sets the trainer's microbatch (default 2, the trainer's
default that the TPU row ran with: BatchNorm statistics over two images);
``--microbatch 16`` trains the same batches unsplit, about six times
faster on the port's launch-bound step, with statistics over sixteen.

Writes ``DIR/result.json`` (the card, the wall times, the losses of every
display step, the eval summary and the yardsticks) and ``DIR/train.log``;
the scaffolding is `detbench_fcos_r50.run`. Runs on one CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os

from detbench_fcos_r50 import ROOT, run
from detbench_retinanet import tpu_yardsticks

TPU_RUN = os.path.join(ROOT, "benchmarks", "runs_v2", "stacked_hourglass")
WIDTH = ["--n_filters", "64", "--n_stacks", "2"]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--max_steps", type=int, default=4000)
    p.add_argument("--out", required=True,
                   help="directory for result.json, train.log, the loss "
                        "logs and eval.json")
    p.add_argument("--microbatch", type=int, default=2,
                   help="the trainer's microbatch (2: the TPU row's)")
    p.add_argument("--keep", action="store_true",
                   help="keep the checkpoint and cache directory")
    args = p.parse_args(argv)

    def train(ckpt, out):
        from detectax_torch.cli import train_hourglass_voc

        return train_hourglass_voc.main([
            "--dataset", "detbench_v2", "--max_steps", str(args.max_steps),
            "--backbone", "mobilenetv2", "--display_step", "100",
            "--step_save", "1000", "--loss_norm", "pos",
            "--warmup_steps", "300", "--grad_clip", "16", "--canvas", "320",
            "--batch_size", "16", "--variant", "stacked", *WIDTH,
            "--steps_per_epoch", "1000", "--init_lr", "1e-3", "--bf16",
            "--microbatch", str(args.microbatch),
            "--ckpt_dir", ckpt, "--out_dir", out,
        ])

    tpu = tpu_yardsticks(TPU_RUN)
    result = run(
        args.out, name="detbench_hourglass", dataset="detbench_v2",
        train=train,
        evaluate_argv=["--family", "stacked_hourglass", "--dataset",
                       "detbench_v2", "--backbone", "mobilenetv2", *WIDTH,
                       "--coco_metrics"],
        result={"max_steps": args.max_steps, "dtype": "bfloat16",
                "microbatch": args.microbatch, "tpu_yardsticks": tpu},
        keep=args.keep)
    # this run's losses beside the TPU log's at its logged steps
    mine = {int(m["step"]): m for m in result["losses"]}
    side = {}
    for step, want in sorted(tpu["steps"].items()):
        if step in mine:
            side[step] = {k: (mine[step][k], want[k])
                          for k in ("num_pos", "cls", "reg", "total")}
    equal = sum(1 for v in side.values()
                if v["num_pos"][0] == v["num_pos"][1])
    print(json.dumps({"port_vs_tpu_at_logged_steps": side,
                      "num_pos_equal_at": f"{equal} of {len(side)}",
                      "mAP@0.5": (result["eval"]["mAP@0.5"],
                                  tpu["eval"]["mAP@0.5"]),
                      "mAP@[.5:.95]": (result["eval"]["mAP@[.5:.95]"],
                                       tpu["eval"]["mAP@[.5:.95]"])}))
    result["port_vs_tpu_at_logged_steps"] = side
    with open(os.path.join(args.out, "result.json"), "w") as f:
        json.dump(result, f, indent=1)
    return result


if __name__ == "__main__":
    main()
