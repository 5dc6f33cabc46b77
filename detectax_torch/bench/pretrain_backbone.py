"""Crop pretraining of a backbone, for the detectors' ``--init_backbone``.

Port of `benchmarks/pretrain_backbone.py`. With no ImageNet weights at
hand, a trunk is pretrained as a classifier of single-object crops drawn
from the DetBench train split, and its weights are saved in the port's
``.npz`` (`tools.port_tf_weights.save_ported`, keyed by the Flax path,
``{"params": <trunk>, "batch_stats": <trunk>}``), which every trainer
reads through ``--init_backbone`` (optionally with ``--freeze_bn``): the
path an ImageNet port would take.

The recipe is the JAX program's: the trunk computes in bf16 (parameters
float32, each layer casting, BatchNorm normalizing in the compute dtype),
the c5 tap is averaged in float32 and a float32 dense layer ``cls_head``
gives the logits; mean softmax cross-entropy; global-norm clip 8, then
SGD with momentum 0.9 on optax's warmup-cosine schedule from 0 to
``--init_lr``; crops from ``np.random.default_rng(0)``, the evaluation's
from ``default_rng(1)``. Weights start from a seeded `torch.Generator`
(seed 0), not from JAX's random init.

Usage (a CUDA device; exits 1 without one):
    python -m detectax_torch.bench.pretrain_backbone --backbone mobilenetv2 \\
        --steps 3000 --out runs_torch/pretrain_mbv2/backbone.npz
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from detectax_torch.bench._common import require_cuda, synchronize
from detectax_torch.data import detbench
from detectax_torch.models.backbones import build_backbone
from detectax_torch.models.layers import init_parameters
from detectax_torch.runtime import set_tf32
from detectax_torch.tools.from_flax import load_flax, to_flax
from detectax_torch.tools.port_tf_weights import save_ported
from detectax_torch.train.schedules import make_optimizer, warmup_cosine_decay

# the JAX class's fixed compute dtype
TRUNK_DTYPE = torch.bfloat16
SEED = 0


class CropClassifier(nn.Module):
    """Backbone trunk -> float32 average of the c5 tap over H and W ->
    float32 logits. Takes NHWC images; the trunk's Flax name is its
    ``flax_name``, so `tools.from_flax` fills it from a JAX init."""

    def __init__(self, backbone_name: str = "mobilenetv2",
                 num_classes: int = 8, dtype: torch.dtype = TRUNK_DTYPE):
        super().__init__()
        self.backbone = build_backbone(backbone_name, dtype=dtype)
        self.cls_head = nn.Linear(self.backbone.out_channels["c5"],
                                  num_classes)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        taps = self.backbone(x.permute(0, 3, 1, 2).contiguous(), train)
        h = taps["c5"].to(torch.float32).mean(dim=(2, 3))
        return self.cls_head(h)


def crop_batch(ds, rng, batch, crop_px):
    """Random (image, GT-box) crops with 10-35% context margin, resized to
    ``crop_px`` with PIL bilinear. Returns (uint8 [B,S,S,3], int32 [B])."""
    from PIL import Image

    imgs = np.empty((batch, crop_px, crop_px, 3), np.uint8)
    labels = np.empty((batch,), np.int32)
    n = len(ds)
    size = ds.img_size
    filled = 0
    while filled < batch:
        s = ds[int(rng.integers(0, n))]
        if len(s["labels"]) == 0:
            continue
        j = int(rng.integers(0, len(s["labels"])))
        # DetBench boxes are canvas-normalized xyxy: scaled to pixels
        x1, y1, x2, y2 = s["boxes_xyxy"][j] * size
        mw = (x2 - x1) * rng.uniform(0.10, 0.35)
        mh = (y2 - y1) * rng.uniform(0.10, 0.35)
        xa = int(max(0, x1 - mw)); ya = int(max(0, y1 - mh))
        xb = int(min(size, x2 + mw)); yb = int(min(size, y2 + mh))
        if xb - xa < 8 or yb - ya < 8:
            continue
        patch = Image.fromarray(s["image"][ya:yb, xa:xb])
        imgs[filled] = np.asarray(
            patch.resize((crop_px, crop_px), Image.BILINEAR)
        )
        labels[filled] = s["labels"][j]
        filled += 1
    return imgs, labels


def _inputs(images: np.ndarray, labels: np.ndarray, device):
    x = torch.from_numpy(images).to(device).to(torch.float32) / 127.5 - 1.0
    return x, torch.from_numpy(labels).to(device).long()


def train_step(model, opt, torch_opt, step, images, labels, device):
    """One update from the crops; ``step`` counts the updates made before
    it. Returns the loss and the accuracy as device scalars."""
    x, y = _inputs(images, labels, device)
    logits = model(x, train=True)
    loss = F.cross_entropy(logits, y)
    acc = (logits.argmax(-1) == y).to(torch.float32).mean()
    params = [p for g in torch_opt.param_groups for p in g["params"]]
    grads = torch.autograd.grad(loss, params)
    opt.update(torch_opt, grads, step)
    return loss.detach(), acc


@torch.no_grad()
def eval_step(model, images, labels, device) -> float:
    x, y = _inputs(images, labels, device)
    return float((model(x, train=False).argmax(-1) == y)
                 .to(torch.float32).mean())


def trunk_variables(model: CropClassifier) -> dict:
    """``{"params", "batch_stats"}`` of the trunk alone, as Flax trees
    (the ``--init_backbone`` contract: no ``cls_head``)."""
    params, batch_stats = to_flax(model)
    bk = [k for k in params if k != "cls_head"]
    assert len(bk) == 1, f"expected one backbone submodule, got {bk}"
    return {"params": params[bk[0]],
            "batch_stats": batch_stats.get(bk[0], {})}


def main(argv=None, *, device=None, variables=None):
    """The program. ``device`` None means CUDA (exit 1 without it);
    ``variables``, the Flax ``{"params", "batch_stats"}`` of a whole
    `CropClassifier`, replaces the seeded init (tests start both
    implementations from one init). Returns the metadata written beside
    the trunk, with the run's timing under ``"timing"``."""
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--backbone", default="mobilenetv2")
    p.add_argument("--steps", type=int, default=3000)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--crop", type=int, default=128)
    p.add_argument("--init_lr", type=float, default=0.05)
    p.add_argument("--warmup_steps", type=int, default=200)
    p.add_argument("--out", required=True)
    p.add_argument("--display_step", type=int, default=100)
    p.add_argument("--eval_batches", type=int, default=8)
    args = p.parse_args(argv)

    device = (require_cuda("detectax_torch.bench.pretrain_backbone")
              if device is None else torch.device(device))
    set_tf32(False)

    train_ds = detbench.DetBenchDataset("train")
    eval_ds = detbench.DetBenchDataset("eval")
    nc = train_ds.num_classes

    model = CropClassifier(args.backbone, nc, dtype=TRUNK_DTYPE)
    rng = np.random.default_rng(0)
    print("init...", flush=True)
    if variables is None:
        init_parameters(model, torch.Generator().manual_seed(SEED))
    else:
        load_flax(model, variables["params"], variables.get("batch_stats"))
    model.to(device)
    print("init done", flush=True)

    opt = make_optimizer(
        "sgd", warmup_cosine_decay(0.0, args.init_lr, args.warmup_steps,
                                   args.steps),
        grad_clip=8.0, momentum=0.9)
    torch_opt = opt.bind(model.parameters())

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    t0 = time.time()
    crop_s = window_crop_s = 0.0
    window_t0, window_steps = time.perf_counter(), 0
    losses = []
    for step in range(1, args.steps + 1):
        if step == 1:
            print("generating first batch...", flush=True)
        tc = time.perf_counter()
        images, labels = crop_batch(train_ds, rng, args.batch_size,
                                    args.crop)
        dt = time.perf_counter() - tc
        crop_s += dt
        window_crop_s += dt
        window_steps += 1
        if step == 1:
            print("first batch done; running the first step...", flush=True)
        loss, acc = train_step(model, opt, torch_opt, step - 1, images,
                               labels, device)
        losses.append(loss)
        if step % args.display_step == 0 or step == 1:
            loss, acc = float(loss), float(acc)   # waits for the step
            wall = time.perf_counter() - window_t0
            print(
                f"step {step} loss {loss:.4f} acc {acc:.3f} "
                f"({(time.time() - t0) / 60:.1f} min) "
                f"{1e3 * wall / window_steps:.1f} ms/step, crops "
                f"{100.0 * window_crop_s / wall:.1f}% of it",
                flush=True,
            )
            window_t0, window_steps, window_crop_s = \
                time.perf_counter(), 0, 0.0
    synchronize(device)
    train_s = time.time() - t0

    accs = []
    erng = np.random.default_rng(1)
    for _ in range(args.eval_batches):
        images, labels = crop_batch(eval_ds, erng, args.batch_size,
                                    args.crop)
        accs.append(eval_step(model, images, labels, device))
    eval_acc = float(np.mean(accs))
    print(f"eval crop accuracy: {eval_acc:.3f}")

    save_ported(trunk_variables(model), args.out)
    meta = {
        "backbone": args.backbone, "steps": args.steps,
        "crop": args.crop, "eval_crop_acc": round(eval_acc, 4),
        "train_min": round((time.time() - t0) / 60, 1),
    }
    with open(args.out + ".json", "w") as f:
        json.dump(meta, f, indent=2)
    print(json.dumps(meta))
    timing = {"train_s": train_s, "ms_per_step": 1e3 * train_s / args.steps,
              "crops_per_s": args.steps * args.batch_size / train_s,
              "crop_share": crop_s / train_s,
              "losses": [float(v) for v in torch.stack(losses).cpu()]}
    print("timing " + json.dumps({k: v for k, v in timing.items()
                                  if k != "losses"}), flush=True)
    return {**meta, "timing": timing}


if __name__ == "__main__":
    main()
