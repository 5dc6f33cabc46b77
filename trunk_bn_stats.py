"""Layer by layer, the BatchNorm running statistics of crop-pretrained
ResNet-50 trunks against the batch statistics that DetBench v1 training
images give each layer.

`detbench_fcos_r50.py` trains under ``--freeze_bn``: the trunk normalizes
with the running mean and variance it brought from crop pretraining. This
program loads each trunk (the port's ``.npz`` or a Flax ``.msgpack``)
into FCOS-R50's backbone, runs the first ``--images`` DetBench v1
training images through it in eval mode at ``--canvas`` px (the FCOS
trainer's loader and seed 0, float32, TF32 off), and records each
BatchNorm layer's input mean and biased variance a channel. It prints one
JSON line a layer, with these numbers for each trunk (by its path):

- ``shift``: the mean over channels of |running_mean − batch_mean| /
  sqrt(batch_var + eps);
- ``log_var``: the mean over channels of |ln((running_var + eps) /
  (batch_var + eps))|;
- ``running_var``, ``batch_var``: the means over channels;

then one ``{"summary": ...}`` line with each trunk's means over layers and
its worst layers. Runs on one CUDA device unless ``--device cpu``.

    python3 trunk_bn_stats.py --trunks JAX.msgpack PORT.npz [...] \\
        [--images 64] [--canvas 384] [--out stats.jsonl]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import types

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
EPS = 1e-5


def batch_of_images(n: int, canvas: int):
    """The first ``n`` images of the FCOS trainer's loader over DetBench
    v1's training split (seed 0), normalized as training sees them:
    float32 NHWC."""
    from detectax_torch.data.detbench import DetBenchDataset, load_spec
    from detectax_torch.train.driver import TrainConfig, build_loader

    cfg = TrainConfig(batch_size=n, canvas=canvas, max_steps=1,
                      device_normalize=False)
    loader = build_loader(cfg, DetBenchDataset(
        "train", spec=load_spec(name="detbench")))
    return next(iter(loader))["images"]


def layer_stats(path: str, images, device) -> dict:
    """{layer name: (running_mean, running_var, batch_mean, batch_var)} of
    the trunk at ``path``, float64 numpy arrays."""
    import torch

    from detectax_torch.models import FCOS
    from detectax_torch.models.layers import BatchNorm
    from detectax_torch.train.driver import load_backbone_weights

    model = FCOS(num_classes=8, backbone="resnet50")
    load_backbone_weights(types.SimpleNamespace(model=model), path)
    trunk = model.backbone.to(device).eval()
    seen = {}

    def hook(name):
        def pre(mod, args):
            x = args[0].to(torch.float32)
            mean = x.mean(dim=(0, 2, 3))
            var = (x - mean.view(1, -1, 1, 1)).square().mean(dim=(0, 2, 3))
            seen[name] = (mod.running_mean, mod.running_var, mean, var)
        return pre

    handles = [m.register_forward_pre_hook(hook(n))
               for n, m in trunk.named_modules() if isinstance(m, BatchNorm)]
    x = torch.as_tensor(images, device=device).permute(0, 3, 1, 2)
    with torch.no_grad():
        trunk(x.contiguous(), False)
    for h in handles:
        h.remove()
    return {n: tuple(t.double().cpu().numpy() for t in v)
            for n, v in seen.items()}


def compare(stats: dict) -> dict:
    """The per-layer numbers of one trunk (see the module docstring)."""
    out = {}
    for name, (rm, rv, bm, bv) in stats.items():
        out[name] = {
            "shift": float(np.mean(np.abs(rm - bm) / np.sqrt(bv + EPS))),
            "log_var": float(np.mean(np.abs(np.log((rv + EPS)
                                                   / (bv + EPS))))),
            "running_var": float(np.mean(rv)),
            "batch_var": float(np.mean(bv)),
        }
    return out


def summarize(per_trunk: dict, worst: int = 3) -> dict:
    """Each trunk's means over layers and its ``worst`` layers by shift
    and by log_var."""
    summary = {}
    for trunk, layers in per_trunk.items():
        names = list(layers)
        summary[trunk] = {
            "layers": len(names),
            "mean_shift": sum(layers[n]["shift"] for n in names) / len(names),
            "mean_log_var": (sum(layers[n]["log_var"] for n in names)
                             / len(names)),
            "worst_shift": sorted(names, key=lambda n: -layers[n]["shift"]
                                  )[:worst],
            "worst_log_var": sorted(
                names, key=lambda n: -layers[n]["log_var"])[:worst],
        }
    return summary


def main(argv=None, *, device=None) -> dict:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--trunks", nargs="+", required=True)
    p.add_argument("--images", type=int, default=64)
    p.add_argument("--canvas", type=int, default=384)
    p.add_argument("--out", default=None, help="also write the lines here")
    p.add_argument("--device", default=device)
    args = p.parse_args(argv)

    sys.path.insert(0, ROOT)
    from detectax_torch.runtime import resolve_device, set_tf32
    from detbench_fcos_r50 import card

    dev = resolve_device(args.device)
    set_tf32(False)
    images = batch_of_images(args.images, args.canvas)
    per_trunk = {t: compare(layer_stats(t, images, dev)) for t in args.trunks}
    lines = [{"card": card() if dev.type == "cuda" else "cpu",
              "images": args.images, "canvas": args.canvas,
              "trunks": args.trunks}]
    ref = per_trunk[args.trunks[0]]
    for name in ref:
        lines.append({"layer": name, **{
            t: per_trunk[t][name] for t in args.trunks}})
    summary = summarize(per_trunk)
    lines.append({"summary": summary})
    text = "\n".join(json.dumps(line) for line in lines)
    print(text, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return {"layers": per_trunk, "summary": summary}


if __name__ == "__main__":
    main()
