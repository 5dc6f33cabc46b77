"""Live serving against its exported replay, from a trained checkpoint.

``python -m detectax_torch.bench.diag_export [--family fcos] [--backbone
mobilenetv2] (--ckpt_dir ckpt | --weights w.npz) [--num_classes 8]
[--canvas 384]``

The counterpart of `benchmarks/diag_export.py`, which splits protocol
from product in the export round trip. From a checkpoint (or a weights
file) it compares, on one ``uniform(-1, 1)`` image from
``default_rng(0)``:

  A. the dense pre-NMS outputs (``boxes``, ``probs``: forward, then the
     family's decode);
  B. the serving graph (forward, decode, NMS: `infer.export.
     make_serving_fn` at top-k 1,024, IoU 0.5, score 0.05, 100 outputs);
  C. for B, the number of detections each kept, the top-10 scores and
     the largest score difference over the detections kept;

each evaluated live (eager) and replayed from a `torch.export` program
that went through a save and a load: for B the v2 bundle's program for a
bucket of one (`infer.export.export_detector`), for A the same
construction around the dense graph (weights passed as call arguments).
The JAX program's third arm, live under `jax.jit`, has no counterpart in
an eager program, so its ``*_vs_jit`` keys have none either; the report
keeps the JAX keys that still apply (``replay_vs_eager``, ``num_valid
(eager/replay)``, the top-10 scores, the score deltas) and adds the
device and the card's name and power limit. It needs a CUDA device and
has no CPU branch.
"""
from __future__ import annotations

import argparse
import io
import json

import numpy as np
import torch

from detectax_torch import runtime
from detectax_torch.bench._common import device_label, require_cuda
from detectax_torch.cli.evaluate import build_family
from detectax_torch.infer.export import (
    _in_order,
    export_detector,
    make_serving_fn,
)
from detectax_torch.tools.from_flax import load_flax, load_weights
from detectax_torch.train.driver import restore_for_inference

SERVING = dict(top_k=1024, iou_thresh=0.5, score_thresh=0.05,
               max_outputs=100)


class _DenseProgram(torch.nn.Module):
    """``fn(weights, images) -> {"boxes", "probs"}``: the detector applied
    with ``weights`` (its ``state_dict`` entries), then ``decode``."""

    def __init__(self, model, decode):
        super().__init__()
        # not a submodule: export would lift its weights into constants
        object.__setattr__(self, "detector", model)
        self.decode = decode

    def forward(self, weights: dict, images: torch.Tensor) -> dict:
        outs = torch.func.functional_call(self.detector, weights, (images,),
                                          {"train": False})
        boxes, probs = self.decode(outs)
        return {"boxes": boxes, "probs": probs}


def round_trip(ep):
    """The program after a save and a load (the JAX program's serialize
    and deserialize), as a callable module."""
    buf = io.BytesIO()
    torch.export.save(ep, buf)
    buf.seek(0)
    return torch.export.load(buf).module()


def _maxdiff(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.float(), b.float()
    return float((a - b).abs().max()) if a.numel() else 0.0


def _tree_maxdiff(x: dict, y: dict) -> dict:
    return {k: _maxdiff(x[k], y[k]) for k in x}


def report(model, decode, images: torch.Tensor, *,
           fused: bool | None = None) -> dict:
    """The A/B/C report for ``model`` (on ``images``' device, eval mode);
    ``fused`` is `make_serving_fn`'s (None: resolved for the device)."""
    dev = images.device
    model = model.to(dev).eval()
    weights = _in_order({k: v.detach()
                         for k, v in model.state_dict().items()})
    batch, canvas = images.shape[0], images.shape[1]
    dense = _DenseProgram(model, decode)
    serving_fn = make_serving_fn(model, decode, fused=fused, **SERVING)
    with torch.no_grad():
        live = {"dense": dense(weights, images),
                "serving": serving_fn(images)}
    programs = {
        "dense": torch.export.export(dense, (weights, images), strict=False),
        "serving": export_detector(model, decode, batch=batch,
                                   canvas=canvas, device=dev, fused=fused,
                                   **SERVING),
    }
    out = {}
    for name in ("dense", "serving"):
        with torch.no_grad():
            replay = round_trip(programs[name])(weights, images)
        eager = live[name]
        out[f"{name}: replay_vs_eager"] = _tree_maxdiff(replay, eager)
        if name == "serving":
            se, sr = eager["scores"][0], replay["scores"][0]
            nv = int(eager["num_valid"][0])
            out["serving: num_valid (eager/replay)"] = [
                int(x["num_valid"][0]) for x in (eager, replay)]
            out["serving: top10 scores eager"] = se[:10].tolist()
            out["serving: score deltas eager-replay (first nv)"] = (
                _maxdiff(se[:nv], sr[:nv]) if nv else 0.0)
    out["device"] = device_label(dev)
    out["card"] = runtime.card_name_and_power()
    return out


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--family", default="fcos")
    p.add_argument("--backbone", default="mobilenetv2")
    p.add_argument("--ckpt_dir", default="ckpt")
    p.add_argument("--weights", default=None,
                   help="a weights file (the port's .npz or a Flax "
                        ".msgpack) instead of --ckpt_dir")
    p.add_argument("--num_classes", type=int, default=8)
    p.add_argument("--canvas", type=int, default=384)
    args = p.parse_args(argv)
    # build_family's option surface (cli.export_model's defaults)
    args.center = False
    args.box_scales = [32.0, 64.0, 128.0, 256.0, 512.0]
    args.anchor_sizes = [20.0, 40.0, 80.0, 160.0, 320.0]
    args.n_filters = 12
    args.n_stacks = 1
    return args


def load_model(args, device):
    """(model with the checkpoint's or the file's weights on ``device``,
    decode)."""
    model, decode = build_family(args.family, args.num_classes,
                                 args.backbone, args.canvas, args)
    model = model.to(device)
    if args.weights:
        load_flax(model, *load_weights(args.weights))
    else:
        model = restore_for_inference(args.ckpt_dir, model)
    return model.eval(), decode


def images_for(canvas: int, device) -> torch.Tensor:
    rng = np.random.default_rng(0)
    images = rng.uniform(-1, 1, (1, canvas, canvas, 3)).astype(np.float32)
    return torch.from_numpy(images).to(device)


def main(argv=None) -> dict:
    args = parse_args(argv)
    dev = require_cuda("detectax_torch.bench.diag_export")
    runtime.set_tf32(False)
    model, decode = load_model(args, dev)
    out = report(model, decode, images_for(args.canvas, dev))
    print(json.dumps(out, indent=2, default=str), flush=True)
    return out


if __name__ == "__main__":
    main()
