"""MFU investigation of the flagship step: phase breakdown, canvas sweep
and the backend's levers.

``python -m detectax_torch.bench.mfu_breakdown [--steps 30] [--windows 3]
[--only phases|canvas|levers]``

The counterpart of `benchmarks/mfu_breakdown.py`, under its JSON keys:

1. **Phase breakdown** of the flagship step (FCOS-R50, 384 px, batch 16,
   bf16): five graphs on the same state and batch, ``assign`` (the
   batched assignment), ``forward`` (the training-mode forward),
   ``forward+loss``, ``grad(fwd+bwd)`` (the parameters' gradients of
   forward + loss) and ``full step`` (`train.loop.make_train_step`'s),
   the first three under ``torch.no_grad``; then ``backward (grad -
   fwd+loss)`` and ``update (full - grad)``, derived as the JAX program
   derives them.
2. **Canvas sweep**: the full step at 384, 512 and 640 px, batch 16.
3. **Levers**: the JAX program's arms are TPU compiler options, which an
   eager program does not have. Here the arms are the backend's global
   switches around the same, unchanged step: ``baseline``
   (``torch.backends.cudnn.benchmark = False``, PyTorch's default) and
   ``cudnn_benchmark`` (``True``), the switch restored after each arm;
   each prints its ``options`` (the switches it sets away from their
   defaults) as the JAX line does.
   An arm that raises is printed as ``{"error": ..., "options": ...}``,
   as the JAX program records a rejected option, and the program then
   exits 1: every arm here is required.

The five graphs are timed together by `_levers.time_rounds` (min of
windows, each closed by a value fetch, two warm-up calls), one window of
each graph a round: the eager step is bound by the host, whose speed can
change within a run, and the JAX program's graph-after-graph order would
put that change between two rows (a deviation). ``mfu_pct`` is the
graph's convolution and matmul operations counted by `FlopCounterMode`
(`_levers.count_flops`, `bench.train.step_flops`'s count) over the time
and 989 TFLOP/s, not XLA's cost analysis: the assignment has neither, so
its row counts 0.
Each summary line adds every window's ms, the device and the card's name
and power limit (``nvidia-smi``). It needs a CUDA device and has no CPU
branch.
"""
from __future__ import annotations

import argparse
import sys
import traceback

import torch

from detectax_torch import runtime
from detectax_torch.bench import _levers, train
from detectax_torch.bench._common import emit, require_cuda

CANVASES = (384, 512, 640)
# each arm's torch.backends.cudnn.benchmark
LEVERS = {"baseline": False, "cudnn_benchmark": True}


def lever_options(benchmark: bool) -> dict:
    """An arm's ``options`` as its line prints them: the switches it sets
    away from their defaults."""
    return {"torch.backends.cudnn.benchmark": True} if benchmark else {}


def phase_graphs(parts: train.Parts) -> dict:
    """The five graphs of the breakdown, each ``fn(state, batch)``, with
    whether it is a train step (which threads the state)."""
    model, assign_fn, loss_fn = parts.model, parts.assign_fn, parts.loss
    params = list(model.parameters())

    def targets(bd):
        with torch.no_grad():
            return assign_fn(bd["boxes"], bd["labels"], bd["valid"])

    def fwd_loss(bd):
        y_pred = model(bd["images"], train=True)
        return loss_fn(targets(bd), y_pred)["total"] / len(bd["images"])

    def assign_only(state, bd):
        return targets(bd)

    def fwd_only(state, bd):
        with torch.no_grad():
            return model(bd["images"], train=True)

    def fwd_loss_only(state, bd):
        with torch.no_grad():
            return fwd_loss(bd)

    def grad_only(state, bd):
        return torch.autograd.grad(fwd_loss(bd), params, allow_unused=True)

    return {
        "assign": (assign_only, False),
        "forward": (fwd_only, False),
        "forward+loss": (fwd_loss_only, False),
        "grad(fwd+bwd)": (grad_only, False),
        "full step": (parts.raw_step, True),
    }


def phase_rows(measured: dict) -> dict:
    """`phase_breakdown`'s rows from each graph's (seconds, operations),
    the two derived rows as the JAX program derives them."""
    rows = {}
    for name, (sec, flops) in measured.items():
        rows[name] = {
            "ms": round(sec * 1000, 2),
            "tflops": round(flops / 1e12, 3),
            "mfu_pct": _levers.mfu_pct(flops, sec),
        }
    rows["backward (grad - fwd+loss)"] = {
        "ms": round(rows["grad(fwd+bwd)"]["ms"] - rows["forward+loss"]["ms"],
                    2)
    }
    rows["update (full - grad)"] = {
        "ms": round(rows["full step"]["ms"] - rows["grad(fwd+bwd)"]["ms"], 2)
    }
    return rows


def phase_breakdown(args, device, *, img: int = _levers.IMG,
                    batch: int = _levers.BATCH,
                    backbone: str = _levers.BACKBONE) -> dict:
    parts, state, data = train.build(img, batch, backbone, device=device)
    graphs = phase_graphs(parts)
    timed = _levers.time_rounds(graphs, state, data, args.steps,
                                args.windows)
    measured, windows = {}, {}
    for name, (fn, _) in graphs.items():
        sec, times = timed[name]
        measured[name] = (sec, _levers.count_flops(fn, state, data))
        windows[name] = [round(t * 1000, 3) for t in times]
    return emit({f"phase_breakdown_{img}px_b{batch}": phase_rows(measured),
                 "window_ms": windows, **_levers.footer(device)})


def canvas_sweep(args, device, *, canvases=CANVASES,
                 batch: int = _levers.BATCH,
                 backbone: str = _levers.BACKBONE) -> dict:
    out, windows = {}, {}
    for img in canvases:
        arm = _levers.step_arm(args.steps, args.windows, device,
                               batch=batch, img=img, backbone=backbone)
        row = _levers.step_row(arm, batch)
        out[f"{img}px"] = {
            "ms_per_step": row["ms_per_step"],
            "img_per_sec": row["img_per_sec"],
            "step_tflops": round(arm["flops"] / 1e12, 3),
            "mfu_pct": row["mfu_pct"],
        }
        windows[f"{img}px"] = [round(t * 1000, 3) for t in arm["window_sec"]]
        emit({f"canvas_{img}": out[f"{img}px"]})
    return emit({f"canvas_sweep_fcos_r50_b{batch}": out,
                 "window_ms": windows, **_levers.footer(device)})


def levers(args, device, *, img: int = _levers.IMG,
           batch: int = _levers.BATCH,
           backbone: str = _levers.BACKBONE) -> dict:
    out, windows = {}, {}
    default = torch.backends.cudnn.benchmark
    for name, benchmark in LEVERS.items():
        opts = lever_options(benchmark)
        try:
            torch.backends.cudnn.benchmark = benchmark
            arm = _levers.step_arm(args.steps, args.windows, device,
                                   batch=batch, img=img, backbone=backbone)
            out[name] = {**_levers.step_row(arm, batch), "options": opts}
            windows[name] = [round(t * 1000, 3) for t in arm["window_sec"]]
        except Exception as e:  # an arm's failure is a result: record it
            traceback.print_exc()
            out[name] = {"error": f"{type(e).__name__}: {e}",
                         "options": opts}
        finally:
            torch.backends.cudnn.benchmark = default
        emit({f"lever_{name}": out[name]})
    return emit({f"compiler_levers_{img}px_b{batch}": out,
                 "window_ms": windows, **_levers.footer(device)})


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--steps", type=int, default=30)
    p.add_argument("--windows", type=int, default=3)
    p.add_argument("--only", choices=("phases", "canvas", "levers"),
                   default=None)
    return p.parse_args(argv)


def run(args, device) -> dict:
    """The parts ``args.only`` names (all by default), each line printed;
    returns the summary lines by part."""
    lines = {}
    if args.only in (None, "phases"):
        lines["phases"] = phase_breakdown(args, device)
    if args.only in (None, "canvas"):
        lines["canvas"] = canvas_sweep(args, device)
    if args.only in (None, "levers"):
        lines["levers"] = levers(args, device)
    return lines


def failed_arms(lines: dict) -> list:
    """The lever arms that raised."""
    summary = lines.get("levers", {})
    arms = next((v for k, v in summary.items()
                 if k.startswith("compiler_levers_")), {})
    return [name for name, row in arms.items() if "error" in row]


def main(argv=None) -> dict:
    args = parse_args(argv)
    dev = require_cuda("detectax_torch.bench.mfu_breakdown")
    runtime.set_tf32(False)
    lines = run(args, dev)
    failed = failed_arms(lines)
    if failed:
        sys.stderr.write(f"lever arms failed: {failed}\n")
        sys.exit(1)
    return lines


if __name__ == "__main__":
    main()
