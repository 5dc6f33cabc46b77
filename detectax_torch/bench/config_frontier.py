"""Config-frontier sweep: the BatchNorm and batch levers combined on the
flagship step.

``python -m detectax_torch.bench.config_frontier [--steps 30] [--windows
3] [--only LABEL ...]``

The counterpart of `benchmarks/config_frontier.py`: the same eight
configurations (`CONFIGS`: label, environment, ``freeze_bn``, batch), run
in turn in one process, so that the host's drift reaches every arm:

- ``DETECTAX_BN_STAT_SUBSET=4``: BatchNorm statistics from B/4 examples;
- ``DETECTAX_BN_BF16_STATS=1``: the statistics reduced in bf16;
- ``freeze_bn``: BatchNorm on its running statistics;
- batch 32.

Each arm clears `ENV_KEYS`, sets its environment and rebuilds the model
from the one seed (the port's BatchNorm reads ``DETECTAX_BN_BF16_STATS``
when a block is built); the environment is restored at the end. The JAX
program compiles with its latency-hiding scheduler on; an eager program
has no counterpart. One line a configuration, then
``{"config_frontier_fcos_r50_384": ...}`` with every window's ms, the
device and the card's name and power limit.
Timing and ``mfu_pct`` are `_levers`'s (min of windows; `FlopCounterMode`
operations over 989 TFLOP/s, not XLA's cost analysis). It needs a CUDA
device and has no CPU branch.
"""
from __future__ import annotations

import argparse

from detectax_torch import runtime
from detectax_torch.bench import _levers
from detectax_torch.bench._common import emit, require_cuda, scoped_env

ENV_KEYS = ("DETECTAX_BN_STAT_SUBSET", "DETECTAX_BN_BF16_STATS")

CONFIGS = [
    # (label, env, freeze_bn, batch)
    ("base", {}, False, 16),
    ("subset4", {"DETECTAX_BN_STAT_SUBSET": "4"}, False, 16),
    ("subset4+bf16stats",
     {"DETECTAX_BN_STAT_SUBSET": "4", "DETECTAX_BN_BF16_STATS": "1"},
     False, 16),
    ("bf16stats", {"DETECTAX_BN_BF16_STATS": "1"}, False, 16),
    ("freeze_bn", {}, True, 16),
    ("base_b32", {}, False, 32),
    ("subset4_b32", {"DETECTAX_BN_STAT_SUBSET": "4"}, False, 32),
    ("freeze_bn_b32", {}, True, 32),
]


def measure(args, label: str, env: dict, freeze_bn: bool, batch: int,
            device, **geometry) -> tuple[dict, dict]:
    """(the configuration's row, its arm's numbers)."""
    with scoped_env(env, clear=ENV_KEYS):
        arm = _levers.step_arm(args.steps, args.windows, device,
                               batch=batch, freeze_bn=freeze_bn, **geometry)
    row = {"config": label, "batch": batch, **_levers.step_row(arm, batch)}
    emit(row)
    return row, arm


def run(args, device, **geometry) -> dict:
    out, windows = {}, {}
    for label, env, freeze_bn, batch in CONFIGS:
        if args.only and label not in args.only:
            continue
        out[label], arm = measure(args, label, env, freeze_bn, batch,
                                  device, **geometry)
        windows[label] = [round(t * 1000, 3) for t in arm["window_sec"]]
    return emit({"config_frontier_fcos_r50_384": out, "window_ms": windows,
                 **_levers.footer(device)})


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--steps", type=int, default=30)
    p.add_argument("--windows", type=int, default=3)
    p.add_argument("--only", nargs="*", default=None,
                   help="subset of config labels to run")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    dev = require_cuda("detectax_torch.bench.config_frontier")
    runtime.set_tf32(False)
    return run(args, dev)


if __name__ == "__main__":
    main()
