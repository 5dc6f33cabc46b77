"""A/B of the space-to-depth stem on the flagship train step.

``python -m detectax_torch.bench.s2d_ab [--steps 30] [--windows 3]``

The counterpart of `benchmarks/s2d_ab.py`. ``DETECTAX_S2D_STEM=1``
evaluates the ResNet stem's 7x7/s2 conv over 3 input channels as a 4x4/s1
conv over space-to-depth input with 12 (`models.layers.S2DConv7x7`: the
same function of the same parameters), which cuDNN's tensor-core kernels
fill better than a contraction of 3 channels padded to 8. Four arms in
one process, in turn, so that the host's drift reaches both sides:
``base``, ``s2d``, ``base+freeze_bn``, ``s2d+freeze_bn`` (FCOS-R50,
384 px, batch 16, bf16), each rebuilt from the one seed.
One line an arm under the JAX keys, then ``{"s2d_ab_fcos_r50_384_b16":
...}`` with every window's ms, the device and the card's name and power
limit.

``mfu_pct`` divides the plain stem's `FlopCounterMode` count (the
model's work; the s2d stem's kernel is 8x8 where the plain one is 7x7,
so its own count is larger), so that the arms divide the same
operations; ``arm_step_tflops`` is the arm's own count. Timing is
`_levers.time_fn`'s (min of windows, each closed by a value fetch). It
needs a CUDA device and has no CPU branch.
"""
from __future__ import annotations

import argparse

from detectax_torch import runtime
from detectax_torch.bench import _levers
from detectax_torch.bench._common import emit, require_cuda

ENV_KEY = "DETECTAX_S2D_STEM"


def run(args, device, **geometry) -> dict:
    out, windows = _levers.lever_ab(
        args, device, env_key=ENV_KEY, row_key="s2d_stem", arm_name="s2d",
        model_count_env={ENV_KEY: "0"}, **geometry)
    return emit({"s2d_ab_fcos_r50_384_b16": out, "window_ms": windows,
                 **_levers.footer(device)})


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--steps", type=int, default=30)
    p.add_argument("--windows", type=int, default=3)
    return p.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    dev = require_cuda("detectax_torch.bench.s2d_ab")
    runtime.set_tf32(False)
    return run(args, dev)


if __name__ == "__main__":
    main()
