"""A/B of the stem max pool's tie-splitting backward on the flagship step.

``python -m detectax_torch.bench.pool_ab [--steps 30] [--windows 3]``

The counterpart of `benchmarks/pool_ab.py`. ``DETECTAX_POOL_VJP=1`` makes
the ResNet stem's 3x3/s2 max pool take `ops.pool.pool_bwd_tied` for its
backward (the JAX package's select-and-scatter-free decomposition, which
splits a tied window's gradient), in place of PyTorch's
`max_pool2d_with_indices_backward`; the forward is the same. `ops.pool.
max_pool_3x3_s2` reads the switch at every call. Four arms in one
process, in turn: ``base``, ``pool``, ``base+freeze_bn``,
``pool+freeze_bn`` (FCOS-R50, 384 px, batch 16, bf16), each rebuilt from
the one seed. One line an arm under the JAX keys, then
``{"pool_ab_fcos_r50_384_b16": ...}`` with every window's ms, the device
and the card's name and power limit. Timing and ``mfu_pct`` are
`_levers`'s (min of windows; `FlopCounterMode` operations over 989
TFLOP/s, not XLA's cost analysis). It needs a CUDA device and has no CPU
branch.
"""
from __future__ import annotations

import argparse

from detectax_torch import runtime
from detectax_torch.bench import _levers
from detectax_torch.bench._common import emit, require_cuda

ENV_KEY = "DETECTAX_POOL_VJP"


def run(args, device, **geometry) -> dict:
    out, windows = _levers.lever_ab(
        args, device, env_key=ENV_KEY, row_key="pool_vjp", arm_name="pool",
        **geometry)
    return emit({"pool_ab_fcos_r50_384_b16": out, "window_ms": windows,
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
    dev = require_cuda("detectax_torch.bench.pool_ab")
    runtime.set_tf32(False)
    return run(args, dev)


if __name__ == "__main__":
    main()
