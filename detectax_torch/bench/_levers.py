"""What the lever programs share (`mfu_breakdown`, `config_frontier`,
`s2d_ab`, `pool_ab`): the counterparts of `benchmarks/mfu_breakdown.py`'s
`_time_fn` and `_flops_of`, one arm of the flagship training step
(`step_arm`), four of them for the two-by-two A/Bs (`lever_ab`), and the
keys every summary line adds (`footer`).

Every arm builds its model anew from `bench.train.SEED` (`train.build`),
so that BatchNorm reads the arm's environment when it is built; the
switches change no parameter, so every arm starts from the same weights,
as the JAX programs share one ``state``.

Timing (`time_fn`) is the JAX program's: two warm-up calls, then
``windows`` windows of ``steps // windows`` calls (at least one), each
window closed by a value fetch (a float of the first element of the first
parameter after train steps, of the first output otherwise), which waits
for the card; the result is the least seconds a call over the windows,
with every window's. `time_rounds` times several graphs so, their windows
interleaved round by round (a deviation: the JAX program times one graph's
windows after another's).

``mfu_pct`` is the graph's convolution and matmul operations counted by
`torch.utils.flop_counter.FlopCounterMode` (`count_flops`, the count of
`bench.train.step_flops`) over the time and 989 TFLOP/s, the H100 SXM's
dense bf16 peak. It is not XLA's cost analysis, which the JAX programs
divide by: BatchNorm, elementwise work and the focal operator count 0
here, so the two programs' ``mfu_pct`` are not comparable.
"""
from __future__ import annotations

import time
from typing import Callable

import torch

from detectax_torch import runtime
from detectax_torch.bench import train
from detectax_torch.bench._common import (
    device_label,
    emit,
    scoped_env,
    synchronize,
)

PEAK_BF16_FLOPS = train.PEAK_BF16_FLOPS
IMG, BATCH, BACKBONE = 384, 16, "resnet50"   # the flagship step
FLOPS_NOTE = ("tflops and mfu_pct count a graph's convolutions and "
              "matmuls, forward and backward (torch.utils.flop_counter."
              "FlopCounterMode); BatchNorm, elementwise work, the focal "
              "operator and the update count 0. The JAX programs' count is "
              "XLA's cost analysis of the compiled graph, so the two "
              "programs' mfu_pct are not comparable")
WARMUP_CALLS = 2


def _first_tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    if isinstance(x, dict):
        x = list(x.values())
    for leaf in x:
        if leaf is not None:
            return _first_tensor(leaf)
    raise ValueError("no tensor to fetch")


def force(out, state=None) -> float:
    """A value fetch that waits for the card (`_force`): the first element
    of the first parameter of ``state`` where one is given (a train step),
    else of the first tensor in ``out``."""
    if state is not None:
        out = next(state.model.parameters())
    return float(_first_tensor(out).detach().reshape(-1)[0])


def time_fn(fn: Callable, state, data: dict, steps: int, windows: int,
            carry_state: bool) -> tuple[float, list]:
    """`_time_fn`: (least seconds a call, every window's seconds a call) of
    ``fn(state, data)``. ``carry_state``: ``fn`` is a train step, which
    updates ``state`` in place, and a window closes on its parameters."""
    return time_rounds({"": (fn, carry_state)}, state, data, steps,
                       windows)[""]


def time_rounds(graphs: dict, state, data: dict, steps: int,
                windows: int) -> dict:
    """`time_fn` of several graphs (name -> ``(fn, carry_state)``) with
    their windows interleaved: every graph's warm-up calls, then
    ``windows`` rounds, each timing one window of every graph in turn, so
    that a change in the host's speed during the run falls on every graph
    alike. Returns name -> (least seconds a call, every window's)."""
    def window(fn, fetch_state, calls):
        t0 = time.perf_counter()
        for _ in range(calls):
            out = fn(state, data)
        force(out, fetch_state)
        return (time.perf_counter() - t0) / calls

    fetch = {name: state if carry else None
             for name, (_, carry) in graphs.items()}
    for name, (fn, _) in graphs.items():
        for _ in range(WARMUP_CALLS):
            window(fn, fetch[name], 1)
    per = max(1, steps // windows)
    times = {name: [] for name in graphs}
    for _ in range(windows):
        for name, (fn, _) in graphs.items():
            times[name].append(window(fn, fetch[name], per))
    return {name: (min(t), t) for name, t in times.items()}


def count_flops(fn: Callable, state, data: dict) -> int:
    """Convolution and matmul operations of one call of ``fn(state,
    data)`` (`FlopCounterMode`; a train step advances ``state`` by one)."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn(state, data)
    return int(counter.get_total_flops())


def mfu_pct(flops: int, sec: float) -> float:
    return round(100.0 * flops / sec / PEAK_BF16_FLOPS, 1)


def footer(device) -> dict:
    """What every summary line adds beside the JAX program's keys."""
    return {"device": device_label(torch.device(device)),
            "card": runtime.card_name_and_power(),
            "flops_counted": FLOPS_NOTE}


def step_arm(steps: int, windows: int, device, *,
             batch: int = BATCH, freeze_bn: bool = False, img: int = IMG,
             backbone: str = BACKBONE, count_env: dict | None = None
             ) -> dict:
    """One arm: the flagship step built under the environment as it is now
    (BatchNorm reads ``DETECTAX_BN_BF16_STATS`` when it is built); its
    operations counted (under ``count_env`` as well where given, for a
    count of another evaluation of the same model) and its step timed.
    Returns ``sec``, ``window_sec``, ``flops`` (and ``count_env_flops``);
    the model is freed."""
    parts, state, data = train.build(img, batch, backbone,
                                     freeze_bn=freeze_bn, device=device)
    out = {"flops": count_flops(parts.raw_step, state, data)}
    if count_env is not None:
        with scoped_env(count_env):
            out["count_env_flops"] = count_flops(parts.raw_step, state, data)
    out["sec"], out["window_sec"] = time_fn(parts.raw_step, state, data,
                                            steps, windows, True)
    dev = data["images"].device
    del parts, state, data
    synchronize(dev)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def step_row(arm: dict, batch: int, flops: int | None = None) -> dict:
    """The JAX programs' row arithmetic: ms a step, images/s and
    ``mfu_pct`` (over ``flops``, by default the arm's own count)."""
    sec = arm["sec"]
    return {
        "ms_per_step": round(sec * 1000, 2),
        "img_per_sec": round(batch / sec, 1),
        "mfu_pct": mfu_pct(arm["flops"] if flops is None else flops, sec),
    }


def lever_ab(args, device, *, env_key: str, row_key: str, arm_name: str,
             model_count_env: dict | None = None, img: int = IMG,
             batch: int = BATCH, backbone: str = BACKBONE
             ) -> tuple[dict, dict]:
    """`s2d_ab`'s and `pool_ab`'s four arms, in the JAX programs' order
    (base, lever; then both with ``freeze_bn``): ``env_key`` "0" or "1",
    the model rebuilt an arm. Each row carries the JAX keys (``row_key``:
    whether the lever was on). With
    ``model_count_env`` (the environment of the model's plain evaluation)
    ``mfu_pct`` divides that evaluation's count, the model's work, so
    that every arm divides the same operations, and ``arm_step_tflops``
    is the arm's own count. Returns (rows by arm key, window ms by arm
    key)."""
    out, windows = {}, {}
    for freeze_bn in (False, True):
        for on in (False, True):
            key = (f"{arm_name if on else 'base'}"
                   f"{'+freeze_bn' if freeze_bn else ''}")
            with scoped_env({env_key: "1" if on else "0"}):
                arm = step_arm(args.steps, args.windows, device,
                               batch=batch, freeze_bn=freeze_bn, img=img,
                               backbone=backbone, count_env=model_count_env)
            row = {row_key: on, "freeze_bn": freeze_bn,
                   **step_row(arm, batch, arm.get("count_env_flops"))}
            if model_count_env is not None:
                row["arm_step_tflops"] = round(arm["flops"] / 1e12, 3)
            out[key] = row
            windows[key] = [round(t * 1000, 3) for t in arm["window_sec"]]
            emit(row)
    return out, windows
