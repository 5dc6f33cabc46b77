"""The flagship training step as `bench.py` measures it (its lines 1, 1b
and 1c), and the step's share of the card's peak.

The step is FCOS with a ResNet-50 FPN, 20 classes, bf16 compute, batch
16 at 384 px: `ops.assign.fcos_assign` on the device, `train.losses.
fcos_loss` (the focal kernel), SGD on `exponential_with_floor(5e-4)`
with clip 1, built by `train.loop.make_train_step`. Its batch is
`bench.py`'s synthetic one, drawn from ``default_rng(0)``; its weights come
from a seeded generator.

`mfu_pct` is the step's convolution and matmul operations, forward and
backward, counted once by `torch.utils.flop_counter.FlopCounterMode`
(`step_flops`), over the step time and the card's dense bf16 peak. The
count depends on the model and the shapes alone: the focal operator and
every elementwise operation count 0, so a kernel that replaces a plain
version leaves it as it was.
"""
from __future__ import annotations

import time
from typing import Callable, NamedTuple

import numpy as np
import torch

from detectax_torch import runtime
from detectax_torch.bench._common import (
    device_label,
    launches_since,
    synchronize,
)
from detectax_torch.kernels import _common as kcommon
from detectax_torch.models import FCOS
from detectax_torch.ops.assign import fcos_assign
from detectax_torch.train.loop import create_train_state, make_train_step
from detectax_torch.train.losses import fcos_loss
from detectax_torch.train.schedules import (
    exponential_with_floor,
    make_optimizer,
)

NUM_CLASSES = 20
BOXES = 16   # ground-truth boxes an image, all valid
SEED = 0
# The TF2/Keras eager reference loop (ResNet-50 FPN, 384 px) on a CPU,
# BASELINE.md: what `vs_baseline` divides by, as in bench.py.
CPU_REFERENCE_IMG_PER_SEC = 0.129
BASELINE_NOTE = ("vs_baseline divides by 0.129 images/s, the TF2/Keras "
                 "eager per-image reference training loop (ResNet-50 FPN, "
                 "384 px) measured on a CPU (BASELINE.md); not a TPU figure")
FLOPS_NOTE = ("step_flops counts the convolutions and matmuls of one step, "
              "forward and backward (torch.utils.flop_counter."
              "FlopCounterMode); BatchNorm, elementwise work, the focal "
              "operator and the update count 0. bench.py's step_tflops is "
              "XLA's cost analysis of the whole compiled step, so the two "
              "programs' mfu_pct are not comparable")
# NVIDIA H100 SXM, dense bf16 (the data sheet's rate without sparsity, at
# the 700 W power limit)
PEAK_BF16_FLOPS = 989e12
WARMUP_STEPS = 3


class TrainSetup(NamedTuple):
    step: Callable
    state: object          # train.loop.TrainState, updated in place
    batch: dict            # the synthetic batch, on the model's device


class Parts(NamedTuple):
    """The pieces of the flagship step (`benchmarks/mfu_breakdown.py::
    build`'s ``parts``), from which the lever programs make their graphs."""
    model: torch.nn.Module
    assign_fn: Callable    # (boxes, labels, valid) -> y_true, batched
    loss: Callable         # (y_true, y_pred) -> dict with "total"
    raw_step: Callable     # train.loop.make_train_step's step


def train_batch(img: int, batch: int, nc: int = NUM_CLASSES) -> dict:
    """`bench.py::_train_batch`'s arrays (and `benchmarks/mfu_breakdown.py::
    build`'s), as numpy: ``default_rng(0)``, 16 boxes an image around the
    centre (yxhw, normalised), normal images, labels over the ``nc``
    classes, all valid; the same draws in the same order."""
    rng = np.random.default_rng(0)
    boxes = np.zeros((batch, BOXES, 4), np.float32)
    boxes[:, :, 0] = rng.uniform(0.3, 0.7, (batch, BOXES))
    boxes[:, :, 1] = rng.uniform(0.3, 0.7, (batch, BOXES))
    boxes[:, :, 2] = rng.uniform(0.05, 0.5, (batch, BOXES))
    boxes[:, :, 3] = rng.uniform(0.05, 0.5, (batch, BOXES))
    return {
        "images": rng.normal(size=(batch, img, img, 3)).astype(np.float32),
        "boxes": boxes,
        "labels": rng.integers(0, nc, (batch, BOXES)).astype(np.int32),
        "valid": np.ones((batch, BOXES), bool),
    }


def flagship_assign(img: int, nc: int = NUM_CLASSES) -> Callable:
    """The step's target assignment: five FCOS levels of an ``img``
    canvas, ``nc`` classes."""
    def assign_fn(boxes, labels, valid):
        return fcos_assign(boxes, labels, valid, img_dim=(img, img),
                           num_classes=nc)[0]
    return assign_fn


def build(img: int, batch: int, backbone: str = "resnet50",
          nc: int = NUM_CLASSES, *, freeze_bn: bool = False, device=None,
          dtype: torch.dtype = torch.bfloat16,
          assign_fn: Callable | None = None,
          loss_fn: Callable | None = None):
    """`benchmarks/mfu_breakdown.py::build` (and `bench.py::
    _make_train_setup`): the FCOS step at ``img`` px computing in
    ``dtype`` (bf16, as the programs run it), SGD on
    `exponential_with_floor(5e-4)`, its fresh state and the synthetic batch
    of ``batch`` images on ``device`` (None: CUDA, raising without one).
    The weights are drawn from a generator seeded with `SEED`; neither
    ``freeze_bn``, ``dtype`` nor the environment's switches change the
    parameters, so every build of one ``nc`` and ``backbone`` starts from
    the same weights. ``assign_fn`` / ``loss_fn`` replace the flagship's
    (a profile wraps them in named ranges).

    Returns (`Parts`, state, batch)."""
    dev = runtime.resolve_device(device)
    model = FCOS(num_classes=nc, backbone=backbone, freeze_bn=freeze_bn,
                 dtype=dtype, generator=torch.Generator().manual_seed(SEED)
                 ).to(dev)
    opt = make_optimizer("sgd", exponential_with_floor(5e-4))
    assign_fn = assign_fn or flagship_assign(img, nc)
    loss_fn = loss_fn or fcos_loss
    raw_step = make_train_step(model, assign_fn, loss_fn, opt)
    data = {k: torch.from_numpy(v).to(dev)
            for k, v in train_batch(img, batch, nc).items()}
    return (Parts(model, assign_fn, loss_fn, raw_step),
            create_train_state(model, None, opt), data)


def make_train_setup(img: int, batch: int, backbone: str = "resnet50", *,
                     freeze_bn: bool = False, device=None,
                     dtype: torch.dtype = torch.bfloat16,
                     assign_fn: Callable | None = None,
                     loss_fn: Callable | None = None) -> TrainSetup:
    """`bench.py::_make_train_setup`: `build`'s step, state and batch."""
    parts, state, data = build(img, batch, backbone, freeze_bn=freeze_bn,
                               device=device, dtype=dtype,
                               assign_fn=assign_fn, loss_fn=loss_fn)
    return TrainSetup(parts.raw_step, state, data)


def step_flops(setup: TrainSetup) -> int:
    """Convolution and matmul operations of one step, forward and backward
    (`FlopCounterMode`: a convolution's backward counts only the gradients
    autograd asks for, so the stem, whose input is the image, computes no
    input gradient). The step is taken: the state advances by one."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        setup.step(setup.state, setup.batch)
    return int(counter.get_total_flops())


def timed_sec_per_step(setup: TrainSetup, steps: int, windows: int):
    """`bench.py`'s min-of-N-windows protocol: `WARMUP_STEPS` steps, then
    ``windows`` windows of ``steps // windows`` steps (at least one), each
    closed by a synchronise and timed on the host clock. Returns (the
    least seconds a step, the last step's ``total``, steps a window, every
    window's seconds a step)."""
    device = setup.batch["images"].device
    for _ in range(WARMUP_STEPS):
        _, metrics = setup.step(setup.state, setup.batch)
        float(metrics["total"])
    synchronize(device)
    per = max(1, steps // windows)
    times = []
    for _ in range(windows):
        t0 = time.perf_counter()
        for _ in range(per):
            _, metrics = setup.step(setup.state, setup.batch)
        synchronize(device)
        times.append((time.perf_counter() - t0) / per)
    return min(times), float(metrics["total"]), per, times


def roofline(flops: int, sec_per_step: float, batch: int) -> dict:
    """`bench.py:160-171`'s arithmetic: the step's TFLOP, its share of the
    peak, the images/s at 100 % of the peak and the measured rate's share
    of that."""
    rate = batch / sec_per_step
    roofline_img_s = batch * PEAK_BF16_FLOPS / flops
    return {
        "step_tflops": round(flops / 1e12, 3),
        "mfu_pct": round(100.0 * flops / sec_per_step / PEAK_BF16_FLOPS, 1),
        "roofline_img_per_sec": round(roofline_img_s, 1),
        "vs_roofline": round(rate / roofline_img_s, 3),
    }


def train_line(metric: str, img: int, batch: int, steps: int, windows: int,
               backbone: str, *, freeze_bn: bool = False,
               note: str | None = None, device=None) -> dict:
    """One training line of `bench_torch.py`, under `bench.py`'s keys and
    formulas; ``detail`` adds the step's exact operation count, every
    window's time, the card's name and power limit and the kernel
    launches of the line's steps."""
    before = kcommon.launch_counts()
    setup = make_train_setup(img, batch, backbone, freeze_bn=freeze_bn,
                             device=device)
    dev = setup.batch["images"].device
    flops = step_flops(setup)
    sec, total, per, times = timed_sec_per_step(setup, steps, windows)
    rate = batch / sec
    detail = {
        "steps": steps,
        "protocol": f"min-of-{windows}-windows x {per} steps",
        "sec_per_step": round(sec, 5),
        "window_sec_per_step": times,
        "final_loss": round(total, 3),
        "device": device_label(dev),
        "card": runtime.card_name_and_power(),
        "step_flops": flops,
        "flops_counted": FLOPS_NOTE,
        "launches": launches_since(before),
        "baseline": BASELINE_NOTE,
    }
    if note:
        detail["note"] = note
    detail.update(roofline(flops, sec, batch))
    return {
        "metric": metric,
        "value": round(rate, 2),
        "unit": "images/sec/chip",
        "vs_baseline": round(rate / CPU_REFERENCE_IMG_PER_SEC, 1),
        "mfu_pct": detail["mfu_pct"],
        "detail": detail,
    }

