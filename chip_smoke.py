#!/usr/bin/env python3
"""GPU smoke run of the PyTorch / CUDA port: ``python3 chip_smoke.py``.

Needs one NVIDIA GPU (written for an H100) and ``nvcc``; there is no CPU
branch, and any failed phase ends the run with a non-zero exit code. In
order:

1. device: name, ``nvidia-smi`` name and power limit, TF32 switches (off);
2. builds the CUDA kernels from ``detectax_torch/kernels/csrc`` and loads
   them;
3. holds each kernel against its plain PyTorch version on the card, at the
   shapes of the main paths: the two NMS kernels to an exact match on
   inputs (numpy, seeded) with heavy overlap, exact score ties,
   duplicates, degenerate boxes and padding; the focal-loss kernel
   (forward sum rtol 2e-4, dlogits atol 1e-5, two runs bitwise equal) at
   the five level shapes, with a weight mask, with logits of +-100, and
   on a strided view; times kernels and plain versions with CUDA events;
4. drives the serving path at full width: FCOS, ResNet-50 + FPN, 20
   classes, 384 px, fp32, seeded weights, through `Predictor` with buckets
   (1, 8) — once with the default NMS (fused dense kernel) and once with
   combined-NMS candidates (top-k + sweep kernel) — and checks launch
   counts, shapes, finiteness and equality with the same path run on the
   kernels' plain versions;
5. drives the training path at the same width, batch 16: 5 steps through
   `make_train_step` with `fcos_assign`, `fcos_loss`, SGD-momentum and
   clip 1.0 on the kernel path, the same 5 steps from the same initial
   state on the plain versions, and one microbatched step; checks launch
   counts, finiteness, agreement of the two paths, and that BatchNorm
   statistics moved;
6. trains 4 steps through the command-line entry point
   `detectax_torch.cli.train_fcos` on the synthetic dataset, restores the
   checkpoint it wrote and serves one 8-image request from it;
7. prints one JSON line ``{"kernels": [...]}`` and, last, the ``ok`` line.

It imports `detectax_torch` only — nothing of JAX or of `detectax`.
"""
from __future__ import annotations

import functools
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from detectax_torch import runtime
from detectax_torch.infer.export import fcos_decode_fn, make_serving_fn
from detectax_torch.infer.serving import Predictor
from detectax_torch.kernels import _common as kcommon
from detectax_torch.kernels import focal as KF
from detectax_torch.kernels import nms as K
from detectax_torch.kernels.probe import barrier_probe
from detectax_torch.models import FCOS
from detectax_torch.ops.assign import fcos_assign
from detectax_torch.train.driver import restore_for_inference
from detectax_torch.train.loop import create_train_state, make_train_step
from detectax_torch.train.losses import fcos_loss
from detectax_torch.train.schedules import (
    exponential_with_floor,
    global_norm,
    make_optimizer,
)

SEED = 0
DEV = torch.device("cuda", 0)

# Published peaks of one H100 SXM (NVIDIA data sheet): device memory rate
# and the float32 rate outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
# floating-point operations per candidate pair (2 min, 2 max, 2 sub,
# 2 clamp, 1 mul, 3 add/sub, 1 div, 1 compare) ...
SWEEP_FLOPS_PER_PAIR = 14
# ... plus, in the dense kernel, the argmax comparison (1) in every round,
# and each candidate's area (2 sub, 1 mul) once
DENSE_FLOPS_PER_CANDIDATE_ROUND = SWEEP_FLOPS_PER_PAIR + 1
AREA_FLOPS_PER_CANDIDATE = 3

# ... and per element of the focal loss, every call of expf, log1pf, powf
# and every division counted as one operation like an add: 12 for the
# shared terms (|x|, two exp, log1p, min, max, p), 12 more for the forward
# (two pow, the products, the running sum), 18 more for the backward; one
# more with a weight mask
FOCAL_FWD_FLOPS = 24
FOCAL_BWD_FLOPS = 30
FOCAL_LEVELS = (48, 24, 12, 6, 3)  # h = w of the five levels at 384 px
FOCAL_BATCH = 16
# the kernel sums in another order than torch: tolerance of the sum, and
# of one element of dlogits
FOCAL_SUM_RTOL, FOCAL_GRAD_ATOL = 2e-4, 1e-5

BOUND_NOTE = (
    "bound_ms is the larger of bytes/3.35e12 and operations/67e12 and "
    "bound_by names which; the chain of dependent rounds is not part of "
    "it: chain_ms = rounds_max x the empty round measured in this run, the "
    "floor of a one-block-per-image design, stands beside it as its own "
    "key. focal: launches counts the forward launches of the training "
    "run (launches_bwd the backward ones); ms, plain_ms and library_ms "
    "are device times of the forward queued behind a blocker, the "
    "call_ms keys what a caller on this host sees; an element is charged "
    "24 operations forward and 30 backward, each transcendental call and "
    "division counted as one")

BACKBONE, CANVAS, NUM_CLASSES, BUCKETS = "resnet50", 384, 20, (1, 8)
CANDIDATES = 3069  # 48^2 + 24^2 + 12^2 + 6^2 + 3^2 cells at 384 px
REQUESTS = (1, 3, 8, 11)
CLS_HEAD_BIAS = -2.0  # the focal prior (-4.6) would leave NMS nothing


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


# --------------------------------------------------------------------------
# inputs and timing
# --------------------------------------------------------------------------

def make_candidates(rng, batch, n, *, pad_tail=0, nc=NUM_CLASSES,
                    span=160.0):
    """[batch, n] crowded corner boxes (pixels, yxyx), scores and classes
    with exact score ties, exact duplicate boxes, degenerate boxes and a
    tail of `pad_tail` padding entries (zero box, score -1, class 0)."""
    y = rng.uniform(0, span, size=(batch, n)).astype(np.float32)
    x = rng.uniform(0, span, size=(batch, n)).astype(np.float32)
    h = rng.uniform(8, 120, size=(batch, n)).astype(np.float32)
    w = rng.uniform(8, 120, size=(batch, n)).astype(np.float32)
    boxes = np.stack([y, x, y + h, x + w], axis=-1)
    scores = rng.uniform(0.01, 1, size=(batch, n)).astype(np.float32)
    scores = (np.round(scores * 256) / 256).astype(np.float32)  # ties
    classes = rng.integers(0, nc, size=(batch, n)).astype(np.int32)
    dup = n // 8
    boxes[:, n // 2:n // 2 + dup] = boxes[:, :dup]        # duplicates
    classes[:, n // 2:n // 2 + dup] = classes[:, :dup]
    bad = rng.choice(n, size=n // 10, replace=False)
    boxes[:, bad, 2] = boxes[:, bad, 0] - 7.0             # negative height
    boxes[:, bad[::2], 3] = boxes[:, bad[::2], 1] - 3.0   # and width
    if pad_tail:
        boxes[:, -pad_tail:] = 0.0
        scores[:, -pad_tail:] = -1.0
        classes[:, -pad_tail:] = 0
    return boxes, scores, classes


def cuda(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x)).to(DEV)


def time_ms(fn, *, warmup: int, reps: int) -> float:
    """Mean milliseconds of one call, by CUDA events around `reps` calls.
    Inputs stay in L2 between calls, as the serving path finds them: the
    decode just before has written them."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def queued_ms(fn, *, reps: int) -> float:
    """Mean device milliseconds of one call of a function whose launches
    are shorter than the host takes to enqueue them: the `reps` calls are
    queued behind a blocker (large float32 matrix products) so that the
    device runs them back to back once the host has enqueued them all, and
    the events around them see no host time. `time_ms` of the same function
    gives what a caller on this host sees."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3
    a = torch.ones((8192, 8192), device=DEV)
    one_ms = time_ms(lambda: a @ a, warmup=1, reps=2)
    blockers = int(2.0 * host_ms / one_ms) + 2
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for _ in range(blockers):
        a @ a
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def barrier_round_us(blocks: int = 8) -> float:
    """Microseconds of one empty dependent round (shared-memory exchange +
    barrier of a 1024-thread block), as the slope between a short and a
    long chain so that the launch itself cancels."""
    short, long = 1000, 11000
    t = {n: time_ms(lambda n=n: barrier_probe(n, blocks, DEV),
                    warmup=2, reps=10) for n in (short, long)}
    return (t[long] - t[short]) * 1e3 / (long - short)


def bound(bytes_moved: int, flops: int) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_flops = flops / FP32_FLOPS * 1e3
    return max(t_bytes, t_flops), ("bytes" if t_bytes >= t_flops
                                   else "operations")


# --------------------------------------------------------------------------
# phase 3: each kernel against its plain version
# --------------------------------------------------------------------------

def check_sweep(rng, batch, k, *, class_aware, with_valid):
    boxes, scores, classes = make_candidates(
        rng, batch, k, pad_tail=k // 16 if with_valid else 0)
    order = np.argsort(-scores, axis=1, kind="stable")
    take = lambda a: np.take_along_axis(
        a, order if a.ndim == 2 else order[..., None], axis=1)
    b, c = cuda(take(boxes)), cuda(take(classes))
    v = cuda(take(scores) >= 0) if with_valid else None
    args = (b, 0.5)
    kw = dict(valid=v, classes=c if class_aware else None)

    got = K.nms_sweep(*args, **kw)
    torch.cuda.synchronize()
    want = K.nms_sweep_plain(*args, **kw)
    mismatches = int((got != want).sum())
    check(got.dtype == torch.bool and got.shape == (batch, k),
          f"nms_sweep K={k}: wrong output {got.dtype} {tuple(got.shape)}")
    check(mismatches == 0,
          f"nms_sweep K={k} class_aware={class_aware}: {mismatches} keep "
          f"bits differ from the plain version")
    kept = int(want.sum())
    check(0 < kept < batch * k, f"nms_sweep K={k}: degenerate test input")

    ms = time_ms(lambda: K.nms_sweep(*args, **kw), warmup=3, reps=50)
    plain_ms = time_ms(lambda: K.nms_sweep_plain(*args, **kw),
                       warmup=1, reps=2)
    # work this data needs: one IoU row (the j > i part) per kept box
    idx = torch.arange(k, device=DEV)
    pairs = int((want * (k - 1 - idx)).sum())
    nbytes = batch * k * (16 + (4 if class_aware else 0)
                          + (1 if with_valid else 0) + 1)
    bound_ms, bound_by = bound(nbytes, pairs * SWEEP_FLOPS_PER_PAIR)
    return {
        "shape": {"B": batch, "K": k, "class_aware": class_aware,
                  "valid_mask": with_valid},
        "max_abs_err": float(mismatches), "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None, "rounds_per_image": kept / batch,
        "rounds_max": int(want.sum(dim=1).max()),
        "us_per_round": ms * 1e3 / (kept / batch),
    }


def check_dense(rng, batch, m, max_outputs):
    boxes, scores, classes = make_candidates(rng, batch, m)
    b, s, c = cuda(boxes), cuda(scores), cuda(classes)
    kw = dict(iou_thresh=0.5, score_thresh=0.05, max_outputs=max_outputs,
              class_aware=True)

    got = K.dense_nms(b, s, c, **kw)
    torch.cuda.synchronize()
    want = K.dense_nms_plain(b, s, c, **kw)
    err = 0.0
    for key in ("boxes", "scores", "classes", "valid", "num_valid"):
        check(got[key].shape == want[key].shape
              and got[key].dtype == want[key].dtype,
              f"dense_nms M={m}: {key} is {got[key].dtype} "
              f"{tuple(got[key].shape)}, plain gives {want[key].dtype} "
              f"{tuple(want[key].shape)}")
        diff = (got[key].double() - want[key].double()).abs().max().item()
        err = max(err, diff)
    check(err == 0.0, f"dense_nms M={m}: max abs difference {err} from the "
                      f"plain version (exact match expected)")
    nv = want["num_valid"]
    check(int(nv.min()) > 0, f"dense_nms M={m}: degenerate test input")

    ms = time_ms(lambda: K.dense_nms(b, s, c, **kw), warmup=3, reps=50)
    plain_ms = time_ms(lambda: K.dense_nms_plain(b, s, c, **kw),
                       warmup=1, reps=2)
    # rounds this data needs: one per survivor, one more to find none left
    rounds = nv + (nv < max_outputs).to(nv.dtype)
    flops = (int(rounds.sum()) * m * DENSE_FLOPS_PER_CANDIDATE_ROUND
             + batch * m * AREA_FLOPS_PER_CANDIDATE)
    nbytes = batch * (m * 24 + max_outputs * 25)
    bound_ms, bound_by = bound(nbytes, flops)
    mean_rounds = float(rounds.float().mean())
    return {
        "shape": {"B": batch, "M": m, "max_outputs": max_outputs},
        "max_abs_err": err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None, "rounds_per_image": mean_rounds,
        "rounds_max": int(rounds.max()),
        "us_per_round": ms * 1e3 / mean_rounds,
    }


def library_focal(labels, logits, alpha=0.25, gamma=2.0):
    """The nearest single PyTorch call family: focal weighting around
    `binary_cross_entropy_with_logits`. A yardstick for `library_ms`
    only; nothing in the port calls it."""
    import torch.nn.functional as F
    ce = F.binary_cross_entropy_with_logits(logits, labels, reduction="none")
    p_t = torch.exp(-ce)
    return ((labels * alpha + (1 - labels) * (1 - alpha))
            * (1 - p_t) ** gamma * ce).sum()


def check_focal(rng, hw, *, case="dense"):
    """Forward sum and dlogits of the focal kernel against its plain
    version at one level's shape ``[16, hw, hw, 20]``. `case`: "dense"
    (contiguous), "weights" (with a 0/1 mask), "extreme" (logits in
    {-100, -40, 0, 40, 100}), "strided" (the class channels of a
    25-channel map, read in place)."""
    shape = (FOCAL_BATCH, hw, hw, NUM_CLASSES)
    labels = (rng.uniform(size=shape) < 0.01).astype(np.float32)
    if case == "extreme":
        logits = rng.choice(
            np.array([-100, -40, 0, 40, 100], np.float32), size=shape)
    else:
        logits = (4.0 * rng.standard_normal(size=shape)).astype(np.float32)
    z, x = cuda(labels), cuda(logits)
    w = None
    if case == "weights":
        w = cuda((rng.uniform(size=shape[:3] + (1,)) < 0.7)
                 .astype(np.float32))
    if case == "strided":
        def widen(t):
            wide = torch.zeros(shape[:3] + (5 + NUM_CLASSES,), device=DEV)
            wide[..., 5:] = t
            return wide[..., 5:]
        z, x = widen(z), widen(x)
        check(not x.is_contiguous(), "strided case is contiguous")
    name = f"focal {case} hw={hw}"

    def run(fn):
        xg = x.detach().requires_grad_(True)
        out = fn(z, xg, weights=w)
        out.backward()
        return out.detach(), xg.grad

    got, got_grad = run(KF.focal_loss)
    again, again_grad = run(KF.focal_loss)
    torch.cuda.synchronize()
    want, want_grad = run(KF.focal_loss_plain)
    closed = KF.focal_grad_plain(z, x, weights=w)
    check(bool(torch.isfinite(got)) and bool(torch.isfinite(got_grad).all()),
          f"{name}: non-finite loss or gradient")
    check(got_grad.shape == x.shape and got.shape == (),
          f"{name}: wrong output shapes")
    check(torch.equal(got, again) and torch.equal(got_grad, again_grad),
          f"{name}: two runs on the same input differ in their bits")
    sum_rel = float((got - want).abs() / want.abs().clamp_min(1e-30))
    grad_err = float((got_grad - want_grad).abs().max())
    closed_err = float((got_grad - closed).abs().max())
    check(sum_rel <= FOCAL_SUM_RTOL,
          f"{name}: sum {float(got)} vs plain {float(want)} "
          f"(rel {sum_rel}, tolerance {FOCAL_SUM_RTOL})")
    check(max(grad_err, closed_err) <= FOCAL_GRAD_ATOL,
          f"{name}: dlogits differ by {grad_err} from autograd of the "
          f"plain version, {closed_err} from the closed form "
          f"(tolerance {FOCAL_GRAD_ATOL})")

    # Times. The calls are far shorter than the host takes to enqueue them,
    # so each is timed twice: queued behind a blocker (device time, the
    # `ms` keys) and in an eager loop (what a caller on this host sees, the
    # `call_ms` keys). Backward = forward + backward minus forward.
    xg = x.detach().requires_grad_(True)
    one = torch.ones((), device=DEV)

    def fwd_bwd(loss_fn):
        def run():
            torch.autograd.grad(loss_fn(z, xg, weights=w), xg, one)
        return run

    def both(fn, reps):
        return (queued_ms(fn, reps=reps),
                time_ms(fn, warmup=2, reps=reps))

    with torch.no_grad():
        ms, call_ms = both(lambda: KF.focal_loss(z, x, weights=w), 50)
        plain_ms, plain_call_ms = both(
            lambda: KF.focal_loss_plain(z, x, weights=w), 20)
        plain_bwd_ms, _ = both(
            lambda: KF.focal_grad_plain(z, x, weights=w), 20)
        library_ms = (None if w is not None else
                      queued_ms(lambda: library_focal(z, x), reps=20))
    fwd_bwd_ms, fwd_bwd_call_ms = both(fwd_bwd(KF.focal_loss), 50)
    plain_fwd_bwd_ms, plain_fwd_bwd_call_ms = both(
        fwd_bwd(KF.focal_loss_plain), 20)

    n = int(np.prod(shape))
    per_el = 8 + (4 if w is not None else 0)
    extra = 1 if w is not None else 0
    bound_ms, bound_by = bound(n * per_el + 4, n * (FOCAL_FWD_FLOPS + extra))
    bwd_bound_ms, _ = bound(n * (per_el + 4) + 4,
                            n * (FOCAL_BWD_FLOPS + extra))
    return {
        "shape": {"B": FOCAL_BATCH, "h": hw, "w": hw, "classes": NUM_CLASSES,
                  "case": case},
        "max_abs_err": max(grad_err, closed_err), "sum_rel_err": sum_rel,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": library_ms,
        "bwd_ms": fwd_bwd_ms - ms, "fwd_bwd_ms": fwd_bwd_ms,
        "plain_bwd_ms": plain_bwd_ms, "plain_fwd_bwd_ms": plain_fwd_bwd_ms,
        "bwd_bound_ms": bwd_bound_ms,
        "call_ms": call_ms, "fwd_bwd_call_ms": fwd_bwd_call_ms,
        "plain_call_ms": plain_call_ms,
        "plain_fwd_bwd_call_ms": plain_fwd_bwd_call_ms,
    }


def check_focal_all(rng):
    rows = [check_focal(rng, hw) for hw in FOCAL_LEVELS]
    rows += [check_focal(rng, FOCAL_LEVELS[0], case=c)
             for c in ("weights", "extreme", "strided")]
    return rows


# --------------------------------------------------------------------------
# phase 4: the main path
# --------------------------------------------------------------------------

def build_model() -> FCOS:
    model = FCOS(num_classes=NUM_CLASSES, backbone=BACKBONE,
                 generator=torch.Generator().manual_seed(SEED))
    with torch.no_grad():
        for i in range(1, 6):
            getattr(model, f"cls_head_{i}").Conv_0.bias.fill_(CLS_HEAD_BIAS)
    return model


def predictor(model, *, buckets=BUCKETS, **serving) -> Predictor:
    decode = fcos_decode_fn("fcos", CANVAS)
    fn = make_serving_fn(model, decode, **serving)
    return Predictor.for_model(fn, model, canvas=CANVAS, buckets=buckets,
                               device=DEV)


def check_detections(name, dets, n, max_outputs=100):
    want_shapes = {"boxes": (n, max_outputs, 4), "scores": (n, max_outputs),
                   "classes": (n, max_outputs), "valid": (n, max_outputs),
                   "num_valid": (n,)}
    for key, shape in want_shapes.items():
        check(dets[key].shape == shape,
              f"{name}: {key} has shape {dets[key].shape}, want {shape} "
              f"(pad rows must be dropped)")
    check(np.isfinite(dets["boxes"]).all()
          and np.isfinite(dets["scores"]).all(), f"{name}: non-finite output")
    check((dets["num_valid"] > 0).all(),
          f"{name}: an image has no detection (num_valid {dets['num_valid']})")
    check((dets["valid"].sum(axis=1) == dets["num_valid"]).all(),
          f"{name}: valid and num_valid disagree")
    top = dets["scores"][:, 0]
    check((dets["scores"][dets["valid"]] >= 0.05).all() and (top > 0).all(),
          f"{name}: a kept score lies below the threshold")


def same_detections(name, got, want):
    for key in ("classes", "valid", "num_valid"):
        check(np.array_equal(got[key], want[key]),
              f"{name}: {key} differs between kernel path and plain path")
    for key in ("boxes", "scores"):
        diff = float(np.abs(got[key] - want[key]).max())
        check(diff <= 1e-5, f"{name}: {key} differ by {diff} between kernel "
                            f"path and plain path (tolerance 1e-5)")


def serve(pred: Predictor, requests) -> tuple[list, list]:
    outs, seconds = [], []
    for images in requests:
        t0 = time.perf_counter()
        out = pred.predict(images)   # returns host arrays: device is done
        seconds.append(time.perf_counter() - t0)
        outs.append(out)
    return outs, seconds


def breakdown(model, images8: np.ndarray) -> dict:
    """Device milliseconds (CUDA events) of the stages of one chunk, at
    batch 8 and batch 1: forward, decode, and the NMS stage of each path
    (candidate selection, sort and compaction included)."""
    from detectax_torch.infer.predict import detections_from_dense

    decode = fcos_decode_fn("fcos", CANVAS)
    out = {}
    with torch.no_grad():
        for batch in (8, 1):
            x = torch.from_numpy(images8[:batch]).to(DEV)
            levels = model(x)
            boxes, probs = decode(levels)
            t = lambda fn: time_ms(fn, warmup=2, reps=10)
            out[f"batch_{batch}"] = {
                "forward": t(lambda: model(x)),
                "decode": t(lambda: decode(levels)),
                "nms_stage_dense": t(
                    lambda: detections_from_dense(boxes, probs)),
                "nms_stage_sweep": t(lambda: detections_from_dense(
                    boxes, probs, class_aware_candidates=True)),
            }
    return out


def main_path():
    rng = np.random.default_rng(SEED + 1)
    requests = [rng.uniform(-1, 1, size=(n, CANVAS, CANVAS, 3))
                .astype(np.float32) for n in REQUESTS]
    model = build_model()
    paths = {
        "dense_nms": dict(),                             # default: fused
        "nms_sweep": dict(class_aware_candidates=True),  # top-k + sweep
    }
    preds = {name: predictor(model, **kw) for name, kw in paths.items()}

    # how many candidates the NMS stage sees above the threshold
    with torch.no_grad():
        outs = model(torch.from_numpy(requests[0]).to(DEV))
        _, probs = fcos_decode_fn("fcos", CANVAS)(outs)
    m = probs.shape[1]
    passing = int((probs.amax(-1) >= 0.05).sum())
    log(f"main path: M={m} candidates per image, {passing} of the first "
        f"image pass score_thresh 0.05")
    check(m == CANDIDATES,
          f"expected {CANDIDATES} candidates at {CANVAS} px, got {m}")
    check(passing >= 1000, "too few candidates pass the threshold for the "
                           "NMS stage to do real work")

    for p in preds.values():
        p.warmup()

    # ---- the counted run: counts set to 0 just before, read just after
    kcommon.reset_launch_counts()
    results, timings = {}, {}
    for name, p in preds.items():
        results[name], timings[name] = serve(p, requests)
    counts = kcommon.launch_counts()
    # ----

    chunks = sum(len(preds["dense_nms"]._plan(n)) for n in REQUESTS)
    for name in paths:
        check(counts.get(name, 0) == chunks,
              f"main path launched {name} {counts.get(name, 0)} times, "
              f"expected one per chunk = {chunks}")
        for n, dets in zip(REQUESTS, results[name]):
            check_detections(f"{name} path, request of {n}", dets, n)

    # the same paths on the kernels' plain versions, on the card
    for name, kw in paths.items():
        plain = predictor(model, kernels="plain", **kw)
        plain_out, _ = serve(plain, requests)
        for n, got, want in zip(REQUESTS, results[name], plain_out):
            same_detections(f"{name} path, request of {n}", got, want)
    check(kcommon.launch_counts() == counts,
          "the plain paths launched a kernel")

    # a request that needs padding: buckets (4, 8), 11 images -> 8 + 4(3).
    # The pad row must be dropped: the answer has 11 rows, and they equal
    # the first 11 of the same chunks served with a zero image as row 12.
    padded = predictor(model, buckets=(4, 8))
    check(padded._plan(11) == [8, 4], "bucket plan of the padded request")
    got = padded.predict(requests[3])
    check_detections("padded request of 11", got, 11)
    zero = np.zeros((1, CANVAS, CANVAS, 3), np.float32)
    full = padded.predict(np.concatenate([requests[3], zero]))
    for key in got:
        check(np.array_equal(got[key], full[key][:11]),
              f"padded request: {key} differs from the unpadded chunks")
    # another batch shape may round a convolution differently, so against
    # the (1, 8) plan only the best score of each image is compared
    top_diff = float(np.abs(
        got["scores"][:, 0] - results["dense_nms"][3]["scores"][:, 0]).max())
    check(top_diff <= 1e-4, f"padded request: best scores differ by "
                            f"{top_diff} from the (1, 8) plan")

    stages = breakdown(model, requests[2])
    serving = {}
    for name in paths:
        n_img = sum(REQUESTS)
        total = sum(timings[name])
        serving[name] = {
            "images_per_s": n_img / total,
            "request_ms": {str(n): s * 1e3
                           for n, s in zip(REQUESTS, timings[name])},
        }
    return counts, serving, stages


# --------------------------------------------------------------------------
# phase 5: the training path
# --------------------------------------------------------------------------

TRAIN_BATCH, TRAIN_BOXES, TRAIN_STEPS = 16, 16, 5
PATHS_RTOL = 1e-4  # kernel path against plain path, and split against unsplit


def train_batch(seed: int) -> dict:
    """A seeded numpy batch: normal images, 16 boxes an image around the
    centre, all valid."""
    rng = np.random.default_rng(seed)
    shape = (TRAIN_BATCH, TRAIN_BOXES)
    boxes = np.zeros(shape + (4,), np.float32)
    boxes[:, :, 0] = rng.uniform(0.3, 0.7, shape)
    boxes[:, :, 1] = rng.uniform(0.3, 0.7, shape)
    boxes[:, :, 2] = rng.uniform(0.05, 0.5, shape)
    boxes[:, :, 3] = rng.uniform(0.05, 0.5, shape)
    return {
        "images": rng.normal(size=(TRAIN_BATCH, CANVAS, CANVAS, 3))
        .astype(np.float32),
        "boxes": boxes,
        "labels": rng.integers(0, NUM_CLASSES, shape).astype(np.int32),
        "valid": np.ones(shape, bool),
    }


def assign_fn(boxes, labels, valid):
    return fcos_assign(boxes, labels, valid, img_dim=(CANVAS, CANVAS),
                       num_classes=NUM_CLASSES)[0]


def make_trainer(*, kernels=None, microbatch=None, loss_norm="batch",
                 freeze_bn=False):
    """Model (seeded weights, the same on every call), state, step and
    the optimizer chain."""
    model = FCOS(num_classes=NUM_CLASSES, backbone=BACKBONE,
                 freeze_bn=freeze_bn,
                 generator=torch.Generator().manual_seed(SEED)).to(DEV)
    opt = make_optimizer("sgd", exponential_with_floor(5e-4), grad_clip=1.0)
    step = make_train_step(
        model, assign_fn, functools.partial(fcos_loss, kernels=kernels), opt,
        microbatch=microbatch, loss_norm=loss_norm)
    return model, create_train_state(model, None, opt), step, opt


def run_steps(state, step, batches):
    """Per-step metrics (host floats) and device ms (CUDA events)."""
    metrics, ms = [], []
    for batch in batches:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        state, m = step(state, batch)
        end.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end))
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, ms


def profile_steps(state, step, batches) -> dict | None:
    """Device busy time and idle share of a few train steps by
    `torch.profiler` (the kernels' own times summed against the steps'
    time under the profiler, which is slower than without it). None when
    the profiler saw no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, ms = run_steps(state, step, batches)
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    if busy <= 0:
        return None
    kernels.sort(key=lambda e: -e.self_device_time_total)
    n = len(batches)
    return {
        "steps": n, "step_ms_under_profiler": ms,
        "device_busy_ms_per_step": busy / n,
        "idle_share": 1.0 - busy / sum(ms),
        "kernel_launches_per_step": sum(e.count for e in kernels) / n,
        "top_kernels_ms_per_step": [
            [e.key[:70], e.self_device_time_total / 1e3 / n, e.count // n]
            for e in kernels[:8]],
    }


def close(a: float, b: float, rtol: float) -> bool:
    return abs(a - b) <= rtol * max(abs(a), abs(b))


def train_path():
    batches = [{k: cuda(v) for k, v in train_batch(SEED + 10 + i).items()}
               for i in range(TRAIN_STEPS)]
    _, state, step, _ = make_trainer()
    run_steps(state, step, batches[:1])       # warm-up: cuDNN picks plans
    del state, step
    model, state, step, _ = make_trainer()
    stem_bn = next(m for m in model.modules() if hasattr(m, "running_mean"))
    mean0 = stem_bn.running_mean.clone()
    torch.cuda.reset_peak_memory_stats()

    # ---- the counted run: counts set to 0 just before, read just after
    kcommon.reset_launch_counts()
    t0 = time.perf_counter()
    metrics, step_ms = run_steps(state, step, batches)
    wall = time.perf_counter() - t0
    counts = kcommon.launch_counts()
    # ----
    peak = torch.cuda.max_memory_allocated()

    check(state.step == TRAIN_STEPS, f"step count {state.step}")
    for i, m in enumerate(metrics):
        check(all(np.isfinite(v) for v in m.values()),
              f"training step {i + 1}: non-finite metric {m}")
    levels = len(FOCAL_LEVELS)
    check(counts.get("focal_fwd", 0) == levels * TRAIN_STEPS,
          f"training launched focal_fwd {counts.get('focal_fwd', 0)} times, "
          f"expected {levels} a step = {levels * TRAIN_STEPS}")
    check(counts.get("focal_bwd", 0) == levels * TRAIN_STEPS,
          f"training launched focal_bwd {counts.get('focal_bwd', 0)} times, "
          f"expected {levels} a step = {levels * TRAIN_STEPS}")
    moved = float((stem_bn.running_mean - mean0).abs().max())
    check(moved > 0, "BatchNorm running statistics did not move")

    # the same steps from the same initial state on the plain versions
    del model, state, step
    _, pstate, pstep, _ = make_trainer(kernels="plain")
    plain_metrics, plain_ms = run_steps(pstate, pstep, batches)
    check(kcommon.launch_counts() == counts,
          "the plain training path launched a kernel")
    agree = {}
    for key in ("total", "cls", "grad_norm"):
        a, b = metrics[0][key], plain_metrics[0][key]
        agree[key] = abs(a - b) / max(abs(a), abs(b))
        check(close(a, b, PATHS_RTOL),
              f"step 1 {key}: kernel path {a}, plain path {b} "
              f"(tolerance rtol {PATHS_RTOL})")
    del pstate, pstep

    # one step split into chunks of 4 under loss_norm="pos" against the
    # unsplit step. BatchNorm is frozen for this comparison: with live
    # statistics a chunk normalizes by its own 4 images, which is another
    # function than the batch of 16
    split = {}
    for micro in (None, 4):
        _, mstate, mstep, _ = make_trainer(
            microbatch=micro, loss_norm="pos", freeze_bn=True)
        m, ms = run_steps(mstate, mstep, batches[:1])
        split[micro] = (m[0], ms[0])
        del mstate, mstep
    for key in ("grad_norm", "total"):
        a, b = split[4][0][key], split[None][0][key]
        check(close(a, b, PATHS_RTOL),
              f"microbatch 4 {key} {a} against the unsplit step's {b} "
              f"(tolerance rtol {PATHS_RTOL})")

    # where a step's device time goes (separate timings of its parts)
    model, state, step, opt = make_trainer()
    b0 = batches[0]
    with torch.no_grad():
        y_true = assign_fn(b0["boxes"], b0["labels"], b0["valid"])
        preds = model(b0["images"], train=True)
        parts = {
            "assign": time_ms(lambda: assign_fn(
                b0["boxes"], b0["labels"], b0["valid"]), warmup=1, reps=5),
            "forward_no_grad": time_ms(
                lambda: model(b0["images"], train=True), warmup=1, reps=3),
            "loss_forward": time_ms(lambda: fcos_loss(y_true, preds),
                                    warmup=1, reps=5),
        }
    grads = [torch.zeros_like(p) for p in model.parameters()]
    parts["grad_norm"] = time_ms(lambda: global_norm(grads),
                                 warmup=1, reps=3)
    norm = global_norm(grads)  # a step computes it once, for both
    parts["clip_and_update"] = time_ms(
        lambda: opt.update(state.opt, grads, 0, grad_norm=norm),
        warmup=1, reps=3)
    steady = step_ms[1:]
    parts["backward_and_rest"] = (
        sum(steady) / len(steady) - sum(parts.values()))
    profiled = profile_steps(state, step, batches[:2])
    return counts, {
        "batch": TRAIN_BATCH, "steps": TRAIN_STEPS,
        "step_ms": step_ms, "plain_path_step_ms": plain_ms,
        "step_ms_mean_after_first": sum(steady) / len(steady),
        "images_per_s": TRAIN_BATCH * TRAIN_STEPS / wall,
        "peak_memory_bytes": peak,
        "metrics_step_1": metrics[0], "metrics_last": metrics[-1],
        "plain_metrics_step_1": plain_metrics[0],
        "kernel_vs_plain_rel": agree,
        "microbatch_4": {"grad_norm": split[4][0]["grad_norm"],
                         "unsplit_grad_norm": split[None][0]["grad_norm"],
                         "step_ms": split[4][1],
                         "unsplit_step_ms": split[None][1]},
        "parts_ms": parts,
        "profile": profiled if profiled else "not measured",
        "bn_running_mean_moved": moved,
    }


# --------------------------------------------------------------------------
# phase 6: the command-line trainer, and serving from its checkpoint
# --------------------------------------------------------------------------

def cli_path():
    from detectax_torch.cli import train_fcos

    with tempfile.TemporaryDirectory() as tmp:
        ckpt_dir = os.path.join(tmp, "ckpt")
        kcommon.reset_launch_counts()
        summary = train_fcos.main([
            "--backbone", BACKBONE, "--canvas", str(CANVAS),
            "--batch_size", "16", "--max_steps", "4", "--display_step", "2",
            "--step_save", "4", "--synthetic_n", "64",
            "--ckpt_dir", ckpt_dir, "--out_dir", os.path.join(tmp, "out"),
        ])
        counts = kcommon.launch_counts()
        check(summary["final_step"] == 4, f"CLI trained {summary}")
        check(np.isfinite(summary["total"]) and np.isfinite(
            summary["grad_norm"]), f"CLI metrics not finite: {summary}")
        check(counts.get("focal_fwd", 0) == 20
              and counts.get("focal_bwd", 0) == 20,
              f"CLI training launched {counts}, expected 20 and 20")
        nc = 3  # the synthetic dataset's classes
        model = FCOS(num_classes=nc, backbone=BACKBONE).to(DEV)
        fresh = model.cls_head_1.Conv_0.weight.clone()
        restore_for_inference(ckpt_dir, model)
        check(not torch.equal(fresh, model.cls_head_1.Conv_0.weight),
              "restore left the model's weights as they were")
    # four steps from the focal prior leave every score near 0.01: serve
    # with no score threshold so that the request has detections to check
    fn = make_serving_fn(model, fcos_decode_fn("fcos", CANVAS),
                         score_thresh=0.0)
    pred = Predictor.for_model(fn, model, canvas=CANVAS, buckets=BUCKETS,
                               device=DEV)
    rng = np.random.default_rng(SEED + 2)
    images = rng.uniform(-1, 1, size=(8, CANVAS, CANVAS, 3)) \
        .astype(np.float32)
    dets = pred.predict(images)
    check(dets["boxes"].shape == (8, 100, 4)
          and dets["scores"].shape == (8, 100)
          and dets["num_valid"].shape == (8,),
          "request from the checkpoint: wrong output shapes")
    check(np.isfinite(dets["boxes"]).all()
          and np.isfinite(dets["scores"]).all(),
          "request from the checkpoint: non-finite output")
    check((dets["num_valid"] > 0).all()
          and (dets["classes"][dets["valid"]] < nc).all(),
          "request from the checkpoint: no or impossible detections")
    return {k: summary[k] for k in ("final_step", "images_per_sec", "total",
                                    "grad_norm")}


# --------------------------------------------------------------------------

def main() -> None:
    if not torch.cuda.is_available():
        sys.stderr.write(
            "chip_smoke.py needs a CUDA device; none is available\n")
        sys.exit(1)
    t_start = time.perf_counter()
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        timeout=60,
    ).stdout.strip().splitlines()
    card = smi[0] if smi else "nvidia-smi gave nothing"
    log(f"device: {kind} | torch {torch.__version__} cuda {torch.version.cuda}")
    log(f"nvidia-smi name, power.limit: {card}")
    log(f"tf32: {json.dumps(runtime.set_tf32(False))}")

    kcommon.load_library(verbose=True)
    K.load_kernels()
    built = kcommon.build_seconds()
    log("kernels found built and loaded" if built is None
        else f"kernels built and loaded in {built:.1f} s")

    round_us = barrier_round_us()
    log(f"empty round (exchange + barrier, 1024 threads, 8 blocks): "
        f"{round_us:.4f} us")

    rng = np.random.default_rng(SEED)
    sweep = [
        check_sweep(rng, 8, 1024, class_aware=True, with_valid=False),
        check_sweep(rng, 8, 1024, class_aware=False, with_valid=True),
        check_sweep(rng, 8, 2048, class_aware=True, with_valid=False),
    ]
    dense = [check_dense(rng, 8, 3069, 100), check_dense(rng, 8, 8525, 200)]
    for name, rows in (("nms_sweep", sweep), ("dense_nms", dense)):
        for r in rows:
            # floor of a one-block-per-image design: the rounds of its
            # longest image, each no more than an empty round
            r["chain_ms"] = r["rounds_max"] * round_us * 1e-3
            log(f"kernel {name} {json.dumps(r)}")
    focal = check_focal_all(rng)
    for r in focal:
        log(f"kernel focal {json.dumps(r)}")

    counts, serving, stages = main_path()
    log("serving " + json.dumps({"card": card, "model": f"FCOS {BACKBONE} FPN",
                                 "canvas": CANVAS, "dtype": "float32",
                                 "buckets": BUCKETS, "requests": REQUESTS,
                                 "paths": serving,
                                 "stage_ms": stages}))

    train_counts, training = train_path()
    log("training " + json.dumps({
        "card": card, "model": f"FCOS {BACKBONE} FPN", "canvas": CANVAS,
        "dtype": "float32", "classes": NUM_CLASSES, **training}))
    log("cli " + json.dumps(cli_path()))
    counts = {**counts, "focal": train_counts["focal_fwd"]}
    levels = focal[:len(FOCAL_LEVELS)]
    focal[0]["launches_bwd"] = train_counts["focal_bwd"]
    focal[0]["all_levels_fwd_ms"] = sum(r["ms"] for r in levels)
    focal[0]["all_levels_fwd_bwd_ms"] = sum(r["fwd_bwd_ms"] for r in levels)
    focal[0]["all_levels_fwd_bwd_call_ms"] = sum(
        r["fwd_bwd_call_ms"] for r in levels)

    meta = {
        "nms_sweep": ("detectax_torch/kernels/csrc/nms_sweep.cu",
                      "detectax/ops/pallas/nms_kernel.py:105", sweep),
        "dense_nms": ("detectax_torch/kernels/csrc/dense_nms.cu",
                      "detectax/ops/pallas/nms_kernel.py:247", dense),
        "focal": ("detectax_torch/kernels/csrc/focal.cu",
                  "detectax/ops/pallas/focal.py:75", focal),
    }
    kernels = []
    for name, (source, replaces, rows) in meta.items():
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": counts[name],
            **rows[0], "other_shapes": rows[1:],
        })
    log(f"chip_smoke took {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels, "bound_note": BOUND_NOTE}))
    log(card)  # name, power.limit as nvidia-smi gives them
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
