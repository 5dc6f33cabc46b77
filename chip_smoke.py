#!/usr/bin/env python3
"""GPU smoke run of the PyTorch / CUDA port: ``python3 chip_smoke.py``.

Needs one NVIDIA GPU (written for an H100) and ``nvcc``; there is no CPU
branch, and any failed phase ends the run with a non-zero exit code. In
order:

1. device: name, ``nvidia-smi`` name and power limit, TF32 switches (off);
2. builds the CUDA kernels from ``detectax_torch/kernels/csrc`` and loads
   them;
3. holds each kernel against its plain PyTorch version on the card, exact
   match, at the shapes of the main path and on inputs (numpy, seeded) with
   heavy overlap, exact score ties, duplicates, degenerate boxes and
   padding; times kernel and plain version with CUDA events;
4. drives the main path at full width: FCOS, ResNet-50 + FPN, 20 classes,
   384 px, fp32, seeded weights, through `Predictor` with buckets (1, 8) —
   once with the default NMS (fused dense kernel) and once with
   combined-NMS candidates (top-k + sweep kernel) — and checks launch
   counts, shapes, finiteness and equality with the same path run on the
   kernels' plain versions;
5. prints one JSON line ``{"kernels": [...]}`` and, last, the ``ok`` line.

It imports `detectax_torch` only — nothing of JAX or of `detectax`.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from detectax_torch import runtime
from detectax_torch.infer.export import fcos_decode_fn, make_serving_fn
from detectax_torch.infer.serving import Predictor
from detectax_torch.kernels import _common as kcommon
from detectax_torch.kernels import nms as K
from detectax_torch.kernels.probe import barrier_probe
from detectax_torch.models import FCOS

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

BOUND_NOTE = (
    "bound_ms is the larger of bytes/3.35e12 and operations/67e12 and "
    "bound_by names which; the chain of dependent rounds is not part of "
    "it: chain_ms = rounds_max x the empty round measured in this run, the "
    "floor of a one-block-per-image design, stands beside it as its own key")

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

    counts, serving, stages = main_path()
    log("serving " + json.dumps({"card": card, "model": f"FCOS {BACKBONE} FPN",
                                 "canvas": CANVAS, "dtype": "float32",
                                 "buckets": BUCKETS, "requests": REQUESTS,
                                 "paths": serving,
                                 "stage_ms": stages}))

    meta = {
        "nms_sweep": ("detectax_torch/kernels/csrc/nms_sweep.cu",
                      "detectax/ops/pallas/nms_kernel.py:105", sweep),
        "dense_nms": ("detectax_torch/kernels/csrc/dense_nms.cu",
                      "detectax/ops/pallas/nms_kernel.py:247", dense),
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
