#!/usr/bin/env python3
"""GPU smoke run of the PyTorch / CUDA port: ``python3 chip_smoke.py``.

Needs one NVIDIA GPU (written for an H100) and ``nvcc``; there is no CPU
branch, and any failed phase ends the run with a non-zero exit code. In
order:

1. device: name, ``nvidia-smi`` name and power limit, TF32 switches (off);
2. builds the CUDA kernels from ``detectax_torch/kernels/csrc`` and loads
   them;
3. times an empty kernel launch (the floor under every kernel's time) and
   the empty steps of the NMS designs (``kernels/probe.py``: the
   block round, the cluster rounds at cluster sizes 1-16, the sweep's
   chain step), then holds each kernel against its plain PyTorch version
   on the card, at the shapes of the main paths: the two NMS kernels to an
   exact match, two runs bitwise equal, on inputs (numpy, seeded) with
   heavy overlap, exact score ties, duplicates, degenerate boxes and
   padding, and at edge cases (K = 256, K not a multiple of 64, all
   padding, one class; M below the cluster size, M = 1, nothing above the
   threshold, one class, class-agnostic, no classes), and past the
   register and ring tiers of their plans (`nms_sweep` at K = 16,384 and
   20,000; `dense_nms` at M = 76,725 and 81,920 staged in shared memory,
   and 327,680 read from device memory; and, untimed, K = 15,001 with
   padding and no classes, M = 70,001 with no classes and M = 150,001
   class-agnostic); `nms_sweep`'s mask
   kernel word for word against `suppression_bits_plain`; the focal-loss
   kernel (forward sum rtol 2e-4, dlogits atol 1e-5, two runs bitwise equal) at
   the five level shapes, with a weight mask, with logits of +-100, and
   on a strided view, a view at an odd float offset and the stride-25
   class channels each bitwise equal to their clones (sum and dlogits:
   the order of a sum depends on the sizes alone), and its grouped call
   (`focal_loss_group`: one
   forward and one backward launch) segment by segment on the five FCOS
   levels read in place, ten segments (class + centerness), one segment,
   a segment of one element, a segment of no rows, mixed weights and
   extreme logits, every call through the ``torch.library`` operators
   ``detectax_torch::focal_group`` / ``focal_group_bwd`` (checked on each
   result's autograd graph), which `torch.library.opcheck` then checks
   on CUDA segments at the five level shapes with a weight mask, and
   whose grouped forward and backward at those shapes, captured in one
   `torch.cuda.graph`, must replay the eager call's bits (a replay counts
   no launches: the count is taken in Python, at capture); the
   peak-decode kernel in both modes
   (`peak_mask_scores` to an exact match, NaN pattern included;
   `peak_scores` to 1e-6, a differing keep/zero decision allowed only
   within 2 ulp of the neighbourhood maximum) on plateaus, all-zero
   planes, values below the -1 border fill, NaN and +-inf, 1 x N maps, a
   strided view, the folded [H, W, P] layout and the band edges of its
   plan (a last band shorter than the others, a band clamped to the map,
   column tiles, channel tiles); times kernels and plain versions with
   CUDA events;
4. drives the serving path at full width: FCOS, ResNet-50 + FPN, 20
   classes, 384 px, fp32, seeded weights, through `Predictor` with buckets
   (1, 8) — once with the default NMS (fused dense kernel) and once with
   combined-NMS candidates (top-k + sweep kernel) — and checks launch
   counts, shapes, finiteness and equality with the same path run on the
   kernels' plain versions;
5. drives the training path at the same width, batch 16: 3 steps through
   `make_train_step` with `fcos_assign`, `fcos_loss`, SGD-momentum and
   clip 1.0 on the kernel path, the same 3 steps from the same initial
   state on the plain versions, and one microbatched step; checks launch
   counts, finiteness, agreement of the two paths, and that BatchNorm
   statistics moved;
6. trains 4 steps through the command-line entry point
   `detectax_torch.cli.train_fcos` on the synthetic dataset, restores the
   checkpoint it wrote and serves one 8-image request from it;
7. drives the CenterNet paths at full width: serves `CenterNetFPNSingle`
   (ResNet-50, 20 classes, 384 px) through `Predictor` — peak-decode
   kernel and fused dense NMS kernel, one launch each a chunk — and one
   8-image chunk of `CenterNetS8` (5 slots, 11,520 candidates an image),
   both held against the same paths on the plain versions; trains
   `CenterNetFPNSingle` at batch 16 for 3 steps on the kernel path and 3
   on the plain path (`centernet_heatmap_assign`, `fcos_loss`, Adam);
   trains 3 steps through `detectax_torch.cli.train_centernet_heatmap`
   and serves one request from its checkpoint; trains `CenterNetS8` at
   its reference 512 px, batch 16, 5 slots, for 2 steps on the kernel
   path and 2 on the plain path (`centernet_scale_slot_assign`,
   `centernet_s8_loss`, SGD); trains 2 steps through
   `detectax_torch.cli.train_centernet_crowdhuman` and serves one 8-image
   request at 512 px (20,480 candidates an image) and one 1-image request
   at 1024 px (81,920) from its checkpoint;
8. DetBench, evaluation and the FCOS center variants: trains 4 steps
   through `cli.train_fcos --dataset detbench` at 384 px, batch 16, from
   the crop-pretrained ResNet-50 trunk in `benchmarks/` (from a fresh
   init, with a log line, where the checkout lacks it), then runs
   `cli.evaluate --dataset detbench` over the 256-image eval split on the
   kernels and on their plain versions, whose summaries must be equal;
   trains FCOS "center" (Adam) and "center_v1" (SGD), the centerness a
   focal term, for 2 steps on the kernel path and 2 on the plain path,
   then through `cli.train_fcos_center_voc` and
   `cli.train_fcos_center_v1_voc`, and serves one request from each
   checkpoint on the kernels and on the plain versions;
9. the RetinaNet family: serves ResNet-101 RetinaNet (81 classes, 9
   anchors, 512 px: 49,104 candidates an image) through `Predictor` with
   buckets (1, 8) and the request mix in `cli.evaluate`'s NMS
   configuration (class-aware, score 0.05, 100 outputs) and in
   `cli.infer_retinanet`'s (class-agnostic, 0.30, 200), and one 1024-px
   image (196,416 candidates: the dense kernel's device-memory tier), each
   against the same path on the plain versions; trains it at batch 16 for
   3 steps on the kernel path and 3 on the plain path
   (`retinanet_assign`, `retinanet_loss`: the five levels' class channels,
   81 of 85 columns, in one grouped focal call; SGD piecewise, clip 1.0);
   trains 2 steps through `cli.train_retinanet_coco` (its zero-target
   filter on) and serves one request from its checkpoint; trains 4 steps
   of `cli.train_retinanet_coco --dataset detbench_v2 --backbone
   mobilenetv2 --bf16 --no-skip_zero_target` and evaluates the
   256 eval images (`cli.evaluate --family retinanet`) on the kernels and
   on the plain versions, summaries equal. Phase 3 holds the kernels at
   these shapes first: the RetinaNet focal group (63,638,784 elements,
   forward and backward, bitwise equal to its contiguous clones) and
   `dense_nms` at B = 8, M = 49,104 (class-aware, 100 outputs;
   class-agnostic, 200) and B = 1, M = 196,416 (class-agnostic, 200);
10. bf16 compute: FCOS-R50 at 384 px, batch 16, 3 steps on the kernel
   path and 3 on the plain path (step 1 to 1e-4, the last step to
   `BF16_LATER_RTOL`, 2e-2), and 3 RetinaNet-R101 bf16 steps at 512 px,
   each step's ms beside the float32 step's;
11. the hourglass half of the CenterNet family at the TPU rows' widths
   (`HourglassNet` n_filters 12, `StackedHourglass` n_filters 64 with two
   stacks; 20 classes, 320 px, 6,400 candidates an image): serves both
   through `Predictor` with buckets (1, 8) and the request mix with the
   default NMS (dense kernel) and with combined-NMS candidates (top-k +
   sweep kernel), each against the same path on the plain versions;
   trains each at its TPU row's batch (32, 16) for 3 steps on the kernel
   path and 3 on the plain path (Adam, the epoch schedule; `HourglassNet`
   with the focal class loss), step 1 to 1e-4 and the BatchNorm
   statistics moved, then 2 bf16 steps; trains 2 steps of
   `cli.train_hourglass_voc --variant stacked --multi_scale 256 320` and
   of the sigmoid `HourglassNet` on the synthetic set (microbatches of 2)
   and serves one request from the stacked checkpoint; trains 2 steps of
   the TPU DetBench v2 row's command line and evaluates the 256 eval
   images (`cli.evaluate --family stacked_hourglass`) on the kernels and
   on the plain versions, summaries equal; then the dense-crowd split's
   row (v2_crowd, `row_argvs`: up to 128 boxes an image) the same way,
   2 steps (16 + 16 focal launches), and its 128 eval images at K = 2,048
   and 200 outputs (16 `dense_nms` launches), every image's detections
   equal; then the crowd `HourglassNet` row (`row_argvs(...,
   "hourglass", ...)`, batch 32, the sigmoid class loss: no focal launch)
   on the same
   cache, 2 steps and the 128 eval images the same way (16 more
   `dense_nms` launches). Phase 3 holds the kernels at these shapes
   first: the two class terms read in place (`[16, 80, 80, 20]` of 24
   and `[32, 40, 40, 4, 21]` of 25, each bitwise equal to its contiguous
   clone) and `dense_nms` at B = 8, M = 6,400 (100 and 200 outputs) and
   12,544 (the 448 bucket);
12. exported serving bundles: exports the checkpoints of phases 6, 7, 9
   and 11 through `detectax_torch.cli.export_model` (buckets 1 and 8, one
   `torch.export` program a bucket with the weights as call arguments;
   the CLI's own verification must pass): FCOS-R50 at 384 px with the
   default NMS (`dense_nms` in the program) and with combined-NMS
   candidates (`nms_sweep` at K = 1,024), `CenterNetFPNSingle`-R50 (`peak`
   and `dense_nms`), RetinaNet-R101 at 512 px (`dense_nms` at M = 49,104)
   and `StackedHourglass` n_filters 64 with two stacks at 320 px
   (`dense_nms` at M = 6,400); replays the request mix through
   `load_bundle` and holds it against the live `Predictor` on the kernels
   and on the plain versions (classes, valid and num_valid exactly, boxes
   and scores to 1e-5), with one launch of each operator a chunk and no
   parameter or buffer in any program; prints each bucket's export
   seconds, the programs' bytes beside the weights file's, the load
   seconds and the replayed and live request times;
13. data parallelism (`detectax_torch.parallel`): trains 3 steps of
   FCOS-R50 at 384 px, global batch 16, through `torchrun
   --nproc_per_node 1 -m detectax_torch.cli.train_fcos` (NCCL) and
   through the same CLI in this process, step 1's ``total``, ``cls`` and
   ``grad_norm`` equal to 1e-6; under torchrun, the step with a group of
   one (NCCL) against the step without one in the same process, fp32 and
   bf16, with the collectives a step and the time of an all-reduce of a
   BatchNorm layer's moments and of the gradient; two gloo ranks sharing
   the card (NCCL refuses two ranks on one card; both build the kernels
   at once from an empty build) on the same 3 global batches as phase 5,
   step 1 equal to phase 5's to `PATHS_RTOL`, each rank launching focal
   once forward and once backward a step; `cli.evaluate --data_parallel`
   at batch 8 on the two ranks over 16 synthetic images from phase 6's
   checkpoint against `cli.evaluate` in this process at a rank's batch
   (4, the shape each image's forward has on a rank: cuDNN picks its
   algorithm by the shape), the same detections exactly; and FSDP
   (`shard_train_state(fsdp=True)`, 3 SGD steps of the same FCOS-R50
   at global batch 16): one NCCL rank under torchrun, every leaf of 2**16
   elements or more "sharded" over it (NCCL's all-gather and
   reduce-scatter), step 1's ``total``, ``cls`` and ``grad_norm`` equal
   to the data-parallel step's to 1e-6; two gloo ranks sharing the card,
   step 1 equal to phase 5's to `PATHS_RTOL`, each rank launching focal
   once forward and once backward a step, the ranks' gathered states
   bitwise equal, and the checkpoint every rank saved restored in this
   process, without a group, equal to that state; each with its step ms,
   collectives a step, the bytes of parameters and optimizer state a rank
   holds and the peak of allocated memory beside data parallelism's;
14. ingestion, from raw files to a trained checkpoint: writes 64 seeded
   JPEGs at VOC's sizes (500 x 375 and 375 x 500, quality 90) with one
   VOC XML annotation each (1-6 objects over the 20 classes), converts
   them with `detectax_torch.cli.convert_voc` (the index's samples and
   objects against what was written), builds the native JPEG loader
   (``g++`` and libjpeg; where libjpeg alone is missing it says so and the
   rest runs on PIL), runs the `Loader` at the main config (batch 16,
   384 px, 8 batches) natively and on PIL (boxes equal, mean pixel
   difference under 0.2, each one's images/s), trains 4 steps of
   `cli.train_fcos --index` at 384 px, batch 16 (focal 4 + 4 launches),
   evaluates the 64 images from its checkpoint through `cli.evaluate
   --index` on the kernels and on the plain versions (every batch's
   detections equal), and ports a seeded torchvision-layout ResNeXt-50
   with `tools.port_tf_weights.port_torch_resnext` through the ``.npz``
   into the port's ``resnext50:torch`` trunk on the card (C3-C5 to 1e-4 of
   each tap's largest magnitude);
15. the measurement programs: `bench_torch.py`'s four lines in-process
   at 6 steps in 2 windows (the training lines' names, finite rates above
   0, ``0 < mfu_pct <= 100``, the step's operation count equal to the
   same step's count on the CPU, one focal launch each way a step, one
   `dense_nms` launch a decode call; the decode line's detections on its
   own inputs equal to the plain version's, exactly),
   `detectax_torch.bench.serving` at buckets 1, 8 and 16 for 3
   iterations (one `dense_nms` launch a call; each bucket's detections
   equal to the plain version's on the same model outputs, exactly), the
   same buckets again with the class heads' bias raised so that NMS has
   work (every image keeping a detection, again equal to the plain
   version's) and `detectax_torch.bench.profile_step` (its categories summing to the
   profiler's device total within 1 %, the focal kernels there by name);
16. crop pretraining and the DetBench driver: 40 steps of
   `detectax_torch.bench.pretrain_backbone` for MobileNetV2 at batch 64,
   crops of 128 px (losses finite, the saved trunk's tree that of the
   committed JAX trunk); `python -m detectax_torch.bench.run_detbench
   --families centernet_s8` and `--families centernet_heatmap`, `--steps
   4`, from that trunk as two subprocesses at once (both rows written, the
   trunk loaded); the
   centernet_heatmap row's evaluation in this process on the kernels and
   on their plain versions (summaries equal, one `dense_nms` and one
   `peak` launch a batch, exactly);
17. the space-to-depth stem and the last measurement programs: the
   stem's two evaluations at the flagship's input (`ConvBN(s2d=True)`
   against its plain evaluation, fp32 to 1e-4 of the output's largest
   magnitude with TF32 off, bf16 within twice the plain stem's own bf16
   error plus 1e-3, both BatchNorm modes; one fp32 FCOS-R50 step with
   ``DETECTAX_S2D_STEM=1`` against the plain stem's from the same state,
   ``total`` to 1e-4; the stem's bf16 forward + backward timed both
   ways); the grouped focal kernel against its plain version at the level
   maps the programs train at besides 384 px and batch 16 (512 and 640 px
   at batch 16, 384 px at batch 32; `check_focal_group`'s tolerances);
   then in this process, at full width (FCOS-R50, 384 px, batch
   16, bf16): `detectax_torch.bench.mfu_breakdown` ``--only phases`` (4
   steps in 4 windows, one window of each graph a round: the seven rows,
   every graph's ms above 0, ``0 < mfu_pct <= 100`` but on the
   assignment, which counts 0 operations, full step >= grad >=
   forward+loss within the windows' spread), ``--only canvas`` and ``--only levers`` (2 steps an arm),
   `config_frontier` (all eight arms), `s2d_ab` and `pool_ab` (2 steps an
   arm; their switches restored; the s2d arm's own count above the plain
   stem's), `latency_reconcile` (three protocols finite and above 0, one
   application's detections equal to the plain version's exactly, the
   CUDA graph holding 50 `dense_nms` launches, counted at capture, and
   its replay's sum that of 50 applications) and `diag_export` on the
   checkpoint of 2 steps of `cli.train_fcos` for a MobileNetV2 FCOS at
   384 px, then on its weights with the class heads' bias raised
   (``num_valid`` equal live and replayed, the dense outputs to 1e-4);
   every program's kernel launches exactly as its graphs call them;
18. prints the seconds each phase took (``phase_seconds``), one JSON line
   ``{"kernels": [...]}`` and, last, the ``ok`` line.

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
from detectax_torch.infer.export import (
    centernet_decode_fn,
    fcos_decode_fn,
    hourglass_decode_fn,
    make_serving_fn,
    retinanet_decode_fn,
)
from detectax_torch.infer.serving import Predictor
from detectax_torch.kernels import _common as kcommon
from detectax_torch.kernels import focal as KF
from detectax_torch.kernels import nms as K
from detectax_torch.kernels import peak as KP
from detectax_torch.kernels import probe as KB
from detectax_torch.models import (
    FCOS,
    CenterNetFPNSingle,
    CenterNetS8,
    HourglassNet,
    RetinaNet,
    StackedHourglass,
)
from detectax_torch.models.layers import BatchNorm
from detectax_torch.ops.anchors import anchor_shapes_per_level
from detectax_torch.ops.assign import (
    centernet_heatmap_assign,
    centernet_scale_slot_assign,
    fcos_assign,
    fcos_center_assign,
    fcos_center_v1_assign,
    hourglass_assign,
    retinanet_assign,
    stacked_hourglass_assign,
)
from detectax_torch.train.driver import restore_for_inference
from detectax_torch.train.loop import create_train_state, make_train_step
from detectax_torch.train.losses import (
    centernet_s8_loss,
    fcos_loss,
    hourglass_loss,
    retinanet_loss,
    stacked_hourglass_loss,
)
from detectax_torch.train.schedules import (
    epoch_decay,
    exponential_with_floor,
    global_norm,
    make_optimizer,
    piecewise_constant,
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

# ... and per element of the peak decode: 8 comparisons; with the sigmoid,
# 9 scores of 4 operations each (negate, exp, add, divide) besides
PEAK_FLOPS, PEAK_SIGMOID_FLOPS = 8, 8 + 9 * 4
PEAK_ATOL = 1e-6      # peak_scores values: an ulp of expf
PEAK_TIE_ULPS = 2     # a keep/zero decision may differ only this close

BOUND_NOTE = (
    "bound_ms is the larger of bytes/3.35e12 and operations/67e12 and "
    "bound_by names which. The chain of dependent steps is not part of it: "
    "chain_ms, a key of its own, is the floor of each NMS design measured "
    "in this run - nms_sweep: K x an empty chain step (chain_probe, "
    "ns_per_step beside it is the kernel's own); dense_nms: rounds_max x "
    "the empty round of its cluster exchange (cluster_probe "
    "exchange_round) at the cluster size and threads the launch used "
    "(us_per_round beside it is the kernel's own). NMS ms is device time "
    "of calls queued behind a blocker, call_ms what a caller on this host "
    "sees. launch_floor_ms is the device time of an empty kernel launch "
    "queued behind a blocker, the floor under every ms. focal: launches "
    "counts the forward launches of the training runs (launches_bwd the "
    "backward ones; FCOS groups its five levels into one launch each "
    "way); ms, plain_ms and library_ms are device times of the forward "
    "queued behind a blocker, the call_ms keys what a caller on this host "
    "sees; all_levels_* are one focal_loss_group call over the five FCOS "
    "levels' class channels read in place (its bound over their 982,080 "
    "elements), five_calls_* the five single calls of the per-level rows; "
    "sum_ms is torch's own sum of the same logits (a reduction over the "
    "same elements with no focal arithmetic); an element is charged "
    "24 operations forward and 30 backward, each transcendental call and "
    "division counted as one. peak: copy_ms is torch's clone of the map "
    "(the same bytes in and out, no work); ms, plain_ms and library_ms are device "
    "times queued behind a blocker, call_ms what a caller on this host "
    "sees; library_ms is torch.where(p >= max_pool2d(p, 3, 1, 1), p, 0) "
    "on an NCHW copy made outside the timing - two calls, and it pads "
    "with -inf, so it is another function at the border. launches is the "
    "sum over the counted runs listed in launches_by_path")

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


def _slope(run, short: int, long: int) -> float:
    """Microseconds a step of `run(steps)`, as the slope between a short and
    a long chain so that the launch itself cancels."""
    t = {n: time_ms(lambda n=n: run(n), warmup=2, reps=10)
         for n in (short, long)}
    return (t[long] - t[short]) * 1e3 / (long - short)


def barrier_round_us(blocks: int = 8) -> float:
    """One empty round of a one-block-per-image design: shared-memory
    exchange + barrier of a 1024-thread block."""
    return _slope(lambda n: KB.barrier_probe(n, blocks, DEV), 1000, 11000)


@functools.cache
def cluster_round_us(cluster: int, threads: int,
                     mode: str = "exchange_round") -> float:
    """One empty round across 8 clusters of `cluster` blocks of `threads`
    threads (`probe.CLUSTER_MODES`)."""
    return _slope(lambda n: KB.cluster_probe(n, 8, cluster, DEV, threads,
                                             mode), 1000, 11000)


def chain_step_ns() -> float:
    """One empty step of the sweep's chain, 8 warps on 8 SMs."""
    return _slope(lambda n: KB.chain_probe(n, 8, DEV), 6400, 64000) * 1e3


def bound(bytes_moved: int, flops: int) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_flops = flops / FP32_FLOPS * 1e3
    return max(t_bytes, t_flops), ("bytes" if t_bytes >= t_flops
                                   else "operations")


# --------------------------------------------------------------------------
# phase 3: each kernel against its plain version
# --------------------------------------------------------------------------

def check_sweep(rng, batch, k, *, class_aware, with_valid, case="crowded",
                timed=True, plain_reps=2):
    """`nms_sweep` and its mask kernel alone against the plain versions on
    score-sorted crowded boxes: keep bits and mask words exactly, two runs
    bitwise equal. `case`: "crowded", "all_invalid" (every candidate
    padding), "one_class" (every candidate of class 3)."""
    boxes, scores, classes = make_candidates(
        rng, batch, k, pad_tail=k // 16 if with_valid else 0)
    if case == "one_class":
        classes[:] = 3
    order = np.argsort(-scores, axis=1, kind="stable")
    take = lambda a: np.take_along_axis(
        a, order if a.ndim == 2 else order[..., None], axis=1)
    b, c = cuda(take(boxes)), cuda(take(classes))
    v = cuda(take(scores) >= 0) if with_valid else None
    if case == "all_invalid":
        v = torch.zeros((batch, k), dtype=torch.bool, device=DEV)
    args = (b, 0.5)
    kw = dict(valid=v, classes=c if class_aware else None)
    name = f"nms_sweep B={batch} K={k} class_aware={class_aware} {case}"

    got = K.nms_sweep(*args, **kw)
    again = K.nms_sweep(*args, **kw)
    bits = K.suppression_bits(b, 0.5, kw["classes"])
    torch.cuda.synchronize()
    want = K.nms_sweep_plain(*args, **kw)
    want_bits = K.suppression_bits_plain(b, 0.5, kw["classes"])
    mismatches = int((got != want).sum())
    words_differing = int((bits != want_bits).sum())
    check(got.dtype == torch.bool and got.shape == (batch, k),
          f"{name}: wrong output {got.dtype} {tuple(got.shape)}")
    check(mismatches == 0,
          f"{name}: {mismatches} keep bits differ from the plain version")
    check(words_differing == 0,
          f"{name}: {words_differing} mask words differ from "
          f"suppression_bits_plain")
    check(torch.equal(got, again),
          f"{name}: two runs on the same input differ")
    kept = int(want.sum())
    if case == "all_invalid":
        check(kept == 0, f"{name}: padding survived")
    else:
        check(0 < kept < batch * k, f"{name}: degenerate test input")
    row = {"shape": {"B": batch, "K": k, "class_aware": class_aware,
                     "valid_mask": v is not None, "case": case},
           "max_abs_err": float(mismatches),
           "mask_words_differing": words_differing,
           "plan": K._sweep_plan(k)}
    if not timed:
        return row

    ms = queued_ms(lambda: K.nms_sweep(*args, **kw), reps=50)
    # the mask kernel alone (with the zero fill of its comparison entry)
    mask_ms = queued_ms(lambda: K.suppression_bits(b, 0.5, kw["classes"]),
                        reps=50)
    call_ms = time_ms(lambda: K.nms_sweep(*args, **kw), warmup=3, reps=50)
    plain_ms = time_ms(lambda: K.nms_sweep_plain(*args, **kw),
                       warmup=min(plain_reps, 1), reps=plain_reps)
    # work this data needs: one IoU row (the j > i part) per kept box
    idx = torch.arange(k, device=DEV)
    pairs = int((want * (k - 1 - idx)).sum())
    nbytes = batch * k * (16 + (4 if class_aware else 0)
                          + (1 if with_valid else 0) + 1)
    bound_ms, bound_by = bound(nbytes, pairs * SWEEP_FLOPS_PER_PAIR)
    row.update({
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": None, "call_ms": call_ms,
        "mask_ms": mask_ms, "rounds_per_image": kept / batch,
        "rounds_max": int(want.sum(dim=1).max()),
        "ns_per_step": ms * 1e6 / k,
    })
    return row


def check_dense(rng, batch, m, max_outputs, *, case="crowded",
                class_aware=True, timed=True, plain_reps=2, nc=NUM_CLASSES):
    """`dense_nms` against its plain version: every output exactly, two
    runs bitwise equal. `case`: "crowded", "below_threshold" (every score
    under score_thresh), "one_class" (every candidate of class 2),
    "no_classes" (classes=None). `nc`: the classes drawn from."""
    boxes, scores, classes = make_candidates(rng, batch, m, nc=nc)
    if case == "below_threshold":
        scores = (scores * 0.04).astype(np.float32)
    if case == "one_class":
        classes[:] = 2
    b, s, c = cuda(boxes), cuda(scores), cuda(classes)
    if case == "no_classes":
        c = None
    kw = dict(iou_thresh=0.5, score_thresh=0.05, max_outputs=max_outputs,
              class_aware=class_aware)
    name = f"dense_nms B={batch} M={m} class_aware={class_aware} {case}"

    got = K.dense_nms(b, s, c, **kw)
    again = K.dense_nms(b, s, c, **kw)
    torch.cuda.synchronize()
    want = K.dense_nms_plain(b, s, c, **kw)
    err = 0.0
    for key in ("boxes", "scores", "classes", "valid", "num_valid"):
        check(got[key].shape == want[key].shape
              and got[key].dtype == want[key].dtype,
              f"{name}: {key} is {got[key].dtype} "
              f"{tuple(got[key].shape)}, plain gives {want[key].dtype} "
              f"{tuple(want[key].shape)}")
        diff = (got[key].double() - want[key].double()).abs().max().item()
        err = max(err, diff)
        check(torch.equal(got[key], again[key]),
              f"{name}: two runs on the same input differ in {key}")
    check(err == 0.0, f"{name}: max abs difference {err} from the "
                      f"plain version (exact match expected)")
    nv = want["num_valid"]
    if case == "below_threshold":
        check(int(nv.max()) == 0, f"{name}: a score below the threshold "
                                  f"surfaced")
    else:  # a handful of candidates may all fall under the threshold
        check(int(nv.min() if m >= 64 else nv.sum()) > 0,
              f"{name}: degenerate test input")
    row = {"shape": {"B": batch, "M": m, "max_outputs": max_outputs,
                     "class_aware": class_aware, "case": case},
           "max_abs_err": err, "plan": K._dense_plan(m)}
    if not timed:
        return row

    ms = queued_ms(lambda: K.dense_nms(b, s, c, **kw), reps=50)
    call_ms = time_ms(lambda: K.dense_nms(b, s, c, **kw), warmup=3, reps=50)
    plain_ms = time_ms(lambda: K.dense_nms_plain(b, s, c, **kw),
                       warmup=min(plain_reps, 1), reps=plain_reps)
    # rounds this data needs: one per survivor, one more to find none left
    rounds = nv + (nv < max_outputs).to(nv.dtype)
    flops = (int(rounds.sum()) * m * DENSE_FLOPS_PER_CANDIDATE_ROUND
             + batch * m * AREA_FLOPS_PER_CANDIDATE)
    nbytes = batch * (m * 24 + max_outputs * 25)
    bound_ms, bound_by = bound(nbytes, flops)
    mean_rounds = float(rounds.float().mean())
    row.update({
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": None, "call_ms": call_ms,
        "rounds_per_image": mean_rounds, "rounds_max": int(rounds.max()),
        "us_per_round": ms * 1e3 / mean_rounds,
    })
    return row


def library_focal(labels, logits, alpha=0.25, gamma=2.0):
    """The nearest single PyTorch call family: focal weighting around
    `binary_cross_entropy_with_logits`. A yardstick for `library_ms`
    only; nothing in the port calls it."""
    import torch.nn.functional as F
    ce = F.binary_cross_entropy_with_logits(logits, labels, reduction="none")
    p_t = torch.exp(-ce)
    return ((labels * alpha + (1 - labels) * (1 - alpha))
            * (1 - p_t) ** gamma * ce).sum()


def check_focal(rng, hw, *, case="dense", classes=NUM_CLASSES, slots=None,
                lead=5, batch=FOCAL_BATCH):
    """Forward sum and dlogits of the focal kernel against its plain
    version on ``[16, hw, hw, classes]`` (``[16, hw, hw, slots, classes]``
    with `slots`, the scale-slot map). `case`: "dense" (contiguous),
    "weights" (with a 0/1 mask), "extreme" (logits in {-100, -40, 0, 40,
    100}), "strided" (the class channels of a map with `lead` more
    channels before them, read in place)."""
    shape = ((batch, hw, hw) + ((slots,) if slots else ())
             + (classes,))
    labels = (rng.uniform(size=shape) < 0.01).astype(np.float32)
    if case == "extreme":
        logits = rng.choice(
            np.array([-100, -40, 0, 40, 100], np.float32), size=shape)
    else:
        logits = (4.0 * rng.standard_normal(size=shape)).astype(np.float32)
    z, x = cuda(labels), cuda(logits)
    w = None
    if case == "weights":
        w = cuda((rng.uniform(size=shape[:-1] + (1,)) < 0.7)
                 .astype(np.float32))
    if case == "strided":
        def widen(t):
            wide = torch.zeros(shape[:-1] + (lead + classes,), device=DEV)
            wide[..., lead:] = t
            return wide[..., lead:]
        z, x = widen(z), widen(x)
        check(not x.is_contiguous(), "strided case is contiguous")
    name = f"focal {case} {shape}"

    def run(fn):
        xg = x.detach().requires_grad_(True)
        out = fn(z, xg, weights=w)
        check(fn is not KF.focal_loss or through_operator(out),
              f"{name}: focal_loss did not go through the operator")
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
        # torch's own sum of the logits: a reduction over the same
        # elements that does no focal arithmetic
        sum_ms = (queued_ms(lambda: x.sum(), reps=50) if case == "dense"
                  else None)
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
        "shape": {"B": batch, "h": hw, "w": hw, "slots": slots,
                  "classes": classes, "case": case,
                  "row_stride": (lead + classes if case == "strided"
                                 else classes)},
        "max_abs_err": max(grad_err, closed_err), "sum_rel_err": sum_rel,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": library_ms, "sum_ms": sum_ms,
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
    # the class terms of the two CenterNet losses, as their training paths
    # hand them over: channels 5: of the heatmap model's [16, 48, 48, 26]
    # map, and channels 4: of the scale-slot model's [16, 64, 64, 5, 24]
    rows += [check_focal(rng, CANVAS // 8, case="strided",
                         classes=NUM_CLASSES + 1, lead=5),
             check_focal(rng, S8_CANVAS // 8, case="strided",
                         classes=NUM_CLASSES, slots=len(S8_SCALES), lead=4)]
    return rows


def check_focal_alignment(rng):
    """The focal sum depends on the values and the (rows, cols) alone: a
    `[16, 48, 48, 20]` view at an odd float offset (read with 4-byte loads)
    and its clone (16-byte loads) give the same sum and the same dlogits
    bit for bit, and so do the FCOS class channels ``y[..., 5:]`` of a
    `[16, 48, 48, 25]` map (row stride 25) and their clone (stride 20)."""
    shape = (FOCAL_BATCH, FOCAL_LEVELS[0], FOCAL_LEVELS[0], NUM_CLASSES)
    n = int(np.prod(shape))
    labels = (rng.uniform(size=n) < 0.02).astype(np.float32)
    logits = (4.0 * rng.standard_normal(n)).astype(np.float32)

    def offset_view(values):
        buf = torch.zeros(n + 1, device=DEV)
        buf[1:] = cuda(values)
        return buf[1:].view(shape)

    wide = shape[:-1] + (5 + NUM_CLASSES,)
    zw = torch.zeros(wide, device=DEV)
    xw = torch.zeros(wide, device=DEV)
    zw[..., 5:] = cuda(labels.reshape(shape))
    xw[..., 5:] = cuda(logits.reshape(shape))
    pairs = {"odd_offset": (offset_view(labels), offset_view(logits)),
             "class_channels_of_25": (zw[..., 5:], xw[..., 5:])}
    out = {}
    for name, (z, x) in pairs.items():
        zc, xc = z.clone(), x.clone()
        modes = [KF._walk_mode(KF._prepare(a, b, None), None)
                 for a, b in ((z, x), (zc, xc))]
        check(modes == [KF._QUAD4, KF._QUAD16],
              f"focal alignment {name}: walk modes {modes}, expected the "
              f"4-byte and the 16-byte walk")
        sums, grads = [], []
        for zz, xx in ((z, x), (zc, xc)):
            leaf = xx.detach().requires_grad_(True)
            total = KF.focal_loss(zz, leaf)
            total.backward()
            sums.append(total.detach())
            grads.append(leaf.grad)
        torch.cuda.synchronize()
        check(torch.equal(sums[0], sums[1]),
              f"focal alignment {name}: sums {sums[0].item()!r} and "
              f"{sums[1].item()!r} differ")
        check(torch.equal(grads[0], grads[1]),
              f"focal alignment {name}: dlogits differ")
        out[name] = {"sum": sums[0].item(), "walk_modes": modes,
                     "bitwise_equal": True}
    return out


FOCAL_GROUP_CASES = ("levels", "levels_and_centerness", "one_segment",
                     "one_element", "zero_rows", "mixed_weights", "extreme")


def focal_group_segments(rng, case, *, levels=FOCAL_LEVELS,
                         batch=FOCAL_BATCH):
    """Segments of one `focal_loss_group` call, as the training path hands
    them over where it can: "levels" the class channels ``y[..., 5:]`` of
    the five FCOS level maps ``[batch, h, h, 25]`` (``h`` over
    ``levels``; strided views), read in place; "levels_and_centerness"
    those and the five centerness maps ``y[..., 4]`` (ten segments, as
    under cen_type="focal"); "one_segment" one contiguous ``[16, 48, 48,
    20]``; "one_element" a level and a
    segment of one element; "zero_rows" a segment of no rows between two
    levels; "mixed_weights" the five levels, every other one with a 0/1
    mask; "extreme" the five levels with logits in {-100, -40, 0, 40,
    100}. Returns the segments as (labels, logits, weights or None) and
    the logits that take a gradient (leaf tensors, strided where the
    segment is)."""
    def level(hw, extreme=False):
        shape = (batch, hw, hw, 5 + NUM_CLASSES)
        labels = (rng.uniform(size=shape) < 0.01).astype(np.float32)
        if extreme:
            logits = rng.choice(
                np.array([-100, -40, 0, 40, 100], np.float32), size=shape)
        else:
            logits = (4.0 * rng.standard_normal(size=shape)).astype(np.float32)
        return cuda(labels), cuda(logits)

    if case == "one_segment":
        shape = (FOCAL_BATCH, 48, 48, NUM_CLASSES)
        pairs = [(cuda((rng.uniform(size=shape) < 0.01).astype(np.float32)),
                  cuda((4.0 * rng.standard_normal(size=shape))
                       .astype(np.float32)))]
        weights = [None]
    else:
        maps = [level(hw, extreme=case == "extreme") for hw in levels]
        pairs = [(z[..., 5:], x[..., 5:]) for z, x in maps]
        if case == "levels_and_centerness":
            pairs += [(z[..., 4], x[..., 4]) for z, x in maps]
        elif case == "one_element":
            pairs = [pairs[-1], (cuda(np.ones((1,), np.float32)),
                                 cuda(np.full((1,), -1.5, np.float32)))]
        elif case == "zero_rows":
            empty = torch.zeros((0, NUM_CLASSES), device=DEV)
            pairs = [pairs[-2], (empty, empty.clone()), pairs[-1]]
        weights = [None] * len(pairs)
        if case == "mixed_weights":
            weights = [cuda((rng.uniform(size=x.shape[:-1] + (1,)) < 0.7)
                            .astype(np.float32)) if i % 2 == 0 else None
                       for i, (_, x) in enumerate(pairs)]
    xs = [x.detach().requires_grad_(True) for _, x in pairs]
    segs = [(z, x, w) for (z, _), x, w in zip(pairs, xs, weights)]
    return segs, xs


def check_focal_group(rng, case, *, timed=False, levels=FOCAL_LEVELS,
                      batch=FOCAL_BATCH):
    """`focal_loss_group` against its plain version segment by segment:
    each sum to FOCAL_SUM_RTOL, each segment's dlogits (the upstream
    gradient differing by segment) to FOCAL_GRAD_ATOL, one forward and one
    backward launch, two runs bitwise equal. Timed: the grouped call, and
    five single `focal_loss` calls on the same segments, queued behind a
    blocker. ``levels`` and ``batch``: the FCOS level maps' sides and
    batch (`focal_group_segments`)."""
    segs, xs = focal_group_segments(rng, case, levels=levels, batch=batch)
    name = (f"focal_loss_group {case} ({len(segs)} segments, batch "
            f"{batch}, levels {levels})")
    upstream = torch.linspace(0.5, 2.0, len(segs), device=DEV)

    def run(group):
        out = group(segs)
        check(group is not KF.focal_loss_group or through_operator(out),
              f"{name}: the call did not go through the operator")
        grads = torch.autograd.grad(out, xs, upstream, allow_unused=True)
        return out.detach(), grads

    before = kcommon.launch_counts()
    got, got_grads = run(KF.focal_loss_group)
    after = kcommon.launch_counts()
    again, again_grads = run(KF.focal_loss_group)
    torch.cuda.synchronize()
    for key in ("focal_fwd", "focal_bwd"):
        check(after.get(key, 0) - before.get(key, 0) == 1,
              f"{name}: {after.get(key, 0) - before.get(key, 0)} {key} "
              f"launches for one call, expected 1")
    want, want_grads = run(KF.focal_loss_group_plain)
    check(got.shape == (len(segs),) and bool(torch.isfinite(got).all()),
          f"{name}: sums {got}")
    check(torch.equal(got, again)
          and all(torch.equal(a, b) for a, b in zip(got_grads, again_grads)),
          f"{name}: two runs on the same input differ in their bits")
    sum_rel, grad_err = 0.0, 0.0
    for i, (g, w, gg, wg) in enumerate(zip(got, want, got_grads, want_grads)):
        rel = float((g - w).abs() / w.abs().clamp_min(1e-30))
        check(rel <= FOCAL_SUM_RTOL or float((g - w).abs()) == 0.0,
              f"{name}: segment {i} sum {float(g)} vs plain {float(w)} "
              f"(rel {rel}, tolerance {FOCAL_SUM_RTOL})")
        err = float((gg - wg).abs().max()) if gg.numel() else 0.0
        check(gg.shape == xs[i].shape and err <= FOCAL_GRAD_ATOL,
              f"{name}: segment {i} dlogits differ by {err} "
              f"(tolerance {FOCAL_GRAD_ATOL})")
        sum_rel, grad_err = max(sum_rel, rel), max(grad_err, err)
    if case == "zero_rows":
        check(float(got[1]) == 0.0, f"{name}: the empty segment sums to "
                                    f"{float(got[1])}")
    row = {"case": case, "segments": len(segs),
           "elements": sum(x.numel() for x in xs),
           "sum_rel_err": sum_rel, "max_abs_err": grad_err}
    if not timed:
        return row

    ones = torch.ones(len(segs), device=DEV)
    one = torch.ones((), device=DEV)

    def grouped_fwd_bwd():
        torch.autograd.grad(KF.focal_loss_group(segs), xs, ones)

    def single_fwd():
        for z, x, w in segs:
            KF.focal_loss(z, x, weights=w)

    def single_fwd_bwd():
        outs = [KF.focal_loss(z, x, weights=w) for z, x, w in segs]
        torch.autograd.grad(outs, xs, [one] * len(outs))

    with torch.no_grad():
        row["ms"] = queued_ms(lambda: KF.focal_loss_group(segs), reps=50)
        row["call_ms"] = time_ms(lambda: KF.focal_loss_group(segs),
                                 warmup=2, reps=50)
        row["single_calls_fwd_ms"] = queued_ms(single_fwd, reps=50)
        # the plain version, and the library yardstick a segment each
        row["plain_ms"] = queued_ms(
            lambda: KF.focal_loss_group_plain(segs), reps=20)
        row["library_ms"] = queued_ms(
            lambda: [library_focal(z, x) for z, x, _ in segs], reps=20)
    row["fwd_bwd_ms"] = queued_ms(grouped_fwd_bwd, reps=50)
    row["fwd_bwd_call_ms"] = time_ms(grouped_fwd_bwd, warmup=2, reps=50)
    row["single_calls_fwd_bwd_ms"] = queued_ms(single_fwd_bwd, reps=50)
    n = row["elements"]
    row["bound_ms"], row["bound_by"] = bound(n * 8 + 4 * len(segs),
                                             n * FOCAL_FWD_FLOPS)
    row["fwd_bwd_bound_ms"], _ = bound(
        n * 8 + 4 * len(segs) + n * 12 + 4 * len(segs),
        n * (FOCAL_FWD_FLOPS + FOCAL_BWD_FLOPS))
    row["grid_blocks"] = sum(b for _, b, _ in KF._focal_plan(
        [(int(np.prod(x.shape[:-1])), x.shape[-1]) for x in xs]))
    return row


def check_focal_groups(rng):
    """First row: the five FCOS levels, timed; then every other case."""
    return [check_focal_group(rng, case, timed=case == "levels")
            for case in FOCAL_GROUP_CASES]


def through_operator(out: torch.Tensor) -> bool:
    """Whether ``out`` came from the focal operator: its autograd graph
    holds ``detectax_torch::focal_group``'s backward within a few nodes
    (a wrapper may reshape the operator's output)."""
    nodes = [out.grad_fn]
    for _ in range(3):
        if any(n is not None and "focal_group" in type(n).__name__
               for n in nodes):
            return True
        nodes = [m for n in nodes if n is not None
                 for m, _ in n.next_functions]
    return False


def check_focal_operator():
    """The focal kernel as the ``torch.library`` operators
    ``detectax_torch::focal_group`` and ``focal_group_bwd`` (what the
    wrappers call on CUDA): `torch.library.opcheck` of both on CUDA
    segments at the five FCOS level shapes (the class channels of ``[16,
    h, h, 25]`` read in place) with a 0/1 weight mask; then the grouped
    forward and backward at those shapes captured in one
    `torch.cuda.graph`, whose replays must equal the eager call bit for
    bit. A replay counts no launches: `count_launch` runs in Python, once,
    at capture."""
    gen = np.random.default_rng(SEED + 15)
    labels, logits, weights = [], [], []
    for hw in FOCAL_LEVELS:
        shape = (FOCAL_BATCH, hw, hw, 5 + NUM_CLASSES)
        labels.append(cuda((gen.uniform(size=shape) < 0.01)
                           .astype(np.float32))[..., 5:])
        logits.append(cuda((4.0 * gen.standard_normal(size=shape))
                           .astype(np.float32))[..., 5:])
        weights.append(cuda((gen.uniform(size=shape[:-1] + (1,)) < 0.7)
                            .astype(np.float32)))
    check(not logits[0].is_contiguous(), "operator segments contiguous")
    row = {"segments": len(logits),
           "elements": sum(x.numel() for x in logits)}
    t0 = time.perf_counter()
    for name, op, args in (
            ("focal_group", torch.ops.detectax_torch.focal_group,
             (labels, [x.clone().requires_grad_(True) for x in logits],
              weights, 0.25, 2.0)),
            ("focal_group_bwd", torch.ops.detectax_torch.focal_group_bwd,
             (labels, logits, weights,
              torch.linspace(0.5, 2.0, len(logits), device=DEV), 0.25,
              2.0))):
        result = torch.library.opcheck(op, args)
        check(all(v == "SUCCESS" for v in result.values()),
              f"opcheck {name}: {result}")
        row[f"opcheck_{name}"] = result
    row["opcheck_s"] = time.perf_counter() - t0

    xs = [x.detach().requires_grad_(True) for x in logits]
    segs = list(zip(labels, xs, weights))
    ones = torch.ones(len(xs), device=DEV)

    def fwd_bwd():
        out = KF.focal_loss_group(segs)
        check(through_operator(out), "focal_loss_group on CUDA did not "
              "go through detectax_torch::focal_group")
        return out.detach(), torch.autograd.grad(out, xs, ones)

    eager = fwd_bwd()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fwd_bwd()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = kcommon.launch_counts()
    with torch.cuda.graph(graph):
        captured = fwd_bwd()
    at_capture = kcommon.launch_counts()
    for _ in range(3):
        graph.replay()
    torch.cuda.synchronize()
    replayed = kcommon.launch_counts()
    check(torch.equal(captured[0], eager[0])
          and all(torch.equal(a, b) for a, b in zip(captured[1], eager[1])),
          "the captured focal forward + backward replays other bits than "
          "the eager call")
    row["graph_equal_to_eager"] = True
    row["launches_counted_at_capture"] = {
        k: at_capture.get(k, 0) - before.get(k, 0)
        for k in ("focal_fwd", "focal_bwd")}
    row["launches_counted_by_3_replays"] = {
        k: replayed.get(k, 0) - at_capture.get(k, 0)
        for k in ("focal_fwd", "focal_bwd")}
    row["replay_ms"] = time_ms(graph.replay, warmup=2, reps=50)
    row["replay_queued_ms"] = queued_ms(graph.replay, reps=50)
    row["eager_call_ms"] = time_ms(fwd_bwd, warmup=2, reps=50)
    del graph
    return row


def library_peak(p_nchw):
    """The nearest PyTorch calls: max_pool2d and a select. A yardstick for
    `library_ms` only; nothing in the port calls it, and it pads with -inf
    where the kernel's contract is -1."""
    import torch.nn.functional as F
    return torch.where(p_nchw >= F.max_pool2d(p_nchw, 3, 1, 1), p_nchw,
                       torch.zeros((), device=p_nchw.device))


def check_peak(rng, shape, *, sigmoid=False, case="uniform", timed=False):
    """One mode of the peak kernel against its plain version on one map
    ``[B, h, w, C]`` or ``[H, W, P]``. `case`: "uniform", "plateaus" (three
    distinct values; with the sigmoid, logits of 18-30 that all give 1.0),
    "zeros", "below_border" (values under the -1 fill), "nonfinite" (NaN
    and +-inf sprinkled in), "strided" (the channels 1: of a wider map)."""
    if case == "plateaus":
        x = (rng.integers(0, 3, size=shape) / 2).astype(np.float32)
        if sigmoid:
            x = (18.0 + 6.0 * x).astype(np.float32)
            x.reshape(-1)[::7] = -3.0
    elif case == "zeros":
        x = np.zeros(shape, np.float32)
    elif case == "below_border":
        x = rng.uniform(-3, 0.5, size=shape).astype(np.float32)
    else:
        x = (rng.normal(scale=4.0, size=shape) if sigmoid
             else rng.uniform(0, 1, size=shape)).astype(np.float32)
    if case == "nonfinite":
        flat = x.reshape(-1)
        flat[::17], flat[5::31], flat[7::29] = np.nan, np.inf, -np.inf
    t = cuda(x)
    if case == "strided":
        wide = torch.zeros(shape[:-1] + (shape[-1] + 1,), device=DEV)
        wide[..., 1:] = t
        t = wide[..., 1:]
        check(not t.is_contiguous(), "strided case is contiguous")
    fn, plain = ((KP.peak_scores, KP.peak_scores_plain) if sigmoid
                 else (KP.peak_mask_scores, KP.peak_mask_scores_plain))
    name = f"{fn.__name__} {case} {shape}"

    got = fn(t)
    torch.cuda.synchronize()
    want = plain(t)
    check(got.shape == want.shape == t.shape and got.dtype == torch.float32
          and got.is_contiguous(), f"{name}: wrong output")
    check(torch.equal(got.isnan(), want.isnan()),
          f"{name}: NaN pattern differs from the plain version")
    g, w = torch.nan_to_num(got, 0.0, 9.0, -9.0), \
        torch.nan_to_num(want, 0.0, 9.0, -9.0)
    flipped = (g == 0) != (w == 0)
    n_flipped = int(flipped.sum())
    if sigmoid:
        p = 1.0 / (1.0 + torch.exp(-t))
        gap = (p - KP.neighbour_max(p)).abs()
        ulp = torch.nextafter(p, torch.full_like(p, 2.0)) - p
        check(bool((gap[flipped] <= PEAK_TIE_ULPS * ulp[flipped]).all()),
              f"{name}: a keep/zero decision differs at a cell further than "
              f"{PEAK_TIE_ULPS} ulp from its neighbourhood maximum")
        err = float((g - w)[~flipped].abs().max()) if g.numel() else 0.0
        check(err <= PEAK_ATOL, f"{name}: values differ by {err} from the "
                                f"plain version (tolerance {PEAK_ATOL})")
    else:
        err = float((g - w).abs().max()) if g.numel() else 0.0
        check(err == 0.0 and n_flipped == 0,
              f"{name}: max abs difference {err}, {n_flipped} keep/zero "
              f"decisions differ (exact match expected)")
    kept = float((w != 0).float().mean())
    if case == "zeros":   # with the sigmoid: a plateau of 0.5, kept whole
        check(bool((got == (0.5 if sigmoid else 0.0)).all()),
              f"{name}: an all-zero plane is not flat after the kernel")
    elif case in ("uniform", "strided") and min(shape[-3:-1]) >= 3:
        check(0.0 < kept < 0.5, f"{name}: degenerate test input ({kept})")
    dims = (1,) * (4 - len(shape)) + tuple(shape)
    row = {"shape": {"dims": list(shape), "sigmoid": sigmoid, "case": case},
           "max_abs_err": err, "decisions_differing": n_flipped,
           "kept_share": kept,
           "plan": KP._peak_plan(dims[1], dims[2], dims[3], dims[0])}
    if not timed:
        return row

    n = int(np.prod(shape))
    nchw = t.permute(0, 3, 1, 2).contiguous()
    if sigmoid:
        nchw = torch.sigmoid(nchw)
    with torch.no_grad():
        ms = queued_ms(lambda: fn(t), reps=50)
        call_ms = time_ms(lambda: fn(t), warmup=2, reps=50)
        plain_ms = queued_ms(lambda: plain(t), reps=20)
        plain_call_ms = time_ms(lambda: plain(t), warmup=2, reps=20)
        library_ms = queued_ms(lambda: library_peak(nchw), reps=20)
        # torch's copy of the map: the same bytes in and out, no work
        copy_ms = queued_ms(lambda: t.clone(), reps=50)
    bound_ms, bound_by = bound(
        n * 8, n * (PEAK_SIGMOID_FLOPS if sigmoid else PEAK_FLOPS))
    row.update({"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": library_ms,
                "copy_ms": copy_ms, "call_ms": call_ms,
                "plain_call_ms": plain_call_ms})
    return row


PEAK_MAIN = (8, 48, 48, 20)   # the heatmap decode's scores at 384 px, batch 8
PEAK_EDGE_SHAPES = ((3, 3, 2), (1, 7, 3), (7, 1, 3), (48, 48, 160),
                    (2, 64, 64, 7), (80, 80, 33), (1, 1, 1))
# the band edges of `_peak_plan`: h not a multiple of the band (3 rows),
# a band taller than the map (clamped to its 2 rows), one row of one
# image, a row too wide for one block (two column tiles), a cell too wide
# for one block (four channel tiles)
PEAK_BAND_SHAPES = ((8, 50, 10, 4), (512, 2, 8, 4), (1, 1, 37, 20),
                    (2, 5, 300, 20), (2, 3, 5000))
PEAK_CASES = ("uniform", "plateaus", "zeros", "below_border", "nonfinite")


def check_peak_all(rng):
    """First row: `peak_mask_scores` at the main path's shape, timed (what
    the `kernels` line reports); then `peak_scores` there, the decode at
    512 px, the batch-1 bucket's map, strided views, and every edge shape
    and case in both modes."""
    rows = [check_peak(rng, PEAK_MAIN, timed=True),
            check_peak(rng, PEAK_MAIN, sigmoid=True, timed=True),
            check_peak(rng, (8, 64, 64, 20), timed=True),
            check_peak(rng, (1,) + PEAK_MAIN[1:]),   # the batch-1 bucket
            check_peak(rng, PEAK_MAIN, case="strided"),
            check_peak(rng, PEAK_MAIN, sigmoid=True, case="strided")]
    for shape in (PEAK_MAIN,) + PEAK_EDGE_SHAPES + PEAK_BAND_SHAPES:
        for case in PEAK_CASES:
            for sigmoid in (False, True):
                if shape == PEAK_MAIN and case == "uniform":
                    continue
                rows.append(check_peak(rng, shape, sigmoid=sigmoid,
                                       case=case))
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

TRAIN_BATCH, TRAIN_BOXES, TRAIN_STEPS = 16, 16, 3
PATHS_RTOL = 1e-4  # kernel path against plain path, and split against unsplit


def train_batch(seed: int, canvas: int | None = None,
                nc: int = NUM_CLASSES, batch: int = TRAIN_BATCH) -> dict:
    """A seeded numpy batch of `batch` images: normal images (`CANVAS`
    pixels a side unless `canvas` is given), 16 boxes an image around the
    centre, all valid, labels drawn from `nc` classes."""
    canvas = canvas or CANVAS
    rng = np.random.default_rng(seed)
    shape = (batch, TRAIN_BOXES)
    boxes = np.zeros(shape + (4,), np.float32)
    boxes[:, :, 0] = rng.uniform(0.3, 0.7, shape)
    boxes[:, :, 1] = rng.uniform(0.3, 0.7, shape)
    boxes[:, :, 2] = rng.uniform(0.05, 0.5, shape)
    boxes[:, :, 3] = rng.uniform(0.05, 0.5, shape)
    return {
        "images": rng.normal(size=(batch, canvas, canvas, 3))
        .astype(np.float32),
        "boxes": boxes,
        "labels": rng.integers(0, nc, shape).astype(np.int32),
        "valid": np.ones(shape, bool),
    }


def assign_fn(boxes, labels, valid):
    return fcos_assign(boxes, labels, valid, img_dim=(CANVAS, CANVAS),
                       num_classes=NUM_CLASSES)[0]


def make_trainer(*, kernels=None, microbatch=None, loss_norm="batch",
                 freeze_bn=False, dtype=torch.float32):
    """Model (seeded weights, the same on every call; computing in
    `dtype`), state, step and the optimizer chain."""
    model = FCOS(num_classes=NUM_CLASSES, backbone=BACKBONE,
                 freeze_bn=freeze_bn, dtype=dtype,
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
    # the five levels' class terms go through one grouped call a step
    for key in ("focal_fwd", "focal_bwd"):
        check(counts.get(key, 0) == TRAIN_STEPS,
              f"training launched {key} {counts.get(key, 0)} times, "
              f"expected one a step = {TRAIN_STEPS}")
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

def cli_path(ckpt_root):
    """`cli.train_fcos` for 4 steps; its checkpoint goes to
    ``ckpt_root/fcos``, which the export phase reads."""
    from detectax_torch.cli import train_fcos

    with tempfile.TemporaryDirectory() as tmp:
        ckpt_dir = os.path.join(ckpt_root, "fcos")
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
        check(counts.get("focal_fwd", 0) == 4
              and counts.get("focal_bwd", 0) == 4,
              f"CLI training launched {counts}, expected 4 and 4")
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
# phase 7: the CenterNet paths (ResNet backbone, stride 8)
# --------------------------------------------------------------------------

CN_CELLS = (CANVAS // 8) ** 2               # 2,304 candidates an image
S8_SCALES = (32.0, 64.0, 128.0, 256.0, 512.0)
S8_CANVAS = 512   # the scale-slot model's reference canvas


def build_centernet(kind: str):
    """Seeded full-width model with the class heads' bias raised as
    `build_model` raises it."""
    gen = torch.Generator().manual_seed(SEED)
    if kind == "heatmap":
        model = CenterNetFPNSingle(num_classes=NUM_CLASSES, backbone=BACKBONE,
                                   generator=gen)
        heads = [model.cls_head]
    else:
        model = CenterNetS8(num_classes=NUM_CLASSES,
                            n_scales=len(S8_SCALES), backbone=BACKBONE,
                            generator=gen)
        heads = [getattr(model, f"cls_head_{s}")
                 for s in range(1, len(S8_SCALES) + 1)]
    with torch.no_grad():
        for head in heads:
            head.Conv_0.bias.fill_(CLS_HEAD_BIAS)
    return model


def centernet_predictor(model, *, kernels=None, buckets=BUCKETS,
                        canvas=CANVAS, **serving) -> Predictor:
    decode = centernet_decode_fn(model.family, box_scales=S8_SCALES,
                                 kernels=kernels)
    fn = make_serving_fn(model, decode, kernels=kernels, **serving)
    return Predictor.for_model(fn, model, canvas=canvas, buckets=buckets,
                               device=DEV)


def centernet_breakdown(model, images8: np.ndarray) -> dict:
    """Device milliseconds (CUDA events) of the stages of one heatmap
    chunk at batch 8 and batch 1: forward, decode with the peak kernel
    inside (and on its plain version), and the NMS stage."""
    from detectax_torch.infer.predict import detections_from_dense

    decode = centernet_decode_fn("centernet_heatmap")
    decode_plain = centernet_decode_fn("centernet_heatmap", kernels="plain")
    out = {}
    with torch.no_grad():
        for batch in (8, 1):
            x = torch.from_numpy(images8[:batch]).to(DEV)
            y = model(x)
            boxes, probs = decode(y)
            t = lambda fn: time_ms(fn, warmup=2, reps=10)
            out[f"batch_{batch}"] = {
                "forward": t(lambda: model(x)),
                "decode": t(lambda: decode(y)),
                "decode_plain_peak": t(lambda: decode_plain(y)),
                "nms_stage_dense": t(
                    lambda: detections_from_dense(boxes, probs)),
            }
    return out


def centernet_serving_path():
    rng = np.random.default_rng(SEED + 3)
    requests = [rng.uniform(-1, 1, size=(n, CANVAS, CANVAS, 3))
                .astype(np.float32) for n in REQUESTS]
    model = build_centernet("heatmap")
    pred = centernet_predictor(model)

    with torch.no_grad():
        y = model(torch.from_numpy(requests[0]).to(DEV))
        _, probs = centernet_decode_fn("centernet_heatmap")(y)
    passing = int((probs.amax(-1) >= 0.05).sum())
    log(f"centernet heatmap path: M={probs.shape[1]} candidates per image, "
        f"{int((probs > 0).sum())} peaks and {passing} cells of the first "
        f"image pass score_thresh 0.05")
    check(probs.shape[1] == CN_CELLS, f"expected {CN_CELLS} candidates")
    check(passing >= 100, "too few peaks pass the threshold for the NMS "
                          "stage to do real work")
    pred.warmup()

    # ---- the counted run: counts set to 0 just before, read just after
    kcommon.reset_launch_counts()
    results, seconds = serve(pred, requests)
    counts = kcommon.launch_counts()
    # ----

    chunks = sum(len(pred._plan(n)) for n in REQUESTS)
    for name in ("peak", "dense_nms"):
        check(counts.get(name, 0) == chunks,
              f"centernet serving launched {name} {counts.get(name, 0)} "
              f"times, expected one per chunk = {chunks}")
    check(set(counts) == {"peak", "dense_nms"},
          f"centernet serving launched {counts}")
    plain_out, _ = serve(centernet_predictor(model, kernels="plain"),
                         requests)
    check(kcommon.launch_counts() == counts,
          "the plain centernet path launched a kernel")
    for n, got, want in zip(REQUESTS, results, plain_out):
        check_detections(f"centernet heatmap, request of {n}", got, n)
        same_detections(f"centernet heatmap, request of {n}", got, want)

    # one 8-image chunk of the scale-slot model: 5 x 2,304 candidates an
    # image through the dense kernel
    s8 = build_centernet("s8")
    s8_pred = centernet_predictor(s8, buckets=(8,))
    s8_pred.warmup()
    kcommon.reset_launch_counts()
    t0 = time.perf_counter()
    s8_got = s8_pred.predict(requests[2])
    s8_ms = (time.perf_counter() - t0) * 1e3
    s8_counts = kcommon.launch_counts()
    check(s8_counts == {"dense_nms": 1},
          f"the CenterNetS8 chunk launched {s8_counts}, expected one "
          f"dense_nms")
    s8_want = centernet_predictor(s8, kernels="plain", buckets=(8,)) \
        .predict(requests[2])
    check_detections("CenterNetS8 chunk", s8_got, 8)
    same_detections("CenterNetS8 chunk", s8_got, s8_want)
    del s8, s8_pred

    stages = centernet_breakdown(model, requests[2])
    serving = {
        "images_per_s": sum(REQUESTS) / sum(seconds),
        "request_ms": {str(n): s * 1e3 for n, s in zip(REQUESTS, seconds)},
        "s8_chunk_of_8_ms": s8_ms,
        "s8_candidates_per_image": len(S8_SCALES) * CN_CELLS,
    }
    return counts, serving, stages


CN_TRAIN_STEPS = 3


def centernet_assign_fn(boxes, labels, valid):
    # objectness slot at class index 0; real labels shift by +1
    return [centernet_heatmap_assign(
        boxes, labels + 1, valid, img_dim=(CANVAS, CANVAS),
        num_classes=NUM_CLASSES + 1)[0]]


def make_centernet_trainer(*, kernels=None):
    model = CenterNetFPNSingle(
        num_classes=NUM_CLASSES, backbone=BACKBONE,
        generator=torch.Generator().manual_seed(SEED)).to(DEV)
    opt = make_optimizer("adam", exponential_with_floor(1e-3), grad_clip=1.0)

    def loss_fn(y_true, y_pred):
        return fcos_loss(y_true, [y_pred], cen_type="l1", kernels=kernels)

    step = make_train_step(model, centernet_assign_fn, loss_fn, opt)
    return model, create_train_state(model, None, opt), step


def kernel_and_plain_steps(name, make, assign, batches, *, warmup):
    """Train `batches` on the kernel path (the counted run) and, from the
    same seeded state, on the plain path; one focal launch forward and one
    backward a step, step-1 losses equal to `PATHS_RTOL`. `make(kernels=)`
    returns (model, state, step)."""
    steps = len(batches)
    if warmup:                                 # cuDNN picks plans
        _, state, step = make()
        run_steps(state, step, batches[:1])
        del state, step
    _, state, step = make()
    torch.cuda.reset_peak_memory_stats()

    # ---- the counted run: counts set to 0 just before, read just after
    kcommon.reset_launch_counts()
    t0 = time.perf_counter()
    metrics, step_ms = run_steps(state, step, batches)
    wall = time.perf_counter() - t0
    counts = kcommon.launch_counts()
    # ----
    peak_mem = torch.cuda.max_memory_allocated()

    check(state.step == steps, f"{name}: step count {state.step}")
    for i, m in enumerate(metrics):
        check(all(np.isfinite(v) for v in m.values()),
              f"{name} step {i + 1}: non-finite metric {m}")
    check(counts == {"focal_fwd": steps, "focal_bwd": steps},
          f"{name} launched {counts}, expected one focal_fwd and one "
          f"focal_bwd a step")
    check(metrics[0]["num_pos"] > 0,
          f"{name}: no positive cell in the first batch")

    del state, step
    _, pstate, pstep = make(kernels="plain")
    plain_metrics, plain_ms = run_steps(pstate, pstep, batches)
    check(kcommon.launch_counts() == counts,
          f"the plain path of {name} launched a kernel")
    agree = {}
    for key in ("total", "cls", "grad_norm"):
        a, b = metrics[0][key], plain_metrics[0][key]
        agree[key] = abs(a - b) / max(abs(a), abs(b))
        check(close(a, b, PATHS_RTOL),
              f"{name} step 1 {key}: kernel path {a}, plain path {b} "
              f"(tolerance rtol {PATHS_RTOL})")
    b0 = batches[0]
    assign_ms = time_ms(lambda: assign(
        b0["boxes"], b0["labels"], b0["valid"]), warmup=1, reps=5)
    batch = int(batches[0]["images"].shape[0])
    return counts, {
        "batch": batch, "steps": steps,
        "step_ms": step_ms, "plain_path_step_ms": plain_ms,
        "images_per_s": batch * steps / wall,
        "peak_memory_bytes": peak_mem, "assign_ms": assign_ms,
        "metrics_step_1": metrics[0], "metrics_last": metrics[-1],
        "plain_metrics_step_1": plain_metrics[0],
        "plain_metrics_last": plain_metrics[-1],
        "kernel_vs_plain_rel": agree,
    }


def centernet_train_path():
    batches = [{k: cuda(v) for k, v in train_batch(SEED + 20 + i).items()}
               for i in range(CN_TRAIN_STEPS)]
    counts, out = kernel_and_plain_steps(
        "centernet training", make_centernet_trainer, centernet_assign_fn,
        batches, warmup=True)
    steady = out["step_ms"][1:]
    return counts, {"optimizer": "adam", **out,
                    "step_ms_mean_after_first": sum(steady) / len(steady)}


def centernet_cli_path(ckpt_root):
    from detectax_torch.cli import train_centernet_heatmap

    steps = 3
    with tempfile.TemporaryDirectory() as tmp:
        ckpt_dir = os.path.join(ckpt_root, "centernet_heatmap")
        kcommon.reset_launch_counts()
        summary = train_centernet_heatmap.main([
            "--backbone", BACKBONE, "--canvas", str(CANVAS),
            "--batch_size", "16", "--max_steps", str(steps),
            "--display_step", "1", "--step_save", str(steps),
            "--synthetic_n", "48",
            "--ckpt_dir", ckpt_dir, "--out_dir", os.path.join(tmp, "out"),
        ])
        counts = kcommon.launch_counts()
        check(summary["final_step"] == steps, f"CLI trained {summary}")
        check(np.isfinite(summary["total"]) and np.isfinite(
            summary["grad_norm"]), f"CLI metrics not finite: {summary}")
        check(counts == {"focal_fwd": steps, "focal_bwd": steps},
              f"CLI training launched {counts}, expected {steps} and "
              f"{steps}")
        nc = 3  # the synthetic dataset's classes
        model = CenterNetFPNSingle(num_classes=nc, backbone=BACKBONE).to(DEV)
        fresh = model.cls_head.Conv_0.weight.clone()
        restore_for_inference(ckpt_dir, model)
        check(not torch.equal(fresh, model.cls_head.Conv_0.weight),
              "restore left the model's weights as they were")
    # three steps from the focal prior leave every score near 0.01: serve
    # with no score threshold so that the request has detections to check
    pred = centernet_predictor(model, score_thresh=0.0)
    rng = np.random.default_rng(SEED + 4)
    images = rng.uniform(-1, 1, size=(8, CANVAS, CANVAS, 3)) \
        .astype(np.float32)
    kcommon.reset_launch_counts()
    dets = pred.predict(images)
    check(kcommon.launch_counts() == {"peak": 1, "dense_nms": 1},
          f"request from the checkpoint launched {kcommon.launch_counts()}")
    check(dets["boxes"].shape == (8, 100, 4)
          and dets["num_valid"].shape == (8,),
          "centernet request from the checkpoint: wrong output shapes")
    check(np.isfinite(dets["boxes"]).all()
          and np.isfinite(dets["scores"]).all(),
          "centernet request from the checkpoint: non-finite output")
    check((dets["num_valid"] > 0).all()
          and (dets["classes"][dets["valid"]] < nc).all(),
          "centernet request from the checkpoint: no or impossible "
          "detections")
    return {k: summary[k] for k in ("final_step", "images_per_sec", "total",
                                    "grad_norm")}


S8_TRAIN_STEPS = 2


def s8_assign_fn(boxes, labels, valid):
    return centernet_scale_slot_assign(
        boxes, labels, valid, img_dim=(S8_CANVAS, S8_CANVAS),
        num_classes=NUM_CLASSES, box_scales=S8_SCALES)[0]


def make_s8_trainer(*, kernels=None):
    model = CenterNetS8(
        num_classes=NUM_CLASSES, n_scales=len(S8_SCALES), backbone=BACKBONE,
        generator=torch.Generator().manual_seed(SEED)).to(DEV)
    opt = make_optimizer(
        "sgd", piecewise_constant(0.01, [20000, 25000], [0.1, 0.1]),
        grad_clip=1.0)
    step = make_train_step(
        model, s8_assign_fn,
        functools.partial(centernet_s8_loss, kernels=kernels), opt)
    return model, create_train_state(model, None, opt), step


def s8_train_path():
    """`CenterNetS8` at its reference canvas of 512 px, batch 16, 5 slots:
    `centernet_scale_slot_assign` -> `centernet_s8_loss` -> SGD with the
    piecewise schedule. The focal kernel reads channels 4: of the
    ``[16, 64, 64, 5, 24]`` maps in place. No warm-up: the first step's
    time includes cuDNN's choice of plans."""
    batches = [{k: cuda(v)
                for k, v in train_batch(SEED + 30 + i, S8_CANVAS).items()}
               for i in range(S8_TRAIN_STEPS)]
    counts, out = kernel_and_plain_steps(
        "scale-slot training", make_s8_trainer, s8_assign_fn, batches,
        warmup=False)
    return counts, {"optimizer": "sgd", "canvas": S8_CANVAS,
                    "slots": len(S8_SCALES), **out}


def s8_cli_path():
    """`cli.train_centernet_crowdhuman` for a few steps on the synthetic
    dataset (Gaussian class targets, which go through the assigner's
    `scatter_reduce_` maximum), then one 8-image request at 512 px from
    the checkpoint: 20,480 candidates an image through the dense kernel."""
    from detectax_torch.cli import train_centernet_crowdhuman

    steps = 2
    with tempfile.TemporaryDirectory() as tmp:
        ckpt_dir = os.path.join(tmp, "ckpt")
        kcommon.reset_launch_counts()
        summary = train_centernet_crowdhuman.main([
            "--backbone", BACKBONE, "--canvas", str(S8_CANVAS),
            "--batch_size", "16", "--max_steps", str(steps),
            "--display_step", "1", "--step_save", str(steps),
            "--synthetic_n", "32", "--gaussian_cls",
            "--ckpt_dir", ckpt_dir, "--out_dir", os.path.join(tmp, "out"),
        ])
        counts = kcommon.launch_counts()
        check(summary["final_step"] == steps, f"CLI trained {summary}")
        check(np.isfinite(summary["total"]) and np.isfinite(
            summary["grad_norm"]), f"CLI metrics not finite: {summary}")
        check(counts == {"focal_fwd": steps, "focal_bwd": steps},
              f"CLI training launched {counts}, expected {steps} and "
              f"{steps}")
        nc = 3  # the synthetic dataset's classes
        model = CenterNetS8(num_classes=nc, n_scales=len(S8_SCALES),
                            backbone=BACKBONE).to(DEV)
        fresh = model.cls_head_1.Conv_0.weight.clone()
        restore_for_inference(ckpt_dir, model)
        check(not torch.equal(fresh, model.cls_head_1.Conv_0.weight),
              "restore left the model's weights as they were")
    pred = centernet_predictor(model, buckets=(8,), canvas=S8_CANVAS,
                               score_thresh=0.0)
    rng = np.random.default_rng(SEED + 5)
    images = rng.uniform(0, 1, size=(8, S8_CANVAS, S8_CANVAS, 3)) \
        .astype(np.float32)
    kcommon.reset_launch_counts()
    dets = pred.predict(images)
    check(kcommon.launch_counts() == {"dense_nms": 1},
          f"request from the checkpoint launched {kcommon.launch_counts()}")
    want = centernet_predictor(model, kernels="plain", buckets=(8,),
                               canvas=S8_CANVAS, score_thresh=0.0) \
        .predict(images)
    name = "scale-slot request from the checkpoint"
    check(dets["boxes"].shape == (8, 100, 4)
          and dets["num_valid"].shape == (8,), f"{name}: wrong output shapes")
    check(np.isfinite(dets["boxes"]).all()
          and np.isfinite(dets["scores"]).all(), f"{name}: non-finite output")
    check((dets["num_valid"] > 0).all()
          and (dets["classes"][dets["valid"]] < nc).all(),
          f"{name}: no or impossible detections")
    same_detections(name, dets, want)
    # the same checkpoint on one 1024-px image, as `cli.infer_centernet
    # --variant s8 --img_dims 1024` serves it: 81,920 candidates, past the
    # dense kernel's register tier (its shared-memory tier)
    side = 2 * S8_CANVAS
    check(K._dense_plan(len(S8_SCALES) * (side // 8) ** 2)["tier"]
          == "shared", "the 1024-px request is not on the shared tier")
    big = [centernet_predictor(model, kernels=k, buckets=(1,), canvas=side,
                               score_thresh=0.0) for k in (None, "plain")]
    image = rng.uniform(0, 1, size=(1, side, side, 3)).astype(np.float32)
    kcommon.reset_launch_counts()
    dets = big[0].predict(image)
    check(kcommon.launch_counts() == {"dense_nms": 1},
          f"1024-px request launched {kcommon.launch_counts()}")
    check(int(dets["num_valid"][0]) > 0, "1024-px request: no detection")
    same_detections(f"{name} at {side} px", dets, big[1].predict(image))
    return {**{k: summary[k] for k in ("final_step", "images_per_sec",
                                       "total", "grad_norm")},
            f"num_valid_at_{side}_px": int(dets["num_valid"][0])}


# --------------------------------------------------------------------------
# phase 8: DetBench, evaluation and the FCOS center variants
# --------------------------------------------------------------------------

TRUNK = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     "benchmarks", "runs", "pretrain_r50", "backbone.msgpack")
DETBENCH_STEPS = 4


def detbench_path():
    """`cli.train_fcos --dataset detbench` for 4 steps at 384 px, batch 16,
    from the crop-pretrained trunk where the checkout holds it, then
    `cli.evaluate --dataset detbench` over the 256-image eval split twice:
    on the kernels (the counted run: the fused dense kernel, one launch a
    batch of 8) and with every kernel on its plain version; the two
    summaries must be equal. DetBench lies in the run's cache (`main`).
    Four steps leave the scores near the focal prior, so the evaluation
    keeps every candidate (no score threshold): each image then has 100
    detections to compare."""
    import contextlib
    import io

    from detectax_torch.cli import evaluate, train_fcos
    from detectax_torch.data.detbench import DetBenchDataset

    with tempfile.TemporaryDirectory() as tmp:
        ckpt_dir = os.path.join(tmp, "ckpt")
        init = (["--init_backbone", TRUNK, "--freeze_bn"]
                if os.path.exists(TRUNK) else [])
        log(f"detbench: training from the crop-pretrained trunk {TRUNK}"
            if init else "detbench: the checkout holds no pretrained trunk; "
            "training from a fresh seeded init")
        t0 = time.perf_counter()
        DetBenchDataset("train")
        DetBenchDataset("eval")
        cache_s = time.perf_counter() - t0
        kcommon.reset_launch_counts()
        summary = train_fcos.main([
            "--dataset", "detbench", "--backbone", BACKBONE,
            "--canvas", str(CANVAS), "--batch_size", "16",
            "--max_steps", str(DETBENCH_STEPS), "--display_step", "2",
            "--step_save", str(DETBENCH_STEPS), "--ckpt_dir", ckpt_dir,
            "--out_dir", os.path.join(tmp, "out"), *init,
        ])
        train_counts = kcommon.launch_counts()
        check(summary["final_step"] == DETBENCH_STEPS
              and np.isfinite(summary["total"]),
              f"DetBench training: {summary}")
        check(train_counts == {"focal_fwd": DETBENCH_STEPS,
                               "focal_bwd": DETBENCH_STEPS},
              f"DetBench training launched {train_counts}")
        argv = ["--family", "fcos", "--dataset", "detbench",
                "--backbone", BACKBONE, "--ckpt_dir", ckpt_dir,
                "--coco_metrics", "--cls_thresh", "0.0"]
        quiet = io.StringIO()
        # ---- the counted run: counts set to 0 just before, read just after
        kcommon.reset_launch_counts()
        t1 = time.perf_counter()
        with contextlib.redirect_stdout(quiet):
            got = evaluate.main(argv)
        eval_s = time.perf_counter() - t1
        counts = kcommon.launch_counts()
        # ----
        with contextlib.redirect_stdout(quiet):
            want = evaluate.main(argv + ["--plain_kernels"])
        check(kcommon.launch_counts() == counts,
              "the plain-kernel evaluation launched a kernel")
    batches = -(-256 // 8)
    check(counts == {"dense_nms": batches},
          f"DetBench evaluation launched {counts}, expected {batches} "
          f"dense_nms")
    check(got["num_images"] == 256, f"evaluated {got['num_images']} images")
    check(got == want, f"DetBench summaries differ: kernels {got}, plain "
                       f"versions {want}")
    return counts, {
        "trunk": bool(init), "cache_s": cache_s, "train": {
            k: summary[k] for k in ("final_step", "images_per_sec", "total",
                                    "grad_norm")},
        "eval_s": eval_s, "eval_images_per_s": 256 / eval_s,
        "summary": got, "summaries_equal": True,
    }


CENTER_STEPS = 2
# variant: (its trainer CLI, its optimizer)
CENTER_VARIANTS = {"center": ("train_fcos_center_voc", "adam"),
                   "center_v1": ("train_fcos_center_v1_voc", "sgd")}


def center_assign_fn(variant):
    img = (CANVAS, CANVAS)
    if variant == "center":
        return lambda b, l, v: fcos_center_assign(
            b, l, v, img_dim=img, num_classes=NUM_CLASSES,
            center_only=True)[0]
    return lambda b, l, v: fcos_center_v1_assign(
        b, l, v, img_dim=img, num_classes=NUM_CLASSES)[0]


def make_center_trainer(variant, *, kernels=None):
    """FCOS `variant` at full width as its trainer composes it: the center
    assigner, `fcos_loss` with the centerness as a focal term (ten
    segments, one grouped call), Adam piecewise (center) or SGD-momentum
    with exponential decay (center_v1), clip 1.0."""
    model = FCOS(num_classes=NUM_CLASSES, variant=variant, backbone=BACKBONE,
                 generator=torch.Generator().manual_seed(SEED)).to(DEV)
    if variant == "center":
        opt = make_optimizer("adam", piecewise_constant(1e-3, [8000], [0.1]),
                             grad_clip=1.0)
    else:
        opt = make_optimizer("sgd", exponential_with_floor(0.01),
                             grad_clip=1.0)
    loss = functools.partial(fcos_loss, reg_type="l1", cen_type="focal",
                             kernels=kernels)
    step = make_train_step(model, center_assign_fn(variant), loss, opt)
    return model, create_train_state(model, None, opt), step


def center_cli(variant, cli):
    """The variant's trainer CLI for 2 steps on the synthetic dataset, then
    one 8-image request from its checkpoint, kernels against plain
    versions."""
    import importlib

    main_fn = importlib.import_module(f"detectax_torch.cli.{cli}").main
    with tempfile.TemporaryDirectory() as tmp:
        ckpt_dir = os.path.join(tmp, "ckpt")
        kcommon.reset_launch_counts()
        summary = main_fn([
            "--backbone", BACKBONE, "--canvas", str(CANVAS),
            "--batch_size", "16", "--max_steps", str(CENTER_STEPS),
            "--display_step", "1", "--step_save", str(CENTER_STEPS),
            "--synthetic_n", "32", "--ckpt_dir", ckpt_dir,
            "--out_dir", os.path.join(tmp, "out"),
        ])
        counts = kcommon.launch_counts()
        check(summary["final_step"] == CENTER_STEPS
              and np.isfinite(summary["total"]), f"{cli} trained {summary}")
        check(counts == {"focal_fwd": CENTER_STEPS,
                         "focal_bwd": CENTER_STEPS},
              f"{cli} launched {counts}, expected one focal launch each "
              f"way a step")
        nc = 3  # the synthetic dataset's classes
        model = FCOS(num_classes=nc, variant=variant,
                     backbone=BACKBONE).to(DEV)
        restore_for_inference(ckpt_dir, model)
    decode = fcos_decode_fn(variant, CANVAS)
    preds = [Predictor.for_model(
        make_serving_fn(model, decode, kernels=k, score_thresh=0.0), model,
        canvas=CANVAS, buckets=(8,), device=DEV) for k in (None, "plain")]
    images = np.random.default_rng(SEED + 6).uniform(
        -1, 1, size=(8, CANVAS, CANVAS, 3)).astype(np.float32)
    kcommon.reset_launch_counts()
    dets = preds[0].predict(images)
    check(kcommon.launch_counts() == {"dense_nms": 1},
          f"{cli} request launched {kcommon.launch_counts()}")
    name = f"{cli} request from the checkpoint"
    check(dets["boxes"].shape == (8, 100, 4), f"{name}: wrong shapes")
    check(np.isfinite(dets["boxes"]).all()
          and np.isfinite(dets["scores"]).all(), f"{name}: non-finite")
    check((dets["num_valid"] > 0).all()
          and (dets["classes"][dets["valid"]] < nc).all(),
          f"{name}: no or impossible detections")
    same_detections(name, dets, preds[1].predict(images))
    return {k: summary[k] for k in ("final_step", "images_per_sec", "total",
                                    "grad_norm")}


def center_paths():
    counts, out = {}, {}
    for variant, (cli, opt) in CENTER_VARIANTS.items():
        batches = [{k: cuda(v) for k, v in train_batch(SEED + 40 + i).items()}
                   for i in range(CENTER_STEPS)]
        counts[variant], rows = kernel_and_plain_steps(
            f"FCOS {variant} training",
            functools.partial(make_center_trainer, variant),
            center_assign_fn(variant), batches, warmup=False)
        out[variant] = {"optimizer": opt, **rows,
                        "cli": center_cli(variant, cli)}
    return counts, out


# --------------------------------------------------------------------------
# phase 9: the RetinaNet family (serving, training, evaluation)
# --------------------------------------------------------------------------

RN_BACKBONE, RN_CANVAS, RN_CLASSES = "resnet101", 512, 81
RN_SIZES = (20.0, 40.0, 80.0, 160.0, 320.0)   # the trainer's anchor sizes
RN_ANCHORS = anchor_shapes_per_level(anchor_sizes=RN_SIZES)
RN_LEVELS = (64, 32, 16, 8, 4)   # h = w of the five levels at 512 px
RN_CANDIDATES = 9 * sum(h * h for h in RN_LEVELS)           # 49,104
RN_HIGH_RES_CANDIDATES = 9 * sum(4 * h * h for h in RN_LEVELS)  # 196,416
# the two NMS configurations of the family: `cli.evaluate` (class-aware,
# score 0.05, 100 outputs) and `cli.infer_retinanet` (class-agnostic,
# score 0.30, 200 outputs)
RN_CONFIGS = {"evaluate": {},
              "infer": dict(class_aware=False, score_thresh=0.30,
                            max_outputs=200)}
RN_STEPS = 3
RN_DETBENCH_STEPS = 4
# later steps of the bf16 kernel path against its plain path: after step
# 1 the parameters differ by float32 roundings of the focal gradient's two
# evaluations (closed form against autograd). From random weights the
# losses are in the thousands and every step is clipped, so that
# difference grows: the float32 paths of this script already differ by up
# to 1.1e-3 (grad_norm) at their last step; in bf16 it also moves
# roundings of activations, 2^-8 relative each (2.4e-3 seen in total at
# step 3 on the H100). The tolerance is the bf16 step tolerance of the CPU
# tests, tests/test_torch_bf16.py
BF16_LATER_RTOL = 2e-2


def check_focal_retinanet():
    """The RetinaNet class term of a step at batch 16, 512 px, 81 classes,
    9 anchors, as `retinanet_loss` hands it over: the class channels
    ``y[..., 4:]`` of the five level maps ``[16, h, h, 9, 85]`` read in
    place (81 of 85 columns, 785,664 rows, 63,638,784 elements) in one
    `focal_loss_group` call. Each segment's sum and dlogits against the
    plain version, one launch each way, two runs bitwise equal, and the
    same bits from contiguous clones of the segments."""
    gen = torch.Generator(device=DEV).manual_seed(SEED + 12)
    maps = []
    for h in RN_LEVELS:
        shape = (FOCAL_BATCH, h, h, 9, 4 + RN_CLASSES)
        z = (torch.rand(shape, generator=gen, device=DEV) < 0.005).float()
        x = 4.0 * torch.randn(shape, generator=gen, device=DEV)
        maps.append((z, x))
    zs = [z[..., 4:] for z, _ in maps]
    xs = [x[..., 4:].detach().requires_grad_(True) for _, x in maps]
    check(not xs[0].is_contiguous(), "RetinaNet focal segments contiguous")
    name = "focal RetinaNet group (5 levels, 81 of 85 columns)"
    upstream = torch.linspace(0.5, 2.0, len(xs), device=DEV)

    def run(group, zz, xx):
        out = group(list(zip(zz, xx)))
        check(group is not KF.focal_loss_group or through_operator(out),
              f"{name}: the call did not go through the operator")
        return out.detach(), torch.autograd.grad(out, xx, upstream)

    before = kcommon.launch_counts()
    got, got_grads = run(KF.focal_loss_group, zs, xs)
    after = kcommon.launch_counts()
    again, again_grads = run(KF.focal_loss_group, zs, xs)
    torch.cuda.synchronize()
    for key in ("focal_fwd", "focal_bwd"):
        check(after.get(key, 0) - before.get(key, 0) == 1,
              f"{name}: {after.get(key, 0) - before.get(key, 0)} {key} "
              f"launches for one call, expected 1")
    check(torch.equal(got, again)
          and all(torch.equal(a, b) for a, b in zip(got_grads, again_grads)),
          f"{name}: two runs on the same input differ in their bits")
    clones = ([z.clone() for z in zs],
              [x.detach().clone().requires_grad_(True) for x in xs])
    c_sum, c_grads = run(KF.focal_loss_group, *clones)
    check(torch.equal(got, c_sum)
          and all(torch.equal(a, b) for a, b in zip(got_grads, c_grads)),
          f"{name}: the contiguous clones give other bits")
    want, want_grads = run(KF.focal_loss_group_plain, zs, xs)
    sum_rel, grad_err = 0.0, 0.0
    for i, (g, w, gg, wg) in enumerate(zip(got, want, got_grads,
                                           want_grads)):
        rel = float((g - w).abs() / w.abs().clamp_min(1e-30))
        err = float((gg - wg).abs().max())
        check(rel <= FOCAL_SUM_RTOL, f"{name}: level {i} sum {float(g)} vs "
                                     f"plain {float(w)} (rel {rel})")
        check(err <= FOCAL_GRAD_ATOL, f"{name}: level {i} dlogits differ by "
                                      f"{err}")
        sum_rel, grad_err = max(sum_rel, rel), max(grad_err, err)
    del want_grads, c_grads, again_grads, clones
    segs = list(zip(zs, xs))
    ones = torch.ones(len(xs), device=DEV)

    def fwd_bwd(group):
        def run_():
            torch.autograd.grad(group(segs), xs, ones)
        return run_

    with torch.no_grad():
        ms = queued_ms(lambda: KF.focal_loss_group(segs), reps=20)
        call_ms = time_ms(lambda: KF.focal_loss_group(segs), warmup=2,
                          reps=20)
        plain_ms = time_ms(lambda: KF.focal_loss_group_plain(segs),
                           warmup=1, reps=3)
        library_ms = time_ms(lambda: [library_focal(z, x) for z, x in segs],
                             warmup=1, reps=3)
    fwd_bwd_ms = queued_ms(fwd_bwd(KF.focal_loss_group), reps=20)
    plain_fwd_bwd_ms = time_ms(fwd_bwd(KF.focal_loss_group_plain),
                               warmup=1, reps=3)
    n = sum(x.numel() for x in xs)
    bound_ms, bound_by = bound(n * 8 + 4 * len(xs), n * FOCAL_FWD_FLOPS)
    fwd_bwd_bound_ms, _ = bound(n * 20 + 8 * len(xs),
                                n * (FOCAL_FWD_FLOPS + FOCAL_BWD_FLOPS))
    plan = KF._focal_plan([(int(np.prod(x.shape[:-1])), x.shape[-1])
                           for x in xs])
    return {
        "shape": {"case": "retinanet_group", "B": FOCAL_BATCH,
                  "levels": RN_LEVELS, "anchors": 9, "classes": RN_CLASSES,
                  "row_stride": 4 + RN_CLASSES, "elements": n,
                  "rows": sum(int(np.prod(x.shape[:-1])) for x in xs)},
        "max_abs_err": grad_err, "sum_rel_err": sum_rel,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": library_ms,
        "fwd_bwd_ms": fwd_bwd_ms, "plain_fwd_bwd_ms": plain_fwd_bwd_ms,
        "fwd_bwd_bound_ms": fwd_bwd_bound_ms, "call_ms": call_ms,
        "grid_blocks": sum(b for _, b, _ in plan),
        "rows_per_block": [r for _, _, r in plan],
        "bitwise_equal_to_clones": True,
    }


def build_retinanet(dtype=torch.float32) -> RetinaNet:
    return RetinaNet(num_classes=RN_CLASSES, backbone=RN_BACKBONE,
                     dtype=dtype,
                     generator=torch.Generator().manual_seed(SEED))


def calibrate_retinanet(model, images) -> float:
    """Set the class heads' biases so that a tenth of the candidates' best
    class scores reach 0.35 on `images`: the focal prior would leave NMS
    nothing, and a fixed bias cannot know the seeded towers' scale.
    Returns the bias (a pure function of the seed)."""
    with torch.no_grad():
        for i in range(1, 6):
            getattr(model, f"cls_head_{i}").Conv_0.bias.zero_()
        outs = model(torch.from_numpy(images).to(DEV))
        best = torch.cat([o[..., 4:].amax(-1).flatten() for o in outs])
        bias = float(np.log(0.35 / 0.65) - best.quantile(0.9))
        for i in range(1, 6):
            getattr(model, f"cls_head_{i}").Conv_0.bias.fill_(bias)
    return bias


def retinanet_predictor(model, *, kernels=None, buckets=BUCKETS,
                        canvas=None, **serving) -> Predictor:
    fn = make_serving_fn(model, retinanet_decode_fn(RN_SIZES),
                         kernels=kernels, **serving)
    return Predictor.for_model(fn, model, canvas=canvas or RN_CANVAS,
                               buckets=buckets, device=DEV)


def retinanet_serving_path():
    """ResNet-101 RetinaNet, 81 classes, 9 anchors, 512 px, fp32, seeded
    weights, through `Predictor` with buckets (1, 8) and the request mix,
    in both NMS configurations (the counted run: the dense kernel once a
    chunk each), then the same requests on the plain versions; one
    1024-px image (the infer CLI's `--high_res`: 196,416 candidates, the
    dense kernel's device-memory tier) against the plain path."""
    from detectax_torch.infer.predict import (
        detections_from_dense,
        retinanet_decode,
    )

    rng = np.random.default_rng(SEED + 30)
    requests = [rng.uniform(-1, 1, size=(n, RN_CANVAS, RN_CANVAS, 3))
                .astype(np.float32) for n in REQUESTS]
    model = build_retinanet().to(DEV).eval()
    bias = calibrate_retinanet(model, requests[2])
    with torch.no_grad():
        boxes, probs = retinanet_decode(
            model(torch.from_numpy(requests[0]).to(DEV)),
            anchors_per_level=RN_ANCHORS)
    best = probs.amax(-1)
    passing = {str(t): int((best >= t).sum()) for t in (0.05, 0.30)}
    log(f"retinanet serving: M={probs.shape[1]} candidates an image, "
        f"class-head bias {bias:.4f}, passing in the first image: "
        f"{passing}")
    check(probs.shape[1] == RN_CANDIDATES,
          f"expected {RN_CANDIDATES} candidates, got {probs.shape[1]}")
    check(passing["0.05"] >= 1000 and passing["0.3"] >= 100,
          f"too few candidates pass the thresholds: {passing}")
    check(K._dense_plan(RN_CANDIDATES)["tier"] == "registers"
          and K._dense_plan(RN_HIGH_RES_CANDIDATES)["tier"] == "device",
          "the RetinaNet sizes are not on the expected dense tiers")
    preds = {name: retinanet_predictor(model, **kw)
             for name, kw in RN_CONFIGS.items()}
    for p in preds.values():
        p.warmup()

    # ---- the counted run: counts set to 0 just before, read just after
    kcommon.reset_launch_counts()
    results, timings = {}, {}
    for name, p in preds.items():
        results[name], timings[name] = serve(p, requests)
    counts = kcommon.launch_counts()
    # ----
    chunks = sum(len(preds["evaluate"]._plan(n)) for n in REQUESTS)
    check(counts == {"dense_nms": 2 * chunks},
          f"RetinaNet serving launched {counts}, expected dense_nms once a "
          f"chunk = {2 * chunks}")
    for name, kw in RN_CONFIGS.items():
        max_out = kw.get("max_outputs", 100)
        for n, dets in zip(REQUESTS, results[name]):
            check_detections(f"RetinaNet {name}, request of {n}", dets, n,
                             max_outputs=max_out)
        if name == "infer":
            check(all((d["scores"][d["valid"]] >= 0.30).all()
                      for d in results[name]),
                  "RetinaNet infer: a kept score below 0.30")
        plain = retinanet_predictor(model, kernels="plain", **kw)
        plain_out, _ = serve(plain, requests)
        for n, got, want in zip(REQUESTS, results[name], plain_out):
            same_detections(f"RetinaNet {name}, request of {n}", got, want)
    check(kcommon.launch_counts() == counts,
          "the RetinaNet plain paths launched a kernel")

    side = 2 * RN_CANVAS
    big = [retinanet_predictor(model, kernels=k, buckets=(1,), canvas=side,
                               **RN_CONFIGS["infer"]) for k in (None, "plain")]
    image = rng.uniform(-1, 1, size=(1, side, side, 3)).astype(np.float32)
    kcommon.reset_launch_counts()
    t0 = time.perf_counter()
    high = big[0].predict(image)
    high_s = time.perf_counter() - t0
    high_counts = kcommon.launch_counts()
    check(high_counts == {"dense_nms": 1},
          f"1024-px RetinaNet request launched {high_counts}")
    check_detections(f"RetinaNet at {side} px", high, 1, max_outputs=200)
    same_detections(f"RetinaNet at {side} px", high, big[1].predict(image))
    counts = {"dense_nms": counts.get("dense_nms", 0)
              + high_counts.get("dense_nms", 0)}

    stages = {}
    with torch.no_grad():
        x = torch.from_numpy(requests[2]).to(DEV)
        outs = model(x)
        boxes, probs = retinanet_decode(outs, anchors_per_level=RN_ANCHORS)
        t = lambda fn: time_ms(fn, warmup=2, reps=10)
        stages = {
            "forward": t(lambda: model(x)),
            "decode": t(lambda: retinanet_decode(
                outs, anchors_per_level=RN_ANCHORS)),
        }
        for name, kw in RN_CONFIGS.items():
            stages[f"nms_stage_{name}"] = t(
                lambda kw=kw: detections_from_dense(boxes, probs, **kw))
    return counts, {
        "class_head_bias": bias, "candidates": RN_CANDIDATES,
        "passing_first_image": passing,
        "paths": {name: {
            "images_per_s": sum(REQUESTS) / sum(timings[name]),
            "request_ms": {str(n): s * 1e3
                           for n, s in zip(REQUESTS, timings[name])}}
            for name in RN_CONFIGS},
        f"request_ms_at_{side}_px": high_s * 1e3,
        f"num_valid_at_{side}_px": int(high["num_valid"][0]),
        "stage_ms_batch_8": stages,
    }


def retinanet_assign_fn(boxes, labels, valid):
    return retinanet_assign(
        boxes, labels, valid, img_dim=(RN_CANVAS, RN_CANVAS),
        num_classes=RN_CLASSES, anchors_per_level=RN_ANCHORS)[0]


def make_retinanet_trainer(*, kernels=None, dtype=torch.float32):
    """RetinaNet-R101 at full width as `cli.train_retinanet_coco` composes
    it: `retinanet_assign`, `retinanet_loss` (the five levels' class terms
    in one grouped focal call), SGD-momentum, piecewise lr 0.01, clip
    1.0."""
    model = build_retinanet(dtype).to(DEV)
    opt = make_optimizer("sgd", piecewise_constant(0.01, [60000], [0.1]),
                         grad_clip=1.0)
    step = make_train_step(
        model, retinanet_assign_fn,
        functools.partial(retinanet_loss, kernels=kernels), opt)
    return model, create_train_state(model, None, opt), step


def retinanet_batches(seed: int, n: int) -> list:
    return [{k: cuda(v) for k, v in train_batch(
        seed + i, canvas=RN_CANVAS, nc=RN_CLASSES).items()}
        for i in range(n)]


def retinanet_train_path():
    batches = retinanet_batches(SEED + 50, RN_STEPS)
    counts, out = kernel_and_plain_steps(
        "RetinaNet training", make_retinanet_trainer, retinanet_assign_fn,
        batches, warmup=True)
    steady = out["step_ms"][1:]
    return counts, {"optimizer": "sgd", **out,
                    "step_ms_mean_after_first": sum(steady) / len(steady)}


def retinanet_cli_path(ckpt_root):
    """`cli.train_retinanet_coco` for 2 steps at 512 px, batch 16, on the
    synthetic dataset (checkpoint under ``ckpt_root/retinanet``), then one
    8-image request from its checkpoint on the kernels and on the plain
    versions."""
    from detectax_torch.cli import train_retinanet_coco

    steps = 2
    with tempfile.TemporaryDirectory() as tmp:
        ckpt_dir = os.path.join(ckpt_root, "retinanet")
        kcommon.reset_launch_counts()
        summary = train_retinanet_coco.main([
            "--backbone", RN_BACKBONE, "--canvas", str(RN_CANVAS),
            "--batch_size", "16", "--max_steps", str(steps),
            "--display_step", "1", "--step_save", str(steps),
            "--synthetic_n", "32", "--ckpt_dir", ckpt_dir,
            "--out_dir", os.path.join(tmp, "out"),
        ])
        counts = kcommon.launch_counts()
        check(summary["final_step"] == steps
              and np.isfinite(summary["total"]), f"CLI trained {summary}")
        check(counts == {"focal_fwd": steps, "focal_bwd": steps},
              f"RetinaNet CLI launched {counts}")
        nc = 3  # the synthetic dataset's classes
        model = RetinaNet(num_classes=nc, backbone=RN_BACKBONE).to(DEV)
        fresh = model.cls_head_1.Conv_0.weight.clone()
        restore_for_inference(ckpt_dir, model)
        check(not torch.equal(fresh, model.cls_head_1.Conv_0.weight),
              "restore left the model's weights as they were")
    preds = [retinanet_predictor(model, kernels=k, buckets=(8,),
                                 score_thresh=0.0) for k in (None, "plain")]
    images = np.random.default_rng(SEED + 31).uniform(
        -1, 1, size=(8, RN_CANVAS, RN_CANVAS, 3)).astype(np.float32)
    kcommon.reset_launch_counts()
    dets = preds[0].predict(images)
    check(kcommon.launch_counts() == {"dense_nms": 1},
          f"RetinaNet request launched {kcommon.launch_counts()}")
    name = "RetinaNet request from the checkpoint"
    check(dets["boxes"].shape == (8, 100, 4), f"{name}: wrong shapes")
    check((dets["num_valid"] > 0).all()
          and (dets["classes"][dets["valid"]] < nc).all(),
          f"{name}: no or impossible detections")
    same_detections(name, dets, preds[1].predict(images))
    return {k: summary[k] for k in ("final_step", "images_per_sec", "total",
                                    "grad_norm")}


def retinanet_detbench_path():
    """`cli.train_retinanet_coco --dataset detbench_v2 --backbone
    mobilenetv2 --bf16` for a few steps at 512 px, batch 16 (the TPU row's
    recipe: losses over the positives, clip 16), then `cli.evaluate
    --family retinanet` over the 256 eval images on the kernels (the
    counted run: the dense kernel once a batch of 8, 49,104 candidates an
    image, class-aware) and on the plain versions; the summaries must be
    equal. No score threshold, so that every image keeps 100 detections.
    The zero-target filter is off: it is host numpy, the CLI phase runs
    it, and over the split's 4,096 images it took most of this phase
    (59-78 s of training's 4 steps on the H100 machine)."""
    import contextlib
    import io

    from detectax_torch.cli import evaluate, train_retinanet_coco
    from detectax_torch.data.detbench import DetBenchDataset, load_spec

    with tempfile.TemporaryDirectory() as tmp:
        ckpt_dir = os.path.join(tmp, "ckpt")
        t0 = time.perf_counter()
        spec = load_spec(name="detbench_v2")
        DetBenchDataset("train", spec=spec)
        DetBenchDataset("eval", spec=spec)
        cache_s = time.perf_counter() - t0
        kcommon.reset_launch_counts()
        t1 = time.perf_counter()
        summary = train_retinanet_coco.main([
            "--dataset", "detbench_v2", "--backbone", "mobilenetv2",
            "--bf16", "--canvas", str(RN_CANVAS), "--batch_size", "16",
            "--max_steps", str(RN_DETBENCH_STEPS), "--display_step", "2",
            "--step_save", str(RN_DETBENCH_STEPS), "--loss_norm", "pos",
            "--grad_clip", "16", "--no-skip_zero_target",
            "--ckpt_dir", ckpt_dir, "--out_dir", os.path.join(tmp, "out"),
        ])
        train_s = time.perf_counter() - t1
        train_counts = kcommon.launch_counts()
        check(summary["final_step"] == RN_DETBENCH_STEPS
              and np.isfinite(summary["total"]),
              f"DetBench v2 RetinaNet training: {summary}")
        check(train_counts == {"focal_fwd": RN_DETBENCH_STEPS,
                               "focal_bwd": RN_DETBENCH_STEPS},
              f"DetBench v2 RetinaNet training launched {train_counts}")
        argv = ["--family", "retinanet", "--dataset", "detbench_v2",
                "--backbone", "mobilenetv2", "--ckpt_dir", ckpt_dir,
                "--coco_metrics", "--cls_thresh", "0.0"]
        quiet = io.StringIO()
        # ---- the counted run: counts set to 0 just before, read just after
        kcommon.reset_launch_counts()
        t2 = time.perf_counter()
        with contextlib.redirect_stdout(quiet):
            got = evaluate.main(argv)
        eval_s = time.perf_counter() - t2
        counts = kcommon.launch_counts()
        # ----
        with contextlib.redirect_stdout(quiet):
            want = evaluate.main(argv + ["--plain_kernels"])
        check(kcommon.launch_counts() == counts,
              "the plain-kernel evaluation launched a kernel")
    batches = -(-256 // 8)
    check(counts == {"dense_nms": batches},
          f"DetBench v2 evaluation launched {counts}, expected {batches}")
    check(got["num_images"] == 256, f"evaluated {got['num_images']} images")
    check(got == want, f"DetBench v2 summaries differ: kernels {got}, "
                       f"plain versions {want}")
    return train_counts, counts, {
        "cache_s": cache_s, "train_s": train_s,
        "train": {k: summary[k] for k in ("final_step", "images_per_sec",
                                          "total", "cls", "num_pos",
                                          "grad_norm")},
        "eval_s": eval_s, "eval_images_per_s": 256 / eval_s,
        "summary": got, "summaries_equal": True,
    }


def bf16_train_path(fp32_step_ms, retinanet_fp32_step_ms):
    """FCOS-R50 at 384 px, batch 16, bf16 compute: 3 steps on the kernel
    path (the counted run) and 3 on the plain path from the same state;
    step 1 agrees to PATHS_RTOL (the paths differ in the focal sum's order
    only), the last step to BF16_LATER_RTOL. Then 3 RetinaNet-R101 bf16
    steps at 512 px on the kernel path, timed."""
    batches = [{k: cuda(v) for k, v in train_batch(SEED + 10 + i).items()}
               for i in range(TRAIN_STEPS)]

    def make(kernels=None):
        model, state, step, _ = make_trainer(kernels=kernels,
                                             dtype=torch.bfloat16)
        return model, state, step

    counts, out = kernel_and_plain_steps(
        "FCOS bf16 training", make, assign_fn, batches, warmup=True)
    later = {}
    for key in ("total", "cls", "grad_norm"):
        a, b = out["metrics_last"][key], out["plain_metrics_last"][key]
        later[key] = abs(a - b) / max(abs(a), abs(b))
        check(close(a, b, BF16_LATER_RTOL),
              f"FCOS bf16 step {TRAIN_STEPS} {key}: kernel path {a}, plain "
              f"path {b} (tolerance rtol {BF16_LATER_RTOL})")
    rbatches = retinanet_batches(SEED + 50, RN_STEPS)
    _, rstate, rstep = make_retinanet_trainer(dtype=torch.bfloat16)
    run_steps(rstate, rstep, rbatches[:1])   # warm-up: cuDNN picks plans
    kcommon.reset_launch_counts()
    rmetrics, rms = run_steps(rstate, rstep, rbatches)
    rcounts = kcommon.launch_counts()
    check(rcounts == {"focal_fwd": RN_STEPS, "focal_bwd": RN_STEPS},
          f"RetinaNet bf16 training launched {rcounts}")
    check(all(np.isfinite(v) for m in rmetrics for v in m.values()),
          f"RetinaNet bf16 training: non-finite metrics {rmetrics}")
    steady = out["step_ms"][1:]
    return counts, rcounts, {
        "fcos_r50": {**out, "later_steps_rtol": BF16_LATER_RTOL,
                     "kernel_vs_plain_rel_last_step": later,
                     "step_ms_mean_after_first": sum(steady) / len(steady),
                     "fp32_step_ms": fp32_step_ms},
        "retinanet_r101": {"step_ms": rms,
                           "fp32_step_ms": retinanet_fp32_step_ms,
                           "metrics_last": rmetrics[-1]},
    }


# --------------------------------------------------------------------------
# phase 11: the hourglass half of the CenterNet family
# --------------------------------------------------------------------------

HG_CANVAS = 320
# family: (TPU row's batch, candidates an image at 320 px)
HG_MODELS = {"hourglass": (32, 4 * (HG_CANVAS // 8) ** 2),       # 6,400
             "stacked_hourglass": (16, (HG_CANVAS // 4) ** 2)}  # 6,400
HG_BIG_CANDIDATES = (448 // 4) ** 2    # the 448 bucket: 12,544 either way
HG_PATHS = {"dense_nms": {}, "nms_sweep": dict(class_aware_candidates=True)}
HG_STEPS, HG_BF16_STEPS, HG_CLI_STEPS = 3, 2, 2
HG_MICROBATCH = 2   # the trainer's default, which the TPU row kept
# the TPU rows' widths (`benchmarks/run_detbench.py`), and the buckets of
# the multi-scale trainer run
HG_WIDTHS = {"hourglass": 12, "stacked_hourglass": 64}
HG_STACKS = 2
HG_BUCKETS = (256, 320)


def check_focal_hourglass():
    """The class terms of the two hourglass losses as they hand them to
    `focal_loss`, read in place: channels 4: of `StackedHourglass`'s
    ``[16, 80, 80, 24]`` map (20 of 24 columns, 2,048,000 elements) and of
    `HourglassNet`'s ``[32, 40, 40, 4, 25]`` (objectness and classes, 21 of
    25, 4,300,800). Each against its plain version (`check_focal`), and its
    sum and dlogits bitwise equal to those of a contiguous clone."""
    rng = np.random.default_rng(SEED + 13)
    rows = [check_focal(rng, HG_CANVAS // 4, case="strided",
                        classes=NUM_CLASSES, lead=4),
            check_focal(rng, HG_CANVAS // 8, case="strided",
                        classes=NUM_CLASSES + 1, slots=4, lead=4, batch=32)]
    gen = torch.Generator(device=DEV).manual_seed(SEED + 13)
    for row, shape in zip(rows, ((16, 80, 80, 4 + NUM_CLASSES),
                                 (32, 40, 40, 4, 5 + NUM_CLASSES))):
        z = (torch.rand(shape, generator=gen, device=DEV) < 0.01).float()
        x = 4.0 * torch.randn(shape, generator=gen, device=DEV)
        sums, grads = [], []
        for zz, xx in ((z[..., 4:], x[..., 4:]),
                       (z[..., 4:].clone(), x[..., 4:].clone())):
            leaf = xx.detach().requires_grad_(True)
            total = KF.focal_loss(zz, leaf)
            total.backward()
            sums.append(total.detach())
            grads.append(leaf.grad)
        torch.cuda.synchronize()
        check(torch.equal(sums[0], sums[1])
              and torch.equal(grads[0], grads[1]),
              f"focal {shape}[..., 4:]: the view and its clone give other "
              f"bits")
        row["bitwise_equal_to_clone"] = True
        row["shape"]["case"] = ("stacked_hourglass" if len(shape) == 4
                                else "hourglass")
    return rows


def build_hourglass(family, dtype=torch.float32):
    """The TPU rows' widths: `HourglassNet` ``n_filters`` 12,
    `StackedHourglass` ``n_filters`` 64 with two stacks; 20 classes,
    seeded weights."""
    gen = torch.Generator().manual_seed(SEED)
    if family == "hourglass":
        return HourglassNet(num_classes=NUM_CLASSES,
                            n_filters=HG_WIDTHS[family], dtype=dtype,
                            generator=gen)
    return StackedHourglass(num_classes=NUM_CLASSES,
                            n_filters=HG_WIDTHS[family], n_stacks=HG_STACKS,
                            dtype=dtype, generator=gen)


def hourglass_scores(family, out, bias):
    """The best score of each candidate with the focal bias ``bias``."""
    if family == "hourglass":
        obj = torch.sigmoid(out[..., 4] + bias)
        return (obj * torch.sigmoid(out[..., 5:] + bias).amax(-1)).flatten()
    return torch.sigmoid(out[..., 4:] + bias).amax(-1).flatten()


def calibrate_hourglass(model, family, images) -> float:
    """Set the focal bias (`b_focal`) so that a tenth of the candidates'
    best scores reach 0.35 on `images` (bisection): the focal prior leaves
    NMS nothing on random weights. Returns the bias."""
    with torch.no_grad():
        model.b_focal.bias.zero_()
        out = model(torch.from_numpy(images).to(DEV))
        # random weights give the stacked model's class logits in the
        # hundreds: a wide bracket
        lo, hi = -1e4, 1e4
        for _ in range(60):
            mid = 0.5 * (lo + hi)
            share = float((hourglass_scores(family, out, mid) >= 0.35)
                          .float().mean())
            lo, hi = (lo, mid) if share >= 0.1 else (mid, hi)
        model.b_focal.bias.fill_(hi)
    return hi


def hourglass_predictor(model, family, *, kernels=None, buckets=BUCKETS,
                        **serving) -> Predictor:
    decode = hourglass_decode_fn(family, canvas=HG_CANVAS, stride=4)
    fn = make_serving_fn(model, decode, kernels=kernels, **serving)
    return Predictor.for_model(fn, model, canvas=HG_CANVAS, buckets=buckets,
                               device=DEV)


def hourglass_serving_path():
    """Both models at the TPU rows' widths, 20 classes, 320 px, fp32,
    through `Predictor` with buckets (1, 8) and the request mix, with the
    default NMS (the dense kernel) and with combined-NMS candidates (top-k
    + the sweep kernel): the counted run, one launch a chunk each; then the
    same requests on the plain versions."""
    from detectax_torch.infer.predict import detections_from_dense

    rng = np.random.default_rng(SEED + 60)
    requests = [rng.uniform(-1, 1, size=(n, HG_CANVAS, HG_CANVAS, 3))
                .astype(np.float32) for n in REQUESTS]
    counts = {"dense_nms": 0, "nms_sweep": 0}
    out = {}
    for family, (_, cells) in HG_MODELS.items():
        model = build_hourglass(family).to(DEV).eval()
        bias = calibrate_hourglass(model, family, requests[2])
        decode = hourglass_decode_fn(family, canvas=HG_CANVAS, stride=4)
        with torch.no_grad():
            _, probs = decode(model(torch.from_numpy(requests[0]).to(DEV)))
        passing = int((probs.amax(-1) >= 0.05).sum())
        log(f"{family} serving: M={probs.shape[1]} candidates an image, "
            f"focal bias {bias:.4f}, {passing} of the first image pass "
            f"0.05")
        check(probs.shape[1] == cells,
              f"{family}: expected {cells} candidates, got {probs.shape[1]}")
        check(passing >= 300, f"{family}: too few candidates pass 0.05")
        preds = {name: hourglass_predictor(model, family, **kw)
                 for name, kw in HG_PATHS.items()}
        for p in preds.values():
            p.warmup()

        # ---- the counted run: counts set to 0 just before, read just after
        kcommon.reset_launch_counts()
        results, timings = {}, {}
        for name, p in preds.items():
            results[name], timings[name] = serve(p, requests)
        got_counts = kcommon.launch_counts()
        # ----
        chunks = sum(len(preds["dense_nms"]._plan(n)) for n in REQUESTS)
        check(got_counts == {"dense_nms": chunks, "nms_sweep": chunks},
              f"{family} serving launched {got_counts}, expected each NMS "
              f"kernel once a chunk = {chunks}")
        for name, kw in HG_PATHS.items():
            for n, dets in zip(REQUESTS, results[name]):
                check_detections(f"{family} {name}, request of {n}", dets, n)
            plain_out, _ = serve(
                hourglass_predictor(model, family, kernels="plain", **kw),
                requests)
            for n, got, want in zip(REQUESTS, results[name], plain_out):
                same_detections(f"{family} {name}, request of {n}", got,
                                want)
        check(kcommon.launch_counts() == got_counts,
              f"the {family} plain paths launched a kernel")
        for k in counts:
            counts[k] += got_counts.get(k, 0)
        with torch.no_grad():
            x = torch.from_numpy(requests[2]).to(DEV)
            o = model(x)
            boxes, probs = decode(o)
            t = lambda fn: time_ms(fn, warmup=2, reps=10)
            stages = {
                "forward": t(lambda: model(x)),
                "decode": t(lambda: decode(o)),
                "nms_stage_dense": t(
                    lambda: detections_from_dense(boxes, probs)),
                "nms_stage_sweep": t(lambda: detections_from_dense(
                    boxes, probs, class_aware_candidates=True)),
            }
        out[family] = {
            "focal_bias": bias, "candidates": cells,
            "passing_first_image": passing,
            "paths": {name: {
                "images_per_s": sum(REQUESTS) / sum(timings[name]),
                "request_ms": {str(n): sec * 1e3 for n, sec in
                               zip(REQUESTS, timings[name])}}
                for name in HG_PATHS},
            "stage_ms_batch_8": stages,
        }
        del model, preds
        torch.cuda.empty_cache()
    return counts, out


def hourglass_assign_fn(family):
    img = (HG_CANVAS, HG_CANVAS)
    if family == "hourglass":
        scales = tuple(HG_CANVAS / 2.0 ** x for x in reversed(range(4)))
        return lambda b, l, v: hourglass_assign(
            b, l, v, img_dim=img, num_classes=NUM_CLASSES,
            box_scales=scales)[0]
    return lambda b, l, v: stacked_hourglass_assign(
        b, l, v, img_dim=img, num_classes=NUM_CLASSES, stride=4)[0]


def make_hourglass_trainer(family, *, kernels=None, dtype=torch.float32):
    """As `cli.train_hourglass_voc` composes it (without microbatches):
    Adam on the epoch schedule, clip 1.0; `HourglassNet` with the focal
    class loss, so that its focal shape runs."""
    model = build_hourglass(family, dtype).to(DEV)
    opt = make_optimizer("adam", epoch_decay(1e-3, 0.9, 500), grad_clip=1.0)
    if family == "hourglass":
        loss = functools.partial(hourglass_loss, loss_type="focal",
                                 kernels=kernels)
    else:
        loss = functools.partial(stacked_hourglass_loss, kernels=kernels)
    step = make_train_step(model, hourglass_assign_fn(family), loss, opt)
    return model, create_train_state(model, None, opt), step


def hourglass_train_path():
    """Each model at its TPU row's batch: 3 fp32 steps on the kernel path
    (the counted run) and 3 on the plain path from the same state, step 1
    to PATHS_RTOL, the BatchNorm statistics moved; then 2 bf16 steps on
    the kernel path, each step's ms beside the fp32 step's."""
    counts = {"focal_fwd": 0, "focal_bwd": 0}
    bf16_counts = {"focal_fwd": 0, "focal_bwd": 0}
    out = {}
    for i, (family, (batch, _)) in enumerate(HG_MODELS.items()):
        batches = [{k: cuda(v) for k, v in train_batch(
            SEED + 70 + 10 * i + j, canvas=HG_CANVAS, batch=batch).items()}
            for j in range(HG_STEPS)]
        made = []

        def make(kernels=None, family=family):
            model, state, step = make_hourglass_trainer(family,
                                                        kernels=kernels)
            made.append(model)
            return model, state, step

        got, row = kernel_and_plain_steps(
            f"{family} training", make, hourglass_assign_fn(family),
            batches, warmup=True)
        counted = made[1]   # after the warm-up's model
        moved = sum(int((m.running_mean != 0).any())
                    for m in counted.modules() if isinstance(m, BatchNorm))
        check(moved > 0, f"{family}: BatchNorm statistics did not move")
        del made, counted
        torch.cuda.empty_cache()
        _, state, step = make_hourglass_trainer(family, dtype=torch.bfloat16)
        run_steps(state, step, batches[:1])   # warm-up: cuDNN picks plans
        kcommon.reset_launch_counts()
        metrics, ms = run_steps(state, step, batches[:HG_BF16_STEPS])
        got16 = kcommon.launch_counts()
        check(got16 == {"focal_fwd": HG_BF16_STEPS,
                        "focal_bwd": HG_BF16_STEPS},
              f"{family} bf16 training launched {got16}")
        check(all(np.isfinite(v) for m in metrics for v in m.values()),
              f"{family} bf16 training: non-finite metrics {metrics}")
        del state, step
        torch.cuda.empty_cache()
        for k in counts:
            counts[k] += got.get(k, 0)
            bf16_counts[k] += got16.get(k, 0)
        steady = row["step_ms"][1:]
        out[family] = {
            **row, "batch_norm_layers_moved": moved,
            "step_ms_mean_after_first": sum(steady) / len(steady),
            "bf16_step_ms": ms, "bf16_metrics_last": metrics[-1]}
    return counts, bf16_counts, out


def hourglass_cli_path(ckpt_root):
    """`cli.train_hourglass_voc --variant stacked --multi_scale 256 320`
    (batch 16 in the trainer's microbatches of 2) and the sigmoid
    `HourglassNet` (batch 32), 2 steps each on the synthetic dataset
    (checkpoints under ``ckpt_root/hourglass_<run>``); one 8-image request
    from the stacked checkpoint on the kernels and on the plain
    versions."""
    from detectax_torch.cli import train_hourglass_voc

    stacked = ["--variant", "stacked", "--n_filters",
               str(HG_WIDTHS["stacked_hourglass"]), "--n_stacks",
               str(HG_STACKS)]
    runs = {
        "stacked_multi_scale": [*stacked, "--batch_size", "16",
                                "--multi_scale", *map(str, HG_BUCKETS)],
        "hourglass_sigmoid": ["--n_filters", str(HG_WIDTHS["hourglass"]),
                              "--batch_size", "32"],
    }
    out, counts = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, extra in runs.items():
            ckpt_dir = os.path.join(ckpt_root, "hourglass_" + name)
            kcommon.reset_launch_counts()
            summary = train_hourglass_voc.main([
                "--canvas", str(HG_CANVAS), "--max_steps", str(HG_CLI_STEPS),
                "--display_step", "1", "--step_save", str(HG_CLI_STEPS),
                "--synthetic_n", "64", "--ckpt_dir", ckpt_dir,
                "--out_dir", os.path.join(tmp, name + "_out"), *extra])
            counts[name] = kcommon.launch_counts()
            check(summary["final_step"] == HG_CLI_STEPS
                  and np.isfinite(summary["total"]),
                  f"hourglass CLI {name} trained {summary}")
            out[name] = {k: summary[k] for k in (
                "final_step", "images_per_sec", "total", "num_pos",
                "grad_norm")}
        chunks = 16 // HG_MICROBATCH
        want = HG_CLI_STEPS * chunks
        check(counts["stacked_multi_scale"] == {"focal_fwd": want,
                                                "focal_bwd": want},
              f"stacked CLI launched {counts['stacked_multi_scale']}, "
              f"expected one focal launch each way a microbatch = {want}")
        check(counts["hourglass_sigmoid"] == {},
              f"the sigmoid hourglass CLI launched "
              f"{counts['hourglass_sigmoid']}")
        nc = 3  # the synthetic dataset's classes
        model = StackedHourglass(num_classes=nc,
                                 n_filters=HG_WIDTHS["stacked_hourglass"],
                                 n_stacks=HG_STACKS).to(DEV)
        fresh = model.cnn_out.weight.clone()
        restore_for_inference(
            os.path.join(ckpt_root, "hourglass_stacked_multi_scale"), model)
        check(not torch.equal(fresh, model.cnn_out.weight),
              "restore left the model's weights as they were")
    decode = hourglass_decode_fn("stacked_hourglass", stride=4)
    preds = [Predictor.for_model(
        make_serving_fn(model, decode, score_thresh=0.0, kernels=k), model,
        canvas=HG_CANVAS, buckets=(8,), device=DEV) for k in (None, "plain")]
    images = np.random.default_rng(SEED + 61).uniform(
        -1, 1, size=(8, HG_CANVAS, HG_CANVAS, 3)).astype(np.float32)
    kcommon.reset_launch_counts()
    dets = preds[0].predict(images)
    counts["request"] = kcommon.launch_counts()
    check(counts["request"] == {"dense_nms": 1},
          f"stacked request launched {counts['request']}")
    name = "stacked hourglass request from the checkpoint"
    check(dets["boxes"].shape == (8, 100, 4)
          and (dets["num_valid"] > 0).all()
          and (dets["classes"][dets["valid"]] < nc).all(),
          f"{name}: wrong shapes, no or impossible detections")
    same_detections(name, dets, preds[1].predict(images))
    return counts, out


# a DetBench row's launches in 2 training steps: `StackedHourglass`'s
# focal class loss once a microbatch of 2 each way (batch 16);
# `HourglassNet`'s sigmoid class loss runs no kernel
ROW_TRAIN_LAUNCHES = {
    "stacked_hourglass": {"focal_fwd": HG_CLI_STEPS * 16 // HG_MICROBATCH,
                          "focal_bwd": HG_CLI_STEPS * 16 // HG_MICROBATCH},
    "hourglass": {},
}


def hourglass_detbench_row(bench: str, n_eval: int, argvs,
                           train_launches: dict):
    """2 steps of `cli.train_hourglass_voc` with a DetBench row's command
    line, launching ``train_launches``, then its `cli.evaluate` over the
    ``n_eval`` eval images on the kernels (the counted run: the dense
    kernel once a batch of 8, 6,400 candidates an image) and on the plain
    versions; every image's detections and the summaries must be equal.
    ``argvs(ckpt_dir, out_dir)`` gives the (train, evaluate) argv."""
    import contextlib
    import io

    from detectax_torch.cli import evaluate, train_hourglass_voc
    from detectax_torch.data.detbench import DetBenchDataset, load_spec
    from detectax_torch.eval.detection_metrics import (
        MeanAPEvaluator as evaluator_cls,
    )

    with tempfile.TemporaryDirectory() as tmp:
        ckpt_dir = os.path.join(tmp, "ckpt")
        train_argv, argv = argvs(ckpt_dir, os.path.join(tmp, "out"))
        family = argv[argv.index("--family") + 1]
        t0 = time.perf_counter()
        spec = load_spec(name=bench)
        DetBenchDataset("train", spec=spec)
        DetBenchDataset("eval", spec=spec)
        cache_s = time.perf_counter() - t0
        kcommon.reset_launch_counts()
        t1 = time.perf_counter()
        summary = train_hourglass_voc.main(train_argv)
        train_s = time.perf_counter() - t1
        train_counts = kcommon.launch_counts()
        check(summary["final_step"] == HG_CLI_STEPS
              and np.isfinite(summary["total"]),
              f"{bench} {family} training: {summary}")
        check(train_counts == train_launches,
              f"{bench} {family} training launched {train_counts}, "
              f"expected {train_launches}")
        quiet = io.StringIO()
        # two steps from random weights may match no box at all: beside the
        # summaries, every image's detections are compared
        seen = []
        add_image = evaluator_cls.add_image

        def recording(self, *a):
            seen[-1].append([np.asarray(v) for v in a[:3]])
            return add_image(self, *a)

        evaluator_cls.add_image = recording
        try:
            # ---- the counted run: counts set to 0 just before, read just
            # after
            seen.append([])
            kcommon.reset_launch_counts()
            t2 = time.perf_counter()
            with contextlib.redirect_stdout(quiet):
                got = evaluate.main(argv)
            eval_s = time.perf_counter() - t2
            counts = kcommon.launch_counts()
            # ----
            seen.append([])
            with contextlib.redirect_stdout(quiet):
                plain = evaluate.main(argv + ["--plain_kernels"])
        finally:
            evaluator_cls.add_image = add_image
        check(kcommon.launch_counts() == counts,
              "the plain-kernel evaluation launched a kernel")
    check(len(seen[0]) == len(seen[1]) == n_eval
          and all(len(a[0]) > 0 and all(np.array_equal(x, y)
                                        for x, y in zip(a, b))
                  for a, b in zip(*seen)),
          f"{bench} evaluation: the detections of the kernels and of the "
          f"plain versions differ")
    batches = -(-n_eval // 8)
    check(counts == {"dense_nms": batches},
          f"{bench} evaluation launched {counts}, expected {batches}")
    check(got["num_images"] == n_eval, f"evaluated {got['num_images']} images")
    check(got == plain, f"{bench} summaries differ: kernels {got}, "
                        f"plain versions {plain}")
    return train_counts, counts, {
        "cache_s": cache_s, "train_s": train_s,
        "train": {k: summary[k] for k in ("final_step", "images_per_sec",
                                          "total", "cls", "num_pos",
                                          "grad_norm")},
        "eval_s": eval_s, "eval_images_per_s": n_eval / eval_s,
        "summary": got, "summaries_equal": True,
        "detections_equal_image_by_image": True,
    }


CROWD_EVAL_IMAGES = 128   # the dense-crowd split's eval images (640 px)
CROWD_MAX_OUTPUTS = 200


def row_argvs(bench: str, family: str, ckpt_dir: str,
              out_dir: str) -> tuple[list, list]:
    """The (train, evaluate) argv of the DetBench row of ``family`` on
    ``bench``, as `run_detbench.family_commands` builds them (on
    v2_crowd: up to 128 boxes an image; at evaluation K = 2,048 of the
    6,400 candidates and 200 outputs), but for 2 steps, under ``ckpt_dir``
    and ``out_dir``, and with every score kept (``--cls_thresh 0.0``) so
    that NMS has work."""
    from detectax_torch.bench import run_detbench

    args = run_detbench.parse_args([
        "--bench", bench, "--run_root", out_dir,
        "--out", os.path.join(out_dir, "results.json")])
    run = {"--max_steps": str(HG_CLI_STEPS), "--display_step": "1",
           "--step_save": str(HG_CLI_STEPS), "--ckpt_dir": ckpt_dir,
           "--out_dir": out_dir,
           "--out_json": os.path.join(out_dir, "eval.json")}

    def with_run(cmd):
        argv = cmd[cmd.index("-m") + 2:]
        return [run.get(flag, a) for flag, a in zip([None, *argv], argv)]

    train, evaluate = run_detbench.family_commands(family, args)
    return with_run(train), with_run(evaluate) + ["--cls_thresh", "0.0"]


def hourglass_detbench_path():
    """The DetBench v2 `stacked_hourglass` row (`row_argvs`: batch 16 in
    the trainer's microbatches of 2): 2 steps, then the 256 eval images
    (`hourglass_detbench_row`)."""
    return hourglass_detbench_row(
        "detbench_v2", 256,
        functools.partial(row_argvs, "detbench_v2", "stacked_hourglass"),
        ROW_TRAIN_LAUNCHES["stacked_hourglass"])


def hourglass_crowd_path(family: str):
    """The DetBench v2_crowd row of ``family`` (`row_argvs`): 2 steps on
    the 2,048 training images of 640 px, then the 128 eval images through
    `dense_nms` rounds of 200 outputs (`hourglass_detbench_row`)."""
    return hourglass_detbench_row(
        "detbench_v2_crowd", CROWD_EVAL_IMAGES,
        functools.partial(row_argvs, "detbench_v2_crowd", family),
        ROW_TRAIN_LAUNCHES[family])


# --------------------------------------------------------------------------
# phase 12: exported serving bundles (cli.export_model, load_bundle)
# --------------------------------------------------------------------------

# bundle: (cli.export_model arguments, backbone, checkpoint under the kept
# root, canvas, the operators one chunk launches)
EXPORTS = {
    "fcos": (["--family", "fcos"], BACKBONE, "fcos", CANVAS,
             {"dense_nms": 1}),
    "fcos_candidates": (["--family", "fcos", "--class_aware_candidates"],
                        BACKBONE, "fcos", CANVAS, {"nms_sweep": 1}),
    "centernet_heatmap": (["--family", "centernet_heatmap"], BACKBONE,
                          "centernet_heatmap", CANVAS,
                          {"peak": 1, "dense_nms": 1}),
    "retinanet": (["--family", "retinanet"], RN_BACKBONE, "retinanet",
                  RN_CANVAS, {"dense_nms": 1}),
    "stacked_hourglass": (
        ["--family", "stacked_hourglass", "--n_filters",
         str(HG_WIDTHS["stacked_hourglass"]), "--n_stacks", str(HG_STACKS)],
        None, "hourglass_stacked_multi_scale", HG_CANVAS, {"dense_nms": 1}),
}
EXPORT_CLASSES = 3  # the synthetic dataset's, which the checkpoints have


def export_path(ckpt_root):
    """Each checkpoint of `EXPORTS` through `cli.export_model` (buckets 1
    and 8, no score threshold: the few training steps leave every score
    near the focal prior; its own verification must pass), then the
    bundle through `load_bundle` over the request mix: the replay is
    counted (one launch of each operator a chunk), its detections equal
    those of the live `Predictor` on the kernels and of the live path on
    the plain versions (classes, valid and num_valid exactly, boxes and
    scores to 1e-5), and every program holds no parameter and no buffer.
    Times: each bucket's export (manifest), the load, and each request
    replayed and live (host clock; the faster of two passes, in turns)."""
    from types import SimpleNamespace

    from detectax_torch.cli import evaluate, export_model
    from detectax_torch.infer.export import (
        PROGRAM_NAME,
        WEIGHTS_NAME,
        load_bundle,
    )

    family_args = SimpleNamespace(
        center=False, box_scales=list(S8_SCALES), anchor_sizes=list(RN_SIZES),
        n_filters=HG_WIDTHS["stacked_hourglass"], n_stacks=HG_STACKS,
        per_anchor_heads=False)
    rng = np.random.default_rng(SEED + 70)
    out, counts = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, (cli_args, backbone, ckpt, canvas, per_chunk) in \
                EXPORTS.items():
            family = cli_args[1]
            bundle = os.path.join(tmp, name)
            t0 = time.perf_counter()
            res = export_model.main([
                *cli_args, *(["--backbone", backbone] if backbone else []),
                "--ckpt_dir", os.path.join(ckpt_root, ckpt),
                "--num_classes", str(EXPORT_CLASSES),
                "--canvas", str(canvas), "--out_dir", bundle,
                "--buckets", *map(str, BUCKETS), "--cls_thresh", "0.0"])
            cli_s = time.perf_counter() - t0
            manifest = res["manifest"]
            candidates = "--class_aware_candidates" in cli_args
            check(manifest["device"] == str(DEV)
                  and manifest["fused"] is not candidates,
                  f"{name} bundle: device {manifest['device']}, fused "
                  f"{manifest['fused']}")
            pt2 = {}
            for b in manifest["buckets"]:
                path = os.path.join(bundle, PROGRAM_NAME.format(b))
                sig = torch.export.load(path).graph_signature
                check(not sig.parameters and not sig.buffers,
                      f"{name} bucket {b}: the program holds "
                      f"{len(sig.parameters)} parameters and "
                      f"{len(sig.buffers)} buffers")
                pt2[str(b)] = os.path.getsize(path)
            t0 = time.perf_counter()
            replay = load_bundle(bundle, device=DEV)
            load_s = time.perf_counter() - t0

            model, decode = evaluate.build_family(
                family, EXPORT_CLASSES, backbone, canvas, family_args)
            model = restore_for_inference(os.path.join(ckpt_root, ckpt),
                                          model.to(DEV))
            plain_decode = (centernet_decode_fn(family, kernels="plain")
                            if family == "centernet_heatmap" else decode)
            nms = dict(score_thresh=0.0, class_aware_candidates=candidates)
            live = Predictor.for_model(
                make_serving_fn(model, decode, fused=manifest["fused"],
                                **nms),
                model, canvas=canvas, buckets=BUCKETS, device=DEV)
            plain = Predictor.for_model(
                make_serving_fn(model, plain_decode, kernels="plain", **nms),
                model, canvas=canvas, buckets=BUCKETS, device=DEV)
            requests = [rng.uniform(-1, 1, size=(n, canvas, canvas, 3))
                        .astype(np.float32) for n in REQUESTS]
            replay.warmup()
            live.warmup()
            kcommon.reset_launch_counts()
            replayed, replay_s = serve(replay, requests)
            counts[name] = kcommon.launch_counts()
            chunks = sum(len(replay._plan(n)) for n in REQUESTS)
            want = {k: v * chunks for k, v in per_chunk.items()}
            check(counts[name] == want,
                  f"{name} replay launched {counts[name]}, expected {want}")
            lived, live_s = serve(live, requests)
            plained, _ = serve(plain, requests)
            replay_s = np.minimum(replay_s, serve(replay, requests)[1])
            live_s = np.minimum(live_s, serve(live, requests)[1])
            for n, got, want_live, want_plain in zip(REQUESTS, replayed,
                                                     lived, plained):
                check(got["boxes"].shape == (n, 100, 4)
                      and np.isfinite(got["boxes"]).all()
                      and np.isfinite(got["scores"]).all()
                      and (got["num_valid"] > 0).all()
                      and (got["classes"][got["valid"]]
                           < EXPORT_CLASSES).all(),
                      f"{name} replay of {n} images: wrong shapes, "
                      "non-finite, no or impossible detections")
                same_detections(f"{name} replay vs live kernels, {n} images",
                                got, want_live)
                same_detections(f"{name} replay vs plain versions, {n} "
                                "images", got, want_plain)
            images = sum(REQUESTS)
            out[name] = {
                "canvas": canvas, "cli_s": cli_s,
                "export_s_by_bucket": manifest["export_seconds"],
                "verify_max_abs_diff": res["verify_max_abs_diff"],
                "pt2_bytes_by_bucket": pt2,
                "weights_npz_bytes": os.path.getsize(
                    os.path.join(bundle, WEIGHTS_NAME)),
                "load_s": load_s,
                "replay_request_ms": [1e3 * t for t in replay_s],
                "live_request_ms": [1e3 * t for t in live_s],
                "replay_images_per_s": images / float(np.sum(replay_s)),
                "live_images_per_s": images / float(np.sum(live_s)),
                "launches": counts[name],
            }
            log(f"exported {name}: " + json.dumps(out[name]))
            del replay, live, plain, model
            torch.cuda.empty_cache()
    return counts, out


# --------------------------------------------------------------------------
# phase 13: data parallelism (torchrun over NCCL; two gloo ranks, one card)
# --------------------------------------------------------------------------

REPO = os.path.dirname(os.path.abspath(__file__))
DP_STEPS = TRAIN_STEPS
NCCL_RTOL = 1e-6   # one rank over NCCL against the same process alone
TORCHRUN = (sys.executable, "-m", "torch.distributed.run", "--standalone",
            "--nproc_per_node", "1")


def run_processes(cmds, timeout: float) -> list[str]:
    """Run ``cmds`` at once from the checkout, each in a session of its
    own with its output in a file; kill every session (torchrun and its
    workers) still running at ``timeout``. Returns their outputs; fails
    the run on a non-zero exit."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (REPO, os.environ.get("PYTHONPATH")) if p))
    files = [tempfile.TemporaryFile("w+") for _ in cmds]
    procs = [subprocess.Popen(cmd, cwd=REPO, env=env, text=True, stdout=f,
                              stderr=subprocess.STDOUT,
                              start_new_session=True)
             for cmd, f in zip(cmds, files)]
    deadline = time.monotonic() + timeout
    late = []
    for cmd, proc in zip(cmds, procs):
        try:
            proc.wait(timeout=max(0.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, 9)
            proc.wait()
            late.append(cmd)
    outs = []
    for f in files:
        f.seek(0)
        outs.append(f.read())
        f.close()
    for cmd, proc, out in zip(cmds, procs, outs):
        check(cmd not in late,
              f"{' '.join(cmd[:8])} ran past {timeout} s:\n{out[-4000:]}")
        check(proc.returncode == 0,
              f"{' '.join(cmd[:8])} exited {proc.returncode}:\n"
              f"{out[-6000:]}")
    return outs


def run_process(cmd, timeout: float) -> str:
    """`run_processes` of one command."""
    return run_processes([cmd], timeout)[0]


def step_one(out_dir: str) -> dict:
    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        return json.loads(f.readline())


def fsdp_summary(job: dict, dp_job: dict, reference: list) -> dict:
    """An FSDP job's numbers beside the data-parallel job's of the same
    group: step ms, collectives a step, the bytes of parameters and
    optimizer state a rank holds after the steps, the peak of allocated
    memory, and step 1's relative difference from ``reference[0]``."""
    return {
        "step_ms": job["step_ms"], "data_parallel_step_ms": dp_job["step_ms"],
        "collectives_per_step": job["collectives_per_step"],
        "data_parallel_collectives_per_step":
            dp_job["collectives_per_step"],
        "sharded_leaves": job["sharded_leaves"], "leaves": job["leaves"],
        "state_bytes": job["state_bytes"],
        "data_parallel_state_bytes": dp_job["state_bytes"],
        "peak_allocated_bytes": job["peak_allocated_bytes"],
        "data_parallel_peak_allocated_bytes":
            dp_job["peak_allocated_bytes"],
        "step_1_rel": {k: abs(job["metrics"][0][k] - reference[0][k])
                       / abs(reference[0][k])
                       for k in ("total", "cls", "grad_norm")}}


def same_state(a: dict, b: dict) -> bool:
    """Two `TrainState.state_dict`s equal bit for bit (step, parameters
    and buffers, optimizer state, EMA)."""
    def flat(sd):
        out = {("step",): sd["step"]}
        out.update({("model", k): v for k, v in sd["model"].items()})
        out.update({("opt", i, k): v for i, per in sd["opt"]["state"].items()
                    for k, v in per.items()})
        out.update({("ema", k): v for k, v in (sd["ema"] or {}).items()})
        return out

    fa, fb = flat(a), flat(b)
    return fa.keys() == fb.keys() and all(
        torch.equal(fa[k].cpu(), fb[k].cpu())
        if isinstance(fa[k], torch.Tensor) else fa[k] == fb[k] for k in fa)


def restore_fsdp_checkpoint(ckpt_dir: str) -> dict:
    """The state dict of a fresh FCOS training state (as the ranks build
    it) after `CheckpointManager.restore_latest` from ``ckpt_dir``, in
    this process, which has no group."""
    from detectax_torch.train.checkpoint import CheckpointManager

    check(not torch.distributed.is_initialized(), "this process has a group")
    model = FCOS(num_classes=NUM_CLASSES, backbone=BACKBONE).to(DEV)
    state = create_train_state(model, None, make_optimizer(
        "sgd", exponential_with_floor(5e-4), grad_clip=1.0))
    restored = CheckpointManager(ckpt_dir).restore_latest(state)
    check(restored is not None and restored[1] == DP_STEPS,
          f"FSDP checkpoint under {ckpt_dir}: {restored and restored[1]}")
    sd = state.state_dict()
    out = {"step": sd["step"],
           "model": {k: v.cpu() for k, v in sd["model"].items()},
           "opt": {"state": {i: {k: v.cpu() for k, v in per.items()}
                             for i, per in sd["opt"]["state"].items()}},
           "ema": sd["ema"]}
    del state, model
    torch.cuda.empty_cache()
    return out


def parallel_path(ckpt_root, training) -> tuple[dict, dict]:
    """(1) `torchrun --nproc_per_node 1 -m detectax_torch.cli.train_fcos`
    (NCCL) against the same CLI in this process, step 1 to `NCCL_RTOL`;
    (2) under torchrun, the FCOS step with a group of one (NCCL) against
    the step without one in the same process, fp32 and bf16, with the
    collectives a step and the time of an all-reduce; (3) two gloo ranks
    sharing the card (NCCL refuses two ranks on one card) against
    `train_path`'s one process on the same global batches, `PATHS_RTOL`,
    after both ranks built the kernels at once from an empty build; (4)
    `cli.evaluate --data_parallel` at batch 8 on the two ranks against
    `cli.evaluate` here at a rank's batch, 4, detection for detection,
    exactly: each image's forward then has the shape it has on a rank
    (cuDNN picks its algorithm by the shape, and with random weights a
    last-bit change of a score reorders near-ties in NMS). Logs each part
    as it ends; returns the launches of the counted runs and the
    numbers."""
    from detectax_torch.cli import evaluate as cli_evaluate
    from detectax_torch.cli import train_fcos
    from detectax_torch.tools import two_process_cpu_test as ranks

    out: dict = {}
    counts: dict = {}
    with tempfile.TemporaryDirectory() as tmp:
        # (1) the trainer CLI under torchrun, then without a group
        argv = ["--backbone", BACKBONE, "--canvas", str(CANVAS),
                "--batch_size", str(TRAIN_BATCH), "--max_steps",
                str(DP_STEPS), "--display_step", "1", "--step_save",
                str(DP_STEPS), "--synthetic_n", "64"]
        runs = {}
        t0 = time.perf_counter()
        run_process([*TORCHRUN, "-m", "detectax_torch.cli.train_fcos", *argv,
                     "--ckpt_dir", os.path.join(tmp, "ckpt_nccl"),
                     "--out_dir", os.path.join(tmp, "out_nccl")], 300)
        runs["torchrun_s"] = time.perf_counter() - t0
        summary = train_fcos.main(argv + [
            "--ckpt_dir", os.path.join(tmp, "ckpt_alone"),
            "--out_dir", os.path.join(tmp, "out_alone")])
        runs["alone_images_per_s"] = summary["images_per_sec"]
        nccl, alone = (step_one(os.path.join(tmp, d))
                       for d in ("out_nccl", "out_alone"))
        for key in ("total", "cls", "grad_norm"):
            runs[f"{key}_rel"] = abs(nccl[key] - alone[key]) / abs(alone[key])
            check(close(nccl[key], alone[key], NCCL_RTOL),
                  f"torchrun cli.train_fcos step 1 {key} {nccl[key]}, "
                  f"without a group {alone[key]} (rtol {NCCL_RTOL})")
        out["cli_torchrun_nproc_1"] = runs
        log("parallel_cli " + json.dumps(runs))

        batches = os.path.join(tmp, "batches.npz")
        np.savez(batches, **{f"{k}_{i}": v for i in range(DP_STEPS)
                             for k, v in train_batch(SEED + 10 + i).items()})
        train = {"kind": "train", "batches": batches, "lr": 5e-4,
                 "grad_clip": 1.0, "model": {
                     "backbone": BACKBONE, "num_classes": NUM_CLASSES,
                     "canvas": CANVAS, "seed": SEED}}

        # (2) the step with a group of one (NCCL) and without, one process
        work = os.path.join(tmp, "nccl")
        ranks.write_jobs([
            dict(train, name="fp32", alone=True, time_all_reduce=True),
            dict(train, name="bf16", alone=True,
                 model=dict(train["model"], dtype="bfloat16")),
            dict(train, name="fsdp", fsdp=True)], work)
        t0 = time.perf_counter()
        run_process([*TORCHRUN, "-m", "detectax_torch.tools."
                     "two_process_cpu_test", work], 400)
        with open(os.path.join(work, "rank0.json")) as f:
            res = json.load(f)
        check(res["world_size"] == 1, f"torchrun gave {res['world_size']}")
        nccl = {"phase_s": time.perf_counter() - t0}
        fsdp_job = res["jobs"].pop("fsdp")
        for name, job in res["jobs"].items():
            check(job["backend"] == "nccl", f"{name}: {job['backend']}")
            got, want = job["metrics"][0], job["alone"]["metrics"][0]
            for key in ("total", "cls", "grad_norm"):
                check(close(got[key], want[key], NCCL_RTOL),
                      f"NCCL {name} step 1 {key} {got[key]}, without a "
                      f"group {want[key]} (rtol {NCCL_RTOL})")
            check(job["launches"].get("focal_fwd") == DP_STEPS
                  and job["launches"].get("focal_bwd") == DP_STEPS,
                  f"NCCL {name} launched {job['launches']}")
            counts[f"nccl_{name}"] = job["launches"]
            nccl[name] = {
                "step_ms": job["step_ms"],
                "alone_step_ms": job["alone"]["step_ms"],
                "collectives_per_step": job["collectives_per_step"],
                "metrics_step_1": got}
            nccl[name].update({k: job[k] for k in ("allreduce_ms",)
                               if k in job})
        fp32 = nccl["fp32"]["metrics_step_1"]
        for key in ("total", "cls", "grad_norm"):
            check(close(fp32[key], training["metrics_step_1"][key],
                        PATHS_RTOL),
                  f"NCCL step 1 {key} {fp32[key]}, train_path's "
                  f"{training['metrics_step_1'][key]}")
        # FSDP over one NCCL rank: every leaf of 2**16 elements or more is
        # "sharded" over the one rank, through NCCL's all-gather and
        # reduce-scatter, against the data-parallel step of the same group
        dp_fp32 = res["jobs"]["fp32"]
        got = fsdp_job["metrics"][0]
        for key in ("total", "cls", "grad_norm"):
            check(close(got[key], fp32[key], NCCL_RTOL),
                  f"NCCL FSDP step 1 {key} {got[key]}, the data-parallel "
                  f"step's {fp32[key]} (rtol {NCCL_RTOL})")
        check(fsdp_job["backend"] == "nccl" and fsdp_job["sharded_leaves"]
              > 0, f"NCCL FSDP: {fsdp_job['backend']}, "
              f"{fsdp_job.get('sharded_leaves')} sharded leaves")
        check(fsdp_job["launches"].get("focal_fwd") == DP_STEPS
              and fsdp_job["launches"].get("focal_bwd") == DP_STEPS,
              f"NCCL FSDP launched {fsdp_job['launches']}")
        counts["nccl_fsdp"] = fsdp_job["launches"]
        nccl["fsdp"] = fsdp_summary(fsdp_job, dp_fp32, [fp32])
        out["torchrun_nproc_1_nccl"] = nccl
        log("parallel_nccl " + json.dumps(nccl))

        # (3) + (4): two gloo ranks on the card, which build the kernels
        # at once from an empty build
        lib = os.path.join(kcommon.BUILD_DIR, kcommon.LIB_NAME)
        if os.path.exists(lib):
            os.remove(lib)  # this process keeps the copy it loaded
        torch.cuda.empty_cache()
        work = os.path.join(tmp, "gloo")
        evaluate = ["--family", "fcos", "--dataset", "synthetic",
                    "--synthetic_n", "16", "--backbone", BACKBONE,
                    "--canvas", str(CANVAS), "--cls_thresh", "0.0",
                    "--ckpt_dir", os.path.join(ckpt_root, "fcos")]
        t0 = time.perf_counter()
        fsdp_ckpt = os.path.join(tmp, "ckpt_fsdp")
        res = ranks.launch(
            [dict(train, name="train", time_all_reduce=True),
             dict(train, name="fsdp", fsdp=True, save_state="full",
                  checkpoint=fsdp_ckpt, time_all_reduce=True),
             {"kind": "evaluate", "name": "evaluate",
              "argv": evaluate + ["--batch_size", "8", "--device",
                                  "cuda:0", "--data_parallel"]}],
            2, work, device="cuda:0", backend="gloo", timeout=600)
        gloo = {"phase_s": time.perf_counter() - t0,
                "built_s_by_rank": [r["built_s"] for r in res]}
        check(all(r["built_s"] is not None for r in res)
              or os.path.exists(lib), "the ranks left no library built")
        train_res = [r["jobs"]["train"] for r in res]
        for rank, job in enumerate(train_res):
            check(job["backend"] == "gloo" and job["device"] == "cuda:0",
                  f"rank {rank}: {job['backend']} on {job['device']}")
            check(job["launches"].get("focal_fwd") == DP_STEPS
                  and job["launches"].get("focal_bwd") == DP_STEPS,
                  f"gloo rank {rank} launched {job['launches']}, expected "
                  f"{DP_STEPS} and {DP_STEPS}")
            check(job["metrics"] == train_res[0]["metrics"],
                  f"rank {rank}'s metrics differ from rank 0's")
        got = train_res[0]["metrics"]
        rel = {}
        for key in ("total", "cls", "grad_norm"):
            a, b = got[0][key], training["metrics_step_1"][key]
            rel[key] = abs(a - b) / abs(b)
            check(close(a, b, PATHS_RTOL),
                  f"two gloo ranks step 1 {key} {a}, one process {b} "
                  f"(tolerance rtol {PATHS_RTOL})")
        last = {k: abs(got[-1][k] - training["metrics_last"][k])
                / abs(training["metrics_last"][k])
                for k in ("total", "cls", "grad_norm")}
        counts["gloo_train"] = [j["launches"] for j in train_res]
        gloo["train"] = {
            "global_batch": TRAIN_BATCH, "rows_a_rank": TRAIN_BATCH // 2,
            "step_ms_by_rank": [j["step_ms"] for j in train_res],
            "one_process_step_ms": training["step_ms"],
            "collectives_per_step": train_res[0]["collectives_per_step"],
            "allreduce_ms": train_res[0]["allreduce_ms"],
            "step_1_rel_to_one_process": rel,
            f"step_{DP_STEPS}_rel_to_one_process": last}
        log("parallel_gloo_train " + json.dumps(gloo))

        # FSDP on the two gloo ranks: step 1 against the one process of
        # train_path, the ranks' gathered states bitwise equal, and the
        # checkpoint (every rank saved, rank 0 wrote) restored here, in a
        # process without a group
        fsdp_res = [r["jobs"]["fsdp"] for r in res]
        for rank, job in enumerate(fsdp_res):
            check(job["backend"] == "gloo" and job["sharded_leaves"] > 0,
                  f"FSDP rank {rank}: {job['backend']}, "
                  f"{job.get('sharded_leaves')} sharded leaves")
            check(job["launches"].get("focal_fwd") == DP_STEPS
                  and job["launches"].get("focal_bwd") == DP_STEPS,
                  f"FSDP gloo rank {rank} launched {job['launches']}")
            check(job["metrics"] == fsdp_res[0]["metrics"],
                  f"FSDP rank {rank}'s metrics differ from rank 0's")
        counts["gloo_fsdp"] = [j["launches"] for j in fsdp_res]
        got = fsdp_res[0]["metrics"]
        for key in ("total", "cls", "grad_norm"):
            a, b = got[0][key], training["metrics_step_1"][key]
            check(close(a, b, PATHS_RTOL),
                  f"two FSDP gloo ranks step 1 {key} {a}, one process {b} "
                  f"(tolerance rtol {PATHS_RTOL})")
        held = [torch.load(os.path.join(work, f"fsdp_rank{r}.pt"),
                           map_location="cpu", weights_only=True)
                for r in range(2)]
        check(same_state(held[0], held[1]),
              "the FSDP ranks' gathered states differ in their bits")
        check(same_state(restore_fsdp_checkpoint(fsdp_ckpt), held[0]),
              "the FSDP checkpoint restored without a group differs from "
              "the ranks' gathered state")
        gloo["fsdp"] = fsdp_summary(fsdp_res[0], train_res[0],
                                    [training["metrics_step_1"]])
        gloo["fsdp"]["step_ms_by_rank"] = [j["step_ms"] for j in fsdp_res]
        gloo["fsdp"]["collective_ms"] = dict(
            fsdp_res[0]["fsdp_collective_ms"],
            all_reduce_of_the_gradient=fsdp_res[0]["allreduce_ms"][
                "gradient"])
        gloo["fsdp"]["ranks_bitwise_equal"] = True
        gloo["fsdp"]["checkpoint_restored_without_a_group"] = True
        log("parallel_gloo_fsdp " + json.dumps(gloo["fsdp"]))

        eval_res = [r["jobs"]["evaluate"] for r in res]
        t0 = time.perf_counter()
        with ranks.record_detections() as seen:
            want = cli_evaluate.main(evaluate + ["--batch_size", "4",
                                                 "--device", str(DEV)])
        alone_s = time.perf_counter() - t0
        check(eval_res[0]["summary"] == json.loads(json.dumps(want))
              and eval_res[1]["summary"] is None,
              f"--data_parallel summary {eval_res[0]['summary']}, one "
              f"process {want}")
        dets = np.load(os.path.join(work, "evaluate_dets.npz"))
        check(len(seen) == 16 and eval_res[0]["images"] == 16,
              f"evaluated {len(seen)} / {eval_res[0]['images']} images")
        for i, d in enumerate(seen):
            for k, v in d.items():
                check(np.array_equal(dets[f"{k}_{i}"], v),
                      f"--data_parallel image {i}: {k} differ from one "
                      "process's")
        counts["gloo_evaluate"] = [j["launches"] for j in eval_res]
        for rank, c in enumerate(counts["gloo_evaluate"]):
            check(c.get("dense_nms", 0) == 2,
                  f"evaluate rank {rank} launched {c}: expected dense_nms "
                  "once for each of its 2 batches")
        gloo["evaluate"] = {
            "images": 16, "batch": 8, "data_parallel_s_by_rank": [
                j["wall_s"] for j in eval_res],
            "one_process_batch": 4, "one_process_s": alone_s,
            "detections": sum(len(d["scores"]) for d in seen),
            "detections_equal": True}
        out["gloo_two_ranks_one_card"] = gloo
        log("parallel_gloo_evaluate " + json.dumps(gloo["evaluate"]))
    return counts, out


# --------------------------------------------------------------------------
# phase 14: ingestion — raw VOC-layout JPEGs to a trained checkpoint
# --------------------------------------------------------------------------

INGEST_IMAGES = 64
VOC_SIZES = ((375, 500), (500, 375))   # (h, w): VOC's two common shapes
VOC_QUALITY = 90
LOADER_BATCHES = 8
# the mean |native - PIL| pixel bound of tests/test_native_loader.py
# (pixels normalized to [-1, 1]; PIL's resize antialiases, libjpeg's
# bilinear does not)
NATIVE_PIL_MEAN_DIFF = 0.2
INGEST_STEPS = 4
RESNEXT_RTOL = 1e-4   # of the tap's largest magnitude, TF32 off


def write_voc_tree(root: str, n: int, seed: int) -> tuple[str, str, int]:
    """``n`` seeded JPEGs at VOC's sizes (quality 90), each drawn with
    filled boxes, and one ``Annotations/*.xml`` each with 1-6 objects over
    VOC's 20 classes. Returns (annotations dir, images dir, objects)."""
    from PIL import Image

    from detectax_torch.data.convert_voc import VOC_CLASSES

    ann = os.path.join(root, "Annotations")
    img_dir = os.path.join(root, "JPEGImages")
    os.makedirs(ann)
    os.makedirs(img_dir)
    rng = np.random.default_rng(seed)
    n_objects = 0
    for i in range(n):
        h, w = VOC_SIZES[int(rng.integers(len(VOC_SIZES)))]
        coarse = rng.uniform(0, 255, size=(h // 25 + 1, w // 25 + 1, 3))
        img = np.asarray(Image.fromarray(coarse.astype(np.uint8)).resize(
            (w, h), Image.BILINEAR), np.float32)
        img += rng.normal(0, 12, size=img.shape)
        objects = []
        for _ in range(int(rng.integers(1, 7))):
            bw = int(rng.integers(w // 10, w // 2))
            bh = int(rng.integers(h // 10, h // 2))
            x1 = int(rng.integers(1, w - bw))
            y1 = int(rng.integers(1, h - bh))
            cls = int(rng.integers(len(VOC_CLASSES)))
            img[y1:y1 + bh, x1:x1 + bw] = 255.0 * np.asarray(
                [(cls * 37) % 256, (cls * 91) % 256, (cls * 53) % 256]
            ) / 255.0
            objects.append(
                f"  <object><name>{VOC_CLASSES[cls]}</name>"
                f"<difficult>0</difficult><bndbox><xmin>{x1}</xmin>"
                f"<ymin>{y1}</ymin><xmax>{x1 + bw}</xmax>"
                f"<ymax>{y1 + bh}</ymax></bndbox></object>")
        name = f"2026_{i:06d}"
        Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(
            os.path.join(img_dir, name + ".jpg"), quality=VOC_QUALITY)
        with open(os.path.join(ann, name + ".xml"), "w") as f:
            f.write(f"<annotation><folder>VOC2026</folder>"
                    f"<filename>{name}.jpg</filename><size><width>{w}"
                    f"</width><height>{h}</height><depth>3</depth></size>\n"
                    + "\n".join(objects) + "\n</annotation>\n")
        n_objects += len(objects)
    return ann, img_dir, n_objects


def probe_libjpeg() -> dict:
    """Whether this host's compiler finds ``jpeglib.h`` and ``-ljpeg``, and
    its version line (the native loader's build needs all three); and the
    libjpeg that Pillow's wheel carries, if any (a library without its
    header)."""
    import glob

    import PIL

    pillow_libs = os.path.join(os.path.dirname(os.path.dirname(
        PIL.__file__)), "pillow.libs")
    out = {"gxx": None, "jpeglib_h": False, "ljpeg": False,
           "pillow_libjpeg": sorted(os.path.basename(p) for p in glob.glob(
               os.path.join(pillow_libs, "libjpeg*")))}
    cxx = os.environ.get("CXX", "g++")
    try:
        out["gxx"] = subprocess.run(
            [cxx, "--version"], capture_output=True, text=True,
            timeout=60).stdout.splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError) as e:
        out["gxx"] = f"{cxx} did not run: {e}"
        return out
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "probe.cpp")
        with open(src, "w") as f:
            f.write("#include <cstdio>\n#include <jpeglib.h>\n"
                    "int main() { jpeg_decompress_struct c; "
                    "c.err = jpeg_std_error(nullptr); return 0; }\n")
        out["jpeglib_h"] = subprocess.run(
            [cxx, "-fsyntax-only", src], capture_output=True,
            timeout=60).returncode == 0
        empty = os.path.join(tmp, "empty.cpp")
        with open(empty, "w") as f:
            f.write("int main() { return 0; }\n")
        out["ljpeg"] = subprocess.run(
            [cxx, empty, "-o", os.path.join(tmp, "a.out"), "-ljpeg"],
            capture_output=True, timeout=60).returncode == 0
    return out


def time_loader(loader, batches: int) -> tuple[list, float]:
    """The first ``batches`` batches of ``loader`` and its images/s on the
    host clock, from the iterator's start to the last batch."""
    got = []
    t0 = time.perf_counter()
    for batch in loader:
        got.append(batch)
        if len(got) == batches:
            break
    wall = time.perf_counter() - t0
    return got, batches * loader.batch_size / wall


class TorchvisionBottleneck(torch.nn.Module):
    """torchvision's ResNeXt 32x4d bottleneck, with its state-dict keys."""

    def __init__(self, inplanes, planes, stride=1, project=False):
        super().__init__()
        nn = torch.nn
        width = planes * 2
        self.conv1 = nn.Conv2d(inplanes, width, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(width)
        self.conv2 = nn.Conv2d(width, width, 3, stride, padding=1,
                               groups=32, bias=False)
        self.bn2 = nn.BatchNorm2d(width)
        self.conv3 = nn.Conv2d(width, planes * 4, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(planes * 4)
        self.relu = nn.ReLU()
        self.downsample = None
        if project:
            self.downsample = nn.Sequential(
                nn.Conv2d(inplanes, planes * 4, 1, stride, bias=False),
                nn.BatchNorm2d(planes * 4))

    def forward(self, x):
        idt = self.downsample(x) if self.downsample is not None else x
        h = self.relu(self.bn1(self.conv1(x)))
        h = self.relu(self.bn2(self.conv2(h)))
        return self.relu(self.bn3(self.conv3(h)) + idt)


class TorchvisionResNeXt50(torch.nn.Module):
    """torchvision's ``resnext50_32x4d`` trunk (C3, C4, C5), built inline:
    the card's host has no torchvision and no download."""

    def __init__(self):
        super().__init__()
        nn = torch.nn
        self.conv1 = nn.Conv2d(3, 64, 7, 2, padding=3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        self.relu = nn.ReLU()
        self.maxpool = nn.MaxPool2d(3, 2, padding=1)
        inplanes = 64
        for li, (planes, n) in enumerate(zip((64, 128, 256, 512),
                                             (3, 4, 6, 3))):
            blocks = []
            for b in range(n):
                blocks.append(TorchvisionBottleneck(
                    inplanes, planes, 2 if (b == 0 and li > 0) else 1,
                    project=(b == 0)))
                inplanes = planes * 4
            setattr(self, f"layer{li + 1}", nn.Sequential(*blocks))

    def forward(self, x):
        h = self.layer1(self.maxpool(self.relu(self.bn1(self.conv1(x)))))
        c3 = self.layer2(h)
        c4 = self.layer3(c3)
        return c3, c4, self.layer4(c4)


def resnext_import_check(tmp: str) -> dict:
    """A seeded torchvision-layout ResNeXt-50 on the card, ported with
    `port_torch_resnext` through the ``.npz`` into the port's
    ``resnext50:torch`` trunk on the card: C3/C4/C5 to `RESNEXT_RTOL`."""
    from detectax_torch.models.backbones import build_backbone
    from detectax_torch.tools import from_flax as FF
    from detectax_torch.tools import port_tf_weights as PW

    torch.manual_seed(SEED)
    ref = TorchvisionResNeXt50()
    with torch.no_grad():
        for m in ref.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.weight.uniform_(0.5, 1.5)
                m.bias.normal_(0, 0.1)
                m.running_mean.normal_(0, 0.5)
                m.running_var.uniform_(0.5, 2.0)
    ref = ref.to(DEV).eval()
    path = os.path.join(tmp, "resnext50.npz")
    t0 = time.perf_counter()
    PW.save_ported(PW.port_torch_resnext(ref.state_dict(), "resnext50"),
                   path)
    trunk = build_backbone("resnext50:torch")
    FF.load_flax(trunk, *FF.load_npz(path))
    port_s = time.perf_counter() - t0
    trunk = trunk.to(DEV).eval()
    x = cuda(np.random.default_rng(SEED + 21).normal(
        size=(2, 3, CANVAS, CANVAS)).astype(np.float32))
    with torch.no_grad():
        want = ref(x)
        got = trunk(x)
    rel = {}
    for tap, w in zip(("c3", "c4", "c5"), want):
        g = got[tap]
        check(g.shape == w.shape, f"ResNeXt {tap}: {g.shape} vs {w.shape}")
        rel[tap] = float((g - w).abs().max() / w.abs().max())
        check(rel[tap] <= RESNEXT_RTOL,
              f"ported ResNeXt-50 {tap} differs by {rel[tap]} of its "
              f"largest magnitude (limit {RESNEXT_RTOL})")
    return {"input": [2, 3, CANVAS, CANVAS], "npz_bytes":
            os.path.getsize(path), "port_and_load_s": port_s,
            "max_rel_err": rel, "rtol": RESNEXT_RTOL}


def ingestion_path() -> tuple[dict, dict]:
    """Raw VOC-layout JPEGs → `cli.convert_voc` → the native loader (against
    the PIL path at the main config) → `cli.train_fcos --index` for 4 steps
    at 384 px, batch 16 → `cli.evaluate --index` from its checkpoint on the
    kernels and on the plain versions (detections equal) → a ResNeXt-50
    weight import on the card. Returns (launch counts of the counted
    training and evaluation runs, the phase's numbers)."""
    import contextlib
    import io

    from detectax_torch.cli import convert_voc, evaluate, train_fcos
    from detectax_torch.data import native_loader as NL
    from detectax_torch.data.index import IndexDataset, load_index
    from detectax_torch.data.pipeline import Loader
    from detectax_torch.infer import predict as P

    t_phase = time.perf_counter()
    out = {}
    counts = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        ann, img_dir, n_objects = write_voc_tree(
            os.path.join(tmp, "voc"), INGEST_IMAGES, SEED + 20)
        index = os.path.join(tmp, "voc.json")
        quiet = io.StringIO()
        with contextlib.redirect_stdout(quiet):
            convert_voc.main(["--annotations_dir", ann, "--images_dir",
                              img_dir, "--output", index])
        classes, samples = load_index(index)
        check(len(samples) == INGEST_IMAGES and len(classes) == NUM_CLASSES,
              f"index: {len(samples)} samples, {len(classes)} classes")
        check(sum(len(s["labels"]) for s in samples) == n_objects,
              f"index holds {sum(len(s['labels']) for s in samples)} "
              f"objects, {n_objects} were written")
        out["dataset"] = {"images": INGEST_IMAGES, "objects": n_objects,
                          "sizes_hw": VOC_SIZES, "quality": VOC_QUALITY,
                          "write_and_convert_s": time.perf_counter() - t0}

        # ---- the native library: build, and why not where it does not
        probe = probe_libjpeg()
        native = NL.available()
        build = {"built": native, "build_s": NL.build_seconds(),
                 "library": NL.library_path(), **probe}
        log("native_loader_build " + json.dumps(build))
        if not native:
            if not (probe["jpeglib_h"] and probe["ljpeg"]):
                log("native loader: libjpeg is missing on this host "
                    f"(jpeglib.h found: {probe['jpeglib_h']}, -ljpeg found: "
                    f"{probe['ljpeg']}); the native steps are skipped and "
                    "the loaders run native=False")
            else:
                fail(f"the native loader did not build: "
                     f"{NL.unavailable_reason()}")
        out["native_build"] = build

        # ---- the loaders at the main config, native against PIL
        dataset = IndexDataset(index)
        config = dict(batch_size=TRAIN_BATCH, canvas=CANVAS, seed=SEED,
                      steps=LOADER_BATCHES)
        loaders = {}
        for mode in ((True, False) if native else (False,)):
            got, rate = time_loader(Loader(dataset, native=mode, **config),
                                    LOADER_BATCHES)
            loaders["native" if mode else "pil"] = (got, rate)
        out["loaders"] = {
            "batch": TRAIN_BATCH, "canvas": CANVAS,
            "batches": LOADER_BATCHES, "host_cores": os.cpu_count(),
            "usable_cores": len(os.sched_getaffinity(0)),
            "images_per_s": {k: v[1] for k, v in loaders.items()}}
        if native:
            nat, pil = loaders["native"][0], loaders["pil"][0]
            for a, b in zip(nat, pil):
                check(np.array_equal(a["boxes"], b["boxes"])
                      and np.array_equal(a["valid"], b["valid"]),
                      "native and PIL loaders gave different boxes")
            diff = float(np.mean([np.abs(a["images"] - b["images"]).mean()
                                  for a, b in zip(nat, pil)]))
            check(diff < NATIVE_PIL_MEAN_DIFF,
                  f"native against PIL: mean pixel difference {diff} "
                  f"(bound {NATIVE_PIL_MEAN_DIFF})")
            out["loaders"]["mean_abs_pixel_diff"] = diff
            out["loaders"]["boxes_equal"] = True
        del loaders
        log("ingestion_loaders " + json.dumps(out["loaders"]))

        # ---- the trainer CLI on the index (the default loader)
        ckpt_dir = os.path.join(tmp, "ckpt")
        kcommon.reset_launch_counts()
        summary = train_fcos.main([
            "--index", index, "--backbone", BACKBONE, "--canvas",
            str(CANVAS), "--batch_size", str(TRAIN_BATCH), "--max_steps",
            str(INGEST_STEPS), "--display_step", "2", "--step_save",
            str(INGEST_STEPS), "--ckpt_dir", ckpt_dir,
            "--out_dir", os.path.join(tmp, "out")])
        counts["train"] = kcommon.launch_counts()
        check(summary["final_step"] == INGEST_STEPS,
              f"trainer on the index: {summary}")
        check(np.isfinite(summary["total"])
              and np.isfinite(summary["grad_norm"]),
              f"trainer on the index: metrics not finite: {summary}")
        check(counts["train"] == {"focal_fwd": INGEST_STEPS,
                                  "focal_bwd": INGEST_STEPS},
              f"trainer on the index launched {counts['train']}, expected "
              f"{INGEST_STEPS} and {INGEST_STEPS}")
        out["train"] = {k: summary[k] for k in (
            "final_step", "images_per_sec", "total", "grad_norm")}
        out["train"]["loader"] = "native" if native else "pil"

        # ---- evaluation from the checkpoint: kernels, then plain versions
        argv = ["--family", "fcos", "--index", index, "--backbone",
                BACKBONE, "--canvas", str(CANVAS), "--ckpt_dir", ckpt_dir,
                "--cls_thresh", "0.0"]
        real_nms = P.detections_from_dense
        recorded: list = []

        def recording_nms(*a, **k):
            dets = real_nms(*a, **k)
            recorded.append({key: v.cpu().numpy()
                             for key, v in dets.items()})
            return dets

        runs = {}
        P.detections_from_dense = recording_nms
        try:
            for name, extra in (("kernels", []),
                                ("plain", ["--plain_kernels"])):
                recorded.clear()
                kcommon.reset_launch_counts()
                t1 = time.perf_counter()
                with contextlib.redirect_stdout(quiet):
                    got = evaluate.main(argv + extra)
                runs[name] = (got, time.perf_counter() - t1,
                              kcommon.launch_counts(), list(recorded))
        finally:
            P.detections_from_dense = real_nms
        (got, eval_s, counts["evaluate"], dets_k) = runs["kernels"]
        want, _, plain_counts, dets_p = runs["plain"]
        batches = -(-INGEST_IMAGES // 8)
        check(counts["evaluate"] == {"dense_nms": batches},
              f"evaluation launched {counts['evaluate']}, expected "
              f"{batches} dense_nms")
        check(plain_counts == {}, f"the plain evaluation launched "
                                  f"{plain_counts}")
        check(got["num_images"] == INGEST_IMAGES,
              f"evaluated {got['num_images']} images")
        check(len(dets_k) == len(dets_p) == batches,
              f"recorded {len(dets_k)} / {len(dets_p)} batches")
        for i, (a, b) in enumerate(zip(dets_k, dets_p)):
            for key in a:
                check(np.array_equal(a[key], b[key]),
                      f"evaluation batch {i}: {key} differ between the "
                      "kernels and the plain versions")
        check(got == want, f"evaluation summaries differ: kernels {got}, "
                           f"plain versions {want}")
        out["evaluate"] = {
            "images": INGEST_IMAGES, "eval_s": eval_s,
            "eval_images_per_s": INGEST_IMAGES / eval_s,
            "detections": int(sum(d["num_valid"].sum() for d in dets_k)),
            "detections_equal": True, "summary": got}

        # ---- weight import without TensorFlow
        out["resnext_import"] = resnext_import_check(tmp)
    out["phase_s"] = time.perf_counter() - t_phase
    return counts, out


# --------------------------------------------------------------------------
# phase 15: the measurement programs (bench_torch.py, bench.serving,
# bench.profile_step)
# --------------------------------------------------------------------------

BENCH_STEPS, BENCH_WINDOWS, BENCH_NMS_ITERS = 6, 2, 20
SERVING_BUCKETS, SERVING_ITERS = (1, 8, 16), 3
PROFILE_SUM_RTOL = 0.01   # categories against the profiler's device total


def exact_detections(name, got, want, *, need_valid=True) -> None:
    """The fused path's detections (``got``, the `dense_nms` kernel)
    against the same call on its plain version (``want``), on the same
    tensors on the card: every output exactly, as `check_dense` holds
    them; with ``need_valid``, every image keeps a detection."""
    for key in ("boxes", "scores", "classes", "valid", "num_valid"):
        check(got[key].shape == want[key].shape
              and got[key].dtype == want[key].dtype
              and torch.equal(got[key], want[key]),
              f"{name}: {key} differs from the plain version's "
              f"(exact match expected)")
    if need_valid:
        check(int(want["num_valid"].min()) > 0,
              f"{name}: an image has no detection "
              f"(num_valid {want['num_valid'].tolist()})")


def serving_against_plain(name, model, decode, args, images, *,
                          need_valid) -> int:
    """One forward and decode of ``images``, then `detections_from_dense`
    as `make_serving_fn` calls it, on the kernel and on its plain version:
    exactly equal. Returns the detections kept."""
    from detectax_torch.infer import predict as P

    with torch.no_grad():
        boxes, probs = decode(model(images, train=False))
        got, want = (P.detections_from_dense(boxes, probs, top_k=args.top_k,
                                             kernels=k)
                     for k in (None, "plain"))
    exact_detections(name, got, want, need_valid=need_valid)
    return int(want["num_valid"].sum())


def measurement_path() -> tuple[dict, dict]:
    """`bench_torch.py`'s lines, the serving bench and the step profile,
    in this process at reduced steps; each part driven with the launch
    counts set to 0 just before it and read just after. Returns (counts a
    part, the lines and the checks' numbers)."""
    import bench_torch
    from detectax_torch.bench import decode as bench_decode
    from detectax_torch.bench import profile_step as bench_profile
    from detectax_torch.bench import serving as bench_serving
    from detectax_torch.bench import train as bench_train
    from detectax_torch.cli.evaluate import build_family

    t0 = time.perf_counter()
    # the same step's count on the CPU: at batch 1, in float32, times the
    # batch (a convolution's count is linear in the batch and independent
    # of the dtype; tests/test_torch_bench.py holds both)
    cpu = bench_train.make_train_setup(CANVAS, 1, BACKBONE, device="cpu",
                                       dtype=torch.float32)
    cpu_flops = bench_train.step_flops(cpu) * TRAIN_BATCH
    del cpu
    cpu_s = time.perf_counter() - t0

    counts = {}
    kcommon.reset_launch_counts()
    lines = bench_torch.bench_train(CANVAS, TRAIN_BATCH, BENCH_STEPS,
                                    BENCH_WINDOWS, BACKBONE)
    counts["train"] = kcommon.launch_counts()
    kcommon.reset_launch_counts()
    lines.append(bench_torch.emit(bench_decode.decode_line(BENCH_NMS_ITERS)))
    counts["decode"] = kcommon.launch_counts()
    torch.cuda.empty_cache()

    base = f"train_images_per_sec_fcos_{BACKBONE}_{CANVAS}px_b{TRAIN_BATCH}"
    names = [base + "_bf16", base + "_bf16_bnsubset4",
             base + "_bf16_freeze_bn", "decode_nms_latency_fcos_512px_k1024"]
    check([ln["metric"] for ln in lines] == names,
          f"bench_torch lines {[ln['metric'] for ln in lines]}")
    steps_a_line = (1 + bench_train.WARMUP_STEPS
                    + BENCH_WINDOWS * (BENCH_STEPS // BENCH_WINDOWS))
    for ln in lines:
        check(np.isfinite(ln["value"]) and ln["value"] > 0,
              f"{ln['metric']}: value {ln['value']}")
    for ln in lines[:3]:
        d = ln["detail"]
        check(0 < ln["mfu_pct"] <= 100, f"{ln['metric']}: mfu_pct "
              f"{ln['mfu_pct']}")
        check(d["step_flops"] == cpu_flops,
              f"{ln['metric']}: step_flops {d['step_flops']}, the same "
              f"step on the CPU {cpu_flops}")
        check(np.isfinite(d["final_loss"]), f"{ln['metric']}: final loss")
        want = {"focal_fwd": steps_a_line, "focal_bwd": steps_a_line}
        check(d["launches"] == want,
              f"{ln['metric']}: launches {d['launches']}, expected {want}")
    check(counts["train"] == {"focal_fwd": 3 * steps_a_line,
                              "focal_bwd": 3 * steps_a_line},
          f"training lines launched {counts['train']}")
    check(lines[3]["detail"]["launches"] == {"dense_nms": BENCH_NMS_ITERS}
          and counts["decode"] == {"dense_nms": BENCH_NMS_ITERS + 1},
          f"decode line launched {counts['decode']}")
    # the decode line's detections against the plain version on the
    # line's own inputs (B=1, M=5,456, 20 classes)
    outs = [cuda(o) for o in bench_decode.decode_inputs()]
    with torch.no_grad():
        got = bench_decode.decode_and_nms(outs)
        exact_detections("decode line", got, bench_decode.decode_and_nms(
            outs, kernels="plain"))
    decode_kept = int(got["num_valid"][0])
    del outs, got

    serving_argv = ["--buckets", *map(str, SERVING_BUCKETS),
                    "--iters", str(SERVING_ITERS)]
    kcommon.reset_launch_counts()
    served = bench_serving.main(serving_argv)
    counts["serving"] = kcommon.launch_counts()
    # the same model (the seeded weights, bf16, 8 classes, M=3,069) and
    # the same batches, against the plain version: the seeded class heads
    # keep every score under the threshold, so NMS selects nothing here
    args = bench_serving.parse_args(serving_argv)
    dev = torch.device("cuda")
    model, decode = build_family(args.family, args.num_classes,
                                 args.backbone, args.canvas, args,
                                 dtype=(torch.bfloat16 if args.bf16
                                        else torch.float32))
    model = model.to(dev).eval()
    batches = bench_serving.bucket_images(args.buckets, args.canvas, dev)
    seeded_kept = [serving_against_plain(
        f"serving b{x.shape[0]}", model, decode, args, x, need_valid=False)
        for x in batches]
    # then with the class heads' bias raised, so that NMS has work: the
    # serving lines again, driven from 0, each image keeping a detection
    with torch.no_grad():
        for i in range(1, 6):
            getattr(model, f"cls_head_{i}").Conv_0.bias.fill_(CLS_HEAD_BIAS)
    fn = make_serving_fn(model, decode, top_k=args.top_k)
    kcommon.reset_launch_counts()
    served_work = [bench_serving.bucket_line(fn, args, x) for x in batches]
    counts["serving_nms_work"] = kcommon.launch_counts()
    for ln in served_work:
        check(np.isfinite(ln["value"]) and ln["value"] > 0
              and min(ln["detail"]["num_valid"]) > 0,
              f"{ln['metric']} (class-head bias {CLS_HEAD_BIAS}): value "
              f"{ln['value']}, num_valid {ln['detail']['num_valid']}")
    check(counts["serving_nms_work"] == {
        "dense_nms": len(SERVING_BUCKETS) * (2 + SERVING_ITERS)},
        f"serving with NMS work launched {counts['serving_nms_work']}")
    work_kept = [serving_against_plain(
        f"serving b{x.shape[0]}, class-head bias {CLS_HEAD_BIAS}", model,
        decode, args, x, need_valid=True) for x in batches]
    del model, fn, batches
    check([ln["metric"] for ln in served] ==
          [f"serving_img_per_sec_fcos_mobilenetv2_384px_b{b}"
           for b in SERVING_BUCKETS],
          f"serving lines {[ln['metric'] for ln in served]}")
    for ln in served:
        check(np.isfinite(ln["value"]) and ln["value"] > 0,
              f"{ln['metric']}: value {ln['value']}")
        check(ln["detail"]["launches"] == {"dense_nms": SERVING_ITERS},
              f"{ln['metric']}: launches {ln['detail']['launches']}")
    check(counts["serving"] == {
        "dense_nms": len(SERVING_BUCKETS) * (2 + SERVING_ITERS)},
        f"serving launched {counts['serving']}")
    torch.cuda.empty_cache()

    kcommon.reset_launch_counts()
    summary = bench_profile.main([])
    counts["profile"] = kcommon.launch_counts()
    categories = summary["by_category"]
    total = summary["key_averages_device_ms"]
    summed = sum(r["ms"] for r in categories.values())
    check(abs(summed - total) <= PROFILE_SUM_RTOL * total,
          f"profile: categories sum to {summed} ms, the profiler's device "
          f"total is {total} ms")
    check(all(f"port:focal_{d}_kernel" in categories
              for d in ("fwd", "bwd")),
          f"profile: no focal kernel by name in {list(categories)}")
    check(0.0 <= summary["idle_share"] < 1.0,
          f"profile: idle share {summary['idle_share']}")
    profiled = 2 + bench_train.WARMUP_STEPS   # counted, warm-up, traced
    check(counts["profile"] == {"focal_fwd": profiled,
                                "focal_bwd": profiled},
          f"profile launched {counts['profile']}")
    torch.cuda.empty_cache()
    return counts, {
        "cpu_step_flops": cpu_flops, "cpu_count_s": cpu_s,
        "bench_torch": lines, "serving": served,
        "serving_nms_work": served_work,
        "kept_vs_plain": {"decode": decode_kept, "serving": seeded_kept,
                          "serving_nms_work": work_kept},
        "profile": {k: summary[k] for k in (
            "device_ms", "key_averages_device_ms", "busy_ms", "window_ms",
            "idle_share", "step_ms_unprofiled", "idle_share_unprofiled",
            "kernels", "by_phase", "gemm_tflops_per_s_from_step_count")},
        "profile_categories_ms_sum": summed,
        "phase_s": time.perf_counter() - t0,
    }


# --------------------------------------------------------------------------

# --------------------------------------------------------------------------
# phase 16: crop pretraining and the DetBench driver
# --------------------------------------------------------------------------

PRETRAIN_STEPS = 40
PRETRAIN_ARGS = ("--backbone", "mobilenetv2", "--steps", str(PRETRAIN_STEPS),
                 "--warmup_steps", "10", "--batch_size", "64", "--crop",
                 "128", "--eval_batches", "2", "--display_step", "10")
JAX_MBV2_TRUNK = os.path.join(REPO, "benchmarks", "runs", "pretrain_mbv2",
                              "backbone.msgpack")
DRIVER_STEPS = 4
DRIVER_FAMILIES = ("centernet_s8", "centernet_heatmap")
EVAL_IMAGES, EVAL_BATCH = 256, 8   # the v1 eval split, cli.evaluate's batch


def tree_layout(params: dict, batch_stats: dict) -> dict:
    """(shape, dtype) of every leaf, keyed by its Flax path."""
    from detectax_torch.tools.from_flax import _flatten

    return {"/".join(path): (tuple(v.shape), str(v.dtype))
            for top, tree in (("params", params),
                              ("batch_stats", batch_stats))
            for path, v in _flatten(tree, (top,))}


def pretrain_driver_path() -> tuple[dict, dict]:
    """Crop pretraining, then the DetBench driver from its trunk.

    1. `detectax_torch.bench.pretrain_backbone.main` for MobileNetV2, 40
       steps (10 of warmup) at batch 64, crops of 128 px, 2 evaluation
       batches: every loss finite, the saved trunk's tree (keys, shapes,
       dtypes) that of the committed JAX trunk; ms a step and crops/s.
    2. `python -m detectax_torch.bench.run_detbench --families <family>
       --steps 4 --trunk <that .npz>` for centernet_s8 and for
       centernet_heatmap, two subprocesses at once into one temporary run
       root (a results file each), on the run's DetBench cache: both rows
       without an error, 4 training steps, mAP@0.5 in [0, 1], and the
       centernet_s8 log saying that the trunk was loaded.
    3. The centernet_heatmap row's evaluate argv from `family_commands`
       in this process on the kernels (the counted run) and again with
       ``--plain_kernels``: the summaries equal. Expected launches: the
       256 eval images at batch 8 are 32 batches, each one `peak` launch
       (the heatmap decode) and one `dense_nms` launch (the fused NMS):
       exactly {"dense_nms": 32, "peak": 32}.
    Returns (the counted run's launches, the phase's numbers)."""
    import contextlib
    import io

    from detectax_torch.bench import pretrain_backbone, run_detbench
    from detectax_torch.cli import evaluate
    from detectax_torch.data.detbench import DetBenchDataset
    from detectax_torch.tools.from_flax import load_npz, read_msgpack

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        DetBenchDataset("train")
        DetBenchDataset("eval")
        cache_s = time.perf_counter() - t0

        trunk = os.path.join(tmp, "pretrain_mbv2", "backbone.npz")
        meta = pretrain_backbone.main([*PRETRAIN_ARGS, "--out", trunk])
        timing = meta["timing"]
        losses = timing["losses"]
        check(len(losses) == PRETRAIN_STEPS
              and all(np.isfinite(v) for v in losses),
              f"pretraining losses: {losses}")
        check(0.0 <= meta["eval_crop_acc"] <= 1.0,
              f"pretraining eval accuracy {meta['eval_crop_acc']}")
        committed = read_msgpack(JAX_MBV2_TRUNK)
        want = tree_layout(committed["params"], committed["batch_stats"])
        got = tree_layout(*load_npz(trunk))
        check(got == want, "the pretrained trunk's tree differs from the "
              f"committed JAX trunk's: {sorted(set(got) ^ set(want))[:8]}, "
              f"{[k for k in got if k in want and got[k] != want[k]][:8]}")

        run_root = os.path.join(tmp, "runs")
        driver_argv = ["--steps", str(DRIVER_STEPS), "--trunk", trunk,
                       "--run_root", run_root]
        outs = {fam: os.path.join(tmp, f"RESULTS_{fam}.json")
                for fam in DRIVER_FAMILIES}
        t1 = time.perf_counter()
        # a driver a family, all at once: a row is two processes that
        # mostly start up (one after the other, the two took 130 s)
        run_processes([[sys.executable, "-m",
                        "detectax_torch.bench.run_detbench", "--families",
                        fam, *driver_argv, "--out", outs[fam]]
                       for fam in DRIVER_FAMILIES], timeout=600)
        driver_s = time.perf_counter() - t1
        rows = {}
        for fam in DRIVER_FAMILIES:
            with open(outs[fam]) as f:
                rows[fam] = json.load(f).get(fam, {})
            row = rows[fam]
            check("error" not in row and row.get("train_steps")
                  == DRIVER_STEPS and 0.0 <= row.get("mAP@0.5", -1) <= 1.0,
                  f"the driver's {fam} row: {row}")
        with open(os.path.join(run_root, "centernet_s8", "log.txt")) as f:
            s8_log = f.read()
        loaded = f"initialized backbone MobileNetV2_0 from {trunk}"
        check(loaded in s8_log,
              f"the centernet_s8 log does not say '{loaded}':\n"
              f"{s8_log[-3000:]}")

        args = run_detbench.parse_args(driver_argv)
        _, eval_cmd = run_detbench.family_commands("centernet_heatmap", args)
        argv = eval_cmd[eval_cmd.index("-m") + 2:]
        quiet = io.StringIO()
        # ---- the counted run: counts set to 0 just before, read just after
        kcommon.reset_launch_counts()
        t2 = time.perf_counter()
        with contextlib.redirect_stdout(quiet):
            summary = evaluate.main(argv)
        eval_s = time.perf_counter() - t2
        counts = kcommon.launch_counts()
        # ----
        with contextlib.redirect_stdout(quiet):
            plain = evaluate.main(argv + ["--plain_kernels"])
        check(kcommon.launch_counts() == counts,
              "the plain-kernel evaluation launched a kernel")
    batches = -(-EVAL_IMAGES // EVAL_BATCH)
    check(counts == {"dense_nms": batches, "peak": batches},
          f"the centernet_heatmap evaluation launched {counts}, expected "
          f"{batches} dense_nms and {batches} peak")
    check(summary["num_images"] == EVAL_IMAGES,
          f"evaluated {summary['num_images']} images")
    check(summary == plain, f"centernet_heatmap summaries differ: kernels "
                            f"{summary}, plain versions {plain}")
    return counts, {
        "cache_s": cache_s,
        "pretrain": {"steps": PRETRAIN_STEPS, "batch": 64, "crop": 128,
                     "eval_crop_acc": meta["eval_crop_acc"],
                     "first_loss": losses[0], "last_loss": losses[-1],
                     **{k: timing[k] for k in ("train_s", "ms_per_step",
                                               "crops_per_s",
                                               "crop_share")}},
        "trunk_tree_equal": True,
        "driver_s": driver_s,
        "rows": {fam: {k: rows[fam].get(k) for k in
                       ("mAP@0.5", "mAP@[.5:.95]", "train_steps",
                        "train_min")} for fam in DRIVER_FAMILIES},
        "trunk_loaded": True,
        "eval_s": eval_s, "eval_images_per_s": EVAL_IMAGES / eval_s,
        "summary": summary, "summaries_equal": True,
        "phase_s": time.perf_counter() - t_phase,
    }


# --------------------------------------------------------------------------
# phase 17: the space-to-depth stem and the last measurement programs
# (mfu_breakdown, config_frontier, s2d_ab, pool_ab, latency_reconcile,
# diag_export)
# --------------------------------------------------------------------------

S2D_RTOL = 1e-4    # of the output's largest magnitude (fp32, TF32 off);
                   # the step's loss, relative
S2D_TIME_REPS = 20
LEVER_PHASE_STEPS, LEVER_PHASE_WINDOWS = 4, 4   # mfu_breakdown --only phases
LEVER_STEPS, LEVER_WINDOWS = 2, 2   # every other lever program's arms
DIAG_STEPS, DIAG_CLASSES = 2, 3     # cli.train_fcos; the synthetic classes
DIAG_DENSE_ATOL = 1e-4
FCOS_STRIDES = (8, 16, 32, 64, 128)
LEVER_TRAINING_PARTS = ("mfu_phases", "mfu_canvas", "mfu_levers",
                        "config_frontier", "s2d_ab", "pool_ab")


def s2d_stem_checks() -> dict:
    """The stem's two evaluations on the card at the flagship's input
    (batch 16, 384 px): `ConvBN(s2d=True)` against its own plain
    evaluation in float32 (TF32 off) to `S2D_RTOL` of the output's largest
    magnitude, in both BatchNorm modes; in bf16 within the CPU tests'
    bound, ``max|s2d - plain| <= 2 * max|plain_bf16 - plain_fp32| +
    1e-3``; one fp32 step of FCOS-R50 with ``DETECTAX_S2D_STEM=1`` against
    the same step with the plain stem from the same state (``total`` to
    `S2D_RTOL`, relative); and the stem's bf16 forward + backward (the
    weight gradients, as in training: the image needs none) timed by CUDA
    events in both evaluations."""
    from detectax_torch.bench import train as bench_train
    from detectax_torch.bench._common import scoped_env
    from detectax_torch.models.layers import ConvBN, init_parameters

    out = {}
    x = torch.from_numpy(bench_train.train_batch(CANVAS, TRAIN_BATCH)[
        "images"]).to(DEV).permute(0, 3, 1, 2)
    outs = {}
    for name, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        stem = ConvBN(3, 64, kernel=7, stride=2, s2d=True, dtype=dtype)
        init_parameters(stem, torch.Generator().manual_seed(SEED + 17))
        stem = stem.to(DEV)
        for train in (False, True):
            with torch.no_grad():
                outs[name, train] = {
                    s2d: stem(x, train, s2d=s2d).float() for s2d in
                    (True, False)}
        if name == "bf16":
            timed = {}
            for s2d in (True, False):
                def fwd_bwd(s2d=s2d):
                    stem(x, True, s2d=s2d).float().sum().backward()
                timed[s2d] = time_ms(fwd_bwd, warmup=3, reps=S2D_TIME_REPS)
            out["stem_bf16_fwd_bwd_ms"] = {"s2d": timed[True],
                                           "plain": timed[False]}
            log(f"s2d stem, bf16 forward + backward at [{TRAIN_BATCH}, 3, "
                f"{CANVAS}, {CANVAS}]: s2d {timed[True]:.4f} ms, plain "
                f"{timed[False]:.4f} ms")
        del stem
    for train in (False, True):
        got, want = outs["fp32", train][True], outs["fp32", train][False]
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        check(err <= S2D_RTOL * scale, f"s2d stem fp32 (train={train}): "
              f"{err} against {S2D_RTOL} of {scale}")
        b16 = outs["bf16", train]
        err16 = float((b16[True] - b16[False]).abs().max())
        bound = 2 * float((b16[False] - want).abs().max()) + 1e-3
        check(err16 <= bound, f"s2d stem bf16 (train={train}): {err16} "
              f"over the bound {bound}")
        out[f"fp32_train_{train}"] = {"max_abs_err": err, "scale": scale}
        out[f"bf16_train_{train}"] = {"max_abs_err": err16, "bound": bound}
    del outs, x
    # one fp32 step of the full model, the same seeded state, each
    # evaluation
    totals = {}
    for s2d in (True, False):
        with scoped_env({"DETECTAX_S2D_STEM": "1" if s2d else "0"}):
            parts, state, data = bench_train.build(
                CANVAS, TRAIN_BATCH, BACKBONE, device=DEV,
                dtype=torch.float32)
            _, metrics = parts.raw_step(state, data)
            totals[s2d] = {k: float(metrics[k])
                           for k in ("total", "grad_norm")}
        del parts, state, data
        torch.cuda.empty_cache()
    check(close(totals[True]["total"], totals[False]["total"], S2D_RTOL),
          f"FCOS-R50 fp32 step, s2d stem against plain: {totals}")
    out["fcos_r50_fp32_step"] = {"s2d": totals[True], "plain": totals[False]}
    return out


def check_focal_lever_shapes(canvases, batches) -> list:
    """The grouped focal kernel against its plain version
    (`check_focal_group`, case "levels") at each (canvas, batch) the lever
    programs train at besides the kernels phase's 384 px and batch 16:
    every canvas at batch 16, every batch at 384 px."""
    rng = np.random.default_rng(SEED + 18)
    shapes = sorted(({(c, FOCAL_BATCH) for c in canvases}
                     | {(CANVAS, b) for b in batches})
                    - {(CANVAS, FOCAL_BATCH)})
    rows = []
    for canvas, batch in shapes:
        levels = tuple(canvas // s for s in FCOS_STRIDES)
        row = check_focal_group(rng, "levels", levels=levels, batch=batch)
        rows.append({"canvas": canvas, "batch": batch, **row})
        log(f"focal_loss_group at {canvas} px, batch {batch}: "
            f"{json.dumps(rows[-1])}")
    return rows


def lever_rows(line: dict, prefix: str) -> dict:
    """The rows of a program's summary line, under its JAX key."""
    keys = [k for k in line if k.startswith(prefix)]
    check(len(keys) == 1, f"no single {prefix}* key in {sorted(line)}")
    return line[keys[0]]


def check_step_rows(what: str, rows: dict, names):
    check(list(rows) == list(names), f"{what}: arms {list(rows)}")
    for name, row in rows.items():
        check("error" not in row and row["ms_per_step"] > 0
              and np.isfinite(row["img_per_sec"])
              and 0 < row["mfu_pct"] <= 100,
              f"{what} {name}: {row}")


def lever_programs_path() -> tuple[dict, dict]:
    """The stem's checks (`s2d_stem_checks`) and the grouped focal kernel
    against its plain version at the programs' other training shapes
    (`check_focal_lever_shapes`); then each program in this process at few
    steps and full width (FCOS-R50, 384 px, batch 16, bf16), its launch
    counts set to 0 just before it and read just after (each a step of
    its graphs launches focal once each way; each decode + NMS
    `dense_nms` once). Returns (counts a program, the numbers)."""
    import argparse

    from detectax_torch.bench import (
        config_frontier,
        diag_export,
        latency_reconcile,
        mfu_breakdown,
        pool_ab,
        s2d_ab,
    )
    from detectax_torch.bench import decode as bench_decode
    from detectax_torch.cli import train_fcos
    from detectax_torch.tools.from_flax import save_npz, to_flax

    t_phase = time.perf_counter()
    out, counts = {}, {}
    out["s2d_stem"] = s2d_stem_checks()
    out["s2d_stem_s"] = time.perf_counter() - t_phase
    # comparisons, made before the counts are set to 0
    out["focal_lever_shapes"] = check_focal_lever_shapes(
        mfu_breakdown.CANVASES, [c[3] for c in config_frontier.CONFIGS])

    def ns(steps, windows, only=None):
        return argparse.Namespace(steps=steps, windows=windows, only=only)

    # a graph's calls: 2 warm-up, the windows', 1 counted
    calls = 2 + LEVER_PHASE_WINDOWS * (LEVER_PHASE_STEPS
                                       // LEVER_PHASE_WINDOWS) + 1
    arm_calls = 2 + LEVER_WINDOWS * (LEVER_STEPS // LEVER_WINDOWS) + 1

    kcommon.reset_launch_counts()
    t0 = time.perf_counter()
    lines = mfu_breakdown.run(ns(LEVER_PHASE_STEPS, LEVER_PHASE_WINDOWS,
                                 "phases"), DEV)
    counts["mfu_phases"] = kcommon.launch_counts()
    phases = lines["phases"]
    rows = lever_rows(phases, "phase_breakdown_")
    graphs = ["assign", "forward", "forward+loss", "grad(fwd+bwd)",
              "full step"]
    check(list(rows) == graphs + ["backward (grad - fwd+loss)",
                                  "update (full - grad)"],
          f"mfu_breakdown phases: rows {list(rows)}")
    for name in graphs:
        check(rows[name]["ms"] > 0, f"phase {name}: {rows[name]}")
    # the assignment has no convolution or matmul: FlopCounterMode counts 0
    check(rows["assign"]["tflops"] == 0 and rows["assign"]["mfu_pct"] == 0,
          f"phase assign: {rows['assign']}")
    for name in graphs[1:]:
        check(0 < rows[name]["mfu_pct"] <= 100, f"phase {name}: "
              f"{rows[name]}")
    win = phases["window_ms"]
    spread = max(max(w) - min(w) for w in win.values())
    for hi, lo in (("full step", "grad(fwd+bwd)"),
                   ("grad(fwd+bwd)", "forward+loss")):
        check(rows[hi]["ms"] >= rows[lo]["ms"] - spread,
              f"phase {hi} {rows[hi]['ms']} ms under {lo} {rows[lo]['ms']}"
              f" by more than the windows' spread {spread}")
    check(rows["backward (grad - fwd+loss)"]["ms"] == round(
        rows["grad(fwd+bwd)"]["ms"] - rows["forward+loss"]["ms"], 2)
        and rows["update (full - grad)"]["ms"] == round(
        rows["full step"]["ms"] - rows["grad(fwd+bwd)"]["ms"], 2),
        f"derived phase rows: {rows}")
    check(counts["mfu_phases"] == {"focal_fwd": 3 * calls,
                                   "focal_bwd": 2 * calls},
          f"mfu_breakdown phases launched {counts['mfu_phases']}")
    out["mfu_phases"] = {"rows": rows, "window_ms": win,
                         "s": time.perf_counter() - t0}
    torch.cuda.empty_cache()

    for part, names in (("canvas", [f"{c}px" for c in
                                    mfu_breakdown.CANVASES]),
                        ("levers", list(mfu_breakdown.LEVERS))):
        kcommon.reset_launch_counts()
        t0 = time.perf_counter()
        line = mfu_breakdown.run(ns(LEVER_STEPS, LEVER_WINDOWS, part),
                                 DEV)[part]
        counts[f"mfu_{part}"] = kcommon.launch_counts()
        prefix = ("canvas_sweep_" if part == "canvas"
                  else "compiler_levers_")
        rows = lever_rows(line, prefix)
        check_step_rows(f"mfu_breakdown {part}", rows, names)
        n = len(names) * arm_calls
        check(counts[f"mfu_{part}"] == {"focal_fwd": n, "focal_bwd": n},
              f"mfu_breakdown {part} launched {counts[f'mfu_{part}']}")
        out[f"mfu_{part}"] = {"rows": rows, "window_ms": line["window_ms"],
                              "s": time.perf_counter() - t0}
        torch.cuda.empty_cache()
    check(not torch.backends.cudnn.benchmark,
          "the cudnn_benchmark lever was left on")

    kcommon.reset_launch_counts()
    t0 = time.perf_counter()
    line = config_frontier.run(ns(LEVER_STEPS, LEVER_WINDOWS), DEV)
    counts["config_frontier"] = kcommon.launch_counts()
    labels = [c[0] for c in config_frontier.CONFIGS]
    rows = line["config_frontier_fcos_r50_384"]
    check_step_rows("config_frontier", rows, labels)
    for label, env, freeze_bn, batch in config_frontier.CONFIGS:
        check(rows[label]["config"] == label
              and rows[label]["batch"] == batch,
              f"config_frontier {label}: {rows[label]}")
    check(not any(k in os.environ for k in config_frontier.ENV_KEYS),
          "config_frontier left its environment set")
    n = len(labels) * arm_calls
    check(counts["config_frontier"] == {"focal_fwd": n, "focal_bwd": n},
          f"config_frontier launched {counts['config_frontier']}")
    out["config_frontier"] = {"rows": rows, "window_ms": line["window_ms"],
                              "s": time.perf_counter() - t0}

    arms = ["base", "{}", "base+freeze_bn", "{}+freeze_bn"]
    for name, prog, key, lever in (
            ("s2d_ab", s2d_ab, "s2d_ab_fcos_r50_384_b16", "s2d"),
            ("pool_ab", pool_ab, "pool_ab_fcos_r50_384_b16", "pool")):
        kcommon.reset_launch_counts()
        t0 = time.perf_counter()
        line = prog.run(ns(LEVER_STEPS, LEVER_WINDOWS), DEV)
        counts[name] = kcommon.launch_counts()
        rows = line[key]
        check_step_rows(name, rows, [a.format(lever) for a in arms])
        check(prog.ENV_KEY not in os.environ, f"{name} left its switch set")
        # s2d_ab counts each arm's step twice (its own and the plain stem's)
        n = 4 * (arm_calls + (name == "s2d_ab"))
        check(counts[name] == {"focal_fwd": n, "focal_bwd": n},
              f"{name} launched {counts[name]}")
        out[name] = {"rows": rows, "window_ms": line["window_ms"],
                     "s": time.perf_counter() - t0}
    s2d_rows = out["s2d_ab"]["rows"]
    check(s2d_rows["s2d"]["arm_step_tflops"]
          > s2d_rows["base"]["arm_step_tflops"],
          f"s2d_ab: the s2d arm's own count is not above the plain one's: "
          f"{s2d_rows}")
    torch.cuda.empty_cache()

    kcommon.reset_launch_counts()
    t0 = time.perf_counter()
    p = latency_reconcile.protocols(DEV)
    counts["latency_reconcile"] = kcommon.launch_counts()
    line = latency_reconcile.reconcile_line(p, DEV)
    for key in ("dispatch_only_ms", "amortized_fetch_ms",
                "device_chained_ms"):
        check(np.isfinite(p[key]) and p[key] > 0,
              f"latency_reconcile {key}: {p[key]}")
    outs = [cuda(o) for o in bench_decode.decode_inputs()]
    with torch.no_grad():
        exact_detections("latency_reconcile application", p["detections"],
                         bench_decode.decode_and_nms(outs, kernels="plain"))
    inner = latency_reconcile.INNER
    check(p["graph_dense_nms_launches_at_capture"] == inner,
          f"the graph holds {p['graph_dense_nms_launches_at_capture']} "
          f"dense_nms launches, expected {inner}")
    want_sum = inner * float(p["detections"]["scores"].sum())
    check(abs(p["graph_scores_sum"] - want_sum) <= 1e-5 * want_sum,
          f"the graph's replay summed {p['graph_scores_sum']}, {inner} "
          f"applications {want_sum}")
    iters, reps = latency_reconcile.ITERS, latency_reconcile.REPEATS
    n = 1 + iters + reps * iters + 1 + inner
    check(counts["latency_reconcile"] == {"dense_nms": n},
          f"latency_reconcile launched {counts['latency_reconcile']}, "
          f"expected {n} (the graph's at capture)")
    out["latency_reconcile"] = {**line, "graph_scores_sum":
                                p["graph_scores_sum"],
                                "s": time.perf_counter() - t0}
    del outs, p
    torch.cuda.empty_cache()

    # diag_export on a checkpoint of 2 steps of cli.train_fcos (MobileNetV2
    # FCOS, 384 px), then on the same weights with the class heads' bias
    # raised so that the serving graph keeps detections
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "ckpt")
        summary = train_fcos.main([
            "--backbone", "mobilenetv2", "--canvas", str(CANVAS),
            "--batch_size", str(TRAIN_BATCH), "--max_steps",
            str(DIAG_STEPS), "--display_step", "1", "--step_save",
            str(DIAG_STEPS), "--synthetic_n", "32", "--ckpt_dir", ckpt,
            "--out_dir", os.path.join(tmp, "out")])
        check(summary["final_step"] == DIAG_STEPS,
              f"diag_export's checkpoint run: {summary}")
        argv = ["--backbone", "mobilenetv2", "--num_classes",
                str(DIAG_CLASSES), "--canvas", str(CANVAS)]
        reports = {}
        kcommon.reset_launch_counts()
        reports["checkpoint"] = diag_export.main(argv + ["--ckpt_dir", ckpt])
        counts["diag_export"] = kcommon.launch_counts()
        model, _ = diag_export.load_model(
            diag_export.parse_args(argv + ["--ckpt_dir", ckpt]), DEV)
        with torch.no_grad():
            for i in range(1, 6):
                getattr(model, f"cls_head_{i}").Conv_0.bias.fill_(
                    CLS_HEAD_BIAS)
        weights = os.path.join(tmp, "raised.npz")
        save_npz(weights, *to_flax(model))
        del model
        reports["raised_bias"] = diag_export.main(argv + ["--weights",
                                                          weights])
    for name, rep in reports.items():
        nv = rep["serving: num_valid (eager/replay)"]
        check(nv[0] == nv[1], f"diag_export {name}: num_valid {nv}")
        dense = rep["dense: replay_vs_eager"]
        check(max(dense.values()) <= DIAG_DENSE_ATOL,
              f"diag_export {name}: dense replay against eager {dense}")
    check(min(reports["raised_bias"][
        "serving: num_valid (eager/replay)"]) > 0,
        "diag_export with the class heads' bias raised kept no detection")
    # one live serving call and one replay a report
    check(counts["diag_export"] == {"dense_nms": 2},
          f"diag_export launched {counts['diag_export']}")
    out["diag_export"] = {**reports, "s": time.perf_counter() - t0}
    out["phase_s"] = time.perf_counter() - t_phase
    torch.cuda.empty_cache()
    return counts, out


def main() -> None:
    if not torch.cuda.is_available():
        sys.stderr.write(
            "chip_smoke.py needs a CUDA device; none is available\n")
        sys.exit(1)
    t_start = time.perf_counter()
    # one DetBench cache for the run (DetBench keys a split by version,
    # split, seed and size): each split is generated once, by the first
    # phase that reads it
    detbench_cache = tempfile.TemporaryDirectory()
    os.environ["DETECTAX_DETBENCH_CACHE"] = detbench_cache.name
    # seconds a phase, each from the end of the one before; printed at the
    # end to show which phases use the run's time
    phase_s, t_mark = {}, [t_start]

    def done(phase: str) -> None:
        now = time.perf_counter()
        phase_s[phase] = round(now - t_mark[0], 1)
        t_mark[0] = now

    kind = torch.cuda.get_device_name(0)
    card = runtime.card_name_and_power()
    log(f"device: {kind} | torch {torch.__version__} cuda {torch.version.cuda}")
    log(f"nvidia-smi name, power.limit: {card}")
    log(f"tf32: {json.dumps(runtime.set_tf32(False))}")
    # the CLI phases' checkpoints, which the export phase reads; removed at
    # the end (and at exit, should a phase fail)
    ckpts = tempfile.TemporaryDirectory()

    kcommon.load_library(verbose=True)
    K.load_kernels()
    KP.load_kernels()
    built = kcommon.build_seconds()
    log("kernels found built and loaded" if built is None
        else f"kernels built and loaded in {built:.1f} s")

    round_us = barrier_round_us()
    log(f"empty round (exchange + barrier, 1024 threads, 8 blocks): "
        f"{round_us:.4f} us")
    step_ns = chain_step_ns()
    log(f"empty sweep chain step (one warp, 8 images): {step_ns:.4f} ns")
    launch_floor = queued_ms(lambda: KB.empty_launch(DEV), reps=200)
    log(f"empty kernel launch, queued: {launch_floor:.5f} ms")
    cluster_probe = {
        mode: {str(c): cluster_round_us(c, 384, mode)
               for c in (1, 2, 4, 8, 16)}
        for mode in KB.CLUSTER_MODES}
    log("empty cluster round, us (8 clusters of 384-thread blocks, by "
        "cluster size): " + json.dumps(cluster_probe))

    rng = np.random.default_rng(SEED)
    edge = np.random.default_rng(SEED + 6)  # leaves rng's sequence as it was
    sweep = [
        check_sweep(rng, 8, 1024, class_aware=True, with_valid=False),
        check_sweep(rng, 8, 1024, class_aware=False, with_valid=True),
        check_sweep(rng, 8, 2048, class_aware=True, with_valid=False),
        # the smallest K the serving path routes to the kernel; K not a
        # multiple of 64; all padding; one class
        check_sweep(edge, 8, 256, class_aware=True, with_valid=False),
        check_sweep(edge, 8, 1000, class_aware=True, with_valid=True),
        check_sweep(edge, 4, 700, class_aware=True, with_valid=True,
                    case="all_invalid", timed=False),
        check_sweep(edge, 4, 700, class_aware=True, with_valid=False,
                    case="one_class", timed=False),
    ]
    # 3,069: FCOS at 384 px; 2,304 and 11,520: the two CenterNet decodes
    # there (2,304 at both buckets); 20,480: the scale-slot decode at 512 px
    dense = [check_dense(rng, 8, 3069, 100), check_dense(rng, 8, 8525, 200),
             check_dense(rng, 8, CN_CELLS, 100),
             check_dense(rng, 1, CN_CELLS, 100),
             check_dense(rng, 8, len(S8_SCALES) * CN_CELLS, 100),
             check_dense(rng, 8, len(S8_SCALES) * (S8_CANVAS // 8) ** 2,
                         100),
             # fewer candidates than the cluster's blocks; one candidate;
             # none above the threshold; one class; class-agnostic; no
             # classes at all
             check_dense(edge, 8, 5, 100, timed=False),
             check_dense(edge, 8, 1, 100, timed=False),
             check_dense(edge, 4, 3069, 100, case="below_threshold",
                         timed=False),
             check_dense(edge, 4, 3069, 100, case="one_class", timed=False),
             check_dense(edge, 4, 3069, 100, class_aware=False, timed=False),
             check_dense(edge, 4, 3069, 50, case="no_classes", timed=False)]
    # past the plans' former bounds: the wide sweep (K > 14,464); the
    # dense set staged in shared memory (RetinaNet at 640 px, CenterNetS8
    # at 1024 px) and read from device memory (327,680)
    big = np.random.default_rng(SEED + 8)
    sweep += [check_sweep(big, 1, k, class_aware=True, with_valid=False,
                          plain_reps=1) for k in (16384, 20000)]
    dense += [check_dense(big, 2, 76725, 100, plain_reps=1),
              check_dense(big, 2, 81920, 100, plain_reps=1),
              check_dense(big, 1, 327680, 100, plain_reps=1)]
    # the same tiers at odd sizes, padding, class-agnostic, no classes
    sweep.append(check_sweep(big, 2, 15001, class_aware=False,
                             with_valid=True, timed=False))
    dense += [check_dense(big, 1, 70001, 100, case="no_classes",
                          timed=False),
              check_dense(big, 2, 150001, 50, class_aware=False,
                          timed=False)]
    # RetinaNet at 512 px (49,104 candidates an image): cli.evaluate's
    # configuration and cli.infer_retinanet's; and its --high_res 1024 px
    # (196,416, the device-memory tier)
    rn = np.random.default_rng(SEED + 11)
    dense += [check_dense(rn, 8, RN_CANDIDATES, 100, plain_reps=1,
                          nc=RN_CLASSES),
              check_dense(rn, 8, RN_CANDIDATES, 200, class_aware=False,
                          plain_reps=1, nc=RN_CLASSES),
              check_dense(rn, 1, RN_HIGH_RES_CANDIDATES, 200,
                          class_aware=False, plain_reps=1, nc=RN_CLASSES)]
    # both hourglass models at 320 px (6,400 candidates an image) and at
    # the 448 bucket (12,544)
    hg = np.random.default_rng(SEED + 14)
    dense += [check_dense(hg, 8, m, 100, plain_reps=1)
              for m in (HG_MODELS["hourglass"][1], HG_BIG_CANDIDATES)]
    # the dense-crowd split's evaluation: 200 outputs an image
    dense.append(check_dense(np.random.default_rng(SEED + 16), 8,
                             HG_MODELS["hourglass"][1], CROWD_MAX_OUTPUTS,
                             plain_reps=1))
    for r in sweep:
        if "ms" in r:
            r["chain_ms"] = r["shape"]["K"] * step_ns * 1e-6
        log(f"kernel nms_sweep {json.dumps(r)}")
    for r in dense:
        if "ms" in r:
            plan = r["plan"]
            r["empty_round_us"] = cluster_round_us(plan["cluster"],
                                                   plan["threads"])
            r["chain_ms"] = r["rounds_max"] * r["empty_round_us"] * 1e-3
        log(f"kernel dense_nms {json.dumps(r)}")
    focal = check_focal_all(rng)
    focal[0]["alignment"] = check_focal_alignment(
        np.random.default_rng(SEED + 9))
    focal.append(check_focal_retinanet())
    focal += check_focal_hourglass()
    torch.cuda.empty_cache()
    for r in focal:
        log(f"kernel focal {json.dumps(r)}")
    groups = check_focal_groups(np.random.default_rng(SEED + 7))
    for r in groups:
        log(f"kernel focal_loss_group {json.dumps(r)}")
    focal_op = check_focal_operator()
    log(f"kernel focal operator {json.dumps(focal_op)}")
    peak = check_peak_all(rng)
    for r in peak[:6]:
        log(f"kernel peak {json.dumps(r)}")
    log(f"kernel peak: {len(peak)} shape/case/mode combinations held; "
        f"peak_scores decisions differing within {PEAK_TIE_ULPS} ulp: "
        f"{sum(r['decisions_differing'] for r in peak)}")
    done("build_and_kernels")

    counts, serving, stages = main_path()
    log("serving " + json.dumps({"card": card, "model": f"FCOS {BACKBONE} FPN",
                                 "canvas": CANVAS, "dtype": "float32",
                                 "buckets": BUCKETS, "requests": REQUESTS,
                                 "paths": serving,
                                 "stage_ms": stages}))
    done("serving")

    train_counts, training = train_path()
    log("training " + json.dumps({
        "card": card, "model": f"FCOS {BACKBONE} FPN", "canvas": CANVAS,
        "dtype": "float32", "classes": NUM_CLASSES, **training}))
    log("cli " + json.dumps(cli_path(ckpts.name)))
    done("training_and_cli")

    cn_counts, cn_serving, cn_stages = centernet_serving_path()
    log("centernet_serving " + json.dumps({
        "card": card, "model": f"CenterNetFPNSingle {BACKBONE}",
        "canvas": CANVAS, "dtype": "float32", "buckets": BUCKETS,
        "requests": REQUESTS, **cn_serving, "stage_ms": cn_stages}))
    cn_train_counts, cn_training = centernet_train_path()
    log("centernet_training " + json.dumps({
        "card": card, "model": f"CenterNetFPNSingle {BACKBONE}",
        "canvas": CANVAS, "dtype": "float32", "classes": NUM_CLASSES,
        **cn_training}))
    log("centernet_cli " + json.dumps(centernet_cli_path(ckpts.name)))
    s8_train_counts, s8_training = s8_train_path()
    log("centernet_s8_training " + json.dumps({
        "card": card, "model": f"CenterNetS8 {BACKBONE}", "dtype": "float32",
        "classes": NUM_CLASSES, **s8_training}))
    log("centernet_s8_cli " + json.dumps(s8_cli_path()))
    done("centernet")
    db_counts, detbench = detbench_path()
    log("detbench " + json.dumps({"card": card, "model": f"FCOS {BACKBONE} "
                                  "FPN", "canvas": CANVAS, **detbench}))
    done("detbench")
    center_counts, center = center_paths()
    log("fcos_center " + json.dumps({"card": card, "canvas": CANVAS,
                                     "classes": NUM_CLASSES, **center}))
    torch.cuda.empty_cache()
    done("fcos_center")

    rn_counts, rn_serving = retinanet_serving_path()
    log("retinanet_serving " + json.dumps({
        "card": card, "model": f"RetinaNet {RN_BACKBONE}",
        "canvas": RN_CANVAS, "dtype": "float32", "classes": RN_CLASSES,
        "anchors": 9, "buckets": BUCKETS, "requests": REQUESTS,
        "nms": RN_CONFIGS, **rn_serving}))
    torch.cuda.empty_cache()
    rn_train_counts, rn_training = retinanet_train_path()
    log("retinanet_training " + json.dumps({
        "card": card, "model": f"RetinaNet {RN_BACKBONE}",
        "canvas": RN_CANVAS, "dtype": "float32", "classes": RN_CLASSES,
        **rn_training}))
    torch.cuda.empty_cache()
    log("retinanet_cli " + json.dumps(retinanet_cli_path(ckpts.name)))
    torch.cuda.empty_cache()
    rn_db_train_counts, rn_db_counts, rn_detbench = retinanet_detbench_path()
    log("retinanet_detbench_v2 " + json.dumps({
        "card": card, "model": "RetinaNet mobilenetv2", "canvas": RN_CANVAS,
        "dtype": "bfloat16", **rn_detbench}))
    torch.cuda.empty_cache()
    done("retinanet")
    bf16_counts, rn_bf16_counts, bf16 = bf16_train_path(
        training["step_ms"], rn_training["step_ms"])
    log("bf16_training " + json.dumps({
        "card": card, "fcos": f"FCOS {BACKBONE} FPN, {CANVAS} px",
        "retinanet": f"RetinaNet {RN_BACKBONE}, {RN_CANVAS} px",
        "dtype": "bfloat16", "batch": TRAIN_BATCH, **bf16}))
    torch.cuda.empty_cache()
    done("bf16_training")

    t_hg = time.perf_counter()
    hg_counts, hg_serving = hourglass_serving_path()
    log("hourglass_serving " + json.dumps({
        "card": card, "models": {"hourglass": "HourglassNet n_filters 12",
                                 "stacked_hourglass": "StackedHourglass "
                                 "n_filters 64, 2 stacks"},
        "canvas": HG_CANVAS, "dtype": "float32", "classes": NUM_CLASSES,
        "buckets": BUCKETS, "requests": REQUESTS, **hg_serving}))
    hg_train_counts, hg_bf16_counts, hg_training = hourglass_train_path()
    log("hourglass_training " + json.dumps({
        "card": card, "canvas": HG_CANVAS, "classes": NUM_CLASSES,
        "dtype": "float32, then bfloat16", **hg_training}))
    hg_cli_counts, hg_cli = hourglass_cli_path(ckpts.name)
    log("hourglass_cli " + json.dumps(hg_cli))
    torch.cuda.empty_cache()
    hg_db_train_counts, hg_db_counts, hg_detbench = hourglass_detbench_path()
    log("hourglass_detbench_v2 " + json.dumps({
        "card": card, "model": "StackedHourglass n_filters 64, 2 stacks",
        "canvas": HG_CANVAS, "dtype": "bfloat16", **hg_detbench}))
    log(f"hourglass phase took {time.perf_counter() - t_hg:.1f} s")
    torch.cuda.empty_cache()
    done("hourglass")
    hg_crowd_train_counts, hg_crowd_counts, hg_crowd = hourglass_crowd_path(
        "stacked_hourglass")
    log("hourglass_detbench_v2_crowd " + json.dumps({
        "card": card, "model": "StackedHourglass n_filters 64, 2 stacks",
        "canvas": HG_CANVAS, "dtype": "bfloat16", "max_boxes": 128,
        "max_outputs": CROWD_MAX_OUTPUTS, **hg_crowd}))
    torch.cuda.empty_cache()
    done("hourglass_crowd")
    _, hgn_crowd_counts, hgn_crowd = hourglass_crowd_path("hourglass")
    log("hourglass_net_detbench_v2_crowd " + json.dumps({
        "card": card, "model": "HourglassNet n_filters 12",
        "canvas": HG_CANVAS, "dtype": "bfloat16", "max_boxes": 128,
        "max_outputs": CROWD_MAX_OUTPUTS, **hgn_crowd}))
    torch.cuda.empty_cache()
    done("hourglass_net_crowd")

    t_export = time.perf_counter()
    ex_counts, exported = export_path(ckpts.name)
    export_s = time.perf_counter() - t_export
    log("exported_serving " + json.dumps({
        "card": card, "buckets": BUCKETS, "requests": REQUESTS,
        "dtype": "float32", "phase_s": export_s, "bundles": exported}))
    torch.cuda.empty_cache()
    done("export")

    t_dp = time.perf_counter()
    dp_counts, parallel = parallel_path(ckpts.name, training)
    log("parallel " + json.dumps({
        "card": card, "model": f"FCOS {BACKBONE} FPN", "canvas": CANVAS,
        "classes": NUM_CLASSES, "global_batch": TRAIN_BATCH,
        "phase_s": time.perf_counter() - t_dp, **parallel}))
    ckpts.cleanup()
    torch.cuda.empty_cache()
    done("parallel")

    in_counts, ingestion = ingestion_path()
    log("ingestion " + json.dumps({
        "card": card, "model": f"FCOS {BACKBONE} FPN", "canvas": CANVAS,
        "classes": NUM_CLASSES, "batch": TRAIN_BATCH, **ingestion}))
    torch.cuda.empty_cache()
    done("ingestion")

    ms_counts, measured = measurement_path()
    log("measurement_programs " + json.dumps({
        "card": card, "model": f"FCOS {BACKBONE} FPN", "canvas": CANVAS,
        "batch": TRAIN_BATCH, "bench_steps": BENCH_STEPS,
        "bench_windows": BENCH_WINDOWS, **measured}))
    torch.cuda.empty_cache()
    done("measurement_programs")

    pd_counts, pretrain_driver = pretrain_driver_path()
    log("pretrain_and_detbench_driver " + json.dumps({
        "card": card, "backbone": "mobilenetv2", "dtype": "bfloat16",
        "families": DRIVER_FAMILIES, "driver_steps": DRIVER_STEPS,
        **pretrain_driver}))
    torch.cuda.empty_cache()
    # the last DetBench reader is done
    del os.environ["DETECTAX_DETBENCH_CACHE"]
    detbench_cache.cleanup()
    done("pretrain_and_detbench_driver")

    lv_counts, lever_programs = lever_programs_path()
    log("s2d_stem_and_lever_programs " + json.dumps({
        "card": card, "model": f"FCOS {BACKBONE} FPN", "canvas": CANVAS,
        "batch": TRAIN_BATCH, "dtype": "bfloat16",
        "phase_steps": [LEVER_PHASE_STEPS, LEVER_PHASE_WINDOWS],
        "arm_steps": [LEVER_STEPS, LEVER_WINDOWS], **lever_programs},
        default=str))
    done("s2d_stem_and_lever_programs")

    by_path = {
        "nms_sweep": {"fcos_serving": counts["nms_sweep"],
                      "hourglass_serving": hg_counts["nms_sweep"],
                      "fcos_exported_serving":
                          ex_counts["fcos_candidates"]["nms_sweep"]},
        "dense_nms": {"fcos_serving": counts["dense_nms"],
                      "centernet_serving": cn_counts["dense_nms"],
                      "detbench_evaluation": db_counts["dense_nms"],
                      "retinanet_serving": rn_counts["dense_nms"],
                      "retinanet_detbench_v2_evaluation":
                          rn_db_counts["dense_nms"],
                      "hourglass_serving": hg_counts["dense_nms"],
                      "stacked_hourglass_cli_request":
                          hg_cli_counts["request"]["dense_nms"],
                      "stacked_hourglass_detbench_v2_evaluation":
                          hg_db_counts["dense_nms"],
                      "stacked_hourglass_detbench_v2_crowd_evaluation":
                          hg_crowd_counts["dense_nms"],
                      "hourglass_detbench_v2_crowd_evaluation":
                          hgn_crowd_counts["dense_nms"],
                      "fcos_exported_serving":
                          ex_counts["fcos"]["dense_nms"],
                      "centernet_exported_serving":
                          ex_counts["centernet_heatmap"]["dense_nms"],
                      "retinanet_exported_serving":
                          ex_counts["retinanet"]["dense_nms"],
                      "stacked_hourglass_exported_serving":
                          ex_counts["stacked_hourglass"]["dense_nms"],
                      "fcos_evaluate_data_parallel_two_ranks": sum(
                          c["dense_nms"] for c in dp_counts["gloo_evaluate"]),
                      "fcos_evaluate_voc_jpeg_index":
                          in_counts["evaluate"]["dense_nms"],
                      "bench_torch_decode_line":
                          ms_counts["decode"]["dense_nms"],
                      "serving_bench": ms_counts["serving"]["dense_nms"],
                      "serving_bench_nms_work":
                          ms_counts["serving_nms_work"]["dense_nms"],
                      "detbench_driver_centernet_heatmap_evaluation":
                          pd_counts["dense_nms"],
                      "latency_reconcile":
                          lv_counts["latency_reconcile"]["dense_nms"],
                      "diag_export": lv_counts["diag_export"]["dense_nms"]},
        "focal": {"fcos_training": train_counts["focal_fwd"],
                  "centernet_training": cn_train_counts["focal_fwd"],
                  "centernet_s8_training": s8_train_counts["focal_fwd"],
                  "fcos_center_training":
                      center_counts["center"]["focal_fwd"],
                  "fcos_center_v1_training":
                      center_counts["center_v1"]["focal_fwd"],
                  "retinanet_training": rn_train_counts["focal_fwd"],
                  "retinanet_detbench_v2_bf16_training":
                      rn_db_train_counts["focal_fwd"],
                  "fcos_bf16_training": bf16_counts["focal_fwd"],
                  "retinanet_bf16_training": rn_bf16_counts["focal_fwd"],
                  "hourglass_training": hg_train_counts["focal_fwd"],
                  "hourglass_bf16_training": hg_bf16_counts["focal_fwd"],
                  "stacked_hourglass_cli_training":
                      hg_cli_counts["stacked_multi_scale"]["focal_fwd"],
                  "stacked_hourglass_detbench_v2_bf16_training":
                      hg_db_train_counts["focal_fwd"],
                  "stacked_hourglass_detbench_v2_crowd_bf16_training":
                      hg_crowd_train_counts["focal_fwd"],
                  "fcos_training_nccl_one_rank":
                      dp_counts["nccl_fp32"]["focal_fwd"],
                  "fcos_bf16_training_nccl_one_rank":
                      dp_counts["nccl_bf16"]["focal_fwd"],
                  "fcos_training_gloo_two_ranks": sum(
                      c["focal_fwd"] for c in dp_counts["gloo_train"]),
                  "fcos_training_fsdp_nccl_one_rank":
                      dp_counts["nccl_fsdp"]["focal_fwd"],
                  "fcos_training_fsdp_gloo_two_ranks": sum(
                      c["focal_fwd"] for c in dp_counts["gloo_fsdp"]),
                  "fcos_training_voc_jpeg_index":
                      in_counts["train"]["focal_fwd"],
                  "bench_torch_training_lines":
                      ms_counts["train"]["focal_fwd"],
                  "profile_step": ms_counts["profile"]["focal_fwd"],
                  **{f"lever_program_{k}": lv_counts[k]["focal_fwd"]
                     for k in LEVER_TRAINING_PARTS}},
        "peak": {"centernet_serving": cn_counts["peak"],
                 "centernet_exported_serving":
                     ex_counts["centernet_heatmap"]["peak"],
                 "detbench_driver_centernet_heatmap_evaluation":
                     pd_counts["peak"]},
    }
    for name, paths in by_path.items():
        check(all(n > 0 for n in paths.values()),
              f"{name} was launched no time on a path that runs it: {paths}")
    counts = {name: sum(paths.values()) for name, paths in by_path.items()}
    focal[0]["launches_bwd"] = (train_counts["focal_bwd"]
                                + cn_train_counts["focal_bwd"]
                                + s8_train_counts["focal_bwd"]
                                + sum(c["focal_bwd"]
                                      for c in center_counts.values())
                                + rn_train_counts["focal_bwd"]
                                + rn_db_train_counts["focal_bwd"]
                                + bf16_counts["focal_bwd"]
                                + rn_bf16_counts["focal_bwd"]
                                + hg_train_counts["focal_bwd"]
                                + hg_bf16_counts["focal_bwd"]
                                + hg_cli_counts["stacked_multi_scale"][
                                    "focal_bwd"]
                                + hg_db_train_counts["focal_bwd"]
                                + hg_crowd_train_counts["focal_bwd"]
                                + dp_counts["nccl_fp32"]["focal_bwd"]
                                + dp_counts["nccl_bf16"]["focal_bwd"]
                                + sum(c["focal_bwd"]
                                      for c in dp_counts["gloo_train"])
                                + dp_counts["nccl_fsdp"]["focal_bwd"]
                                + sum(c["focal_bwd"]
                                      for c in dp_counts["gloo_fsdp"])
                                + in_counts["train"]["focal_bwd"]
                                + ms_counts["train"]["focal_bwd"]
                                + ms_counts["profile"]["focal_bwd"]
                                + sum(lv_counts[k]["focal_bwd"]
                                      for k in LEVER_TRAINING_PARTS))
    # the five levels: one grouped call (what training runs), and beside it
    # the five single calls of the per-level rows
    levels, grouped = focal[:len(FOCAL_LEVELS)], groups[0]
    focal[0]["all_levels_fwd_ms"] = grouped["ms"]
    focal[0]["all_levels_fwd_bwd_ms"] = grouped["fwd_bwd_ms"]
    focal[0]["all_levels_fwd_bwd_call_ms"] = grouped["fwd_bwd_call_ms"]
    focal[0]["all_levels_bound_ms"] = grouped["bound_ms"]
    focal[0]["all_levels_fwd_bwd_bound_ms"] = grouped["fwd_bwd_bound_ms"]
    focal[0]["all_levels_plain_ms"] = grouped["plain_ms"]
    focal[0]["all_levels_library_ms"] = grouped["library_ms"]
    focal[0]["five_calls_fwd_ms"] = sum(r["ms"] for r in levels)
    focal[0]["five_calls_fwd_bwd_ms"] = sum(r["fwd_bwd_ms"] for r in levels)
    focal[0]["focal_loss_group"] = groups
    focal[0]["operator"] = focal_op

    meta = {
        "nms_sweep": ("detectax_torch/kernels/csrc/nms_sweep.cu",
                      "detectax/ops/pallas/nms_kernel.py:105", sweep),
        "dense_nms": ("detectax_torch/kernels/csrc/dense_nms.cu",
                      "detectax/ops/pallas/nms_kernel.py:247", dense),
        "focal": ("detectax_torch/kernels/csrc/focal.cu",
                  "detectax/ops/pallas/focal.py:75", focal),
        "peak": ("detectax_torch/kernels/csrc/peak.cu",
                 "detectax/ops/pallas/peak_decode.py:57", peak),
    }
    kernels = []
    for name, (source, replaces, rows) in meta.items():
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": counts[name],
            "launches_by_path": by_path[name],
            **rows[0], "other_shapes": rows[1:],
        })
    done("kernels_line")
    log("phase_seconds " + json.dumps(phase_s))
    log(f"chip_smoke took {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels, "launch_floor_ms": launch_floor,
                    "bound_note": BOUND_NOTE}))
    log(card)  # name, power.limit as nvidia-smi gives them
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
