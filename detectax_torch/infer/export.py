"""Serving graph, request preprocessing and the serving bundle.

Port of `detectax/infer/export.py`. `make_serving_fn` composes the full
serving graph (forward → decode → candidate select → NMS) over a live
``nn.Module``. A bundle freezes a detector for a serving host:

    <dir>/manifest.json   model/geometry/NMS config + bucket list
    <dir>/weights.npz     the weights, keyed by the Flax parameter path

`load_bundle` rebuilds the module from the manifest, fills it from the
weights file and returns a `infer.serving.Predictor`. Deviation from the
JAX package, whose bundle holds one ahead-of-time compiled artifact per
batch bucket: PyTorch runs the graph eagerly, so the bundle carries the
configuration and the weights and no compiled artifact; per-bucket
exported artifacts are left to a later change.
"""
from __future__ import annotations

import json
import os
from typing import Callable, Sequence

import numpy as np
import torch

from detectax_torch.infer import predict as P

MANIFEST_NAME = "manifest.json"
WEIGHTS_NAME = "weights.npz"
BUNDLE_FORMAT = "detectax-torch-serving-bundle-v1"

_NMS_DEFAULTS = dict(top_k=1024, iou_thresh=0.5, score_thresh=0.05,
                     max_outputs=100, class_aware=True,
                     class_aware_candidates=False)


def make_serving_fn(
    model: torch.nn.Module,
    decode: Callable,
    *,
    top_k: int = 1024,
    iou_thresh: float = 0.5,
    score_thresh: float = 0.05,
    max_outputs: int = 100,
    class_aware: bool = True,
    class_aware_candidates: bool = False,
    fused: bool | None = None,
    kernels=None,
) -> Callable:
    """The serving graph: ``fn(images [B,H,W,3] tensor) -> detections``,
    the `ops.nms` detection dict (boxes/scores/classes/valid/num_valid)
    padded to ``max_outputs``. ``images`` must lie on the model's device.

    ``fused`` and ``kernels`` are the structure overrides of
    `infer.predict.detections_from_dense`."""

    def fn(images: torch.Tensor) -> dict:
        outs = model(images, train=False)
        boxes, probs = decode(outs)
        return P.detections_from_dense(
            boxes, probs, top_k=top_k, iou_thresh=iou_thresh,
            score_thresh=score_thresh, max_outputs=max_outputs,
            class_aware=class_aware,
            class_aware_candidates=class_aware_candidates, fused=fused,
            kernels=kernels,
        )

    return fn


def fcos_decode_fn(variant: str, canvas: int, center: bool = False):
    """The decode of an FCOS variant as the evaluation CLI of the JAX
    package pairs them: ltrb decode for ``fcos`` (centerness only when
    ``center``) and ``center`` (always with centerness), offset+scale
    decode with scales (32, 64, 128, 256, canvas) for ``center_v1``."""
    if variant == "center_v1":
        scales = [32.0, 64.0, 128.0, 256.0, float(canvas)]
        return lambda outs: P.fcos_center_v1_decode(outs, box_scales=scales)
    if variant in ("fcos", "center"):
        use_centerness = variant != "fcos" or center
        return lambda outs: P.fcos_decode(
            outs, use_centerness=use_centerness)
    raise ValueError(f"unknown FCOS variant {variant!r}")


def centernet_decode_fn(family: str, *, box_scales=None, kernels=None):
    """The decode of a ResNet-backbone CenterNet family:
    ``"centernet_heatmap"`` (`CenterNetFPNSingle`: peak-masked heatmap
    decode, whose peak mask is the hand-written kernel on a CUDA tensor;
    ``kernels="plain"`` takes its plain version) or ``"centernet_s8"``
    (`CenterNetS8`: scale-slot decode with ``box_scales``, one a slot)."""
    if family == "centernet_heatmap":
        return lambda out: P.centernet_heatmap_decode(out, kernels=kernels)
    if family == "centernet_s8":
        if box_scales is None:
            raise ValueError("centernet_s8 decodes with box_scales")
        scales = [float(s) for s in box_scales]
        return lambda out: P.centernet_s8_decode(out, box_scales=scales)
    raise ValueError(f"unknown CenterNet family {family!r}")


def hourglass_decode_fn(family: str, *, canvas: int | None = None,
                        stride: int = 4):
    """The decode of an hourglass family as the evaluation CLI pairs
    them: ``"hourglass"`` (`HourglassNet`: four slots of scales ``canvas /
    2^x``, x = 3..0) or ``"stacked_hourglass"`` (`StackedHourglass`: one
    map of output stride ``stride``)."""
    if family == "hourglass":
        if canvas is None:
            raise ValueError("hourglass decodes with the canvas's scales")
        scales = [canvas / (2.0 ** x) for x in reversed(range(4))]
        return lambda out: P.hourglass_decode(out, box_scales=scales)
    if family == "stacked_hourglass":
        return lambda out: P.stacked_hourglass_decode(out, stride=stride)
    raise ValueError(f"unknown hourglass family {family!r}")


def retinanet_decode_fn(anchor_sizes: Sequence[float]):
    """The decode of a `RetinaNet` trained with ``anchor_sizes`` (one a
    level; the default aspect ratios and scales give nine anchors a
    cell)."""
    from detectax_torch.ops.anchors import anchor_shapes_per_level

    anchors = anchor_shapes_per_level(
        anchor_sizes=[float(s) for s in anchor_sizes])
    return lambda outs: P.retinanet_decode(outs, anchors_per_level=anchors)


FAMILIES = ("fcos", "centernet_heatmap", "centernet_s8", "retinanet")


def save_bundle(
    out_dir: str,
    model,
    *,
    canvas: int,
    buckets: Sequence[int] = (1, 8),
    center: bool = False,
    box_scales: Sequence[float] | None = None,
    anchor_sizes: Sequence[float] | None = None,
    manifest_extra: dict | None = None,
    **nms_config,
) -> dict:
    """Write ``manifest.json`` + ``weights.npz`` for an `FCOS`,
    `CenterNetFPNSingle`, `CenterNetS8` or `RetinaNet` module (the
    module's ``family`` goes into the manifest). ``center`` belongs to
    FCOS, ``box_scales`` (one a slot) to `CenterNetS8`, ``anchor_sizes``
    (one a level) to `RetinaNet`, whose manifest also records its head
    layout. ``nms_config`` takes the NMS keywords of `make_serving_fn`
    (top_k, iou_thresh, score_thresh, max_outputs, class_aware,
    class_aware_candidates)."""
    from detectax_torch.tools.from_flax import save_npz, to_flax

    unknown = set(nms_config) - set(_NMS_DEFAULTS)
    if unknown:
        raise TypeError(f"unknown serving options {sorted(unknown)}")
    family = getattr(model, "family", None)
    if family not in FAMILIES:
        raise TypeError(
            f"save_bundle takes a module of family {FAMILIES}, got "
            f"{type(model).__name__}")
    cfg = {
        "family": family,
        "num_classes": model.num_classes,
        "backbone": model.backbone_name,
        "features": model.features,
    }
    extra = {}
    if family == "fcos":
        cfg["variant"] = model.variant
        extra["center"] = bool(center)
    elif family == "centernet_s8":
        cfg["n_scales"] = model.n_scales
        if box_scales is None or len(box_scales) != model.n_scales:
            raise ValueError(
                f"a CenterNetS8 bundle needs {model.n_scales} box_scales, "
                f"got {box_scales!r}")
        extra["box_scales"] = [float(s) for s in box_scales]
    elif family == "retinanet":
        cfg["n_anchors"] = model.n_anchors
        cfg["per_anchor_heads"] = model.per_anchor_heads
        if anchor_sizes is None or len(anchor_sizes) != 5:
            raise ValueError(
                f"a RetinaNet bundle needs 5 anchor_sizes (one a level), "
                f"got {anchor_sizes!r}")
        extra["anchor_sizes"] = [float(s) for s in anchor_sizes]
    os.makedirs(out_dir, exist_ok=True)
    params, batch_stats = to_flax(model)
    save_npz(os.path.join(out_dir, WEIGHTS_NAME), params, batch_stats)
    manifest = {
        "format": BUNDLE_FORMAT,
        "canvas": int(canvas),
        "buckets": sorted(set(int(b) for b in buckets)),
        "model": cfg,
        **extra,
        "nms": {**_NMS_DEFAULTS, **nms_config},
        **(manifest_extra or {}),
    }
    with open(os.path.join(out_dir, MANIFEST_NAME), "w") as f:
        json.dump(manifest, f, indent=2)
    return manifest


def _model_and_decode(manifest: dict):
    """The module (fresh weights) and the decode a manifest describes."""
    from detectax_torch import models

    cfg = manifest["model"]
    family = cfg["family"]
    common = dict(num_classes=cfg["num_classes"], backbone=cfg["backbone"],
                  features=cfg["features"])
    if family == "fcos":
        return (models.FCOS(variant=cfg["variant"], **common),
                fcos_decode_fn(cfg["variant"], manifest["canvas"],
                               manifest["center"]))
    if family == "centernet_heatmap":
        return models.CenterNetFPNSingle(**common), centernet_decode_fn(family)
    if family == "centernet_s8":
        return (models.CenterNetS8(n_scales=cfg["n_scales"], **common),
                centernet_decode_fn(family,
                                    box_scales=manifest["box_scales"]))
    if family == "retinanet":
        return (models.RetinaNet(n_anchors=cfg["n_anchors"],
                                 per_anchor_heads=cfg["per_anchor_heads"],
                                 **common),
                retinanet_decode_fn(manifest["anchor_sizes"]))
    raise ValueError(f"unsupported model family {family!r}; a bundle holds "
                     f"one of {FAMILIES}")


def load_bundle(bundle_dir: str, device=None):
    """Rehydrate a bundle into an `infer.serving.Predictor` on ``device``
    (default CUDA)."""
    from detectax_torch.infer.serving import Predictor
    from detectax_torch.tools.from_flax import load_flax, load_npz

    with open(os.path.join(bundle_dir, MANIFEST_NAME)) as f:
        manifest = json.load(f)
    if manifest.get("format") != BUNDLE_FORMAT:
        raise ValueError(
            f"{bundle_dir}: not a {BUNDLE_FORMAT} bundle "
            f"(format {manifest.get('format')!r})"
        )
    model, decode = _model_and_decode(manifest)
    load_flax(model, *load_npz(os.path.join(bundle_dir, WEIGHTS_NAME)))
    fn = make_serving_fn(model, decode, **manifest["nms"])
    return Predictor.for_model(
        fn, model, canvas=manifest["canvas"], buckets=manifest["buckets"],
        device=device, manifest=manifest,
    )


def compare_detections(
    want,
    got,
    *,
    iou_min: float = 0.95,
    score_tol: float = 1e-3,
    boundary_gap: float = 2e-3,
    score_thresh: float | None = None,
    flip_iou: float = 0.3,
) -> dict:
    """Detection-aware equivalence between two padded detection dicts
    (`ops.nms` layout: boxes [B,K,4], scores [B,K], classes [B,K],
    num_valid [B]).

    Elementwise array comparison is the wrong gate for a serving
    round-trip on a *trained* model: top-k and NMS are discontinuous
    selections, so an O(1e-6) score difference between two lowerings of
    the same program can swap two near-tied candidates and produce
    O(canvas)-scale box diffs at some rank while the detection SETS are
    semantically identical. This gate compares the sets:

    - every valid detection in ``want`` must have a same-class partner in
      ``got`` with IoU >= ``iou_min`` and |score Δ| <= ``score_tol``
      (greedy best-IoU matching in score order), and vice versa;
    - an UNMATCHED detection is excusable only as a *selection flip* a
      near-tie could plausibly cause:

      1. truncation: the other side's list is full (num_valid == K) and
         the score is within ``boundary_gap`` of its lowest kept score;
      2. threshold: ``score_thresh`` is given and the score is within
         ``boundary_gap`` of it (the det flipped across the cutoff);
      3. NMS rank flip: an unmatched det on the *other* side has the
         same class, score within ``boundary_gap``, and box IoU >=
         ``flip_iou`` (class-aware NMS suppression order between two
         overlapping near-ties depends on their rank, so the survivor
         can legitimately differ).

      Anything else counts as a real mismatch (a genuinely diverging
      bundle: geometry/weights/dtype baking bugs move detections by more
      than compile noise and break these criteria).

    Returns ``{"ok", "images", "matched", "max_matched_score_diff",
    "max_matched_iou_gap", "boundary_unmatched", "real_mismatches"}``.
    """
    wb = np.asarray(want["boxes"], np.float32)
    gb = np.asarray(got["boxes"], np.float32)
    ws, gs = (np.asarray(x["scores"], np.float32) for x in (want, got))
    wc, gc = (np.asarray(x["classes"]) for x in (want, got))
    wn, gn = (np.asarray(x["num_valid"]).astype(int)
              for x in (want, got))
    B, K = ws.shape
    matched = 0
    boundary = 0
    real = 0
    max_sd = 0.0
    max_ig = 0.0

    def _iou(a, b):
        # corners [ymin, xmin, ymax, xmax]
        yx0 = np.maximum(a[:2], b[:2])
        yx1 = np.minimum(a[2:], b[2:])
        inter = np.prod(np.maximum(yx1 - yx0, 0.0))
        ua = np.prod(np.maximum(a[2:] - a[:2], 0.0))
        ub = np.prod(np.maximum(b[2:] - b[:2], 0.0))
        return inter / max(ua + ub - inter, 1e-9)

    for i in range(B):
        nw, ng = wn[i], gn[i]
        used = np.zeros(ng, bool)
        # --- pass 1: greedy class+IoU matching in score order ---
        un_w = []
        for j in range(nw):
            best, best_iou = -1, 0.0
            for k in range(ng):
                if used[k] or wc[i, j] != gc[i, k]:
                    continue
                v = _iou(wb[i, j], gb[i, k])
                if v > best_iou:
                    best, best_iou = k, v
            if best >= 0 and best_iou >= iou_min and (
                abs(ws[i, j] - gs[i, best]) <= score_tol
            ):
                used[best] = True
                matched += 1
                max_sd = max(max_sd, float(abs(ws[i, j] - gs[i, best])))
                max_ig = max(max_ig, float(1.0 - best_iou))
            else:
                un_w.append(j)
        un_g = [k for k in range(ng) if not used[k]]

        # --- pass 2: excuse selection flips among the unmatched ---
        floor_g = gs[i, ng - 1] if ng else np.inf
        floor_w = ws[i, nw - 1] if nw else np.inf
        trunc_g = ng == K
        trunc_w = nw == K

        def _excused(score, floor_other, trunc_other):
            if trunc_other and score <= floor_other + boundary_gap:
                return True
            if score_thresh is not None and (
                score <= score_thresh + boundary_gap
            ):
                return True
            return False

        flip_used_g = np.zeros(ng, bool)
        for j in un_w:
            if _excused(ws[i, j], floor_g, trunc_g):
                boundary += 1
                continue
            flipped = False
            for k in un_g:
                if flip_used_g[k] or wc[i, j] != gc[i, k]:
                    continue
                if abs(ws[i, j] - gs[i, k]) <= boundary_gap and (
                    _iou(wb[i, j], gb[i, k]) >= flip_iou
                ):
                    flip_used_g[k] = True
                    flipped = True
                    break
            if flipped:
                boundary += 2  # both sides of the flip pair
            else:
                real += 1
        for k in un_g:
            if flip_used_g[k]:
                continue
            if _excused(gs[i, k], floor_w, trunc_w):
                boundary += 1
            else:
                real += 1
    return {
        "ok": real == 0,
        "images": int(B),
        "matched": int(matched),
        "max_matched_score_diff": max_sd,
        "max_matched_iou_gap": max_ig,
        "boundary_unmatched": int(boundary),
        "real_mismatches": int(real),
    }


def preprocess_images(
    images: Sequence[np.ndarray],
    *,
    canvas: int,
    resize_mode: str = "resize_pad",
    pad_position: str = "topleft",
    normalize: str = "tf",
) -> tuple[np.ndarray, list[tuple[int, int]]]:
    """Host-side request preprocessing with the family's training geometry.
    Returns the stacked f32 batch plus each image's placed content (h, w)
    so callers can rescale boxes back to source resolution."""
    from detectax_torch.data.pipeline import normalize_pixels, place_on_canvas

    out, content_hw = [], []
    for img in images:
        placed, _, hw = place_on_canvas(
            np.asarray(img), np.zeros((0, 4), np.float32),
            (canvas, canvas), mode=resize_mode, pad_position=pad_position,
        )
        out.append(normalize_pixels(placed, normalize))
        content_hw.append(hw)
    return np.stack(out).astype(np.float32), content_hw
