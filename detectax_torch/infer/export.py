"""Serving graph, request preprocessing and the serving bundle.

Port of `detectax/infer/export.py`. `make_serving_fn` composes the full
serving graph (forward → decode → candidate select → NMS) over a live
``nn.Module``. A bundle freezes a detector for a serving host. Two
formats stand side by side:

    <dir>/manifest.json     model/geometry/NMS config + bucket list
    <dir>/weights.npz       the weights, keyed by the Flax parameter path
    <dir>/serving_b<N>.pt2  v2 only: one `torch.export` program a bucket

v1 (``save_bundle`` without ``export_device``) holds the configuration and
the weights: `load_bundle` rebuilds the module from the manifest and fills
it. v2 (``export_device`` given) also holds, for each batch bucket, the
serving graph exported by `export_detector`: ``fn(weights, images)``
with the weights as call arguments, not constants, so one weights file
serves every bucket, as in the JAX bundle. `load_bundle` replays a v2
bundle without the port's model code (no module of
`detectax_torch.models` is imported). Deviations from the JAX bundle: a
v2 program is bound to the device it was exported on (the manifest's
``device``; decode constants are baked for it), and there is no
multi-platform artifact.
"""
from __future__ import annotations

import json
import os
import time
from typing import Callable, Sequence

import numpy as np
import torch

from detectax_torch.infer import predict as P
from detectax_torch.runtime import resolve_device, set_tf32

MANIFEST_NAME = "manifest.json"
WEIGHTS_NAME = "weights.npz"
PROGRAM_NAME = "serving_b{}.pt2"
BUNDLE_FORMAT = "detectax-torch-serving-bundle-v1"
EXPORTED_FORMAT = "detectax-torch-serving-bundle-v2"

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


FAMILIES = ("fcos", "centernet_heatmap", "centernet_s8", "retinanet",
            "hourglass", "stacked_hourglass")


def _exact_device(device) -> torch.device:
    """``device`` (None: CUDA) with a CUDA index filled in."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _in_order(weights: dict) -> dict:
    """``weights`` with its keys sorted: a program reads a dict input by
    position, so the export and every call pass the keys in one order."""
    return {k: weights[k] for k in sorted(weights)}


class _ServingProgram(torch.nn.Module):
    """``fn(weights, images)`` of the serving graph: the detector applied
    with ``weights`` (its ``state_dict`` keys) by `functional_call`."""

    def __init__(self, model, decode, nms: dict):
        super().__init__()
        # not a submodule: export would lift its parameters and buffers
        # into every program as constants
        object.__setattr__(self, "detector", model)
        self.decode = decode
        self.nms = nms

    def forward(self, weights: dict, images: torch.Tensor) -> dict:
        detector = self.detector

        def apply(x, train=False):
            return torch.func.functional_call(detector, weights, (x,),
                                              {"train": train})

        return make_serving_fn(apply, self.decode, **self.nms)(images)


def export_detector(
    model: torch.nn.Module,
    decode: Callable,
    *,
    batch: int,
    canvas: int,
    device=None,
    **nms,
):
    """A `torch.export.ExportedProgram` of the serving graph
    ``fn(weights: dict[str, Tensor], images f32 [batch, canvas, canvas,
    3]) -> detections`` on ``device`` (default CUDA). ``weights`` are the
    model's ``state_dict`` entries, passed at every call: the program
    holds no parameter and no buffer. ``nms`` takes the keywords of
    `make_serving_fn`; ``fused=None`` resolves for ``device``
    (`infer.predict.resolve_fused`). The model is moved to ``device`` and
    put in eval mode."""
    dev = _exact_device(device)
    nms = dict(nms)
    nms["fused"] = P.resolve_fused(
        nms.get("fused"), dev,
        class_aware_candidates=nms.get("class_aware_candidates", False),
        kernels=nms.get("kernels"))
    model.to(dev).eval()
    weights = _in_order({k: v.detach()
                         for k, v in model.state_dict().items()})
    images = torch.zeros((batch, canvas, canvas, 3), dtype=torch.float32,
                         device=dev)
    ep = torch.export.export(_ServingProgram(model, decode, nms),
                             (weights, images), strict=False)
    sig = ep.graph_signature
    if sig.parameters or sig.buffers:
        raise RuntimeError(
            f"the exported serving graph holds {len(sig.parameters)} "
            f"parameters and {len(sig.buffers)} buffers; its weights must "
            "all be call arguments")
    # the example inputs hold the weights: a saved program keeps none
    ep.example_inputs = None
    return ep


def _model_config(model, canvas: int, center, box_scales, anchor_sizes):
    """(the manifest's ``model`` entry, its family's extra keys)."""
    family = getattr(model, "family", None)
    if family not in FAMILIES:
        raise TypeError(
            f"save_bundle takes a module of family {FAMILIES}, got "
            f"{type(model).__name__}")
    cfg = {"family": family, "num_classes": model.num_classes}
    extra = {}
    if family in ("hourglass", "stacked_hourglass"):
        cfg["n_filters"] = model.n_filters
        if family == "hourglass":
            extra["stride"] = 8
            extra["box_scales"] = [canvas / (2.0 ** x)
                                   for x in reversed(range(4))]
        else:
            cfg["n_stacks"] = model.n_stacks
            extra["stride"] = model.output_stride
        return cfg, extra
    cfg["backbone"] = model.backbone_name
    cfg["features"] = model.features
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
    return cfg, extra


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
    export_device=None,
    fused: bool | None = None,
    **nms_config,
) -> dict:
    """Write ``manifest.json`` + ``weights.npz`` for a module of one of
    `FAMILIES` (the module's ``family`` goes into the manifest).
    ``center`` belongs to FCOS, ``box_scales`` (one a slot) to
    `CenterNetS8`, ``anchor_sizes`` (one a level) to `RetinaNet`, whose
    manifest also records its head layout; a hourglass manifest records
    ``n_filters`` (and ``n_stacks``) and its decode's stride and scales.
    ``nms_config`` takes the NMS keywords of `make_serving_fn` (top_k,
    iou_thresh, score_thresh, max_outputs, class_aware,
    class_aware_candidates).

    With ``export_device`` the bundle is v2: one `export_detector` program
    a bucket exported on that device, which the manifest records beside
    the resolved ``fused`` flag (`infer.predict.resolve_fused`) and the
    host seconds each bucket's export and save took."""
    from detectax_torch.tools.from_flax import save_npz, to_flax

    unknown = set(nms_config) - set(_NMS_DEFAULTS)
    if unknown:
        raise TypeError(f"unknown serving options {sorted(unknown)}")
    if fused is not None and export_device is None:
        raise ValueError("fused is recorded by an exported (v2) bundle "
                         "only: pass export_device")
    cfg, extra = _model_config(model, canvas, center, box_scales,
                               anchor_sizes)
    manifest = {
        "format": BUNDLE_FORMAT,
        "canvas": int(canvas),
        "buckets": sorted(set(int(b) for b in buckets)),
        "model": cfg,
        **extra,
        "nms": {**_NMS_DEFAULTS, **nms_config},
        **(manifest_extra or {}),
    }
    os.makedirs(out_dir, exist_ok=True)
    if export_device is not None:
        dev = _exact_device(export_device)
        manifest["format"] = EXPORTED_FORMAT
        manifest["device"] = str(dev)
        manifest["fused"] = P.resolve_fused(
            fused, dev, class_aware_candidates=manifest["nms"][
                "class_aware_candidates"])
        decode = _decode(manifest)
        manifest["export_seconds"] = {}
        for b in manifest["buckets"]:
            t0 = time.perf_counter()
            ep = export_detector(model, decode, batch=b, canvas=canvas,
                                 device=dev, fused=manifest["fused"],
                                 **manifest["nms"])
            torch.export.save(ep, os.path.join(out_dir,
                                               PROGRAM_NAME.format(b)))
            manifest["export_seconds"][str(b)] = time.perf_counter() - t0
    params, batch_stats = to_flax(model)
    save_npz(os.path.join(out_dir, WEIGHTS_NAME), params, batch_stats)
    with open(os.path.join(out_dir, MANIFEST_NAME), "w") as f:
        json.dump(manifest, f, indent=2)
    return manifest


def _decode(manifest: dict):
    """The decode a manifest describes (no model code needed)."""
    cfg = manifest["model"]
    family = cfg["family"]
    if family == "fcos":
        return fcos_decode_fn(cfg["variant"], manifest["canvas"],
                              manifest["center"])
    if family in ("centernet_heatmap", "centernet_s8"):
        return centernet_decode_fn(family,
                                   box_scales=manifest.get("box_scales"))
    if family == "retinanet":
        return retinanet_decode_fn(manifest["anchor_sizes"])
    if family in ("hourglass", "stacked_hourglass"):
        return hourglass_decode_fn(family, canvas=manifest["canvas"],
                                   stride=manifest["stride"])
    raise ValueError(f"unsupported model family {family!r}; a bundle holds "
                     f"one of {FAMILIES}")


# the ``model`` entries each family's manifest records
_MODEL_KEYS = {
    "fcos": ("backbone", "features", "variant"),
    "centernet_heatmap": ("backbone", "features"),
    "centernet_s8": ("backbone", "features", "n_scales"),
    "retinanet": ("backbone", "features", "n_anchors", "per_anchor_heads"),
    "hourglass": ("n_filters",),
    "stacked_hourglass": ("n_filters", "n_stacks"),
}


def _model(manifest: dict):
    """The module (fresh weights) a v1 manifest describes."""
    from detectax_torch import models

    cfg = manifest["model"]
    family = cfg["family"]
    missing = [k for k in _MODEL_KEYS.get(family, ()) if k not in cfg]
    if family not in _MODEL_KEYS or missing:
        raise ValueError(
            f"unsupported model entry {cfg!r} (missing {missing}); a "
            f"bundle holds one of {FAMILIES}")
    if family == "hourglass":
        return models.HourglassNet(cfg["num_classes"],
                                   n_filters=cfg["n_filters"])
    if family == "stacked_hourglass":
        return models.StackedHourglass(cfg["num_classes"],
                                       n_filters=cfg["n_filters"],
                                       n_stacks=cfg["n_stacks"])
    common = dict(num_classes=cfg["num_classes"], backbone=cfg["backbone"],
                  features=cfg["features"])
    if family == "fcos":
        return models.FCOS(variant=cfg["variant"], **common)
    if family == "centernet_heatmap":
        return models.CenterNetFPNSingle(**common)
    if family == "centernet_s8":
        return models.CenterNetS8(n_scales=cfg["n_scales"], **common)
    return models.RetinaNet(n_anchors=cfg["n_anchors"],
                            per_anchor_heads=cfg["per_anchor_heads"],
                            **common)


def load_bundle(bundle_dir: str, device=None):
    """Rehydrate a bundle into an `infer.serving.Predictor` on ``device``
    (default CUDA). A v2 bundle replays its exported programs, and raises
    for a device other than the one it was exported on."""
    with open(os.path.join(bundle_dir, MANIFEST_NAME)) as f:
        manifest = json.load(f)
    fmt = manifest.get("format")
    if fmt == EXPORTED_FORMAT:
        return _load_exported(bundle_dir, manifest, device)
    if fmt != BUNDLE_FORMAT:
        raise ValueError(
            f"{bundle_dir}: not a {BUNDLE_FORMAT} or {EXPORTED_FORMAT} "
            f"bundle (format {fmt!r})"
        )
    from detectax_torch.infer.serving import Predictor
    from detectax_torch.tools.from_flax import load_flax, load_npz

    model = _model(manifest)
    load_flax(model, *load_npz(os.path.join(bundle_dir, WEIGHTS_NAME)))
    fn = make_serving_fn(model, _decode(manifest), **manifest["nms"])
    return Predictor.for_model(
        fn, model, canvas=manifest["canvas"], buckets=manifest["buckets"],
        device=device, manifest=manifest,
    )


def _load_exported(bundle_dir: str, manifest: dict, device):
    """A `Predictor` over a v2 bundle's programs, the weights passed to
    each call. Imports no model code."""
    # registers the detectax_torch operators the programs call
    from detectax_torch.kernels import ops  # noqa: F401
    from detectax_torch.infer.serving import Predictor
    from detectax_torch.tools.from_flax import from_flax, load_npz

    dev = _exact_device(device)
    if str(dev) != manifest["device"]:
        raise ValueError(
            f"{bundle_dir} was exported on {manifest['device']} and its "
            f"programs are bound to it; asked for {dev}")
    set_tf32(False)  # as Predictor.for_model: the fp32 serving path
    weights = _in_order({k: v.to(dev) for k, v in from_flax(
        *load_npz(os.path.join(bundle_dir, WEIGHTS_NAME))).items()})
    canvas = manifest["canvas"]
    fns = {}
    for b in manifest["buckets"]:
        program = torch.export.load(
            os.path.join(bundle_dir, PROGRAM_NAME.format(b))).module()
        # the program checks every input of a call against its spec, some
        # hundreds of weights: check once here, then call it unchecked (the
        # weights stay as they are, and `Predictor` hands every call a
        # [b, canvas, canvas, 3] float32 batch on the device)
        with torch.no_grad():
            program(weights, torch.zeros((b, canvas, canvas, 3),
                                         device=dev))
        program.validate_inputs = False

        def run(images: np.ndarray, _program=program) -> dict:
            with torch.no_grad():
                return _program(weights, torch.from_numpy(images).to(dev))

        fns[int(b)] = run
    return Predictor(fns, canvas=canvas, manifest=manifest, device=dev)


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
