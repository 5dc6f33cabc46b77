"""Exported serving bundles of the PyTorch port, on the CPU.

* the three serving kernels as custom operators (`kernels.ops`): on a CPU
  tensor each equals its plain version exactly, with and without
  ``classes`` and ``valid``, and `torch.library.opcheck` passes on each
  (schema, fake implementation, dispatch under tracing);
* `infer.export.export_detector` through a v2 bundle (`save_bundle` with
  ``export_device``, `load_bundle`) for every family `cli.evaluate` takes,
  at 64 px with tiny widths (the tiny backbone; ``n_filters`` 2 for
  `HourglassNet`, 4 with two stacks for `StackedHourglass`), one bucket of
  2: the program holds the expected ``detectax_torch`` operators and no
  parameter or buffer; its replay equals the live port graph exactly;
  and (but for the FCOS center variants, whose decodes
  ``tests/test_torch_serving.py`` holds against JAX) it matches the JAX package's jitted ``make_serving_fn`` on
  the same weights: classes, valid and num_valid exactly, boxes to 1e-5 of their
  largest magnitude, scores to 1e-6. Elementwise, and not by
  `compare_detections` (the gate of ``tests/test_torch_serving.py``):
  with random weights most kept boxes have zero clamped area, which that
  gate matches to nothing. On the CPU the fused path and the sweep are
  chosen explicitly (``fused=True``; ``kernels=True`` for the sweep),
  since their automatic choice is the CUDA one;
* `cli.export_model` end to end after 4 steps of `cli.train_fcos`, and its
  refusals: ``--platforms`` with two entries or naming another device, and
  a bundle loaded on a device other than its own.

Weights are numpy arrays in the trees `jax.eval_shape` gives (no Flax
init), crossed to the port by `tools.from_flax`.
"""
import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detectax.cli import evaluate as JEV
from detectax.infer import export as JE
from detectax.models import layers as JL
from detectax_torch.cli import evaluate as TEV
from detectax_torch.infer import export as TE
from detectax_torch.infer.serving import Predictor
from detectax_torch.kernels import nms as KN
from detectax_torch.kernels import ops as KO
from detectax_torch.kernels import peak as KP
from detectax_torch.tools import from_flax as FF


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """torch on one thread: the steps are tiny, and beside the suite's
    other workers a pool of threads a process waits on busy cores at every
    operation (tens of times slower)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


NC, CANVAS, BATCH = 3, 64, 2
DET_KEYS = ("boxes", "scores", "classes", "valid", "num_valid")
SERVING = dict(top_k=64, max_outputs=16, score_thresh=0.0)
# replay against JAX: the forwards differ by convolution rounding, so the
# boxes (pixels) agree to this share of their largest magnitude and the
# scores to a few float32 ulps of the sigmoid; the keep sets exactly
BOX_RTOL, SCORE_ATOL = 1e-5, 1e-6

# cases that go through a whole v2 bundle (save_bundle, load_bundle)
ROUNDTRIP = ("fcos", "centernet_heatmap", "hourglass")
# cases held against the live graph alone: the FCOS center variants share
# fcos's model and NMS, and tests/test_torch_serving.py holds their decodes
# against the JAX package's
LIVE_ONLY = ("fcos_center", "fcos_center_v1")
# case: (cli.evaluate family, serving options, operators in the program)
CASES = {
    "fcos": ("fcos", dict(fused=True), {"dense_nms"}),
    "fcos_candidates": ("fcos", dict(class_aware_candidates=True,
                                     kernels=True), {"nms_sweep"}),
    "fcos_center": ("fcos_center", dict(fused=True), {"dense_nms"}),
    "fcos_center_v1": ("fcos_center_v1", dict(fused=True), {"dense_nms"}),
    "centernet_heatmap": ("centernet_heatmap", dict(fused=True),
                          {"peak", "dense_nms"}),
    "centernet_s8": ("centernet_s8", dict(fused=True), {"dense_nms"}),
    "retinanet": ("retinanet", dict(fused=True), {"dense_nms"}),
    "hourglass": ("hourglass", dict(fused=True), {"dense_nms"}),
    "stacked_hourglass": ("stacked_hourglass", dict(fused=True),
                          {"dense_nms"}),
}


def _args(family):
    return types.SimpleNamespace(
        center=False, box_scales=[32.0, 64.0, 128.0, 256.0, 512.0],
        anchor_sizes=[20.0, 40.0, 80.0, 160.0, 320.0],
        n_filters=2 if family == "hourglass" else 4, n_stacks=2,
        per_anchor_heads=False)


def flax_trees(module, seed):
    """(params, batch_stats) in the trees of ``module``'s Flax variables
    (`jax.eval_shape` of its init), values from numpy: conv kernels
    LeCun-normal, biases small, BatchNorm scale one, the focal bias its
    prior, running statistics near their init."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: module.init(
        jax.random.key(0), jnp.zeros((1, CANVAS, CANVAS, 3)), train=False))

    def fill(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "kernel":
            v = rng.normal(0.0, np.sqrt(1.0 / np.prod(shape[:-1])), shape)
        elif name == "scale":
            v = np.ones(shape)
        elif name == "bias" and shape == ():
            v = np.full(shape, JL.FOCAL_BIAS)
        elif name == "bias":
            v = rng.normal(0, 0.05, shape)
        elif name == "mean":
            v = rng.normal(0.0, 0.1, shape)
        else:  # var
            v = rng.uniform(0.7, 1.3, shape)
        return np.asarray(v, np.float32)

    return (jax.tree_util.tree_map_with_path(fill, shapes["params"]),
            jax.tree_util.tree_map_with_path(fill, shapes["batch_stats"]))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _ops_in(program) -> set:
    return {str(n.target).split(".")[1] for n in program.graph.nodes
            if str(n.target).startswith("detectax_torch.")}


# --------------------------------------------------------------------------
# the custom operators
# --------------------------------------------------------------------------

def _candidates(rng, batch=2, m=300, nc=4):
    yx = rng.uniform(0, 200, (batch, m, 2))
    hw = rng.uniform(5, 60, (batch, m, 2))
    boxes = torch.from_numpy(np.concatenate([yx, yx + hw], -1)
                             .astype(np.float32))
    scores = torch.from_numpy(rng.uniform(0, 1, (batch, m))
                              .astype(np.float32))
    classes = torch.from_numpy(rng.integers(0, nc, (batch, m))
                               .astype(np.int32))
    valid = torch.from_numpy(rng.uniform(0, 1, (batch, m)) < 0.9)
    return boxes, scores, classes, valid


@pytest.mark.parametrize("with_classes", [True, False])
@pytest.mark.parametrize("with_valid", [True, False])
def test_ops_on_the_cpu_equal_the_plain_versions(rng, with_classes,
                                                 with_valid):
    boxes, scores, classes, valid = _candidates(rng)
    c = classes if with_classes else None
    v = valid if with_valid else None
    keep = torch.ops.detectax_torch.nms_sweep(boxes, 0.5, v, c)
    assert torch.equal(keep, KN.nms_sweep_plain(boxes, 0.5, v, c))
    assert torch.equal(KN.nms_sweep(boxes[0], 0.5, None if v is None
                                    else v[0], None if c is None else c[0]),
                       KN.nms_sweep_plain(boxes[0], 0.5, None if v is None
                                          else v[0],
                                          None if c is None else c[0]))
    for class_aware in (True, False):
        got = torch.ops.detectax_torch.dense_nms(
            boxes, scores, c, 0.5, 0.2, 20, class_aware)
        want = KN.dense_nms_plain(boxes, scores, c, iou_thresh=0.5,
                                  score_thresh=0.2, max_outputs=20,
                                  class_aware=class_aware)
        for t, key in zip(got, ("boxes", "scores", "classes", "valid")):
            assert torch.equal(t, want[key]), key
        wrapped = KN.dense_nms(boxes, scores, c, iou_thresh=0.5,
                               score_thresh=0.2, max_outputs=20,
                               class_aware=class_aware)
        for key in DET_KEYS:
            assert torch.equal(wrapped[key], want[key]), key
    logits = torch.from_numpy(rng.normal(0, 2, (2, 9, 7, 3))
                              .astype(np.float32))
    assert torch.equal(torch.ops.detectax_torch.peak(logits, True),
                       KP.peak_scores_plain(logits))
    assert torch.equal(torch.ops.detectax_torch.peak(logits, False),
                       KP.peak_mask_scores_plain(logits))
    assert torch.equal(KP.peak_scores(logits[0]),
                       KP.peak_scores_plain(logits[0]))


@pytest.mark.parametrize("op", ["dense_nms", "nms_sweep", "peak"])
def test_opcheck(rng, op):
    boxes, scores, classes, valid = _candidates(rng, m=40)
    args = {
        "dense_nms": [(boxes, scores, classes, 0.5, 0.1, 8, True),
                      (boxes, scores, None, 0.5, 0.1, 8, False)],
        "nms_sweep": [(boxes, 0.5, valid, classes),
                      (boxes, 0.5, None, None)],
        "peak": [(scores.reshape(2, 5, 8, 1), True),
                 (scores.reshape(2, 4, 5, 2), False)],
    }[op]
    for a in args:
        torch.library.opcheck(getattr(KO, op), a)


@pytest.mark.parametrize("op", ["dense_nms", "nms_sweep", "peak"])
def test_ops_have_a_cuda_kernel_and_a_cpu_plain_version(op):
    """Each operator dispatches to its kernel on CUDA and to its plain
    version on the CPU; it has no catch-all implementation that would run
    the plain version on a CUDA tensor."""
    name = f"detectax_torch::{op}"
    has = torch._C._dispatch_has_kernel_for_dispatch_key
    assert has(name, "CUDA") and has(name, "CPU")
    assert not has(name, "CompositeExplicitAutograd")
    assert not has(name, "CompositeImplicitAutograd")


# --------------------------------------------------------------------------
# export_detector and the v2 bundle against the live graph and JAX
# --------------------------------------------------------------------------

@pytest.mark.parametrize("case", list(CASES))
def test_exported_bundle_equals_live_graph_and_jax(rng, tmp_path, case):
    family, serving, ops = CASES[case]
    args = _args(family)
    jm, jdecode = JEV.build_family(family, NC, "tiny", CANVAS, args)
    tm, tdecode = TEV.build_family(family, NC, "tiny", CANVAS, args)
    params, stats = flax_trees(jm, seed=len(case))
    FF.load_flax(tm, params, stats).eval()
    nms = {**SERVING, **serving}
    kernels = nms.pop("kernels", None)
    fused = nms.pop("fused", None)

    out = str(tmp_path / "bundle")
    if case in ROUNDTRIP:
        # the program as a v2 bundle holds it: save_bundle, then
        # torch.export.load
        manifest = TE.save_bundle(out, tm, canvas=CANVAS, buckets=(BATCH,),
                                  export_device="cpu", fused=fused, **nms)
        program = torch.export.load(
            os.path.join(out, TE.PROGRAM_NAME.format(BATCH)))
    else:
        program = TE.export_detector(tm, tdecode, batch=BATCH, canvas=CANVAS,
                                     device="cpu", fused=fused,
                                     kernels=kernels, **nms)
    assert _ops_in(program) == ops
    assert not program.graph_signature.parameters
    assert not program.graph_signature.buffers
    # no layer casts a tensor to the dtype it already has (each cast would
    # come with an assertion node, both run at every replayed call, some
    # three a convolution); the outputs' few casts stay
    layer_casts = [n for n in program.graph.nodes
                   if str(n.target).startswith("aten.to.")
                   and n.args[0].meta["val"].dtype == n.meta["val"].dtype
                   and "models/layers.py" in n.meta.get("stack_trace", "")]
    assert not layer_casts, layer_casts[:5]

    images = rng.uniform(-1, 1, (BATCH, CANVAS, CANVAS, 3)).astype(
        np.float32)
    live_fn = TE.make_serving_fn(tm, tdecode, fused=fused, kernels=kernels,
                                 **nms)
    with torch.no_grad():
        live = live_fn(torch.from_numpy(images))
        weights = {k: tm.state_dict()[k] for k in sorted(tm.state_dict())}
        replay = program.module()(weights, torch.from_numpy(images))
    for key in DET_KEYS:
        assert torch.equal(replay[key], live[key]), key
    assert int(live["num_valid"].min()) > 0
    if case in LIVE_ONLY:
        return

    jfn = jax.jit(JE.make_serving_fn(jm, jdecode, fused=fused, pallas=False,
                                     **nms))
    want = {k: np.asarray(v) for k, v in jfn(params, stats, images).items()}
    for key in ("classes", "valid", "num_valid"):
        np.testing.assert_array_equal(_np(replay[key]), want[key],
                                      err_msg=key)
    np.testing.assert_allclose(_np(replay["scores"]), want["scores"],
                               rtol=0, atol=SCORE_ATOL)
    np.testing.assert_allclose(
        _np(replay["boxes"]), want["boxes"], rtol=0,
        atol=BOX_RTOL * float(np.abs(want["boxes"]).max()) + BOX_RTOL)

    if case in ROUNDTRIP:
        _check_bundle(out, manifest, tm, tdecode, family, fused, images)


def _check_bundle(out, manifest, tm, tdecode, family, fused, images):
    """A v2 bundle (`save_bundle` with ``export_device``) replays through
    `load_bundle` to the live `Predictor`'s detections, on its own device
    only."""
    assert manifest["format"] == TE.EXPORTED_FORMAT
    assert manifest["device"] == "cpu" and manifest["fused"] is True
    assert sorted(os.listdir(out)) == ["manifest.json", "serving_b2.pt2",
                                       "weights.npz"]
    if family == "fcos":
        # no weights in the program: below the weights file
        assert os.path.getsize(os.path.join(out, "serving_b2.pt2")) < \
            os.path.getsize(os.path.join(out, "weights.npz"))
    if family == "hourglass":
        assert manifest["model"]["n_filters"] == 2
        assert manifest["stride"] == 8
        assert manifest["box_scales"] == [8.0, 16.0, 32.0, 64.0]
    pred = TE.load_bundle(out, device="cpu")
    live = Predictor.for_model(
        TE.make_serving_fn(tm, tdecode, fused=fused, **SERVING), tm,
        canvas=CANVAS, buckets=(BATCH,), device="cpu")
    got, want = pred.predict(images[:1]), live.predict(images[:1])
    for key in DET_KEYS:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)

    with open(os.path.join(out, "manifest.json")) as f:
        m = json.load(f)
    m["device"] = "cuda:0"
    with open(os.path.join(out, "manifest.json"), "w") as f:
        json.dump(m, f)
    with pytest.raises(ValueError, match="exported on cuda:0"):
        TE.load_bundle(out, device="cpu")


def test_v1_bundle_takes_the_hourglass_families(rng, tmp_path):
    """The configuration-and-weights bundle (v1) now holds both hourglass
    families as well, and rebuilds them from the manifest."""
    for family in ("hourglass", "stacked_hourglass"):
        args = _args(family)
        tm, tdecode = TEV.build_family(family, NC, "tiny", CANVAS, args)
        tm.eval()
        out = str(tmp_path / family)
        manifest = TE.save_bundle(out, tm, canvas=CANVAS, buckets=(1,),
                                  **SERVING)
        assert manifest["format"] == TE.BUNDLE_FORMAT
        assert manifest["model"]["n_filters"] == args.n_filters
        if family == "stacked_hourglass":
            assert manifest["model"]["n_stacks"] == 2
            assert manifest["stride"] == 4
        pred = TE.load_bundle(out, device="cpu")
        live = Predictor.for_model(TE.make_serving_fn(tm, tdecode,
                                                      **SERVING),
                                   tm, canvas=CANVAS, buckets=(1,),
                                   device="cpu")
        images = rng.uniform(-1, 1, (1, CANVAS, CANVAS, 3)).astype(
            np.float32)
        got, want = pred.predict(images), live.predict(images)
        for key in DET_KEYS:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    with pytest.raises(ValueError, match="export_device"):
        TE.save_bundle(out, tm, canvas=CANVAS, fused=True)


# --------------------------------------------------------------------------
# the command line
# --------------------------------------------------------------------------

def test_export_cli_end_to_end(tmp_path):
    """4 steps of `cli.train_fcos`, then `cli.export_model --device cpu`:
    the CLI reloads its bundle and verifies it against the live graph."""
    from detectax_torch.cli import export_model, train_fcos

    train_fcos.main([
        "--device", "cpu", "--backbone", "tiny", "--canvas", "64",
        "--batch_size", "2", "--max_steps", "4", "--display_step", "2",
        "--step_save", "4", "--synthetic_n", "8", "--max_boxes", "8",
        "--ckpt_dir", str(tmp_path / "ckpt"),
        "--out_dir", str(tmp_path / "out"),
    ])
    common = ["--family", "fcos", "--backbone", "tiny", "--num_classes",
              "3", "--canvas", "64", "--ckpt_dir", str(tmp_path / "ckpt"),
              "--device", "cpu"]
    res = export_model.main(common + [
        "--out_dir", str(tmp_path / "bundle"), "--buckets", "1",
        "--top_k", "32", "--max_outputs", "16"])
    assert res["verify_max_abs_diff"] < 1e-4
    assert res["verify_detection_report"] is None
    assert res["manifest"]["fused"] is False       # auto, on the CPU
    assert res["manifest"]["family"] == "fcos"
    for name in ("manifest.json", "weights.npz", "serving_b1.pt2"):
        assert (tmp_path / "bundle" / name).exists()

    with pytest.raises(SystemExit, match="multi-platform"):
        export_model.main(common + ["--out_dir", str(tmp_path / "b2"),
                                    "--platforms", "cuda", "cpu"])
    with pytest.raises(SystemExit, match="does not name"):
        export_model.main(common + ["--out_dir", str(tmp_path / "b3"),
                                    "--platforms", "tpu"])
    assert not (tmp_path / "b2").exists() and not (tmp_path / "b3").exists()
