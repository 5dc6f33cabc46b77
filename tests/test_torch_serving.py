"""The serving slice of the PyTorch port as a whole, on the CPU.

A tiny FCOS carries Flax-initialised weights (perturbed with numpy so that
boxes have positive extent and some scores pass the threshold) on both
sides; the port's module is filled through `from_flax`.

* decode + NMS fed the *same* level outputs on both sides must match
  exactly (classes, valid, num_valid) and to atol 1e-5 on boxes and scores
  (pixel coordinates up to ~1e2 computed by the same fp32 arithmetic, and
  scores that pass through each library's own sigmoid);
* end to end (forward included) the two differ by convolution rounding, so
  the detection *sets* are compared with `compare_detections`.
"""
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detectax.infer import export as JE
from detectax.infer import predict as JP
from detectax.models.fcos import FCOS as JFCOS
from detectax_torch.infer import export as TE
from detectax_torch.infer import predict as TP
from detectax_torch.infer.serving import Predictor
from detectax_torch.models.fcos import FCOS as TFCOS
from detectax_torch.tools import from_flax as FF

NC, CANVAS = 5, 64
DET_KEYS = ("boxes", "scores", "classes", "valid", "num_valid")


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_dets_equal(got, want, atol=1e-5):
    for key in DET_KEYS:
        g, w = _np(got[key]), _np(want[key])
        assert g.shape == w.shape, (key, g.shape, w.shape)
        if key in ("boxes", "scores"):
            np.testing.assert_allclose(g, w, rtol=0, atol=atol, err_msg=key)
        else:
            np.testing.assert_array_equal(g, w, err_msg=key)


@functools.lru_cache(maxsize=None)
def tiny_fcos(variant="fcos"):
    """(flax module, params, batch_stats, torch module) of one tiny FCOS."""
    rng = np.random.default_rng(5)
    jm = JFCOS(num_classes=NC, variant=variant, backbone="tiny")
    variables = jm.init(jax.random.key(0),
                        jnp.zeros((1, CANVAS, CANVAS, 3)), train=False)
    params = jax.tree.map(lambda x: np.array(x, np.float32),
                          jax.device_get(variables["params"]))
    stats = jax.tree.map(lambda x: np.array(x, np.float32),
                         jax.device_get(variables["batch_stats"]))
    for name, sub in params.items():
        if name.startswith("reg_head"):
            # ltrb distances around 2 cells: boxes of positive extent
            sub["Conv_0"]["bias"][:4] = 2.0
            sub["Conv_0"]["kernel"] *= 4.0
        elif name.startswith("cls_head"):
            sub["Conv_0"]["bias"][:] = -1.0
            sub["Conv_0"]["kernel"] *= 8.0
    for path, leaf in jax.tree_util.tree_leaves_with_path(stats):
        leaf[...] = (rng.normal(scale=0.1, size=leaf.shape)
                     if path[-1].key == "mean"
                     else rng.uniform(0.7, 1.4, size=leaf.shape))
    tm = FF.load_flax(TFCOS(NC, variant=variant, backbone="tiny"),
                      params, stats).eval()
    return jm, params, stats, tm


def _level_outputs(rng, batch, canvas):
    """Random level outputs [B, h, w, 5 + NC] with ties in the logits and
    negative distances (degenerate boxes)."""
    outs = []
    size = canvas // 8
    for _ in range(5):
        reg = rng.normal(loc=1.5, scale=2.0, size=(batch, size, size, 4))
        cen = rng.normal(size=(batch, size, size, 1))
        cls = np.round(rng.normal(loc=-1.0, scale=1.5,
                                  size=(batch, size, size, NC)) * 4) / 4
        outs.append(np.concatenate([reg, cen, cls], -1).astype(np.float32))
        size = -(-size // 2)
    return outs


# --------------------------------------------------------------------------
# (a) decode + NMS on the same level outputs
# --------------------------------------------------------------------------

@pytest.mark.parametrize("use_centerness", [True, False])
def test_fcos_decode_parity(rng, use_centerness):
    outs = _level_outputs(rng, 2, 64)
    wb, wp = JP.fcos_decode([jnp.asarray(o) for o in outs],
                            use_centerness=use_centerness)
    gb, gp = TP.fcos_decode([torch.from_numpy(o) for o in outs],
                            use_centerness=use_centerness)
    np.testing.assert_allclose(gb.numpy(), np.asarray(wb), rtol=0, atol=1e-5)
    np.testing.assert_allclose(gp.numpy(), np.asarray(wp), rtol=0, atol=1e-6)


def test_fcos_center_v1_decode_parity(rng):
    outs = _level_outputs(rng, 2, 64)
    scales = [32.0, 64.0, 128.0, 256.0, 64.0]
    wb, wp = JP.fcos_center_v1_decode([jnp.asarray(o) for o in outs],
                                      box_scales=scales)
    gb, gp = TP.fcos_center_v1_decode([torch.from_numpy(o) for o in outs],
                                      box_scales=scales)
    # box sizes reach 256 * reg: one fp32 ulp there is ~3e-5
    np.testing.assert_allclose(gb.numpy(), np.asarray(wb), rtol=1e-6,
                               atol=1e-5)
    np.testing.assert_allclose(gp.numpy(), np.asarray(wp), rtol=0, atol=1e-6)
    hm = TP.class_heatmap(gp[0, :64], (8, 8)).numpy()
    np.testing.assert_allclose(
        hm, np.asarray(JP.class_heatmap(wp[0, :64], (8, 8))), atol=1e-6)


DENSE_PATHS = {
    # name: (JAX kwargs, port kwargs) — the same structure on both sides
    "fused_kernel": (dict(fused=True, pallas=True),
                     dict(fused=True, kernels=True)),
    "fused_plain": (dict(fused=True, pallas=False),
                    dict(kernels="plain")),
    "two_stage_sweep": (dict(fused=False, pallas=True),
                        dict(fused=False, kernels=True)),
    "two_stage_sweep_combined": (
        dict(pallas=True, class_aware_candidates=True),
        dict(kernels="plain", class_aware_candidates=True)),
    "two_stage_matrix": (dict(fused=False, pallas=False),
                         dict(fused=False, kernels=False)),
    "cpu_default": (dict(), dict()),
    "soft": (dict(mode="soft", pallas=False), dict(mode="soft")),
}


@pytest.mark.parametrize("path", sorted(DENSE_PATHS))
def test_decode_and_detections_match_on_same_level_outputs(rng, path):
    """128 px: 341 candidates, top_k 256 >= the sweep's minimum K."""
    jkw, tkw = DENSE_PATHS[path]
    outs = _level_outputs(rng, 2, 128)
    common = dict(top_k=256, iou_thresh=0.5, score_thresh=0.05,
                  max_outputs=40)
    wb, wp = JP.fcos_decode([jnp.asarray(o) for o in outs],
                            use_centerness=False)
    want = JP.detections_from_dense(wb, wp, **common, **jkw)
    gb, gp = TP.fcos_decode([torch.from_numpy(o) for o in outs],
                            use_centerness=False)
    # the decoded candidates are the same numbers up to the sigmoid's last
    # bit; feed the JAX side's to the port so that selection sees equal
    # inputs and the outputs must agree exactly
    np.testing.assert_allclose(gp.numpy(), np.asarray(wp), rtol=0, atol=1e-6)
    got = TP.detections_from_dense(
        torch.from_numpy(np.array(wb)), torch.from_numpy(np.array(wp)),
        **common, **tkw)
    assert int(np.asarray(want["num_valid"]).min()) > 0
    assert_dets_equal(got, want, atol=1e-6 if path != "soft" else 1e-5)


# --------------------------------------------------------------------------
# (b) Predictor end to end against the jitted JAX serving graph
# --------------------------------------------------------------------------

@pytest.mark.parametrize("serving", [
    dict(),                                   # default structure
    dict(class_aware_candidates=True),        # the infer CLI's candidates
])
def test_predictor_end_to_end_matches_jax_serving_graph(rng, serving):
    jm, params, stats, tm = tiny_fcos()
    common = dict(top_k=64, max_outputs=16, score_thresh=0.05, **serving)
    jfn = jax.jit(JE.make_serving_fn(
        jm, lambda o: JP.fcos_decode(o, use_centerness=False),
        pallas=False, **common))
    images = rng.uniform(-1, 1, (5, CANVAS, CANVAS, 3)).astype(np.float32)
    want = {k: np.asarray(v) for k, v in jfn(params, stats, images).items()}

    tfn = TE.make_serving_fn(tm, TE.fcos_decode_fn("fcos", CANVAS), **common)
    pred = Predictor.for_model(tfn, tm, canvas=CANVAS, buckets=(1, 4),
                               device="cpu")
    got = pred.predict(images)
    assert got["boxes"].shape == (5, 16, 4)
    assert int(want["num_valid"].min()) > 0
    res = TE.compare_detections(want, got, score_thresh=0.05)
    assert res["real_mismatches"] == 0, res
    assert res["matched"] >= int(want["num_valid"].sum()) - \
        res["boundary_unmatched"]
    # the port's copy of the gate gives the JAX package's verdict
    assert res == JE.compare_detections(want, got, score_thresh=0.05)
    # and it does flag a real divergence
    bad = dict(got, classes=(got["classes"] + 1) % NC)
    assert not TE.compare_detections(want, bad)["ok"]


# --------------------------------------------------------------------------
# (c) bucket plan, padding, empty request, wrong canvas
# --------------------------------------------------------------------------

def _tiny_predictor(buckets, **serving):
    _, _, _, tm = tiny_fcos()
    fn = TE.make_serving_fn(tm, TE.fcos_decode_fn("fcos", CANVAS),
                            top_k=64, max_outputs=16, **serving)
    return fn, Predictor.for_model(fn, tm, canvas=CANVAS, buckets=buckets,
                                   device="cpu")


def test_predictor_bucket_plan_and_padding(rng):
    _, p = _tiny_predictor((1, 2, 4))
    assert p._plan(7) == [4, 2, 1]
    assert p._plan(3) == [2, 1]
    fn, p2 = _tiny_predictor((2, 4))
    assert p2._plan(5) == [4, 2]  # tail of 1 padded up to 2

    images = rng.uniform(-1, 1, (5, CANVAS, CANVAS, 3)).astype(np.float32)
    got = p2.predict(images)
    with torch.no_grad():
        want = fn(torch.from_numpy(images))
    for key in DET_KEYS:
        assert got[key].shape[0] == 5, key  # the pad row was dropped
    # per-image results do not depend on the chunking (atol: a conv may
    # round differently at another batch size)
    np.testing.assert_allclose(got["scores"], want["scores"].numpy(),
                               rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got["num_valid"],
                                  want["num_valid"].numpy())


def test_predictor_warmup_empty_and_wrong_shape():
    _, p = _tiny_predictor((1,))
    p.warmup()
    out = p.predict(np.zeros((0, CANVAS, CANVAS, 3), np.float32))
    assert set(out) == set(DET_KEYS)
    assert all(v.shape[0] == 0 for v in out.values())
    with pytest.raises(ValueError, match="canvas"):
        p.predict(np.zeros((1, 32, 32, 3), np.float32))
    with pytest.raises(ValueError, match="bucket"):
        Predictor({}, canvas=CANVAS)


def test_preprocess_images_matches_jax_package(rng):
    imgs = [rng.integers(0, 255, (48, 96, 3), np.uint8),
            rng.integers(0, 255, (128, 64, 3), np.uint8),
            rng.integers(0, 255, (64, 64, 3), np.uint8)]
    for kw in (dict(resize_mode="resize_pad", pad_position="topleft",
                    normalize="tf"),
               dict(resize_mode="stretch", pad_position="center",
                    normalize="unit")):
        want, want_hw = JE.preprocess_images(imgs, canvas=64, **kw)
        got, got_hw = TE.preprocess_images(imgs, canvas=64, **kw)
        assert got.dtype == np.float32 and got.shape == (3, 64, 64, 3)
        np.testing.assert_array_equal(got, want)
        assert got_hw == want_hw


# --------------------------------------------------------------------------
# (d) bundle round trip, weights file, CLI
# --------------------------------------------------------------------------

@pytest.mark.parametrize("variant", ["fcos", "center_v1"])
def test_bundle_roundtrip(rng, tmp_path, variant):
    _, _, _, tm = tiny_fcos(variant)
    serving = dict(top_k=64, max_outputs=16, class_aware_candidates=True)
    manifest = TE.save_bundle(str(tmp_path / "b"), tm, canvas=CANVAS,
                              buckets=(2, 1), **serving)
    assert manifest["buckets"] == [1, 2]
    assert (tmp_path / "b" / "manifest.json").exists()
    assert (tmp_path / "b" / "weights.npz").exists()
    with open(tmp_path / "b" / "manifest.json") as f:
        assert json.load(f)["model"]["variant"] == variant

    pred = TE.load_bundle(str(tmp_path / "b"), device="cpu")
    assert pred.canvas == CANVAS and pred.manifest["nms"]["top_k"] == 64
    images = rng.uniform(-1, 1, (3, CANVAS, CANVAS, 3)).astype(np.float32)
    got = pred.predict(images)
    live = Predictor.for_model(
        TE.make_serving_fn(tm, TE.fcos_decode_fn(variant, CANVAS), **serving),
        tm, canvas=CANVAS, buckets=(1, 2), device="cpu")
    assert_dets_equal(got, live.predict(images), atol=0)

    with pytest.raises(TypeError, match="unknown serving options"):
        TE.save_bundle(str(tmp_path / "c"), tm, canvas=CANVAS, topk=3)
    (tmp_path / "b" / "manifest.json").write_text('{"format": "other"}')
    with pytest.raises(ValueError, match="bundle"):
        TE.load_bundle(str(tmp_path / "b"), device="cpu")


def test_infer_fcos_cli_reads_weights_written_from_jax_trees(tmp_path):
    from PIL import Image

    from detectax_torch.cli import infer_fcos

    _, params, stats, _ = tiny_fcos()
    FF.save_npz(str(tmp_path / "w.npz"), params, stats)
    rng = np.random.default_rng(2)
    Image.fromarray(rng.integers(0, 255, (80, 120, 3), np.uint8)).save(
        tmp_path / "in.jpg")
    infer_fcos.main([
        "--img_file", str(tmp_path / "in.jpg"),
        "--weights", str(tmp_path / "w.npz"), "--device", "cpu",
        "--backbone", "tiny", "--num_classes", str(NC), "--img_dims", "64",
        "--cls_thresh", "0.05",
        "--heatmap_out", str(tmp_path / "hm.jpg"),
        "--detect_out", str(tmp_path / "det.jpg"),
    ])
    assert (tmp_path / "hm.jpg").stat().st_size > 0
    assert (tmp_path / "det.jpg").stat().st_size > 0
