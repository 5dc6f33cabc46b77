"""Evaluation of the port against the JAX package, on the CPU.

* `MeanAPEvaluator` and `coco_evaluator` (a copy of the JAX package's): the
  same seeded detections give the same summary, integers exactly and
  floats to 1e-12.
* `tools.from_flax.read_msgpack` against `flax.serialization` on a small
  tree of every kind Flax writes, and on the committed crop-pretrained
  ResNet-50 trunk bit for bit; `--init_backbone` takes a `.msgpack`.
* `cli.evaluate` on tiny-backbone weights converted from the JAX package
  against `detectax.cli.evaluate` on the same synthetic images, for the
  families `fcos` and `centernet_heatmap` at `top_k` >= `max_outputs`
  (the JAX CLI fails below that); the port alone at `--top_k 16`; the
  families and flags that wait for a later slice raise (the `retinanet`
  family is held against the JAX CLI in `tests/test_torch_retinanet.py`).
* `--dump_visuals` draws through the port's eval hooks, and raises at
  start-up, naming matplotlib, where it is missing.
"""
import json
import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detectax.cli import evaluate as j_evaluate
from detectax.eval import detection_metrics as JM
from detectax.models import FCOS as JFCOS
from detectax.models import CenterNetFPNSingle as JCN
from detectax.models.backbones import TinyBackbone as JTiny
from detectax_torch.cli import evaluate as t_evaluate
from detectax_torch.cli import train_fcos as t_train_fcos
from detectax_torch.eval import detection_metrics as TM
from detectax_torch.models import FCOS as TFCOS
from detectax_torch.tools import from_flax as FF
from detectax_torch.train.driver import load_backbone_weights
from detectax_torch.train.loop import create_train_state
from detectax_torch.train.schedules import make_optimizer, make_schedule

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRUNK = os.path.join(REPO, "benchmarks", "runs", "pretrain_r50",
                     "backbone.msgpack")
NC = 4


def _summaries_equal(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        if isinstance(w, dict):
            _summaries_equal(g, w)
        elif w is None or isinstance(w, (int, np.integer)):
            assert g == w, k
        else:
            assert g == pytest.approx(w, abs=1e-12), k


def _detections(rng, n_images, nc):
    out = []
    for _ in range(n_images):
        n_gt = int(rng.integers(0, 6))
        yx = rng.uniform(0, 300, (n_gt, 2))
        hw = rng.uniform(4, 150, (n_gt, 2))
        gt = np.concatenate([yx, yx + hw], -1).astype(np.float32)
        gl = rng.integers(0, nc, n_gt).astype(np.int32)
        n_det = int(rng.integers(0, 12))
        pick = rng.integers(0, max(n_gt, 1), n_det)
        jitter = rng.normal(0, 12, (n_det, 4))
        base = gt[pick] if n_gt else np.zeros((n_det, 4), np.float32)
        det = (base + jitter).astype(np.float32)
        det[:, 2:] = np.maximum(det[:, 2:], det[:, :2] + 1)
        scores = (np.round(rng.uniform(0, 1, n_det) * 64) / 64) \
            .astype(np.float32)                          # ties included
        dc = np.where(rng.uniform(size=n_det) < 0.8,
                      gl[pick] if n_gt else 0,
                      rng.integers(0, nc, n_det)).astype(np.int32)
        out.append((det, scores, dc, gt, gl))
    return out


@pytest.mark.parametrize("kind", ["voc", "coco"])
def test_evaluators_equal_the_jax_package(rng, kind):
    make_t = TM.coco_evaluator if kind == "coco" else TM.MeanAPEvaluator
    make_j = JM.coco_evaluator if kind == "coco" else JM.MeanAPEvaluator
    t_ev, j_ev = make_t(NC), make_j(NC)
    for image in _detections(rng, 40, NC):
        t_ev.add_image(*image)
        j_ev.add_image(*image)
    got, want = t_ev.summarize(), j_ev.summarize()
    _summaries_equal(got, want)
    assert 0.0 < got["mAP@0.5"] < 1.0 and got["num_images"] == 40
    np.testing.assert_array_equal(t_ev.per_class_ap(), j_ev.per_class_ap())
    r = rng.uniform(size=9)
    p = rng.uniform(size=9)
    assert TM.average_precision(r.cumsum() / 9, p) == \
        JM.average_precision(r.cumsum() / 9, p)


# --------------------------------------------------------------------------
# Flax .msgpack
# --------------------------------------------------------------------------

def _same_tree(got, want, path=""):
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            _same_tree(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (np.ndarray, np.generic)):
        assert np.asarray(got).dtype == np.asarray(want).dtype, path
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert got == want and type(got) is type(want), path


def test_msgpack_reader_against_flax(tmp_path):
    from flax import serialization

    tree = {
        "a": {"k": np.arange(6, dtype=np.float32).reshape(2, 3),
              "i": np.arange(3, dtype=np.int32),
              "b": np.array([True, False]),
              "h": np.ones((2, 2), np.float16),
              "e": np.zeros((0, 3), np.float64)},
        "n": 3, "neg": -5, "big": 2 ** 40, "s": "x" * 40, "f": 1.5,
        "l": [1, 2, "z"], "sc": np.float32(2.5), "none": None,
        "t": True, "empty": {},
    }
    path = tmp_path / "t.msgpack"
    path.write_bytes(serialization.msgpack_serialize(tree))
    want = serialization.msgpack_restore(path.read_bytes())
    _same_tree(FF.read_msgpack(str(path)), want)
    path.write_bytes(path.read_bytes() + b"\x00")
    with pytest.raises(ValueError, match="follow"):
        FF.read_msgpack(str(path))


def test_msgpack_reader_reads_the_committed_trunk_bit_for_bit():
    from flax import serialization

    with open(TRUNK, "rb") as f:
        data = f.read()
    want = serialization.msgpack_restore(data)
    params, stats = FF.load_msgpack(TRUNK)
    _same_tree({"params": params, "batch_stats": stats}, want)
    assert "stage2_block0" in params and "stem" in params


def test_init_backbone_takes_a_msgpack(tmp_path):
    """A trunk written by Flax (as the JAX package's tools write them)
    lands in the port's model exactly as `from_flax` places it."""
    from flax import serialization

    trunk = JTiny()
    variables = trunk.init(jax.random.PRNGKey(3),
                           jnp.zeros((1, 32, 32, 3)), train=False)
    variables = jax.tree.map(lambda x: np.asarray(x) + 0.5, variables)
    path = tmp_path / "tiny.msgpack"
    path.write_bytes(serialization.to_bytes(variables))
    state = create_train_state(
        TFCOS(num_classes=NC, backbone="tiny"), None,
        make_optimizer("sgd", make_schedule("constant", init_lr=1e-3)))
    load_backbone_weights(state, str(path))
    want = FF.from_flax({"TinyBackbone_0": variables["params"]},
                        {"TinyBackbone_0": variables["batch_stats"]})
    got = state.model.state_dict()
    assert want and all(torch.equal(got[k], v) for k, v in want.items())


# --------------------------------------------------------------------------
# cli.evaluate
# --------------------------------------------------------------------------

COMMON = ["--dataset", "synthetic", "--synthetic_n", "10", "--backbone",
          "tiny", "--canvas", "64", "--batch_size", "4", "--max_boxes", "8",
          "--coco_metrics"]


def _jax_weights(family, seed):
    """Seeded JAX weights of `family` (3 synthetic classes, tiny trunk):
    the regression heads' biases raised by U(1, 3) stride units, so that
    boxes reach the synthetic objects' size, and every other bias moved by
    N(0, 0.5), so that the scores spread."""
    model = {"fcos": lambda: JFCOS(num_classes=3, backbone="tiny"),
             "centernet_heatmap": lambda: JCN(num_classes=3,
                                              backbone="tiny")}[family]()
    variables = model.init(jax.random.PRNGKey(seed),
                           jnp.zeros((1, 64, 64, 3)), train=False)
    rng = np.random.default_rng(seed)

    def jitter(path, x):
        x = np.asarray(x)
        if path[-1].key != "bias":
            return x
        if any(str(p.key).startswith("reg_head") for p in path):
            return (x + rng.uniform(1, 3, x.shape)).astype(x.dtype)
        return (x + rng.normal(0, 0.5, x.shape)).astype(x.dtype)

    params = jax.tree_util.tree_map_with_path(jitter, variables["params"])
    return params, jax.tree.map(np.asarray, variables["batch_stats"])


def _recording(monkeypatch, module):
    """Record what `module`'s evaluator is given, image by image."""
    seen = []
    add = module.MeanAPEvaluator.add_image

    def add_image(self, *args):
        seen.append([np.asarray(a) for a in args])
        return add(self, *args)

    monkeypatch.setattr(module.MeanAPEvaluator, "add_image", add_image)
    return seen


@pytest.mark.parametrize("family", ["fcos", "centernet_heatmap"])
def test_evaluate_cli_equals_the_jax_cli(tmp_path, monkeypatch, family):
    """The same detections reach the evaluator image by image (classes and
    counts exactly, scores to 1e-6, boxes to 1e-4 px: float32 forwards in
    two frameworks), the same ground truth, and the summaries agree."""
    params, stats = _jax_weights(family, seed=4)
    state = types.SimpleNamespace(params=params, batch_stats=stats)
    monkeypatch.setattr(j_evaluate, "restore_for_inference",
                        lambda *a, **k: state)
    args = COMMON + ["--family", family, "--cls_thresh", "0.0"]
    j_seen = _recording(monkeypatch, JM)
    want = j_evaluate.main(args)
    FF.save_npz(str(tmp_path / "w.npz"), params, stats)
    t_seen = _recording(monkeypatch, TM)
    got = t_evaluate.main(args + ["--device", "cpu", "--weights",
                                  str(tmp_path / "w.npz"),
                                  "--out_json", str(tmp_path / "s.json")])
    _summaries_equal(got, want)
    assert got["num_images"] == 10 and len(t_seen) == len(j_seen) == 10
    for (tb, ts, tc, tg, tl), (jb, js, jc, jg, jl) in zip(t_seen, j_seen):
        assert tb.shape == jb.shape and len(tb) > 0
        np.testing.assert_array_equal(tc, jc)
        np.testing.assert_allclose(ts, js, rtol=0, atol=1e-6)
        np.testing.assert_allclose(tb, jb, rtol=0, atol=1e-4)
        np.testing.assert_array_equal(tg, jg)
        np.testing.assert_array_equal(tl, jl)
    with open(tmp_path / "s.json") as f:
        assert json.load(f)["mAP@0.5"] == got["mAP@0.5"]
    # the plain-kernel structure (fused selection) on the CPU reads the
    # same weights and gives a summary of its own shape
    plain = t_evaluate.main(args + ["--device", "cpu", "--weights",
                                    str(tmp_path / "w.npz"),
                                    "--plain_kernels"])
    assert plain["num_images"] == 10


def test_evaluate_cli_small_pool_and_checkpoint(tmp_path):
    """`--top_k 16` < `--max_outputs`: the case the JAX CLI fails on (its
    two NMS branches return 16 and 100 rows); the port reads `num_valid`
    rows of either. Also from a checkpoint the trainer wrote."""
    t_train_fcos.main(["--device", "cpu", "--backbone", "tiny", "--canvas",
                       "64", "--batch_size", "2", "--synthetic_n", "4",
                       "--max_steps", "1", "--display_step", "1",
                       "--ckpt_dir", str(tmp_path / "ckpt"),
                       "--out_dir", str(tmp_path / "out")])
    base = COMMON + ["--device", "cpu", "--ckpt_dir", str(tmp_path / "ckpt"),
                     "--cls_thresh", "0.0"]
    full = t_evaluate.main(base)
    small = t_evaluate.main(base + ["--top_k", "16"])
    for s in (full, small):
        assert s["num_images"] == 10 and 0.0 <= s["mAP@0.5"] <= 1.0
    assert small["AR@100"] <= full["AR@100"]


@pytest.mark.parametrize("argv,match", [
    (["--data_parallel"], "Parallelism")])
def test_evaluate_cli_refuses_what_waits(argv, match):
    with pytest.raises(NotImplementedError, match=match):
        t_evaluate.main(COMMON + ["--device", "cpu", *argv])
    assert set(t_evaluate.FAMILIES) == set(j_evaluate.FAMILIES)
    assert t_evaluate.TRAIN_GEOMETRY == j_evaluate.TRAIN_GEOMETRY


# --------------------------------------------------------------------------
# --dump_visuals
# --------------------------------------------------------------------------

def _train_args(tmp_path, *extra):
    return ["--device", "cpu", "--backbone", "tiny", "--canvas", "64",
            "--batch_size", "2", "--synthetic_n", "4", "--max_steps", "2",
            "--display_step", "1", "--ckpt_dir", str(tmp_path / "ckpt"),
            "--out_dir", str(tmp_path / "out"), *extra]


def test_dump_visuals_draws_on_display_steps(tmp_path):
    t_train_fcos.main(_train_args(tmp_path, "--dump_visuals"))
    drawn = sorted(os.listdir(tmp_path / "out"))
    for step in (1, 2):
        assert f"detect_{step}.jpg" in drawn
        assert f"heatmap_{step}.jpg" in drawn


def test_dump_visuals_without_matplotlib_fails_before_step_1(tmp_path,
                                                            monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(RuntimeError, match="matplotlib"):
        t_train_fcos.main(_train_args(tmp_path, "--dump_visuals"))
    assert not os.path.exists(tmp_path / "ckpt")
