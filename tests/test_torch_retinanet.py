"""The RetinaNet family of the PyTorch port against the JAX package, on the
CPU.

Tiny trunks at 128 px — the smallest canvas at
which the stride-128 level has a cell — batch 2, weights from Flax through
`detectax_torch.tools.from_flax`, inputs made with numpy from a seed.

* anchors: all four functions of `ops.anchors`, exactly, the predicate on
  boxes that match only at an edge column;
* `retinanet_assign` on a crowded, a padded, an empty and a near-0.5-IoU
  batch: positive anchors, owners (labels equal the box index), classes
  and the count exactly, regression to 1e-6;
* the model's forward, shared and per-anchor heads, ``train=False`` and
  ``train=True`` (with the running statistics), to 2e-5 of the largest
  magnitude of each output level and of each statistic (the MobileNetV2
  trunk's float32 forward, both modes, is held to the same tolerance in
  `tests/test_torch_bf16.py`, beside its bf16 forward);
* `retinanet_decode` and `detections_from_dense` (two-stage on the CPU):
  keep sets and classes exactly, boxes to 1e-5;
* `retinanet_loss`: value to 1e-5 relative (a float32 sum of some 20,000
  terms in another order: 3.2e-6 seen), gradient to 5e-5 of its largest
  magnitude (`GRAD_RTOL`: XLA's own spread), away from a logit of exactly
  0 (where `jax.grad` of the JAX focal loss is not the loss's derivative);
* one train step of the trainer's configuration (SGD piecewise, clip 1);
* `cli.evaluate --family retinanet` against `detectax.cli.evaluate` on
  DetBench v2 cut to four eval images;
* `cli.train_retinanet_coco`, `cli.infer_retinanet` and the serving
  bundle on the CPU.
"""
import functools
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detectax.cli import evaluate as j_evaluate
from detectax.eval import detection_metrics as JM
from detectax.infer import predict as JP
from detectax.models import RetinaNet as JRetina
from detectax.ops import anchors as JAn
from detectax.ops import assign as JA
from detectax.train import losses as JTL
from detectax.train import loop as JLoop
from detectax.train import schedules as JS
from detectax_torch.cli import evaluate as t_evaluate
from detectax_torch.cli import infer_retinanet, train_retinanet_coco
from detectax_torch.data.index import SubsetDataset
from detectax_torch.eval import detection_metrics as TM
from detectax_torch.infer import export as TE
from detectax_torch.infer import predict as TP
from detectax_torch.models import RetinaNet as TRetina
from detectax_torch.ops import anchors as TAn
from detectax_torch.ops import assign as TA
from detectax_torch.tools import from_flax as FF
from detectax_torch.train import losses as TTL
from detectax_torch.train import loop as TLoop
from detectax_torch.train import schedules as TS
from detectax_torch.train.checkpoint import CheckpointManager

IMG, NC, BATCH = 128, 3, 2
SIZES = (20.0, 40.0, 80.0, 160.0, 320.0)   # the trainer's anchor sizes
STRIDES = (8, 16, 32, 64, 128)
FORWARD_RTOL = 2e-5
LOSS_RTOL = 1e-5   # as tests/test_torch_losses.py: sums in other orders
# XLA's CPU code for the focal gradient's exp / log / pow is not one fixed
# function: two compiles of the same JAX gradient in one test process
# (before and after another test's executables were loaded from the
# suite's compilation cache) differed by 1.4e-5 of the largest element,
# 1.1e-4 relative where (1 - p)^gamma cancels; the port is within 3.6e-7
# of either
GRAD_RTOL = 5e-5


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """torch on one thread: the shapes are tiny, and beside the suite's
    other workers a pool of threads a process waits on busy cores at every
    operation (tens of times slower). Yields the count it replaced."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield threads
    torch.set_num_threads(threads)


def _np(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _t_anchors():
    return TAn.anchor_shapes_per_level(anchor_sizes=SIZES)


def _j_anchors():
    return JAn.anchor_shapes_per_level(anchor_sizes=SIZES)


# --------------------------------------------------------------------------
# anchors
# --------------------------------------------------------------------------

@pytest.mark.parametrize("sizes", [JAn.DEFAULT_SIZES, SIZES,
                                   (300.0, 30.0, 10.0, 64.0, 128.0)])
def test_anchor_shapes_and_boxes_equal_the_jax_package(sizes):
    """Outer loop over ratios, inner over scales, areas sorted; centres
    at ``k * stride``."""
    want = JAn.anchor_shapes_per_level(anchor_sizes=sizes)
    got = TAn.anchor_shapes_per_level(anchor_sizes=sizes)
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == (9, 2)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for (hm, wm, stride), g, w in zip(((16, 16, 8), (5, 3, 16), (1, 1, 128)),
                                      got, want):
        np.testing.assert_array_equal(
            TAn.anchor_boxes_level(hm, wm, stride, g).numpy(),
            np.asarray(JAn.anchor_boxes_level(hm, wm, stride, w)))


def test_decode_anchor_regression_equals_the_jax_package(rng):
    ab = np.asarray(JAn.anchor_boxes_level(8, 8, 16, _j_anchors()[1]))
    ab = np.broadcast_to(ab, (2,) + ab.shape)
    reg = rng.normal(size=ab.shape).astype(np.float32)
    reg[..., 2:] = np.exp(reg[..., 2:])
    want = np.asarray(JAn.decode_anchor_regression(jnp.asarray(reg),
                                                   jnp.asarray(ab)))
    got = TAn.decode_anchor_regression(torch.from_numpy(reg),
                                       torch.from_numpy(ab.copy()))
    np.testing.assert_array_equal(got.numpy(), want)


def test_has_anchor_targets_equals_the_jax_package(rng):
    """Random images, an empty one, and boxes that an anchor of the x = 0
    column matches while no anchor matches their mirror image (that
    column's mirror lands off the grid): True unflipped, False overall."""
    canvas = (IMG, IMG)
    cases = [np.zeros((0, 4), np.float32)]
    for _ in range(40):
        n = int(rng.integers(1, 4))
        c = rng.uniform(0.1, 0.9, (n, 2))
        s = rng.uniform(0.02, 0.6, (n, 2))
        cases.append(np.concatenate([c - s / 2, c + s / 2], -1)
                     .astype(np.float32))
    # a 16x16 px box centred on the (y=64, x=0) anchors of size 20; its
    # mirror is centred on x = 128, off the grid, where no anchor reaches
    # IoU 0.5
    edge = np.array([[-8.0, 56.0, 8.0, 72.0]], np.float32) / IMG
    cases.append(edge)
    for boxes in cases:
        want = JAn.has_anchor_targets_np(boxes, canvas, anchor_sizes=SIZES)
        got = TAn.has_anchor_targets_np(boxes, canvas, anchor_sizes=SIZES)
        assert got == want, boxes
    mirror = np.stack([1 - edge[:, 2], edge[:, 1], 1 - edge[:, 0],
                       edge[:, 3]], -1)
    assert not TAn.has_anchor_targets_np(edge, canvas, anchor_sizes=SIZES)
    assert not TAn.has_anchor_targets_np(mirror, canvas, anchor_sizes=SIZES)
    # the unflipped orientation alone has a positive: the predicate refuses
    # it for the mirror only
    shapes = TAn.anchor_shapes_per_level(anchor_sizes=SIZES)[0].numpy()
    a = TAn.anchor_boxes_level(IMG // 8, IMG // 8, 8,
                               torch.from_numpy(shapes)).reshape(-1, 4)
    from detectax_torch.ops.boxes import pairwise_iou_center
    gt = torch.tensor([[64.0, 0.0, 16.0, 16.0]])
    assert bool((pairwise_iou_center(gt, a) > 0.5).any())
    assert sum(bool(TAn.has_anchor_targets_np(b, canvas, anchor_sizes=SIZES))
               for b in cases[1:-1]) > 10


# --------------------------------------------------------------------------
# assignment
# --------------------------------------------------------------------------

def _gt(rng, case, n=6):
    """A padded GT batch [2, n, 4] (normalized y, x, h, w), labels equal
    to the box index (so a class names its owner) and the valid mask."""
    cy = rng.uniform(0.3, 0.7, (BATCH, n))
    cx = rng.uniform(0.3, 0.7, (BATCH, n))
    h = rng.uniform(0.1, 0.6, (BATCH, n))
    w = rng.uniform(0.1, 0.6, (BATCH, n))
    valid = np.ones((BATCH, n), bool)
    if case == "crowded":        # many overlapping boxes, one duplicate
        cy[:, 1], cx[:, 1], h[:, 1], w[:, 1] = cy[:, 0], cx[:, 0], h[:, 0], \
            w[:, 0]
    elif case == "padded":
        valid[0, 2:] = False
        valid[1, 4:] = False
    elif case == "empty":
        valid[:] = False
    elif case == "near_half":
        # boxes centred on anchors, sized so that their IoU with the
        # anchor of size 40 (ratio 1, scale 1) is ~0.5 from either side
        side = 40.0 * np.sqrt(2.0) * (1.0 + rng.uniform(-3e-7, 3e-7,
                                                       (BATCH, n)))
        cy = rng.integers(2, 14, (BATCH, n)) * 8.0 / IMG
        cx = rng.integers(2, 14, (BATCH, n)) * 8.0 / IMG
        h = w = side / IMG
    boxes = np.stack([cy, cx, h, w], -1).astype(np.float32)
    labels = np.broadcast_to(np.arange(n, dtype=np.int32), (BATCH, n)).copy()
    return boxes, labels, valid


@pytest.mark.parametrize("case", ["crowded", "padded", "empty",
                                  "near_half"])
def test_retinanet_assign_equals_the_jax_package(rng, case):
    n = 6
    boxes, labels, valid = _gt(rng, case, n)

    def j_one(b, l, v):
        return JA.retinanet_assign(b, l, v, img_dim=(IMG, IMG),
                                   num_classes=n,
                                   anchors_per_level=_j_anchors())

    # eager, operation by operation: XLA's fused CPU code contracts a
    # multiply and an add into one rounding, which moves an IoU on the
    # threshold by an ulp (the near-0.5 case: 2 matches of 119)
    want, want_n = jax.vmap(j_one)(
        jnp.asarray(boxes), jnp.asarray(labels), jnp.asarray(valid))
    got, got_n = TA.retinanet_assign(
        torch.from_numpy(boxes), torch.from_numpy(labels),
        torch.from_numpy(valid), img_dim=(IMG, IMG), num_classes=n,
        anchors_per_level=_t_anchors())
    np.testing.assert_array_equal(got_n.numpy(), np.asarray(want_n))
    positives = 0
    for lvl, (g, w) in enumerate(zip(got, want)):
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == w.shape == (BATCH, IMG // STRIDES[lvl],
                                      IMG // STRIDES[lvl], 9, 4 + n)
        np.testing.assert_array_equal(g[..., 4:], w[..., 4:],
                                      err_msg=f"classes, level {lvl}")
        np.testing.assert_allclose(g[..., :4], w[..., :4], rtol=0,
                                   atol=1e-6, err_msg=f"reg, level {lvl}")
        positives += int(g[..., 4:].sum())
    if case == "empty":
        assert positives == 0 and int(got_n.sum()) == 0
    else:
        assert positives > 0
        # the count is of (box, anchor) pairs: at least the positives
        assert int(got_n.sum()) >= positives


# --------------------------------------------------------------------------
# the model
# --------------------------------------------------------------------------

def _variables(backbone, per_anchor_heads, seed=0):
    rng = np.random.default_rng(seed)
    jm = JRetina(num_classes=NC, backbone=backbone,
                 per_anchor_heads=per_anchor_heads)
    v = jm.init(jax.random.key(seed), jnp.zeros((1, IMG, IMG, 3)),
                train=False)
    params = _np(v["params"])
    stats = jax.tree.map(
        lambda x: np.asarray(x) + rng.uniform(0.0, 0.3, np.shape(x))
        .astype(np.float32), _np(v["batch_stats"]))
    return jm, params, stats


@pytest.mark.parametrize("backbone,per_anchor_heads", [
    ("tiny", False), ("tiny", True)])
def test_forward_equals_the_jax_package(rng, backbone, per_anchor_heads):
    jm, params, stats = _variables(backbone, per_anchor_heads)
    images = rng.uniform(-1, 1, (BATCH, IMG, IMG, 3)).astype(np.float32)
    tm = FF.load_flax(
        TRetina(num_classes=NC, backbone=backbone,
                per_anchor_heads=per_anchor_heads), params, stats)
    n_head_convs = sum(1 for k in tm.state_dict()
                       if k.endswith("Conv_0.weight") and "_head_" in k)
    assert n_head_convs == (90 if per_anchor_heads else 10)
    for train in (False, True):
        apply = jax.jit(functools.partial(
            jm.apply, train=train,
            mutable=["batch_stats"] if train else False))
        want = apply({"params": params, "batch_stats": stats},
                     jnp.asarray(images))
        if train:
            want, mutated = want
        with torch.no_grad():
            got = tm(torch.from_numpy(images), train=train)
        assert len(got) == 5
        for lvl, (g, w) in enumerate(zip(got, want)):
            w = np.asarray(w)
            assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
            assert w.shape[1:] == (IMG // STRIDES[lvl],) * 2 + (9, 4 + NC)
            err = float(np.abs(g.numpy() - w).max())
            assert err <= FORWARD_RTOL * float(np.abs(w).max()), \
                (train, lvl, err)
        if train:
            got_stats = FF.to_flax(tm)[1]
            for (k, g), (_, w) in zip(_leaves(got_stats),
                                      _leaves(_np(mutated["batch_stats"]))):
                err = float(np.abs(g - w).max())
                assert err <= FORWARD_RTOL * float(np.abs(w).max()), (k, err)


def _leaves(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _leaves(tree[k], f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(tree[k])


# --------------------------------------------------------------------------
# decode and NMS
# --------------------------------------------------------------------------

def _outputs(rng):
    """Random level maps [2, h, w, 9, 4 + NC]: regression around the
    anchors, logits spread over the thresholds."""
    outs = []
    for s in STRIDES:
        h = IMG // s
        o = rng.normal(0.0, 0.3, (BATCH, h, h, 9, 4 + NC)).astype(np.float32)
        o[..., 2:4] = np.exp(o[..., 2:4])
        o[..., 4:] = rng.normal(-1.0, 1.5, o[..., 4:].shape)
        outs.append(o)
    return outs


@pytest.mark.parametrize("config", ["evaluate", "infer"])
def test_decode_and_nms_equal_the_jax_package(rng, config):
    """`evaluate`: class-aware, score 0.05, 100 outputs; `infer`:
    class-agnostic, score 0.30, 200 outputs (`cli.infer_retinanet`)."""
    outs = _outputs(rng)
    jb, jp = JP.retinanet_decode([jnp.asarray(o) for o in outs],
                                 anchors_per_level=_j_anchors())
    tb, tp = TP.retinanet_decode([torch.from_numpy(o) for o in outs],
                                 anchors_per_level=_t_anchors())
    m = 9 * sum((IMG // s) ** 2 for s in STRIDES)
    assert tuple(tb.shape) == (BATCH, m, 4) and tuple(tp.shape) == (
        BATCH, m, NC)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=0,
                               atol=1e-6)
    kw = (dict(score_thresh=0.05, max_outputs=100) if config == "evaluate"
          else dict(score_thresh=0.30, max_outputs=200, class_aware=False))
    want = JP.detections_from_dense(jb, jp, **kw)
    got = TP.detections_from_dense(tb, tp, **kw)
    for key in ("classes", "valid", "num_valid"):
        np.testing.assert_array_equal(got[key].numpy(),
                                      np.asarray(want[key]), err_msg=key)
    np.testing.assert_allclose(got["boxes"].numpy(),
                               np.asarray(want["boxes"]), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["scores"].numpy(),
                               np.asarray(want["scores"]), rtol=0, atol=1e-6)
    assert int(got["num_valid"].min()) > 0


# --------------------------------------------------------------------------
# the loss and one train step
# --------------------------------------------------------------------------

def test_loss_and_gradient_equal_the_jax_package(rng):
    boxes, labels, valid = _gt(rng, "padded")
    labels = labels % NC
    y_true = [np.asarray(y) for y in jax.jit(jax.vmap(
        lambda b, l, v: JA.retinanet_assign(
            b, l, v, img_dim=(IMG, IMG), num_classes=NC,
            anchors_per_level=_j_anchors())[0]))(
        jnp.asarray(boxes), jnp.asarray(labels), jnp.asarray(valid))]
    y_pred = [rng.normal(0.0, 2.0, y.shape).astype(np.float32)
              for y in y_true]
    for y in y_pred:   # away from a logit of exactly 0
        y[np.abs(y) < 1e-3] = 0.5

    def j_total(preds):
        return JTL.retinanet_loss([jnp.asarray(y) for y in y_true],
                                  preds)["total"]

    want = jax.jit(JTL.retinanet_loss)([jnp.asarray(y) for y in y_true],
                                       [jnp.asarray(y) for y in y_pred])
    want_grad = jax.jit(jax.grad(j_total))([jnp.asarray(y) for y in y_pred])
    for kernels in (None, "plain"):
        preds = [torch.from_numpy(y).requires_grad_(True) for y in y_pred]
        got = TTL.retinanet_loss([torch.from_numpy(y) for y in y_true],
                                 preds, kernels=kernels)
        assert set(got) == set(want) == {"cls", "reg", "total", "num_pos"}
        for k in want:
            np.testing.assert_allclose(float(got[k]), float(want[k]),
                                       rtol=LOSS_RTOL, err_msg=k)
        assert float(got["num_pos"]) > 0
        grads = torch.autograd.grad(got["total"], preds)
        for g, w in zip(grads, want_grad):
            w = np.asarray(w)
            np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                       atol=GRAD_RTOL * np.abs(w).max())


def test_train_step_of_the_cli_configuration_equals_the_jax_step(rng):
    """SGD-momentum, piecewise lr 1e-2 with a drop at step 1, clip 1,
    `retinanet_assign` and `retinanet_loss`: two steps, metrics to 1e-4,
    parameters and momentum to 2e-6."""
    anchors_j, anchors_t = _j_anchors(), _t_anchors()
    sched = dict(init_lr=1e-2, boundaries=[1], scales=[0.1])

    def j_assign(b, l, v):
        return JA.retinanet_assign(b, l, v, img_dim=(IMG, IMG),
                                   num_classes=NC,
                                   anchors_per_level=anchors_j)[0]

    def t_assign(b, l, v):
        return TA.retinanet_assign(b, l, v, img_dim=(IMG, IMG),
                                   num_classes=NC,
                                   anchors_per_level=anchors_t)[0]

    jmodel = JRetina(num_classes=NC, backbone="tiny")
    jopt = JS.make_optimizer("sgd", JS.make_schedule("piecewise", **sched),
                             grad_clip=1.0)
    jstep = JLoop.make_train_step(jmodel, j_assign, JTL.retinanet_loss,
                                  jopt, donate=False, jit=True)
    jstate = JLoop.create_train_state(
        jmodel, jax.random.PRNGKey(0), jnp.zeros((BATCH, IMG, IMG, 3)),
        jopt)
    tmodel = TRetina(num_classes=NC, backbone="tiny")
    topt = TS.make_optimizer("sgd", TS.make_schedule("piecewise", **sched),
                             grad_clip=1.0)
    tstep = TLoop.make_train_step(tmodel, t_assign, TTL.retinanet_loss,
                                  topt)
    tstate = TLoop.create_train_state(tmodel, None, topt)
    FF.load_train_state(tstate, _np(jstate.params),
                        _np(jstate.batch_stats),
                        opt_state=_np(jstate.opt_state),
                        step=int(jstate.step))
    for n in (1, 2):
        boxes, labels, valid = _gt(rng, "padded")
        batch = {"images": rng.normal(size=(BATCH, IMG, IMG, 3))
                 .astype(np.float32), "boxes": boxes,
                 "labels": labels % NC, "valid": valid}
        jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        tstate, tm = tstep(tstate, batch)
        assert set(tm) == set(jm)
        for k in jm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=1e-4, err_msg=f"{k} step {n}")
    assert float(tm["num_pos"]) > 0
    params, stats = FF.to_flax(tstate.model)
    for (k, g), (_, w) in zip(_leaves(params), _leaves(_np(jstate.params))):
        np.testing.assert_allclose(g, w, rtol=0, atol=2e-6, err_msg=k)
    trace = FF._optax_fields(_np(jstate.opt_state))["trace"]
    for (k, g), (_, w) in zip(_leaves(FF.opt_to_flax(tstate)["trace"]),
                              _leaves(trace)):
        np.testing.assert_allclose(g, w, rtol=0, atol=2e-6, err_msg=k)


# --------------------------------------------------------------------------
# the command-line entry points and the bundle
# --------------------------------------------------------------------------

def _cut_detbench(monkeypatch, tmp_path, n_train=4, n_eval=4):
    """Both packages' DetBench v2 cut to a few images, cached under the
    test's directory."""
    from detectax.data import detbench as JD
    from detectax_torch.data import detbench as TD

    for mod in (JD, TD):
        full = mod.load_spec

        def small(*a, _full=full, **k):
            return dict(_full(*a, **k), n_train=n_train, n_eval=n_eval)

        monkeypatch.setattr(mod, "load_spec", small)
    monkeypatch.setenv("DETECTAX_DETBENCH_CACHE", str(tmp_path / "cache"))


def _recording(monkeypatch, module):
    seen = []
    add = module.MeanAPEvaluator.add_image

    def add_image(self, *args):
        seen.append([np.asarray(a) for a in args])
        return add(self, *args)

    monkeypatch.setattr(module.MeanAPEvaluator, "add_image", add_image)
    return seen


def test_evaluate_cli_equals_the_jax_cli_on_detbench_v2(tmp_path,
                                                         monkeypatch):
    """Detections image by image (classes exactly, scores to 1e-6, boxes
    to 1e-4 px + 2e-6 relative: the anchor decode scales the forwards'
    float32 differences by anchor sides of up to 450 px), the same ground
    truth, equal summaries."""
    _cut_detbench(monkeypatch, tmp_path)
    jm = JRetina(num_classes=8, backbone="tiny")
    v = jm.init(jax.random.key(3), jnp.zeros((1, IMG, IMG, 3)), train=False)
    rng = np.random.default_rng(3)

    def jitter(path, x):
        x = np.asarray(x)
        if path[-1].key != "bias":
            return x
        return (x + rng.normal(0, 0.5, x.shape)).astype(x.dtype)

    params = jax.tree_util.tree_map_with_path(jitter, v["params"])
    stats = _np(v["batch_stats"])
    monkeypatch.setattr(
        j_evaluate, "restore_for_inference",
        lambda *a, **k: types.SimpleNamespace(params=params,
                                              batch_stats=stats))
    args = ["--family", "retinanet", "--dataset", "detbench_v2",
            "--backbone", "tiny", "--canvas", str(IMG), "--batch_size", "2",
            "--coco_metrics", "--cls_thresh", "0.0"]
    j_seen = _recording(monkeypatch, JM)
    want = j_evaluate.main(args)
    FF.save_npz(str(tmp_path / "w.npz"), params, stats)
    t_seen = _recording(monkeypatch, TM)
    got = t_evaluate.main(args + ["--device", "cpu", "--weights",
                                  str(tmp_path / "w.npz")])
    assert got["num_images"] == want["num_images"] == 4
    assert len(t_seen) == len(j_seen) == 4
    for (tb, ts, tc, tg, tl), (jb, js, jc, jg, jl) in zip(t_seen, j_seen):
        assert tb.shape == jb.shape and len(tb) > 0
        np.testing.assert_array_equal(tc, jc)
        np.testing.assert_allclose(ts, js, rtol=0, atol=1e-6)
        np.testing.assert_allclose(tb, jb, rtol=2e-6, atol=1e-4)
        np.testing.assert_array_equal(tg, jg)
        np.testing.assert_array_equal(tl, jl)
    assert set(got) == set(want)
    for k, w in want.items():
        if isinstance(w, dict):
            assert got[k] == pytest.approx(w, abs=1e-12), k
        else:
            assert got[k] == pytest.approx(w, abs=1e-12), k


def _image_file(tmp_path):
    from PIL import Image

    path = tmp_path / "in.jpg"
    Image.fromarray(np.random.default_rng(2).integers(
        0, 255, (90, 120, 3), np.uint8)).save(path)
    return str(path)


def test_train_cli_skips_images_without_anchor_matches(tmp_path,
                                                       monkeypatch, capsys):
    """The trainer filters DetBench v2 (cut to 8 training images) with the
    predicate, as the JAX trainer does, trains two steps (its eval hook
    drawing on each) and the infer CLI serves its checkpoint, at 1x and
    at --high_res."""
    _cut_detbench(monkeypatch, tmp_path, n_train=8)
    from detectax_torch.data.detbench import DetBenchDataset, load_spec

    ds = DetBenchDataset("train", spec=load_spec(name="detbench_v2"))
    sizes = [4.0, 8.0, 16.0, 32.0, 64.0]
    keep = [i for i in range(len(ds)) if TAn.has_anchor_targets_np(
        ds[i]["boxes_xyxy"], (IMG, IMG), anchor_sizes=sizes)]
    assert 0 < len(keep)
    summary = train_retinanet_coco.main([
        "--device", "cpu", "--dataset", "detbench_v2", "--backbone", "tiny",
        "--canvas", str(IMG), "--batch_size", "2", "--max_steps", "2",
        "--display_step", "1", "--anchor_sizes", *map(str, sizes),
        "--lr_boundaries", "1", "--loss_norm", "pos", "--dump_visuals",
        "--ckpt_dir", str(tmp_path / "ckpt"),
        "--out_dir", str(tmp_path / "out")])
    out = capsys.readouterr().out
    dropped = 8 - len(keep)
    assert (f"excluded {dropped}/8" in out) == (dropped > 0)
    assert summary["final_step"] == 2 and np.isfinite(summary["total"])
    assert CheckpointManager(str(tmp_path / "ckpt")).latest_step() == 2
    # the eval hook drew on both display steps
    assert {"detect_1.jpg", "detect_2.jpg"} <= set(os.listdir(
        tmp_path / "out"))
    for extra in ((), ("--high_res",)):
        dets = infer_retinanet.main([
            "--img_file", _image_file(tmp_path), "--device", "cpu",
            "--backbone", "tiny", "--num_classes", "8", "--img_dims",
            str(IMG), "--cls_thresh", "0.0", "--anchor_sizes",
            *map(str, sizes), "--ckpt_dir", str(tmp_path / "ckpt"),
            "--heatmap_out", str(tmp_path / "hm.jpg"),
            "--detect_out", str(tmp_path / "det.jpg"), *extra])
        assert dets["boxes"].shape == (1, 200, 4)
        assert int(dets["num_valid"][0]) > 0
        assert (tmp_path / "hm.jpg").stat().st_size > 0
    assert "detections ->" in capsys.readouterr().out


def test_subset_dataset_keeps_the_class_metadata():
    from detectax_torch.data.synthetic import SyntheticDataset

    ds = SyntheticDataset(n=5, img_size=64)
    sub = SubsetDataset(ds, [3, 1])
    assert len(sub) == 2 and sub.num_classes == ds.num_classes
    assert sub.id_to_label == ds.id_to_label
    np.testing.assert_array_equal(sub[0]["boxes_xyxy"], ds[3]["boxes_xyxy"])


@pytest.mark.parametrize("per_anchor_heads", [False, True])
def test_bundle_round_trip(tmp_path, rng, per_anchor_heads):
    _, params, stats = _variables("tiny", per_anchor_heads)
    tm = FF.load_flax(TRetina(num_classes=NC, backbone="tiny",
                              per_anchor_heads=per_anchor_heads),
                      params, stats).eval()
    nms = dict(score_thresh=0.0, max_outputs=20)
    manifest = TE.save_bundle(str(tmp_path / "b"), tm, canvas=IMG,
                              buckets=(3,), anchor_sizes=SIZES, **nms)
    assert manifest["anchor_sizes"] == list(SIZES)
    assert manifest["model"]["per_anchor_heads"] == per_anchor_heads
    assert manifest["model"]["n_anchors"] == 9
    with pytest.raises(ValueError, match="anchor_sizes"):
        TE.save_bundle(str(tmp_path / "c"), tm, canvas=IMG)
    images = rng.uniform(-1, 1, (3, IMG, IMG, 3)).astype(np.float32)
    got = TE.load_bundle(str(tmp_path / "b"), device="cpu").predict(images)
    fn = TE.make_serving_fn(tm, TE.retinanet_decode_fn(SIZES), **nms)
    with torch.no_grad():
        want = fn(torch.from_numpy(images))
    for k in ("boxes", "scores", "classes", "num_valid"):
        np.testing.assert_array_equal(got[k], want[k].numpy(), err_msg=k)
    assert int(got["num_valid"].min()) > 0
