"""The ResNet-backbone CenterNet slice of the PyTorch port against the JAX
package, on the CPU, module by module and as a whole.

Small sizes (tiny / MobileNetV2 backbones, 64 px, 3 classes). Inputs are
made with numpy from a seed and handed to both sides; weights are made by
Flax, perturbed with numpy and converted with
`detectax_torch.tools.from_flax`. Where the JAX function reaches the Pallas
peak kernel it runs in interpret mode (`use_pallas=True` on the CPU), as
the JAX package's own tests run it.

Tolerances: module outputs atol 1e-5 (float32 convolutions summed in
another order); decoded boxes atol 1e-5, scores 1e-6 (each library's own
sigmoid), the zero pattern of the peak-masked scores exact; assigners:
class one-hots, ownership and forced-1.0 cells exact, floats atol 1e-6;
loss value rtol 1e-5 and gradient atol 1e-6; parameters, BatchNorm
statistics and momentum after 1 and 3 train steps atol 2e-6, metrics rtol
1e-4 (as `tests/test_torch_train.py`, SGD-momentum under clip 1.0; Adam is
held against optax there, and an Adam step's size does not shrink with the
gradient, so a parameter-level comparison would measure the sign of
gradients near zero).
"""
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detectax.infer import predict as JP
from detectax.models import centernet as JC
from detectax.models.fpn import S8CollapseFPN as JS8FPN
from detectax.ops import assign as JA
from detectax.train import loop as JLoop
from detectax.train import losses as JTL
from detectax.train import schedules as JS
from detectax_torch.cli import (
    infer_centernet,
    train_centernet_crowdhuman,
    train_centernet_heatmap,
)
from detectax_torch.infer import export as TE
from detectax_torch.infer import predict as TP
from detectax_torch.infer.serving import Predictor
from detectax_torch.models import centernet as TC
from detectax_torch.models.fpn import S8CollapseFPN as TS8FPN
from detectax_torch.ops import assign as TA
from detectax_torch.tools import from_flax as FF
from detectax_torch.train import loop as TLoop
from detectax_torch.train import losses as TTL
from detectax_torch.train import schedules as TS
from detectax_torch.train.checkpoint import CheckpointManager


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """torch on one thread: the steps are tiny, and beside the suite's
    other workers a pool of threads a process waits on busy cores at every
    operation (tens of times slower). Yields the count it replaced."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield threads
    torch.set_num_threads(threads)


@pytest.fixture
def _process_threads(_one_thread):
    """The process's own thread count for one test: the CPU convolutions'
    backward sums in an order the thread count sets, and the three-step
    parity below holds its 2e-6 at the count it was written under."""
    torch.set_num_threads(_one_thread)
    yield
    torch.set_num_threads(1)


NC, IMG, BATCH = 3, 64, 4
SCALES = (16.0, 32.0, 64.0)
MODEL_ATOL = 1e-5
PARAM_ATOL, METRIC_RTOL = 2e-6, 1e-4
DET_KEYS = ("boxes", "scores", "classes", "valid", "num_valid")


def _numpy_tree(tree):
    return jax.tree.map(lambda x: np.array(x), jax.device_get(tree))


def _leaves(tree, prefix=""):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v)


def _assert_trees_close(got, want, atol, what):
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert set(got) == set(want), what
    for k in want:
        assert got[k].shape == want[k].shape, (what, k)
        np.testing.assert_allclose(got[k], want[k], atol=atol, rtol=0,
                                   err_msg=f"{what}: {k}")


def _perturbed(variables, rng):
    """Flax variables as numpy trees with non-trivial BatchNorm parameters
    and statistics and non-zero conv biases."""
    params = _numpy_tree(variables["params"])
    stats = _numpy_tree(variables.get("batch_stats", {}))

    def walk(tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v)
            elif k == "scale":
                v[...] = rng.uniform(0.5, 1.5, v.shape)
            elif k == "bias":
                v += rng.normal(scale=0.1, size=v.shape).astype(np.float32)
            elif k == "mean":
                v[...] = rng.normal(scale=0.2, size=v.shape)
            elif k == "var":
                v[...] = rng.uniform(0.5, 2.0, v.shape)

    walk(params)
    walk(stats)
    return params, stats


def _jmodel(kind, backbone="tiny", **kw):
    if kind == "heatmap":
        return JC.CenterNetFPNSingle(num_classes=NC, backbone=backbone, **kw)
    return JC.CenterNetS8(num_classes=NC, n_scales=len(SCALES),
                          backbone=backbone, **kw)


def _tmodel(kind, backbone="tiny", **kw):
    if kind == "heatmap":
        return TC.CenterNetFPNSingle(num_classes=NC, backbone=backbone, **kw)
    return TC.CenterNetS8(num_classes=NC, n_scales=len(SCALES),
                          backbone=backbone, **kw)


@functools.lru_cache(maxsize=None)
def _pair(kind, backbone="tiny", serving=False):
    """(flax module, params, batch_stats, torch module in eval mode) with
    the same weights. ``serving`` shapes the heads so that boxes have
    positive extent and a few clear peaks pass the threshold."""
    rng = np.random.default_rng(7)
    jm = _jmodel(kind, backbone)
    variables = jm.init(jax.random.key(0), jnp.zeros((1, IMG, IMG, 3)),
                        train=False)
    params, stats = _perturbed(variables, rng)
    if serving:
        for name, sub in params.items():
            if name.startswith("reg_head"):
                sub["Conv_0"]["kernel"] *= 4.0
                sub["Conv_0"]["bias"][:4] = 2.0 if kind == "heatmap" else 0.0
            elif name.startswith("cls_head"):
                sub["Conv_0"]["kernel"] *= 8.0
                sub["Conv_0"]["bias"][:] = 0.5
    tm = FF.load_flax(_tmodel(kind, backbone), params, stats).eval()
    return jm, params, stats, tm


# --------------------------------------------------------------------------
# the neck and the two models
# --------------------------------------------------------------------------

@pytest.mark.parametrize("sizes", [(8, 4, 2), (9, 5, 3), (12, 6, 3)],
                         ids=["even", "odd", "mixed"])
def test_s8_collapse_fpn_matches_jax(rng, sizes):
    chans = {"c3": 5, "c4": 6, "c5": 7}
    taps = {k: rng.normal(size=(2, s, s, chans[k])).astype(np.float32)
            for k, s in zip(("c3", "c4", "c5"), sizes)}
    jm = JS8FPN(features=8)
    variables = jm.init(jax.random.key(1),
                        {k: jnp.asarray(v) for k, v in taps.items()})
    params, _ = _perturbed(variables, rng)
    want = np.asarray(jm.apply({"params": params},
                               {k: jnp.asarray(v) for k, v in taps.items()}))
    tm = TS8FPN(chans, features=8)
    tm.load_state_dict(FF.from_flax(params), strict=True)
    with torch.no_grad():
        got = tm({k: torch.from_numpy(v).permute(0, 3, 1, 2)
                  for k, v in taps.items()})
    got = got.permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (2, sizes[0], sizes[0], 8)
    np.testing.assert_allclose(got, want, rtol=0, atol=MODEL_ATOL)


@pytest.mark.parametrize("backbone", ["tiny", "mobilenetv2"])
@pytest.mark.parametrize("kind", ["heatmap", "s8"])
def test_model_forward_matches_jax(rng, kind, backbone):
    jm, params, stats, tm = _pair(kind, backbone)
    images = rng.uniform(-1, 1, size=(2, IMG, IMG, 3)).astype(np.float32)
    want = np.asarray(jm.apply({"params": params, "batch_stats": stats},
                               jnp.asarray(images), train=False))
    with torch.no_grad():
        got = tm(torch.from_numpy(images), train=False)
    assert got.dtype == torch.float32 and got.is_contiguous()
    shape = ((2, 8, 8, 4 + 1 + NC + 1) if kind == "heatmap"
             else (2, 8, 8, len(SCALES), 4 + NC))
    assert tuple(got.shape) == want.shape == shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=MODEL_ATOL)
    if kind == "s8":  # the reg heads are sigmoid-activated
        assert (got[..., :4] > 0).all() and (got[..., :4] < 1).all()


@pytest.mark.parametrize("kind", ["heatmap", "s8"])
def test_weights_round_trip_through_to_flax(kind):
    _, params, stats, tm = _pair(kind)
    back_params, back_stats = FF.to_flax(tm)
    _assert_trees_close(back_params, params, 0.0, "params")
    _assert_trees_close(back_stats, stats, 0.0, "batch_stats")
    # strict both ways: a tree of the other family does not fit
    other = "s8" if kind == "heatmap" else "heatmap"
    with pytest.raises(KeyError):
        FF.load_flax(_tmodel(other), params, stats)


def test_fresh_models_start_from_the_focal_prior():
    from detectax_torch.models.layers import FOCAL_BIAS

    a = TC.CenterNetFPNSingle(num_classes=NC, backbone="tiny")
    b = TC.CenterNetFPNSingle(num_classes=NC, backbone="tiny")
    for (k, x), (_, y) in zip(a.state_dict().items(),
                              b.state_dict().items()):
        assert torch.equal(x, y), k          # seeded: two builds agree
    assert torch.all(a.cls_head.Conv_0.bias == FOCAL_BIAS)
    assert torch.all(a.reg_head.Conv_0.bias == 0)
    s8 = TC.CenterNetS8(num_classes=NC, n_scales=2, backbone="tiny")
    assert torch.all(s8.cls_head_2.Conv_0.bias == FOCAL_BIAS)
    assert not hasattr(s8, "cls_head_3")


# --------------------------------------------------------------------------
# the two decodes
# --------------------------------------------------------------------------

def _heatmap_output(rng, batch=2, size=12):
    reg = rng.normal(loc=1.5, scale=2.0, size=(batch, size, size, 4))
    rest = rng.normal(scale=2.0, size=(batch, size, size, 1 + NC + 1))
    return np.concatenate([reg, rest], -1).astype(np.float32)


@pytest.mark.parametrize("use_centerness", [True, False])
@pytest.mark.parametrize("skip_background", [True, False])
@pytest.mark.parametrize("peak_mask", [True, False])
def test_heatmap_decode_matches_jax(rng, use_centerness, skip_background,
                                    peak_mask):
    out = _heatmap_output(rng)
    kw = dict(use_centerness=use_centerness, skip_background=skip_background,
              peak_mask=peak_mask)
    # use_pallas=True: the Pallas kernel, in interpret mode on the CPU
    wb, wp = JP.centernet_heatmap_decode(jnp.asarray(out), use_pallas=True,
                                         **kw)
    wb, wp = np.asarray(wb), np.asarray(wp)
    for kernels in (None, "plain"):
        gb, gp = TP.centernet_heatmap_decode(torch.from_numpy(out),
                                             kernels=kernels, **kw)
        assert gb.shape == wb.shape and gp.shape == wp.shape
        np.testing.assert_allclose(gb.numpy(), wb, rtol=0, atol=1e-5)
        np.testing.assert_allclose(gp.numpy(), wp, rtol=0, atol=1e-6)
        np.testing.assert_array_equal(gp.numpy() == 0, wp == 0)
    if peak_mask:
        assert 0 < (wp > 0).mean() < 0.5     # peaks are sparse
    with pytest.raises(ValueError, match="kernels"):
        TP.centernet_heatmap_decode(torch.from_numpy(out), kernels=True)


def test_s8_decode_matches_jax(rng):
    out = rng.uniform(0.05, 0.95, size=(2, 6, 6, len(SCALES), 4 + NC))
    out[..., 4:] = rng.normal(scale=2.0, size=out[..., 4:].shape)
    out = out.astype(np.float32)
    wb, wp = JP.centernet_s8_decode(jnp.asarray(out), box_scales=SCALES)
    gb, gp = TP.centernet_s8_decode(torch.from_numpy(out), box_scales=SCALES)
    assert tuple(gb.shape) == (2, 6 * 6 * len(SCALES), 4)
    np.testing.assert_allclose(gb.numpy(), np.asarray(wb), rtol=1e-6,
                               atol=1e-5)
    np.testing.assert_allclose(gp.numpy(), np.asarray(wp), rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="box scales"):
        TP.centernet_s8_decode(torch.from_numpy(out), box_scales=SCALES[:2])


# --------------------------------------------------------------------------
# the two assigners
# --------------------------------------------------------------------------

def _random_boxes(rng, batch, n):
    b = np.zeros((batch, n, 4), np.float32)
    b[..., :2] = rng.uniform(0.05, 0.95, (batch, n, 2))
    b[..., 2:] = rng.uniform(0.02, 0.9, (batch, n, 2))
    labels = rng.integers(0, NC, (batch, n)).astype(np.int32)
    valid = rng.uniform(size=(batch, n)) < 0.8
    return b, labels, valid


def _overlapping(rng, batch, n):
    """Boxes of exactly equal area around one centre, with different
    labels, and exact duplicates: the lower index owns shared cells."""
    b, labels, valid = _random_boxes(rng, batch, n)
    b[:, 0] = (0.5, 0.5, 0.5, 0.25)
    b[:, 1] = (0.5, 0.5, 0.25, 0.5)
    b[:, 2] = (0.5, 0.5, 0.5, 0.25)
    b[:, 3] = (0.52, 0.51, 0.25, 0.5)     # same cell, same slot
    labels[:, :4] = (0, 1, 2, 1)
    valid[:, :4] = True
    return b, labels, valid


def _degenerate(rng, batch, n):
    b, labels, valid = _random_boxes(rng, batch, n)
    b[:, 0, 2:] = 0.0                       # a point
    b[:, 1, 2:] = (0.001, 0.3)              # no row covered
    b[:, 2, 2:] = (0.3, 0.001)              # no column covered
    b[:, 3] = (0.0, 0.0, 0.01, 0.01)        # at the origin
    b[:, 4] = (0.5, 0.5, 3.0, 3.0)          # larger than every scale
    valid[:, :5] = True
    return b, labels, valid


def _out_of_map(rng, batch, n):
    b, labels, valid = _random_boxes(rng, batch, n)
    b[:, 0] = (1.3, 0.5, 0.2, 0.2)          # centre below the canvas
    b[:, 1] = (0.5, -0.4, 0.2, 0.2)         # centre left of it
    b[:, 2] = (1.0, 1.0, 0.1, 0.1)          # on the far corner
    b[:, 3] = (0.98, 0.02, 0.3, 0.3)        # hangs over two edges
    valid[:, :4] = True
    return b, labels, valid


def _all_invalid(rng, batch, n):
    b, labels, _ = _random_boxes(rng, batch, n)
    return b, labels, np.zeros((batch, n), bool)


CASES = {"random": _random_boxes, "overlapping": _overlapping,
         "degenerate": _degenerate, "out_of_map": _out_of_map,
         "all_invalid": _all_invalid}
GEOMETRY = {"square": dict(img_dim=(64, 64)),
            "padded": dict(img_dim=(48, 56), img_pad=(64, 64))}


def _assign_both(j_fn, t_fn, boxes, labels, valid, **kw):
    want, want_n = jax.vmap(functools.partial(j_fn, **kw))(
        jnp.asarray(boxes), jnp.asarray(labels), jnp.asarray(valid))
    got, got_n = t_fn(torch.from_numpy(boxes), torch.from_numpy(labels),
                      torch.from_numpy(valid), **kw)
    np.testing.assert_array_equal(got_n.numpy(), np.asarray(want_n))
    want = np.asarray(want)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    return got.numpy(), want


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("geometry", sorted(GEOMETRY))
@pytest.mark.parametrize("heatmap_kind", ["pseudo", "gaussian"])
def test_heatmap_assign_matches_jax(case, geometry, heatmap_kind):
    rng = np.random.default_rng(3)
    boxes, labels, valid = CASES[case](rng, 3, 10)
    got, want = _assign_both(
        JA.centernet_heatmap_assign, TA.centernet_heatmap_assign,
        boxes, labels + 1, valid, num_classes=NC + 1,
        heatmap_kind=heatmap_kind, **GEOMETRY[geometry])
    assert got.shape == (3, 8, 8, 5 + NC + 1)
    np.testing.assert_array_equal(got[..., 5:], want[..., 5:])   # classes
    np.testing.assert_array_equal(got[..., 4] == 1.0, want[..., 4] == 1.0)
    np.testing.assert_array_equal(got == 0, want == 0)           # ownership
    np.testing.assert_allclose(got[..., :5], want[..., :5], rtol=0,
                               atol=1e-6)
    if case == "all_invalid":
        assert not got.any()
    else:
        assert got[..., 5:].any() and not got[..., 5].any()  # slot 0 unused


def test_heatmap_assign_rejects_an_unknown_kind(rng):
    boxes, labels, valid = _random_boxes(rng, 1, 2)
    with pytest.raises(ValueError, match="heatmap_kind"):
        TA.centernet_heatmap_assign(
            torch.from_numpy(boxes), torch.from_numpy(labels),
            torch.from_numpy(valid), img_dim=(64, 64), num_classes=NC,
            heatmap_kind="box")


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("geometry", sorted(GEOMETRY))
@pytest.mark.parametrize("gaussian_cls", [False, True])
def test_scale_slot_assign_matches_jax(case, geometry, gaussian_cls):
    rng = np.random.default_rng(4)
    boxes, labels, valid = CASES[case](rng, 3, 10)
    got, want = _assign_both(
        JA.centernet_scale_slot_assign, TA.centernet_scale_slot_assign,
        boxes, labels, valid, num_classes=NC, box_scales=SCALES,
        gaussian_cls=gaussian_cls, **GEOMETRY[geometry])
    assert got.shape == (3, 8, 8, len(SCALES), 4 + NC)
    # positives (class target exactly 1.0) and the cells that carry a box
    np.testing.assert_array_equal(got[..., 4:] == 1.0, want[..., 4:] == 1.0)
    np.testing.assert_array_equal(got[..., :4] == 0, want[..., :4] == 0)
    np.testing.assert_array_equal(got[..., 4:] == 0, want[..., 4:] == 0)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    if not gaussian_cls:
        np.testing.assert_array_equal(got[..., 4:], want[..., 4:])
    if case == "all_invalid":
        assert not got.any()
    elif gaussian_cls:
        tails = (got[..., 4:] > 0) & (got[..., 4:] < 1)
        assert tails.any()


# --------------------------------------------------------------------------
# the scale-slot loss
# --------------------------------------------------------------------------

def _s8_maps(rng, gaussian_cls):
    boxes, labels, valid = _random_boxes(rng, BATCH, 8)
    y_true, _ = TA.centernet_scale_slot_assign(
        torch.from_numpy(boxes), torch.from_numpy(labels),
        torch.from_numpy(valid), img_dim=(IMG, IMG), num_classes=NC,
        box_scales=SCALES, gaussian_cls=gaussian_cls)
    y_pred = rng.normal(scale=1.5, size=tuple(y_true.shape)) \
        .astype(np.float32)
    return y_true.numpy(), y_pred


@pytest.mark.parametrize("gaussian_cls", [False, True])
@pytest.mark.parametrize("lambdas", [(1.0, 1.0), (2.5, 0.5)])
def test_centernet_s8_loss_value_and_gradient(rng, gaussian_cls, lambdas):
    y_true, y_pred = _s8_maps(rng, gaussian_cls)
    kw = dict(cls_lambda=lambdas[0], reg_lambda=lambdas[1])
    want = JTL.centernet_s8_loss(jnp.asarray(y_true), jnp.asarray(y_pred),
                                 **kw)
    want_grad = jax.grad(lambda p: JTL.centernet_s8_loss(
        jnp.asarray(y_true), p, **kw)["total"])(jnp.asarray(y_pred))
    for kernels in (None, "plain"):
        pred = torch.from_numpy(y_pred).requires_grad_(True)
        got = TTL.centernet_s8_loss(torch.from_numpy(y_true), pred,
                                    kernels=kernels, **kw)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(float(got[k].detach()),
                                       float(want[k]), rtol=1e-5, err_msg=k)
        got["total"].backward()
        np.testing.assert_allclose(pred.grad.numpy(), np.asarray(want_grad),
                                   rtol=0, atol=1e-6)
    assert float(got["num_pos"]) > 0
    with pytest.raises(ValueError, match="kernels"):
        TTL.centernet_s8_loss(torch.from_numpy(y_true),
                              torch.from_numpy(y_pred), kernels=True)


# --------------------------------------------------------------------------
# train steps
# --------------------------------------------------------------------------

def _batch(rng):
    boxes = np.zeros((BATCH, 6, 4), np.float32)
    boxes[..., :2] = rng.uniform(0.3, 0.7, (BATCH, 6, 2))
    boxes[..., 2:] = rng.uniform(0.1, 0.6, (BATCH, 6, 2))
    valid = np.ones((BATCH, 6), bool)
    valid[1, 3:] = False
    valid[3] = False
    return {"images": rng.normal(size=(BATCH, IMG, IMG, 3))
            .astype(np.float32),
            "boxes": boxes,
            "labels": rng.integers(0, NC, (BATCH, 6)).astype(np.int32),
            "valid": valid}


def _train_fns(kind, lib_assign, lib_losses):
    """(assign_fn, loss_fn) of a family as its trainer composes them, over
    the JAX package's or the port's libraries."""
    img = (IMG, IMG)
    if kind == "heatmap":
        def assign_fn(boxes, labels, valid):
            out, _ = lib_assign.centernet_heatmap_assign(
                boxes, labels + 1, valid, img_dim=img, num_classes=NC + 1)
            return [out]

        def loss_fn(y_true, y_pred):
            return lib_losses.fcos_loss(y_true, [y_pred], cen_type="l1")
    else:
        def assign_fn(boxes, labels, valid):
            return lib_assign.centernet_scale_slot_assign(
                boxes, labels, valid, img_dim=img, num_classes=NC,
                box_scales=SCALES, gaussian_cls=True)[0]

        loss_fn = lib_losses.centernet_s8_loss
    return assign_fn, loss_fn


def _make_both(kind, microbatch=None):
    sched = dict(init_lr=1e-2, boundaries=[2], scales=[0.1])
    jmodel, tmodel = _jmodel(kind), _tmodel(kind)
    jopt = JS.make_optimizer("sgd", JS.make_schedule("piecewise", **sched),
                             grad_clip=1.0)
    jstep = JLoop.make_train_step(
        jmodel, *_train_fns(kind, JA, JTL), jopt, microbatch=microbatch,
        donate=False, jit=True)
    jstate = JLoop.create_train_state(
        jmodel, jax.random.PRNGKey(0), jnp.zeros((BATCH, IMG, IMG, 3)), jopt)
    topt = TS.make_optimizer("sgd", TS.make_schedule("piecewise", **sched),
                             grad_clip=1.0)
    tstep = TLoop.make_train_step(
        tmodel, *_train_fns(kind, TA, TTL), topt, microbatch=microbatch)
    tstate = TLoop.create_train_state(tmodel, None, topt)
    FF.load_train_state(
        tstate, _numpy_tree(jstate.params), _numpy_tree(jstate.batch_stats),
        opt_state=_numpy_tree(jstate.opt_state), step=int(jstate.step))
    return (jstep, jstate), (tstep, tstate)


def _compare_states(jstate, tstate, what, atol=PARAM_ATOL):
    assert tstate.step == int(jstate.step)
    params, stats = FF.to_flax(tstate.model)
    _assert_trees_close(params, _numpy_tree(jstate.params), atol,
                        f"{what} params")
    _assert_trees_close(stats, _numpy_tree(jstate.batch_stats), atol,
                        f"{what} batch_stats")
    trace = FF._optax_fields(_numpy_tree(jstate.opt_state))["trace"]
    _assert_trees_close(FF.opt_to_flax(tstate)["trace"], trace, atol,
                        f"{what} momentum")


# Seed 6 is held to the tolerances of `test_torch_train.py`. With seed 5 the
# heatmap model's third step has one activation within rounding of zero
# that falls on either side of a ReLU in the two frameworks: grad_norm then
# differs by 2e-6 relative and the stem's momentum by 7e-6, while every
# other step of both seeds stays at 4e-8. A property of comparing two
# roundings, not of either side; that seed's state is held to 1e-5, which a
# real fault (a wrong term, a missed update) exceeds by orders of magnitude.
@pytest.mark.usefixtures("_process_threads")
@pytest.mark.parametrize("kind,microbatch,seed,param_atol", [
    ("heatmap", None, 6, PARAM_ATOL),
    ("s8", None, 6, PARAM_ATOL),
    ("s8", 2, 6, PARAM_ATOL),
    ("heatmap", 2, 6, PARAM_ATOL),
    ("heatmap", None, 5, 1e-5),
    ("s8", None, 5, PARAM_ATOL),
])
def test_train_steps_match_jax(kind, microbatch, seed, param_atol):
    (jstep, jstate), (tstep, tstate) = _make_both(kind, microbatch)
    _compare_states(jstate, tstate, "converted state")
    rng = np.random.default_rng(seed)
    for n in (1, 2, 3):
        batch = _batch(rng)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        _, tm = tstep(tstate, batch)
        assert set(tm) == set(jm)
        for k in jm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=METRIC_RTOL,
                                       err_msg=f"{k} at step {n}")
        if n in (1, 3):
            _compare_states(jstate, tstate, f"{kind} after {n} steps",
                            param_atol)
    assert float(tm["num_pos"]) > 0 and float(tm["grad_norm"]) > 0


# --------------------------------------------------------------------------
# the serving graph, bundles, command lines
# --------------------------------------------------------------------------

def _decode_fns(kind):
    if kind == "heatmap":
        return (lambda o: JP.centernet_heatmap_decode(o, use_pallas=True),
                TE.centernet_decode_fn("centernet_heatmap"))
    return (lambda o: JP.centernet_s8_decode(o, box_scales=SCALES),
            TE.centernet_decode_fn("centernet_s8", box_scales=SCALES))


@pytest.mark.parametrize("kind", ["heatmap", "s8"])
def test_serving_graph_matches_jax_end_to_end(rng, kind):
    jm, params, stats, tm = _pair(kind, serving=True)
    j_decode, t_decode = _decode_fns(kind)
    common = dict(top_k=64, max_outputs=16, score_thresh=0.3, iou_thresh=0.5)
    images = rng.uniform(-1, 1, (5, IMG, IMG, 3)).astype(np.float32)
    out = jm.apply({"params": params, "batch_stats": stats},
                   jnp.asarray(images), train=False)
    want = JP.detections_from_dense(*j_decode(out), pallas=False, **common)
    want = {k: np.asarray(v) for k, v in want.items()}

    pred = Predictor.for_model(
        TE.make_serving_fn(tm, t_decode, **common), tm, canvas=IMG,
        buckets=(1, 4), device="cpu")
    got = pred.predict(images)
    assert int(want["num_valid"].min()) > 0
    for key in ("classes", "valid", "num_valid"):      # the keep sets
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(got["boxes"], want["boxes"], rtol=0,
                               atol=2e-4)   # pixels up to 64 x stride sums


@pytest.mark.parametrize("kind", ["heatmap", "s8"])
def test_bundle_roundtrip(rng, tmp_path, kind):
    _, _, _, tm = _pair(kind, serving=True)
    serving = dict(top_k=64, max_outputs=16, score_thresh=0.3)
    extra = dict(box_scales=SCALES) if kind == "s8" else {}
    manifest = TE.save_bundle(str(tmp_path / "b"), tm, canvas=IMG,
                              buckets=(2, 1), **extra, **serving)
    assert manifest["model"]["family"] == tm.family
    with open(tmp_path / "b" / "manifest.json") as f:
        on_disk = json.load(f)
    if kind == "s8":
        assert on_disk["model"]["n_scales"] == len(SCALES)
        assert on_disk["box_scales"] == list(SCALES)
        with pytest.raises(ValueError, match="box_scales"):
            TE.save_bundle(str(tmp_path / "c"), tm, canvas=IMG)
    else:
        assert "box_scales" not in on_disk and "center" not in on_disk

    pred = TE.load_bundle(str(tmp_path / "b"), device="cpu")
    images = rng.uniform(-1, 1, (3, IMG, IMG, 3)).astype(np.float32)
    got = pred.predict(images)
    live = Predictor.for_model(
        TE.make_serving_fn(tm, _decode_fns(kind)[1], **serving), tm,
        canvas=IMG, buckets=(1, 2), device="cpu")
    want = live.predict(images)
    assert int(want["num_valid"].min()) > 0
    for key in DET_KEYS:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)

    on_disk["model"]["family"] = "hourglass"
    (tmp_path / "b" / "manifest.json").write_text(json.dumps(on_disk))
    with pytest.raises(ValueError, match="centernet_heatmap"):
        TE.load_bundle(str(tmp_path / "b"), device="cpu")
    with pytest.raises(TypeError, match="family"):
        TE.save_bundle(str(tmp_path / "d"), torch.nn.Linear(2, 2),
                       canvas=IMG)


def _cli_args(tmp_path, *extra):
    return ["--device", "cpu", "--backbone", "tiny", "--canvas", "64",
            "--batch_size", "2", "--synthetic_n", "8", "--display_step", "1",
            "--step_save", "2", "--max_steps", "2",
            "--ckpt_dir", str(tmp_path / "ckpt"),
            "--out_dir", str(tmp_path / "out"), *extra]


def _image_file(tmp_path):
    from PIL import Image

    rng = np.random.default_rng(2)
    path = tmp_path / "in.jpg"
    Image.fromarray(rng.integers(0, 255, (80, 120, 3), np.uint8)).save(path)
    return str(path)


def _infer(tmp_path, *args):
    dets = infer_centernet.main([
        "--img_file", _image_file(tmp_path), "--device", "cpu",
        "--backbone", "tiny", "--num_classes", "3", "--img_dims", "64",
        "--cls_thresh", "0.001",
        "--heatmap_out", str(tmp_path / "hm.jpg"),
        "--detect_out", str(tmp_path / "det.jpg"), *args])
    assert (tmp_path / "hm.jpg").stat().st_size > 0
    assert (tmp_path / "det.jpg").stat().st_size > 0
    assert dets["boxes"].shape == (1, 200, 4)
    assert np.isfinite(dets["boxes"]).all()
    return dets


@pytest.mark.parametrize("heatmap_kind", ["pseudo", "gaussian"])
def test_heatmap_cli_trains_and_infer_cli_serves_its_checkpoint(
        tmp_path, heatmap_kind):
    summary = train_centernet_heatmap.main(
        _cli_args(tmp_path, "--heatmap_kind", heatmap_kind))
    assert summary["final_step"] == 2 and np.isfinite(summary["total"])
    assert np.isfinite(summary["grad_norm"]) and summary["cen"] > 0
    assert CheckpointManager(str(tmp_path / "ckpt")).latest_step() == 2
    dets = _infer(tmp_path, "--variant", "heatmap",
                  "--ckpt_dir", str(tmp_path / "ckpt"))
    assert int(dets["num_valid"][0]) > 0
    assert (dets["classes"][dets["valid"]] < 3).all()


@pytest.mark.parametrize("extra", [
    (), ("--gaussian_cls", "--use_scale", "--base_dims", "64")],
    ids=["reference", "gaussian_jitter"])
def test_crowdhuman_cli_trains_and_infer_cli_serves_its_checkpoint(
        tmp_path, extra):
    scales = ("--box_scales", "16", "32", "64")
    summary = train_centernet_crowdhuman.main(
        _cli_args(tmp_path, *scales, "--lr_boundaries", "1", *extra))
    assert summary["final_step"] == 2 and np.isfinite(summary["total"])
    assert set(summary) >= {"cls", "reg", "num_pos", "grad_norm"}
    for soft in ((), ("--soft_nms",)):
        dets = _infer(tmp_path, "--variant", "s8", *scales, *soft,
                      "--ckpt_dir", str(tmp_path / "ckpt"))
        assert int(dets["num_valid"][0]) > 0


@pytest.mark.parametrize("kind", ["heatmap", "s8"])
def test_infer_cli_reads_weights_written_from_jax_trees(tmp_path, kind):
    _, params, stats, _ = _pair(kind, serving=True)
    FF.save_npz(str(tmp_path / "w.npz"), params, stats)
    extra = (("--box_scales", *map(str, SCALES)) if kind == "s8" else ())
    dets = _infer(tmp_path, "--variant", kind,
                  "--weights", str(tmp_path / "w.npz"), *extra)
    assert int(dets["num_valid"][0]) > 0


@pytest.mark.parametrize("main", [
    train_centernet_heatmap.main, train_centernet_crowdhuman.main],
    ids=["heatmap", "crowdhuman"])
def test_train_clis_refuse_what_is_not_ported_and_need_a_device(
        tmp_path, main):
    # --bf16 is ported: it trains (bf16 compute, float32 parameters)
    summary = main(_cli_args(tmp_path, "--bf16", "--max_steps", "1"))
    assert summary["final_step"] == 1 and np.isfinite(summary["total"])
    if main is train_centernet_heatmap.main:
        # as in the JAX package, this trainer has no visual hook
        with pytest.raises(NotImplementedError, match="no visual hook"):
            main(_cli_args(tmp_path, "--dump_visuals"))
    if torch.cuda.is_available():
        return
    args = [a for a in _cli_args(tmp_path) if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="CUDA"):
        main(args)
    with pytest.raises(RuntimeError, match="CUDA"):
        infer_centernet.main(["--img_file", "x.jpg"])
