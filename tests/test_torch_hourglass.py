"""The hourglass half of the CenterNet family of the PyTorch port against
the JAX package, on the CPU: the blocks, the two models, `from_flax`, the
assigners, the losses and the decoders.

Inputs and weights are made with numpy from a seed, the weights in the
Flax variables' own trees (`flax_trees`), and cross to the port through
`detectax_torch.tools.from_flax`. Sizes: ``n_filters`` 2 (`HourglassNet`,
whose six stages bring a 64 px canvas down to 1x1) and 4 (two stacks of
`StackedHourglass`), two repeats, 64 px, batch 2, three classes.

* the blocks (`HourglassConvBlock`, `HourglassDownsample` in both norm
  orders, separable and plain convs; `BottleneckHGBlock`; the NCHW
  re-layouts are held in `tests/test_torch_models.py`);
* both models' float32 forwards, ``train=False`` (running statistics moved
  off their init) and ``train=True`` (with the running statistics it
  leaves), to ``1e-4`` of each output's largest magnitude plus ``1e-5``
  (JAX's own jitted and eager float32 forwards of `HourglassNet` in train
  mode differ by 3.3e-5 of it at this size: batch statistics of 1x1 maps);
  bf16 within twice JAX's own bf16 error, as `tests/test_torch_bf16.py`;
* `from_flax` fills both models strictly both ways: every Flax leaf has a
  place, every entry of the model is filled, and `to_flax` gives the same
  trees back;
* both assigners on boxes with equal areas sharing a cell, padding, an
  empty batch and boxes off the map: integers and one-hots exactly, floats
  to 1e-6;
* both losses and their gradients against `jax.grad`, away from a logit of
  exactly 0 (ROADMAP.md queue 3.1), on the kernels' wrappers and on the
  plain versions;
* both decoders and `detections_from_dense`: keep sets exactly.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detectax.infer import predict as JP
from detectax.models import HourglassNet as JHG
from detectax.models import StackedHourglass as JSH
from detectax.models import centernet as JC
from detectax.models import layers as JL
from detectax.ops import assign as JA
from detectax.train import losses as JTL
from detectax_torch.infer import export as TE
from detectax_torch.infer import predict as TP
from detectax_torch.models import HourglassNet as THG
from detectax_torch.models import StackedHourglass as TSH
from detectax_torch.models import centernet as TC
from detectax_torch.models import layers as TL
from detectax_torch.ops import assign as TA
from detectax_torch.tools import from_flax as FF
from detectax_torch.train import losses as TTL


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """torch on one thread: the models are tiny, and beside the suite's
    other workers a pool of threads a process waits on busy cores at every
    operation (tens of times slower)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


IMG, NC, BATCH = 64, 3, 2
F32, BF16 = torch.float32, torch.bfloat16
FWD_RTOL, FWD_ATOL = 1e-4, 1e-5
LOSS_RTOL = 1e-5     # as tests/test_torch_retinanet.py: sums in other orders
GRAD_RTOL = 5e-5     # ibid.: XLA's spread of the focal gradient

# name: (JAX class, port class, keywords)
MODELS = {
    "hourglass": (JHG, THG, {"n_filters": 2}),
    "hourglass_norm_last": (JHG, THG, {"n_filters": 2,
                                       "norm_order": "norm_last"}),
    "stacked": (JSH, TSH, {"n_filters": 4, "n_stacks": 2}),
}


def _np(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _leaves(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _leaves(tree[k], f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(tree[k])


def _close(got, want, what):
    err = float(np.abs(got - want).max())
    assert err <= FWD_RTOL * float(np.abs(want).max()) + FWD_ATOL, (what, err)


def flax_trees(module, seed, sample=(1, IMG, IMG, 3)):
    """(params, batch_stats) with the tree, names and shapes of
    ``module``'s Flax variables (`jax.eval_shape` of its init: no Flax init
    is run, which takes tens of seconds op by op here) and values from
    numpy: conv kernels LeCun-normal, conv biases small, BatchNorm scale
    one and bias zero, the focal bias its prior, running statistics near
    their init."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: module.init(
        jax.random.key(0), jnp.zeros(sample), train=False))

    def fill(path, leaf):
        name = path[-1].key
        shape = leaf.shape
        if name == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            v = rng.normal(0.0, np.sqrt(1.0 / fan_in), shape)
        elif name == "scale":
            v = np.ones(shape)
        elif name == "bias" and shape == ():
            v = np.full(shape, JL.FOCAL_BIAS)
        elif name == "bias":
            under_bn = "BatchNorm" in str(path[-2].key) or \
                str(path[-2].key).startswith("bn_")
            v = np.zeros(shape) if under_bn else rng.normal(0, 0.05, shape)
        elif name == "mean":
            v = rng.normal(0.0, 0.1, shape)
        elif name == "var":
            v = rng.uniform(0.7, 1.3, shape)
        else:
            raise KeyError(name)
        return np.asarray(v, np.float32)

    params = jax.tree_util.tree_map_with_path(fill, shapes["params"])
    stats = jax.tree_util.tree_map_with_path(fill, shapes["batch_stats"])
    return params, stats


def _jax_forward(module, params, stats, images, train):
    out = jax.jit(lambda p, s, x: module.apply(
        {"params": p, "batch_stats": s}, x, train=train,
        mutable=["batch_stats"] if train else False))(
        params, stats, jnp.asarray(images))
    return (np.asarray(out[0]), _np(out[1]["batch_stats"])) if train \
        else np.asarray(out)


# --------------------------------------------------------------------------
# the blocks
# --------------------------------------------------------------------------

def _block_pair(kind, norm_order, separable):
    """(Flax module, port module) of one block, 5 input channels."""
    cin, f = 5, 6
    if kind == "conv_block":
        kw = dict(n_repeats=2, separable=separable, norm_order=norm_order)
        return (JL.HourglassConvBlock(f, 3, 1, **kw),
                TL.HourglassConvBlock(cin, f, 3, 1, **kw))
    if kind == "downsample":
        kw = dict(separable=separable, norm_order=norm_order)
        return (JL.HourglassDownsample(f, 3, **kw),
                TL.HourglassDownsample(cin, f, 3, **kw))
    return (JC.BottleneckHGBlock(3, 3, n_repeats=2, separable=separable),
            TC.BottleneckHGBlock(cin, 3, 3, n_repeats=2,
                                 separable=separable))


@pytest.mark.parametrize("kind,norm_order,separable", [
    ("conv_block", "norm_first", True), ("conv_block", "norm_last", True),
    ("conv_block", "norm_first", False),
    ("downsample", "norm_first", True), ("downsample", "norm_last", True),
    ("downsample", "norm_last", False),
    ("bottleneck", None, True), ("bottleneck", None, False)])
def test_blocks_equal_the_jax_package(rng, kind, norm_order, separable):
    """Odd spatial sizes (the stride-2 "SAME" pads (0, 1)), both modes,
    the running statistics after ``train=True``."""
    jm, tm = _block_pair(kind, norm_order or "norm_first", separable)
    x = rng.normal(size=(BATCH, 9, 7, 5)).astype(np.float32)
    params, stats = flax_trees(jm, 1, x.shape)
    FF.load_flax(tm, params, stats)
    for train in (False, True):
        want = _jax_forward(jm, params, stats, x, train)
        if train:
            want, want_stats = want
        got = tm(torch.from_numpy(x).permute(0, 3, 1, 2), train=train)
        got = got.detach().permute(0, 2, 3, 1).numpy()
        assert got.shape == want.shape
        _close(got, want, (kind, train))
    for (k, g), (_, w) in zip(_leaves(FF.to_flax(tm)[1]),
                              _leaves(want_stats)):
        _close(g, w, k)


# --------------------------------------------------------------------------
# the models
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _variables(name, seed=0):
    jcls, _, kw = MODELS[name]
    return flax_trees(jcls(num_classes=NC, **kw), seed)


def _build(name, side, dtype, params, stats):
    jcls, tcls, kw = MODELS[name]
    if side == "jax":
        return jcls(num_classes=NC, **kw,
                    dtype=jnp.bfloat16 if dtype == BF16 else jnp.float32)
    return FF.load_flax(tcls(num_classes=NC, **kw, dtype=dtype), params,
                        stats)


@pytest.mark.parametrize("name", list(MODELS))
def test_forward_equals_the_jax_package(rng, name):
    params, stats = _variables(name)
    images = rng.uniform(-1, 1, (BATCH, IMG, IMG, 3)).astype(np.float32)
    jm = _build(name, "jax", F32, params, stats)
    tm = _build(name, "torch", F32, params, stats)
    shape = ((BATCH, IMG // 8, IMG // 8, 4, 5 + NC) if name != "stacked"
             else (BATCH, IMG // 4, IMG // 4, 4 + NC))
    want = _jax_forward(jm, params, stats, images, False)
    with torch.no_grad():
        got = tm(torch.from_numpy(images))
    assert got.dtype == F32 and tuple(got.shape) == want.shape == shape
    _close(got.numpy(), want, "eval")
    want, want_stats = _jax_forward(jm, params, stats, images, True)
    with torch.no_grad():
        got = tm(torch.from_numpy(images), train=True)
    _close(got.numpy(), want, "train")
    got_stats = dict(_leaves(FF.to_flax(tm)[1]))
    assert set(got_stats) == set(dict(_leaves(want_stats)))
    for k, w in _leaves(want_stats):
        _close(got_stats[k], w, k)


@pytest.mark.parametrize("name", ["hourglass", "stacked"])
def test_bf16_forward_within_jax_bf16_error(rng, name):
    """bf16 compute with float32 parameters: within twice JAX's own bf16
    error plus 1e-3, every conv computing in bf16, and the port's own bf16
    error real and of JAX's order (``train=False``)."""
    params, stats = _variables(name)
    images = rng.uniform(-1, 1, (BATCH, IMG, IMG, 3)).astype(np.float32)
    j32 = _jax_forward(_build(name, "jax", F32, params, stats), params,
                       stats, images, False)
    j16 = _jax_forward(_build(name, "jax", BF16, params, stats), params,
                       stats, images, False)
    t16_model = _build(name, "torch", BF16, params, stats)
    seen = []
    hooks = [m.register_forward_hook(
        lambda mod, args, out: seen.append(out.dtype))
        for m in t16_model.modules() if isinstance(m, TL.Conv)]
    with torch.no_grad():
        t16 = t16_model(torch.from_numpy(images)).numpy()
        t32 = _build(name, "torch", F32, params, stats)(
            torch.from_numpy(images)).numpy()
    for h in hooks:
        h.remove()
    assert seen and all(d == BF16 for d in seen)
    assert all(p.dtype == F32 for p in t16_model.parameters())
    jax_err = float(np.abs(j16 - j32).max())
    port_err = float(np.abs(t16 - t32).max())
    assert float(np.abs(t16 - j16).max()) <= 2.0 * jax_err + 1e-3
    assert 0.0 < port_err and 0.25 * jax_err <= port_err <= 4.0 * jax_err, \
        (port_err, jax_err)


@pytest.mark.parametrize("name,separable", [
    ("hourglass", True), ("hourglass", False), ("stacked", True),
    ("stacked", False)])
def test_from_flax_fills_both_models_strictly(name, separable):
    """Both ways: the trees fill every entry (the auto-named
    ``BatchNorm_0`` and ``SeparableConv_0`` / ``Conv_0`` of the
    downsample blocks, ``depthwise`` / ``pointwise``, the 0-d
    ``b_focal/bias``), `to_flax` returns them leaf for leaf, and a leaf
    missing or left over is refused."""
    jcls, tcls, kw = MODELS[name]
    params, stats = flax_trees(jcls(num_classes=NC, separable=separable,
                                    **kw), 2)
    tm = FF.load_flax(tcls(num_classes=NC, separable=separable, **kw),
                      params, stats)
    assert tm.b_focal.bias.shape == () and \
        float(tm.b_focal.bias.detach()) == pytest.approx(JL.FOCAL_BIAS)
    down = "down_block_1" if name == "hourglass" else None
    if down:
        sub = "SeparableConv_0" if separable else "Conv_0"
        assert set(params[down]) == {"BatchNorm_0", sub}
    back_params, back_stats = FF.to_flax(tm)
    for got, want in ((back_params, params), (back_stats, stats)):
        got, want = dict(_leaves(got)), dict(_leaves(want))
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    short = dict(params)
    short.pop("b_focal")
    with pytest.raises(KeyError, match="did not fill"):
        FF.from_flax(short, stats, tm)
    extra = {**params, "head_extra": {"kernel": np.zeros((1, 1, 2, 2),
                                                         np.float32)}}
    with pytest.raises(KeyError, match="no place"):
        FF.from_flax(extra, stats, tm)


# --------------------------------------------------------------------------
# the assigners
# --------------------------------------------------------------------------

def _gt(rng, case, n=7):
    """A padded GT batch [2, n, 4] (normalized y, x, h, w), labels and the
    valid mask. Boxes 0 and 1 share a centre and an area (a tie the lower
    index wins); box 2 shares their cell with a smaller area."""
    cy = rng.uniform(0.1, 0.9, (BATCH, n))
    cx = rng.uniform(0.1, 0.9, (BATCH, n))
    h = rng.uniform(0.02, 0.9, (BATCH, n))
    w = rng.uniform(0.02, 0.9, (BATCH, n))
    valid = np.ones((BATCH, n), bool)
    cy[:, 1], cx[:, 1] = cy[:, 0], cx[:, 0]
    h[:, 1], w[:, 1] = w[:, 0], h[:, 0]           # the same area
    cy[:, 2], cx[:, 2] = cy[:, 0], cx[:, 0]
    h[:, 2], w[:, 2] = 0.5 * h[:, 0], w[:, 0]     # smaller, same slot or not
    if case == "padded":
        valid[0, 3:] = False
        valid[1, 5:] = False
    elif case == "empty":
        valid[:] = False
    elif case == "off_map":
        cy[:, 3] = 1.2                             # centre below the canvas
        cx[:, 4] = -0.1
        h[:, 5] = -0.05                            # a negative height
    boxes = np.stack([cy, cx, h, w], -1).astype(np.float32)
    labels = rng.integers(0, NC, (BATCH, n)).astype(np.int32)
    return boxes, labels, valid


def _assigners(name, img_dim, img_pad):
    kw = dict(img_dim=img_dim, img_pad=img_pad, num_classes=NC)
    if name == "hourglass":
        scales = (8.0, 16.0, 32.0, 64.0)
        return (functools.partial(JA.hourglass_assign, box_scales=scales,
                                  **kw),
                functools.partial(TA.hourglass_assign, box_scales=scales,
                                  **kw), 5)
    return (functools.partial(JA.stacked_hourglass_assign, **kw),
            functools.partial(TA.stacked_hourglass_assign, **kw), 4)


@pytest.mark.parametrize("name", ["hourglass", "stacked"])
@pytest.mark.parametrize("case", ["ties", "padded", "empty", "off_map"])
def test_assign_equals_the_jax_package(rng, name, case):
    """The content ``(56, 48)`` centre-padded into the 64 px canvas
    (``pad = int((pad - dim) / 2)``) for ``off_map``, the whole canvas
    otherwise."""
    img_dim = (56, 48) if case == "off_map" else (IMG, IMG)
    j_fn, t_fn, first_cls = _assigners(name, img_dim, (IMG, IMG))
    boxes, labels, valid = _gt(rng, case)
    want, want_n = jax.vmap(j_fn)(jnp.asarray(boxes), jnp.asarray(labels),
                                  jnp.asarray(valid))
    got, got_n = t_fn(torch.from_numpy(boxes), torch.from_numpy(labels),
                      torch.from_numpy(valid))
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape
    assert got.shape[-1] == first_cls + NC
    np.testing.assert_array_equal(got_n.numpy(), np.asarray(want_n))
    # objectness (hourglass) and one-hots exactly, the regression to 1e-6
    np.testing.assert_array_equal(got[..., 4:], want[..., 4:])
    np.testing.assert_allclose(got[..., :4], want[..., :4], rtol=0,
                               atol=1e-6)
    positives = int((got[..., first_cls:] > 0).sum())
    if case == "empty":
        assert positives == 0 and int(got_n.sum()) == 0
    else:
        assert positives > 0
    if case == "off_map":
        assert int(got_n.sum()) < int(valid.sum())


# --------------------------------------------------------------------------
# the losses
# --------------------------------------------------------------------------

def _y_true(name):
    j_fn, _, _ = _assigners(name, (IMG, IMG), (IMG, IMG))
    boxes, labels, valid = _gt(np.random.default_rng(5), "padded")
    y, _ = jax.vmap(j_fn)(jnp.asarray(boxes), jnp.asarray(labels),
                          jnp.asarray(valid))
    return np.asarray(y)


@pytest.mark.parametrize("name,kw", [
    ("hourglass", {"loss_type": "sigmoid"}),
    ("hourglass", {"loss_type": "focal"}),
    ("stacked", {})], ids=["hourglass-sigmoid", "hourglass-focal",
                          "stacked"])
def test_loss_and_gradient_equal_the_jax_package(rng, name, kw):
    y_true = _y_true(name)
    y_pred = rng.normal(0.0, 2.0, y_true.shape).astype(np.float32)
    y_pred[np.abs(y_pred) < 1e-3] = 0.5     # away from a logit of 0
    j_loss = (JTL.hourglass_loss if name == "hourglass"
              else JTL.stacked_hourglass_loss)
    t_loss = (TTL.hourglass_loss if name == "hourglass"
              else TTL.stacked_hourglass_loss)
    want = jax.jit(functools.partial(j_loss, **kw))(
        jnp.asarray(y_true), jnp.asarray(y_pred))
    want_grad = np.asarray(jax.jit(jax.grad(lambda p: j_loss(
        jnp.asarray(y_true), p, **kw)["total"]))(jnp.asarray(y_pred)))
    for kernels in (None, "plain"):
        pred = torch.from_numpy(y_pred).requires_grad_(True)
        got = t_loss(torch.from_numpy(y_true), pred, kernels=kernels, **kw)
        assert set(got) == set(want) == {"cls", "reg", "total", "num_pos"}
        for k in want:
            np.testing.assert_allclose(float(got[k]), float(want[k]),
                                       rtol=LOSS_RTOL, err_msg=k)
        assert float(got["num_pos"]) > 0
        (grad,) = torch.autograd.grad(got["total"], pred)
        np.testing.assert_allclose(grad.numpy(), want_grad, rtol=0,
                                   atol=GRAD_RTOL * np.abs(want_grad).max())


def test_hourglass_loss_refuses_an_unknown_type():
    y = torch.zeros(1, 2, 2, 4, 5 + NC)
    with pytest.raises(ValueError, match="loss_type"):
        TTL.hourglass_loss(y, y, loss_type="softmax")


# --------------------------------------------------------------------------
# decode and NMS
# --------------------------------------------------------------------------

def _outputs(rng, name):
    if name == "hourglass":
        o = rng.normal(0.0, 0.3, (BATCH, IMG // 8, IMG // 8, 4, 5 + NC))
        o[..., :4] = 1.0 / (1.0 + np.exp(-o[..., :4] * 4))   # sigmoid reg
        o[..., 4:] = rng.normal(-0.5, 1.5, o[..., 4:].shape)
    else:
        o = rng.normal(0.0, 0.3, (BATCH, IMG // 4, IMG // 4, 4 + NC))
        o[..., :4] = np.abs(rng.normal(1.5, 1.0, o[..., :4].shape))
        o[..., 4:] = rng.normal(-1.0, 1.5, o[..., 4:].shape)
    return o.astype(np.float32)


@pytest.mark.parametrize("name", ["hourglass", "stacked"])
def test_decode_and_nms_equal_the_jax_package(rng, name):
    """The decode the evaluation CLI pairs with each family
    (`infer.export.hourglass_decode_fn`), then `detections_from_dense` at
    score 0.05 and 100 outputs (two-stage on the CPU)."""
    out = _outputs(rng, name)
    if name == "hourglass":
        scales = [IMG / 2.0 ** x for x in reversed(range(4))]
        jb, jp = JP.hourglass_decode(jnp.asarray(out), box_scales=scales)
        decode = TE.hourglass_decode_fn("hourglass", canvas=IMG)
    else:
        jb, jp = JP.stacked_hourglass_decode(jnp.asarray(out), stride=4)
        decode = TE.hourglass_decode_fn("stacked_hourglass", stride=4)
    tb, tp = decode(torch.from_numpy(out))
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=0, atol=1e-6)
    want = JP.detections_from_dense(jb, jp)
    got = TP.detections_from_dense(tb, tp)
    for key in ("classes", "valid", "num_valid"):
        np.testing.assert_array_equal(got[key].numpy(),
                                      np.asarray(want[key]), err_msg=key)
    np.testing.assert_allclose(got["boxes"].numpy(),
                               np.asarray(want["boxes"]), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["scores"].numpy(),
                               np.asarray(want["scores"]), rtol=0, atol=1e-6)
    assert int(got["num_valid"].min()) > 0
    with pytest.raises(ValueError, match="canvas"):
        TE.hourglass_decode_fn("hourglass")
