"""The space-to-depth stem of the PyTorch port against the JAX package's,
on the CPU.

`ConvBN(s2d=True)` and `ResNet(s2d_stem=True)` evaluate the 7x7/s2 stem
conv as a 4x4/s1 conv over space-to-depth input (`layers.S2DConv7x7`), for
the plain stem ("SAME", ``pad_low`` 2) and the ``:keras`` / ``:torch``
stems (explicit (3, 3) padding, ``pad_low`` 3; Keras's conv has a bias).
Both sides get the same numpy weights (trees of `jax.eval_shape`'s
shapes, converted by `tools.from_flax`) and the same images: 32 px for a
ConvBN, 64 px for a ResNet (the JAX test's size: at 32 px the last stage
is 1 x 1, so training-mode BatchNorm there normalizes two values a channel
and turns float32 rounding into differences of 1e-3):

- float32 forwards to rtol = atol = 2e-5, the bound of the JAX package's
  own `tests/test_models.py::test_s2d_stem_exact_equivalence`; the
  parameter gradients of a fixed projection of the output against
  `jax.grad`, each leaf to 2e-5 of its largest magnitude; the port's s2d
  forward against its own plain forward to the same bound;
- bf16 within JAX's own bf16 error on the same inputs
  (``max|port_bf16 - jax_bf16| <= 2 * max|jax_bf16 - jax_fp32| + 1e-3``,
  `tests/test_torch_bf16.py`'s bound);
- ``DETECTAX_S2D_STEM=1`` is read when ``s2d_stem`` is None, and an odd H
  or W takes the plain stem, as in the JAX package; the parameter tree
  is that of the plain stem.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detectax.models import layers as JL
from detectax.models.backbones import ResNet as JResNet
from detectax_torch.models import layers as TL
from detectax_torch.models.backbones import ResNet as TResNet
from detectax_torch.tools import from_flax as FF

RTOL = ATOL = 2e-5   # tests/test_models.py::test_s2d_stem_exact_equivalence
GRAD_RTOL = 2e-5     # of each gradient leaf's largest magnitude
BATCH, WIDTH = 2, 8
IMG = {"convbn": 32, "resnet": 64}
STAGES = (1, 1, 1, 1)
# stem convention -> (ResNet keywords, ConvBN padding, conv bias)
STEMS = {"plain": ({}, "SAME", False),
         "keras": ({"keras_compat": True}, ((3, 3), (3, 3)), True),
         "torch": ({"torch_compat": True}, ((3, 3), (3, 3)), False)}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """torch on one thread: the models are tiny, and beside the suite's
    other workers a pool of threads waits on busy cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def numpy_trees(module, seed, shape=(BATCH, 32, 32, 3)):
    """(params, batch_stats) in the tree `jax.eval_shape` gives for
    ``module``'s init (no Flax init is run), values from numpy: kernels
    LeCun-normal, biases and BatchNorm parameters non-trivial, running
    statistics near their init."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: module.init(
        jax.random.key(0), jnp.zeros(shape), train=False))

    def fill(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "kernel":
            v = rng.normal(0.0, np.sqrt(1.0 / np.prod(shape[:-1])), shape)
        elif name == "scale":
            v = rng.uniform(0.5, 1.5, shape)
        elif name == "bias":
            v = rng.normal(0.0, 0.1, shape)
        elif name == "mean":
            v = rng.normal(0.0, 0.2, shape)
        elif name == "var":
            v = rng.uniform(0.5, 2.0, shape)
        else:
            raise KeyError(name)
        return np.asarray(v, np.float32)

    return (jax.tree_util.tree_map_with_path(fill, shapes["params"]),
            jax.tree_util.tree_map_with_path(fill, shapes["batch_stats"]))


def images(seed, h, w=None):
    return np.random.default_rng(seed).normal(
        size=(BATCH, h, h if w is None else w, 3)).astype(np.float32)


def jax_resnet(stem, s2d, dtype=jnp.float32):
    return JResNet(stage_sizes=STAGES, width=WIDTH, s2d_stem=s2d,
                   dtype=dtype, **STEMS[stem][0])


def torch_resnet(stem, s2d, params, stats, dtype=torch.float32):
    model = TResNet(stage_sizes=STAGES, width=WIDTH, s2d_stem=s2d,
                    dtype=dtype, **STEMS[stem][0])
    return FF.load_flax(model, params, stats)


def jax_convbn(stem, s2d, dtype=jnp.float32):
    _, padding, bias = STEMS[stem]
    return JL.ConvBN(WIDTH, kernel=7, stride=2, padding=padding,
                     use_bias=bias, s2d=s2d, dtype=dtype)


def torch_convbn(stem, s2d, params, stats, dtype=torch.float32):
    _, padding, bias = STEMS[stem]
    model = TL.ConvBN(3, WIDTH, kernel=7, stride=2, padding=padding,
                      use_bias=bias, s2d=s2d, dtype=dtype)
    return FF.load_flax(model, params, stats)


def nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def as_dict(out) -> dict:
    """A ResNet's taps, or a ConvBN's output under one key."""
    return out if isinstance(out, dict) else {"out": out}


def jax_outputs(module, params, stats, x, train):
    out = module.apply({"params": params, "batch_stats": stats}, x,
                       train=train,
                       mutable=["batch_stats"] if train else False)
    return as_dict(out[0] if train else out)


def jax_apply(module, params, stats, x, train):
    """`jax_outputs` jitted (one compile is quicker here than the
    operations one by one) as float32 numpy."""
    out = jax.jit(jax_outputs, static_argnums=(0, 4))(
        module, params, stats, jnp.asarray(x), train)
    return {k: np.asarray(v, np.float32) for k, v in out.items()}


def torch_apply(model, x, train):
    with torch.no_grad():
        out = as_dict(model(nchw(x), train))
    return {k: v.permute(0, 2, 3, 1).float().numpy() for k, v in out.items()}


def projections(outs: dict, seed: int) -> dict:
    """A fixed random [B, H, W, C] weight per output: the gradient test's
    scalar is the sum of each output times its weight."""
    rng = np.random.default_rng(seed)
    return {k: rng.normal(size=v.shape).astype(np.float32)
            for k, v in sorted(outs.items())}


PAIRS = {"convbn": (jax_convbn, torch_convbn),
         "resnet": (jax_resnet, torch_resnet)}


def build_pair(kind, stem, seed):
    jmake, tmake = PAIRS[kind]
    jm = jmake(stem, True)
    params, stats = numpy_trees(jm, seed)
    return jm, tmake(stem, True, params, stats), params, stats


# training-mode BatchNorm in the ResNet's last stages (2 x 2 at 64 px)
# normalizes 8 values a channel, which turns float32 rounding into
# differences past 2e-5 whatever the stem; a ConvBN's 512 values do not
MODES = {"convbn": (False, True), "resnet": (False,)}


@pytest.mark.parametrize("stem", list(STEMS))
@pytest.mark.parametrize("kind", list(PAIRS))
def test_s2d_forward_matches_jax(kind, stem):
    jm, tm, params, stats = build_pair(kind, stem, 1)
    stem_block = tm.stem if kind == "resnet" else tm
    assert isinstance(stem_block.Conv_0, TL.S2DConv7x7)
    x = images(2, IMG[kind])
    for train in MODES[kind]:
        want = jax_apply(jm, params, stats, x, train)
        got = torch_apply(tm, x, train)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=RTOL,
                                       atol=ATOL, err_msg=f"{k} {train}")


@pytest.mark.parametrize("stem", list(STEMS))
@pytest.mark.parametrize("kind", list(PAIRS))
def test_s2d_gradients_match_jax_grad(kind, stem):
    """Gradients of every parameter (the 7x7 kernel through the repack)
    of sum(output * w), against `jax.grad`: each leaf to `GRAD_RTOL` of
    its largest magnitude, or in training mode, where BatchNorm gives the
    conv's bias a gradient of 0, of the layer's largest."""
    jm, tm, params, stats = build_pair(kind, stem, 3)
    x = images(4, IMG[kind])
    for train in MODES[kind]:
        w = projections(jax_apply(jm, params, stats, x, train), 5)

        def jloss(p):
            out = jax_outputs(jm, p, stats, jnp.asarray(x), train)
            return sum(jnp.sum(v * w[k]) for k, v in out.items())

        want = FF.from_flax(jax.tree.map(np.asarray,
                                         jax.jit(jax.grad(jloss))(params)))
        out = as_dict(tm(nchw(x), train))
        loss = sum((v.permute(0, 2, 3, 1) * torch.from_numpy(w[k])).sum()
                   for k, v in out.items())
        names = [n for n, _ in tm.named_parameters()]
        grads = torch.autograd.grad(loss, [p for _, p in
                                           tm.named_parameters()])
        assert set(names) == set(want)
        largest = max(float(np.abs(g.numpy()).max()) for g in want.values())
        for name, g in zip(names, grads):
            ref = want[name].numpy()
            err = float(np.abs(g.numpy() - ref).max())
            scale = largest if train else float(np.abs(ref).max())
            assert err <= GRAD_RTOL * scale, (name, train, err, scale)


@pytest.mark.parametrize("stem", list(STEMS))
@pytest.mark.parametrize("kind", list(PAIRS))
def test_s2d_equals_plain_stem(kind, stem):
    """The port's two evaluations of one set of weights; the parameter
    tree is the plain stem's, name for name and shape for shape."""
    jmake, tmake = PAIRS[kind]
    params, stats = numpy_trees(jmake(stem, False), 6)
    s2d = tmake(stem, True, params, stats)
    plain = tmake(stem, False, params, stats)
    assert {k: v.shape for k, v in s2d.state_dict().items()} == \
        {k: v.shape for k, v in plain.state_dict().items()}
    x = images(7, IMG[kind])
    for train in MODES[kind]:
        want = torch_apply(plain, x, train)
        got = torch_apply(s2d, x, train)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=RTOL,
                                       atol=ATOL, err_msg=f"{k} {train}")


@pytest.mark.parametrize("stem", list(STEMS))
def test_s2d_bf16_within_jax_bf16_error(stem):
    """bf16 compute (float32 parameters, the image cast at the stem) on
    the whole trunk, in both modes: the port within twice JAX's own bf16
    error plus 1e-3 on every tap."""
    params, stats = numpy_trees(jax_resnet(stem, True), 8)
    x = images(9, IMG["resnet"])
    t16 = torch_resnet(stem, True, params, stats, torch.bfloat16)
    for train in (False, True):
        j32 = jax_apply(jax_resnet(stem, True), params, stats, x, train)
        j16 = jax_apply(jax_resnet(stem, True, jnp.bfloat16), params, stats,
                        x, train)
        got = torch_apply(t16, x, train)
        for k in j32:
            jax_err = float(np.abs(j16[k] - j32[k]).max())
            assert jax_err > 0, k   # bf16 really happened
            err = float(np.abs(got[k] - j16[k]).max())
            assert err <= 2 * jax_err + 1e-3, (k, train, err, jax_err)


def test_env_switch_and_odd_sides(monkeypatch):
    """``s2d_stem=None`` reads ``DETECTAX_S2D_STEM=1`` at the call; an odd
    H or W takes the plain stem (as JAX's ResNet does), and a ConvBN built
    with s2d refuses one."""
    params, stats = numpy_trees(jax_resnet("plain", None), 10)
    model = torch_resnet("plain", None, params, stats)
    calls = []
    repack = model.stem.Conv_0.s2d_kernel
    monkeypatch.setattr(model.stem.Conv_0, "s2d_kernel",
                        lambda dtype: calls.append(dtype) or repack(dtype))
    x = images(11, IMG["resnet"])
    monkeypatch.delenv("DETECTAX_S2D_STEM", raising=False)
    plain = torch_apply(model, x, False)
    assert calls == []
    monkeypatch.setenv("DETECTAX_S2D_STEM", "1")
    s2d = torch_apply(model, x, False)
    assert calls == [torch.float32]
    for k in plain:
        np.testing.assert_allclose(s2d[k], plain[k], rtol=RTOL, atol=ATOL)
    want = jax_apply(jax_resnet("plain", None), params, stats, x, False)
    for k in want:
        np.testing.assert_allclose(s2d[k], want[k], rtol=RTOL, atol=ATOL)
    # the switch off, and an explicit False, keep the plain stem
    monkeypatch.setenv("DETECTAX_S2D_STEM", "0")
    torch_apply(model, x, False)
    monkeypatch.setenv("DETECTAX_S2D_STEM", "1")
    torch_apply(torch_resnet("plain", False, params, stats), x, False)
    assert len(calls) == 1
    # odd sides: the plain stem, as JAX's `s2d_stem=True` on the same input
    for h, w in ((65, 64), (64, 63)):
        odd = images(12, h, w)
        got = torch_apply(model, odd, False)
        assert len(calls) == 1
        want = jax_apply(jax_resnet("plain", True), params, stats, odd, False)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL)
    conv = torch_convbn("plain", True, *numpy_trees(jax_convbn("plain", True),
                                                     13, (1, 8, 8, 3)))
    with pytest.raises(ValueError, match="even"):
        conv(torch.zeros(1, 3, 9, 8))
    with pytest.raises(ValueError, match="s2d"):
        TL.ConvBN(3, 8, kernel=3, stride=2, s2d=True)
    with pytest.raises(ValueError, match="padding"):
        TL.ConvBN(3, 8, kernel=7, stride=2, padding="VALID", s2d=True)
