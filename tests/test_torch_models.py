"""Models of the PyTorch port against the JAX package, on the CPU.

Weights are initialised by Flax, perturbed with numpy (non-trivial
BatchNorm scale/bias and running mean/var), converted with
`detectax_torch.tools.from_flax` and loaded strictly; the same numpy image
batch then goes through both forwards.

Tolerance: atol 1e-4 on outputs of order 1 — both sides compute fp32
convolutions but sum the products in different orders, and the difference
grows with depth (50 layers for ResNet-50).
"""
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detectax.models import layers as JL
from detectax.models.backbones import build_backbone as j_build_backbone
from detectax.models.fcos import FCOS as JFCOS
from detectax.ops.pool import max_pool_3x3_s2 as j_max_pool
from detectax_torch.models import layers as TL
from detectax_torch.models.backbones import build_backbone as t_build_backbone
from detectax_torch.models.fcos import FCOS as TFCOS
from detectax_torch.ops.pool import max_pool_3x3_s2 as t_max_pool
from detectax_torch.ops.pool import same_pad
from detectax_torch.tools import from_flax as FF


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """torch on one thread: the models are tiny, and beside the suite's
    other workers a pool of threads a process waits on busy cores at every
    operation (tens of times slower)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


ATOL = 1e-4
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _numpy_tree(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _perturb(params, batch_stats, rng):
    """Non-trivial BN parameters and running statistics, and non-zero conv
    biases, made with numpy."""
    def walk(tree, path=()):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v, path + (k,))
                continue
            v = np.array(v, np.float32)
            if k == "scale":
                v = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
            elif k == "bias":
                v = v + rng.normal(scale=0.1, size=v.shape).astype(np.float32)
            elif k == "mean":
                v = rng.normal(scale=0.2, size=v.shape).astype(np.float32)
            elif k == "var":
                v = rng.uniform(0.5, 2.0, v.shape).astype(np.float32)
            out[k] = v
        return out

    return walk(_numpy_tree(params)), walk(_numpy_tree(batch_stats))


def _init_flax(module, images, rng):
    variables = module.init(jax.random.key(0), jnp.asarray(images),
                            train=False)
    return _perturb(variables["params"], variables["batch_stats"], rng)


@functools.lru_cache(maxsize=None)
def _tiny_fcos_variables(variant):
    """Perturbed Flax variables of a tiny 5-class FCOS (the parameters do
    not depend on the canvas, so every test of a variant shares them)."""
    rng = np.random.default_rng(11)
    jm = JFCOS(num_classes=5, variant=variant, backbone="tiny")
    return _init_flax(jm, np.zeros((1, 64, 64, 3), np.float32), rng)


def _images(rng, n, size):
    return rng.uniform(-1, 1, size=(n, size, size, 3)).astype(np.float32)


# --------------------------------------------------------------------------
# padding, pooling, resampling
# --------------------------------------------------------------------------

@pytest.mark.parametrize("size", [6, 7, 12, 384])
@pytest.mark.parametrize("k,s", [(3, 2), (7, 2), (3, 1), (1, 1)])
def test_same_pad_is_xla_same(size, k, s):
    want = jax.lax.padtype_to_pads((size,), (k,), (s,), "SAME")[0]
    assert same_pad(size, k, s) == tuple(want)


def test_same_pad_named_cases():
    assert same_pad(384, 3, 2) == (0, 1)   # even side
    assert same_pad(3, 3, 2) == (1, 1)     # odd side
    assert same_pad(384, 7, 2) == (2, 3)   # the stem


@pytest.mark.parametrize("hw", [(8, 8), (7, 9), (6, 5)])
def test_max_pool_3x3_s2(rng, hw):
    x = rng.normal(size=(2, *hw, 3)).astype(np.float32)
    want = np.asarray(j_max_pool(jnp.asarray(x)))
    got = t_max_pool(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)


@pytest.mark.parametrize("method", ["nearest", "bilinear"])
@pytest.mark.parametrize("src,dst", [((3, 3), (6, 6)), ((3, 3), (5, 5)),
                                     ((5, 3), (9, 6)), ((4, 4), (4, 4))])
def test_upsample_to(rng, method, src, dst):
    """2x nearest is a repeat on both sides; for any other shape the JAX
    package falls back to `jax.image.resize`, and the port to
    `F.interpolate` with "nearest-exact" / half-pixel bilinear."""
    x = rng.normal(size=(2, *src, 4)).astype(np.float32)
    want = np.asarray(JL.upsample_to(jnp.asarray(x), dst, method))
    got = TL.upsample_to(torch.from_numpy(x), dst, method).numpy()
    assert got.shape == want.shape
    # nearest copies values; bilinear blends with fp32 weights
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=0 if method == "nearest" else 1e-6)


@pytest.mark.parametrize("method", ["nearest", "bilinear"])
def test_upsample2x(rng, method):
    x = rng.normal(size=(1, 3, 5, 2)).astype(np.float32)
    want = np.asarray(JL.upsample2x(jnp.asarray(x), method))
    got = TL.upsample2x(torch.from_numpy(x), method).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_space_to_depth_roundtrip(rng):
    """The port's re-layouts run on NCHW (`HourglassNet` concatenates its
    stage outputs with them) and pack the channels (dy, dx, c) as the JAX
    package's NHWC functions do."""
    for block in (2, 4, 8):
        x = rng.normal(size=(2, 16, 8, 3 * block * block)).astype(
            np.float32)
        want = np.asarray(JL.space_to_depth(jnp.asarray(x), block))
        got = TL.space_to_depth_nchw(
            torch.from_numpy(x).permute(0, 3, 1, 2), block)
        np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)
        np.testing.assert_array_equal(
            TL.depth_to_space_nchw(got, block).permute(0, 2, 3, 1).numpy(),
            x)
        np.testing.assert_array_equal(
            TL.depth_to_space_nchw(torch.from_numpy(x).permute(0, 3, 1, 2),
                                   block).permute(0, 2, 3, 1).numpy(),
            np.asarray(JL.depth_to_space(jnp.asarray(x), block)))
        np.testing.assert_array_equal(
            np.asarray(JL.depth_to_space(jnp.asarray(want), block)), x)


def test_focal_bias_and_seeded_init():
    assert TL.FOCAL_BIAS == JL.FOCAL_BIAS
    a = TFCOS(3, backbone="tiny")
    b = TFCOS(3, backbone="tiny")
    c = TFCOS(3, backbone="tiny",
              generator=torch.Generator().manual_seed(7))
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["fpn.c3_1x1.weight"], sc["fpn.c3_1x1.weight"])
    np.testing.assert_allclose(
        sa["cls_head_1.Conv_0.bias"].numpy(), JL.FOCAL_BIAS, rtol=1e-6)
    assert float(sa["reg_head_1.Conv_0.bias"].abs().max()) == 0.0


def test_batchnorm_training_branch_is_deferred():
    """The training branch arrived with the training path (it raised
    before): batch statistics normalize, the running averages move by
    Flax's momentum 0.9 with the biased variance, and ``train=False`` goes
    on using the running averages. `tests/test_torch_train.py` holds it
    against the Flax module."""
    bn = TL.BatchNorm(4)
    x = torch.arange(16, dtype=torch.float32).reshape(1, 4, 2, 2)
    y = bn(x, train=True)
    assert torch.allclose(y.mean(dim=(0, 2, 3)), torch.zeros(4), atol=1e-6)
    mean = x.mean(dim=(0, 2, 3))
    var = x.var(dim=(0, 2, 3), unbiased=False)
    assert torch.allclose(bn.running_mean, 0.1 * mean)
    assert torch.allclose(bn.running_var, 0.9 + 0.1 * var)
    assert not torch.allclose(bn(x, train=False), y)


def test_convbn_s2d_stem_is_the_plain_conv(rng):
    """`s2d=True` is a re-evaluation of the same 7x7/s2 conv in the JAX
    package; the port runs the plain conv and must match it."""
    x = rng.normal(size=(1, 16, 16, 3)).astype(np.float32)
    jm = JL.ConvBN(8, kernel=7, stride=2, s2d=True)
    params, stats = _init_flax(jm, x, rng)
    want = np.asarray(jm.apply({"params": params, "batch_stats": stats},
                               jnp.asarray(x), train=False))
    tm = TL.ConvBN(3, 8, kernel=7, stride=2, s2d=True)
    FF.load_flax(tm, params, stats)
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=0, atol=1e-5)


# --------------------------------------------------------------------------
# FCOS forward parity per level
# --------------------------------------------------------------------------

@pytest.mark.parametrize("variant", ["fcos", "center", "center_v1"])
@pytest.mark.parametrize("size", [64, 96])  # 96: odd level sizes (3, 2, 1)
def test_fcos_tiny_forward_parity(rng, variant, size):
    images = _images(rng, 2, size)
    jm = JFCOS(num_classes=5, variant=variant, backbone="tiny")
    params, stats = _tiny_fcos_variables(variant)
    want = jm.apply({"params": params, "batch_stats": stats},
                    jnp.asarray(images), train=False)

    tm = TFCOS(num_classes=5, variant=variant, backbone="tiny")
    FF.load_flax(tm, params, stats)
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(images))
    assert len(got) == len(want) == 5
    for lvl, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == torch.float32
        assert tuple(g.shape) == tuple(w.shape), lvl
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=ATOL, err_msg=f"level {lvl}")


@pytest.mark.parametrize("name", [
    "resnet50", "resnext50", "mobilenetv2", "resnet50:keras",
    "resnext50:torch",
])
def test_backbone_forward_parity(rng, name):
    images = _images(rng, 1, 64)
    jm = j_build_backbone(name)
    params, stats = _init_flax(jm, images, rng)
    want = jm.apply({"params": params, "batch_stats": stats},
                    jnp.asarray(images), train=False)

    tm = t_build_backbone(name)
    FF.load_flax(tm, params, stats)
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(images).permute(0, 3, 1, 2))
    assert set(got) == set(want) == {"c3", "c4", "c5"}
    for tap in ("c3", "c4", "c5"):
        g = got[tap].permute(0, 2, 3, 1).numpy()
        w = np.asarray(want[tap])
        assert g.shape == w.shape, tap
        assert tm.out_channels[tap] == w.shape[-1]
        np.testing.assert_allclose(g, w, rtol=0, atol=ATOL, err_msg=tap)


def _small_resnet_input_grad(jm, tm, params, stats, images, taps_w):
    """Gradient of sum(tap * weights) over C3-C5 with respect to the input,
    through the JAX trunk (traced anew at each call, so the environment is
    read then) and the port's."""
    def j_loss(x):
        out = jm.apply({"params": params, "batch_stats": stats}, x,
                       train=False)
        return sum(jnp.sum(out[t] * taps_w[t]) for t in taps_w)

    want = np.asarray(jax.jit(jax.grad(j_loss))(jnp.asarray(images)))
    x = torch.from_numpy(images).permute(0, 3, 1, 2).requires_grad_(True)
    out = tm(x, train=False)
    loss = sum((out[t] * torch.from_numpy(w).permute(0, 3, 1, 2)).sum()
               for t, w in taps_w.items())
    loss.backward()
    return x.grad.permute(0, 2, 3, 1).numpy(), want


def test_pool_vjp_variable_reaches_the_resnet_stem(rng, monkeypatch):
    """``DETECTAX_POOL_VJP=1`` swaps in the tied-window pool backward at
    the ResNet stem (`max_pool_3x3_s2(tied_vjp=None)`), as in the JAX
    package: the input gradient of a small ResNet matches JAX's under the
    variable, equals the port's with ``tied_vjp=True`` passed in, and
    differs from the default's (the ReLU'd stem leaves tied windows)."""
    from detectax.models.backbones import ResNet as JResNet
    from detectax_torch.models import backbones as TB
    from detectax_torch.ops import pool as TP

    # constant 16x16 patches: the 7x7 stem's outputs repeat inside a
    # patch, so the pool's windows hold ties above zero
    images = np.repeat(np.repeat(_images(rng, 2, 4), 16, axis=1), 16, axis=2)
    jm = JResNet(stage_sizes=(1, 1, 1, 1), width=8)
    params, stats = _init_flax(jm, images, rng)
    tm = TB.ResNet(stage_sizes=(1, 1, 1, 1), width=8)
    FF.load_flax(tm, params, stats)
    tm.eval()
    shapes = {t: o.shape for t, o in jax.eval_shape(
        lambda x: jm.apply({"params": params, "batch_stats": stats}, x,
                           train=False), jnp.asarray(images)).items()}
    taps_w = {t: rng.normal(size=shapes[t]).astype(np.float32)
              for t in ("c3", "c4", "c5")}

    monkeypatch.delenv("DETECTAX_POOL_VJP", raising=False)
    plain, plain_jax = _small_resnet_input_grad(jm, tm, params, stats,
                                                images, taps_w)
    monkeypatch.setenv("DETECTAX_POOL_VJP", "1")
    tied, tied_jax = _small_resnet_input_grad(jm, tm, params, stats,
                                              images, taps_w)
    scale = float(np.abs(tied_jax).max())
    np.testing.assert_allclose(tied, tied_jax, rtol=0, atol=ATOL * scale)
    np.testing.assert_allclose(plain, plain_jax, rtol=0, atol=ATOL * scale)
    assert np.abs(tied_jax - plain_jax).max() > 100 * ATOL * scale
    assert np.abs(tied - plain).max() > 100 * ATOL * scale

    monkeypatch.delenv("DETECTAX_POOL_VJP")
    monkeypatch.setattr(TB, "max_pool_3x3_s2",
                        functools.partial(TP.max_pool_3x3_s2, tied_vjp=True))
    forced, _ = _small_resnet_input_grad(jm, tm, params, stats, images,
                                         taps_w)
    np.testing.assert_array_equal(forced, tied)


def test_build_backbone_rejects_unknown():
    with pytest.raises(ValueError, match="unknown backbone"):
        t_build_backbone("vgg")
    with pytest.raises(ValueError, match="compat"):
        t_build_backbone("tiny:keras")
    with pytest.raises(ValueError, match="compat"):
        t_build_backbone("resnet50:caffe")
    assert isinstance(t_build_backbone("mobilenetv2:keras"), torch.nn.Module)


# --------------------------------------------------------------------------
# the converter
# --------------------------------------------------------------------------

def test_from_flax_is_strict(rng):
    params, stats = _tiny_fcos_variables("fcos")
    tm = TFCOS(num_classes=5, backbone="tiny")

    sd = FF.from_flax(params, stats, tm)
    assert set(sd) == set(tm.state_dict())
    # HWIO -> OIHW
    k = params["fpn"]["c3_3x3"]["kernel"]
    np.testing.assert_array_equal(sd["fpn.c3_3x3.weight"].numpy(),
                                  k.transpose(3, 2, 0, 1))

    extra = {**params, "fpn": {**params["fpn"], "c9_1x1": {"kernel": k}}}
    with pytest.raises(KeyError, match="no place in the model"):
        FF.from_flax(extra, stats, tm)
    odd = {**params, "fpn": {**params["fpn"], "c3_1x1": {"gamma": k}}}
    with pytest.raises(KeyError, match="unknown leaf"):
        FF.from_flax(odd, stats, tm)
    fewer = {k_: v for k_, v in params.items() if k_ != "cls_tower"}
    with pytest.raises(KeyError, match="did not fill"):
        FF.from_flax(fewer, stats, tm)
    with pytest.raises(KeyError, match="did not fill"):
        FF.from_flax(params, {}, tm)
    with pytest.raises(ValueError, match="shape"):
        FF.from_flax(params, stats, TFCOS(num_classes=4, backbone="tiny"))


def test_to_flax_and_npz_roundtrip(rng, tmp_path):
    params, stats = _tiny_fcos_variables("center")
    tm = FF.load_flax(TFCOS(5, variant="center", backbone="tiny"),
                      params, stats)
    p2, s2 = FF.to_flax(tm)
    flat = lambda t: {"/".join(str(getattr(k, "key", k)) for k in path): v
                      for path, v in jax.tree_util.tree_leaves_with_path(t)}
    for a, b in ((flat(params), flat(p2)), (flat(stats), flat(s2))):
        assert set(a) == set(b)
        for key in a:
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    # a weights file written from the JAX package's trees (as numpy) is
    # read back by the port's numpy-only reader
    path = str(tmp_path / "weights.npz")
    FF.save_npz(path, params, stats)
    p3, s3 = FF.load_npz(path)
    for a, b in ((flat(params), flat(p3)), (flat(stats), flat(s3))):
        assert set(a) == set(b)
        for key in a:
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def test_converter_on_committed_mobilenetv2_backbone(rng):
    """The committed pretrained MobileNetV2 backbone (Flax msgpack, read
    through Flax here, never in the port): every key is consumed, every
    entry of the port's module is filled, and the taps match at 64 px."""
    from flax import serialization

    path = os.path.join(REPO, "benchmarks", "runs", "pretrain_mbv2",
                        "backbone.msgpack")
    with open(path, "rb") as f:
        tree = serialization.msgpack_restore(f.read())
    params, stats = tree["params"], tree["batch_stats"]

    tm = t_build_backbone("mobilenetv2")
    sd = FF.from_flax(params, stats, tm)  # raises on any leftover
    n_leaves = len(jax.tree.leaves(params)) + len(jax.tree.leaves(stats))
    assert len(sd) == n_leaves == len(tm.state_dict())
    tm.load_state_dict(sd, strict=True)

    images = _images(rng, 1, 64)
    want = j_build_backbone("mobilenetv2").apply(
        {"params": params, "batch_stats": stats}, jnp.asarray(images),
        train=False)
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(images).permute(0, 3, 1, 2))
    for tap in ("c3", "c4", "c5"):
        np.testing.assert_allclose(
            got[tap].permute(0, 2, 3, 1).numpy(), np.asarray(want[tap]),
            rtol=0, atol=ATOL, err_msg=tap)
