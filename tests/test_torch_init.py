"""The port's seeded init against Flax's `lecun_normal()`.

Every JAX conv and dense kernel is drawn by Flax's ``lecun_normal()``:
``variance_scaling(1, "fan_in", "truncated_normal")``, a standard normal
truncated to [-2, 2] times sqrt(1/fan_in) / 0.87962566103423978.
`detectax_torch.models.layers.init_parameters` must draw the same
distribution (not the same bits). For each kind of kernel the JAX package
draws, the port's draw, scaled by sqrt(fan_in), is held to Flax's bound,
to unit deviation within 3 %, and to Flax's own draw on the same
Flax-layout shape by a two-sample Kolmogorov-Smirnov test at the 0.1 %
level. Each kind is drawn at a width that gives at least 30,000 values.
"""
from __future__ import annotations

import math

import numpy as np
import pytest
import torch
from scipy import stats

from detectax_torch.models import FCOS, HourglassNet
from detectax_torch.models import backbones as TB
from detectax_torch.models.layers import (
    FOCAL_BIAS,
    TRUNC_NORMAL_STD,
    BatchNorm,
    Conv,
    ConvBN,
    FocalBias,
    S2DConv7x7,
    init_parameters,
)

BOUND = 2.0 / TRUNC_NORMAL_STD + 1e-6
KS_ALPHA = 1e-3


def _conv(cin, cout, k, groups=1):
    return Conv(cin, cout, k, use_bias=False, groups=groups)


# the kernel kinds the JAX package draws, a factory of each layer
KINDS = {
    # a 3x3 dense conv (ResNet, FPN, the towers): 36,864 values
    "conv3x3": lambda: _conv(64, 64, 3),
    # a 1x1 conv (bottleneck projections, FPN laterals): 32,768 values
    "conv1x1": lambda: _conv(256, 128, 1),
    # MobileNetV2's depthwise 3x3 (fan_in 9): 31,104 values
    "depthwise3x3": lambda: _conv(3456, 3456, 3, groups=3456),
    # the 7x7/s2 stem over 3 channels, plain and space-to-depth: 37,632
    "stem7x7": lambda: ConvBN(3, 256, 7, stride=2).Conv_0,
    "s2d_stem7x7": lambda: S2DConv7x7(3, 256),
    # the crop classifier's float32 dense head: 32,768 values
    "cls_head": lambda: torch.nn.Linear(2048, 16),
}


def _flax_shape(layer: torch.nn.Module) -> tuple:
    w = layer.weight
    if w.ndim == 2:                      # Dense: [in, out]
        return (w.shape[1], w.shape[0])
    f, cin_g, kh, kw = w.shape          # Conv: [kh, kw, in / groups, out]
    return (kh, kw, cin_g, f)


def _port_draw(make, seed: int = 0) -> tuple[np.ndarray, int]:
    layer = make()
    assert isinstance(layer, (torch.nn.Conv2d, torch.nn.Linear))
    init_parameters(layer, torch.Generator().manual_seed(seed))
    w = layer.weight.detach().numpy().ravel()
    fan_in = int(np.prod(layer.weight.shape[1:]))
    return w, fan_in


def _flax_draw(shape: tuple, seed: int = 0) -> np.ndarray:
    import jax
    import jax.numpy as jnp
    from flax.linen.initializers import lecun_normal

    w = lecun_normal()(jax.random.PRNGKey(seed), shape, jnp.float32)
    return np.asarray(w).ravel()


@pytest.mark.parametrize("kind", list(KINDS))
def test_draw_matches_flax_lecun_normal(kind):
    layer = KINDS[kind]()
    w, fan_in = _port_draw(KINDS[kind])
    assert w.size >= 30_000
    shape = _flax_shape(layer)
    assert int(np.prod(shape[:-1])) == fan_in
    z = w * math.sqrt(fan_in)
    assert np.abs(z).max() <= BOUND
    assert abs(z.std() - 1.0) <= 0.03
    flax_z = _flax_draw(shape) * math.sqrt(fan_in)
    assert np.abs(flax_z).max() <= BOUND
    ks = stats.ks_2samp(z, flax_z)
    assert ks.pvalue >= KS_ALPHA, (kind, ks)


def test_untruncated_draw_fails_the_ks_test():
    """The test has power: the port's former draw (an untruncated normal of
    variance 1/fan_in) on the 3x3 shape is told apart from Flax's."""
    layer = KINDS["conv3x3"]()
    fan_in = layer.weight[0].numel()
    g = torch.Generator().manual_seed(0)
    z = torch.empty(layer.weight.shape).normal_(0.0, 1.0, generator=g)
    z = z.numpy().ravel()
    flax_z = _flax_draw(_flax_shape(layer)) * math.sqrt(fan_in)
    assert np.abs(z).max() > BOUND
    assert stats.ks_2samp(z, flax_z).pvalue < KS_ALPHA


def _tiny_fcos(monkeypatch):
    monkeypatch.setitem(
        TB.BACKBONES, "resnet_1111",
        lambda **kw: TB.ResNet(stage_sizes=(1, 1, 1, 1), width=8, **kw))
    return FCOS(num_classes=3, backbone="resnet_1111", features=16,
                generator=torch.Generator().manual_seed(0))


@pytest.mark.parametrize("model", ["fcos", "hourglass"])
def test_seeded_model_meets_the_bound(model, monkeypatch):
    m = (_tiny_fcos(monkeypatch) if model == "fcos" else HourglassNet(
        num_classes=3, n_filters=4, n_features=16,
        generator=torch.Generator().manual_seed(0)))
    kernels = focal = 0
    for name, mod in m.named_modules():
        if isinstance(mod, (torch.nn.Conv2d, torch.nn.Linear)):
            fan_in = mod.weight[0].numel()
            z = mod.weight.detach().abs().max().item() * math.sqrt(fan_in)
            assert z <= BOUND, name
            kernels += 1
            if mod.bias is not None:
                want = FOCAL_BIAS if getattr(mod, "focal_bias", False) else 0
                focal += want != 0
                assert torch.all(mod.bias == want), name
        elif isinstance(mod, BatchNorm):
            assert torch.all(mod.weight == 1) and torch.all(mod.bias == 0)
            assert torch.all(mod.running_mean == 0)
            assert torch.all(mod.running_var == 1)
        elif isinstance(mod, FocalBias):
            assert mod.bias.item() == pytest.approx(mod.init_value)
    assert kernels > 10
    if model == "fcos":
        assert focal == 5           # the five class heads' focal prior


def test_same_seed_same_weights_new_seed_new_weights():
    a, _ = _port_draw(KINDS["conv1x1"], seed=0)
    b, _ = _port_draw(KINDS["conv1x1"], seed=0)
    c, _ = _port_draw(KINDS["conv1x1"], seed=1)
    assert np.array_equal(a, b)
    assert not np.array_equal(a, c)
