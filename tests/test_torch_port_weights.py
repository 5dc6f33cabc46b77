"""The port's weight-import tool (`detectax_torch.tools.port_tf_weights`)
against the JAX package's mappings, on the CPU.

Each mapping of the port gives the JAX mapping's arrays key for key,
exactly; the `.npz` it writes loads into the port's trunk, whose C3/C4/C5
then match the source model's on one 64 px image: relative error 1e-4 of
the tap's largest magnitude (both sides sum fp32 products in their own
orders over 50 layers). The source models are a torchvision-layout
ResNeXt-50 32x4d built inline with `torch.nn`, and Keras `ResNet50` /
`MobileNetV2` built with ``weights=None`` (no download) and given random
BatchNorm statistics and parameters, so that a swapped leaf shows.
TensorFlow is imported once, and each Keras model is built once."""
import os
import types

import numpy as np
import pytest
import torch
import torch.nn as tnn

from detectax.tools import port_tf_weights as JP
from detectax_torch.models.backbones import build_backbone
from detectax_torch.tools import from_flax as FF
from detectax_torch.tools import port_tf_weights as TP
from detectax_torch.train.driver import load_backbone_weights

RTOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """torch on one thread: the work is tiny, and beside the suite's other
    workers a pool of threads waits on busy cores at every operation."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), v


def _assert_same_trees(got, want):
    g, w = dict(_flat(got)), dict(_flat(want))
    assert sorted(g) == sorted(w)
    for k in w:
        assert g[k].dtype == np.float32, k
        np.testing.assert_array_equal(g[k], np.asarray(w[k]), err_msg=k)


def _assert_taps_match(trunk, x_nhwc, want):
    with torch.no_grad():
        got = trunk.eval()(torch.from_numpy(x_nhwc).permute(0, 3, 1, 2))
    for tap, w in zip(("c3", "c4", "c5"), want):
        g = got[tap].permute(0, 2, 3, 1).numpy()
        assert g.shape == w.shape, tap
        scale = float(np.abs(w).max())
        assert scale > 0, tap
        np.testing.assert_allclose(g, w, rtol=0, atol=RTOL * scale,
                                   err_msg=tap)


# --------------------------------------------------------------------------
# torchvision-layout ResNeXt-50 32x4d (no TensorFlow)
# --------------------------------------------------------------------------

class Bottleneck(tnn.Module):
    def __init__(self, inplanes, planes, stride=1, project=False):
        super().__init__()
        width = planes * 2  # 32x4d: width = planes * (4/64) * 32
        self.conv1 = tnn.Conv2d(inplanes, width, 1, bias=False)
        self.bn1 = tnn.BatchNorm2d(width)
        self.conv2 = tnn.Conv2d(width, width, 3, stride, padding=1,
                                groups=32, bias=False)
        self.bn2 = tnn.BatchNorm2d(width)
        self.conv3 = tnn.Conv2d(width, planes * 4, 1, bias=False)
        self.bn3 = tnn.BatchNorm2d(planes * 4)
        self.relu = tnn.ReLU()
        self.downsample = None
        if project:
            self.downsample = tnn.Sequential(
                tnn.Conv2d(inplanes, planes * 4, 1, stride, bias=False),
                tnn.BatchNorm2d(planes * 4),
            )

    def forward(self, x):
        idt = self.downsample(x) if self.downsample is not None else x
        h = self.relu(self.bn1(self.conv1(x)))
        h = self.relu(self.bn2(self.conv2(h)))
        h = self.bn3(self.conv3(h))
        return self.relu(h + idt)


class TorchResNeXt50(tnn.Module):
    """torchvision's ``resnext50_32x4d`` trunk, with its state-dict keys."""

    def __init__(self):
        super().__init__()
        self.conv1 = tnn.Conv2d(3, 64, 7, 2, padding=3, bias=False)
        self.bn1 = tnn.BatchNorm2d(64)
        self.relu = tnn.ReLU()
        self.maxpool = tnn.MaxPool2d(3, 2, padding=1)
        inplanes = 64
        for li, (planes, n) in enumerate(zip((64, 128, 256, 512),
                                             (3, 4, 6, 3))):
            blocks = []
            for b in range(n):
                stride = 2 if (b == 0 and li > 0) else 1
                blocks.append(Bottleneck(inplanes, planes, stride,
                                         project=(b == 0)))
                inplanes = planes * 4
            setattr(self, f"layer{li + 1}", tnn.Sequential(*blocks))

    def forward(self, x):
        h = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        h = self.layer1(h)
        c3 = self.layer2(h)
        c4 = self.layer3(c3)
        c5 = self.layer4(c4)
        return c3, c4, c5


@pytest.fixture(scope="module")
def resnext():
    torch.manual_seed(0)
    model = TorchResNeXt50()
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, tnn.BatchNorm2d):
                m.weight.uniform_(0.5, 1.5)
                m.bias.normal_(0, 0.1)
                m.running_mean.normal_(0, 0.5)
                m.running_var.uniform_(0.5, 2.0)
    return model.eval()


def test_torch_resnext_mapping_equals_jax_and_loads(resnext, tmp_path):
    sd = resnext.state_dict()
    variables = TP.port_torch_resnext(sd, "resnext50")
    _assert_same_trees(variables, JP.port_torch_resnext(sd, "resnext50"))
    assert TP.RESNEXT_STAGE_SIZES == JP.RESNEXT_STAGE_SIZES
    path = str(tmp_path / "resnext.npz")
    TP.save_ported(variables, path)
    _assert_same_trees(TP.load_ported(path), variables)

    x = np.random.default_rng(2).normal(size=(1, 64, 64, 3)) \
        .astype(np.float32)
    with torch.no_grad():
        want = [t.permute(0, 2, 3, 1).numpy()
                for t in resnext(torch.from_numpy(x).permute(0, 3, 1, 2))]
    trunk = build_backbone("resnext50:torch")
    FF.load_flax(trunk, *FF.load_npz(path))
    _assert_taps_match(trunk, x, want)


def test_main_ports_a_torchvision_state_dict(resnext, tmp_path, capsys):
    """``--arch resnext50`` reads a ``.pth`` state dict (no TensorFlow)
    and writes the ``.npz`` that a trainer's ``--init_backbone`` loads."""
    pth = str(tmp_path / "resnext50_32x4d.pth")
    torch.save(resnext.state_dict(), pth)
    out = str(tmp_path / "backbone.npz")
    TP.main(["--arch", "resnext50", "--weights", pth, "--output", out])
    assert f"ported resnext50 -> {out}" in capsys.readouterr().out
    _assert_same_trees(
        TP.load_ported(out),
        JP.port_torch_resnext(resnext.state_dict(), "resnext50"))

    from detectax_torch.models import FCOS

    model = FCOS(num_classes=3, backbone="resnext50:torch")
    state = load_backbone_weights(types.SimpleNamespace(model=model), out)
    got = state.model.backbone.state_dict()
    for k, v in FF.from_flax(*FF.load_npz(out)).items():
        assert torch.equal(got[k], v), k


# --------------------------------------------------------------------------
# Keras ResNet50 and MobileNetV2 (weights=None)
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tf():
    return pytest.importorskip("tensorflow")


def _randomize(keras_model, seed):
    """Random BatchNorm parameters and statistics and conv biases: Keras
    builds them as 1, 0, 0, 1 and 0, under which a swap would not show."""
    rng = np.random.default_rng(seed)
    for layer in keras_model.layers:
        name = type(layer).__name__
        weights = layer.get_weights()
        if name == "BatchNormalization":
            gamma, beta, mean, var = weights
            layer.set_weights([
                rng.uniform(0.5, 1.5, gamma.shape).astype(np.float32),
                rng.normal(0, 0.1, beta.shape).astype(np.float32),
                rng.normal(0, 0.2, mean.shape).astype(np.float32),
                rng.uniform(0.5, 2.0, var.shape).astype(np.float32)])
        elif name == "Conv2D" and len(weights) == 2:
            kernel, bias = weights
            layer.set_weights([
                kernel, rng.normal(0, 0.05, bias.shape).astype(np.float32)])
    return keras_model


@pytest.fixture(scope="module")
def keras_resnet50(tf):
    return _randomize(tf.keras.applications.ResNet50(
        include_top=False, weights=None, input_shape=[None, None, 3]), 3)


@pytest.fixture(scope="module")
def keras_mobilenetv2(tf):
    return _randomize(tf.keras.applications.MobileNetV2(
        include_top=False, weights=None, input_shape=[None, None, 3]), 4)


def _keras_taps(tf, keras_model, taps, x):
    extractor = tf.keras.Model(
        inputs=keras_model.input,
        outputs=[keras_model.get_layer(n).output for n in taps])
    return [np.asarray(t) for t in extractor(x, training=False)]


def test_keras_resnet50_mapping_equals_jax_and_matches_keras(
        tf, keras_resnet50):
    variables = TP.port_resnet(keras_resnet50, "resnet50")
    _assert_same_trees(variables, JP.port_resnet(keras_resnet50, "resnet50"))
    assert TP.STAGE_SIZES == JP.STAGE_SIZES
    x = np.random.default_rng(0).normal(size=(1, 64, 64, 3)) \
        .astype(np.float32)
    want = _keras_taps(tf, keras_resnet50, ["conv3_block4_out",
                                            "conv4_block6_out",
                                            "conv5_block3_out"], x)
    trunk = build_backbone("resnet50:keras")
    FF.load_flax(trunk, variables["params"], variables["batch_stats"])
    _assert_taps_match(trunk, x, want)


def test_keras_mobilenetv2_mapping_equals_jax_and_matches_keras(
        tf, keras_mobilenetv2, tmp_path, capsys):
    variables = TP.port_mobilenetv2(keras_mobilenetv2)
    _assert_same_trees(variables, JP.port_mobilenetv2(keras_mobilenetv2))
    assert TP.MBV2_GROUPS == JP.MBV2_GROUPS
    x = np.random.default_rng(1).normal(size=(1, 64, 64, 3)) \
        .astype(np.float32)
    # group outputs at strides 8/16/32
    want = _keras_taps(tf, keras_mobilenetv2,
                       ["block_5_add", "block_12_add", "out_relu"], x)
    trunk = build_backbone("mobilenetv2")
    FF.load_flax(trunk, variables["params"], variables["batch_stats"])
    _assert_taps_match(trunk, x, want)

    # main: Keras weights file in, the port's .npz out
    h5 = str(tmp_path / "mbv2.weights.h5")
    keras_mobilenetv2.save_weights(h5)
    out = str(tmp_path / "mbv2.npz")
    TP.main(["--arch", "mobilenetv2", "--weights", h5, "--output", out])
    assert f"ported mobilenetv2 -> {out}" in capsys.readouterr().out
    assert os.path.getsize(out) > 0
    _assert_same_trees(TP.load_ported(out), variables)
