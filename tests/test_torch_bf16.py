"""bf16 compute and the BatchNorm statistics modes of the PyTorch port
against the JAX package, on the CPU.

The parameters stay float32 on both sides; each layer casts its input and
its parameters to the compute dtype, as Flax's ``promote_dtype`` does.
XLA and torch round bf16 at different points (XLA's CPU code keeps fused
chains in float32), so bf16 outputs are held to a tolerance relative to
JAX's own bf16 error, per output tensor:

    max|port_bf16 - jax_bf16| <= 2 * max|jax_bf16 - jax_fp32| + 1e-3.

That bf16 really happened is checked too: a forward hook sees every
convolution compute in bf16 (the stem given the float32 image, every other
conv bf16 inputs), and the port's own bf16 error is non-zero and
within a factor of 4 of JAX's. One train step: losses within 2e-2
relative, gradient norms within 2e-2 of each other.

BatchNorm modes, with the environment set for both packages:
``DETECTAX_BN_STAT_SUBSET=2`` at batch 4 in float32 (a layer's outputs and
running statistics to 1e-5; a whole tiny FCOS to the model tolerance of
`tests/test_torch_models.py`), and ``DETECTAX_BN_BF16_STATS=1`` under bf16.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detectax.models import CenterNetFPNSingle as JCN
from detectax.models import FCOS as JFCOS
from detectax.models import RetinaNet as JRetina
from detectax.models import layers as JL
from detectax.ops import anchors as JAn
from detectax.ops import assign as JA
from detectax.train import losses as JTL
from detectax.train import loop as JLoop
from detectax.train import schedules as JS
from detectax_torch.cli import (
    train_centernet_crowdhuman,
    train_centernet_heatmap,
    train_fcos,
    train_fcos_center_v1_voc,
    train_fcos_center_voc,
    train_retinanet_coco,
)
from detectax_torch.models import CenterNetFPNSingle as TCN
from detectax_torch.models import CenterNetS8 as TS8
from detectax_torch.models import FCOS as TFCOS
from detectax_torch.models import RetinaNet as TRetina
from detectax_torch.models import layers as TL
from detectax_torch.ops import anchors as TAn
from detectax_torch.ops import assign as TA
from detectax_torch.tools import from_flax as FF
from detectax_torch.train import losses as TTL
from detectax_torch.train import loop as TLoop
from detectax_torch.train import schedules as TS


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """torch on one thread: the steps are tiny, and beside the suite's
    other workers a pool of threads a process waits on busy cores at every
    operation (tens of times slower)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


NC = 3
BF16, F32 = torch.bfloat16, torch.float32
STEP_RTOL = 2e-2
MODEL_ATOL = 1e-4   # tests/test_torch_models.py, float32 forwards
FP32_RTOL = 2e-5    # tests/test_torch_retinanet.py, float32 forwards

# name: (JAX class, port class, canvas, extra keywords)
MODELS = {
    "fcos": (JFCOS, TFCOS, 64, {}),
    "centernet_heatmap": (JCN, TCN, 64, {}),
    "retinanet": (JRetina, TRetina, 128, {}),
    "retinanet_mobilenetv2": (JRetina, TRetina, 128,
                              {"backbone": "mobilenetv2"}),
}


def _np(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _levels(out):
    return out if isinstance(out, (list, tuple)) else [out]


def _pair(name, seed=0):
    """Flax variables (float32, the running statistics moved off their
    init) of model `name`, and a function building either side in a dtype
    with those weights."""
    jcls, tcls, size, extra = MODELS[name]
    kw = {"num_classes": NC, "backbone": "tiny", **extra}
    v = jcls(**kw).init(jax.random.key(seed), jnp.zeros((1, size, size, 3)),
                        train=False)
    rng = np.random.default_rng(seed)
    params = _np(v["params"])
    stats = jax.tree.map(lambda x: (np.asarray(x) + rng.uniform(
        0.0, 0.3, np.shape(x))).astype(np.float32), _np(v["batch_stats"]))

    def build(side, dtype):
        if side == "jax":
            return jcls(**kw, dtype=jnp.bfloat16 if dtype == BF16
                        else jnp.float32)
        return FF.load_flax(tcls(**kw, dtype=dtype), params, stats)

    return params, stats, size, build


def _jax_forward(module, params, stats, images, train):
    apply = jax.jit(lambda p, s, x: module.apply(
        {"params": p, "batch_stats": s}, x, train=train,
        mutable=["batch_stats"] if train else False))
    out = apply(params, stats, jnp.asarray(images))
    out = out[0] if train else out
    return [np.asarray(o) for o in _levels(out)]


def _torch_forward(module, images, train):
    with torch.no_grad():
        return [o.numpy() for o in _levels(
            module(torch.from_numpy(images), train=train))]


def _max_err(a, b):
    return max(float(np.abs(x - y).max()) for x, y in zip(a, b))


@pytest.mark.parametrize("name,train", [
    ("fcos", False), ("fcos", True), ("centernet_heatmap", False),
    ("retinanet", False), ("retinanet", True),
    ("retinanet_mobilenetv2", False), ("retinanet_mobilenetv2", True)],
    ids=["fcos-eval", "fcos-train", "centernet_heatmap-eval",
         "retinanet-eval", "retinanet-train", "retinanet_mobilenetv2-eval",
         "retinanet_mobilenetv2-train"])
def test_bf16_forward_within_jax_bf16_error(rng, name, train):
    """Also the float32 forwards of the two packages against each other, to
    2e-5 of each output's largest magnitude (the RetinaNet-MobileNetV2
    parity case of `tests/test_torch_retinanet.py`)."""
    params, stats, size, build = _pair(name)
    images = rng.uniform(-1, 1, (2, size, size, 3)).astype(np.float32)
    j32 = _jax_forward(build("jax", F32), params, stats, images, train)
    j16 = _jax_forward(build("jax", BF16), params, stats, images, train)
    t16_model = build("torch", BF16)
    seen = []
    hooks = [m.register_forward_hook(
        lambda mod, args, out: seen.append((args[0].dtype, out.dtype)))
        for m in t16_model.modules() if isinstance(m, TL.Conv)]
    t16 = _torch_forward(t16_model, images, train)
    for h in hooks:
        h.remove()
    t32 = _torch_forward(build("torch", F32), images, train)
    # every convolution ran in bf16 (its output is bf16); the image enters
    # the stem in float32, every other conv is handed bf16; the outputs
    # leave in float32
    assert seen and all(o == BF16 for _, o in seen)
    assert [a for a, _ in seen[1:]] == [BF16] * (len(seen) - 1)
    assert seen[0][0] == F32
    assert all(o.dtype == np.float32 for o in t16)
    for lvl, (g, w, w32) in enumerate(zip(t16, j16, j32)):
        assert g.shape == w.shape, lvl
        jax_err = float(np.abs(w - w32).max())
        err = float(np.abs(g - w).max())
        assert err <= 2.0 * jax_err + 1e-3, (lvl, err, jax_err)
    for lvl, (g, w) in enumerate(zip(t32, j32)):
        err = float(np.abs(g - w).max())
        assert err <= FP32_RTOL * float(np.abs(w).max()), (lvl, err)
    jax_err, port_err = _max_err(j16, j32), _max_err(t16, t32)
    # the port's bf16 error is real and of the order of JAX's: a port
    # computing in float32 would have none
    assert port_err > 0.0
    assert 0.25 * jax_err <= port_err <= 4.0 * jax_err, (port_err, jax_err)


def _fcos_assign(assign, nc, size):
    return lambda b, l, v: assign.fcos_assign(
        b, l, v, img_dim=(size, size), num_classes=nc)[0]


def _retina_assign(assign, anchors, nc, size):
    return lambda b, l, v: assign.retinanet_assign(
        b, l, v, img_dim=(size, size), num_classes=nc,
        anchors_per_level=anchors.anchor_shapes_per_level(
            anchor_sizes=(20.0, 40.0, 80.0, 160.0, 320.0)))[0]


@pytest.mark.parametrize("name", ["fcos", "retinanet"])
def test_bf16_train_step_matches_the_jax_step(rng, name):
    """One SGD step (clip 1) of the bf16 model from the same state: losses
    within 2e-2 relative, the gradient norms within 2e-2 of each other."""
    jcls, tcls, size, _ = MODELS[name]
    if name == "fcos":
        j_assign, t_assign = (_fcos_assign(JA, NC, size),
                              _fcos_assign(TA, NC, size))
        j_loss, t_loss = JTL.fcos_loss, TTL.fcos_loss
    else:
        j_assign = _retina_assign(JA, JAn, NC, size)
        t_assign = _retina_assign(TA, TAn, NC, size)
        j_loss, t_loss = JTL.retinanet_loss, TTL.retinanet_loss
    jmodel = jcls(num_classes=NC, backbone="tiny", dtype=jnp.bfloat16)
    jopt = JS.make_optimizer("sgd", JS.exponential_with_floor(1e-2),
                             grad_clip=1.0)
    jstep = JLoop.make_train_step(jmodel, j_assign, j_loss, jopt,
                                  donate=False, jit=True)
    jstate = JLoop.create_train_state(
        jmodel, jax.random.PRNGKey(0), jnp.zeros((2, size, size, 3)), jopt)
    tmodel = tcls(num_classes=NC, backbone="tiny", dtype=BF16)
    topt = TS.make_optimizer("sgd", TS.exponential_with_floor(1e-2),
                             grad_clip=1.0)
    tstep = TLoop.make_train_step(tmodel, t_assign, t_loss, topt)
    tstate = TLoop.create_train_state(tmodel, None, topt)
    FF.load_train_state(tstate, _np(jstate.params), _np(jstate.batch_stats),
                        opt_state=_np(jstate.opt_state), step=0)
    boxes = np.zeros((2, 4, 4), np.float32)
    boxes[..., :2] = rng.uniform(0.3, 0.7, (2, 4, 2))
    boxes[..., 2:] = rng.uniform(0.2, 0.6, (2, 4, 2))
    batch = {"images": rng.normal(size=(2, size, size, 3))
             .astype(np.float32), "boxes": boxes,
             "labels": rng.integers(0, NC, (2, 4)).astype(np.int32),
             "valid": np.ones((2, 4), bool)}
    jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    tstate, tm = tstep(tstate, batch)
    # the parameters stayed float32 and took a float32 update
    assert all(p.dtype == F32 for p in tmodel.parameters())
    assert float(tm["num_pos"]) == float(jm["num_pos"]) > 0
    for k in ("total", "cls", "reg"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                   rtol=STEP_RTOL, err_msg=k)
    ratio = float(tm["grad_norm"]) / float(jm["grad_norm"])
    assert abs(ratio - 1.0) <= STEP_RTOL, ratio


# --------------------------------------------------------------------------
# the BatchNorm statistics modes
# --------------------------------------------------------------------------

def _bn_pair(c, dtype, f32_stats):
    rng = np.random.default_rng(1)
    scale = rng.uniform(0.5, 1.5, c).astype(np.float32)
    bias = rng.normal(size=c).astype(np.float32)
    mean0 = rng.normal(scale=0.2, size=c).astype(np.float32)
    var0 = rng.uniform(0.5, 2.0, c).astype(np.float32)
    jbn = JL.BatchNorm(use_running_average=False,
                       force_float32_reductions=f32_stats,
                       dtype=jnp.bfloat16 if dtype == BF16 else jnp.float32)
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": {"mean": mean0, "var": var0}}
    tbn = TL.BatchNorm(c, dtype=dtype, force_float32_reductions=f32_stats)
    tbn.load_state_dict({
        "weight": torch.from_numpy(scale), "bias": torch.from_numpy(bias),
        "running_mean": torch.from_numpy(mean0),
        "running_var": torch.from_numpy(var0)})
    return jbn, variables, tbn


def _bn_run(jbn, variables, tbn, x):
    want, mutated = jbn.apply(variables, jnp.asarray(x),
                              mutable=["batch_stats"])
    got = tbn(torch.from_numpy(x).permute(0, 3, 1, 2), train=True)
    got = got.detach().float().permute(0, 2, 3, 1).numpy()
    return (got, np.asarray(want, np.float32),
            {"mean": tbn.running_mean.numpy(), "var": tbn.running_var.numpy()},
            _np(mutated["batch_stats"]))


def test_bn_stat_subset_layer_matches_jax(rng, monkeypatch):
    """Statistics from the first B // 2 = 2 of 4 examples: the full batch
    is normalized by them and the running averages move by them."""
    x = rng.normal(loc=0.3, scale=2.0, size=(4, 5, 4, 6)).astype(np.float32)
    x[2:] *= 3.0   # the second half differs, so the subset shows
    out = {}
    for sub in ("0", "2"):
        monkeypatch.setenv("DETECTAX_BN_STAT_SUBSET", sub)
        got, want, got_s, want_s = _bn_run(*_bn_pair(6, F32, True), x)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
        for k in ("mean", "var"):
            np.testing.assert_allclose(got_s[k], want_s[k], rtol=0,
                                       atol=1e-5, err_msg=k)
        out[sub] = (got, got_s["var"])
    assert np.abs(out["2"][0] - out["0"][0]).max() > 0.1
    assert np.abs(out["2"][1] - out["0"][1]).max() > 0.1
    # fewer examples than the divisor: the whole batch, as in JAX
    monkeypatch.setenv("DETECTAX_BN_STAT_SUBSET", "8")
    got, want, _, _ = _bn_run(*_bn_pair(6, F32, True), x)
    np.testing.assert_allclose(got, out["0"][0], rtol=0, atol=1e-6)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_bn_stat_subset_model_matches_jax(rng, monkeypatch):
    """A tiny FCOS at batch 4 under ``train=True``: outputs and running
    statistics. The subset is read at every forward."""
    params, stats, size, build = _pair("fcos")
    images = rng.uniform(-1, 1, (4, size, size, 3)).astype(np.float32)
    images[2:] *= 0.2
    tm = build("torch", F32)
    outs = {}
    for sub in ("0", "2"):
        monkeypatch.setenv("DETECTAX_BN_STAT_SUBSET", sub)
        jmod = build("jax", F32)
        want, mutated = jmod.apply({"params": params, "batch_stats": stats},
                                   jnp.asarray(images), train=True,
                                   mutable=["batch_stats"])
        tm.load_state_dict(FF.from_flax(params, stats, tm))
        with torch.no_grad():
            got = tm(torch.from_numpy(images), train=True)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                       atol=MODEL_ATOL)
        got_stats = FF.to_flax(tm)[1]
        flat_g = jax.tree_util.tree_leaves(got_stats)
        flat_w = jax.tree_util.tree_leaves(_np(mutated["batch_stats"]))
        for g, w in zip(flat_g, flat_w):
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-5)
        outs[sub] = got[0].numpy()
    assert np.abs(outs["2"] - outs["0"]).max() > 1e-3


def test_bn_bf16_stats_match_jax(rng, monkeypatch):
    """``DETECTAX_BN_BF16_STATS=1`` under bf16: the statistics reduce in
    bf16. A layer against JAX's, and a tiny RetinaNet (the switch read when
    its blocks are built) within JAX's own bf16 error."""
    x = rng.normal(loc=0.3, scale=2.0, size=(3, 5, 4, 6)).astype(np.float32)
    got, want, got_s, want_s = _bn_run(*_bn_pair(6, BF16, False), x)
    ref, _, ref_s, _ = _bn_run(*_bn_pair(6, F32, True), x)
    jax_err = float(np.abs(want - ref).max())
    assert 0 < float(np.abs(got - want).max()) <= 2 * jax_err + 1e-3
    for k in ("mean", "var"):
        j_err = float(np.abs(want_s[k] - ref_s[k]).max())
        assert float(np.abs(got_s[k] - want_s[k]).max()) <= 2 * j_err + 1e-3

    monkeypatch.setenv("DETECTAX_BN_BF16_STATS", "1")
    params, stats, size, build = _pair("retinanet")
    tm = build("torch", BF16)
    bns = [m for m in tm.modules() if isinstance(m, TL.BatchNorm)]
    assert bns and not any(m.force_float32_reductions for m in bns)
    images = rng.uniform(-1, 1, (2, size, size, 3)).astype(np.float32)
    j16 = _jax_forward(build("jax", BF16), params, stats, images, True)
    j32 = _jax_forward(build("jax", F32), params, stats, images, True)
    t16 = _torch_forward(tm, images, True)
    for lvl, (g, w, w32) in enumerate(zip(t16, j16, j32)):
        jax_err = float(np.abs(w - w32).max())
        assert float(np.abs(g - w).max()) <= 2 * jax_err + 1e-3, lvl
    monkeypatch.delenv("DETECTAX_BN_BF16_STATS")
    assert all(m.force_float32_reductions for m in build(
        "torch", BF16).modules() if isinstance(m, TL.BatchNorm))


# --------------------------------------------------------------------------
# --bf16 in every trainer
# --------------------------------------------------------------------------

@pytest.mark.parametrize("main,canvas,steps", [
    (train_fcos.main, 64, 0), (train_fcos_center_voc.main, 64, 0),
    (train_fcos_center_v1_voc.main, 64, 0),
    (train_centernet_heatmap.main, 64, 0),
    (train_centernet_crowdhuman.main, 64, 0),
    (train_retinanet_coco.main, 128, 1)],
    ids=["fcos", "fcos_center", "fcos_center_v1", "centernet_heatmap",
         "centernet_crowdhuman", "retinanet"])
def test_every_trainer_takes_bf16(tmp_path, monkeypatch, main, canvas,
                                  steps):
    """`--bf16` builds the model with a bf16 compute dtype (the five older
    trainers are built and stopped before step 1 here: their tests train a
    bf16 step); the parameters and the checkpoint stay float32."""
    built = []
    for cls in (TFCOS, TCN, TS8, TRetina):
        init = cls.__init__

        def spy(self, *a, _init=init, **k):
            _init(self, *a, **k)
            built.append(self.compute_dtype)

        monkeypatch.setattr(cls, "__init__", spy)
    summary = main(["--device", "cpu", "--backbone", "tiny", "--canvas",
                    str(canvas), "--batch_size", "2", "--synthetic_n", "4",
                    "--max_steps", str(steps), "--display_step", "1",
                    "--bf16", "--ckpt_dir", str(tmp_path / "ckpt"),
                    "--out_dir", str(tmp_path / "out")])
    assert summary["final_step"] == steps and built == [BF16]
    if steps:
        assert np.isfinite(summary["total"])
        ckpt = torch.load(next((tmp_path / "ckpt").glob("*.pt")),
                          weights_only=False)
        assert all(v.dtype == F32 for v in ckpt["model"].values()
                   if v.is_floating_point())
