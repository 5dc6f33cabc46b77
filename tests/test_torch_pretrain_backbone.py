"""Crop pretraining of the PyTorch port against the JAX program, on the CPU.

`detectax_torch.bench.pretrain_backbone` is held against
`benchmarks/pretrain_backbone.py` on the same inputs:

- `train.schedules.warmup_cosine_decay` equals optax's
  `warmup_cosine_decay_schedule` at every count 0-3,000 of the program's
  defaults, and at a small configuration, to `SCHEDULE_RTOL` relative
  (optax evaluated in float64, `jax.enable_x64`); against optax's float32
  evaluation, which the JAX step takes, to two float32 ulps of the peak
  (near the cosine's end that rounding is most of the value, so no
  relative bound holds there);
- `crop_batch` on the port's DetBench dataset equals the JAX function on
  the JAX dataset exactly, uint8 crops and int32 labels, over 3 batches
  (a spec of 16 images at 128 px, no cache, crops of 32);
- `CropClassifier` in float32 with the JAX init carried across by
  `tools.from_flax`: logits to `LOGIT_ATOL` for `tiny` (eval and train
  mode) and `mobilenetv2` (one 32-px crop);
- the two programs' `main()` on the same argv and the same initial
  weights (the JAX class in float32): trunk params and batch_stats of the
  JAX `.msgpack` and the port's `.npz` to `TREE_ATOL`, `eval_crop_acc`
  equal;
- the port's saved `mobilenetv2` trunk has the keys, shapes and dtypes of
  the committed JAX trunk, and `--init_backbone` loads it into a
  `CenterNetS8` state unchanged;
- without a CUDA device the entry point exits 1 with the reason.
"""
import functools
import json
import os
import subprocess
import sys
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import detectax.data.detbench as j_detbench
import detectax_torch.data.detbench as t_detbench
from detectax_torch.bench import pretrain_backbone as TPB
from detectax_torch.models import CenterNetS8
from detectax_torch.tools import from_flax as FF
from detectax_torch.train import loop as TLoop
from detectax_torch.train import schedules as TS
from detectax_torch.train.driver import load_backbone_weights

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_TRUNK = os.path.join(REPO, "benchmarks", "runs", "pretrain_mbv2",
                         "backbone.msgpack")
SCHEDULE_RTOL = 1e-7
# optax in float32 rounds at each of its few operations: up to 1.35 ulp
# of the peak seen
F32_ULPS_OF_PEAK = 2
LOGIT_ATOL = 1e-5
TREE_ATOL = 1e-5
CROP, CROP_BATCH = 32, 8


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """torch on one thread: the shapes are tiny, and beside the suite's
    other workers a pool of threads waits on busy cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jpb(tmp_path_factory):
    """`benchmarks/pretrain_backbone.py`, imported with its compile-cache
    variable pointed at a temporary directory."""
    cache = str(tmp_path_factory.mktemp("jax_cache"))
    with mock.patch.dict(os.environ, {"JAX_COMPILATION_CACHE_DIR": cache}):
        import benchmarks.pretrain_backbone as mod
    return mod


@pytest.fixture(scope="module")
def spec():
    return {**j_detbench.load_spec(), "n_train": 16, "n_eval": 8,
            "img_size": 128}


def _f32_class(jpb):
    class F32(jpb.CropClassifier):
        dtype = jnp.float32
    return F32


def _jax_init(jpb, backbone, nc, crop):
    model = _f32_class(jpb)(backbone_name=backbone, num_classes=nc)
    variables = jax.jit(functools.partial(model.init, train=False))(
        jax.random.PRNGKey(0), jnp.zeros((1, crop, crop, 3)))
    return model, jax.tree.map(np.asarray, jax.device_get(variables))


def _assert_trees_close(got, want, atol, what):
    assert set(got) == set(want), (what, sorted(set(got) ^ set(want)))
    for k in want:
        if isinstance(want[k], dict):
            _assert_trees_close(got[k], want[k], atol, f"{what}/{k}")
        else:
            g, w = np.asarray(got[k]), np.asarray(want[k])
            assert g.shape == w.shape and g.dtype == w.dtype, (
                f"{what}/{k}", g.shape, w.shape, g.dtype, w.dtype)
            np.testing.assert_allclose(g, w, rtol=0, atol=atol,
                                       err_msg=f"{what}/{k}")


# --------------------------------------------------------------------------
# the schedule
# --------------------------------------------------------------------------

@pytest.mark.parametrize("init,peak,warmup,decay,end,counts", [
    (0.0, 0.05, 200, 3000, 0.0, 3001),    # the program's defaults
    (0.0, 0.05, 2, 3, 0.0, 6),            # the parity run's, past its end
    (0.01, 0.2, 5, 17, 0.002, 25),
])
def test_warmup_cosine_decay_equals_optax(init, peak, warmup, decay, end,
                                          counts):
    ours = TS.warmup_cosine_decay(init, peak, warmup, decay, end)
    got = np.array([ours(c) for c in range(counts)])
    ref = optax.warmup_cosine_decay_schedule(init, peak, warmup, decay, end)
    with jax.enable_x64(True):
        want = np.asarray(jax.vmap(ref)(jnp.arange(counts, dtype=jnp.int64)))
    assert want.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=SCHEDULE_RTOL, atol=0)
    assert got[0] == pytest.approx(init, rel=1e-12, abs=0)  # step 1's rate
    # what the JAX step evaluates: optax in float32
    f32 = np.asarray(jax.vmap(ref)(jnp.arange(counts, dtype=jnp.int32)))
    np.testing.assert_allclose(
        got, f32, rtol=0,
        atol=F32_ULPS_OF_PEAK * float(np.spacing(np.float32(peak))))


def test_warmup_cosine_decay_refuses_an_empty_decay():
    with pytest.raises(ValueError, match="must exceed"):
        TS.warmup_cosine_decay(0.0, 0.05, 200, 200)


# --------------------------------------------------------------------------
# crops
# --------------------------------------------------------------------------

def test_crop_batch_equals_the_jax_function(jpb, spec):
    jds = j_detbench.DetBenchDataset("train", spec=spec, cache=False)
    tds = t_detbench.DetBenchDataset("train", spec=spec, cache=False)
    jrng, trng = np.random.default_rng(0), np.random.default_rng(0)
    for _ in range(3):
        ji, jl = jpb.crop_batch(jds, jrng, CROP_BATCH, CROP)
        ti, tl = TPB.crop_batch(tds, trng, CROP_BATCH, CROP)
        assert ti.dtype == np.uint8 and tl.dtype == np.int32
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(tl, jl)
    # both generators were drawn alike
    assert trng.integers(0, 1 << 30) == jrng.integers(0, 1 << 30)


# --------------------------------------------------------------------------
# the classifier
# --------------------------------------------------------------------------

@pytest.mark.parametrize("backbone,batch", [("tiny", 4), ("mobilenetv2", 1)])
def test_crop_classifier_forward_equals_jax(jpb, backbone, batch):
    nc = 8
    jmodel, variables = _jax_init(jpb, backbone, nc, CROP)
    tmodel = TPB.CropClassifier(backbone, nc, dtype=torch.float32)
    FF.load_flax(tmodel, variables["params"], variables["batch_stats"])
    x = np.random.default_rng(1).uniform(
        -1, 1, (batch, CROP, CROP, 3)).astype(np.float32)
    want = np.asarray(jmodel.apply(variables, x, train=False))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(x), train=False).numpy()
    assert got.shape == (batch, nc) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_ATOL)
    if backbone == "tiny":
        want, _ = jmodel.apply(variables, x, train=True,
                               mutable=["batch_stats"])
        with torch.no_grad():
            got = tmodel(torch.from_numpy(x), train=True).numpy()
        np.testing.assert_allclose(got, np.asarray(want), rtol=0,
                                   atol=LOGIT_ATOL)
    # the dense head crosses back to Flax's layout
    params, _ = FF.to_flax(tmodel)
    np.testing.assert_array_equal(params["cls_head"]["kernel"],
                                  variables["params"]["cls_head"]["kernel"])


# --------------------------------------------------------------------------
# the programs
# --------------------------------------------------------------------------

def test_main_equals_the_jax_program(jpb, spec, tmp_path, monkeypatch):
    argv = ["--backbone", "tiny", "--steps", "3", "--warmup_steps", "2",
            "--batch_size", "8", "--crop", str(CROP), "--eval_batches", "1"]
    monkeypatch.setattr(j_detbench, "DetBenchDataset", functools.partial(
        j_detbench.DetBenchDataset, spec=spec, cache=False))
    monkeypatch.setattr(t_detbench, "DetBenchDataset", functools.partial(
        t_detbench.DetBenchDataset, spec=spec, cache=False))
    monkeypatch.setattr(jpb, "CropClassifier", _f32_class(jpb))
    monkeypatch.setattr(TPB, "TRUNK_DTYPE", torch.float32)
    jout, tout = str(tmp_path / "jax.msgpack"), str(tmp_path / "port.npz")
    jpb.main(argv + ["--out", jout])
    # JAX's main initializes from PRNGKey(0) on a zero crop: the same init
    _, variables = _jax_init(jpb, "tiny", 8, CROP)
    meta = TPB.main(argv + ["--out", tout], device="cpu",
                    variables=variables)

    want = FF.read_msgpack(jout)
    got = dict(zip(("params", "batch_stats"), FF.load_npz(tout)))
    assert set(want) == {"params", "batch_stats"}
    _assert_trees_close(got["params"], want["params"], TREE_ATOL, "params")
    _assert_trees_close(got["batch_stats"], want["batch_stats"], TREE_ATOL,
                        "batch_stats")
    # the trunk moved: the run trained
    assert not np.array_equal(
        got["params"]["ConvBN_0"]["Conv_0"]["kernel"],
        variables["params"]["TinyBackbone_0"]["ConvBN_0"]["Conv_0"]["kernel"])
    with open(jout + ".json") as f:
        jmeta = json.load(f)
    with open(tout + ".json") as f:
        tmeta = json.load(f)
    assert set(tmeta) == set(jmeta)
    assert tmeta["eval_crop_acc"] == jmeta["eval_crop_acc"]
    for k in ("backbone", "steps", "crop"):
        assert tmeta[k] == jmeta[k]
    assert meta["eval_crop_acc"] == tmeta["eval_crop_acc"]
    assert len(meta["timing"]["losses"]) == 3
    assert np.isfinite(meta["timing"]["losses"]).all()


def test_saved_mobilenetv2_trunk_is_the_committed_trunks_tree(
        spec, tmp_path, monkeypatch):
    monkeypatch.setattr(t_detbench, "DetBenchDataset", functools.partial(
        t_detbench.DetBenchDataset, spec=spec, cache=False))
    monkeypatch.setattr(TPB, "TRUNK_DTYPE", torch.float32)
    out = str(tmp_path / "backbone.npz")
    TPB.main(["--backbone", "mobilenetv2", "--steps", "2",
              "--warmup_steps", "1", "--batch_size", "2", "--crop",
              str(CROP), "--eval_batches", "1", "--out", out],
             device="cpu")
    params, stats = FF.load_npz(out)
    committed = FF.read_msgpack(JAX_TRUNK)
    assert set(committed) == {"params", "batch_stats"}

    def flat(tree):
        return {p: (v.shape, v.dtype) for p, v in FF._flatten(tree)}

    assert flat(params) == flat(committed["params"])
    assert flat(stats) == flat(committed["batch_stats"])

    model = CenterNetS8(8, backbone="mobilenetv2")
    state = TLoop.create_train_state(
        model, None, TS.make_optimizer("sgd", TS.constant(1e-3)))
    load_backbone_weights(state, out)
    saved = FF.from_flax({"MobileNetV2_0": params}, {"MobileNetV2_0": stats})
    backbone = model.state_dict()
    assert set(saved) == {k for k in backbone if k.startswith("backbone.")}
    for k, v in saved.items():
        assert torch.equal(backbone[k], v), k


def test_entry_point_needs_a_cuda_device(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    out = tmp_path / "b.npz"
    res = subprocess.run(
        [sys.executable, "-m", "detectax_torch.bench.pretrain_backbone",
         "--steps", "1", "--out", str(out)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 1, res.stdout + res.stderr
    assert "needs a CUDA device" in res.stderr
    assert not out.exists() and "step" not in res.stdout
