"""Training and evaluation of the hourglass models of the PyTorch port
against the JAX package, on the CPU.

* One step of Adam on the epoch schedule, from the same state (its
  weights made with numpy in the Flax variables' trees,
  `test_torch_hourglass.flax_trees`, and the optax state crossed with
  `from_flax.load_train_state`), on the same batch, as
  `cli.train_hourglass_voc` composes them: `HourglassNet` with
  ``--loss_type focal``, losses over the batch, clip 1; `StackedHourglass`
  with the TPU DetBench v2 row's losses over the positives, clip 16, and
  the trainer's microbatches of 2. Metrics to rtol 1e-4; the first moment
  (0.1 of the clipped gradient) to 1e-4 of the model's largest element
  (a gradient through some thirty BatchNorms in float32); the parameters
  to 1e-4 wherever the first moment is above that, and elsewhere to twice
  the step's size, lr (as `tests/test_torch_fcos_center.py`: Adam's first
  update is lr g / (|g| + 1e-8), so where g is rounding's — a conv bias
  under a BatchNorm — the step's sign is too); the running statistics to
  1e-5 of each leaf's largest magnitude. `HourglassNet` steps at 128 px:
  at 64 px its stride-64 maps are 1x1, BatchNorm sees two values a
  channel, and JAX's jitted float32 gradient norm lies 4.8e-4 from its
  float64 value (the port's: 1e-7). `StackedHourglass` steps with one
  stack: with two, in microbatches of 2, JAX's jitted float32 gradient
  norm lies 3.6e-4 (64 px) to 7.7e-4 (128 px) from its float64 value, the
  port's within 3.3e-7 (one stack: JAX 5.9e-7, the port 8.7e-9).
* The loader with the trainer's hourglass augment and centre padding, on
  canvas buckets and with the content-scale jitter: batches equal.
* `cli.train_hourglass_voc` for two steps (`--variant stacked` on the
  buckets 64 and 128), then `cli.evaluate` from its checkpoint; and
  `cli.evaluate` against `detectax.cli.evaluate` with the same weights:
  detections image by image, the same ground truth, equal summaries.
"""
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from detectax.cli import evaluate as j_evaluate
from detectax.data import Loader as JLoader
from detectax.data import SyntheticDataset as JSynthetic
from detectax.eval import detection_metrics as JM
from detectax.models import HourglassNet as JHG
from detectax.models import StackedHourglass as JSH
from detectax.ops import assign as JA
from detectax.train import loop as JLoop
from detectax.train import losses as JTL
from detectax.train import schedules as JS
from detectax_torch.cli import evaluate as t_evaluate
from detectax_torch.cli import train_hourglass_voc
from detectax_torch.data.pipeline import Loader as TLoader
from detectax_torch.data.synthetic import SyntheticDataset as TSynthetic
from detectax_torch.eval import detection_metrics as TM
from detectax_torch.models import HourglassNet as THG
from detectax_torch.models import StackedHourglass as TSH
from detectax_torch.ops import assign as TA
from detectax_torch.tools import from_flax as FF
from detectax_torch.train import loop as TLoop
from detectax_torch.train import losses as TTL
from detectax_torch.train import schedules as TS
from detectax_torch.train.checkpoint import CheckpointManager
from test_torch_hourglass import flax_trees

IMG, NC = 64, 3
METRIC_RTOL, STATS_RTOL, MU_RTOL, ADAM_ATOL = 1e-4, 1e-5, 1e-4, 1e-4
LR = 1e-3


def _np(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _leaves(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _leaves(tree[k], f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(tree[k])


# variant: (JAX model, port model, canvas, batch, step keywords, (clip,
# loss keywords))
VARIANTS = {
    "hourglass_focal": (
        JHG(num_classes=NC, n_filters=2), THG(num_classes=NC, n_filters=2),
        128, 2, dict(loss_norm="batch"),
        (1.0, {"loss_type": "focal", "reg_lambda": 0.1})),
    "stacked_pos_microbatch": (
        JSH(num_classes=NC, n_filters=4, n_stacks=1),
        TSH(num_classes=NC, n_filters=4, n_stacks=1),
        64, 4, dict(loss_norm="pos", microbatch=2), (16.0, {})),
}


def _assign(lib, variant):
    """The trainer's assignment, on the batch's canvas."""
    if variant.startswith("stacked"):
        def fn(boxes, labels, valid, img_hw):
            return lib.stacked_hourglass_assign(
                boxes, labels, valid, img_dim=tuple(img_hw),
                num_classes=NC, stride=4)[0]
    else:
        def fn(boxes, labels, valid, img_hw):
            scales = tuple(img_hw[0] / (2.0 ** x) for x in reversed(range(4)))
            return lib.hourglass_assign(
                boxes, labels, valid, img_dim=tuple(img_hw),
                num_classes=NC, box_scales=scales)[0]
    return fn


def _batch(rng, batch, canvas=IMG):
    n = 5
    boxes = np.zeros((batch, n, 4), np.float32)
    boxes[..., :2] = rng.uniform(0.2, 0.8, (batch, n, 2))
    boxes[..., 2:] = rng.uniform(0.05, 0.7, (batch, n, 2))
    valid = np.ones((batch, n), bool)
    valid[0, 3:] = False
    return {"images": rng.normal(size=(batch, canvas, canvas, 3))
            .astype(np.float32), "boxes": boxes,
            "labels": rng.integers(0, NC, (batch, n)).astype(np.int32),
            "valid": valid}


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_train_step_equals_the_jax_step(variant):
    (jmodel, tmodel, canvas, batch_size, step_kw,
     (clip, loss_kw)) = VARIANTS[variant]
    sched = dict(init_lr=LR, decay=0.9, steps_per_epoch=1)
    if variant.startswith("stacked"):
        j_loss, t_loss = (JTL.stacked_hourglass_loss,
                          TTL.stacked_hourglass_loss)
    else:
        j_loss = functools.partial(JTL.hourglass_loss, **loss_kw)
        t_loss = functools.partial(TTL.hourglass_loss, **loss_kw)
    jopt = JS.make_optimizer("adam", JS.make_schedule("epoch", **sched),
                             grad_clip=clip)
    jstep = JLoop.make_train_step(jmodel, _assign(JA, variant), j_loss, jopt,
                                  donate=False, jit=True, **step_kw)
    params, stats = flax_trees(jmodel, 3, (1, canvas, canvas, 3))
    params_before = dict(_leaves(params))
    jstate = JLoop.TrainState(
        step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
        opt_state=jopt.init(params), ema_params=None)
    topt = TS.make_optimizer("adam", TS.make_schedule("epoch", **sched),
                             grad_clip=clip)
    tstep = TLoop.make_train_step(tmodel, _assign(TA, variant), t_loss, topt,
                                  **step_kw)
    tstate = TLoop.create_train_state(tmodel, None, topt)
    FF.load_train_state(tstate, params, stats,
                        opt_state=_np(jstate.opt_state), step=0)
    batch = _batch(np.random.default_rng(7), batch_size, canvas)
    jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    tstate, tm = tstep(tstate, batch)
    assert set(tm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                   rtol=METRIC_RTOL, err_msg=k)
    assert float(tm["num_pos"]) > 0
    t_params, t_stats = FF.to_flax(tstate.model)
    for (k, g), (_, w) in zip(_leaves(t_stats),
                              _leaves(_np(jstate.batch_stats))):
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=STATS_RTOL * np.abs(w).max(),
                                   err_msg=k)
    mu = dict(_leaves(FF._optax_fields(_np(jstate.opt_state))["mu"]))
    got_mu = dict(_leaves(FF.opt_to_flax(tstate)["mu"]))
    want = dict(_leaves(_np(jstate.params)))
    got = dict(_leaves(t_params))
    assert set(got) == set(want) == set(mu) == set(got_mu)
    # the gradient (ten times the first moment) is resolved to about 1e-5
    # of its largest element: below that lie the gradients that are zero
    # but for rounding (a conv bias under a BatchNorm), whose Adam step is
    # +-lr either way
    floor = MU_RTOL * max(np.abs(m).max() for m in mu.values())
    for k in want:
        np.testing.assert_allclose(got_mu[k], mu[k], rtol=0, atol=floor,
                                   err_msg=f"first moment {k}")
        diff = np.abs(got[k] - want[k])
        big = np.abs(mu[k]) > floor
        assert diff[big].max(initial=0.0) <= ADAM_ATOL, k
        assert diff.max() <= 2 * LR, k
    assert any(not np.array_equal(w, params_before[k])
               for k, w in got.items())


@pytest.mark.parametrize("kw", [dict(canvas=[64, 128], jitter=None),
                                dict(canvas=64, jitter=(38.4, 64.0))],
                         ids=["buckets", "jitter"])
def test_loader_with_the_hourglass_augment_equals_the_jax_package(kw):
    common = dict(batch_size=3, max_boxes=8, steps=3, seed=4, prefetch=0,
                  emit_uint8=True, augment="hourglass",
                  pad_position="center", **kw)
    want = list(JLoader(JSynthetic(n=8, img_size=96, seed=1), native=False,
                        **common))
    got = list(TLoader(TSynthetic(n=8, img_size=96, seed=1), **common))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            assert g[k].dtype == w[k].dtype
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


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


@pytest.mark.parametrize("family,train_args", [
    ("hourglass", ["--n_filters", "2"]),
    ("stacked_hourglass", ["--variant", "stacked", "--n_filters", "4",
                           "--n_stacks", "2", "--loss_norm", "pos",
                           "--multi_scale", "64", "128"])])
def test_train_cli_then_evaluate_equals_the_jax_cli(tmp_path, monkeypatch,
                                                    family, train_args):
    """Two steps of the trainer on the CPU (microbatches of 2), then
    `cli.evaluate` from the checkpoint it wrote. Then the port's
    `cli.evaluate --weights` against the JAX package's with the same
    weights on DetBench v2 cut to four eval images: weights made with
    numpy in the Flax trees, the head's kernel scaled by 5 and the focal
    bias 0. Two steps from the focal prior leave the class scores within
    1e-5 of each other (0.011), so near-equal candidates would swap ranks
    on float32 noise, where these weights spread the scores apart. No
    score threshold, so that every image keeps detections."""
    ckpt = str(tmp_path / "ckpt")
    summary = train_hourglass_voc.main([
        "--device", "cpu", "--canvas", str(IMG), "--batch_size", "4",
        "--synthetic_n", "8", "--max_steps", "2", "--display_step", "1",
        "--ckpt_dir", ckpt, "--out_dir", str(tmp_path / "out"),
        *train_args])
    assert summary["final_step"] == 2 and np.isfinite(summary["total"])
    assert CheckpointManager(ckpt).latest_step() == 2
    width = train_args[train_args.index("--n_filters"):][:2]
    if family == "stacked_hourglass":
        width += ["--n_stacks", "2"]
    args = ["--family", family, "--canvas", str(IMG), "--synthetic_n", "4",
            "--batch_size", "2", "--cls_thresh", "0.0", "--coco_metrics",
            *width]
    from_ckpt = t_evaluate.main(args + ["--device", "cpu",
                                        "--ckpt_dir", ckpt])
    assert from_ckpt["num_images"] == 4
    assert np.isfinite(from_ckpt["mAP@0.5"])

    _cut_detbench(monkeypatch, tmp_path)
    args = ["--family", family, "--canvas", str(IMG), "--dataset",
            "detbench_v2", "--batch_size", "2", "--cls_thresh", "0.0",
            "--coco_metrics", *width]
    jmodel = (JHG(num_classes=8, n_filters=2) if family == "hourglass"
              else JSH(num_classes=8, n_filters=4, n_stacks=2))
    params, stats = flax_trees(jmodel, 11)
    # logits spread over several units: the focal prior, on random
    # weights, leaves the scores within 1e-5 of each other
    head = "head_out" if family == "hourglass" else "cnn_out"
    params[head]["kernel"] = params[head]["kernel"] * 5.0
    params["b_focal"]["bias"] = np.zeros((), np.float32)
    FF.save_npz(str(tmp_path / "w.npz"), params, stats)
    monkeypatch.setattr(
        j_evaluate, "restore_for_inference",
        lambda *a, **k: types.SimpleNamespace(params=params,
                                              batch_stats=stats))
    j_seen = _recording(monkeypatch, JM)
    want = j_evaluate.main(args)
    t_seen = _recording(monkeypatch, TM)
    got = t_evaluate.main(args + ["--device", "cpu", "--weights",
                                  str(tmp_path / "w.npz")])
    assert got["num_images"] == want["num_images"] == 4
    assert len(t_seen) == len(j_seen) == 4
    for (tb, ts, tc, tg, tl), (jb, js, jc, jg, jl) in zip(t_seen, j_seen):
        assert tb.shape == jb.shape and len(tb) > 0
        # the kept scores lie well apart: no rank rests on a rounding
        assert np.diff(js).max() < 0 and -np.diff(js).min() > 1e-5
        np.testing.assert_array_equal(tc, jc)
        np.testing.assert_allclose(ts, js, rtol=0, atol=1e-6)
        np.testing.assert_allclose(tb, jb, rtol=0, atol=1e-4)
        np.testing.assert_array_equal(tg, jg)
        np.testing.assert_array_equal(tl, jl)
    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k] == pytest.approx(w, abs=1e-12), k


def test_evaluate_cli_still_refuses_data_parallel_for_the_hourglass():
    with pytest.raises(NotImplementedError, match="Parallelism"):
        t_evaluate.main(["--family", "stacked_hourglass", "--device", "cpu",
                         "--data_parallel"])
