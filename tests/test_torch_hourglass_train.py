"""Training and evaluation of the hourglass models of the PyTorch port
against the JAX package, on the CPU.

* Steps of Adam on the epoch schedule, from the same state (its weights
  made with numpy in the Flax variables' trees,
  `test_torch_hourglass.flax_trees`, and the optax state crossed with
  `from_flax.load_train_state`), on the same batches, as
  `cli.train_hourglass_voc` composes them: one step of `HourglassNet`
  with ``--loss_type focal``, losses over the batch, clip 1; one of
  `StackedHourglass` with the TPU DetBench v2 row's losses over the
  positives, clip 16, and the trainer's microbatches of 2; and three of
  `HourglassNet` at DetBench's own recipe (`benchmarks/run_detbench.py`):
  the CLI's default sigmoid loss, losses over the positives,
  microbatches of 2, clip 16 and the epoch schedule under a linear
  warmup, so that the warmup, Adam's count and the running statistics go
  through steps that start from the state each side's own step wrote.
  After every step: its metrics to rtol 1e-4; the step and Adam's count
  equal; the first moment to 1e-4 of the model's largest element (a
  gradient through some thirty BatchNorms in float32); the parameters to
  1e-4 wherever the first moment is above that, and elsewhere to twice
  the step's size, lr (as `tests/test_torch_fcos_center.py`: Adam's
  update is lr g / (|g| + 1e-8) at the first count, so where g is
  rounding's — a conv bias under a BatchNorm — the step's sign is too);
  the running statistics to 1e-5 of each leaf's largest magnitude.
  `HourglassNet` steps at 128 px: at 64 px its stride-64 maps are 1x1,
  BatchNorm sees two values a channel, and JAX's jitted float32 gradient
  norm lies 4.8e-4 from its float64 value (the port's: 1e-7).
  `StackedHourglass` steps with one stack: with two, in microbatches of
  2, JAX's jitted float32 gradient norm lies 3.6e-4 (64 px) to 7.7e-4
  (128 px) from its float64 value, the port's within 3.3e-7 (one stack:
  JAX 5.9e-7, the port 8.7e-9). The DetBench case computes in float64
  on both sides (parameters, gradients and Adam's state stay float32,
  as in the trainer; BatchNorm reduces in the compute dtype through
  ``DETECTAX_BN_BF16_STATS=1``, which both packages read): in float32 a
  microbatch of 2 at 128 px puts eight values a channel into
  E[x²] − E[x]² at stride 64, and the two packages' first moments lie
  up to 3e-3 of its largest element apart after one step, as far as
  JAX's own moves when the images move by 1e-7 of themselves; in
  float64 they agree to 5e-8.
* The loader with the trainer's hourglass augment and centre padding, on
  canvas buckets and with the content-scale jitter: batches equal.
* `cli.train_hourglass_voc` for two steps (`--variant stacked` on the
  buckets 64 and 128), then `cli.evaluate` from its checkpoint; and
  `cli.evaluate` against `detectax.cli.evaluate` with the same weights:
  detections image by image, the same ground truth, equal summaries.
* `cli.train_hourglass_voc` stopped after two steps and resumed to four
  with ``--resume``: the step count, Adam's moments and the epoch
  schedule's rate go on from the checkpoint.
"""
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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


# variant: (JAX model class, port model class, model keywords, canvas,
# batch, step keywords, (clip, loss keywords), (warmup steps, steps),
# compute dtype)
VARIANTS = {
    "hourglass_focal": (
        JHG, THG, dict(num_classes=NC, n_filters=2), 128, 2,
        dict(loss_norm="batch"),
        (1.0, {"loss_type": "focal", "reg_lambda": 0.1}), (0, 1),
        "float32"),
    "stacked_pos_microbatch": (
        JSH, TSH, dict(num_classes=NC, n_filters=4, n_stacks=1), 64, 4,
        dict(loss_norm="pos", microbatch=2), (16.0, {}), (0, 1),
        "float32"),
    # a warmup of 2 puts step 1 under it and steps 2-3 past it
    "hourglass_detbench": (
        JHG, THG, dict(num_classes=NC, n_filters=2), 128, 4,
        dict(loss_norm="pos", microbatch=2),
        (16.0, {"loss_type": "sigmoid", "reg_lambda": 0.1}), (2, 3),
        "float64"),
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
def test_train_step_equals_the_jax_step(variant, monkeypatch):
    (jcls, tcls, model_kw, canvas, batch_size, step_kw, (clip, loss_kw),
     (warmup, steps), dtype) = VARIANTS[variant]
    if dtype == "float64":
        # both packages read it where a BatchNorm is built or traced
        monkeypatch.setenv("DETECTAX_BN_BF16_STATS", "1")
    with jax.enable_x64(dtype == "float64"):
        jmodel = jcls(**model_kw, dtype=getattr(jnp, dtype))
        tmodel = tcls(**model_kw, dtype=getattr(torch, dtype))
        sched = dict(init_lr=LR, decay=0.9, steps_per_epoch=1)
        if variant.startswith("stacked"):
            j_loss, t_loss = (JTL.stacked_hourglass_loss,
                              TTL.stacked_hourglass_loss)
        else:
            j_loss = functools.partial(JTL.hourglass_loss, **loss_kw)
            t_loss = functools.partial(TTL.hourglass_loss, **loss_kw)
        jsched = JS.with_warmup(JS.make_schedule("epoch", **sched), warmup)
        jopt = JS.make_optimizer("adam", jsched, grad_clip=clip)
        jstep = JLoop.make_train_step(jmodel, _assign(JA, variant), j_loss,
                                      jopt, donate=False, jit=True,
                                      **step_kw)
        params, stats = flax_trees(jmodel, 3, (1, canvas, canvas, 3))
        params_before = dict(_leaves(params))
        jstate = JLoop.TrainState(
            step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
            opt_state=jopt.init(params), ema_params=None)
        topt = TS.make_optimizer(
            "adam", TS.with_warmup(TS.make_schedule("epoch", **sched), warmup),
            grad_clip=clip)
        tstep = TLoop.make_train_step(tmodel, _assign(TA, variant), t_loss,
                                      topt, **step_kw)
        tstate = TLoop.create_train_state(tmodel, None, topt)
        FF.load_train_state(tstate, params, stats,
                            opt_state=_np(jstate.opt_state), step=0)
        rng = np.random.default_rng(7)
        for i in range(steps):
            batch = _batch(rng, batch_size, canvas)
            jstate, jm = jstep(jstate,
                               {k: jnp.asarray(v) for k, v in batch.items()})
            tstate, tm = tstep(tstate, batch)
            assert set(tm) == set(jm)
            for k in jm:
                np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                           rtol=METRIC_RTOL,
                                           err_msg=f"step {i + 1}: {k}")
            assert float(tm["num_pos"]) > 0
            _check_state(tstate, jstate, float(jsched(i)), f"step {i + 1}")
        assert int(tstate.step) == int(jstate.step) == steps
        got = dict(_leaves(FF.to_flax(tstate.model)[0]))
        assert any(not np.array_equal(w, params_before[k])
                   for k, w in got.items())


def _check_state(tstate, jstate, lr, where):
    """The state the port's step wrote against the JAX step's: running
    statistics, Adam's count and first moment, parameters."""
    t_params, t_stats = FF.to_flax(tstate.model)
    for (k, g), (_, w) in zip(_leaves(t_stats),
                              _leaves(_np(jstate.batch_stats))):
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=STATS_RTOL * np.abs(w).max(),
                                   err_msg=f"{where}: {k}")
    fields = FF._optax_fields(_np(jstate.opt_state))
    got_opt = FF.opt_to_flax(tstate)
    assert got_opt["count"] == int(fields["count"]) == int(jstate.step)
    assert int(tstate.step) == int(jstate.step)
    mu = dict(_leaves(fields["mu"]))
    got_mu = dict(_leaves(got_opt["mu"]))
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
                                   err_msg=f"{where}: first moment {k}")
        diff = np.abs(got[k] - want[k])
        big = np.abs(mu[k]) > floor
        assert diff[big].max(initial=0.0) <= ADAM_ATOL, f"{where}: {k}"
        assert diff.max() <= 2 * lr, f"{where}: {k}"


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


def test_evaluate_cli_still_refuses_data_parallel_for_the_hourglass(
        tmp_path, capsys):
    """`--data_parallel` is ported and refuses no family any more: outside
    torchrun the hourglass evaluation goes on in the process alone, on to
    its checkpoint (none here)."""
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        t_evaluate.main(["--family", "stacked_hourglass", "--device", "cpu",
                         "--ckpt_dir", str(tmp_path / "none"),
                         "--data_parallel"])
    assert "no process group" in capsys.readouterr().out


def test_train_cli_resumes_adam_and_the_epoch_schedule(tmp_path, capsys):
    """Two steps with a checkpoint at step 2, then ``--resume --max_steps
    4``: the run says where it resumed, ends at step 4, and its checkpoint
    holds Adam's count 4 for every parameter (a fresh Adam would hold 2)
    and the rate of update 4, lr 0.5^3 on an epoch of one step (a
    restarted schedule would give 0.5)."""
    ckpt = str(tmp_path / "ckpt")
    argv = ["--device", "cpu", "--canvas", str(IMG), "--batch_size", "4",
            "--synthetic_n", "8", "--n_filters", "2", "--display_step", "1",
            "--step_save", "2", "--steps_per_epoch", "1", "--lr_decay",
            "0.5", "--init_lr", str(LR), "--ckpt_dir", ckpt,
            "--out_dir", str(tmp_path / "out")]
    first = train_hourglass_voc.main(argv + ["--max_steps", "2"])
    assert first["final_step"] == 2
    before = CheckpointManager(ckpt)._load(2, "cpu")
    capsys.readouterr()
    second = train_hourglass_voc.main(argv + ["--max_steps", "4",
                                             "--resume"])
    printed = capsys.readouterr().out
    assert "resumed from checkpoint at step 2" in printed
    assert second["final_step"] == 4 and np.isfinite(second["total"])
    steps = [int(line.split()[1]) for line in printed.splitlines()
             if line.startswith("step ")]
    assert steps == [3, 4]
    assert CheckpointManager(ckpt).latest_step() == 4
    after = CheckpointManager(ckpt)._load(4, "cpu")
    assert before["step"] == 2 and after["step"] == 4
    counts = {float(v["step"]) for v in after["opt"]["state"].values()}
    assert counts == {4.0}
    assert {float(v["step"]) for v in before["opt"]["state"].values()} == {
        2.0}
    assert after["opt"]["param_groups"][0]["lr"] == pytest.approx(
        LR * 0.5 ** 3, rel=1e-12)
    # the moments went on from the checkpoint's, which they differ from
    moved = [not torch.equal(after["opt"]["state"][k]["exp_avg_sq"],
                             before["opt"]["state"][k]["exp_avg_sq"])
             for k in before["opt"]["state"]]
    assert all(moved)
