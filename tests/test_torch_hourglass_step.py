"""A train step of each hourglass model of the PyTorch port against the
JAX package's, on the CPU.

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
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detectax.models import HourglassNet as JHG
from detectax.models import StackedHourglass as JSH
from detectax.ops import assign as JA
from detectax.train import loop as JLoop
from detectax.train import losses as JTL
from detectax.train import schedules as JS
from detectax_torch.models import HourglassNet as THG
from detectax_torch.models import StackedHourglass as TSH
from detectax_torch.ops import assign as TA
from detectax_torch.tools import from_flax as FF
from detectax_torch.train import loop as TLoop
from detectax_torch.train import losses as TTL
from detectax_torch.train import schedules as TS
from test_torch_hourglass import flax_trees


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """torch on one thread: the steps are tiny, and beside the suite's
    other workers a pool of threads a process waits on busy cores at every
    operation (tens of times slower)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


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
