"""Training path of the PyTorch port against the JAX package, on the CPU.

Small sizes (tiny backbone, 64 px, batch 4, 3 classes). The same numpy
batch and the same initial state — made by Flax, converted with
`detectax_torch.tools.from_flax.load_train_state` — go through the JAX
package's jitted `make_train_step` and the port's.

Tolerances (float32 on both sides, different summation orders, growing
with the number of steps): parameters, EMA, BatchNorm statistics and
momentum atol 2e-6; losses and grad_norm rtol 1e-4. The gradient is
clipped to norm 1 (raw norms are in the hundreds), so the momentum's
entries are of order 1e-3 and one SGD update moves a parameter by at most
lr x 1.0 = 1e-2. Largest differences seen after three steps: parameters
3.0e-8, momentum 3.0e-8, EMA 4.8e-7, BatchNorm statistics 4.8e-7.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from detectax.models import layers as JL
from detectax.models.fcos import FCOS as JFCOS
from detectax.ops import assign as JA
from detectax.ops import pool as JP
from detectax.train import losses as JTL
from detectax.train import loop as JLoop
from detectax.train import schedules as JS
from detectax_torch.cli import train_fcos as t_train_fcos
from detectax_torch.models import layers as TL
from detectax_torch.models.fcos import FCOS as TFCOS
from detectax_torch.ops import assign as TA
from detectax_torch.ops import pool as TP
from detectax_torch.tools import from_flax as FF
from detectax_torch.train import losses as TTL
from detectax_torch.train import loop as TLoop
from detectax_torch.train import schedules as TS
from detectax_torch.train.checkpoint import CheckpointManager
from detectax_torch.train.driver import restore_for_inference


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """torch on one thread: the steps are tiny, and beside the suite's
    other workers a pool of threads a process waits on busy cores at every
    operation (tens of times slower). Yields the count it replaced."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield threads
    torch.set_num_threads(threads)


@pytest.fixture
def _process_threads(_one_thread):
    """The process's own thread count for one test: the CPU convolutions'
    backward sums in an order the thread count sets, and the three-step
    parity below holds its 2e-6 at the count it was written under."""
    torch.set_num_threads(_one_thread)
    yield
    torch.set_num_threads(1)


IMG, NC, BATCH = 64, 3, 4
PARAM_ATOL, STAT_ATOL, MOMENTUM_ATOL, METRIC_RTOL = 2e-6, 2e-6, 2e-6, 1e-4


def _numpy_tree(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _leaves(tree, prefix=""):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v)


def _assert_trees_close(got, want, atol, what):
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert set(got) == set(want), what
    worst = 0.0
    for k in want:
        assert got[k].shape == want[k].shape, (what, k)
        np.testing.assert_allclose(got[k], want[k], atol=atol,
                                   err_msg=f"{what}: {k}")
        worst = max(worst, float(np.abs(got[k] - want[k]).max()))
    return worst


# --------------------------------------------------------------------------
# BatchNorm, pool backward
# --------------------------------------------------------------------------

@pytest.mark.parametrize("steps", [1, 3])
def test_batchnorm_train_output_and_running_stats(rng, steps):
    c = 6
    scale = rng.uniform(0.5, 1.5, c).astype(np.float32)
    bias = rng.normal(size=c).astype(np.float32)
    mean0 = rng.normal(scale=0.2, size=c).astype(np.float32)
    var0 = rng.uniform(0.5, 2.0, c).astype(np.float32)
    jbn = JL.BatchNorm(use_running_average=False)
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": {"mean": mean0, "var": var0}}
    tbn = TL.BatchNorm(c)
    tbn.load_state_dict({
        "weight": torch.from_numpy(scale), "bias": torch.from_numpy(bias),
        "running_mean": torch.from_numpy(mean0),
        "running_var": torch.from_numpy(var0)})
    for _ in range(steps):
        x = rng.normal(loc=0.3, scale=2.0, size=(3, 5, 4, c)) \
            .astype(np.float32)
        want, mutated = jbn.apply(variables, jnp.asarray(x),
                                  mutable=["batch_stats"])
        variables = {"params": variables["params"], **mutated}
        xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_(True)
        got = tbn(xt, train=True)
        np.testing.assert_allclose(
            got.detach().permute(0, 2, 3, 1).numpy(), np.asarray(want),
            atol=1e-5)
    np.testing.assert_allclose(tbn.running_mean.numpy(),
                               np.asarray(variables["batch_stats"]["mean"]),
                               atol=1e-6)
    np.testing.assert_allclose(tbn.running_var.numpy(),
                               np.asarray(variables["batch_stats"]["var"]),
                               atol=1e-6)
    # biased variance in the running average: F.batch_norm's unbiased one
    # would differ by n / (n - 1) = 60 / 59 in the newest term
    assert not tbn.running_var.requires_grad
    got.sum().backward()
    assert xt.grad is not None and torch.isfinite(xt.grad).all()


def test_batchnorm_train_gradient_matches_jax(rng):
    c = 4
    x = rng.normal(size=(2, 3, 3, c)).astype(np.float32)
    w = rng.normal(size=(2, 3, 3, c)).astype(np.float32)
    jbn = JL.BatchNorm(use_running_average=False)
    variables = jbn.init(jax.random.key(0), jnp.asarray(x))

    def j_fn(xx):
        y, _ = jbn.apply(variables, xx, mutable=["batch_stats"])
        return jnp.sum(y * w)

    want = jax.grad(j_fn)(jnp.asarray(x))
    tbn = TL.BatchNorm(c)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_(True)
    (tbn(xt, train=True)
     * torch.from_numpy(w).permute(0, 3, 1, 2)).sum().backward()
    np.testing.assert_allclose(xt.grad.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("ties", [False, True])
def test_tied_pool_backward_matches_jax(rng, ties):
    x = rng.normal(size=(2, 8, 6, 3)).astype(np.float32)
    if ties:
        x = np.maximum(np.round(x), 0.0)   # post-ReLU-like: many ties at 0
    dy = rng.normal(size=(2, 4, 3, 3)).astype(np.float32)
    y = JP._pool_fwd_raw(jnp.asarray(x))
    want = np.asarray(JP._pool_bwd_raw(jnp.asarray(x), y, jnp.asarray(dy)))

    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_(True)
    yt = TP.max_pool_3x3_s2(xt, tied_vjp=True)
    np.testing.assert_array_equal(
        yt.detach().permute(0, 2, 3, 1).numpy(), np.asarray(y))
    yt.backward(torch.from_numpy(dy).permute(0, 3, 1, 2))
    got = xt.grad.permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)

    # the default keeps PyTorch's derivative: equal without ties, all of a
    # tied window's gradient on one member with them
    xd = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_(True)
    TP.max_pool_3x3_s2(xd).backward(torch.from_numpy(dy).permute(0, 3, 1, 2))
    default = xd.grad.permute(0, 2, 3, 1).numpy()
    if ties:
        assert np.abs(default - want).max() > 1e-3
        np.testing.assert_allclose(default.sum(), want.sum(), rtol=1e-4)
    else:
        np.testing.assert_allclose(default, want, atol=1e-6)


def test_tied_pool_odd_size_keeps_the_default_derivative(rng):
    x = torch.from_numpy(rng.normal(size=(1, 2, 7, 7)).astype(np.float32))
    a = x.clone().requires_grad_(True)
    b = x.clone().requires_grad_(True)
    TP.max_pool_3x3_s2(a, tied_vjp=True).sum().backward()
    TP.max_pool_3x3_s2(b).sum().backward()
    assert torch.equal(a.grad, b.grad)


# --------------------------------------------------------------------------
# schedules, clip, optimizers
# --------------------------------------------------------------------------

SCHEDULES = {
    "exponential": dict(init_lr=5e-4, decay_rate=0.75, decay_steps=1000,
                        min_lr=1e-5),
    "piecewise": dict(init_lr=1e-2, boundaries=[1, 999, 5000],
                      scales=[0.5, 0.1, 0.1]),
    "epoch": dict(init_lr=1e-2, decay=0.9, steps_per_epoch=100),
    "constant": dict(init_lr=3e-3),
    "cosine": dict(init_lr=1e-2, decay_steps=2000, alpha=0.05),
}
STEPS = (0, 1, 2, 998, 999, 1000, 5000, 10 ** 5)


@pytest.mark.parametrize("kind", sorted(SCHEDULES))
@pytest.mark.parametrize("warmup", [0, 500])
def test_schedules_match_jax(kind, warmup):
    js = JS.make_schedule(kind, **SCHEDULES[kind])
    ts = TS.make_schedule(kind, **SCHEDULES[kind])
    js, ts = JS.with_warmup(js, warmup), TS.with_warmup(ts, warmup)
    for step in STEPS:
        got = ts(step)
        assert isinstance(got, float)
        # the JAX side computes the power in float32 (and underflows
        # to 0 where float64 still holds 1e-48)
        np.testing.assert_allclose(got, float(js(step)), rtol=2e-6,
                                   atol=1e-30,
                                   err_msg=f"{kind} at step {step}")
    with pytest.raises(ValueError, match="unknown schedule"):
        TS.make_schedule("linear", init_lr=1.0)


@pytest.mark.parametrize("scale", [0.01, 1.0, 100.0])
def test_clip_by_global_norm_matches_optax(rng, scale):
    grads = [(scale * rng.normal(size=s)).astype(np.float32)
             for s in ((3, 4), (5,), (2, 2, 2))]
    want, _ = optax.clip_by_global_norm(1.0).update(
        [jnp.asarray(g) for g in grads], optax.EmptyState())
    got = TS.clip_by_global_norm([torch.from_numpy(g) for g in grads], 1.0)
    for g, w, raw in zip(got, want, grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)
        if scale == 0.01:               # below the clip: untouched bits
            np.testing.assert_array_equal(g.numpy(), raw)
    np.testing.assert_allclose(
        float(TS.global_norm([torch.from_numpy(g) for g in grads])),
        float(optax.global_norm([jnp.asarray(g) for g in grads])),
        rtol=1e-6)


@pytest.mark.parametrize("name,weight_decay", [
    ("sgd", 0.0), ("sgd", 1e-2), ("adam", 0.0), ("adamw", 1e-2)])
def test_optimizer_updates_match_optax(rng, name, weight_decay):
    shapes = ((3, 4), (5,))
    p0 = [rng.normal(size=s).astype(np.float32) for s in shapes]
    sched = dict(init_lr=1e-2, decay_rate=0.5, decay_steps=2, min_lr=1e-5)
    jopt = JS.make_optimizer(name, JS.exponential_with_floor(**sched),
                             grad_clip=1.0, weight_decay=weight_decay)
    topt = TS.make_optimizer(name, TS.exponential_with_floor(**sched),
                             grad_clip=1.0, weight_decay=weight_decay)
    jp = [jnp.asarray(p) for p in p0]
    jstate = jopt.init(jp)
    tp = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in p0]
    bound = topt.bind(tp)
    for step in range(4):
        scale = (0.1, 5.0, 0.3, 2.0)[step]   # both sides of the clip
        grads = [(scale * rng.normal(size=s)).astype(np.float32)
                 for s in shapes]
        updates, jstate = jopt.update([jnp.asarray(g) for g in grads],
                                      jstate, jp)
        jp = optax.apply_updates(jp, updates)
        topt.update(bound, [torch.from_numpy(g) for g in grads], step)
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                       atol=1e-6, err_msg=f"step {step}")
        assert all(p.grad is None for p in tp)
    with pytest.raises(ValueError, match="unknown optimizer"):
        TS.make_optimizer("lion", TS.constant(1.0))


# --------------------------------------------------------------------------
# the train step
# --------------------------------------------------------------------------

def _batch(rng, uint8=False):
    boxes = np.zeros((BATCH, 6, 4), np.float32)
    boxes[..., 0] = rng.uniform(0.3, 0.7, (BATCH, 6))
    boxes[..., 1] = rng.uniform(0.3, 0.7, (BATCH, 6))
    boxes[..., 2] = rng.uniform(0.1, 0.6, (BATCH, 6))
    boxes[..., 3] = rng.uniform(0.1, 0.6, (BATCH, 6))
    valid = np.ones((BATCH, 6), bool)
    valid[1, 3:] = False
    valid[3] = False                    # a chunk with few positives
    if uint8:
        images = rng.integers(0, 256, (BATCH, IMG, IMG, 3), dtype=np.uint8)
    else:
        images = rng.normal(size=(BATCH, IMG, IMG, 3)).astype(np.float32)
    return {"images": images, "boxes": boxes,
            "labels": rng.integers(0, NC, (BATCH, 6)).astype(np.int32),
            "valid": valid}


def _j_assign(boxes, labels, valid):
    return JA.fcos_assign(boxes, labels, valid, img_dim=(IMG, IMG),
                          num_classes=NC)[0]


def _t_assign(boxes, labels, valid):
    return TA.fcos_assign(boxes, labels, valid, img_dim=(IMG, IMG),
                          num_classes=NC)[0]


def _make_both(loss_norm="batch", microbatch=None, normalize=None,
               weight_decay=0.0, freeze_bn=False):
    kw = dict(grad_clip=1.0, weight_decay=weight_decay)
    jmodel = JFCOS(num_classes=NC, backbone="tiny", freeze_bn=freeze_bn)
    jopt = JS.make_optimizer("sgd", JS.exponential_with_floor(1e-2), **kw)
    jstep = JLoop.make_train_step(
        jmodel, _j_assign, JTL.fcos_loss, jopt, microbatch=microbatch,
        donate=False, jit=True, normalize=normalize, loss_norm=loss_norm,
        ema_decay=0.9)
    jstate = JLoop.create_train_state(
        jmodel, jax.random.PRNGKey(0), jnp.zeros((BATCH, IMG, IMG, 3)), jopt,
        ema=True)

    tmodel = TFCOS(num_classes=NC, backbone="tiny", freeze_bn=freeze_bn)
    topt = TS.make_optimizer("sgd", TS.exponential_with_floor(1e-2), **kw)
    tstep = TLoop.make_train_step(
        tmodel, _t_assign, TTL.fcos_loss, topt, microbatch=microbatch,
        normalize=normalize, loss_norm=loss_norm, ema_decay=0.9)
    tstate = TLoop.create_train_state(tmodel, None, topt, ema=True)
    FF.load_train_state(
        tstate, _numpy_tree(jstate.params), _numpy_tree(jstate.batch_stats),
        opt_state=_numpy_tree(jstate.opt_state), step=int(jstate.step),
        ema_params=_numpy_tree(jstate.ema_params))
    return (jstep, jstate), (tstep, tstate)


def _compare_states(jstate, tstate, what):
    assert tstate.step == int(jstate.step)
    params, stats = FF.to_flax(tstate.model)
    worst = {
        "params": _assert_trees_close(
            params, _numpy_tree(jstate.params), PARAM_ATOL, f"{what} params"),
        "batch_stats": _assert_trees_close(
            stats, _numpy_tree(jstate.batch_stats), STAT_ATOL,
            f"{what} batch_stats"),
        "ema": _assert_trees_close(
            FF.ema_to_flax(tstate), _numpy_tree(jstate.ema_params),
            PARAM_ATOL, f"{what} ema"),
    }
    trace = FF._optax_fields(_numpy_tree(jstate.opt_state))["trace"]
    worst["momentum"] = _assert_trees_close(
        FF.opt_to_flax(tstate)["trace"], trace, MOMENTUM_ATOL,
        f"{what} momentum")
    return worst


@pytest.mark.usefixtures("_process_threads")
@pytest.mark.parametrize("loss_norm,microbatch,normalize,weight_decay", [
    ("batch", None, None, 0.0),
    ("batch", 2, "tf", 1e-3),
    ("pos", None, None, 0.0),
    ("pos", 2, None, 0.0),
])
def test_train_steps_match_jax(loss_norm, microbatch, normalize,
                               weight_decay):
    (jstep, jstate), (tstep, tstate) = _make_both(
        loss_norm, microbatch, normalize, weight_decay)
    _compare_states(jstate, tstate, "converted state")
    stats0 = FF.to_flax(tstate.model)[1]
    rng = np.random.default_rng(5)
    worst = {}
    for n in (1, 2, 3):
        batch = _batch(rng, uint8=normalize is not None)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        same, tm = tstep(tstate, batch)
        assert same is tstate and tstate.step == n
        assert set(tm) == set(jm)
        for k in jm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=METRIC_RTOL,
                                       err_msg=f"{k} at step {n}")
        if n in (1, 3):
            worst[n] = _compare_states(jstate, tstate, f"after {n} steps")
    assert float(tm["num_pos"]) > 0
    moved = _assert_trees_close(FF.to_flax(tstate.model)[1], stats0, 10.0,
                                "stats")
    assert moved > 1e-4, "BatchNorm running statistics did not move"
    print(f"largest differences {loss_norm}/{microbatch}: {worst}")


def test_freeze_bn_keeps_backbone_statistics():
    (jstep, jstate), (tstep, tstate) = _make_both(freeze_bn=True)
    stats0 = FF.to_flax(tstate.model)[1]
    batch = _batch(np.random.default_rng(6))
    jstate, _ = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    tstep(tstate, batch)
    _compare_states(jstate, tstate, "freeze_bn, one step")
    assert _assert_trees_close(FF.to_flax(tstate.model)[1], stats0, 0.0,
                               "frozen stats") == 0.0


def test_microbatch_pos_norm_matches_the_unsplit_step():
    """With frozen BatchNorm the split step's gradients are the unsplit
    step's: chunks are accumulated unnormalized and divided once."""
    grads = {}
    for micro in (None, 2):
        (_, _), (tstep, tstate) = _make_both("pos", micro, freeze_bn=True)
        _, m = tstep(tstate, _batch(np.random.default_rng(7)))
        grads[micro] = (float(m["grad_norm"]), float(m["total"]))
    np.testing.assert_allclose(grads[2], grads[None], rtol=1e-4)


def test_train_step_rejects_what_it_cannot_run():
    (_, _), (tstep, tstate) = _make_both(microbatch=3)
    with pytest.raises(ValueError, match="divide by microbatch"):
        tstep(tstate, _batch(np.random.default_rng(0)))
    other = TLoop.create_train_state(
        TFCOS(num_classes=NC, backbone="tiny"), None,
        TS.make_optimizer("sgd", TS.constant(1e-2)))
    with pytest.raises(ValueError, match="another model"):
        tstep(other, _batch(np.random.default_rng(0)))
    with pytest.raises(ValueError, match="loss_norm"):
        TLoop.make_train_step(other.model, _t_assign, TTL.fcos_loss,
                              TS.make_optimizer("sgd", TS.constant(1e-2)),
                              loss_norm="cells")


def test_adam_state_crosses_over_and_back(rng):
    jmodel = JFCOS(num_classes=NC, backbone="tiny")
    jopt = JS.make_optimizer("adam", JS.exponential_with_floor(1e-3))
    jstep = JLoop.make_train_step(jmodel, _j_assign, JTL.fcos_loss, jopt,
                                  donate=False)
    jstate = JLoop.create_train_state(
        jmodel, jax.random.PRNGKey(1), jnp.zeros((BATCH, IMG, IMG, 3)), jopt)
    batch = _batch(rng)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jstate, _ = jstep(jstate, jbatch)          # non-trivial moments

    tmodel = TFCOS(num_classes=NC, backbone="tiny")
    topt = TS.make_optimizer("adam", TS.exponential_with_floor(1e-3))
    tstate = TLoop.create_train_state(tmodel, None, topt)
    FF.load_train_state(
        tstate, _numpy_tree(jstate.params), _numpy_tree(jstate.batch_stats),
        opt_state=_numpy_tree(jstate.opt_state), step=int(jstate.step))
    back = FF.opt_to_flax(tstate)
    fields = FF._optax_fields(_numpy_tree(jstate.opt_state))
    assert back["count"] == int(fields["count"]) == 1
    assert _assert_trees_close(back["mu"], fields["mu"], 0.0, "mu") == 0.0
    assert _assert_trees_close(back["nu"], fields["nu"], 0.0, "nu") == 0.0

    tstep = TLoop.make_train_step(tmodel, _t_assign, TTL.fcos_loss, topt)
    jstate, _ = jstep(jstate, jbatch)
    tstep(tstate, batch)
    # Adam's update is lr * m / (sqrt(v) + eps), of order lr = 1e-3 per
    # element whatever the gradient's size: atol 2e-5 is 2 % of an update
    _assert_trees_close(FF.to_flax(tstate.model)[0],
                        _numpy_tree(jstate.params), 2e-5, "adam params")
    with pytest.raises(ValueError, match="without EMA"):
        FF.load_train_state(tstate, _numpy_tree(jstate.params),
                            _numpy_tree(jstate.batch_stats),
                            ema_params=_numpy_tree(jstate.params))


def test_eval_forward_uses_running_stats():
    (_, _), (tstep, tstate) = _make_both()
    batch = _batch(np.random.default_rng(2))
    tstep(tstate, batch)
    stats = FF.to_flax(tstate.model)[1]
    outs = TLoop.make_eval_forward(tstate.model)(batch["images"])
    assert len(outs) == 5 and all(torch.isfinite(o).all() for o in outs)
    assert not outs[0].requires_grad
    assert _assert_trees_close(FF.to_flax(tstate.model)[1], stats, 0.0,
                               "eval stats") == 0.0


# --------------------------------------------------------------------------
# checkpoint, fit, CLI
# --------------------------------------------------------------------------

def test_checkpoint_restore_gives_the_identical_next_step(tmp_path):
    (_, _), (tstep, tstate) = _make_both(weight_decay=1e-3)
    rng = np.random.default_rng(8)
    first, second = _batch(rng), _batch(rng)
    tstep(tstate, first)
    mgr = CheckpointManager(str(tmp_path / "ckpt"), max_to_keep=2)
    assert mgr.latest_step() is None and mgr.restore_latest(tstate) is None
    mgr.save(1, tstate)
    mgr.wait()
    assert mgr.latest_step() == 1
    assert not [f for f in os.listdir(mgr.directory) if f.endswith(".tmp")]

    # another model, optimizer and step function, filled from the file
    model2 = TFCOS(num_classes=NC, backbone="tiny",
                   generator=torch.Generator().manual_seed(99))
    opt2 = TS.make_optimizer("sgd", TS.exponential_with_floor(1e-2),
                             grad_clip=1.0, weight_decay=1e-3)
    state2 = TLoop.create_train_state(model2, None, opt2, ema=True)
    step2 = TLoop.make_train_step(model2, _t_assign, TTL.fcos_loss, opt2,
                                  ema_decay=0.9)
    restored, at = CheckpointManager(mgr.directory).restore_latest(state2)
    assert restored is state2 and at == 1 and state2.step == 1

    _, m1 = tstep(tstate, second)
    _, m2 = step2(state2, second)
    for k in m1:
        assert float(m1[k]) == float(m2[k]), k
    for a, b in zip(FF.to_flax(tstate.model), FF.to_flax(model2)):
        assert _assert_trees_close(a, b, 0.0, "after restore") == 0.0
    assert _assert_trees_close(FF.opt_to_flax(tstate)["trace"],
                               FF.opt_to_flax(state2)["trace"], 0.0,
                               "momentum") == 0.0
    assert _assert_trees_close(FF.ema_to_flax(tstate),
                               FF.ema_to_flax(state2), 0.0, "ema") == 0.0

    # retention, and inference restore of raw and EMA weights
    mgr.save(2, tstate)
    mgr.save(3, tstate)
    assert mgr.all_steps() == [2, 3]
    model3 = TFCOS(num_classes=NC, backbone="tiny")
    assert restore_for_inference(mgr.directory, model3) is model3
    assert _assert_trees_close(FF.to_flax(model3)[0],
                               FF.to_flax(tstate.model)[0], 0.0, "raw") == 0.0
    restore_for_inference(mgr.directory, model3, use_ema=True)
    assert _assert_trees_close(FF.to_flax(model3)[0], FF.ema_to_flax(tstate),
                               0.0, "ema weights") == 0.0
    with pytest.raises(FileNotFoundError):
        restore_for_inference(str(tmp_path / "empty"), model3)


def _cli_args(tmp_path, *extra):
    return ["--device", "cpu", "--backbone", "tiny", "--canvas", "64",
            "--batch_size", "2", "--synthetic_n", "8", "--display_step", "1",
            "--step_save", "2", "--ckpt_dir", str(tmp_path / "ckpt"),
            "--out_dir", str(tmp_path / "out"), *extra]


def test_train_fcos_cli_two_steps_and_resume(tmp_path, capsys):
    summary = t_train_fcos.main(_cli_args(tmp_path, "--max_steps", "2"))
    assert summary["final_step"] == 2 and np.isfinite(summary["total"])
    assert CheckpointManager(str(tmp_path / "ckpt")).latest_step() == 2
    with open(tmp_path / "out" / "losses.csv") as f:
        assert len(f.read().strip().splitlines()) == 3
    summary = t_train_fcos.main(
        _cli_args(tmp_path, "--max_steps", "3", "--resume"))
    assert "resumed from checkpoint at step 2" in capsys.readouterr().out
    assert summary["final_step"] == 3
    with open(tmp_path / "out" / "losses.csv") as f:
        assert len(f.read().strip().splitlines()) == 4


@pytest.mark.parametrize("flag", [
    ("--bf16",), ("--dump_visuals",), ("--dataset", "detbench")])
def test_train_fcos_cli_flags_that_wait_raise(tmp_path, monkeypatch, flag):
    """Every one of these flags is ported now and trains: `--bf16` (a
    bf16 compute dtype, float32 parameters), `--dump_visuals` and the
    DetBench datasets (cut to 4 training images of its spec, cached under
    the test's directory)."""
    args = _cli_args(tmp_path, "--max_steps", "1", *flag)
    if flag == ("--bf16",):
        summary = t_train_fcos.main(args)
        assert summary["final_step"] == 1 and np.isfinite(summary["total"])
        assert CheckpointManager(str(tmp_path / "ckpt")).latest_step() == 1
        return
    from detectax_torch.data import detbench

    spec = dict(detbench.SPECS["detbench"], n_train=4)
    monkeypatch.setattr(detbench, "load_spec", lambda *a, **k: spec)
    monkeypatch.setenv("DETECTAX_DETBENCH_CACHE", str(tmp_path / "cache"))
    summary = t_train_fcos.main(args)
    assert summary["final_step"] == 1 and np.isfinite(summary["total"])
    drawn = os.path.exists(tmp_path / "out" / "detect_1.jpg")
    assert drawn == (flag == ("--dump_visuals",))
    assert os.path.exists(tmp_path / "cache") == (flag[0] == "--dataset")


def test_train_fcos_cli_needs_a_device_by_default(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device exists")
    args = [a for a in _cli_args(tmp_path, "--max_steps", "1")
            if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="CUDA"):
        t_train_fcos.main(args)


def test_loader_batches_equal_the_jax_package(rng):
    from detectax.data import Loader as JLoader
    from detectax.data import SyntheticDataset as JSynthetic
    from detectax_torch.data.pipeline import Loader as TLoader
    from detectax_torch.data.synthetic import SyntheticDataset as TSynthetic

    kw = dict(batch_size=3, canvas=64, max_boxes=8, steps=2, seed=4,
              prefetch=0, jitter=(40, 64), emit_uint8=True)
    want = list(JLoader(JSynthetic(n=8, img_size=96, seed=1), native=False,
                        **kw))
    got = list(TLoader(TSynthetic(n=8, img_size=96, seed=1), **kw))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            assert g[k].dtype == w[k].dtype
            np.testing.assert_array_equal(g[k], w[k])


def test_index_dataset_feeds_the_loader(tmp_path, rng):
    from PIL import Image

    from detectax_torch.data.index import IndexDataset
    from detectax_torch.data.pipeline import Loader as TLoader

    samples = []
    for i in range(3):
        path = str(tmp_path / f"{i}.png")
        Image.fromarray(rng.integers(0, 256, (40, 60, 3), dtype=np.uint8)) \
            .save(path)
        samples.append({"image_path": path,
                        "boxes_xyxy": [[0.1, 0.2, 0.6, 0.8]], "labels": [i]})
    index = str(tmp_path / "index.json")
    with open(index, "w") as f:
        json.dump({"classes": ["a", "b", "c"], "samples": samples}, f)
    ds = IndexDataset(index)
    assert ds.num_classes == 3 and len(ds) == 3
    batch = next(iter(TLoader(ds, batch_size=3, canvas=64, max_boxes=4,
                              steps=1, prefetch=0, flip=False,
                              emit_uint8=True)))
    assert batch["images"].shape == (3, 64, 64, 3)
    assert batch["images"].dtype == np.uint8
    assert batch["valid"].sum() == 3
    assert sorted(batch["labels"][:, 0].tolist()) == [0, 1, 2]
    # 40 x 60 content scaled by 64 / 60 onto the top-left of the canvas
    np.testing.assert_allclose(batch["boxes"][0, 0, 2], 0.6 * 43 / 64,
                               atol=1e-6)


def test_init_backbone_loads_only_the_trunk(tmp_path):
    donor = TFCOS(num_classes=NC, backbone="tiny",
                  generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        donor.backbone.ConvBN_0.BatchNorm_0.running_mean.fill_(0.25)
    path = str(tmp_path / "w.npz")
    FF.save_npz(path, *FF.to_flax(donor))
    from detectax_torch.train.driver import load_backbone_weights

    model = TFCOS(num_classes=NC, backbone="tiny")
    head0 = model.cls_head_1.Conv_0.weight.clone()
    state = TLoop.create_train_state(
        model, None, TS.make_optimizer("sgd", TS.constant(1e-2)))
    load_backbone_weights(state, path)
    for (k, a), (_, b) in zip(model.backbone.state_dict().items(),
                              donor.backbone.state_dict().items()):
        assert torch.equal(a, b), k
    assert torch.equal(model.cls_head_1.Conv_0.weight, head0)
    wrong = TFCOS(num_classes=NC, backbone="mobilenetv2")
    wstate = TLoop.create_train_state(
        wrong, None, TS.make_optimizer("sgd", TS.constant(1e-2)))
    with pytest.raises(KeyError, match="do not match"):
        load_backbone_weights(wstate, path)
