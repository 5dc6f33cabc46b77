"""The FCOS center variants of the port against the JAX package, on the CPU.

* `fcos_center_assign` (3x3 center sampling, and centroid-only) and
  `fcos_center_v1_assign` (centroid offset + scale): the same padded numpy
  boxes through the JAX package's assigners (mapped over the batch with
  `jax.vmap`, as the train step does) and the port's batched ones. Class
  one-hots, the ownership mask, the centerness channel of the 3x3 variant
  (1, 0.5, 0.25 or 0) and the target counts must be **equal**; the
  regression channels agree to atol 1e-6 (the same float32 operations).
* One train step of each center CLI's configuration — FCOS "center" with
  Adam, FCOS "center_v1" with SGD-momentum, both with the centerness as a
  focal term (ten focal segments) — from the same state (made by Flax,
  converted with `from_flax.load_train_state`) on the same batch, at the
  tolerances of `tests/test_torch_train.py`: losses and grad_norm rtol
  1e-4; parameters atol 2e-6 after SGD; after Adam the first moment (0.1
  of the clipped gradient) atol 2e-7, which is SGD's 2e-6 on the gradient,
  and the parameters atol 2e-5 (2 % of an update of lr = 1e-3) wherever
  the gradient is above 1e-6. Adam's first update is lr g / (|g| + 1e-8):
  where g is within a few 1e-9 of zero (both sides agree on it to 4e-10)
  the normalised step is rounding's, and there the parameters are held to
  the step's own size, lr.
* Both CLIs for two steps on the synthetic set on the CPU.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detectax.models.fcos import FCOS as JFCOS
from detectax.ops import assign as JA
from detectax.train import loop as JLoop
from detectax.train import losses as JTL
from detectax.train import schedules as JS
from detectax_torch.cli import train_fcos_center_v1_voc as t_center_v1
from detectax_torch.cli import train_fcos_center_voc as t_center
from detectax_torch.models.fcos import FCOS as TFCOS
from detectax_torch.ops import assign as TA
from detectax_torch.tools import from_flax as FF
from detectax_torch.train import loop as TLoop
from detectax_torch.train import losses as TTL
from detectax_torch.train import schedules as TS
from detectax_torch.train.checkpoint import CheckpointManager

NC = 5
ATOL = 1e-6
IMG, BATCH = 64, 4
METRIC_RTOL, SGD_ATOL, ADAM_ATOL = 1e-4, 2e-6, 2e-5


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """torch on one thread: the shapes are tiny, and beside the suite's
    other workers a pool of threads a process waits on busy cores at every
    operation (tens of times slower). Yields the count it replaced."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield threads
    torch.set_num_threads(threads)


def _boxes(rng, batch, n, case):
    b = np.zeros((batch, n, 4), np.float32)
    b[..., 0] = rng.uniform(0.05, 0.95, (batch, n))
    b[..., 1] = rng.uniform(0.05, 0.95, (batch, n))
    b[..., 2] = rng.uniform(0.02, 0.9, (batch, n))
    b[..., 3] = rng.uniform(0.02, 0.9, (batch, n))
    labels = rng.integers(0, NC, (batch, n)).astype(np.int32)
    valid = rng.uniform(size=(batch, n)) < 0.8
    if case == "edge":
        b[:, 0] = (0.02, 0.5, 0.3, 0.6)      # over the top edge
        b[:, 1] = (0.5, 0.99, 0.4, 0.3)      # over the right edge
        b[:, 2] = (0.5, 0.5, 1.2, 1.2)       # larger than the image
        b[:, 3] = (0.5, 0.5, 0.5, 0.25)      # centre on a cell boundary
        b[:, 4] = (1.0, 1.0, 0.02, 0.02)     # centroid on the far corner
        valid[:, :5] = True
    elif case == "ties":
        b[:, 0] = (0.5, 0.5, 0.5, 0.25)
        b[:, 1] = (0.5, 0.5, 0.25, 0.5)      # same area, same centre cell
        b[:, 2] = (0.5, 0.5, 0.5, 0.25)      # exact duplicate of 0
        b[:, 3] = (0.52, 0.5, 0.5, 0.25)     # a neighbouring centre cell
        labels[:, :4] = (0, 1, 2, 3)
        valid[:, :4] = True
    elif case == "all_invalid":
        valid[:] = False
    return b, labels, valid


def _assign_both(variant, boxes, labels, valid, **kw):
    j_fn = {"center": JA.fcos_center_assign,
            "v1": JA.fcos_center_v1_assign}[variant]
    t_fn = {"center": TA.fcos_center_assign,
            "v1": TA.fcos_center_v1_assign}[variant]
    j_batch = jax.jit(jax.vmap(functools.partial(j_fn, num_classes=NC,
                                                 **kw)))
    want, want_n = j_batch(jnp.asarray(boxes), jnp.asarray(labels),
                           jnp.asarray(valid))
    got, got_n = t_fn(torch.from_numpy(boxes), torch.from_numpy(labels),
                      torch.from_numpy(valid), num_classes=NC, **kw)
    return ([np.asarray(w) for w in want], np.asarray(want_n),
            [g.numpy() for g in got], got_n.numpy())


@pytest.mark.parametrize("case", ["random", "edge", "ties", "all_invalid"])
@pytest.mark.parametrize("variant,kw", [
    ("center", {}), ("center", {"center_only": True}), ("v1", {}),
    ("v1", {"box_scales": (16.0, 32.0, 64.0, 128.0, 100.0)})],
    ids=["center_3x3", "center_only", "v1", "v1_scales"])
def test_center_assigns_match_jax(variant, kw, case):
    rng = np.random.default_rng(11)
    boxes, labels, valid = _boxes(rng, 3, 12, case)
    want, want_n, got, got_n = _assign_both(
        variant, boxes, labels, valid, img_dim=(128, 128), **kw)
    np.testing.assert_array_equal(got_n, want_n)
    assert len(got) == len(want) == 5
    for lvl, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape and g.dtype == w.dtype, lvl
        np.testing.assert_array_equal(g[..., 5:], w[..., 5:],
                                      err_msg=f"one-hots, level {lvl}")
        # the centerness channel is a mask (v1) or one of four scores
        np.testing.assert_array_equal(g[..., 4], w[..., 4],
                                      err_msg=f"centerness, level {lvl}")
        np.testing.assert_allclose(g[..., :4], w[..., :4], atol=ATOL,
                                   err_msg=f"regression, level {lvl}")
    if case == "all_invalid":
        assert not any(g.any() for g in got)
    else:
        assert any(g[..., 5:].any() for g in got)


@pytest.mark.parametrize("variant", ["center", "v1"])
def test_center_assigns_content_smaller_than_canvas(variant):
    rng = np.random.default_rng(3)
    boxes, labels, valid = _boxes(rng, 2, 10, "edge")
    want, want_n, got, got_n = _assign_both(
        variant, boxes, labels, valid, img_dim=(96, 112),
        img_pad=(128, 128))
    np.testing.assert_array_equal(got_n, want_n)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[..., 4:], w[..., 4:])
        np.testing.assert_allclose(g[..., :4], w[..., :4], atol=ATOL)
    assert got[0].shape == (2, 16, 16, 5 + NC)


def test_center_score_neighbourhood():
    """One box alone: 1 at its centre cell, 0.5 on the edges and 0.25 on
    the diagonals of the 3x3 neighbourhood; centroid-only keeps the 1."""
    boxes = np.array([[[0.5, 0.5, 0.2, 0.2]]], np.float32)   # 25.6 px
    args = (torch.from_numpy(boxes), torch.zeros((1, 1), dtype=torch.int32),
            torch.ones((1, 1), dtype=torch.bool))
    outs, n = TA.fcos_center_assign(*args, img_dim=(128, 128),
                                    num_classes=NC)
    cen = outs[0][0, ..., 4].numpy()        # level 0, 16 x 16
    assert n.tolist() == [[1, 0, 0, 0, 0]]
    np.testing.assert_array_equal(cen[7:10, 7:10], [[0.25, 0.5, 0.25],
                                                    [0.5, 1.0, 0.5],
                                                    [0.25, 0.5, 0.25]])
    assert cen.sum() == 4.0
    outs, _ = TA.fcos_center_assign(*args, img_dim=(128, 128),
                                    num_classes=NC, center_only=True)
    assert outs[0][0, ..., 4].sum() == 1.0
    with pytest.raises(ValueError, match="padded batch"):
        TA.fcos_center_v1_assign(torch.zeros(4, 4), torch.zeros(4),
                                 torch.zeros(4), img_dim=(64, 64),
                                 num_classes=NC)


# --------------------------------------------------------------------------
# one train step of each CLI's configuration
# --------------------------------------------------------------------------

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
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=atol,
                                   err_msg=f"{what}: {k}")


def _batch(rng):
    boxes = np.zeros((BATCH, 6, 4), np.float32)
    boxes[..., :2] = rng.uniform(0.3, 0.7, (BATCH, 6, 2))
    boxes[..., 2:] = rng.uniform(0.1, 0.6, (BATCH, 6, 2))
    valid = np.ones((BATCH, 6), bool)
    valid[1, 3:] = False
    return {"images": rng.normal(size=(BATCH, IMG, IMG, 3))
            .astype(np.float32),
            "boxes": boxes,
            "labels": rng.integers(0, NC, (BATCH, 6)).astype(np.int32),
            "valid": valid}


def _config(variant, lib_assign, lib_losses, lib_sched):
    """(model variant, optimizer, schedule, assign_fn, loss_fn) as the CLI
    composes them, over the JAX package's or the port's libraries."""
    img = (IMG, IMG)
    loss_fn = functools.partial(lib_losses.fcos_loss, reg_type="l1",
                                cen_type="focal")
    if variant == "center":
        def assign_fn(boxes, labels, valid):
            return lib_assign.fcos_center_assign(
                boxes, labels, valid, img_dim=img, num_classes=NC,
                center_only=True)[0]
        sched = lib_sched.make_schedule("piecewise", init_lr=1e-3,
                                        boundaries=[8000], scales=[0.1])
        return "center", "adam", sched, assign_fn, loss_fn

    def assign_fn(boxes, labels, valid):
        return lib_assign.fcos_center_v1_assign(
            boxes, labels, valid, img_dim=img, num_classes=NC)[0]
    sched = lib_sched.make_schedule("exponential", init_lr=0.01)
    return "center_v1", "sgd", sched, assign_fn, loss_fn


@pytest.mark.parametrize("variant", ["center", "v1"])
def test_center_cli_train_step_matches_jax(variant):
    model_variant, opt, jsched, j_assign, j_loss = _config(
        variant, JA, JTL, JS)
    _, _, tsched, t_assign, t_loss = _config(variant, TA, TTL, TS)
    jmodel = JFCOS(num_classes=NC, variant=model_variant, backbone="tiny")
    jopt = JS.make_optimizer(opt, jsched, grad_clip=1.0)
    jstep = JLoop.make_train_step(jmodel, j_assign, j_loss, jopt,
                                  donate=False, jit=True)
    jstate = JLoop.create_train_state(
        jmodel, jax.random.PRNGKey(0), jnp.zeros((BATCH, IMG, IMG, 3)), jopt)
    tmodel = TFCOS(num_classes=NC, variant=model_variant, backbone="tiny")
    topt = TS.make_optimizer(opt, tsched, grad_clip=1.0)
    tstep = TLoop.make_train_step(tmodel, t_assign, t_loss, topt)
    tstate = TLoop.create_train_state(tmodel, None, topt)
    FF.load_train_state(
        tstate, _numpy_tree(jstate.params), _numpy_tree(jstate.batch_stats),
        opt_state=_numpy_tree(jstate.opt_state), step=int(jstate.step))

    batch = _batch(np.random.default_rng(21))
    jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    _, tm = tstep(tstate, batch)
    assert set(tm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                   rtol=METRIC_RTOL, err_msg=k)
    assert float(tm["num_pos"]) > 0 and float(tm["cen"]) > 0
    params, stats = FF.to_flax(tstate.model)
    want = _numpy_tree(jstate.params)
    _assert_trees_close(stats, _numpy_tree(jstate.batch_stats), SGD_ATOL,
                        "batch_stats")
    if opt == "sgd":
        _assert_trees_close(params, want, SGD_ATOL, "params")
        return
    mu = FF._optax_fields(_numpy_tree(jstate.opt_state))["mu"]
    _assert_trees_close(FF.opt_to_flax(tstate)["mu"], mu, 0.1 * SGD_ATOL,
                        "adam first moment")
    got, want, grad = (dict(_leaves(t)) for t in (params, want, mu))
    for k in want:
        diff = np.abs(got[k] - want[k])
        big = np.abs(grad[k]) / 0.1 > 1e-6
        assert diff[big].max(initial=0.0) <= ADAM_ATOL, k
        assert diff.max() <= 1e-3, k


@pytest.mark.parametrize("main,extra", [
    (t_center.main, ()), (t_center.main, ("--neighborhood",)),
    (t_center_v1.main, ())], ids=["center", "neighborhood", "v1"])
def test_center_clis_train_on_the_cpu(tmp_path, main, extra):
    summary = main(["--device", "cpu", "--backbone", "tiny", "--canvas",
                    "64", "--batch_size", "2", "--synthetic_n", "4",
                    "--max_steps", "2", "--display_step", "1",
                    "--ckpt_dir", str(tmp_path / "ckpt"),
                    "--out_dir", str(tmp_path / "out"), *extra])
    assert summary["final_step"] == 2 and np.isfinite(summary["total"])
    assert CheckpointManager(str(tmp_path / "ckpt")).latest_step() == 2
    # --bf16 is ported: one step in bf16 compute
    summary = main(["--device", "cpu", "--backbone", "tiny", "--canvas",
                    "64", "--batch_size", "2", "--synthetic_n", "4",
                    "--max_steps", "1", "--display_step", "1", "--bf16",
                    "--ckpt_dir", str(tmp_path / "ckpt16"),
                    "--out_dir", str(tmp_path / "out16"), *extra])
    assert summary["final_step"] == 1 and np.isfinite(summary["total"])
