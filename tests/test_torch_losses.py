"""Losses of the PyTorch port against the JAX package, on the CPU.

The same numpy inputs go through the JAX function and its counterpart in
the port; values and gradients (`jax.grad` against autograd) are compared.

Tolerances: both sides compute float32 but sum in different orders. A sum
over a few thousand terms of order 1 differs by about 1e-6 relative:
rtol 1e-5 on values, atol 1e-5 on per-element gradients (of order 1 or
less). The focal plain versions are also held against the Pallas kernel in
interpret mode at the tolerances of `tests/test_pallas_kernels.py`
(rtol 2e-4 on the sum, atol 1e-5 on dlogits).

One difference from the JAX package is pinned here: at a logit of exactly
0 `jax.grad` of `detectax.ops.losses.focal_loss` is not the derivative of
the loss (JAX differentiates |x| to 1 at 0, so -log σ(x) gets slope -1
instead of -0.5), while the Pallas kernel's closed-form gradient is. The
port's plain version has the true derivative there, like its kernel, so
gradients are compared with `jax.grad` of the XLA focal away from 0 only,
and with the Pallas kernel's gradient everywhere.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detectax.ops import losses as JL
from detectax.ops.pallas.focal import focal_loss_pallas
from detectax.train import losses as JTL
from detectax_torch.kernels import focal as KF
from detectax_torch.ops import losses as TL
from detectax_torch.train import losses as TTL

RTOL, GRAD_ATOL = 1e-5, 1e-5
EXTREME = np.array([-100.0, -40.0, 0.0, 40.0, 100.0], np.float32)


def _focal_inputs(rng, shape=(2, 6, 6, 5), extreme=False):
    labels = (rng.uniform(size=shape) < 0.1).astype(np.float32)
    if extreme:
        logits = rng.choice(EXTREME, size=shape)
    else:
        logits = (4.0 * rng.standard_normal(size=shape)).astype(np.float32)
    weights = (rng.uniform(size=shape[:-1] + (1,)) < 0.7).astype(np.float32)
    return labels, logits, weights


def _torch_value_and_grad(fn, x, *args, **kw):
    xt = torch.from_numpy(x).requires_grad_(True)
    out = fn(xt, *args, **kw)
    out.backward()
    return out.detach().numpy(), xt.grad.numpy()


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("extreme", [False, True])
def test_focal_loss_value_and_grad(rng, weighted, extreme):
    labels, logits, weights = _focal_inputs(rng, extreme=extreme)
    w = weights if weighted else None
    jw = None if w is None else jnp.asarray(w)
    want, want_grad = jax.value_and_grad(
        lambda x: JL.focal_loss(jnp.asarray(labels), x, weights=jw)
    )(jnp.asarray(logits))
    tw = None if w is None else torch.from_numpy(w)
    got, got_grad = _torch_value_and_grad(
        lambda x: TL.focal_loss(torch.from_numpy(labels), x, weights=tw),
        logits)
    assert np.isfinite(got) and np.isfinite(got_grad).all()
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL)
    away = logits != 0.0   # see the module docstring
    assert away.mean() > 0.5
    np.testing.assert_allclose(got_grad[away], np.asarray(want_grad)[away],
                               atol=GRAD_ATOL)


@pytest.mark.parametrize("alpha,gamma", [(0.25, 2.0), (0.5, 1.5), (0.25, 0.0)])
def test_focal_loss_alpha_gamma_are_keywords(rng, alpha, gamma):
    labels, logits, _ = _focal_inputs(rng)
    want = JL.focal_loss(jnp.asarray(labels), jnp.asarray(logits),
                         alpha, gamma)
    got = TL.focal_loss(torch.from_numpy(labels), torch.from_numpy(logits),
                        alpha=alpha, gamma=gamma)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL)
    with pytest.raises(TypeError):
        TL.focal_loss(torch.from_numpy(labels), torch.from_numpy(logits),
                      alpha, gamma)
    with pytest.raises(TypeError):
        KF.focal_loss(torch.from_numpy(labels), torch.from_numpy(logits),
                      torch.from_numpy(labels))


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("extreme", [False, True])
def test_focal_plain_versions_against_pallas_interpret(rng, weighted,
                                                       extreme):
    """`focal_loss_plain` and the closed form `focal_grad_plain` — what the
    CUDA kernel is held against on the card — against the TPU kernel in
    interpret mode and its custom gradient."""
    labels, logits, weights = _focal_inputs(rng, (2, 16, 16, 5), extreme)
    w = weights if weighted else None
    jw = None if w is None else jnp.asarray(w)
    want, want_grad = jax.value_and_grad(
        lambda x: focal_loss_pallas(jnp.asarray(labels), x, jw, 0.25, 2.0,
                                    True)
    )(jnp.asarray(logits))
    tw = None if w is None else torch.from_numpy(w)
    z = torch.from_numpy(labels)
    got, got_grad = _torch_value_and_grad(
        lambda x: KF.focal_loss_plain(z, x, weights=tw), logits)
    np.testing.assert_allclose(got, np.asarray(want), rtol=2e-4)
    np.testing.assert_allclose(got_grad, np.asarray(want_grad), atol=1e-5)
    closed = KF.focal_grad_plain(z, torch.from_numpy(logits), weights=tw)
    assert np.isfinite(closed.numpy()).all()
    np.testing.assert_allclose(closed.numpy(), np.asarray(want_grad),
                               atol=1e-5)
    # on a CPU tensor the wrapper is its plain version
    wrapped, wrapped_grad = _torch_value_and_grad(
        lambda x: KF.focal_loss(z, x, weights=tw), logits)
    assert wrapped == got and np.array_equal(wrapped_grad, got_grad)


def test_focal_grad_is_the_true_derivative_at_zero():
    """At x == 0 neither |x| nor min(x, 0) nor max(x, 0) has a derivative;
    the plain version is written so that autograd's subgradients add up to
    the true slopes of -log σ(x) and -log(1-σ(x)), -0.5 and 0.5 — what the
    closed form, the CUDA kernel and the Pallas kernel's gradient give."""
    x = np.zeros((4,), np.float32)
    z = np.array([0, 1, 0, 1], np.float32)
    _, grad = _torch_value_and_grad(
        lambda t: TL.focal_loss(torch.from_numpy(z), t), x)
    closed = KF.focal_grad_plain(torch.from_numpy(z), torch.from_numpy(x))
    pallas = jax.grad(
        lambda t: focal_loss_pallas(jnp.asarray(z), t, None, 0.25, 2.0, True)
    )(jnp.asarray(x))
    p, ln2 = 0.5, np.log(2.0)
    true = np.where(z > 0, -0.25 * p ** 2 * (2 * p * ln2 + p),
                    0.75 * p ** 2 * (2 * p * ln2 + p)).astype(np.float32)
    np.testing.assert_allclose(grad, true, atol=1e-7)
    np.testing.assert_allclose(closed.numpy(), true, atol=1e-7)
    np.testing.assert_allclose(np.asarray(pallas), true, atol=1e-7)


def test_focal_rows_layout_reads_strided_views_in_place():
    y = torch.arange(2 * 3 * 3 * 9, dtype=torch.float32).reshape(2, 3, 3, 9)
    t, rows, cols, stride = KF._common.as_rows(y[..., 5:])
    assert (rows, cols, stride) == (18, 4, 9)
    assert t.data_ptr() == y[..., 5:].data_ptr()      # no copy
    t, rows, cols, stride = KF._common.as_rows(y[..., 4])     # stride 9 elements
    assert (rows, cols, stride) == (6, 3, 3) and t.is_contiguous()
    t, rows, cols, stride = KF._common.as_rows(y.permute(0, 3, 1, 2))
    assert t.is_contiguous() and (rows, cols, stride) == (54, 3, 3)
    assert KF._common.as_rows(torch.tensor(1.0))[1:] == (1, 1, 1)
    with pytest.raises(ValueError, match="differ in shape"):
        KF._prepare(y, y[..., 5:], None)


@pytest.mark.parametrize("weighted", [False, True])
def test_sigmoid_bce_loss(rng, weighted):
    labels, logits, weights = _focal_inputs(rng, extreme=False)
    logits[0, 0, 0] = EXTREME[EXTREME != 0.0].repeat(2)[:5]
    w = weights if weighted else None
    want, want_grad = jax.value_and_grad(
        lambda x: JL.sigmoid_bce_loss(
            jnp.asarray(labels), x, None if w is None else jnp.asarray(w))
    )(jnp.asarray(logits))
    got, got_grad = _torch_value_and_grad(
        lambda x: TL.sigmoid_bce_loss(
            torch.from_numpy(labels), x,
            weights=None if w is None else torch.from_numpy(w)), logits)
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL)
    np.testing.assert_allclose(got_grad, np.asarray(want_grad),
                               atol=GRAD_ATOL)


@pytest.mark.parametrize("masked", [False, True])
def test_smooth_l1_loss(rng, masked):
    y_true = rng.normal(scale=2.0, size=(2, 6, 6, 4)).astype(np.float32)
    y_pred = rng.normal(scale=2.0, size=(2, 6, 6, 4)).astype(np.float32)
    mask = (rng.uniform(size=(2, 6, 6)) < 0.5).astype(np.float32)
    jm = jnp.asarray(mask) if masked else 1.0
    tm = torch.from_numpy(mask) if masked else 1.0
    want, want_grad = jax.value_and_grad(
        lambda p: JL.smooth_l1_loss(jnp.asarray(y_true), p, jm)
    )(jnp.asarray(y_pred))
    got, got_grad = _torch_value_and_grad(
        lambda p: TL.smooth_l1_loss(torch.from_numpy(y_true), p, tm), y_pred)
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL)
    np.testing.assert_allclose(got_grad, np.asarray(want_grad),
                               atol=GRAD_ATOL)


def test_iou_loss(rng):
    t = rng.uniform(0.1, 4.0, size=(2, 6, 6, 4)).astype(np.float32)
    p = rng.uniform(0.1, 4.0, size=(2, 6, 6, 4)).astype(np.float32)
    mask = (rng.uniform(size=(2, 6, 6)) < 0.5).astype(np.float32)
    want, want_grad = jax.value_and_grad(
        lambda q: JL.iou_loss(jnp.asarray(t), q, jnp.asarray(mask))
    )(jnp.asarray(p))
    got, got_grad = _torch_value_and_grad(
        lambda q: TL.iou_loss(torch.from_numpy(t), q,
                              torch.from_numpy(mask)), p)
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL)
    np.testing.assert_allclose(got_grad, np.asarray(want_grad),
                               atol=GRAD_ATOL)


def test_centerness_from_ltrb(rng):
    ltrb = rng.uniform(0.0, 5.0, size=(3, 7, 4)).astype(np.float32)
    ltrb[0, 0] = 0.0
    want = JL.centerness_from_ltrb(jnp.asarray(ltrb))
    got = TL.centerness_from_ltrb(torch.from_numpy(ltrb))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def _level_maps(rng, nc=5, sizes=(8, 4, 2)):
    """Target and prediction maps of the FCOS layout [reg4, cen, cls]."""
    y_true, y_pred = [], []
    for s in sizes:
        shape = (2, s, s)
        cls = np.zeros(shape + (nc,), np.float32)
        pos = rng.uniform(size=shape) < 0.2
        cls[pos, rng.integers(0, nc, size=int(pos.sum()))] = 1.0
        reg = rng.uniform(0, 4, size=shape + (4,)).astype(np.float32)
        cen = rng.uniform(0, 1, size=shape + (1,)).astype(np.float32)
        y_true.append(np.concatenate([reg, cen, cls], -1)
                      * pos[..., None].astype(np.float32))
        y_pred.append(rng.normal(scale=2.0, size=shape + (5 + nc,))
                      .astype(np.float32) + np.float32(0.5))
    for yp in y_pred:      # IoU loss wants positive distances
        yp[..., :4] = np.abs(yp[..., :4]) + 0.1
    return y_true, y_pred


@pytest.mark.parametrize("reg_type", ["l1", "iou"])
@pytest.mark.parametrize("cen_type", ["l1", "focal"])
def test_fcos_loss_value_and_grads(rng, reg_type, cen_type):
    y_true, y_pred = _level_maps(rng)

    def j_total(preds):
        return JTL.fcos_loss([jnp.asarray(t) for t in y_true], preds,
                             reg_type=reg_type, cen_type=cen_type)["total"]

    want = JTL.fcos_loss([jnp.asarray(t) for t in y_true],
                         [jnp.asarray(p) for p in y_pred],
                         reg_type=reg_type, cen_type=cen_type)
    want_grads = jax.grad(j_total)([jnp.asarray(p) for p in y_pred])
    preds = [torch.from_numpy(p).requires_grad_(True) for p in y_pred]
    got = TTL.fcos_loss([torch.from_numpy(t) for t in y_true], preds,
                        reg_type=reg_type, cen_type=cen_type)
    got["total"].backward()
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k].detach()), float(want[k]),
                                   rtol=RTOL,
                                   err_msg=k)
    for p, g in zip(preds, want_grads):
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(g),
                                   atol=GRAD_ATOL)
    plain = TTL.fcos_loss([torch.from_numpy(t) for t in y_true],
                          [torch.from_numpy(p) for p in y_pred],
                          reg_type=reg_type, cen_type=cen_type,
                          kernels="plain")
    assert float(plain["total"]) == float(got["total"])
    with pytest.raises(ValueError, match="kernels"):
        TTL.fcos_loss([], [], kernels=True)
