"""NMS of the PyTorch port against the JAX package, on the CPU.

The same numpy inputs go through `detectax.ops.nms` /
`detectax.ops.pallas.nms_kernel` and their counterparts in
`detectax_torch`. The two Pallas kernels run in interpret mode, as the JAX
package's own tests run them on the CPU; the port's kernel wrappers run
their plain PyTorch versions, because the tensors lie on the CPU.

Tolerances: keep masks, classes, `valid` and `num_valid` must match
exactly. Floats (boxes, scores) are copies of inputs or products with 0/1,
so atol 1e-6 is generous; soft-NMS scores go through `exp`, whose last bit
may differ between the two libraries (atol 1e-6 as well).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detectax.ops import nms as JN
from detectax.ops.pallas.nms_kernel import (
    dense_nms_pallas,
    dense_nms_reference,
    suppression_mask_pallas,
)
from detectax_torch.kernels import nms as TK
from detectax_torch.ops import nms as TN

ATOL = 1e-6
DET_KEYS = ("boxes", "scores", "classes", "valid", "num_valid")


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def make_candidates(rng, m, nc=6, span=120.0, ties=True, degenerate=True):
    """Crowded corner boxes with exact score ties, exact duplicates and
    degenerate (negative-extent) boxes — the cases where tie order, the
    unclamped area and the threshold comparison all matter."""
    y = rng.uniform(0, span, size=(m,)).astype(np.float32)
    x = rng.uniform(0, span, size=(m,)).astype(np.float32)
    h = rng.uniform(8, 60, size=(m,)).astype(np.float32)
    w = rng.uniform(8, 60, size=(m,)).astype(np.float32)
    boxes = np.stack([y, x, y + h, x + w], axis=-1)
    scores = rng.uniform(0.02, 1, size=(m,)).astype(np.float32)
    classes = rng.integers(0, nc, size=(m,)).astype(np.int32)
    if ties:
        scores = np.round(scores * 16) / 16  # many exact ties
        boxes[m // 2:m // 2 + m // 8] = boxes[:m // 8]  # exact duplicates
    if degenerate:
        bad = rng.choice(m, size=max(1, m // 10), replace=False)
        boxes[bad, 2] = boxes[bad, 0] - rng.uniform(0, 20, size=bad.shape)
        boxes[bad[::2], 3] = boxes[bad[::2], 1] - 5.0
    return boxes.astype(np.float32), scores.astype(np.float32), classes


def assert_dets_equal(got, want, atol=ATOL):
    for key in DET_KEYS:
        g = got[key].numpy() if isinstance(got[key], torch.Tensor) \
            else np.asarray(got[key])
        w = np.asarray(want[key])
        assert g.shape == w.shape, (key, g.shape, w.shape)
        if key in ("boxes", "scores"):
            np.testing.assert_allclose(g, w, rtol=0, atol=atol, err_msg=key)
        else:
            np.testing.assert_array_equal(g, w, err_msg=key)


# --------------------------------------------------------------------------
# select_top_k
# --------------------------------------------------------------------------

@pytest.mark.parametrize("class_aware_candidates", [False, True])
@pytest.mark.parametrize("k", [16, 64, 1000])  # 1000 > M*C: padded tail
def test_select_top_k(rng, class_aware_candidates, k):
    m, c = 50, 6
    boxes, _, _ = make_candidates(rng, m)
    probs = rng.uniform(0, 1, size=(m, c)).astype(np.float32)
    probs = np.round(probs * 8) / 8  # ties across boxes and classes
    want = JN.select_top_k(jnp.asarray(boxes), jnp.asarray(probs), k,
                           class_aware_candidates)
    got = TN.select_top_k(_t(boxes), _t(probs), k, class_aware_candidates)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[2].dtype == torch.int32
    # batched call == per-image calls
    gb = TN.select_top_k(_t(np.stack([boxes, boxes[::-1]])),
                         _t(np.stack([probs, probs[::-1]])), k,
                         class_aware_candidates)
    for g, one in zip(gb, got):
        np.testing.assert_array_equal(g[0].numpy(), one.numpy())


# --------------------------------------------------------------------------
# nms: hard / soft x class-aware / agnostic, matrix path
# --------------------------------------------------------------------------

@pytest.mark.parametrize("class_aware", [True, False])
@pytest.mark.parametrize("mode", ["hard", "soft"])
@pytest.mark.parametrize("score_thresh", [0.0, 0.3])
def test_nms_matrix_path(rng, class_aware, mode, score_thresh):
    boxes, scores, classes = make_candidates(rng, 120, degenerate=False)
    kw = dict(iou_thresh=0.5, score_thresh=score_thresh, max_outputs=40,
              class_aware=class_aware, mode=mode, soft_sigma=0.3)
    want = JN.nms(jnp.asarray(boxes), jnp.asarray(scores),
                  jnp.asarray(classes), use_pallas=False, **kw)
    got = TN.nms(_t(boxes), _t(scores), _t(classes), kernels=False, **kw)
    assert_dets_equal(got, want)


def test_nms_degenerate_boxes_matrix_path(rng):
    # the [K, K] path clamps areas at 0 (box_area_corners)
    boxes, scores, classes = make_candidates(rng, 100, degenerate=True)
    kw = dict(iou_thresh=0.4, score_thresh=0.1, max_outputs=100)
    want = JN.nms(jnp.asarray(boxes), jnp.asarray(scores),
                  jnp.asarray(classes), use_pallas=False, **kw)
    got = TN.nms(_t(boxes), _t(scores), _t(classes), kernels=False, **kw)
    assert_dets_equal(got, want)


@pytest.mark.parametrize("class_aware", [True, False])
def test_nms_sweep_path_matches_pallas_path(rng, class_aware):
    """`kernels=True` takes the sweep (its plain version on the CPU), as
    `use_pallas=True` takes the Pallas sweep (interpret mode on the CPU)."""
    boxes, scores, classes = make_candidates(rng, 150)
    kw = dict(iou_thresh=0.5, score_thresh=0.2, max_outputs=50,
              class_aware=class_aware)
    want = JN.nms(jnp.asarray(boxes), jnp.asarray(scores),
                  jnp.asarray(classes), use_pallas=True, **kw)
    got = TN.nms(_t(boxes), _t(scores), _t(classes), kernels=True, **kw)
    assert_dets_equal(got, want)


def test_nms_default_structure_by_k_and_device(rng, monkeypatch):
    """kernels=None on a CPU tensor takes the matrix path whatever K;
    "plain" takes the sweep's plain version from K >= 256."""
    calls = []
    real = TK.nms_sweep_plain
    monkeypatch.setattr(
        TK, "nms_sweep_plain",
        lambda *a, **k: calls.append("plain") or real(*a, **k))
    monkeypatch.setattr(
        TK, "nms_sweep",
        lambda *a, **k: calls.append("wrapper") or real(*a, **k))
    for k in (64, 256):
        boxes, scores, classes = make_candidates(rng, k)
        args = (_t(boxes), _t(scores), _t(classes))
        TN.nms(*args)
        assert calls == []
        TN.nms(*args, kernels="plain")
        assert calls == (["plain"] if k >= 256 else [])
        calls.clear()
        TN.nms(*args, kernels=True)
        assert calls == ["wrapper"]
        calls.clear()
        TN.nms(*args, kernels=False)
        assert calls == []
    with pytest.raises(ValueError, match="kernels"):
        TN.nms(*args, kernels="cuda")


def test_batched_nms_equals_per_image(rng):
    cases = [make_candidates(rng, 90) for _ in range(3)]
    b, s, c = (np.stack(x) for x in zip(*cases))
    kw = dict(iou_thresh=0.5, score_thresh=0.1, max_outputs=30)
    want = JN.batched_nms(jnp.asarray(b), jnp.asarray(s), jnp.asarray(c),
                          use_pallas=False, **kw)
    got = TN.batched_nms(_t(b), _t(s), _t(c), kernels=False, **kw)
    assert_dets_equal(got, want)


def test_compact(rng):
    k, max_outputs = 40, 12
    boxes, scores, classes = make_candidates(rng, k)
    for frac in (0.0, 0.2, 0.9):  # none, fewer than and more than 12 kept
        keep = rng.uniform(size=(k,)) < frac
        want = JN._compact(jnp.asarray(boxes), jnp.asarray(scores),
                           jnp.asarray(classes), jnp.asarray(keep),
                           max_outputs)
        got = TN._compact(_t(boxes)[None], _t(scores)[None],
                          _t(classes)[None], _t(keep)[None], max_outputs)
        assert_dets_equal({k_: v[0] for k_, v in got.items()}, want)


# --------------------------------------------------------------------------
# the kernels' plain versions against the Pallas kernels (interpret mode)
# --------------------------------------------------------------------------

def _sorted_by_score(boxes, scores, classes):
    order = np.argsort(-scores, kind="stable")
    return boxes[order], scores[order], classes[order]


@pytest.mark.parametrize("class_aware", [True, False])
@pytest.mark.parametrize("k", [100, 300])  # 300: not a multiple of 128
def test_nms_sweep_plain_vs_pallas(rng, class_aware, k):
    boxes, scores, classes = _sorted_by_score(*make_candidates(rng, k))
    want = np.asarray(suppression_mask_pallas(
        jnp.asarray(boxes), 0.45,
        classes=jnp.asarray(classes) if class_aware else None,
        interpret=True,
    ))
    got = TK.nms_sweep_plain(
        _t(boxes), 0.45, classes=_t(classes) if class_aware else None)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    # the wrapper on a CPU tensor is the plain version
    np.testing.assert_array_equal(
        TK.nms_sweep(_t(boxes), 0.45,
                     classes=_t(classes) if class_aware else None).numpy(),
        want)


def test_nms_sweep_plain_valid_padding(rng):
    boxes, scores, classes = _sorted_by_score(*make_candidates(rng, 60))
    valid = rng.uniform(size=(60,)) < 0.7
    valid[0] = False  # an invalid top box must not suppress anything
    want = np.asarray(suppression_mask_pallas(
        jnp.asarray(boxes), 0.5, valid=jnp.asarray(valid),
        classes=jnp.asarray(classes), interpret=True))
    got = TK.nms_sweep_plain(_t(boxes), 0.5, valid=_t(valid),
                             classes=_t(classes))
    np.testing.assert_array_equal(got.numpy(), want)
    assert not got.numpy()[~valid].any()


def test_nms_sweep_plain_batched(rng):
    cases = [_sorted_by_score(*make_candidates(rng, 80)) for _ in range(3)]
    b, _, c = (np.stack(x) for x in zip(*cases))
    got = TK.nms_sweep_plain(_t(b), 0.5, classes=_t(c)).numpy()
    for i in range(3):
        want = np.asarray(suppression_mask_pallas(
            jnp.asarray(b[i]), 0.5, classes=jnp.asarray(c[i]),
            interpret=True))
        np.testing.assert_array_equal(got[i], want)


DENSE_CASES = {
    # name: (m, max_outputs, score_thresh, score scale)
    "crowded": (260, 40, 0.1, 1.0),
    "few_survivors": (60, 100, 0.3, 1.0),   # fewer than max_outputs
    "all_below_threshold": (80, 20, 0.5, 0.01),
    "m_not_multiple_of_128": (131, 16, 0.0, 1.0),
}


@pytest.mark.parametrize("class_aware", [True, False])
@pytest.mark.parametrize("case", sorted(DENSE_CASES))
def test_dense_nms_plain_vs_pallas_and_reference(rng, case, class_aware):
    m, max_outputs, score_thresh, scale = DENSE_CASES[case]
    boxes, scores, classes = make_candidates(rng, m)
    scores = (scores * scale).astype(np.float32)
    kw = dict(iou_thresh=0.5, score_thresh=score_thresh,
              max_outputs=max_outputs, class_aware=class_aware)
    jargs = (jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(classes))
    pallas = dense_nms_pallas(*jargs, interpret=True, **kw)
    ref = dense_nms_reference(*jargs, **kw)
    got = TK.dense_nms_plain(_t(boxes), _t(scores), _t(classes), **kw)
    assert_dets_equal(got, pallas)
    assert_dets_equal(got, ref)
    # the wrapper on a CPU tensor is the plain version
    assert_dets_equal(
        TK.dense_nms(_t(boxes), _t(scores), _t(classes), **kw), ref)
    if case == "all_below_threshold":
        assert int(got["num_valid"]) == 0
        assert (got["classes"].numpy() == -1).all()
    if case == "few_survivors":
        assert 0 < int(got["num_valid"]) < max_outputs


def test_dense_nms_plain_without_classes(rng):
    boxes, scores, _ = make_candidates(rng, 90)
    kw = dict(iou_thresh=0.5, score_thresh=0.1, max_outputs=30)
    want = dense_nms_reference(jnp.asarray(boxes), jnp.asarray(scores),
                               None, **kw)
    got = TK.dense_nms_plain(_t(boxes), _t(scores), None, **kw)
    assert_dets_equal(got, want)


@pytest.mark.parametrize("kernels", [None, True, False, "plain"])
def test_dense_nms_op_batched(rng, kernels):
    cases = [make_candidates(rng, 150) for _ in range(3)]
    b, s, c = (np.stack(x) for x in zip(*cases))
    kw = dict(iou_thresh=0.5, score_thresh=0.15, max_outputs=25)
    got = TN.dense_nms(_t(b), _t(s), _t(c), kernels=kernels, **kw)
    for i in range(3):
        want = JN.dense_nms(jnp.asarray(b[i]), jnp.asarray(s[i]),
                            jnp.asarray(c[i]), use_pallas=False, **kw)
        assert_dets_equal({k: v[i] for k, v in got.items()}, want)


def test_dense_equals_two_stage_with_full_top_k(rng):
    """The port keeps the JAX package's equivalence: fused dense NMS ==
    select_top_k(k=M) + sweep, on boxes without degenerate areas."""
    boxes, scores, classes = make_candidates(rng, 200, degenerate=False)
    probs = np.zeros((200, 6), np.float32)
    probs[np.arange(200), classes] = scores
    kw = dict(iou_thresh=0.5, score_thresh=0.1, max_outputs=60)
    two = TN.nms(*TN.select_top_k(_t(boxes), _t(probs), 200), kernels=True,
                 **kw)
    dense = TN.dense_nms(_t(boxes), _t(scores), _t(classes), **kw)
    assert_dets_equal(dense, {k: v.numpy() for k, v in two.items()})


def test_wrappers_reject_bad_shapes():
    with pytest.raises(ValueError, match="boxes must be"):
        TK.nms_sweep(torch.zeros(4, 5), 0.5)
    with pytest.raises(ValueError, match="expected shape"):
        TK.dense_nms(torch.zeros(2, 8, 4), torch.zeros(2, 7))
