"""FCOS label assignment of the PyTorch port against the JAX package.

The same padded numpy boxes go through `detectax.ops.assign.fcos_assign`
(mapped over the batch with `jax.vmap`, as the train step does) and the
port's batched `fcos_assign`. The class one-hots and the ownership mask
must be **equal**; ltrb and centerness agree to atol 1e-6 (the same
float32 operations in the same order; XLA may fuse a multiply-add).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detectax.ops import assign as JA
from detectax_torch.ops import assign as TA

NC = 5
ATOL = 1e-6


def _random_boxes(rng, batch, n, lo=0.02, hi=0.9):
    b = np.zeros((batch, n, 4), np.float32)
    b[..., 0] = rng.uniform(0.05, 0.95, (batch, n))
    b[..., 1] = rng.uniform(0.05, 0.95, (batch, n))
    b[..., 2] = rng.uniform(lo, hi, (batch, n))
    b[..., 3] = rng.uniform(lo, hi, (batch, n))
    labels = rng.integers(0, NC, (batch, n)).astype(np.int32)
    valid = rng.uniform(size=(batch, n)) < 0.8
    return b, labels, valid


def _edge_boxes(rng, batch, n):
    """Boxes that hang over the image edge and boxes snapped to cell
    boundaries (corner coordinates that are whole multiples of a stride)."""
    b, labels, valid = _random_boxes(rng, batch, n)
    b[:, 0] = (0.02, 0.5, 0.3, 0.6)      # over the top edge
    b[:, 1] = (0.5, 0.99, 0.4, 0.3)      # over the right edge
    b[:, 2] = (0.5, 0.5, 1.2, 1.2)       # larger than the image
    b[:, 3] = (0.5, 0.5, 0.5, 0.25)      # corners on cell boundaries
    b[:, 4] = (0.25, 0.75, 0.25, 0.125)
    valid[:, :5] = True
    return b, labels, valid


def _degenerate_boxes(rng, batch, n):
    """Zero-size and sub-cell boxes: the covered cell range is empty and
    the centre-cell branch takes over."""
    b, labels, valid = _random_boxes(rng, batch, n)
    b[:, 0, 2:] = 0.0                       # a point
    b[:, 1, 2:] = (0.001, 0.3)              # no row covered
    b[:, 2, 2:] = (0.3, 0.001)              # no column covered
    b[:, 3] = (0.0, 0.0, 0.01, 0.01)        # at the origin
    b[:, 4] = (1.0, 1.0, 0.02, 0.02)        # at the far corner
    b[:, 5, 2:] = (0.04, 0.04)              # inside one stride-8 cell
    valid[:, :6] = True
    return b, labels, valid


def _tied_boxes(rng, batch, n):
    """Boxes of exactly equal area that overlap, with different labels:
    the lower index must own the shared cells."""
    b, labels, valid = _random_boxes(rng, batch, n)
    b[:, 0] = (0.5, 0.5, 0.5, 0.25)
    b[:, 1] = (0.5, 0.5, 0.25, 0.5)      # same area, rotated
    b[:, 2] = (0.5, 0.5, 0.5, 0.25)      # exact duplicate of 0
    b[:, 3] = (0.45, 0.55, 0.25, 0.5)
    labels[:, :4] = (0, 1, 2, 3)
    valid[:, :4] = True
    return b, labels, valid


def _all_invalid(rng, batch, n):
    b, labels, _ = _random_boxes(rng, batch, n)
    return b, labels, np.zeros((batch, n), bool)


CASES = {
    "random": _random_boxes,
    "edge": _edge_boxes,
    "degenerate": _degenerate_boxes,
    "ties": _tied_boxes,
    "all_invalid": _all_invalid,
}


def _both(boxes, labels, valid, **kw):
    j_fn = jax.vmap(functools.partial(JA.fcos_assign, num_classes=NC, **kw))
    want, want_n = j_fn(jnp.asarray(boxes), jnp.asarray(labels),
                        jnp.asarray(valid))
    got, got_n = TA.fcos_assign(
        torch.from_numpy(boxes), torch.from_numpy(labels),
        torch.from_numpy(valid), num_classes=NC, **kw)
    return ([np.asarray(w) for w in want], np.asarray(want_n),
            [g.numpy() for g in got], got_n.numpy())


def _compare(want, want_n, got, got_n):
    assert len(got) == len(want) == 5
    np.testing.assert_array_equal(got_n, want_n)
    for lvl, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape and g.dtype == w.dtype, lvl
        np.testing.assert_array_equal(g[..., 5:], w[..., 5:],
                                      err_msg=f"class one-hots, level {lvl}")
        has_g = g[..., 5:].max(-1) > 0
        has_w = w[..., 5:].max(-1) > 0
        np.testing.assert_array_equal(has_g, has_w)
        np.testing.assert_allclose(g[..., :5], w[..., :5], atol=ATOL,
                                   err_msg=f"ltrb/centerness, level {lvl}")
        # centerness forced to exactly 1 at an owner's centre cell
        np.testing.assert_array_equal(g[..., 4] == 1.0, w[..., 4] == 1.0)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("seed", [0, 1])
def test_fcos_assign_matches_jax(case, seed):
    rng = np.random.default_rng(seed)
    boxes, labels, valid = CASES[case](rng, 3, 12)
    want, want_n, got, got_n = _both(boxes, labels, valid,
                                     img_dim=(128, 128))
    _compare(want, want_n, got, got_n)
    if case == "all_invalid":
        assert all(not g.any() for g in got)
    else:
        assert any(g[..., 5:].any() for g in got)


@pytest.mark.parametrize("img_dim,img_pad", [
    ((100, 120), (128, 128)),
    ((96, 128), (128, 256)),
    ((384, 384), None),
])
def test_fcos_assign_content_smaller_than_canvas(img_dim, img_pad):
    rng = np.random.default_rng(3)
    boxes, labels, valid = _edge_boxes(rng, 2, 10)
    want, want_n, got, got_n = _both(boxes, labels, valid, img_dim=img_dim,
                                     img_pad=img_pad)
    _compare(want, want_n, got, got_n)
    pad = img_pad or img_dim
    assert got[0].shape == (2, pad[0] // 8, pad[1] // 8, 5 + NC)


def test_equal_area_tie_goes_to_the_lower_index():
    boxes = np.zeros((1, 3, 4), np.float32)
    boxes[0, 0] = (0.5, 0.5, 0.5, 0.25)
    boxes[0, 1] = (0.5, 0.5, 0.25, 0.5)
    boxes[0, 2] = (0.5, 0.5, 0.5, 0.25)
    labels = np.array([[2, 1, 0]], np.int32)
    valid = np.ones((1, 3), bool)
    outs, _ = TA.fcos_assign(
        torch.from_numpy(boxes), torch.from_numpy(labels),
        torch.from_numpy(valid), img_dim=(128, 128), num_classes=NC)
    lvl = outs[2].numpy()[0]            # max side 64 px -> level 2, 4x4
    shared = lvl[2, 2, 5:]              # the one cell all three cover
    assert shared.argmax() == 2 and shared.sum() == 1.0


def test_first_argmax_takes_the_first_of_equal_maxima():
    x = torch.tensor([[1.0, 3.0, 3.0, 2.0], [5.0, 5.0, 5.0, 5.0],
                      [-1e30, -1e30, -1e30, -1e30]])
    assert TA._first_argmax(x).tolist() == [1, 0, 0]
    assert TA._first_argmax(x).tolist() == np.asarray(
        jnp.argmax(jnp.asarray(x.numpy()), axis=-1)).tolist()


def test_trunc_int_truncates_toward_zero():
    x = np.array([-1.7, -0.2, 0.0, 0.9, 2.5], np.float32)
    got = TA._trunc_int(torch.from_numpy(x))
    assert got.dtype == torch.int32
    assert got.tolist() == np.asarray(JA._trunc_int(jnp.asarray(x))).tolist()
    assert got.tolist() == [-1, 0, 0, 0, 2]


def test_select_rows_keeps_dtypes_and_values():
    owner = torch.tensor([[[0, 2], [1, 1]]])
    f = torch.tensor([[409601.0, -3.5, 7.25]])
    i = torch.tensor([[5, -2, 9]], dtype=torch.int32)
    b = torch.tensor([[True, False, True]])
    m = torch.arange(6, dtype=torch.float32).reshape(1, 3, 2)
    sf, si, sb, sm = TA._select_rows(owner, f, i, b, m)
    assert sf.tolist() == [[[409601.0, 7.25], [-3.5, -3.5]]]
    assert si.dtype == torch.int32 and si.tolist() == [[[5, 9], [-2, -2]]]
    assert sb.dtype == torch.bool
    assert sb.tolist() == [[[True, True], [False, False]]]
    assert sm.shape == (1, 2, 2, 2) and sm[0, 0, 1].tolist() == [4.0, 5.0]


def test_bin_bounds_and_input_check():
    assert TA._bin_bounds(TA.FCOS_BIN_EDGES, 5) == \
        JA._bin_bounds(JA.FCOS_BIN_EDGES, 5)
    with pytest.raises(ValueError, match="padded batch"):
        TA.fcos_assign(torch.zeros(4, 4), torch.zeros(4), torch.zeros(4),
                       img_dim=(64, 64), num_classes=NC)
