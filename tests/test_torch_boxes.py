"""Box geometry of the PyTorch port against the JAX package.

Same numpy inputs through `detectax.ops.boxes` and
`detectax_torch.ops.boxes`. Tolerance: fp32, atol 1e-6 — both sides do the
same elementwise arithmetic in the same order, so only the last bit of a
division or a fused multiply may differ.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detectax.ops import boxes as JB
from detectax_torch.ops import boxes as TB

ATOL = 1e-6


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _corner_boxes(rng, n, span=200.0, degenerate=True):
    lo = rng.uniform(0, span, size=(n, 2)).astype(np.float32)
    wh = rng.uniform(-10 if degenerate else 1, 80, size=(n, 2))
    return np.concatenate([lo, lo + wh.astype(np.float32)], axis=-1)


@pytest.mark.parametrize("stride", [8.0, 128.0])
def test_ltrb_to_corners(rng, stride):
    ltrb = rng.normal(scale=3.0, size=(2, 7, 5, 4)).astype(np.float32)
    want = np.asarray(JB.ltrb_to_corners(jnp.asarray(ltrb), stride))
    got = TB.ltrb_to_corners(_t(ltrb), stride).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL * stride)


@pytest.mark.parametrize("box_scale,stride", [(32.0, 8.0), (384.0, 128.0)])
def test_offset_scale_to_corners(rng, box_scale, stride):
    reg = rng.uniform(0, 1, size=(2, 5, 6, 4)).astype(np.float32)
    want = np.asarray(
        JB.offset_scale_to_corners(jnp.asarray(reg), box_scale, stride))
    got = TB.offset_scale_to_corners(_t(reg), box_scale, stride).numpy()
    # coordinates reach ~1e3: atol scales with the magnitude's ulp
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=ATOL)


@pytest.mark.parametrize("batched", [False, True])
def test_pairwise_iou_corners(rng, batched):
    a = _corner_boxes(rng, 40)
    b = _corner_boxes(rng, 30)
    if batched:
        a = np.stack([a, a[::-1]])
        b = np.stack([b, b[::-1]])
    want = np.asarray(JB.pairwise_iou_corners(jnp.asarray(a), jnp.asarray(b)))
    got = TB.pairwise_iou_corners(_t(a), _t(b)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("offset", [0.5, 0.0])
def test_cell_centers(offset):
    want = np.asarray(JB.cell_centers(5, 7, offset))
    got = TB.cell_centers(5, 7, offset).numpy()
    np.testing.assert_array_equal(got, want)


def test_layout_conversions(rng):
    b = _corner_boxes(rng, 16, degenerate=False)
    for name in ("swap_xy", "corners_to_center", "center_to_corners",
                 "box_area_corners", "flip_boxes_horizontal"):
        want = np.asarray(getattr(JB, name)(jnp.asarray(b)))
        got = getattr(TB, name)(_t(b)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4,
                                   err_msg=name)
    want = np.asarray(JB.elementwise_iou_corners(jnp.asarray(b),
                                                 jnp.asarray(b[::-1])))
    got = TB.elementwise_iou_corners(_t(b), _t(b[::-1].copy())).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    want = np.asarray(JB.pairwise_iou_center(jnp.asarray(b), jnp.asarray(b)))
    got = TB.pairwise_iou_center(_t(b), _t(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
