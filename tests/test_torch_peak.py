"""Plain versions of the peak-decode kernel against the JAX package.

`detectax_torch.kernels.peak.peak_mask_scores_plain` does comparisons and a
select only, so it is held exactly (max abs difference 0, same zero
pattern) against `peak_mask_scores_pallas` — run in interpret mode, as the
JAX package's own tests run it on the CPU — and `peak_mask_scores_reference`.
`peak_scores_plain` computes a sigmoid first and is held to 1e-6 (one ulp
of `exp` between the two frameworks). On the CPU the wrappers run the plain
versions, so these tests reach them through the public names too.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detectax.ops.pallas.peak_decode import (
    peak_mask_scores_pallas,
    peak_mask_scores_reference,
    peak_scores_pallas,
    peak_scores_reference,
)
from detectax_torch.kernels import _common
from detectax_torch.kernels import peak as KP

SHAPES = [(3, 3, 2), (1, 7, 3), (7, 1, 3), (1, 1, 4), (12, 10, 5),
          (48, 48, 4), (33, 17, 1)]


def _scores(rng, shape, kind):
    if kind == "uniform":
        return rng.uniform(0, 1, size=shape).astype(np.float32)
    if kind == "plateaus":          # few distinct values: flat runs and ties
        return (rng.integers(0, 3, size=shape) / 2).astype(np.float32)
    if kind == "zeros":
        return np.zeros(shape, np.float32)
    if kind == "below_border":      # values under the -1 border fill
        return rng.uniform(-3, 0.5, size=shape).astype(np.float32)
    raise AssertionError(kind)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize(
    "kind", ["uniform", "plateaus", "zeros", "below_border"])
def test_peak_mask_scores_plain_is_exact(rng, shape, kind):
    x = _scores(rng, shape, kind)
    want = np.asarray(peak_mask_scores_pallas(jnp.asarray(x)))
    ref = np.asarray(peak_mask_scores_reference(jnp.asarray(x)))
    np.testing.assert_array_equal(want, ref)
    got = KP.peak_mask_scores_plain(torch.from_numpy(x))
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    np.testing.assert_array_equal(got.numpy(), want)
    # the wrapper on a CPU tensor is the plain version and launches nothing
    before = _common.launch_counts()
    np.testing.assert_array_equal(
        KP.peak_mask_scores(torch.from_numpy(x)).numpy(), want)
    assert _common.launch_counts() == before
    if kind == "zeros":
        assert not got.any()
    if kind == "plateaus" and min(shape[:2]) >= 3:
        # every cell of a flat top is kept: more survivors than strict
        # maxima could give
        assert (got.numpy() == 1.0).sum() > 0


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_peak_scores_plain_matches_jax(rng, shape):
    x = rng.normal(scale=2.0, size=shape).astype(np.float32)
    got = KP.peak_scores_plain(torch.from_numpy(x)).numpy()
    for want in (peak_scores_pallas(jnp.asarray(x)),
                 peak_scores_reference(jnp.asarray(x))):
        np.testing.assert_allclose(got, np.asarray(want), atol=1e-6)
    np.testing.assert_array_equal(KP.peak_scores(torch.from_numpy(x)).numpy(),
                                  got)


def test_peak_scores_saturated_plateau(rng):
    """Logits above 17 all round to p = 1.0 in float32: a plateau that the
    >= test keeps whole."""
    x = rng.uniform(18.0, 30.0, size=(6, 6, 2)).astype(np.float32)
    x[0, :, 0] = -5.0
    got = KP.peak_scores_plain(torch.from_numpy(x)).numpy()
    want = np.asarray(peak_scores_pallas(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, atol=1e-6)
    assert (got[1:, :, 0] == 1.0).all() and (got[0, :, 0] == 0.0).all()
    assert (got[..., 1] == 1.0).all()


def test_border_fill_is_minus_one_not_minus_infinity():
    x = np.full((4, 4, 1), -2.0, np.float32)   # flat, all below the fill
    got = KP.peak_mask_scores_plain(torch.from_numpy(x)).numpy()[..., 0]
    want = np.asarray(peak_mask_scores_reference(jnp.asarray(x)))[..., 0]
    np.testing.assert_array_equal(got, want)
    # interior cells tie with their neighbours and stay; border cells lose
    # to the -1 outside (a -inf fill, as max_pool2d pads, would keep them)
    assert (got[1:3, 1:3] == -2.0).all()
    border = np.ones((4, 4), bool)
    border[1:3, 1:3] = False
    assert (got[border] == 0.0).all()


def test_non_finite_inputs_follow_the_maximum():
    """NaN propagates through the neighbourhood maximum on both sides, so
    its whole 3x3 neighbourhood is 0; +-inf compare as numbers."""
    x = np.linspace(0.1, 0.9, 25, dtype=np.float32).reshape(5, 5, 1).copy()
    x = np.concatenate([x, x, x], axis=-1)
    x[2, 2, 0] = np.nan
    x[2, 2, 1] = np.inf
    x[4, 4, 2] = -np.inf
    got = KP.peak_mask_scores_plain(torch.from_numpy(x)).numpy()
    want = np.asarray(peak_mask_scores_reference(jnp.asarray(x)))
    np.testing.assert_array_equal(got, want)
    assert (got[1:4, 1:4, 0] == 0).all()
    assert got[2, 2, 1] == np.inf and got[4, 4, 2] == 0.0


def test_strided_view_and_batched_layout(rng):
    """`probs[..., 1:]` is a view with a wider cell stride; [B, h, w, C]
    gives what the folded [h, w, B*C] layout of the JAX decode gives."""
    b, h, w, c = 3, 9, 11, 4
    wide = rng.uniform(0, 1, size=(b, h, w, c + 1)).astype(np.float32)
    view = torch.from_numpy(wide)[..., 1:]
    assert not view.is_contiguous()
    got = KP.peak_mask_scores(view)
    assert got.is_contiguous() and tuple(got.shape) == (b, h, w, c)
    folded = np.transpose(wide[..., 1:], (1, 2, 0, 3)).reshape(h, w, b * c)
    want = np.asarray(peak_mask_scores_pallas(jnp.asarray(folded)))
    want = np.transpose(want.reshape(h, w, b, c), (2, 0, 1, 3))
    np.testing.assert_array_equal(got.numpy(), want)
    # and the folded layout itself, as a three-dimensional map
    np.testing.assert_array_equal(
        KP.peak_mask_scores(torch.from_numpy(folded)).numpy()
        .reshape(h, w, b, c).transpose(2, 0, 1, 3), want)


def test_cell_layout_handed_to_the_kernel(rng):
    """The Python side of the launch: which layouts are read in place and
    at which cell stride (`as_rows`, shared with the focal kernel)."""
    _as_rows = _common.as_rows

    wide = torch.from_numpy(
        rng.uniform(size=(2, 5, 6, 8)).astype(np.float32))
    t, cells, cols, stride = _as_rows(wide[..., 1:])
    assert t.data_ptr() == wide[..., 1:].data_ptr()      # no copy
    assert (cells, cols, stride) == (60, 7, 8)
    t, cells, cols, stride = _as_rows(wide.permute(0, 2, 1, 3))
    assert t.is_contiguous() and (cells, cols, stride) == (60, 8, 8)
    with pytest.raises(ValueError, match="folded planes"):
        KP.peak_mask_scores(torch.zeros(4, 4))
