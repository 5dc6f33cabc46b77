"""The launch plan of the peak-decode kernel and its banded model, on the CPU.

``csrc/peak.cu`` gives each block one band of rows of one image (and one
tile of cells, or of channels, where a row does not fit), staged with a
halo of one row and one cell into shared memory. `_peak_plan` cuts the map;
`peak_bands_plain` is the plain model of that cut (stage, fill -1 outside
the map, test the 8 staged neighbours). Here:

* the plan covers every shape the kernel takes — the serving shapes, the
  edge shapes `chip_smoke.py` holds the kernel at, a band taller than the
  map, a row too wide for one block, a cell too wide for one block,
  ``(1, 1, 1)`` and a seeded sweep of shapes — within the 227 KB of
  shared memory a Hopper block can have (in fact within 48 KB), with
  enough blocks for 132 SMs where the map has the rows;
* the banded model equals `peak_mask_scores_plain` (and, with the sigmoid,
  `peak_scores_plain`) exactly, and matches the JAX package's
  `peak_mask_scores_reference` exactly (`peak_scores_reference` to 1e-6,
  an ulp of `exp` between the frameworks), NaN and ±inf included.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detectax.ops.pallas.peak_decode import (
    peak_mask_scores_reference,
    peak_scores_reference,
)
from detectax_torch.kernels import _common
from detectax_torch.kernels import peak as KP

SMEM_LIMIT = 232_448     # shared memory a Hopper block can have, bytes

# [B, h, w, C]: the serving shapes, chip_smoke.py's edge shapes (folded
# [H, W, P] as B = 1), and the band edges of the plan
PLAN_SHAPES = [
    (8, 48, 48, 20), (8, 64, 64, 20), (1, 48, 48, 20),
    (1, 3, 3, 2), (1, 1, 7, 3), (1, 7, 1, 3), (1, 48, 48, 160),
    (2, 64, 64, 7), (1, 80, 80, 33), (1, 1, 1, 1),
    (8, 50, 10, 4),        # the last band shorter than the others
    (512, 2, 8, 4),        # the band clamped to the map's 2 rows
    (1, 1, 37, 20),        # one row of one image
    (2, 5, 300, 20),       # a row too wide: two column tiles
    (1, 2, 3, 5000),       # a cell too wide: four channel tiles
    (1, 3, 3, 100_000), (1, 4, 5000, 7), (100_000, 1, 1, 1),
]


def _check_plan(batch, h, w, c):
    plan = KP._peak_plan(h, w, c, batch)
    r, tw, tc = plan["rows"], plan["col_tile"], plan["chan_tile"]
    assert r >= 1 and tw >= 1 and tc >= 1
    assert r <= h and tw <= w and tc <= c
    # the tiles cover each axis once, with no empty tile
    for n, tile, count in ((h, r, plan["bands"]), (w, tw, plan["col_tiles"]),
                           (c, tc, plan["chan_tiles"])):
        assert (count - 1) * tile < n <= count * tile
    assert plan["blocks"] == (batch * plan["bands"] * plan["col_tiles"]
                              * plan["chan_tiles"])
    assert plan["smem_bytes"] == (r + 2) * (tw + 2) * tc * 4
    assert plan["smem_bytes"] <= KP.STAGE_BYTES <= SMEM_LIMIT
    # channels are tiled only when a 3 x 3 of cells would not fit, cells
    # only when three staged rows would not; then enough blocks for the
    # SMs where the map has that many rows and tiles
    assert tc == c or 9 * c * 4 > KP.STAGE_BYTES
    assert tw == w or 3 * (w + 2) * tc * 4 > KP.STAGE_BYTES
    rows_and_tiles = batch * h * plan["col_tiles"] * plan["chan_tiles"]
    assert plan["blocks"] >= min(_common.SMS, rows_and_tiles)
    assert plan["blocks"] < 2 ** 31
    return plan


@pytest.mark.parametrize("shape", PLAN_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_peak_plan_covers_the_shape(shape):
    _check_plan(*shape)


def test_peak_plan_cuts_where_it_must():
    assert KP._peak_plan(1, 1, 1) == {
        "rows": 1, "col_tile": 1, "chan_tile": 1, "bands": 1,
        "col_tiles": 1, "chan_tiles": 1, "blocks": 1, "smem_bytes": 36}
    main = KP._peak_plan(48, 48, 20, 8)            # the serving decode
    assert main["col_tiles"] == main["chan_tiles"] == 1
    assert main["blocks"] >= _common.SMS and main["rows"] > 1
    assert KP._peak_plan(50, 10, 4, 8)["rows"] == 3       # 50 = 16 x 3 + 2
    assert KP._peak_plan(2, 8, 4, 512)["rows"] == 2       # clamped to h
    assert KP._peak_plan(5, 300, 20, 2)["col_tiles"] == 2
    assert KP._peak_plan(48, 48, 160)["col_tiles"] == 3   # folded planes
    assert KP._peak_plan(2, 3, 5000)["chan_tiles"] == 4
    assert KP._peak_plan(2, 3, 5000)["chan_tile"] % 4 == 0


def test_peak_plan_sweep():
    """A seeded sweep of shapes, from single cells to wide rows and cells,
    of fewer than 2**31 elements (the old kernel's limit)."""
    rng = np.random.default_rng(5)
    checked = 0
    while checked < 400:
        dims = np.exp(rng.uniform(0, [7, 7, 9, 12])).astype(np.int64)
        if np.prod(dims.astype(float)) >= 2 ** 31:
            continue
        _check_plan(*(int(v) for v in dims))
        checked += 1


def _scores(rng, shape, kind):
    if kind == "plateaus":
        return (rng.integers(0, 3, size=shape) / 2).astype(np.float32)
    if kind == "below_border":
        return rng.uniform(-3, 0.5, size=shape).astype(np.float32)
    x = rng.uniform(0, 1, size=shape).astype(np.float32)
    if kind == "nonfinite":
        flat = x.reshape(-1)
        flat[::17], flat[5::31], flat[7::29] = np.nan, np.inf, -np.inf
    return x


def _jax_per_image(fn, x):
    """The JAX references take [H, W, C]; apply them image by image."""
    if x.ndim == 3:
        return np.asarray(fn(jnp.asarray(x)))
    return np.stack([np.asarray(fn(jnp.asarray(im))) for im in x])


BAND_SHAPES = [(8, 48, 48, 20), (8, 50, 10, 4), (16, 2, 8, 4),
               (1, 1, 37, 20), (2, 5, 300, 3), (2, 3, 1400), (3, 3, 2),
               (1, 1, 1), (48, 48, 160)]


@pytest.mark.parametrize("shape", BAND_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("kind", ["uniform", "plateaus", "below_border",
                                  "nonfinite"])
def test_banded_model_is_the_plain_version(rng, shape, kind):
    x = _scores(rng, shape, kind)
    t = torch.from_numpy(x)
    got = KP.peak_bands_plain(t)
    want = KP.peak_mask_scores_plain(t)
    assert got.shape == t.shape and got.dtype == torch.float32
    assert torch.equal(got.isnan(), want.isnan())
    assert torch.equal(got.nan_to_num(-7.0), want.nan_to_num(-7.0))
    ref = _jax_per_image(peak_mask_scores_reference, x)
    np.testing.assert_array_equal(got.numpy(), ref)
    # with the sigmoid (the staged elements go through it once)
    got_s = KP.peak_bands_plain(t, apply_sigmoid=True)
    want_s = KP.peak_scores_plain(t)
    assert torch.equal(got_s.nan_to_num(-7.0), want_s.nan_to_num(-7.0))
    # jax.nn.sigmoid and 1/(1+exp(-x)) may differ by an ulp, which can
    # flip a keep/zero decision between near-equal neighbours: against
    # JAX only the small maps, where no such pair is drawn
    if kind != "nonfinite" and x.size <= 20_000:
        np.testing.assert_allclose(
            got_s.numpy(), _jax_per_image(peak_scores_reference, x),
            atol=1e-6)
