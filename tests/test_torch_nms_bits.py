"""The bitmask decomposition of the port's `nms_sweep` and the launch plans
of both NMS kernels, on the CPU.

`nms_sweep` on the card is two launches: a mask kernel that writes the
pairwise suppression bits and a sweep over them. Their plain model,
`sweep_bits_plain(suppression_bits_plain(...))`, must give the keep mask
of `nms_sweep_plain` and of the JAX package's Pallas kernel (interpret
mode) bit for bit. The plans are pure functions of K and M; every K and M
the wrappers accept must give a launch the card takes.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detectax.ops.pallas.nms_kernel import suppression_mask_pallas
from detectax_torch.kernels import nms as TK

MAX_SMEM = 232448      # bytes of shared memory a block may use on Hopper
MAX_SWEEP_K = 9297     # the widest K the one-block sweep accepted
MAX_DENSE_M = 57984    # the widest M the one-block dense kernel accepted


def make_sorted_candidates(rng, k, nc=6, span=120.0):
    """Crowded corner boxes in score order with exact score ties, exact
    duplicates, degenerate (negative-extent) boxes, and a valid mask that
    drops a tenth of them, the top one included."""
    y = rng.uniform(0, span, size=(k,)).astype(np.float32)
    x = rng.uniform(0, span, size=(k,)).astype(np.float32)
    h = rng.uniform(8, 60, size=(k,)).astype(np.float32)
    w = rng.uniform(8, 60, size=(k,)).astype(np.float32)
    boxes = np.stack([y, x, y + h, x + w], axis=-1)
    scores = np.round(rng.uniform(0.02, 1, size=(k,)) * 16) / 16
    classes = rng.integers(0, nc, size=(k,)).astype(np.int32)
    boxes[k // 2:k // 2 + k // 8] = boxes[:k // 8]
    bad = rng.choice(k, size=max(1, k // 10), replace=False)
    boxes[bad, 2] = boxes[bad, 0] - rng.uniform(0, 20, size=bad.shape)
    boxes[bad[::2], 3] = boxes[bad[::2], 1] - 5.0
    order = np.argsort(-scores, kind="stable")
    valid = rng.uniform(size=(k,)) >= 0.1
    valid[0] = False
    return boxes[order].astype(np.float32), classes[order], valid


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("class_aware", [True, False])
@pytest.mark.parametrize("k", [1, 63, 64, 65, 300, 1000])
def test_bits_then_sweep_equals_plain_and_pallas(rng, k, class_aware):
    boxes, classes, valid = make_sorted_candidates(rng, k)
    cls = _t(classes) if class_aware else None
    bits = TK.suppression_bits_plain(_t(boxes), 0.45, cls)
    assert bits.dtype == torch.int64 and bits.shape == (k, -(-k // 64))
    got = TK.sweep_bits_plain(bits, _t(valid))
    want = TK.nms_sweep_plain(_t(boxes), 0.45, valid=_t(valid), classes=cls)
    pallas = np.asarray(suppression_mask_pallas(
        jnp.asarray(boxes), 0.45, valid=jnp.asarray(valid),
        classes=jnp.asarray(classes) if class_aware else None,
        interpret=True))
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    np.testing.assert_array_equal(got.numpy(), pallas)
    assert not got.numpy()[~valid].any()


def test_bits_are_the_pairwise_rule(rng):
    """Each bit against the rule computed pair by pair in numpy float32:
    j > i, same class, iou(i, j) > thresh with the sweep's IoU order."""
    k = 130
    boxes, classes, _ = make_sorted_candidates(rng, k, nc=3)
    bits = TK.suppression_bits_plain(_t(boxes), 0.5, _t(classes)).numpy()
    area = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    for i in range(k):
        for j in range(k):
            ih = max(np.float32(0), min(boxes[j, 2], boxes[i, 2])
                     - max(boxes[j, 0], boxes[i, 0]))
            iw = max(np.float32(0), min(boxes[j, 3], boxes[i, 3])
                     - max(boxes[j, 1], boxes[i, 1]))
            inter = np.float32(ih * iw)
            den = np.float32(np.float32(area[j] + area[i]) - inter)
            iou = inter / np.float32(den + np.float32(1e-8))
            want = j > i and classes[i] == classes[j] and iou > 0.5
            got = (int(bits[i, j // 64]) >> (j % 64)) & 1
            assert got == want, (i, j)


def test_bits_batched_and_padding_words(rng):
    """A batch equals its images one by one; the bits past K and below the
    diagonal are zero (the sweep never reads them, the mask kernel's
    comparison entry point zeroes them)."""
    cases = [make_sorted_candidates(rng, 100) for _ in range(3)]
    b, c, v = (np.stack(x) for x in zip(*cases))
    bits = TK.suppression_bits_plain(_t(b), 0.5, _t(c))
    assert bits.shape == (3, 100, 2)
    for n in range(3):
        one = TK.suppression_bits_plain(_t(b[n]), 0.5, _t(c[n]))
        assert torch.equal(bits[n], one)
        np.testing.assert_array_equal(
            TK.sweep_bits_plain(one, _t(v[n])).numpy(),
            TK.sweep_bits_plain(bits, _t(v))[n].numpy())
    past_k = (bits[:, :, 1] >> 36) != 0          # columns 100..127
    assert not past_k.any()
    assert (bits[:, 64:, 0] == 0).all()          # rows 64.. below the diagonal
    # the wrapper of the mask kernel on a CPU tensor is the plain version
    assert torch.equal(TK.suppression_bits(_t(b), 0.5, _t(c)), bits)


def test_sweep_plan_covers_every_accepted_k():
    for k in range(1, MAX_SWEEP_K + 1):
        p = TK._sweep_plan(k)
        words = p["words"]
        assert words * 64 >= k > (words - 1) * 64
        assert p["tiles"] == words * (words + 1) // 2
        assert p["mask_threads"] == 128 and p["sweep_threads"] == 32
        assert 1 <= p["stages"] <= 4 and p["stages"] >= min(words, 2)
        assert p["stages"] <= words
        assert p["smem_bytes"] <= MAX_SMEM
        assert p["tile_bytes"] % 16 == 0 and p["tile_bytes"] < 2 ** 20
        assert p["slots"] * 32 >= words and p["slots"] <= 8
        assert p["tier"] == "ring"
    with pytest.raises(ValueError, match="nms_sweep"):
        TK._sweep_plan(0)
    # past the ring's bound the wide tier takes over: no upper bound of
    # the plan's own below what no card's scratch holds
    for k in (14465, 10 ** 6):
        assert TK._sweep_plan(k)["tier"] == "wide"
    assert TK._sweep_plan(14464)["stages"] == 2


def test_dense_plan_covers_every_accepted_m():
    for m in range(1, MAX_DENSE_M + 1):
        p = TK._dense_plan(m)
        assert 1 <= p["cluster"] <= 16
        assert 32 <= p["threads"] <= 512 and p["threads"] % 32 == 0
        assert p["per"] in (1, 2, 4, 8)
        assert p["slice"] == -(-m // p["cluster"])
        assert p["threads"] * p["per"] >= p["slice"]
        assert p["smem_bytes"] <= MAX_SMEM
        assert p["tier"] == "registers"
    with pytest.raises(ValueError, match="dense_nms"):
        TK._dense_plan(0)
    # past the registers' bound the candidates are staged or streamed
    assert TK._dense_plan(65537)["tier"] == "shared"
    assert TK._dense_plan(65536)["cluster"] == 16


@pytest.mark.parametrize("m", [1, 5, 2304, 3069, 20480])
def test_dense_plan_is_the_smallest_holding_shape(m):
    """The plan spends no more than one warp or one doubling of `per`
    beyond what the slice needs."""
    p = TK._dense_plan(m)
    need = -(-p["slice"] // p["per"])
    assert p["threads"] - need < 32
    if p["per"] > 1:
        assert -(-p["slice"] // (p["per"] // 2)) > 512


def test_wrappers_still_reject_bad_shapes():
    with pytest.raises(ValueError, match="boxes must be"):
        TK.suppression_bits(torch.zeros(4, 5), 0.5)
    with pytest.raises(ValueError, match="expected shape"):
        TK.suppression_bits(torch.zeros(2, 8, 4), 0.5,
                            torch.zeros(2, 7, dtype=torch.int32))


@pytest.mark.parametrize("m,tier", [(65536, "registers"), (76725, "shared"),
                                    (81920, "shared"), (144032, "shared"),
                                    (144033, "device"), (327680, "device")])
def test_dense_plan_tiers_above_the_registers(m, tier):
    """RetinaNet at 640 px (76,725 candidates) and CenterNetS8 at 1024 px
    (81,920) are staged in shared memory, 24 bytes a candidate over a
    cluster of 16 blocks; beyond what that holds the slices are read from
    device memory. The register plan up to 65,536 is as it was."""
    p = TK._dense_plan(m)
    assert p["tier"] == tier
    assert p["cluster"] == 16 and p["threads"] == 512
    assert p["slice"] == -(-m // 16)
    assert p["per"] * p["threads"] >= p["slice"]
    assert p["smem_bytes"] <= MAX_SMEM
    if tier == "shared":
        assert p["smem_bytes"] == TK._DENSE_STATIC_SMEM + 24 * p["slice"]
    elif tier == "device":
        assert p["smem_bytes"] == TK._DENSE_STATIC_SMEM
        assert TK._DENSE_STATIC_SMEM + 24 * p["slice"] > MAX_SMEM
    else:
        assert p["per"] == 8


@pytest.mark.parametrize("k,tier", [(14464, "ring"), (16384, "wide"),
                                    (20000, "wide")])
def test_sweep_plan_tiers(k, tier):
    """Up to K = 14,464 two 64-row tiles of the mask fit the ring; above,
    the wide sweep keeps the removed set (8 bytes a word) in shared memory
    and reads the mask, K^2 / 8 bytes an image, from device memory."""
    p = TK._sweep_plan(k)
    words = -(-k // 64)
    assert p["tier"] == tier and p["words"] == words
    assert p["mask_bytes"] == 64 * words * words * 8
    assert p["smem_bytes"] <= MAX_SMEM
    if tier == "ring":
        assert p["stages"] == 2 and p["sweep_threads"] == 32
    else:
        assert p["stages"] == 0 and p["sweep_threads"] == 256
        assert p["smem_bytes"] == 8 * words
        assert 2 * (64 * words * 8 + 8) > MAX_SMEM


def test_big_shapes_on_cpu_are_the_plain_versions():
    """On a CPU tensor the wrappers of both kernels run their plain
    versions at any size: a dense set past the registers' bound."""
    g = torch.Generator().manual_seed(0)
    m = 65600
    yx = torch.rand((1, m, 2), generator=g) * 500
    boxes = torch.cat([yx, yx + 20 + 40 * torch.rand((1, m, 2), generator=g)],
                      dim=-1)
    scores = torch.rand((1, m), generator=g)
    classes = torch.randint(0, 3, (1, m), generator=g, dtype=torch.int32)
    kw = dict(iou_thresh=0.5, score_thresh=0.05, max_outputs=20)
    got = TK.dense_nms(boxes, scores, classes, **kw)
    want = TK.dense_nms_plain(boxes, scores, classes, **kw)
    for key in want:
        assert torch.equal(got[key], want[key])
    assert int(got["num_valid"][0]) == 20
