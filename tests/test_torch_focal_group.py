"""The grouped focal loss of the port against the JAX package, on the CPU.

`focal_loss_group` takes several (labels, logits[, weights]) segments and
returns one sum a segment; on CUDA tensors it is one forward and one
backward launch of ``csrc/focal.cu`` for all of them, on CPU tensors its
plain version `focal_loss_group_plain`. Here:

* the plain version against the TPU kernel `focal_loss_pallas` in
  interpret mode, segment by segment, value and gradient, at the
  tolerances of `tests/test_pallas_kernels.py` (rtol 2e-4 on a sum, atol
  1e-5 on dlogits);
* `fcos_loss`, which hands all its focal terms to one grouped call,
  against the JAX package's `fcos_loss` (value and `jax.grad`) at 2e-6 —
  both sides sum the same float32 terms in different orders over a few
  thousand elements;
* the launch plan `_focal_plan` and the segment table: pure functions of
  the segments' sizes that cover every element exactly once, in an order
  that does not change between calls;
* the ``torch.library`` operators ``detectax_torch::focal_group`` and
  ``focal_group_bwd`` (the wrappers' route on CUDA): `opcheck` on strided
  CPU segments with weight masks, the CPU forward and registered backward
  against the Pallas kernel in interpret mode and against `jax.grad` away
  from logit 0, and `torch.export` of `fcos_loss` holding one call.
"""
import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detectax.ops.pallas.focal import focal_loss_pallas
from detectax.train import losses as JTL
from detectax_torch.kernels import _common
from detectax_torch.kernels import focal as KF
from detectax_torch.train import losses as TTL

EXTREME = np.array([-100.0, -40.0, 0.0, 40.0, 100.0], np.float32)
LEVELS = (8, 4, 2, 1)          # h = w of four small levels


def _level_maps(rng, *, extreme=False, nc=5, batch=2):
    """[batch, h, h, 5 + nc] label and logit maps a level (numpy)."""
    maps = []
    for hw in LEVELS:
        shape = (batch, hw, hw, 5 + nc)
        labels = (rng.uniform(size=shape) < 0.2).astype(np.float32)
        if extreme:
            logits = rng.choice(EXTREME, size=shape)
        else:
            logits = (4.0 * rng.standard_normal(size=shape)).astype(np.float32)
        maps.append((labels, logits))
    return maps


def _segments(rng, case):
    """numpy segments (labels, logits, weights or None) of one call."""
    maps = _level_maps(rng, extreme=case == "extreme")
    segs = [(z[..., 5:], x[..., 5:], None) for z, x in maps]
    if case == "with_centerness":
        segs += [(z[..., 4], x[..., 4], None) for z, x in maps]
    if case == "weighted":
        segs = [(z, x, (rng.uniform(size=x.shape[:-1] + (1,)) < 0.7)
                 .astype(np.float32) if i % 2 == 0 else None)
                for i, (z, x, _) in enumerate(segs)]
    if case == "one_element":
        segs = [(np.ones((1,), np.float32), np.full((1,), -1.5, np.float32),
                 None)]
    return segs


@pytest.mark.parametrize(
    "case", ["levels", "with_centerness", "weighted", "extreme",
             "one_element"])
def test_group_plain_against_pallas_interpret(rng, case):
    """Each segment's sum and dlogits from the grouped plain version (what
    the CUDA kernel is held against on the card) equal the TPU kernel's,
    run in interpret mode segment by segment."""
    segs = _segments(rng, case)
    xs = [torch.from_numpy(np.ascontiguousarray(x)).requires_grad_(True)
          for _, x, _ in segs]
    tsegs = [(torch.from_numpy(np.ascontiguousarray(z)), x,
              None if w is None else torch.from_numpy(w))
             for (z, _, w), x in zip(segs, xs)]
    got = KF.focal_loss_group_plain(tsegs)
    assert got.shape == (len(segs),) and got.dtype == torch.float32
    upstream = torch.linspace(0.5, 2.0, len(segs))
    grads = torch.autograd.grad(got, xs, upstream)
    for i, (z, x, w) in enumerate(segs):
        jw = None if w is None else jnp.asarray(w)
        want, want_grad = jax.value_and_grad(
            lambda t: focal_loss_pallas(jnp.asarray(z), t, jw, 0.25, 2.0,
                                        True))(jnp.asarray(x))
        np.testing.assert_allclose(float(got[i]), float(want), rtol=2e-4)
        np.testing.assert_allclose(
            grads[i].numpy(), float(upstream[i]) * np.asarray(want_grad),
            atol=1e-5)
        # and the closed form of the backward kernel
        closed = KF.focal_grad_plain(tsegs[i][0], xs[i].detach(),
                                     weights=tsegs[i][2])
        np.testing.assert_allclose(closed.numpy(), np.asarray(want_grad),
                                   atol=1e-5)


def test_group_wrapper_on_cpu_is_the_plain_version(rng):
    """On CPU tensors the wrapper runs the plain version bit for bit and
    launches nothing; a segment of no rows sums to 0."""
    segs = [(torch.from_numpy(np.ascontiguousarray(z)),
             torch.from_numpy(np.ascontiguousarray(x)), w)
            for z, x, w in _segments(rng, "weighted")]
    segs = [(z, x, None if w is None else torch.from_numpy(w))
            for z, x, w in segs]
    segs.insert(1, (torch.zeros((0, 5)), torch.zeros((0, 5))))
    before = _common.launch_counts()
    got = KF.focal_loss_group(segs)
    assert _common.launch_counts() == before
    assert torch.equal(got, KF.focal_loss_group_plain(segs))
    assert float(got[1]) == 0.0
    for i, seg in enumerate(segs):
        z, x = seg[0], seg[1]
        w = seg[2] if len(seg) == 3 else None
        assert float(got[i]) == float(KF.focal_loss(z, x, weights=w))


def test_group_rejects_bad_segments():
    z = torch.zeros((2, 3))
    with pytest.raises(ValueError, match="at least one segment"):
        KF.focal_loss_group([])
    with pytest.raises(ValueError, match="a segment is"):
        KF.focal_loss_group([(z,)])
    with pytest.raises(ValueError, match="differ in shape"):
        KF._prepare(z, torch.zeros((2, 4)), None)


def _jax_fcos(maps, cen_type):
    y_true = [jnp.asarray(z) for z, _ in maps]

    def total(preds):
        return JTL.fcos_loss(y_true, preds, cen_type=cen_type)["total"]

    preds = [jnp.asarray(x) for _, x in maps]
    return (JTL.fcos_loss(y_true, preds, cen_type=cen_type),
            jax.grad(total)(preds))


@pytest.mark.parametrize("cen_type", ["l1", "focal"])
@pytest.mark.parametrize("extreme", [False, True])
def test_fcos_loss_grouped_against_jax(rng, cen_type, extreme):
    """`fcos_loss` — the class terms (and with cen_type="focal" the
    centerness terms) of all levels in one grouped call — against the JAX
    package's per-level loop, value and gradient, at 2e-6."""
    maps = _level_maps(rng, extreme=extreme)
    for z, x in maps:                   # valid boxes for the regression
        x[..., :4] = np.abs(x[..., :4]) + 0.1
        z[..., :4] = np.abs(z[..., :4]) + 0.1
    want, want_grads = _jax_fcos(maps, cen_type)
    preds = [torch.from_numpy(x).requires_grad_(True) for _, x in maps]
    got = TTL.fcos_loss([torch.from_numpy(z) for z, _ in maps], preds,
                        cen_type=cen_type)
    got["total"].backward()
    for k in want:
        np.testing.assert_allclose(float(got[k].detach()), float(want[k]),
                                   rtol=2e-6, err_msg=k)
    away = [x != 0.0 for _, x in maps]  # jax.grad's slope at 0 differs
    for p, g, a in zip(preds, want_grads, away):
        np.testing.assert_allclose(p.grad.numpy()[a], np.asarray(g)[a],
                                   atol=2e-6)


@pytest.mark.parametrize("cen_type", ["l1", "focal"])
def test_fcos_loss_adds_the_group_in_the_loop_order(rng, cen_type):
    """The grouped sums are added level by level as the per-level loop
    adds them (0.0 + l0 + l1 + ...), so the value is the loop's to the
    bit, and the plain path is the same."""
    maps = _level_maps(rng)
    yt = [torch.from_numpy(z) for z, _ in maps]
    yp = [torch.from_numpy(x) for _, x in maps]
    got = TTL.fcos_loss(yt, yp, cen_type=cen_type)
    cls = 0.0
    for t, p in zip(yt, yp):
        cls = cls + KF.focal_loss_plain(t[..., 5:], p[..., 5:])
    assert float(got["cls"]) == float(cls)
    if cen_type == "focal":
        cen = 0.0
        for t, p in zip(yt, yp):
            cen = cen + KF.focal_loss_plain(t[..., 4], p[..., 4])
        assert float(got["cen"]) == float(cen)
    plain = TTL.fcos_loss(yt, yp, cen_type=cen_type, kernels="plain")
    for k in got:
        assert float(got[k]) == float(plain[k])


# ---- the launch plan and the segment table --------------------------------

FCOS_384 = [(16 * hw * hw, 20) for hw in (48, 24, 12, 6, 3)]
PLAN_CASES = {
    "fcos_levels": FCOS_384,
    "fcos_with_centerness": FCOS_384 + [(16 * hw, hw)
                                        for hw in (48, 24, 12, 6, 3)],
    "centernet": [(16 * 48 * 48, 21)],
    "scale_slots": [(16 * 64 * 64 * 5, 20)],
    "one_element": [(1, 1)],
    "with_empty": [(0, 20), (37, 5), (0, 0), (3, 1000), (1, 7), (0, 3)],
    "wide_rows": [(5, 3000), (2, 257), (1, 256)],
    "many_small": [(r, c) for r, c in zip(range(1, 33), range(32, 0, -1))],
}


def _walk(rows, cols, vec, r0, r1):
    """The elements block rows [r0, r1) of a segment adds, thread by
    thread, in each thread's order — the loops of csrc/focal.cu::walk."""
    unit = 4 if vec else 1
    units = cols // unit
    per_group = 1 if units >= KF.THREADS else KF.THREADS // units
    order = []
    for t in range(KF.THREADS):
        dr, c0 = divmod(t, units)
        if dr >= per_group:
            continue
        mine = []
        for c in range(c0, units, KF.THREADS):
            for row in range(r0 + dr, r1, per_group):
                mine += [row * cols + c * unit + e for e in range(unit)]
        order.append(mine)
    return order


@pytest.mark.parametrize("name", sorted(PLAN_CASES))
def test_focal_plan_covers_every_element_once(name):
    sizes = PLAN_CASES[name]
    plan = KF._focal_plan(sizes)
    assert plan == KF._focal_plan(list(sizes))   # a function of the sizes
    assert len(plan) == len(sizes)
    grid = sum(blocks for _, blocks, _ in plan)
    assert grid <= _common.SMS * KF.BLOCKS_PER_SM + len(sizes)
    nonempty = [r * c > 0 for r, c in sizes]
    assert grid >= sum(nonempty)
    first = 0
    for (rows, cols), (start, blocks, rpb) in zip(sizes, plan):
        assert start == first            # segments follow each other
        first += blocks
        if rows * cols == 0:
            assert blocks == 0
            continue
        assert blocks >= 1 and rpb >= 1
        assert (blocks - 1) * rpb < rows <= blocks * rpb   # no empty block
        assert blocks <= -(-rows * cols // KF.THREADS)
        for vec in ([False, True] if cols % 4 == 0 else [False]):
            if rows * cols > 200_000:    # the walk of one block suffices
                spans = [(0, min(rpb, rows))]
            else:
                spans = [(j * rpb, min((j + 1) * rpb, rows))
                         for j in range(blocks)]
            seen = np.zeros(rows * cols, np.int64)
            for r0, r1 in spans:
                for mine in _walk(rows, cols, vec, r0, r1):
                    np.add.at(seen, mine, 1)
            covered = seen[spans[0][0] * cols:spans[-1][1] * cols]
            assert (covered == 1).all()
            assert seen.sum() == covered.size


def test_focal_plan_of_the_fcos_step():
    """The five class maps of an FCOS step at 384 px, batch 16: one grid of
    about 4 blocks an SM, shared by element count."""
    plan = KF._focal_plan(FCOS_384)
    blocks = [b for _, b, _ in plan]
    assert _common.SMS * KF.BLOCKS_PER_SM <= sum(blocks) <= \
        _common.SMS * KF.BLOCKS_PER_SM + 5
    assert blocks == sorted(blocks, reverse=True) and blocks[-1] >= 1
    total = sum(r * c for r, c in FCOS_384)
    assert total == 982_080
    for (rows, cols), b in zip(FCOS_384, blocks):
        share = rows * cols / total
        assert abs(b / sum(blocks) - share) < 0.02


def test_segment_table_reads_16_bytes_where_it_can():
    """The table handed to the C side: S8's class channels 4: of 24 are
    walked four floats a thread and read 16 bytes at a time; FCOS's 5: of
    25 are walked four floats a thread too (20 columns) but read 4 bytes
    at a time (a row stride of 25 floats); CenterNet's 5: of 26 (21
    columns) one float a thread; a weight mask is broadcast and made
    contiguous."""
    def view(shape, lead):
        wide = torch.zeros(shape[:-1] + (lead + shape[-1],))
        return wide[..., lead:]

    cases = [(view((2, 4, 4, 5, 20), 4), 1), (view((2, 4, 4, 20), 5), 2),
             (view((2, 4, 4, 21), 5), 0), (torch.zeros((3, 8)), 1),
             (torch.zeros((3, 6)), 0)]
    segs = [KF._prepare(x, x, None) for x, _ in cases]
    desc, ptrs, blocks = KF._table(segs)
    assert isinstance(desc, ctypes.Array) and len(desc) == 8 * len(segs)
    assert len(ptrs) == 4 * len(segs)
    plan = KF._focal_plan([(s.rows, s.cols) for s in segs])
    assert blocks == sum(b for _, b, _ in plan)
    for i, ((x, vec), seg) in enumerate(zip(cases, segs)):
        row = list(desc[8 * i:8 * i + 8])
        assert row[:4] == [seg.z_stride, seg.x_stride, seg.rows, seg.cols]
        assert row[4] == vec and tuple(row[5:]) == plan[i]
        assert ptrs[4 * i + 1] == x.data_ptr()      # read in place
        assert ptrs[4 * i + 2] is None and ptrs[4 * i + 3] is None
    weighted = KF._prepare(cases[0][0], cases[0][0], torch.ones((2, 4, 4, 5, 1)))
    assert weighted.w.is_contiguous() and weighted.w.shape == (2, 4, 4, 5, 20)


@pytest.mark.parametrize("shape,lead", [((2, 6, 6, 20), 5),
                                        ((2, 3, 3, 5, 20), 4),
                                        ((3, 7, 8), 1),
                                        ((2, 4, 4, 21), 5)])
def test_walk_order_does_not_depend_on_alignment(shape, lead):
    """A view at an odd float offset and its clone: the walk modes differ
    only in the width of their loads, and the modelled walk hands every
    thread the same elements in the same order, covering each once."""
    wide = torch.zeros(shape[:-1] + (lead + shape[-1],))
    view = wide[..., lead:]
    clone = view.clone()
    seg_v, seg_c = (KF._prepare(t, t, None) for t in (view, clone))
    assert (seg_v.rows, seg_v.cols) == (seg_c.rows, seg_c.cols)
    mode_v, mode_c = KF._walk_mode(seg_v, None), KF._walk_mode(seg_c, None)
    quad = shape[-1] % 4 == 0
    assert {mode_v, mode_c} <= ({KF._QUAD16, KF._QUAD4} if quad
                                else {KF._SCALAR})
    assert mode_c == (KF._QUAD16 if quad else KF._SCALAR)
    order_v = KF.focal_walk_plain(seg_v.rows, seg_v.cols, mode_v)
    order_c = KF.focal_walk_plain(seg_c.rows, seg_c.cols, mode_c)
    assert order_v == order_c
    flat = np.concatenate([np.asarray(o, np.int64) for o in order_v])
    assert np.array_equal(np.sort(flat), np.arange(view.numel()))


def test_walk_order_is_that_of_the_unit_not_of_the_loads():
    """At 20 columns the quad walk gives thread t four consecutive floats
    of one row; the scalar walk would give it one float of each of four
    rows. Both quad modes are the quad walk."""
    q16 = KF.focal_walk_plain(64, 20, KF._QUAD16)
    q4 = KF.focal_walk_plain(64, 20, KF._QUAD4)
    scalar = KF.focal_walk_plain(64, 20, KF._SCALAR)
    assert q16 == q4 and q16 != scalar
    assert q16[1][:4] == [4, 5, 6, 7]
    assert scalar[1][:2] == [1, 12 * 20 + 1]
    assert KF._walk_unit(20) == 4 and KF._walk_unit(21) == 1
    with pytest.raises(ValueError):
        KF.focal_walk_plain(4, 21, KF._QUAD4)


# --------------------------------------------------------------------------
# the torch.library operators detectax_torch::focal_group / _bwd
# --------------------------------------------------------------------------

OP_RTOL, OP_GRAD_ATOL = 2e-6, 1e-6   # the plain formula against XLA's


def _op_segments(rng, weights):
    """Torch segments read in place: the class channels ``y[..., 5:]`` of
    two level maps (strided views), one centerness channel ``y[..., 4]``,
    with a weight mask on every segment, on some or on none."""
    maps = [tuple(torch.from_numpy(a) for a in m)
            for m in _level_maps(rng, batch=2)[:2]]
    segs = [(z[..., 5:], x[..., 5:]) for z, x in maps]
    segs.append((maps[0][0][..., 4], maps[0][1][..., 4]))
    mask = [torch.from_numpy((rng.uniform(size=x.shape[:-1] + (1,)) < 0.7)
                             .astype(np.float32)) for _, x in segs]
    if weights == "none":
        mask = [None] * len(segs)
    elif weights == "some":
        mask[1] = None
    return [(z, x, w) for (z, x), w in zip(segs, mask)]


@pytest.mark.parametrize("weights", ["all", "some", "none"])
def test_focal_operators_pass_opcheck_on_cpu_segments(rng, weights):
    """`torch.library.opcheck` (schema, autograd registration, fake tensors,
    AOT dispatch) of both operators on strided views with weight masks."""
    segs = _op_segments(rng, weights)
    assert not segs[0][1].is_contiguous()
    labels = [z for z, _, _ in segs]
    logits = [x.clone().requires_grad_(True) for _, x, _ in segs]
    ws = [w for _, _, w in segs]
    torch.library.opcheck(torch.ops.detectax_torch.focal_group,
                          (labels, logits, ws, 0.25, 2.0))
    torch.library.opcheck(
        torch.ops.detectax_torch.focal_group_bwd,
        (labels, [x for _, x, _ in segs], ws,
         torch.linspace(0.5, 2.0, len(segs)), 0.25, 2.0))


@pytest.mark.parametrize("case", ["levels", "weighted", "extreme"])
def test_focal_operator_against_pallas_and_jax_grad(rng, case):
    """The operator's CPU forward and its registered backward (the closed
    form) against the TPU kernel in interpret mode (rtol 2e-4 on a sum,
    atol 1e-5 on dlogits), and against `jax.grad` of the JAX package's
    `focal_loss` away from logit 0 (rtol 2e-6, atol 1e-6)."""
    from detectax.ops.losses import focal_loss as j_focal

    segs = _segments(rng, case)
    zs = [torch.from_numpy(np.ascontiguousarray(z)) for z, _, _ in segs]
    xs = [torch.from_numpy(np.ascontiguousarray(x)).requires_grad_(True)
          for _, x, _ in segs]
    ws = [None if w is None else torch.from_numpy(w) for _, _, w in segs]
    got = torch.ops.detectax_torch.focal_group(zs, xs, ws, 0.25, 2.0)
    upstream = torch.linspace(0.5, 2.0, len(segs))
    grads = torch.autograd.grad(got, xs, upstream)
    for i, (z, x, w) in enumerate(segs):
        jw = None if w is None else jnp.asarray(w)
        pallas, pallas_grad = jax.value_and_grad(
            lambda t: focal_loss_pallas(jnp.asarray(z), t, jw, 0.25, 2.0,
                                        True))(jnp.asarray(x))
        want, want_grad = jax.value_and_grad(
            lambda t: j_focal(jnp.asarray(z), t, weights=jw))(jnp.asarray(x))
        u = float(upstream[i])
        np.testing.assert_allclose(float(got[i]), float(pallas), rtol=2e-4)
        np.testing.assert_allclose(grads[i].numpy(),
                                   u * np.asarray(pallas_grad), atol=1e-5)
        np.testing.assert_allclose(float(got[i]), float(want), rtol=OP_RTOL)
        away = x != 0.0
        np.testing.assert_allclose(grads[i].numpy()[away],
                                   u * np.asarray(want_grad)[away],
                                   atol=OP_GRAD_ATOL)


def test_cpu_wrapper_routes_by_whether_logits_need_a_gradient(rng):
    """CPU logits that need a gradient take the plain version with
    autograd (no operator in the graph); the others go through the
    operator, whose CPU forward is that plain version, bit for bit."""
    segs = [(z, x, w) for z, x, w in _op_segments(rng, "some")]
    plain = KF.focal_loss_group_plain(segs)
    via_op = KF.focal_loss_group(segs)
    assert torch.equal(via_op, plain)
    xs = [x.clone().requires_grad_(True) for _, x, _ in segs]
    with_grad = KF.focal_loss_group(
        [(z, x, w) for (z, _, w), x in zip(segs, xs)])
    assert torch.equal(with_grad.detach(), plain)
    assert "focal_group" not in type(with_grad.grad_fn).__name__.lower()
    op = torch.ops.detectax_torch.focal_group(
        [z for z, _, _ in segs], xs, [w for _, _, w in segs], 0.25, 2.0)
    assert torch.equal(op.detach(), plain)
    assert "focal_group" in type(op.grad_fn).__name__


def test_export_of_fcos_loss_holds_one_focal_group_call(rng):
    """`torch.export` on the CPU of a module computing `fcos_loss`'s
    forward traces through the focal term: one ``focal_group`` call for
    all levels, and the program gives the eager losses."""
    class Loss(torch.nn.Module):
        def forward(self, *maps):
            half = len(maps) // 2
            return TTL.fcos_loss(list(maps[:half]), list(maps[half:]))

    y_true = [torch.from_numpy(z) for z, _ in _level_maps(rng)]
    y_pred = [torch.from_numpy(x) for _, x in _level_maps(rng)]
    for t in y_true:
        t[..., :4] = torch.rand(t[..., :4].shape) + 0.5
    program = torch.export.export(Loss(), (*y_true, *y_pred))
    calls = [n.target for n in program.graph.nodes
             if n.op == "call_function" and "focal" in str(n.target)]
    assert calls == [torch.ops.detectax_torch.focal_group.default]
    got = program.module()(*y_true, *y_pred)
    want = Loss()(*y_true, *y_pred)
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
