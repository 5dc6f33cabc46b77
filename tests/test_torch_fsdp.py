"""FSDP training of the port (`parallel.mesh.shard_train_state(fsdp=True)`),
on the CPU.

The layout rule, `fsdp_param_spec`, is held against the JAX package's
function for every parameter of FCOS-R50 and RetinaNet-R101 (shapes from
`jax.eval_shape`) at 2, 4 and 8 ranks, and at world sizes that divide few
axes or none.

Two gloo ranks: processes of `detectax_torch.tools.two_process_cpu_test`,
launched once for the module in a thread while this process compiles the
JAX side; each test reads its own job. Tiny FCOS, 64 px, 3 classes, global
batch 4 (2 rows a rank), 2 SGD steps, the weights of a Flax init through
`from_flax`, with the state data-parallel (``dp_*``) and FSDP
(``fsdp_*``), and the JAX tool's scenario C: RetinaNet-tiny, bf16,
microbatch 2, FSDP.

Tolerances: against the JAX package's `make_sharded_train_step(...,
fsdp=True)` over `make_mesh(2)` with `shard_train_state(fsdp=True)` (the
microbatched job on the batch permuted into the port's chunk order),
``total`` rtol 1e-4 and every parameter and BatchNorm statistic atol 1e-5,
as `tests/test_torch_parallel.py` holds the data-parallel ranks. Against
the port's own data-parallel ranks: metrics rtol 1e-5, state atol 2e-6
(the global norm sums its squares in another order). Scenario C against
JAX: losses within 2e-2 relative and the gradient norms within 2e-2 of
each other, the bounds of `tests/test_torch_bf16.py`. Across ranks, and a
checkpoint restored without a group against the ranks' gathered state:
bitwise.
"""
import concurrent.futures
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detectax.models import RetinaNet as JRetina
from detectax.models.fcos import FCOS as JFCOS
from detectax.ops import anchors as JAn
from detectax.ops import assign as JA
from detectax.parallel import mesh as jmesh
from detectax.train import losses as JTL
from detectax.train import loop as JLoop
from detectax.train import schedules as JS
from detectax_torch.models import FCOS as TFCOS
from detectax_torch.models import RetinaNet as TRetina
from detectax_torch.parallel import mesh
from detectax_torch.tools import from_flax as FF
from detectax_torch.tools import two_process_cpu_test as T
from detectax_torch.train import loop as TLoop
from detectax_torch.train import schedules as TS
from detectax_torch.train.checkpoint import CheckpointManager

IMG, NC, BATCH, WORLD, STEPS = 64, 3, 4, 2, 2
JAX_RTOL, JAX_ATOL = 1e-4, 1e-5
DP_RTOL, DP_ATOL = 1e-5, 2e-6
BF16_RTOL = 2e-2
# global chunk j of the interleaved microbatches (microbatch 2, one row a
# rank) is row j of each rank: rows (0, 2), then (1, 3)
PERMUTED = [0, 2, 1, 3]
JAX_JOBS = {
    "batch": {},
    "pos": {"loss_norm": "pos"},
    "micro": {"loss_norm": "pos", "microbatch": 2},
}
# held against the data-parallel ranks only: Adam's moments and the EMA
# are sharded too
JOBS = dict(JAX_JOBS, adam_ema={"optimizer": "adam", "ema_decay": 0.9})
SCENARIO_C = {"model": {"family": "retinanet", "dtype": "bfloat16"},
              "microbatch": 2}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """torch on one thread here and in the ranks: the steps are tiny, and
    beside the suite's other workers a pool of threads a process waits on
    busy cores at every operation (tens of times slower)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _shapes(tree, prefix=()):
    """(path, shape) of each leaf of a tree of `jax.ShapeDtypeStruct`."""
    for k, v in tree.items():
        if isinstance(v, jax.ShapeDtypeStruct):
            yield prefix + (str(k),), tuple(v.shape)
        else:
            yield from _shapes(v, prefix + (str(k),))


def _leaves(tree, prefix=""):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v)


def _batches(rng):
    out = []
    for _ in range(STEPS):
        boxes = np.zeros((BATCH, 6, 4), np.float32)
        boxes[..., :2] = rng.uniform(0.3, 0.7, (BATCH, 6, 2))
        boxes[..., 2:] = rng.uniform(0.1, 0.6, (BATCH, 6, 2))
        valid = np.ones((BATCH, 6), bool)
        valid[1, 3:] = False
        valid[3] = False                # a row with no box at all
        out.append({
            "images": rng.normal(size=(BATCH, IMG, IMG, 3))
            .astype(np.float32),
            "boxes": boxes,
            "labels": rng.integers(0, NC, (BATCH, 6)).astype(np.int32),
            "valid": valid})
    return out


def _j_fcos_assign(boxes, labels, valid):
    return JA.fcos_assign(boxes, labels, valid, img_dim=(IMG, IMG),
                          num_classes=NC)[0]


_J_ANCHORS = JAn.anchor_shapes_per_level(anchor_sizes=T.TINY_ANCHOR_SIZES)


def _j_retina_assign(boxes, labels, valid):
    return JA.retinanet_assign(boxes, labels, valid, img_dim=(IMG, IMG),
                               num_classes=NC,
                               anchors_per_level=_J_ANCHORS)[0]


def _j_family(family):
    """(model, PRNG seed, assign, loss) of the JAX tool's configurations."""
    if family == "fcos":
        return (JFCOS(num_classes=NC, backbone="tiny"), 0, _j_fcos_assign,
                JTL.fcos_loss)
    return (JRetina(num_classes=NC, n_anchors=_J_ANCHORS[0].shape[0],
                    backbone="tiny", dtype=jnp.bfloat16), 1,
            _j_retina_assign, JTL.retinanet_loss)


_OPT = JS.make_optimizer("sgd", JS.exponential_with_floor(1e-2),
                         grad_clip=1.0)


@functools.cache
def _j_state0(family):
    """The JAX tool's initial state of ``family`` (one jitted init)."""
    model, seed, _, _ = _j_family(family)
    return JLoop.create_train_state(model, jax.random.PRNGKey(seed),
                                    jnp.zeros((BATCH, IMG, IMG, 3)), _OPT)


def _j_fsdp_parts(family="fcos", **kw):
    """The JAX step over `make_mesh(2)` with the state FSDP-sharded."""
    model, _, assign, loss = _j_family(family)
    m = jmesh.make_mesh(WORLD)
    # a copy: the sharded step donates the state it is given
    state, shardings = jmesh.shard_train_state(
        jax.tree.map(jnp.copy, _j_state0(family)), m, fsdp=True)
    raw = JLoop.make_train_step(model, assign, loss, _OPT, donate=False,
                                jit=False, **kw)
    step = jmesh.make_sharded_train_step(raw, m, state_shardings=shardings,
                                         fsdp=True)
    return state, step, m


def _weights(family, path):
    """The JAX initial state's weights as a port state dict file."""
    state = _j_state0(family)
    cls = TFCOS if family == "fcos" else TRetina
    kw = {} if family == "fcos" else {"n_anchors": _J_ANCHORS[0].shape[0]}
    port = cls(num_classes=NC, backbone="tiny", **kw)
    FF.load_flax(port, _np(state.params), _np(state.batch_stats))
    torch.save(port.state_dict(), path)
    return path


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Launches the ranks (in a thread, so that the JAX side compiles
    meanwhile) and yields what the tests share."""
    work = str(tmp_path_factory.mktemp("fsdp"))
    batches = _batches(np.random.default_rng(11))
    np.savez(os.path.join(work, "batches.npz"),
             **{f"{k}_{i}": v for i, b in enumerate(batches)
                for k, v in b.items()})
    model = {"backbone": "tiny", "num_classes": NC, "canvas": IMG}
    train = {"kind": "train", "lr": 1e-2, "grad_clip": 1.0,
             "batches": os.path.join(work, "batches.npz"),
             "save_state": "full",
             "model": dict(model, weights=_weights(
                 "fcos", os.path.join(work, "fcos.pt")))}
    jobs = []
    for name, spec in JOBS.items():
        jobs.append(dict(train, name=f"dp_{name}", **spec))
        jobs.append(dict(train, name=f"fsdp_{name}", fsdp=True, **spec))
    jobs[-1]["checkpoint"] = os.path.join(work, "ckpt")
    jobs.append(dict(train, name="scenario_c", fsdp=True,
                     microbatch=SCENARIO_C["microbatch"],
                     model=dict(model, **SCENARIO_C["model"],
                                weights=_weights("retinanet", os.path.join(
                                    work, "retinanet.pt")))))
    pool = concurrent.futures.ThreadPoolExecutor(1)
    ranks = pool.submit(T.launch, jobs, WORLD, work, timeout=240,
                        env={"OMP_NUM_THREADS": "1"})
    try:
        yield {"work": work, "batches": batches, "train": train,
               "ranks": ranks}
    finally:
        concurrent.futures.wait([ranks])
        pool.shutdown()


def _job(world, name, rank=0):
    return world["ranks"].result()[rank]["jobs"][name]


def _state(world, name, rank=0):
    return torch.load(os.path.join(world["work"], f"{name}_rank{rank}.pt"),
                      weights_only=True)


def _assert_close_to_jax(state_dict, jstate, what):
    model = TFCOS(num_classes=NC, backbone="tiny")
    model.load_state_dict(state_dict)
    params, stats = FF.to_flax(model)
    for got, want in ((params, jstate.params), (stats, jstate.batch_stats)):
        got, want = dict(_leaves(got)), dict(_leaves(_np(want)))
        assert set(got) == set(want), what
        for k in want:
            np.testing.assert_allclose(got[k], want[k], atol=JAX_ATOL,
                                       err_msg=f"{what}: {k}")


# --------------------------------------------------------------------------
# the layout rule
# --------------------------------------------------------------------------

def _jax_spec_axis(shape, m):
    """The axis JAX's `fsdp_param_spec` shards (Flax's layout), or None."""
    spec = jmesh.fsdp_param_spec(jax.ShapeDtypeStruct(shape, jnp.float32), m)
    axes = [i for i, s in enumerate(spec) if s is not None]
    return axes[0] if axes else None


def _torch_axis_in_flax_layout(torch_shape, world_size):
    axis = mesh.fsdp_param_spec(torch_shape, world_size)
    if axis is None or len(torch_shape) != 4:
        return axis
    # from_flax: torch = flax.transpose(3, 2, 0, 1)
    return (3, 2, 0, 1)[axis]


@pytest.mark.parametrize("world_size", [2, 4, 8])
@pytest.mark.parametrize("family", ["fcos_r50", "retinanet_r101"])
def test_fsdp_param_spec_matches_jax(family, world_size):
    """Every parameter of FCOS-R50 and RetinaNet-R101: the port's axis,
    mapped to Flax's layout, is the JAX function's (shapes from
    `jax.eval_shape`; the port's model built on the meta device)."""
    if family == "fcos_r50":
        jmodel, tcls, kw = (JFCOS(num_classes=20, backbone="resnet50"),
                            TFCOS, {"num_classes": 20,
                                    "backbone": "resnet50"})
    else:
        jmodel, tcls, kw = (JRetina(num_classes=81, backbone="resnet101"),
                            TRetina, {"num_classes": 81,
                                      "backbone": "resnet101"})
    shapes = jax.eval_shape(
        lambda: jmodel.init(jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 64, 3)), train=False))
    with torch.device("meta"):
        tmodel = tcls(**kw)
    tshapes = {k: tuple(p.shape) for k, p in tmodel.named_parameters()}
    m = jmesh.make_mesh(world_size)
    seen = sharded = 0
    for path, flax_shape in _shapes(shapes["params"]):
        key = FF._torch_key(path, FF._PARAM_LEAVES)
        want_torch = (tuple(flax_shape[i] for i in (3, 2, 0, 1))
                      if len(flax_shape) == 4 else flax_shape)
        assert tshapes[key] == want_torch, key
        got = _torch_axis_in_flax_layout(tshapes[key], world_size)
        assert got == _jax_spec_axis(flax_shape, m), (key, flax_shape)
        seen += 1
        sharded += got is not None
    assert seen == len(tshapes)
    assert sharded > 0


@pytest.mark.parametrize("world_size", [3, 5, 7])
def test_a_world_size_that_divides_no_axis_leaves_the_leaf_replicated(
        world_size):
    """As in JAX: a large leaf no axis of which divides by the world size
    stays whole, a small one always does, and otherwise the largest axis
    that divides wins (a 3x3 kernel's spatial axis at 3 ranks)."""
    m = jmesh.make_mesh(world_size)
    flax_shapes = [(3, 3, 256, 256), (3, 3, 64, 256), (1, 1, 512, 2048),
                   (7, 7, 3, 64), (3, 3, 128, 128), (65536,), (256,)]
    for flax_shape in flax_shapes:
        torch_shape = (tuple(flax_shape[i] for i in (3, 2, 0, 1))
                       if len(flax_shape) == 4 else flax_shape)
        got = _torch_axis_in_flax_layout(torch_shape, world_size)
        assert got == _jax_spec_axis(flax_shape, m), flax_shape
    # 256 and 3 and 1 divide by neither 5 nor 7: replicated
    if world_size != 3:
        assert mesh.fsdp_param_spec((256, 256, 3, 3), world_size) is None
    else:
        assert mesh.fsdp_param_spec((256, 256, 3, 3), 3) == 2
    assert mesh.fsdp_param_spec((256,), 2) is None


# --------------------------------------------------------------------------
# two gloo ranks
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(JAX_JOBS))
def test_fsdp_ranks_match_the_jax_fsdp_step(world, name):
    """The port's FSDP ranks against the JAX step jitted over a two-device
    mesh with `shard_train_state(fsdp=True)`, on the same global batches
    and weights (the microbatched job in the ranks' chunk order)."""
    spec = JAX_JOBS[name]
    jstate, jstep, m = _j_fsdp_parts(**spec)
    order = PERMUTED if "microbatch" in spec else slice(None)
    totals = []
    for batch in world["batches"]:
        jstate, jm = jstep(jstate, jmesh.shard_batch(
            {k: jnp.asarray(v[order]) for k, v in batch.items()}, m))
        totals.append(float(jm["total"]))
    got = _job(world, f"fsdp_{name}")
    assert got["sharded_leaves"] > 0
    np.testing.assert_allclose([x["total"] for x in got["metrics"]], totals,
                               rtol=JAX_RTOL)
    _assert_close_to_jax(_state(world, f"fsdp_{name}")["model"], jstate,
                         f"fsdp {name}")


@pytest.mark.parametrize("name", sorted(JOBS))
def test_fsdp_ranks_match_the_data_parallel_ranks(world, name):
    """Metrics and the gathered state (parameters, BatchNorm statistics,
    optimizer state, EMA) against the same job with the state replicated;
    three collectives more a step (the all-gather, the reduce-scatter and
    the norm's all-reduce)."""
    fsdp, dp = _job(world, f"fsdp_{name}"), _job(world, f"dp_{name}")
    assert fsdp["launches"] == dp["launches"] == {}   # the CPU: plain
    assert fsdp["collectives_per_step"] == dp["collectives_per_step"] + 3
    for g, w in zip(fsdp["metrics"], dp["metrics"]):
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=DP_RTOL,
                                       err_msg=f"{name} {k}")
    a, b = _state(world, f"fsdp_{name}"), _state(world, f"dp_{name}")
    assert a["step"] == b["step"] == STEPS
    pairs = [(f"model {k}", v, b["model"][k]) for k, v in a["model"].items()]
    pairs += [(f"opt {i} {k}", v, b["opt"]["state"][i][k])
              for i, per in a["opt"]["state"].items()
              for k, v in per.items()]
    if name == "adam_ema":
        pairs += [(f"ema {k}", v, b["ema"][k]) for k, v in a["ema"].items()]
    else:
        assert a["ema"] is None
    assert len(pairs) > len(a["model"])
    for what, x, y in pairs:
        assert x.shape == y.shape, what
        np.testing.assert_allclose(x.numpy(), y.numpy(), atol=DP_ATOL,
                                   err_msg=what)


@pytest.mark.parametrize("name", [f"fsdp_{n}" for n in sorted(JOBS)]
                         + ["scenario_c"])
def test_fsdp_ranks_hold_bitwise_equal_gathered_state(world, name):
    a, b = (_state(world, name, r) for r in range(WORLD))
    assert set(a["model"]) == set(b["model"])
    for k in a["model"]:
        assert torch.equal(a["model"][k], b["model"][k]), k
    for i, per in a["opt"]["state"].items():
        for k, v in per.items():
            assert torch.equal(v, b["opt"]["state"][i][k]), (i, k)
    m0, m1 = (_job(world, name, r)["metrics"] for r in range(WORLD))
    assert m0 == m1


def test_scenario_c_retinanet_bf16_microbatch_fsdp_matches_jax(world):
    """The JAX tool's scenario C (RetinaNet-tiny, bf16, microbatch 2, FSDP)
    on two ranks against the JAX step over a two-device mesh on the batch
    in the ranks' chunk order: step 1 within JAX's own bf16 error, and the
    parameters stayed float32."""
    jstate, jstep, m = _j_fsdp_parts("retinanet", microbatch=2)
    batch = world["batches"][0]
    jstate, jm = jstep(jstate, jmesh.shard_batch(
        {k: jnp.asarray(v[PERMUTED]) for k, v in batch.items()}, m))
    got = _job(world, "scenario_c")
    assert got["sharded_leaves"] > 0
    tm = got["metrics"][0]
    assert tm["num_pos"] == float(jm["num_pos"]) > 0
    for k in ("total", "cls", "reg"):
        np.testing.assert_allclose(tm[k], float(jm[k]), rtol=BF16_RTOL,
                                   err_msg=k)
    ratio = tm["grad_norm"] / float(jm["grad_norm"])
    assert abs(ratio - 1.0) <= BF16_RTOL, ratio
    assert all(v.dtype == torch.float32
               for v in _state(world, "scenario_c")["model"].values()
               if v.is_floating_point())
    assert all(np.isfinite(x["total"]) for x in got["metrics"])


def _expected_bytes(name, world_size):
    """(parameters, optimizer, EMA) bytes a rank holds: a leaf that
    `fsdp_param_spec` shards counts 1 / world_size of its bytes, the
    others whole (float32 leaves; Adam's step counters are scalars)."""
    with torch.device("meta"):
        model = TFCOS(num_classes=NC, backbone="tiny")
    params = [p for p in model.parameters()]
    held = sum(
        4 * p.numel() // (1 if world_size is None or mesh.fsdp_param_spec(
            p.shape, world_size) is None else world_size) for p in params)
    if JOBS[name].get("optimizer") == "adam":
        return held, 2 * held + 4 * len(params), held
    return held, held, 0


@pytest.mark.parametrize("name", sorted(JOBS))
def test_an_fsdp_rank_holds_replicated_plus_sharded_over_n_bytes(world,
                                                                 name):
    """Between steps a rank holds exactly ``replicated + sharded / N``
    bytes of parameters, optimizer state and EMA, in storage no larger (no
    full copy of a sharded leaf); the data-parallel rank holds all of
    it."""
    for rank in range(WORLD):
        got = _job(world, f"fsdp_{name}", rank)["state_bytes"]
        params, opt, ema = _expected_bytes(name, WORLD)
        assert (got["parameters"], got["optimizer"], got["ema"]) == (
            params, opt, ema)
        assert got["total"] == got["storage"] == params + opt + ema
        dp = _job(world, f"dp_{name}", rank)["state_bytes"]
        assert (dp["parameters"], dp["optimizer"], dp["ema"]) == (
            _expected_bytes(name, None))
    assert got["total"] < dp["total"]


def test_an_fsdp_checkpoint_restores_without_a_group(world):
    """Every rank called `CheckpointManager.save` (an all-gather), rank 0
    wrote the single-process file; it loads in this process, which has no
    group, into a state equal bit for bit to the ranks' gathered one."""
    name = "fsdp_adam_ema"
    _job(world, name)
    assert not torch.distributed.is_initialized()
    ckpt = os.path.join(world["work"], "ckpt")
    assert CheckpointManager(ckpt).all_steps() == [STEPS]
    model = TFCOS(num_classes=NC, backbone="tiny")
    opt = TS.make_optimizer("adam", TS.exponential_with_floor(1e-2))
    state = TLoop.create_train_state(model, None, opt, ema=True)
    assert CheckpointManager(ckpt).restore_latest(state)[1] == STEPS
    want = _state(world, name)
    got = state.state_dict()
    assert got["step"] == want["step"] == STEPS
    for k, v in want["model"].items():
        assert torch.equal(got["model"][k], v), k
    for k, v in want["ema"].items():
        assert torch.equal(got["ema"][k], v), k
    n = 0
    for i, per in want["opt"]["state"].items():
        for k, v in per.items():
            assert torch.equal(got["opt"]["state"][i][k], v), (i, k)
            n += 1
    # Adam's two moments and step counter of every parameter
    assert n == 3 * sum("running_" not in k for k in want["model"])


def test_flat_collectives_cut_and_join_on_any_axis(monkeypatch):
    """`all_gather_leaves` joins and `reduce_scatter_leaves` cuts leaves
    sharded on different axes through one flat buffer each: rank 1 of two,
    with the collectives replaced by what two ranks would give."""
    rng = np.random.default_rng(0)
    fulls = [torch.from_numpy(rng.normal(size=s).astype(np.float32))
             for s in ((6, 4, 3, 3), (4, 6, 3, 3), (2, 3, 4, 8), (10,))]
    axes = [0, 1, 3, 0]
    dps = [mesh.DataParallel(rank=r, world_size=2,
                             device=torch.device("cpu")) for r in range(2)]
    shards = [[mesh._slice(t, a, dp) for t, a in zip(fulls, axes)]
              for dp in dps]
    flats = [torch.cat([t.reshape(-1) for t in ts]) for ts in shards]
    calls = []

    def all_gather(out, flat, group=None):
        assert torch.equal(flat, flats[1])
        calls.append("all_gather")
        out.copy_(torch.cat(flats))

    def reduce_scatter(out, flat, op=None, group=None):
        # both ranks gave the same buffer: the sum is twice it
        calls.append("reduce_scatter")
        out.copy_(2 * flat.view(2, -1)[1])

    monkeypatch.setattr(mesh.dist, "all_gather_into_tensor", all_gather)
    monkeypatch.setattr(mesh.dist, "reduce_scatter_tensor", reduce_scatter)
    dp = dps[1]
    for got, want in zip(mesh.all_gather_leaves(shards[1], axes, dp),
                         fulls):
        assert torch.equal(got, want)
    for got, want in zip(mesh.reduce_scatter_leaves(fulls, axes, dp),
                         shards[1]):
        assert torch.equal(got, 2 * want)
    assert calls == ["all_gather", "reduce_scatter"]
    assert dp.collectives == 2
