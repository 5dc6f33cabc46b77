"""Data-parallel training and evaluation of the port, on the CPU.

Two gloo ranks: processes of `detectax_torch.tools.two_process_cpu_test`
(which imports no JAX), meeting through a file under the test's directory.
They are launched once for the module and run every job in turn while this
process compiles the JAX side; each test reads its own job. Tiny FCOS,
64 px, 3 classes, global batch 4 (2 rows a rank), 2 SGD steps, the weights
of a Flax init through `from_flax`.

Tolerances: against the JAX package's `make_sharded_train_step` over
`make_mesh(2)` (and its one-device microbatched step on the batch
permuted into the port's chunk order), ``total`` rtol 1e-4 and every
parameter and BatchNorm statistic atol 1e-5, as `tests/test_sharding.py`
holds the sharded step to the one-device one. Against the port's own
single process on the global batch: metrics rtol 1e-5, state atol 2e-6
(largest seen: 1.4e-7 relative, 1.8e-7 absolute; the sums differ in
order only). Across ranks, and for `cli.evaluate --data_parallel`:
bitwise.
"""
import concurrent.futures
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detectax.models.fcos import FCOS as JFCOS
from detectax.ops import assign as JA
from detectax.parallel.mesh import (
    make_mesh,
    make_sharded_train_step,
    shard_batch as j_shard_batch,
    shard_train_state,
)
from detectax.train import losses as JTL
from detectax.train import loop as JLoop
from detectax.train import schedules as JS
from detectax_torch.cli import evaluate as t_evaluate
from detectax_torch.models.fcos import FCOS as TFCOS
from detectax_torch.models.layers import BatchNorm
from detectax_torch.parallel import mesh
from detectax_torch.tools import from_flax as FF
from detectax_torch.tools import two_process_cpu_test as T
from detectax_torch.train.checkpoint import CheckpointManager
from detectax_torch.train.driver import restore_for_inference

IMG, NC, BATCH, WORLD, STEPS = 64, 3, 4, 2, 2
JAX_RTOL, JAX_ATOL = 1e-4, 1e-5
ONE_RTOL, ONE_ATOL = 1e-5, 2e-6
# global chunk j of the interleaved microbatches (microbatch 2, one row a
# rank) is row j of each rank: rows (0, 2), then (1, 3)
PERMUTED = [0, 2, 1, 3]
TRAIN_JOBS = {
    "batch": {},
    "pos": {"loss_norm": "pos"},
    "micro": {"loss_norm": "pos", "microbatch": 2},
    "subset": {"env": {"DETECTAX_BN_STAT_SUBSET": "2"}},
}


def _numpy_tree(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


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
        boxes[..., 0] = rng.uniform(0.3, 0.7, (BATCH, 6))
        boxes[..., 1] = rng.uniform(0.3, 0.7, (BATCH, 6))
        boxes[..., 2] = rng.uniform(0.1, 0.6, (BATCH, 6))
        boxes[..., 3] = rng.uniform(0.1, 0.6, (BATCH, 6))
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


def _j_assign(boxes, labels, valid):
    return JA.fcos_assign(boxes, labels, valid, img_dim=(IMG, IMG),
                          num_classes=NC)[0]


def _j_parts(**kw):
    model = JFCOS(num_classes=NC, backbone="tiny")
    opt = JS.make_optimizer("sgd", JS.exponential_with_floor(1e-2),
                            grad_clip=1.0)
    state = JLoop.create_train_state(
        model, jax.random.PRNGKey(0), jnp.zeros((BATCH, IMG, IMG, 3)), opt)
    step = JLoop.make_train_step(model, _j_assign, JTL.fcos_loss, opt,
                                 donate=False, **kw)
    return state, step


def _cli(work, *extra):
    return ["--device", "cpu", "--backbone", "tiny", "--canvas", str(IMG),
            "--synthetic_n", "8", *extra]


def _evaluate_argv(work, *extra):
    return ["--family", "fcos", "--device", "cpu", "--backbone", "tiny",
            "--canvas", str(IMG), "--synthetic_n", "6", "--cls_thresh", "0.0",
            "--ckpt_dir", os.path.join(work, "ckpt"), *extra]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """torch on one thread here and in the ranks: the steps are tiny, and
    beside the suite's other workers a pool of threads a process waits on
    busy cores at every operation (tens of times slower)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Launches the ranks (in a thread, so that the JAX side compiles
    meanwhile) and yields what the tests share."""
    work = str(tmp_path_factory.mktemp("data_parallel"))
    jstate, _ = _j_parts(jit=False)
    model = TFCOS(num_classes=NC, backbone="tiny")
    FF.load_flax(model, _numpy_tree(jstate.params),
                 _numpy_tree(jstate.batch_stats))
    weights = os.path.join(work, "weights.pt")
    torch.save(model.state_dict(), weights)
    batches = _batches(np.random.default_rng(11))
    np.savez(os.path.join(work, "batches.npz"),
             **{f"{k}_{i}": v for i, b in enumerate(batches)
                for k, v in b.items()})
    train = {"kind": "train", "lr": 1e-2, "grad_clip": 1.0,
             "batches": os.path.join(work, "batches.npz"),
             "model": {"backbone": "tiny", "num_classes": NC, "canvas": IMG,
                       "weights": weights},
             "save_state": True}
    jobs = [dict(train, name=name, **spec)
            for name, spec in TRAIN_JOBS.items()]
    jobs += [
        {"kind": "fit", "name": "fit", "argv": _cli(
            work, "--batch_size", str(BATCH), "--max_steps", str(STEPS),
            "--display_step", "1", "--step_save", str(STEPS),
            "--ckpt_dir", os.path.join(work, "ckpt"),
            "--out_dir", os.path.join(work, "out"))},
        {"kind": "evaluate", "name": "evaluate", "argv": _evaluate_argv(
            work, "--batch_size", str(BATCH), "--data_parallel",
            "--out_json", os.path.join(work, "eval.json"))},
        {"kind": "refuse", "name": "refuse", "train": train,
         "train_argv": _cli(work, "--max_steps", "1",
                            "--ckpt_dir", os.path.join(work, "ckpt_refused"),
                            "--out_dir", os.path.join(work, "out_refused")),
         "evaluate_argv": _evaluate_argv(work, "--data_parallel")},
    ]
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


def _rank_state(world, name, rank=0):
    return torch.load(os.path.join(world["work"], f"{name}_rank{rank}.pt"),
                      weights_only=True)


def _flax_trees(state_dict):
    model = TFCOS(num_classes=NC, backbone="tiny")
    model.load_state_dict(state_dict)
    return FF.to_flax(model)


def _assert_close_to_jax(state_dict, jstate, what):
    params, stats = _flax_trees(state_dict)
    for got, want in ((params, jstate.params), (stats, jstate.batch_stats)):
        got, want = dict(_leaves(got)), dict(_leaves(_numpy_tree(want)))
        assert set(got) == set(want), what
        for k in want:
            np.testing.assert_allclose(got[k], want[k], atol=JAX_ATOL,
                                       err_msg=f"{what}: {k}")


def test_two_ranks_match_jax_sharded_step(world):
    """The port on two ranks against the JAX package's step jitted over a
    two-device mesh, on the same global batches and weights."""
    jmesh = make_mesh(WORLD)
    jstate, jstep = _j_parts(jit=False)
    jstate, shardings = shard_train_state(jstate, jmesh)
    sharded = make_sharded_train_step(jstep, jmesh, state_shardings=shardings)
    totals = []
    for batch in world["batches"]:
        jstate, jm = sharded(jstate, j_shard_batch(
            {k: jnp.asarray(v) for k, v in batch.items()}, jmesh))
        totals.append(float(jm["total"]))
    got = _job(world, "batch")["metrics"]
    np.testing.assert_allclose([m["total"] for m in got], totals,
                               rtol=JAX_RTOL)
    _assert_close_to_jax(_rank_state(world, "batch"), jstate, "sharded")


def test_interleaved_microbatches_match_jax_on_the_permuted_batch(world):
    """Global chunk j is every rank's j-th local chunk: the JAX package's
    one-device microbatched step (loss_norm "pos": one division by the
    global positive count) on the batch in that order."""
    jstate, jstep = _j_parts(jit=True, microbatch=2, loss_norm="pos")
    totals = []
    for batch in world["batches"]:
        jstate, jm = jstep(jstate, {k: jnp.asarray(v[PERMUTED])
                                    for k, v in batch.items()})
        totals.append(float(jm["total"]))
    got = _job(world, "micro")["metrics"]
    np.testing.assert_allclose([m["total"] for m in got], totals,
                               rtol=JAX_RTOL)
    _assert_close_to_jax(_rank_state(world, "micro"), jstate, "microbatch")


@pytest.mark.parametrize("name", sorted(TRAIN_JOBS))
def test_two_ranks_match_one_process(world, name):
    """Each rank's metrics and final state against the port's step without
    a group on the global batch (for "micro" in the ranks' chunk order;
    for "subset" the BatchNorm statistics of the first half of the global
    batch, which rank 0 alone holds)."""
    job = dict(world["train"], **TRAIN_JOBS[name])
    order = PERMUTED if name == "micro" else slice(None)
    batches = [{k: v[order] for k, v in b.items()} for b in world["batches"]]
    with T.environment(job.get("env", {})):
        model, state, step = T.build_trainer(job, torch.device("cpu"))
        want, _ = T.run_steps(state, step, batches, torch.device("cpu"))
    for rank in range(WORLD):
        got = _job(world, name, rank)
        assert got["launches"] == {}  # the plain versions on the CPU
        for g, w in zip(got["metrics"], want):
            assert set(g) == set(w)
            for k in w:
                np.testing.assert_allclose(g[k], w[k], rtol=ONE_RTOL,
                                           err_msg=f"{name} {k}")
        sd = _rank_state(world, name, rank)
        for k, v in model.state_dict().items():
            np.testing.assert_allclose(sd[k].numpy(), v.numpy(),
                                       atol=ONE_ATOL, err_msg=f"{name} {k}")
    start = torch.load(job["model"]["weights"], weights_only=True)
    assert any(not torch.equal(v, start[k])
               for k, v in model.state_dict().items() if "running_" in k)


@pytest.mark.parametrize("name", sorted(TRAIN_JOBS) + ["fit"])
def test_ranks_hold_bitwise_equal_state(world, name):
    """Parameters and BatchNorm buffers equal bit for bit across ranks,
    and so are the logged metrics; "fit" is `cli.train_fcos` with each
    rank's `Loader` on its own share of the data (num_hosts=2)."""
    a, b = (_rank_state(world, name, r) for r in range(WORLD))
    assert set(a) == set(b) and any("running_var" in k for k in a)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    if name == "fit":
        s0, s1 = (_job(world, name, r)["summary"] for r in range(WORLD))
        for k in ("total", "cls", "reg", "cen", "num_pos", "grad_norm"):
            assert s0[k] == s1[k], k
        assert s0["final_step"] == STEPS
    else:
        m0, m1 = (_job(world, name, r)["metrics"] for r in range(WORLD))
        assert m0 == m1


def test_data_parallel_checkpoint_restores_without_a_group(world):
    """Rank 0 alone wrote the checkpoint and the metrics; they load in a
    process that has no group."""
    _job(world, "fit")
    assert not torch.distributed.is_initialized()
    ckpt = os.path.join(world["work"], "ckpt")
    assert CheckpointManager(ckpt).all_steps() == [STEPS]
    model = restore_for_inference(ckpt, TFCOS(num_classes=NC,
                                              backbone="tiny"))
    for k, v in _rank_state(world, "fit").items():
        assert torch.equal(model.state_dict()[k], v), k
    with open(os.path.join(world["work"], "out", "losses.csv")) as f:
        assert len(f.read().strip().splitlines()) == 1 + STEPS
    with open(os.path.join(world["work"], "out", "metrics.jsonl")) as f:
        assert len(f.read().strip().splitlines()) == STEPS


def test_evaluate_data_parallel_gives_the_single_process_detections(world):
    """`cli.evaluate --data_parallel` on two ranks (each its rows of the
    batch, the detections all-gathered, rank 0 evaluating) against
    `cli.evaluate` in one process at a rank's batch, so that each image's
    forward has the shape it has on a rank (on the card cuDNN picks its
    algorithm by the shape): the same detections, exactly. Six images at
    batch 4, so the last global batch is padded."""
    got = _job(world, "evaluate")
    assert _job(world, "evaluate", 1)["summary"] is None
    assert got["images"] == 6 and _job(world, "evaluate", 1)["images"] == 0
    with T.record_detections() as seen:
        want = t_evaluate.main(_evaluate_argv(world["work"], "--batch_size",
                                              str(BATCH // WORLD)))
    assert got["summary"] == json.loads(json.dumps(want))  # as it came
    dets = np.load(os.path.join(world["work"], "evaluate_dets.npz"))
    assert len(seen) == 6 and sum(len(d["scores"]) for d in seen) > 0
    for i, d in enumerate(seen):
        for k, v in d.items():
            np.testing.assert_array_equal(dets[f"{k}_{i}"], v,
                                          err_msg=f"image {i} {k}")
    assert os.path.exists(os.path.join(world["work"], "eval.json"))


@pytest.mark.parametrize("entry", ["shard_batch", "train_fcos", "evaluate",
                                   "make_train_step"])
def test_a_batch_that_does_not_divide_is_refused(world, entry):
    """A global batch (or microbatch) of 3 on two ranks raises on every
    rank before any collective (the ranks went on to the end)."""
    for rank in range(WORLD):
        said = _job(world, "refuse", rank)[entry]
        assert said is not None and "divide by the world size" in said, said


def test_shard_batch_takes_rank_major_rows():
    dp = mesh.DataParallel(rank=1, world_size=WORLD,
                           device=torch.device("cpu"))
    batch = {"images": np.arange(8).reshape(4, 2), "valid": np.arange(4)}
    got = mesh.shard_batch(batch, dp)
    np.testing.assert_array_equal(got["images"], [[4, 5], [6, 7]])
    np.testing.assert_array_equal(got["valid"], [2, 3])
    assert mesh.shard_batch(batch, None) is batch
    with pytest.raises(ValueError, match="divide by the world size"):
        mesh.shard_batch({"images": np.zeros(3)}, dp)


def test_without_torchrun_there_is_no_group(monkeypatch):
    for k in mesh.TORCHRUN_ENV:
        monkeypatch.delenv(k, raising=False)
    assert mesh.maybe_initialize_distributed("cpu") is None
    assert not torch.distributed.is_initialized()
    fn = lambda images: {"boxes": images}  # noqa: E731
    assert mesh.make_sharded_eval_fn(fn, None) is fn
    assert mesh.replicate_state("state", None) == "state"


def test_batchnorm_without_a_group_is_unchanged(rng):
    x = torch.from_numpy(rng.normal(size=(4, 3, 5, 5)).astype(np.float32))
    a, b = BatchNorm(3), BatchNorm(3)
    want = a(x, train=True)
    with mesh.batch_stats_over(None):
        got = b(x, train=True)
    assert torch.equal(got, want)
    assert torch.equal(a.running_var, b.running_var)
