"""Data-parallel runs of the port, one process a rank: the launcher and
what each rank runs.

The port's counterpart of the JAX package's `tools/two_process_cpu_test.py`
(which spawns `jax.distributed` processes). It imports torch and the port
only, so a process that holds JAX (a test) can launch it. `launch(jobs,
world_size, work)` writes ``work/jobs.json`` and starts one process a rank
with torchrun's environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``) and
a ``file://`` rendezvous in ``work`` (no port is opened); each rank
initializes the group (`parallel.mesh.maybe_initialize_distributed`), runs
the jobs in order and writes ``work/rank<r>.json`` (and state dicts as
``work/<name>_rank<r>.pt``). Under torchrun the same module takes
torchrun's rendezvous instead:

    torchrun --standalone --nproc_per_node 1 \\
        -m detectax_torch.tools.two_process_cpu_test WORK

with ``WORK/jobs.json`` written beforehand. Jobs, by ``kind``:

- ``train``: a detector (a state dict, or weights drawn from a seed)
  through `make_train_step(data_parallel=dp)` on this rank's rows
  (`shard_batch`) of the global batches of an ``.npz`` (``images_<i>``,
  ``boxes_<i>``, ``labels_<i>``, ``valid_<i>``): the metrics and
  milliseconds of each step, the kernel launches and the collectives of
  those steps, the bytes of parameters, optimizer state and EMA the rank
  holds after them (and the bytes of their storage), and, on CUDA, the
  peak of allocated memory; with ``alone`` the same steps run first
  without a group, in this process; with ``time_all_reduce`` the time of
  one all-reduce of BatchNorm moments and of the gradient buffer (under
  FSDP also of the step's all-gather and reduce-scatter). Options:
  ``model.family`` ``fcos`` (default) or ``retinanet`` (tiny anchors
  8-48 px), ``model.dtype`` (``bfloat16`` for bf16 compute),
  ``microbatch`` (global rows), ``loss_norm``, ``kernels``, ``env``,
  ``optimizer`` (``sgd``, ``adam``, ``adamw``), ``ema_decay``, ``fsdp``
  (the state sharded by ``shard_train_state(..., fsdp=True)``; the JAX
  tool's scenario C is ``retinanet``, ``bfloat16``, microbatch 2 and
  ``fsdp``), ``save_state`` (the single-process state dict of the model,
  all-gathered under FSDP, as ``<name>_rank<r>.pt``; ``"full"``: the whole
  `TrainState.state_dict`) and ``checkpoint`` (a directory:
  `CheckpointManager.save` from every rank after the steps).
- ``fit``: `cli.train_fcos.main(argv)`; the state dict of the model it
  trained.
- ``evaluate``: `cli.evaluate.main(argv)`; the detections each image got
  (`record_detections`), on rank 0.
- ``refuse``: a global batch of ``world + 1`` rows given to
  `shard_batch`, `cli.train_fcos`, `cli.evaluate`, and a microbatch of
  as many rows to `make_train_step`: the messages they raise.
"""
from __future__ import annotations

import contextlib
import functools
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

from detectax_torch.kernels import _common as kcommon
from detectax_torch.models import FCOS, RetinaNet
from detectax_torch.ops.anchors import anchor_shapes_per_level
from detectax_torch.ops.assign import fcos_assign, retinanet_assign
from detectax_torch.parallel import mesh
from detectax_torch.runtime import set_tf32
from detectax_torch.train.checkpoint import CheckpointManager
from detectax_torch.train.loop import create_train_state, make_train_step
from detectax_torch.train.losses import fcos_loss, retinanet_loss
from detectax_torch.train.schedules import exponential_with_floor, make_optimizer

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# a BatchNorm layer's moments at the FPN's and heads' width: [2, 256]
BN_MOMENTS = 2 * 256
# the anchor sizes of the JAX tool's RetinaNet-tiny scenario
TINY_ANCHOR_SIZES = [8.0, 16.0, 24.0, 32.0, 48.0]


def write_jobs(jobs: list[dict], work: str) -> None:
    """``work/jobs.json``, which every rank reads."""
    os.makedirs(work, exist_ok=True)
    with open(os.path.join(work, "jobs.json"), "w") as f:
        json.dump(jobs, f)


def launch(jobs: list[dict], world_size: int, work: str, *,
           device: str = "cpu", backend: str | None = None,
           timeout: float = 600.0, env: dict | None = None) -> list[dict]:
    """Run ``jobs`` on ``world_size`` ranks (processes started together,
    waited for together) and return each rank's results, rank 0 first.
    Raises with the ranks' output when one fails or the time runs out."""
    write_jobs(jobs, work)
    init = "file://" + os.path.join(os.path.abspath(work), "rendezvous")
    cmd = [sys.executable, "-m", "detectax_torch.tools.two_process_cpu_test",
           work, "--device", device, "--init_method", init]
    if backend:
        cmd += ["--backend", backend]
    procs = []
    for rank in range(world_size):
        rank_env = dict(os.environ, **(env or {}), RANK=str(rank),
                        WORLD_SIZE=str(world_size), LOCAL_RANK=str(rank))
        rank_env["PYTHONPATH"] = os.pathsep.join(
            p for p in (REPO, rank_env.get("PYTHONPATH")) if p)
        log = open(os.path.join(work, f"rank{rank}.log"), "w")
        procs.append((subprocess.Popen(cmd, cwd=REPO, env=rank_env,
                                       stdout=log, stderr=subprocess.STDOUT),
                      log))
    deadline = time.monotonic() + timeout
    failed = []
    try:
        for rank, (proc, _) in enumerate(procs):
            left = max(deadline - time.monotonic(), 0.1)
            try:
                if proc.wait(timeout=left) != 0:
                    failed.append(f"rank {rank} exited {proc.returncode}")
            except subprocess.TimeoutExpired:
                failed.append(f"rank {rank} ran past {timeout} s")
                break
    finally:
        for proc, log in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
    if failed:
        logs = "".join(
            f"\n--- rank {r} ---\n" + open(os.path.join(
                work, f"rank{r}.log")).read()[-6000:]
            for r in range(world_size))
        raise RuntimeError("; ".join(failed) + logs)
    out = []
    for rank in range(world_size):
        with open(os.path.join(work, f"rank{rank}.json")) as f:
            out.append(json.load(f))
    return out


# --------------------------------------------------------------------------
# what a rank runs
# --------------------------------------------------------------------------

@contextlib.contextmanager
def environment(values: dict):
    """Set environment variables for the block, then restore them."""
    old = {k: os.environ.get(k) for k in values}
    os.environ.update({k: str(v) for k, v in values.items()})
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def build_trainer(job: dict, device: torch.device, dp=None):
    """(model, state, step) of a ``train`` job: FCOS or RetinaNet at
    ``canvas`` px, SGD on ``exponential_with_floor(lr)`` with clip
    ``grad_clip``."""
    m = job["model"]
    dtype = getattr(torch, m.get("dtype", "float32"))
    seed = m.get("seed")
    gen = None if seed is None else torch.Generator().manual_seed(seed)
    canvas, nc = m["canvas"], m["num_classes"]
    family = m.get("family", "fcos")
    if family == "fcos":
        model = FCOS(num_classes=nc, backbone=m["backbone"], dtype=dtype,
                     generator=gen)
        loss = fcos_loss

        def assign_fn(boxes, labels, valid):
            return fcos_assign(boxes, labels, valid,
                               img_dim=(canvas, canvas), num_classes=nc)[0]
    elif family == "retinanet":
        anchors = anchor_shapes_per_level(anchor_sizes=TINY_ANCHOR_SIZES)
        model = RetinaNet(num_classes=nc, n_anchors=anchors[0].shape[0],
                          backbone=m["backbone"], dtype=dtype, generator=gen)
        loss = retinanet_loss

        def assign_fn(boxes, labels, valid):
            return retinanet_assign(
                boxes, labels, valid, img_dim=(canvas, canvas),
                num_classes=nc, anchors_per_level=anchors)[0]
    else:
        raise ValueError(f"unknown family {family!r}")
    if m.get("weights"):
        model.load_state_dict(torch.load(m["weights"], weights_only=True))
    model.to(device)
    opt = make_optimizer(job.get("optimizer", "sgd"),
                         exponential_with_floor(job["lr"]),
                         grad_clip=job.get("grad_clip", 1.0))
    ema_decay = job.get("ema_decay")
    step = make_train_step(
        model, assign_fn,
        functools.partial(loss, kernels=job.get("kernels")), opt,
        microbatch=job.get("microbatch"),
        loss_norm=job.get("loss_norm", "batch"), ema_decay=ema_decay,
        data_parallel=dp)
    return (model, create_train_state(model, None, opt,
                                      ema=ema_decay is not None), step)


def load_batches(path: str) -> list[dict]:
    with np.load(path) as z:
        n = sum(1 for k in z.files if k.startswith("images_"))
        return [{k: z[f"{k}_{i}"] for k in ("images", "boxes", "labels",
                                            "valid")} for i in range(n)]


def run_steps(state, step, batches, device) -> tuple[list, list]:
    """Metrics (host floats) and host ms of each step, each ended by a
    synchronise."""
    metrics, ms = [], []
    for batch in batches:
        batch = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
        _sync(device)
        t0 = time.perf_counter()
        state, m = step(state, batch)
        _sync(device)
        ms.append((time.perf_counter() - t0) * 1e3)
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, ms


def time_collective(call, dp, reps: int) -> float:
    """Host ms of one ``call()`` (a collective over the group), after one
    call outside the timing."""
    call()
    _sync(dp.device)
    t0 = time.perf_counter()
    for _ in range(reps):
        call()
    _sync(dp.device)
    return (time.perf_counter() - t0) * 1e3 / reps


def time_all_reduce(numel: int, dp, reps: int) -> float:
    """Host ms of one all-reduce sum of ``numel`` float32 over the group."""
    t = torch.ones(numel, device=dp.device)
    return time_collective(lambda: mesh._all_reduce_(t, dp), dp, reps)


def time_fsdp_collectives(numel: int, dp, reps: int) -> dict:
    """Host ms of the FSDP step's two flat collectives at ``numel`` float32
    a rank: the all-gather into ``world * numel`` and the reduce-scatter
    out of it."""
    world = dp.world_size
    shard = torch.ones(numel, device=dp.device)
    full = torch.ones(world * numel, device=dp.device)
    return {
        "all_gather": time_collective(
            lambda: torch.distributed.all_gather_into_tensor(
                full, shard, group=dp.group), dp, reps),
        "reduce_scatter": time_collective(
            lambda: torch.distributed.reduce_scatter_tensor(
                shard, full, group=dp.group), dp, reps),
        "shard_floats": numel}


def train_job(job: dict, dp) -> dict:
    device = dp.device
    out: dict = {"device": str(device),
                 "backend": torch.distributed.get_backend(dp.group)}
    with environment(job.get("env", {})):
        global_batches = load_batches(job["batches"])
        if job.get("alone"):
            _, state, step = build_trainer(job, device)
            metrics, ms = run_steps(state, step, global_batches, device)
            out["alone"] = {"metrics": metrics, "step_ms": ms}
            del state, step
        model, state, step = build_trainer(job, device, dp)
        # as `fit` starts (rank 0's state on every rank), then cut
        mesh.shard_train_state(state, dp, fsdp=bool(job.get("fsdp")))
        local = [mesh.shard_batch(b, dp) for b in global_batches]
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        # ---- the counted run: counts set to 0 just before, read just after
        kcommon.reset_launch_counts()
        before = dp.collectives
        metrics, ms = run_steps(state, step, local, device)
        out["launches"] = kcommon.launch_counts()
        out["collectives_per_step"] = (dp.collectives - before) / len(local)
        # ----
        if device.type == "cuda":
            out["peak_allocated_bytes"] = torch.cuda.max_memory_allocated(
                device)
    out.update(metrics=metrics, step_ms=ms, state_bytes=held_bytes(state))
    if state.fsdp is not None:
        out["sharded_leaves"] = len(state.fsdp.sharded)
        out["leaves"] = len(state.fsdp.axes)
    if job.get("save_state"):
        # under FSDP an all-gather, which every rank joins
        sd = state.state_dict()
        torch.save(sd if job["save_state"] == "full" else sd["model"],
                   os.path.join(job["work"], f"{job['name']}_rank{dp.rank}.pt"))
    if job.get("checkpoint"):
        CheckpointManager(job["checkpoint"]).save(state.step, state)
    if job.get("time_all_reduce"):
        n_params = sum(math.prod(s) for s in (
            state.fsdp.shapes if state.fsdp is not None
            else [p.shape for p in model.parameters()]))
        out["allreduce_ms"] = {
            "bn_moments": time_all_reduce(BN_MOMENTS, dp, reps=50),
            "gradient": time_all_reduce(n_params, dp, reps=5),
            "gradient_floats": n_params}
        if state.fsdp is not None:
            sharded = sum(math.prod(state.fsdp.shapes[i])
                          for i in state.fsdp.sharded)
            out["fsdp_collective_ms"] = time_fsdp_collectives(
                sharded // dp.world_size, dp, reps=5)
    return out


def held_bytes(state) -> dict:
    """Bytes this rank holds of the parameters, the optimizer state and the
    EMA, their total, and the bytes of the storage they lie in (equal to
    the total where no leaf is a view of a larger tensor: no full copy of
    a sharded leaf is kept)."""
    parts = {"parameters": [p.data for p in state.model.parameters()],
             "optimizer": [v for per in state.opt.state.values()
                           for v in per.values()
                           if isinstance(v, torch.Tensor)],
             "ema": list((state.ema or {}).values())}
    out = {k: sum(t.numel() * t.element_size() for t in ts)
           for k, ts in parts.items()}
    out["total"] = sum(out.values())
    out["storage"] = sum(t.untyped_storage().nbytes()
                         for ts in parts.values() for t in ts)
    return out


def fit_job(job: dict, dp) -> dict:
    """`cli.train_fcos.main` in this rank, the model it trained kept."""
    from detectax_torch.cli import train_fcos

    trained = []
    real_fit = train_fcos.fit

    def fit(cfg, model, *args, **kwargs):
        trained.append(model)
        return real_fit(cfg, model, *args, **kwargs)

    train_fcos.fit = fit
    try:
        summary = train_fcos.main(job["argv"])
    finally:
        train_fcos.fit = real_fit
    torch.save(trained[0].state_dict(), os.path.join(
        job["work"], f"{job['name']}_rank{dp.rank}.pt"))
    return {"summary": summary}


@contextlib.contextmanager
def record_detections():
    """Patch `cli.evaluate`'s evaluators to keep what each image is given:
    yields the list of ``{"boxes", "scores", "classes"}`` in image
    order."""
    from detectax_torch.cli import evaluate

    seen: list[dict] = []
    real = evaluate.MeanAPEvaluator, evaluate.coco_evaluator

    def recording(make):
        def build(*args, **kwargs):
            ev = make(*args, **kwargs)
            add = ev.add_image

            def add_image(boxes, scores, classes, *rest, **kw):
                seen.append({"boxes": np.array(boxes),
                             "scores": np.array(scores),
                             "classes": np.array(classes)})
                return add(boxes, scores, classes, *rest, **kw)

            ev.add_image = add_image
            return ev
        return build

    evaluate.MeanAPEvaluator = recording(real[0])
    evaluate.coco_evaluator = recording(real[1])
    try:
        yield seen
    finally:
        evaluate.MeanAPEvaluator, evaluate.coco_evaluator = real


def evaluate_job(job: dict, dp) -> dict:
    from detectax_torch.cli import evaluate

    kcommon.reset_launch_counts()
    with record_detections() as seen:
        summary = evaluate.main(job["argv"])
    out = {"summary": summary, "launches": kcommon.launch_counts(),
           "images": len(seen)}
    if dp.lead:
        np.savez(os.path.join(job["work"], f"{job['name']}_dets.npz"),
                 **{f"{k}_{i}": d[k] for i, d in enumerate(seen)
                    for k in d})
    return out


def refuse_job(job: dict, dp) -> dict:
    """What each entry point says to a global batch of ``world + 1``."""
    from detectax_torch.cli import evaluate, train_fcos

    n = dp.world_size + 1
    calls = {
        "shard_batch": lambda: mesh.shard_batch(
            {"images": np.zeros((n, 2, 2, 3), np.float32)}, dp),
        "train_fcos": lambda: train_fcos.main(
            job["train_argv"] + ["--batch_size", str(n)]),
        "evaluate": lambda: evaluate.main(
            job["evaluate_argv"] + ["--batch_size", str(n)]),
        "make_train_step": lambda: build_trainer(
            dict(job["train"], microbatch=n), dp.device, dp),
    }
    said = {}
    for name, call in calls.items():
        try:
            call()
            said[name] = None
        except ValueError as e:
            said[name] = str(e)
    return said


JOBS = {"train": train_job, "fit": fit_job, "evaluate": evaluate_job,
        "refuse": refuse_job}


def main(argv=None) -> None:
    import argparse

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("work")
    p.add_argument("--device", default=None,
                   help="this rank's device (default: cuda:LOCAL_RANK)")
    p.add_argument("--backend", default=None,
                   help="default: nccl on CUDA, gloo on the CPU")
    p.add_argument("--init_method", default=None,
                   help="default: env:// (torchrun's rendezvous)")
    args = p.parse_args(argv)
    dp = mesh.maybe_initialize_distributed(
        args.device, backend=args.backend, init_method=args.init_method)
    if dp is None:
        raise SystemExit("no process group: run under torchrun or launch()")
    set_tf32(False)  # the port's float32 policy, as every entry point's
    with open(os.path.join(args.work, "jobs.json")) as f:
        jobs = json.load(f)
    results = {"rank": dp.rank, "world_size": dp.world_size,
               "built_s": None, "jobs": {}}
    try:
        for job in jobs:
            job = dict(job, work=args.work)
            t0 = time.perf_counter()
            res = JOBS[job["kind"]](job, dp)
            res["wall_s"] = time.perf_counter() - t0
            results["jobs"][job["name"]] = res
            mesh.barrier(dp)
        results["built_s"] = kcommon.build_seconds()
    finally:
        mesh.shutdown(dp)
    with open(os.path.join(args.work, f"rank{results['rank']}.json"),
              "w") as f:
        json.dump(results, f)


if __name__ == "__main__":
    main()
