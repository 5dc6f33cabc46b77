"""The training run shared by the CLI trainers (`fit`).

Port of `detectax/train/driver.py`: host loader → train step →
console/CSV metrics → checkpoint cadence. Resume restores both the
checkpoint and the metrics history. Batches are copied to the device one
step ahead on a side stream from pinned host memory, so the copy overlaps
the previous step's compute.

Under `torchrun` (``torchrun --nproc_per_node N -m
detectax_torch.cli.train_fcos ...``) the run is data-parallel, one process
a card (`parallel.mesh`): ``batch_size`` stays the **global** batch, as
for the JAX package's one process over a mesh, and each rank's `Loader`
takes ``batch_size / N`` rows of its own share of the data. Rank 0 alone
prints, logs, profiles, calls the eval hook and writes the checkpoint,
which is the file a single-process run writes.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable

import numpy as np
import torch

from detectax_torch.parallel import mesh
from detectax_torch.runtime import resolve_device, set_tf32
from detectax_torch.tools.from_flax import (
    BACKBONE_FLAX_NAMES,
    from_flax,
    load_weights,
)
from detectax_torch.train.checkpoint import CheckpointManager
from detectax_torch.train.loop import (
    TrainState,
    create_train_state,
    make_eval_forward,
    make_train_step,
)
from detectax_torch.train.metrics import (
    MetricsLogger,
    ThroughputMeter,
    format_console,
)
from detectax_torch.train.schedules import (
    make_optimizer,
    make_schedule,
    with_warmup,
)


@dataclasses.dataclass
class TrainConfig:
    # data
    index: str | None = None          # dataset index json (None -> synthetic)
    batch_size: int = 16
    canvas: int = 384
    max_boxes: int = 64
    jitter: tuple[float, float] | None = None
    jitter_per_batch: bool = False
    pad_position: str = "topleft"
    augment: str = "none"
    normalize: str = "tf"
    resize_mode: str = "resize_pad"
    # optimization
    max_steps: int = 1000
    optimizer: str = "sgd"
    schedule: str = "exponential"
    schedule_kwargs: dict = dataclasses.field(
        default_factory=lambda: {"init_lr": 5e-4}
    )
    grad_clip: float = 1.0
    weight_decay: float = 0.0
    microbatch: int | None = None
    # "batch" (divide by batch size) or "pos" (normalize by positive
    # cells — FCOS-paper convention, needed from scratch)
    loss_norm: str = "batch"
    warmup_steps: int = 0
    # EMA of params (0 = off); the averaged weights live in state.ema
    ema_decay: float = 0.0
    # observability
    ckpt_dir: str = "ckpt"
    display_step: int = 50
    step_save: int = 500
    max_to_keep: int = 1
    resume: bool = False
    out_dir: str = "outputs"
    # the CLIs pass an eval hook that draws on display steps
    dump_visuals: bool = False
    seed: int = 0
    # debugging / tracing
    profile_steps: tuple[int, int] | None = None  # (start, stop) step range
    debug_nans: bool = False
    # ship uint8 batches and normalize on-device (4x less H2D traffic)
    device_normalize: bool = True
    # backbone weights to load into the fresh state before training: the
    # port's .npz (`tools.from_flax.save_npz`) or a Flax .msgpack
    init_backbone: str | None = None
    # torch device; None means CUDA, and there is no CPU fallback
    device: str | None = None


def build_loader(cfg: TrainConfig, dataset,
                 dp: mesh.DataParallel | None = None):
    """The run's loader; under data parallelism this rank's: ``batch_size
    / world`` rows a step of its share of the data (``num_hosts=world``,
    ``host_id=rank``)."""
    from detectax_torch.data.pipeline import Loader

    return Loader(
        dataset,
        batch_size=mesh.local_rows(cfg.batch_size, dp),
        canvas=cfg.canvas,
        max_boxes=cfg.max_boxes,
        mode=cfg.resize_mode,
        pad_position=cfg.pad_position,
        augment=cfg.augment,
        jitter=cfg.jitter,
        jitter_per_batch=cfg.jitter_per_batch,
        normalize=cfg.normalize,
        emit_uint8=cfg.device_normalize,
        seed=cfg.seed,
        num_hosts=1 if dp is None else dp.world_size,
        host_id=0 if dp is None else dp.rank,
        steps=cfg.max_steps,
    )


def _device_prefetch(loader, device: torch.device):
    """Yield (device_batch, host_batch) pairs, each copied to the device
    while the step before it runs: from pinned host memory on a side
    stream, handed to the compute stream through an event."""
    if device.type != "cuda":
        for batch in loader:
            yield {k: torch.from_numpy(v) for k, v in batch.items()}, batch
        return
    side = torch.cuda.Stream(device)

    def put(batch):
        with torch.cuda.stream(side):
            db = {k: torch.from_numpy(v).pin_memory().to(
                      device, non_blocking=True)
                  for k, v in batch.items()}
        done = torch.cuda.Event()
        done.record(side)
        return db, done, batch

    pending = None
    for batch in loader:
        ahead = put(batch)
        if pending is not None:
            yield _hand_over(pending)
        pending = ahead
    if pending is not None:
        yield _hand_over(pending)


def _hand_over(item):
    db, done, batch = item
    current = torch.cuda.current_stream()
    current.wait_event(done)
    for t in db.values():
        t.record_stream(current)
    return db, batch


def load_backbone_weights(state: TrainState, path: str) -> TrainState:
    """Load backbone weights from the port's ``.npz`` or a Flax
    ``.msgpack`` (the JAX package's ported or crop-pretrained trunks) into
    a fresh state: replaces the backbone's parameters and BatchNorm
    statistics, leaving FPN and heads at their fresh init. The file holds
    either the trunk's own trees or a whole detector's (the trunk under its
    Flax name)."""
    params, batch_stats = load_weights(path)
    for name in BACKBONE_FLAX_NAMES:
        if name in params:
            params, batch_stats = params[name], batch_stats.get(name, {})
            break
    flax_name = state.model.backbone.flax_name
    loaded = from_flax({flax_name: params}, {flax_name: batch_stats})
    want = {k: v for k, v in state.model.state_dict().items()
            if k.startswith("backbone.")}
    if set(loaded) != set(want):
        odd = sorted(set(loaded) ^ set(want))
        raise KeyError(f"{path}: backbone entries do not match the model's: "
                       f"{odd[:8]} ({len(odd)} in all)")
    for k, v in loaded.items():
        if tuple(v.shape) != tuple(want[k].shape):
            raise ValueError(f"{path}: {k} has shape {tuple(v.shape)}, the "
                             f"model wants {tuple(want[k].shape)}")
    state.model.load_state_dict(loaded, strict=False)
    print(f"initialized backbone {flax_name} from {path}")
    return state


def fit(
    cfg: TrainConfig,
    model: torch.nn.Module,
    dataset,
    assign_fn: Callable,
    loss_fn: Callable,
    *,
    eval_hook: Callable | None = None,
) -> dict:
    """Run training; returns the final metrics summary.

    ``eval_hook(step=, state=, forward=, batch=, out_dir=)`` is called on
    display steps with the host batch (pixels normalized) and ``forward``,
    the model's eval-mode forward without autograd
    (`train.loop.make_eval_forward`).

    Starts with `parallel.mesh.maybe_initialize_distributed`: under
    torchrun's environment (or in a group already initialized) the run is
    data-parallel over the group, each rank on ``cfg.device`` or
    ``cuda:LOCAL_RANK``; a group created here is destroyed at the end."""
    dp = mesh.maybe_initialize_distributed(cfg.device)
    try:
        return _fit(cfg, model, dataset, assign_fn, loss_fn, eval_hook, dp)
    finally:
        mesh.shutdown(dp)


def _fit(cfg, model, dataset, assign_fn, loss_fn, eval_hook, dp) -> dict:
    device = resolve_device(cfg.device) if dp is None else dp.device
    lead = dp is None or dp.lead
    # refused before any collective, so that every rank raises
    mesh.local_rows(cfg.batch_size, dp)
    set_tf32(False)
    os.makedirs(cfg.out_dir, exist_ok=True)
    schedule = make_schedule(cfg.schedule, **cfg.schedule_kwargs)
    if cfg.warmup_steps:
        schedule = with_warmup(schedule, cfg.warmup_steps)
    optimizer = make_optimizer(
        cfg.optimizer, schedule,
        grad_clip=cfg.grad_clip, weight_decay=cfg.weight_decay,
    )

    model.to(device)
    state = create_train_state(
        model, torch.Generator().manual_seed(cfg.seed), optimizer,
        ema=cfg.ema_decay > 0.0,
    )
    if cfg.init_backbone:
        state = load_backbone_weights(state, cfg.init_backbone)
    step_fn = make_train_step(
        model, assign_fn, loss_fn, optimizer, microbatch=cfg.microbatch,
        normalize=cfg.normalize if cfg.device_normalize else None,
        loss_norm=cfg.loss_norm,
        ema_decay=cfg.ema_decay or None, data_parallel=dp,
    )

    ckpt = CheckpointManager(cfg.ckpt_dir, max_to_keep=cfg.max_to_keep)
    logger = MetricsLogger(
        csv_path=os.path.join(cfg.out_dir, "losses.csv"),
        jsonl_path=os.path.join(cfg.out_dir, "metrics.jsonl"),
    )
    start_step = 0
    if cfg.resume:
        restored = ckpt.restore_latest(state)
        if restored is not None:
            state, start_step = restored
            print(f"resumed from checkpoint at step {start_step}")
        else:
            print("no checkpoint found; starting fresh")
    # the ranks start from rank 0's state (init, backbone and resume alike)
    state = mesh.replicate_state(state, dp)

    loader = build_loader(cfg, dataset, dp)
    meter = ThroughputMeter()
    meter.start()
    eval_fwd = make_eval_forward(model) if eval_hook else None

    step = start_step
    last_metrics: dict = {}
    profiler = None
    t_start = time.time()
    with torch.autograd.set_detect_anomaly(cfg.debug_nans):
        try:
            for device_batch, batch in _device_prefetch(loader, device):
                if step >= cfg.max_steps:
                    break
                if (lead and cfg.profile_steps
                        and step == cfg.profile_steps[0]):
                    profiler = _start_profiler(device)
                state, metrics = step_fn(state, device_batch)
                meter.update(cfg.batch_size)
                step += 1
                if profiler is not None and step == cfg.profile_steps[1]:
                    # force completion so the trace holds real device work
                    _ = float(metrics["total"])
                    _stop_profiler(profiler, cfg.out_dir)
                    profiler = None

                if step % cfg.display_step == 0 or step == cfg.max_steps:
                    # the metrics are the global step's on every rank
                    metrics_host = {k: float(v) for k, v in metrics.items()}
                    metrics_host["images_per_sec"] = meter.reset()
                    last_metrics = metrics_host
                    if lead:
                        print(format_console(step, float(schedule(step)),
                                             metrics_host))
                        logger.log(step, metrics_host)
                    if lead and eval_hook is not None:
                        hook_batch = batch
                        if cfg.device_normalize:
                            from detectax_torch.data.pipeline import (
                                normalize_pixels,
                            )

                            hook_batch = dict(batch)
                            hook_batch["images"] = normalize_pixels(
                                batch["images"].astype(np.float32),
                                cfg.normalize)
                        eval_hook(step=step, state=state, forward=eval_fwd,
                                  batch=hook_batch, out_dir=cfg.out_dir)

                if step % cfg.step_save == 0 or step == cfg.max_steps:
                    if lead:
                        ckpt.save(step, state)
                        logger.flush_csv()
                    mesh.barrier(dp)
        finally:
            if profiler is not None:
                _stop_profiler(profiler, cfg.out_dir)

    ckpt.wait()
    if lead:
        logger.flush_csv()
    elapsed = time.time() - t_start
    summary = {
        "final_step": step,
        "elapsed_sec": elapsed,
        "images_per_sec": (step - start_step) * cfg.batch_size
        / max(elapsed, 1e-9),
        **last_metrics,
    }
    if lead:
        print(f"done: {summary['final_step']} steps in {elapsed / 60:.1f} "
              f"min ({summary['images_per_sec']:.1f} img/s)")
    return summary


def _start_profiler(device: torch.device):
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    profiler = torch.profiler.profile(activities=activities)
    profiler.__enter__()
    return profiler


def _stop_profiler(profiler, out_dir: str) -> None:
    profiler.__exit__(None, None, None)
    trace_dir = os.path.join(out_dir, "profile")
    os.makedirs(trace_dir, exist_ok=True)
    profiler.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
    print(f"profile trace written to {trace_dir}")


def restore_for_inference(
    ckpt_dir: str, model: torch.nn.Module, use_ema: bool = False,
) -> torch.nn.Module:
    """Load the latest checkpoint's parameters and BatchNorm statistics
    into ``model`` (on the device it lies on) and return it in eval mode.

    The optimizer state is ignored, so any trainer's checkpoint loads.
    ``use_ema=True`` loads the EMA-averaged weights instead of the raw
    parameters."""
    restored = CheckpointManager(ckpt_dir).restore_params(
        model, use_ema=use_ema)
    if restored is None:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    model, step = restored
    print(f"restored checkpoint at step {step}")
    return model.eval()
