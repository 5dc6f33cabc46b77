"""Data parallelism over processes: one process a card under `torchrun`
(NCCL), or gloo processes on the CPU.

Port of `detectax/parallel/mesh.py`. The JAX package jits its step over a
one-axis mesh with the batch sharded on it, and XLA then takes three sums
over the **global** batch: BatchNorm's statistics, the loss denominators
(the batch size and ``num_pos``) and the gradient. Here each process holds
its rows of the global batch and a replica of the state, and the step asks
for the same three sums itself:

- `models.layers.BatchNorm(train=True)` all-reduces its per-channel
  moments while `batch_stats_over` holds a group (`make_train_step` enters
  it), through `all_reduce_sum`, whose backward is itself an all-reduce
  sum;
- `train.loop.make_train_step(data_parallel=dp)` divides by the global
  batch or the all-reduced ``num_pos``, and all-reduces the gradients as
  one flat buffer.

`DistributedDataParallel` would do neither of the first two, and it would
never see these gradients: the step takes them with `torch.autograd.grad`,
which fires none of its hooks.

Every rank holds the same number of rows (`shard_batch` and the sharded
`Loader` cut them so). The JAX package's FSDP (`fsdp_param_spec`,
`shard_train_state(fsdp=True)`) is not ported.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import os
from typing import Callable

import torch
import torch.distributed as dist

from detectax_torch.runtime import resolve_device

# torchrun's environment: a process started without it runs alone
TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK")


@dataclasses.dataclass
class DataParallel:
    """This process's place in a data-parallel group.

    ``collectives`` counts the collectives issued through this object (a
    train step's are BatchNorm's all-reduces forward and backward, the
    gradient's and the logged losses')."""
    rank: int
    world_size: int
    device: torch.device
    group: dist.ProcessGroup | None = None
    # True where `maybe_initialize_distributed` created the group, which
    # `shutdown` then destroys
    owns_group: bool = False
    collectives: int = 0

    @property
    def lead(self) -> bool:
        return self.rank == 0


def _rank_device(device) -> torch.device:
    """The caller's device, else ``cuda:LOCAL_RANK``; never the CPU unless
    named (`runtime.resolve_device` raises without CUDA)."""
    if device is None:
        local = os.environ.get("LOCAL_RANK", os.environ.get("RANK", "0"))
        device = f"cuda:{int(local)}"
    return resolve_device(device)


def maybe_initialize_distributed(device=None, backend: str | None = None,
                                 init_method: str | None = None
                                 ) -> DataParallel | None:
    """The group this process belongs to, or None when it runs alone.

    A group that is already initialized is described as it is. Otherwise
    one is initialized when torchrun's environment (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``) is set, even at world size 1, with
    ``init_method`` (default ``env://``, torchrun's rendezvous). The
    backend is NCCL on a CUDA device and gloo on the CPU unless
    ``backend`` names one (gloo lets ranks share one card, which NCCL
    refuses). Each rank's device is ``device``, else ``cuda:LOCAL_RANK``.
    """
    owns = False
    if not dist.is_initialized():
        if any(k not in os.environ for k in TORCHRUN_ENV):
            return None
        dev = _rank_device(device)
        backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(
            backend, init_method=init_method or "env://",
            rank=int(os.environ["RANK"]),
            world_size=int(os.environ["WORLD_SIZE"]),
            **({"device_id": dev} if backend == "nccl" else {}))
        owns = True
    else:
        dev = _rank_device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
    return DataParallel(rank=dist.get_rank(), world_size=dist.get_world_size(),
                        device=dev, group=dist.group.WORLD, owns_group=owns)


def shutdown(dp: DataParallel | None) -> None:
    """Destroy the group where `maybe_initialize_distributed` created it."""
    if dp is not None and dp.owns_group and dist.is_initialized():
        dist.destroy_process_group()
        dp.owns_group = False


def barrier(dp: DataParallel | None) -> None:
    if dp is None:
        return
    if dist.get_backend(dp.group) == "nccl":
        dist.barrier(dp.group, device_ids=[dp.device.index])
    else:
        dist.barrier(dp.group)
    dp.collectives += 1


def local_rows(global_rows: int, dp: DataParallel | None) -> int:
    """Rows a rank holds of a global batch; refuses one that does not
    divide by the world size."""
    if dp is None:
        return global_rows
    if global_rows % dp.world_size:
        raise ValueError(
            f"a global batch of {global_rows} does not divide by the "
            f"world size {dp.world_size}")
    return global_rows // dp.world_size


def shard_batch(batch: dict, dp: DataParallel | None) -> dict:
    """This rank's contiguous rows of a global batch: rank ``r`` of ``W``
    takes rows ``[r·B/W, (r+1)·B/W)``, the rank-major order in which
    `jax.make_array_from_process_local_data` assembles a global array."""
    if dp is None:
        return batch
    per = local_rows(len(next(iter(batch.values()))), dp)
    lo = dp.rank * per
    return {k: v[lo:lo + per] for k, v in batch.items()}


def _all_reduce_(t: torch.Tensor, dp: DataParallel) -> torch.Tensor:
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=dp.group)
    dp.collectives += 1
    return t


def _broadcast_(t: torch.Tensor, dp: DataParallel) -> None:
    buf = t if t.device == dp.device else t.to(dp.device)
    dist.broadcast(buf, src=0, group=dp.group)
    dp.collectives += 1
    if buf is not t:
        t.copy_(buf)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dp):
        ctx.dp = dp
        return _all_reduce_(x.clone(memory_format=torch.contiguous_format), dp)

    @staticmethod
    def backward(ctx, grad):
        # every rank's loss reads the sum, so each input's gradient is the
        # sum over ranks of the gradient at the output
        return _all_reduce_(
            grad.clone(memory_format=torch.contiguous_format), ctx.dp), None


def all_reduce_sum(x: torch.Tensor, dp: DataParallel) -> torch.Tensor:
    """The sum of ``x`` over the group, differentiable: the backward is an
    all-reduce sum too. Every rank must call it in the same order."""
    return _AllReduceSum.apply(x, dp)


def all_reduce_flat(tensors: list[torch.Tensor], dp: DataParallel
                    ) -> list[torch.Tensor]:
    """Sums over the group of same-dtype tensors, by one all-reduce of
    their concatenation."""
    flat = _all_reduce_(torch.cat([t.reshape(-1) for t in tensors]), dp)
    return [part.view_as(t) for part, t in
            zip(torch.split(flat, [t.numel() for t in tensors]), tensors)]


def all_reduce_scalars(values: dict, dp: DataParallel) -> dict:
    """Sums over the group of 0-dim tensors, by one float32 all-reduce;
    each keeps its dtype."""
    keys = list(values)
    summed = all_reduce_flat(
        [torch.as_tensor(values[k]).to(torch.float32) for k in keys], dp)
    return {k: s.to(torch.as_tensor(values[k]).dtype)
            for k, s in zip(keys, summed)}


def _state_tensors(state):
    yield from state.model.parameters()
    yield from state.model.buffers()
    for group in state.opt.param_groups:
        for p in group["params"]:
            per_param = state.opt.state.get(p, {})
            for key in sorted(per_param):
                if isinstance(per_param[key], torch.Tensor):
                    yield per_param[key]
    if state.ema is not None:
        for key in sorted(state.ema):
            yield state.ema[key]


@torch.no_grad()
def replicate_state(state, dp: DataParallel | None):
    """Rank 0's parameters, buffers, optimizer state, EMA and step on every
    rank, in place (the counterpart of ``shard_train_state(...,
    fsdp=False)``). Returns ``state``."""
    if dp is None:
        return state
    for t in _state_tensors(state):
        _broadcast_(t, dp)
    step = torch.tensor([int(state.step)], device=dp.device)
    _broadcast_(step, dp)
    state.step = int(step)
    return state


_STATS_GROUP: contextvars.ContextVar = contextvars.ContextVar(
    "detectax_torch_batch_stats_group", default=None)


@contextlib.contextmanager
def batch_stats_over(dp: DataParallel | None):
    """While active, `BatchNorm(train=True)` takes its statistics over the
    group's global batch (``dp=None``: over the rows it is given)."""
    token = _STATS_GROUP.set(dp)
    try:
        yield
    finally:
        _STATS_GROUP.reset(token)


def batch_stats_group() -> DataParallel | None:
    return _STATS_GROUP.get()


def _all_gather_rows(t: torch.Tensor, dp: DataParallel) -> torch.Tensor:
    # collectives take no bool: gathered as bytes
    src = (t.to(torch.uint8) if t.dtype == torch.bool else t).contiguous()
    parts = [torch.empty_like(src) for _ in range(dp.world_size)]
    dist.all_gather(parts, src, group=dp.group)
    dp.collectives += 1
    out = torch.cat(parts)
    return out.to(torch.bool) if t.dtype == torch.bool else out


def make_sharded_eval_fn(eval_fn: Callable, dp: DataParallel | None
                         ) -> Callable:
    """Batch-sharded inference for the eval and serving path.

    ``eval_fn(images) -> dict of [B, ...] tensors`` (forward + decode +
    NMS, the model held by the closure). Each rank runs it on its rows of
    the global batch, and the ranks all-gather the detection dict, so
    every rank returns the whole batch's. The batch must divide by the
    world size, as on the JAX mesh."""
    if dp is None:
        return eval_fn

    def sharded(images: torch.Tensor) -> dict:
        per = local_rows(images.shape[0], dp)
        out = eval_fn(images[dp.rank * per:(dp.rank + 1) * per])
        return {k: _all_gather_rows(v, dp) for k, v in out.items()}

    return sharded
