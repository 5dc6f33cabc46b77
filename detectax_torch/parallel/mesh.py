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
`Loader` cut them so).

FSDP, the JAX package's ``shard_train_state(fsdp=True)``: `shard_train_state`
keeps on each rank one slice of every parameter of ``2**16`` elements or
more, cut on the axis `fsdp_param_spec` picks (the JAX rule, applied in
Flax's layout), and the same slice of its optimizer state and EMA; small
leaves and BatchNorm statistics stay replicated. The train step then
all-gathers the full parameters before the forward (`all_gather_leaves`,
one flat collective), reduce-scatters the gradient of the sharded leaves
(`reduce_scatter_leaves`) and all-reduces the replicated ones, takes the
group's global norm, updates the slices and frees the full parameters
(`Fsdp`, which `train.loop.make_train_step` drives). Between steps a rank
holds ``replicated + sharded / N`` bytes of state and no full copy of a
sharded leaf.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
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


# --------------------------------------------------------------------------
# FSDP: sharded parameters, optimizer state and EMA
# --------------------------------------------------------------------------

FSDP_MIN_SIZE = 2**16
# a torch conv kernel is OIHW, a Flax one HWIO (`tools.from_flax` takes
# the transpose (3, 2, 0, 1)): Flax's axis f is torch's axis _FLAX_AXES[f]
_FLAX_AXES = {4: (2, 3, 1, 0)}


def fsdp_param_spec(shape, world_size: int,
                    min_size: int = FSDP_MIN_SIZE) -> int | None:
    """The axis (torch's layout) on which FSDP shards a leaf of ``shape``
    over ``world_size`` ranks, or None to replicate it: the JAX package's
    rule (`detectax/parallel/mesh.py::fsdp_param_spec`) in Flax's layout,
    under ``min_size`` elements replicated, else the largest axis that
    divides by the world size, ties to the first axis in Flax's order."""
    shape = tuple(int(d) for d in shape)
    if math.prod(shape) < min_size:
        return None
    to_torch = _FLAX_AXES.get(len(shape), tuple(range(len(shape))))
    flax_shape = [shape[t] for t in to_torch]
    # sorted() is stable: equal sizes keep Flax's order, as in JAX
    for f in sorted(range(len(shape)), key=lambda f: -flax_shape[f]):
        if flax_shape[f] % world_size == 0:
            return to_torch[f]
    return None


def _slice(t: torch.Tensor, axis: int, dp: DataParallel) -> torch.Tensor:
    """This rank's slice of ``t`` on ``axis``, in storage of its own."""
    k = t.shape[axis] // dp.world_size
    return t.narrow(axis, dp.rank * k, k).clone(
        memory_format=torch.contiguous_format)


def _flat_dtype(tensors) -> torch.dtype:
    dtypes = {t.dtype for t in tensors}
    if len(dtypes) != 1:
        raise ValueError(f"FSDP leaves of several dtypes: {dtypes}")
    return dtypes.pop()


def all_gather_leaves(shards: list[torch.Tensor], axes: list[int],
                      dp: DataParallel) -> list[torch.Tensor]:
    """The full tensors whose slice ``dp.rank`` on ``axes[i]`` this rank
    holds as ``shards[i]``, by ONE all-gather of the shards' flat
    concatenation (one dtype). Every rank gets the same bits."""
    if not shards:
        return []
    world = dp.world_size
    flat = torch.cat([t.reshape(-1) for t in shards])
    out = torch.empty(world * flat.numel(), dtype=_flat_dtype(shards),
                      device=flat.device)
    dist.all_gather_into_tensor(out, flat, group=dp.group)
    dp.collectives += 1
    by_rank = out.view(world, flat.numel())
    fulls, lo = [], 0
    for t, axis in zip(shards, axes):
        part = by_rank[:, lo:lo + t.numel()].reshape(world, *t.shape)
        lo += t.numel()
        # rank r's slice lands at [r·k, (r+1)·k) of the axis
        full_shape = list(t.shape)
        full_shape[axis] *= world
        fulls.append(part.movedim(0, axis).reshape(full_shape))
    return fulls


def reduce_scatter_leaves(fulls: list[torch.Tensor], axes: list[int],
                          dp: DataParallel) -> list[torch.Tensor]:
    """This rank's slice on ``axes[i]`` of the sum over the group of each
    ``fulls[i]``, by ONE reduce-scatter of a flat buffer (one dtype) whose
    block ``r`` holds every leaf's slice ``r``."""
    if not fulls:
        return []
    world = dp.world_size
    blocks, shapes = [], []
    for t, axis in zip(fulls, axes):
        k = t.shape[axis] // world
        split = (*t.shape[:axis], world, k, *t.shape[axis + 1:])
        blocks.append(t.reshape(split).movedim(axis, 0).reshape(world, -1))
        shapes.append((*t.shape[:axis], k, *t.shape[axis + 1:]))
    flat = torch.cat(blocks, dim=1)
    out = torch.empty(flat.shape[1], dtype=_flat_dtype(fulls),
                      device=flat.device)
    dist.reduce_scatter_tensor(out, flat.reshape(-1), op=dist.ReduceOp.SUM,
                               group=dp.group)
    dp.collectives += 1
    return [part.view(shape) for part, shape in zip(
        torch.split(out, [math.prod(s) for s in shapes]), shapes)]


@dataclasses.dataclass
class Fsdp:
    """The FSDP layout of a `TrainState` on this rank: ``axes[i]`` is the
    axis on which ``params[i]`` (the model's parameters in order) is
    sharded, or None where it is replicated; ``shapes[i]`` its full
    shape. Made by `shard_train_state(..., fsdp=True)`."""
    dp: DataParallel
    params: list[torch.nn.Parameter]
    axes: list[int | None]
    shapes: list[torch.Size]

    @property
    def sharded(self) -> list[int]:
        return [i for i, a in enumerate(self.axes) if a is not None]

    def gather(self) -> list[torch.Tensor]:
        """Swap each sharded parameter's data for the full tensor (one
        all-gather); returns the slices, which `release` puts back. The
        `Parameter` objects stay the same."""
        idx = self.sharded
        slices = [self.params[i].data for i in idx]
        fulls = all_gather_leaves(slices, [self.axes[i] for i in idx],
                                  self.dp)
        for i, full in zip(idx, fulls):
            self.params[i].data = full
        return slices

    def release(self, slices: list[torch.Tensor]) -> None:
        """Put the slices back in place of the full parameters, which are
        then freed."""
        for i, t in zip(self.sharded, slices):
            self.params[i].data = t

    def reduce_gradients(self, grads: list[torch.Tensor]
                         ) -> list[torch.Tensor]:
        """Sums over the group of full gradients: this rank's slice for a
        sharded parameter (one reduce-scatter), the whole gradient for a
        replicated one (one all-reduce)."""
        idx = self.sharded
        out = list(grads)
        for i, g in zip(idx, reduce_scatter_leaves(
                [grads[i] for i in idx], [self.axes[i] for i in idx],
                self.dp)):
            out[i] = g
        rep = [i for i, a in enumerate(self.axes) if a is None]
        if rep:
            for i, g in zip(rep, all_reduce_flat([grads[i] for i in rep],
                                                 self.dp)):
                out[i] = g
        return out

    def global_norm(self, grads: list[torch.Tensor]) -> torch.Tensor:
        """The group's global norm of the gradients `reduce_gradients`
        gave: the squares of this rank's slices summed over the group (one
        all-reduce), plus those of the replicated gradients, which every
        rank holds whole."""
        def squares(ids):
            return sum((torch.sum(torch.square(grads[i].to(torch.float32)))
                        for i in ids),
                       torch.zeros((), device=grads[0].device))
        sharded = squares(self.sharded)
        sharded = _all_reduce_(sharded.reshape(1), self.dp).reshape(())
        rep = [i for i, a in enumerate(self.axes) if a is None]
        return torch.sqrt(sharded + squares(rep))

    # -- the state around the parameters: optimizer state and EMA ----------

    def _leaves(self, state) -> list[tuple[int, object, object]]:
        """(parameter index, container, key) of every sharded leaf of
        ``state``, in a fixed order: the parameter (container None, key
        the `Parameter`), each optimizer-state tensor of its shape
        (momentum, Adam's moments) and its EMA."""
        names = {id(p): n for n, p in state.model.named_parameters()}
        out = []
        for i in self.sharded:
            p = self.params[i]
            out.append((i, None, p))
            per = state.opt.state.get(p, {})
            out += [(i, per, key) for key in sorted(per)
                    if isinstance(per[key], torch.Tensor) and per[key].ndim]
            if state.ema is not None:
                out.append((i, state.ema, names[id(p)]))
        return out

    def full_state_dict(self, state) -> dict:
        """``state.state_dict()`` of the single process: every sharded leaf
        all-gathered (one all-gather). Every rank must call it."""
        leaves = self._leaves(state)
        fulls = all_gather_leaves(
            [key.data if box is None else box[key] for _, box, key in leaves],
            [self.axes[i] for i, _, _ in leaves], self.dp)
        names = [n for n, _ in state.model.named_parameters()]
        model = state.model.state_dict()
        opt = state.opt.state_dict()
        # the optimizer's state_dict numbers its parameters in order and
        # shares its per-parameter dicts: copied before they are changed
        opt = dict(opt, state={i: dict(per)
                               for i, per in opt["state"].items()})
        ema = None if state.ema is None else dict(state.ema)
        for (i, box, key), full in zip(leaves, fulls):
            if box is None:
                model[names[i]] = full
            elif box is state.ema:
                ema[key] = full
            else:
                opt["state"][i][key] = full
        return {"step": int(state.step), "model": model, "opt": opt,
                "ema": ema}

    def slice_state_dict(self, sd: dict, state) -> dict:
        """This rank's slices of a single-process ``state.state_dict()``,
        each in storage of its own."""
        names = {n: i for i, (n, _) in enumerate(
            state.model.named_parameters())}
        axis_of_name = {n: self.axes[i] for n, i in names.items()}
        model = {k: (v if axis_of_name.get(k) is None
                     else _slice(v, axis_of_name[k], self.dp))
                 for k, v in sd["model"].items()}
        opt = sd["opt"]
        # the optimizer's state_dict numbers its parameters in order
        opt = dict(opt, state={
            i: {k: (_slice(v, self.axes[int(i)], self.dp)
                    if self.axes[int(i)] is not None
                    and isinstance(v, torch.Tensor)
                    and tuple(v.shape) == tuple(self.shapes[int(i)])
                    else v) for k, v in per.items()}
            for i, per in opt["state"].items()})
        ema = sd.get("ema")
        if ema is not None:
            ema = {k: (v if axis_of_name.get(k) is None
                       else _slice(v, axis_of_name[k], self.dp))
                   for k, v in ema.items()}
        return dict(sd, model=model, opt=opt, ema=ema)


@torch.no_grad()
def shard_train_state(state, dp: DataParallel | None, fsdp: bool = False):
    """Place a `TrainState` on the group, in place: replicated
    (`replicate_state`), or with ``fsdp=True`` rank 0's state replicated
    and then cut, each rank keeping its slice of every leaf that
    `fsdp_param_spec` shards (parameter, optimizer state, EMA) and setting
    ``state.fsdp``. Without a group the state stays as it is. Returns
    ``state``."""
    state = replicate_state(state, dp)
    if dp is None or not fsdp:
        return state
    params = list(state.model.parameters())
    opt_params = [p for g in state.opt.param_groups for p in g["params"]]
    if [id(p) for p in opt_params] != [id(p) for p in params]:
        raise ValueError("the optimizer must hold the model's parameters "
                         "in the model's order")
    layout = Fsdp(dp=dp, params=params,
                  axes=[fsdp_param_spec(p.shape, dp.world_size)
                        for p in params],
                  shapes=[p.shape for p in params])
    for i, box, key in layout._leaves(state):
        axis = layout.axes[i]
        if box is None:
            key.data = _slice(key.data, axis, dp)
        else:
            box[key] = _slice(box[key], axis, dp)
    state.fsdp = layout
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
