"""Learning-rate schedules and the clip + optimizer chain.

Port of `detectax/train/schedules.py` without `optax`. A schedule is a
plain function of the update count (from 0) that returns a Python float:

* `exponential_with_floor` — ``max(init * rate^(step/decay_steps), min_lr)``;
* `piecewise_constant` — step drops at boundaries;
* `epoch_decay` — ``init * decay^floor(step/steps_per_epoch)``;
* constant and cosine through `make_schedule`; `with_warmup` on top;
* `warmup_cosine_decay` — optax's `warmup_cosine_decay_schedule`, which
  crop pretraining (`detectax_torch.bench.pretrain_backbone`) takes.

`make_optimizer` builds an `Optimizer`: global-norm clip, then decayed
weights added to the clipped gradient, then SGD-momentum / Adam / AdamW
from `torch.optim` with the learning rate set from the schedule before
each update. The torch optimizers compute what optax's do:

* SGD: ``trace = g + momentum·trace``, ``p -= lr·trace`` (no dampening, no
  Nesterov) — optax's `trace` then `scale_by_learning_rate`;
* Adam / AdamW: bias-corrected moments and ``eps`` added to
  ``sqrt(v̂)`` outside the root, b1 0.9, b2 0.999, eps 1e-8 in both
  libraries (optax's `eps_root` is 0); AdamW's decoupled decay is
  ``p -= lr·wd·p`` with optax's default ``wd = 1e-4`` (torch's default is
  1e-2, so it is set).
"""
from __future__ import annotations

import math
from typing import Callable, Iterable, Sequence

import torch

Schedule = Callable[[int], float]


def exponential_with_floor(
    init_lr: float,
    decay_rate: float = 0.75,
    decay_steps: int = 1000,
    min_lr: float = 1e-5,
) -> Schedule:
    def schedule(step):
        return max(init_lr * decay_rate ** (step / decay_steps), min_lr)

    return schedule


def piecewise_constant(
    init_lr: float,
    boundaries: Sequence[int],
    scales: Sequence[float],
) -> Schedule:
    """lr = init_lr * prod(scales[i] for boundaries[i] <= step)."""
    pairs = [(int(b), float(s)) for b, s in zip(boundaries, scales)]

    def schedule(step):
        lr = init_lr
        for b, s in pairs:
            if step >= b:
                lr *= s
        return lr

    return schedule


def epoch_decay(init_lr: float, decay: float,
                steps_per_epoch: int) -> Schedule:
    def schedule(step):
        return init_lr * decay ** math.floor(step / steps_per_epoch)

    return schedule


def constant(init_lr: float) -> Schedule:
    return lambda step: init_lr


def cosine_decay(init_lr: float, decay_steps: int,
                 alpha: float = 0.01) -> Schedule:
    """Cosine decay to ``alpha * init_lr`` over ``decay_steps``."""
    def schedule(step):
        frac = min(step, decay_steps) / decay_steps
        cosine = 0.5 * (1.0 + math.cos(math.pi * frac))
        return init_lr * ((1.0 - alpha) * cosine + alpha)

    return schedule


def with_warmup(schedule: Schedule, warmup_steps: int) -> Schedule:
    """Linear LR warmup over the first `warmup_steps` steps."""
    if warmup_steps <= 0:
        return schedule

    def s(step):
        return schedule(step) * min((step + 1) / warmup_steps, 1.0)

    return s


def warmup_cosine_decay(init_value: float, peak_value: float,
                        warmup_steps: int, decay_steps: int,
                        end_value: float = 0.0) -> Schedule:
    """optax's `warmup_cosine_decay_schedule`: from ``init_value`` at count
    0 linearly to ``peak_value`` at ``warmup_steps``, then a cosine over
    the ``decay_steps - warmup_steps`` counts after it down to
    ``end_value``, held there. Not `with_warmup` over `cosine_decay`: that
    one starts at ``peak / warmup_steps`` and decays over the whole span."""
    span = decay_steps - warmup_steps
    if span <= 0:
        raise ValueError(f"decay_steps ({decay_steps}) must exceed "
                         f"warmup_steps ({warmup_steps})")
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value

    def schedule(step):
        if step < warmup_steps:
            frac = 1.0 - max(step, 0) / warmup_steps
            return (init_value - peak_value) * frac + peak_value
        count = min(step - warmup_steps, span)
        cosine = 0.5 * (1.0 + math.cos(math.pi * count / span))
        return peak_value * ((1.0 - alpha) * cosine + alpha)

    return schedule


def make_schedule(kind: str, **kwargs) -> Schedule:
    if kind == "exponential":
        return exponential_with_floor(**kwargs)
    if kind == "piecewise":
        return piecewise_constant(**kwargs)
    if kind == "epoch":
        return epoch_decay(**kwargs)
    if kind == "constant":
        return constant(kwargs["init_lr"])
    if kind == "cosine":
        return cosine_decay(kwargs["init_lr"],
                            decay_steps=kwargs["decay_steps"],
                            alpha=kwargs.get("alpha", 0.01))
    raise ValueError(f"unknown schedule kind {kind!r}")


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares over all tensors (float32 scalar)."""
    return torch.sqrt(sum(torch.sum(torch.square(t.to(torch.float32)))
                          for t in tensors))


def clip_by_global_norm(grads: Sequence[torch.Tensor], max_norm: float,
                        norm: torch.Tensor | None = None
                        ) -> list[torch.Tensor]:
    """optax's rule: unchanged when ``norm < max_norm``, else
    ``g · max_norm / norm``. (`torch.nn.utils.clip_grad_norm_` divides by
    ``norm + 1e-6`` and so differs.) Decided on the device, no host
    round trip. ``norm`` is `global_norm(grads)` where the caller has it
    already."""
    if norm is None:
        norm = global_norm(grads)
    scale = torch.where(norm < max_norm, torch.ones_like(norm),
                        max_norm / norm)
    return [g * scale for g in grads]


_ADAMW_WEIGHT_DECAY = 1e-4  # optax.adamw's default


class Optimizer:
    """Clip → add decayed weights → torch optimizer at the schedule's rate.

    `bind(params)` makes the torch optimizer over a model's parameters;
    `update(torch_opt, grads, step)` applies one update from explicit
    gradients, with ``step`` the count of updates made so far
    (``grad_norm``: their global norm, where the caller has computed it)."""

    def __init__(self, name: str, schedule: Schedule, grad_clip: float,
                 momentum: float, weight_decay: float):
        if name not in ("sgd", "adam", "adamw"):
            raise ValueError(f"unknown optimizer {name!r}")
        self.name = name
        self.schedule = schedule
        self.grad_clip = float(grad_clip)
        self.momentum = float(momentum)
        self.weight_decay = float(weight_decay)

    def bind(self, params: Iterable[torch.nn.Parameter]):
        params = list(params)
        lr = self.schedule(0)
        if self.name == "sgd":
            return torch.optim.SGD(params, lr=lr, momentum=self.momentum)
        if self.name == "adam":
            return torch.optim.Adam(params, lr=lr)
        return torch.optim.AdamW(params, lr=lr,
                                 weight_decay=_ADAMW_WEIGHT_DECAY)

    @torch.no_grad()
    def update(self, torch_opt: torch.optim.Optimizer,
               grads: Sequence[torch.Tensor], step: int,
               grad_norm: torch.Tensor | None = None) -> None:
        params = [p for g in torch_opt.param_groups for p in g["params"]]
        if len(params) != len(grads):
            raise ValueError(f"{len(grads)} gradients for {len(params)} "
                             "parameters")
        grads = clip_by_global_norm(grads, self.grad_clip, grad_norm)
        if self.weight_decay > 0.0:
            grads = [g + self.weight_decay * p for g, p in zip(grads, params)]
        lr = self.schedule(step)
        for group in torch_opt.param_groups:
            group["lr"] = lr
        for p, g in zip(params, grads):
            p.grad = g
        torch_opt.step()
        for p in params:
            p.grad = None


def make_optimizer(
    name: str,
    schedule: Schedule,
    grad_clip: float = 1.0,
    momentum: float = 0.9,
    weight_decay: float = 0.0,
) -> Optimizer:
    """Grad-clip + optimizer chain: `clip_by_global_norm(grad_clip)`, then
    optional L2 weight decay added to the clipped gradient, then
    SGD(momentum) / Adam / AdamW."""
    return Optimizer(name, schedule, grad_clip, momentum, weight_decay)
