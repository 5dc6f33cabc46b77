"""Training step with on-device target assignment.

Port of `detectax/train/loop.py`:

  batch (images + padded GT) -> batched assignment -> forward -> loss
  -> gradients -> clip -> optimizer update

all on the model's device, eagerly (no graph compiler is involved, so the
JAX package's `jit`, `donate` and compiler options have no counterpart).

State is held the PyTorch way: `TrainState` owns the module (parameters
and BatchNorm buffers), the torch optimizer (momentum / Adam moments) and
the optional EMA copy, and a step **updates them in place** and returns
the same `TrainState` object; the JAX package returns a new immutable
state instead.

`microbatch` keeps the memory-bounded sub-batch semantics: the batch is
cut into chunks, gradients are accumulated over them, and BatchNorm
running statistics advance chunk by chunk in order.
"""
from __future__ import annotations

import dataclasses
import inspect
from typing import Callable

import numpy as np
import torch
from torch import nn

from detectax_torch.models.layers import init_parameters
from detectax_torch.train.schedules import Optimizer, global_norm


@dataclasses.dataclass
class TrainState:
    step: int
    model: nn.Module
    opt: torch.optim.Optimizer
    # exponential moving average of the parameters by name (None = off)
    ema: dict | None = None

    def state_dict(self) -> dict:
        """Plain tensors and numbers only (what a checkpoint holds)."""
        return {
            "step": int(self.step),
            "model": self.model.state_dict(),
            "opt": self.opt.state_dict(),
            "ema": self.ema,
        }

    def load_state_dict(self, sd: dict) -> None:
        self.model.load_state_dict(sd["model"], strict=True)
        self.opt.load_state_dict(sd["opt"])
        self.step = int(sd["step"])
        if self.ema is not None:
            if sd.get("ema") is None:
                raise ValueError("checkpoint has no EMA parameters, the "
                                 "state to restore expects them")
            with torch.no_grad():
                for k, e in self.ema.items():
                    e.copy_(sd["ema"][k])


def create_train_state(
    model: nn.Module,
    generator: torch.Generator | None,
    optimizer: Optimizer,
    ema: bool = False,
) -> TrainState:
    """Fresh state at step 0. With a ``generator`` the model's weights are
    drawn anew from it (`init_parameters`); with ``None`` they stay as they
    are (a model that was just built or loaded)."""
    if generator is not None:
        init_parameters(model, generator)
    return TrainState(
        step=0,
        model=model,
        opt=optimizer.bind(model.parameters()),
        ema=({k: p.detach().clone() for k, p in model.named_parameters()}
             if ema else None),
    )


def _to_device(v, device) -> torch.Tensor:
    if isinstance(v, np.ndarray):
        v = torch.from_numpy(v)
    return v.to(device)


def normalize_images(images: torch.Tensor, mode: str | None) -> torch.Tensor:
    """On-device pixel normalization: the host ships uint8 (a quarter of
    the bytes) and the division happens here."""
    x = images.to(torch.float32)
    if mode == "tf":
        return x / 127.5 - 1.0
    if mode == "unit":
        return x / 255.0
    return x


def make_train_step(
    model: nn.Module,
    assign_fn: Callable,
    loss_fn: Callable,
    optimizer: Optimizer,
    microbatch: int | None = None,
    normalize: str | None = None,
    loss_norm: str = "batch",
    ema_decay: float | None = None,
):
    """Build the train step.

    Args:
      assign_fn: ``(boxes[B,N,4], labels[B,N], valid[B,N]) -> y_true`` for
        a whole padded batch (one target map, or a tuple of them), or with a fourth
        argument ``img_hw`` taken from the batch's image shape.
      loss_fn: ``(y_true, y_pred) -> dict`` with a "total" entry
        (per-example-sum; divided by batch size here).
      microbatch: if set, split the batch into chunks of this size and
        accumulate gradients over them.
      normalize: "tf" / "unit" when the batch carries uint8 images.
      loss_norm: "batch" divides the summed losses by batch size; "pos"
        divides by the batch's positive-cell count and needs a loss_fn
        that returns "num_pos". With microbatching, chunk sums are
        accumulated unnormalized and divided once by the batch's global
        positive count, so gradients match the unsplit step however
        unevenly positives fall across chunks.

    Returns ``step(state, batch) -> (state, metrics)`` where batch is a
    dict of ``images [B,H,W,3]``, ``boxes [B,N,4]``, ``labels [B,N]``,
    ``valid [B,N]`` (tensors or numpy arrays; moved to the model's device)
    and metrics are 0-dim tensors on that device. ``grad_norm`` is the
    global norm before the clip.
    """
    if loss_norm not in ("batch", "pos"):
        raise ValueError(f"unknown loss_norm {loss_norm!r}")
    assign_takes_hw = len(inspect.signature(assign_fn).parameters) >= 4
    params = list(model.parameters())

    def forward_grads(images, y_true, batch_size, raw):
        preds = model(images, train=True)
        losses = dict(loss_fn(y_true, preds))
        if not raw:
            if loss_norm == "pos":
                denom = torch.clamp_min(losses["num_pos"], 1.0)
            else:
                denom = batch_size
            num_pos = losses.pop("num_pos", None)
            losses = {k: v / denom for k, v in losses.items()}
            if num_pos is not None:
                losses["num_pos"] = num_pos
        grads = torch.autograd.grad(losses["total"], params,
                                    allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(params, grads)]
        return grads, {k: torch.as_tensor(v).detach()
                       for k, v in losses.items()}

    def step(state: TrainState, batch):
        if state.model is not model:
            raise ValueError("the state holds another model than the one "
                             "this step was built for")
        device = params[0].device
        images = _to_device(batch["images"], device)
        if normalize is not None:
            images = normalize_images(images, normalize)
        bsz = images.shape[0]
        gt = [_to_device(batch[k], device)
              for k in ("boxes", "labels", "valid")]
        with torch.no_grad():
            if assign_takes_hw:
                y_true = assign_fn(*gt, (images.shape[1], images.shape[2]))
            else:
                y_true = assign_fn(*gt)

        if microbatch is None or microbatch >= bsz:
            grads, losses = forward_grads(images, y_true, float(bsz), False)
        else:
            if bsz % microbatch:
                raise ValueError("batch must divide by microbatch")
            raw = loss_norm == "pos"
            grads, losses = None, None
            for lo in range(0, bsz, microbatch):
                sl = slice(lo, lo + microbatch)
                # one target map (a tensor) or one a level (a sequence)
                chunk = (y_true[sl] if isinstance(y_true, torch.Tensor)
                         else tuple(t[sl] for t in y_true))
                g, l = forward_grads(images[sl], chunk, float(bsz), raw)
                grads = g if grads is None else [
                    a + b for a, b in zip(grads, g)]
                losses = l if losses is None else {
                    k: losses[k] + l[k] for k in l}
            if raw:
                # chunks accumulated *unnormalized*; divide once by the
                # batch's global positive count
                num_pos = losses.pop("num_pos")
                inv = 1.0 / torch.clamp_min(num_pos, 1.0)
                grads = [g * inv for g in grads]
                losses = {k: v * inv for k, v in losses.items()}
                losses["num_pos"] = num_pos

        metrics = dict(losses)
        metrics["grad_norm"] = global_norm(grads)
        optimizer.update(state.opt, grads, state.step,
                         grad_norm=metrics["grad_norm"])
        if ema_decay is not None and state.ema is not None:
            with torch.no_grad():
                for k, p in model.named_parameters():
                    state.ema[k].mul_(ema_decay).add_(
                        p, alpha=1.0 - ema_decay)
        state.step += 1
        return state, metrics

    return step


def make_eval_forward(model: nn.Module):
    """Inference forward (train=False, running BN statistics), without
    autograd."""

    @torch.no_grad()
    def forward(images):
        device = next(model.parameters()).device
        return model(_to_device(images, device), train=False)

    return forward
