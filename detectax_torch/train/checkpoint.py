"""Checkpoint / resume over `torch.save`.

Port of `detectax/train/checkpoint.py` with the same interface and
semantics: a rolling checkpoint of ``{step, model, opt, ema}`` (the
`TrainState.state_dict`) with ``max_to_keep`` retention, saved on a step
cadence; `restore_latest` resumes so step counting continues. A file holds
plain tensors and numbers only and is read back with
``torch.load(weights_only=True)``. It is written under a temporary name
and renamed, so a reader never finds half a file. Saves are synchronous;
`wait` is kept for the interface. In a data-parallel run rank 0 alone
saves (`train.driver.fit`), and the file is the one a single-process run
writes: it holds nothing of the group and restores without one. Under
FSDP (`parallel.mesh.shard_train_state(..., fsdp=True)`) every rank calls
`save`, which all-gathers the state, and rank 0 alone writes the same
file; `restore_latest` gives each rank its slices of it (the counterpart
of Orbax saving and restoring sharded leaves).
"""
from __future__ import annotations

import os
import re

import torch

_NAME = re.compile(r"^ckpt_(\d+)\.pt$")


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 1):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = int(max_to_keep)
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{int(step)}.pt")

    def all_steps(self) -> list[int]:
        return sorted(int(m.group(1)) for m in
                      map(_NAME.match, os.listdir(self.directory)) if m)

    def save(self, step: int, state) -> None:
        """Write ``state.state_dict()`` as the checkpoint of ``step`` and
        drop the oldest ones beyond ``max_to_keep``. Under FSDP every rank
        calls it (the state dict is all-gathered) and rank 0 writes."""
        sd = state.state_dict()
        fsdp = getattr(state, "fsdp", None)
        if fsdp is not None and not fsdp.dp.lead:
            return
        path = self._path(step)
        tmp = f"{path}.{os.getpid()}.tmp"
        try:
            torch.save(sd, tmp)
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
        steps = self.all_steps()
        for old in steps[:max(len(steps) - self.max_to_keep, 0)]:
            os.remove(self._path(old))

    def wait(self) -> None:
        """Saves are synchronous: nothing is pending."""

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _load(self, step: int, device) -> dict:
        return torch.load(self._path(step), map_location=device,
                          weights_only=True)

    def restore_latest(self, state):
        """Load the newest checkpoint into ``state`` (model, optimizer,
        step, EMA), in place. Returns (state, step) or None when no
        checkpoint exists."""
        step = self.latest_step()
        if step is None:
            return None
        device = next(state.model.parameters()).device
        state.load_state_dict(self._load(step, device))
        return state, step

    def restore_params(self, model: torch.nn.Module, use_ema: bool = False):
        """Load only parameters and BatchNorm statistics into ``model``.

        For inference: ignores the optimizer state entirely, so a
        checkpoint loads whatever optimizer trained it. With
        ``use_ema=True`` the EMA-averaged weights take the parameters'
        place. Returns (model, step) or None when no checkpoint exists."""
        step = self.latest_step()
        if step is None:
            return None
        device = next(model.parameters()).device
        sd = self._load(step, device)
        weights = dict(sd["model"])
        if use_ema:
            if sd.get("ema") is None:
                raise ValueError(
                    "checkpoint has no EMA parameters — train with "
                    "--ema_decay")
            weights.update(sd["ema"])
        model.load_state_dict(weights, strict=True)
        return model, step
