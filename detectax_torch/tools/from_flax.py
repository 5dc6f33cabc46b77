"""Weights between the Flax parameter trees and the port's ``state_dict``.

`from_flax(params, batch_stats)` takes the two Flax trees of a detectax
detector as nested dicts of numpy arrays and returns a ``state_dict`` for
the port's module of the same configuration. The port's modules name their
sub-modules after the Flax tree ("stem", "stage2_block0", "Conv_0",
"BatchNorm_0", "fpn/c3_1x1", "cls_tower/layer_1", "reg_head_1", ...), so
the mapping is mechanical:

* path ``a/b/c`` → key ``a.b.c``; the trunk's auto-name (``ResNet_0``,
  ``MobileNetV2_0``, ``TinyBackbone_0``) → ``backbone``;
* conv ``kernel`` HWIO → ``weight`` OIHW (grouped and depthwise kernels are
  ``[kh, kw, in/groups, out]`` in Flax and ``[out, in/groups, kh, kw]`` in
  torch: the same transpose);
* BatchNorm ``scale``/``bias`` → ``weight``/``bias``; ``batch_stats``
  ``mean``/``var`` → ``running_mean``/``running_var``.

Any leaf it does not know how to place is an error, and so is — when the
target ``model`` is given — any parameter or buffer of the model that the
trees did not fill, or filled with another shape.

The port's own weights file is numpy-only: an ``.npz`` keyed by the Flax
path (``params/ResNet_0/stem/Conv_0/kernel``), written by `save_npz` and
read by `load_npz`. A file written from the JAX package (its trees turned
into numpy) is read by the port without JAX.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from detectax_torch.models.backbones import (
    MobileNetV2,
    ResNet,
    TinyBackbone,
)

# the names Flax gives a trunk inside a detector
BACKBONE_FLAX_NAMES = tuple(
    cls.flax_name for cls in (ResNet, MobileNetV2, TinyBackbone)
)

_PARAM_LEAVES = {"kernel": "weight", "bias": "bias", "scale": "weight"}
_STAT_LEAVES = {"mean": "running_mean", "var": "running_var"}


def _flatten(tree: Mapping, prefix: tuple = ()):
    for name, value in tree.items():
        if isinstance(value, Mapping):
            yield from _flatten(value, prefix + (str(name),))
        else:
            yield prefix + (str(name),), np.asarray(value)


def _torch_key(path: tuple, leaf_names: Mapping[str, str]) -> str:
    *mods, leaf = path
    if leaf not in leaf_names:
        raise KeyError(
            f"unknown leaf {leaf!r} at {'/'.join(path)} "
            f"(known: {sorted(leaf_names)})"
        )
    if mods and mods[0] in BACKBONE_FLAX_NAMES:
        mods[0] = "backbone"
    return ".".join([*mods, leaf_names[leaf]])


def from_flax(params: Mapping, batch_stats: Mapping | None = None,
              model: torch.nn.Module | None = None) -> dict:
    """``state_dict`` (torch tensors) from Flax ``params``/``batch_stats``.

    With ``model`` given, the result is checked against it: every key must
    exist there with the same shape, and every parameter and buffer of the
    model must have been filled.
    """
    out: dict[str, torch.Tensor] = {}
    for path, value in _flatten(params):
        key = _torch_key(path, _PARAM_LEAVES)
        if path[-1] == "kernel":
            if value.ndim != 4:
                raise ValueError(
                    f"{'/'.join(path)}: expected an HWIO conv kernel, got "
                    f"shape {value.shape}"
                )
            value = value.transpose(3, 2, 0, 1)
        if key in out:
            raise KeyError(f"{'/'.join(path)} maps onto {key} twice")
        out[key] = torch.from_numpy(np.array(value, order="C"))
    for path, value in _flatten(batch_stats or {}):
        key = _torch_key(path, _STAT_LEAVES)
        if key in out:
            raise KeyError(f"{'/'.join(path)} maps onto {key} twice")
        out[key] = torch.from_numpy(np.array(value, order="C"))
    if model is not None:
        want = model.state_dict()
        unknown = sorted(set(out) - set(want))
        missing = sorted(set(want) - set(out))
        if unknown:
            raise KeyError(f"Flax keys with no place in the model: "
                           f"{unknown[:8]} ({len(unknown)} in all)")
        if missing:
            raise KeyError(f"model entries the Flax trees did not fill: "
                           f"{missing[:8]} ({len(missing)} in all)")
        for key, value in out.items():
            if tuple(value.shape) != tuple(want[key].shape):
                raise ValueError(
                    f"{key}: Flax gives shape {tuple(value.shape)}, the "
                    f"model wants {tuple(want[key].shape)}"
                )
    return out


def load_flax(model: torch.nn.Module, params: Mapping,
              batch_stats: Mapping | None = None) -> torch.nn.Module:
    """Fill ``model`` from the Flax trees (strict both ways)."""
    model.load_state_dict(from_flax(params, batch_stats, model), strict=True)
    return model


def to_flax(model: torch.nn.Module) -> tuple[dict, dict]:
    """Inverse of `from_flax`: the model's ``state_dict`` as the two Flax
    trees (nested dicts of numpy arrays)."""
    backbone_name = getattr(getattr(model, "backbone", None),
                            "flax_name", None)
    params: dict = {}
    batch_stats: dict = {}
    for key, value in model.state_dict().items():
        *mods, leaf = key.split(".")
        if mods and mods[0] == "backbone" and backbone_name:
            mods[0] = backbone_name
        arr = value.detach().cpu().numpy()
        if leaf in ("running_mean", "running_var"):
            tree, name = batch_stats, leaf[len("running_"):]
        elif leaf == "weight":
            tree = params
            if arr.ndim == 4:
                name, arr = "kernel", arr.transpose(2, 3, 1, 0)
            else:
                name = "scale"
        elif leaf == "bias":
            tree, name = params, "bias"
        else:
            raise KeyError(f"state_dict entry {key} has no Flax counterpart")
        for m in mods:
            tree = tree.setdefault(m, {})
        tree[name] = np.ascontiguousarray(arr)
    return params, batch_stats


def save_npz(path: str, params: Mapping, batch_stats: Mapping | None = None):
    """Write the two trees as one ``.npz`` keyed by the Flax path."""
    flat = {}
    for top, tree in (("params", params), ("batch_stats", batch_stats or {})):
        for p, value in _flatten(tree, (top,)):
            flat["/".join(p)] = value
    with open(path, "wb") as f:
        np.savez(f, **flat)


def load_npz(path: str) -> tuple[dict, dict]:
    """Read a file written by `save_npz` back into (params, batch_stats)."""
    trees: dict = {"params": {}, "batch_stats": {}}
    with np.load(path, allow_pickle=False) as data:
        for key in data.files:
            top, *mods, leaf = key.split("/")
            if top not in trees:
                raise KeyError(f"{path}: unexpected top-level key {top!r}")
            tree = trees[top]
            for m in mods:
                tree = tree.setdefault(m, {})
            tree[leaf] = data[key]
    return trees["params"], trees["batch_stats"]
