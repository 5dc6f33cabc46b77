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

A whole training state crosses over as well: `load_train_state` fills a
`detectax_torch.train.loop.TrainState` from the JAX package's
(``params``, ``batch_stats``, optax ``opt_state``, ``step``,
``ema_params``) turned into numpy, and `opt_to_flax` / `ema_to_flax` give
the optimizer's moments and the EMA back as Flax-shaped trees, so two
runs can be compared leaf by leaf.

The port's own weights file is numpy-only: an ``.npz`` keyed by the Flax
path (``params/ResNet_0/stem/Conv_0/kernel``), written by `save_npz` and
read by `load_npz`. A file written from the JAX package (its trees turned
into numpy) is read by the port without JAX. The JAX package's own
weights files — Flax ``.msgpack``, such as a ported or crop-pretrained
trunk — are read by `load_msgpack`, a decoder of the subset of MessagePack
that `flax.serialization` writes, with no `flax` or `msgpack` package.
"""
from __future__ import annotations

import struct
from typing import Mapping

import numpy as np
import torch

# the names Flax gives a trunk inside a detector (the ``flax_name`` of
# `models.backbones.ResNet`, `MobileNetV2` and `TinyBackbone`), written
# out so that reading a weights file imports no model code
BACKBONE_FLAX_NAMES = ("ResNet_0", "MobileNetV2_0", "TinyBackbone_0")

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


def to_flax(model: torch.nn.Module, tensors: Mapping | None = None
            ) -> tuple[dict, dict]:
    """Inverse of `from_flax`: the model's ``state_dict`` as the two Flax
    trees (nested dicts of numpy arrays). ``tensors``, when given, takes
    the ``state_dict``'s place: any mapping from its names to tensors of
    the same shapes (optimizer moments, EMA parameters)."""
    backbone_name = getattr(getattr(model, "backbone", None),
                            "flax_name", None)
    params: dict = {}
    batch_stats: dict = {}
    items = model.state_dict() if tensors is None else tensors
    for key, value in items.items():
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
        # a copy: the trees must not move when the model trains on
        tree[name] = np.array(arr, order="C")
    return params, batch_stats


def _optax_fields(opt_state) -> dict:
    """The named fields (``trace``, ``mu``, ``nu``, ``count``) of an optax
    state, found by walking its nested tuples: every optax state is a
    (named) tuple, so this needs no import of optax. A plain dict with
    those keys is taken as it is."""
    if isinstance(opt_state, Mapping):
        return dict(opt_state)
    found: dict = {}

    def walk(node):
        for name in getattr(node, "_fields", ()):
            value = getattr(node, name)
            if name in ("trace", "mu", "nu", "count"):
                found.setdefault(name, value)
            else:
                walk(value)
        if isinstance(node, (tuple, list)) and not hasattr(node, "_fields"):
            for child in node:
                walk(child)

    walk(opt_state)
    return found


def load_train_state(state, params: Mapping,
                     batch_stats: Mapping | None = None, *,
                     opt_state=None, step: int = 0,
                     ema_params: Mapping | None = None):
    """Fill a `TrainState` from the JAX package's training state.

    ``opt_state`` is the optax state with numpy leaves (or a dict of its
    fields): SGD's momentum ``trace`` becomes the torch optimizer's
    ``momentum_buffer``; Adam's ``mu`` / ``nu`` / ``count`` become
    ``exp_avg`` / ``exp_avg_sq`` / ``step``. ``ema_params`` needs a state
    created with ``ema=True``."""
    model = state.model
    load_flax(model, params, batch_stats)
    state.step = int(step)
    named = dict(model.named_parameters())

    def as_param_tensors(tree):
        sd = from_flax(tree)
        if set(sd) != set(named):
            odd = sorted(set(sd) ^ set(named))
            raise KeyError(f"tree does not match the model's parameters: "
                           f"{odd[:8]} ({len(odd)} in all)")
        return {k: v.to(named[k].device) for k, v in sd.items()}

    fields = _optax_fields(opt_state) if opt_state is not None else {}
    state.opt.state.clear()
    if "trace" in fields:
        for k, v in as_param_tensors(fields["trace"]).items():
            state.opt.state[named[k]]["momentum_buffer"] = v
    elif "mu" in fields:
        mu = as_param_tensors(fields["mu"])
        nu = as_param_tensors(fields["nu"])
        count = float(np.asarray(fields["count"]))
        for k, p in named.items():
            state.opt.state[p].update(
                step=torch.tensor(count), exp_avg=mu[k], exp_avg_sq=nu[k])
    elif opt_state is not None:
        raise KeyError("opt_state holds neither a momentum trace nor Adam "
                       f"moments (found {sorted(fields)})")
    if ema_params is not None:
        if state.ema is None:
            raise ValueError("the state was created without EMA")
        state.ema = as_param_tensors(ema_params)
    return state


def opt_to_flax(state) -> dict:
    """The torch optimizer's moments as Flax-shaped trees:
    ``{"trace": tree}`` for SGD-momentum, ``{"mu", "nu", "count"}`` for
    Adam / AdamW."""
    names = {"momentum_buffer": "trace", "exp_avg": "mu", "exp_avg_sq": "nu"}
    per_field: dict = {}
    count = None
    for k, p in state.model.named_parameters():
        for name, value in state.opt.state.get(p, {}).items():
            if name == "step":
                count = int(value)
            elif name in names and value is not None:
                per_field.setdefault(names[name], {})[k] = value
    out = {f: to_flax(state.model, t)[0] for f, t in per_field.items()}
    if count is not None:
        out["count"] = count
    return out


def ema_to_flax(state) -> dict:
    """The EMA parameters as a Flax ``params`` tree."""
    if state.ema is None:
        raise ValueError("the state holds no EMA parameters")
    return to_flax(state.model, state.ema)[0]


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


# ---------------------------------------------------------------------------
# Flax .msgpack
# ---------------------------------------------------------------------------

# the extension types `flax.serialization` gives numpy values
_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3


class _MsgpackReader:
    """Decoder of the MessagePack that `flax.serialization.msgpack_serialize`
    writes: maps, arrays, strings, binaries, nil, booleans, ints and
    floats, and its extension types for numpy arrays (1) and numpy scalars
    (3), each a packed ``(shape, dtype name, C-order bytes)``. Anything
    else raises."""

    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("msgpack data ends inside a value")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(">" + fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self):
        b = self.unpack("B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.value() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return str(self.take(b & 0x1F), "utf-8")
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        sized = {0xC4: "B", 0xC5: "H", 0xC6: "I"}       # bin
        if b in sized:
            return bytes(self.take(self.unpack(sized[b])))
        sized = {0xD9: "B", 0xDA: "H", 0xDB: "I"}       # str
        if b in sized:
            return str(self.take(self.unpack(sized[b])), "utf-8")
        sized = {0xC7: "B", 0xC8: "H", 0xC9: "I"}       # ext
        if b in sized:
            n = self.unpack(sized[b])
            return self.ext(self.unpack("b"), self.take(n))
        if 0xD4 <= b <= 0xD8:                          # fixext
            code = self.unpack("b")
            return self.ext(code, self.take(1 << (b - 0xD4)))
        numbers = {0xCA: "f", 0xCB: "d", 0xCC: "B", 0xCD: "H", 0xCE: "I",
                   0xCF: "Q", 0xD0: "b", 0xD1: "h", 0xD2: "i", 0xD3: "q"}
        if b in numbers:
            return self.unpack(numbers[b])
        if b in (0xDC, 0xDD):
            n = self.unpack("H" if b == 0xDC else "I")
            return [self.value() for _ in range(n)]
        if b in (0xDE, 0xDF):
            return self.map(self.unpack("H" if b == 0xDE else "I"))
        raise ValueError(f"msgpack type byte 0x{b:02x} is not one that "
                         "flax.serialization writes")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out

    def ext(self, code: int, payload: memoryview):
        if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
            raise ValueError(f"msgpack extension type {code} is not one "
                             "that this reader decodes")
        shape, dtype, buf = _MsgpackReader(payload).value()
        try:
            dtype = np.dtype(dtype)
        except TypeError as e:
            raise ValueError(f"array of dtype {dtype!r}: not a numpy "
                             "dtype") from e
        arr = np.frombuffer(buf, dtype=dtype).reshape(shape)
        # a scalar travels as a 0-d array
        return arr if code == _EXT_NDARRAY else arr[()]


def read_msgpack(path: str):
    """The tree a Flax ``.msgpack`` file holds (nested dicts of numpy
    arrays and Python scalars), as `flax.serialization.msgpack_restore`
    would give it."""
    with open(path, "rb") as f:
        reader = _MsgpackReader(f.read())
    tree = reader.value()
    if reader.pos != len(reader.data):
        raise ValueError(f"{path}: {len(reader.data) - reader.pos} bytes "
                         "follow the first msgpack value")
    return tree


def load_msgpack(path: str) -> tuple[dict, dict]:
    """(params, batch_stats) of a Flax ``.msgpack`` weights file holding
    the two trees under those names, as the JAX package writes them."""
    tree = read_msgpack(path)
    if not isinstance(tree, dict) or "params" not in tree:
        raise KeyError(f"{path}: no 'params' tree at the top level")
    return tree["params"], tree.get("batch_stats", {})


def load_weights(path: str) -> tuple[dict, dict]:
    """(params, batch_stats) from the port's ``.npz`` or a Flax
    ``.msgpack``, by the file's extension."""
    if path.endswith(".msgpack"):
        return load_msgpack(path)
    return load_npz(path)
