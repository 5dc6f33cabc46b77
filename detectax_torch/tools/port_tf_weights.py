"""One-way Keras / torchvision -> detectax backbone weight port.

Port of `detectax/tools/port_tf_weights.py`, with the same mappings. The
reference leans on ImageNet-pretrained Keras backbones
(`FCOS/fcos.py:30-41`); this is an optional tool for mAP-parity
experiments. Given a Keras ResNet-50/101/152 (e.g.
``tf.keras.applications.ResNet50``), `port_resnet` maps its weights onto
the trunk ``resnet50:keras`` (`models.backbones.ResNet(keras_compat=True)`:
stride on the first 1x1, ZeroPadding stem, conv biases, BN eps 1.001e-5);
`port_mobilenetv2` maps a Keras MobileNetV2 onto ``mobilenetv2``; and
`port_torch_resnext` maps a torchvision-layout ResNeXt state dict onto
``resnext50:torch`` / ``resnext101:torch``. Each returns the trunk's Flax
trees ``{"params", "batch_stats"}`` as numpy.

The output file is the port's ``.npz`` keyed by the Flax path
(`tools.from_flax.save_npz`), which `from_flax.load_npz` and the
trainers' ``--init_backbone`` read. The JAX package writes Flax msgpack
instead; writing msgpack needs Flax, which the port does not import, so
`save_ported` / `load_ported` write and read the ``.npz``. TensorFlow is
imported inside `main` only: the mappings take a model that is already
built.

Usage:
    python -m detectax_torch.tools.port_tf_weights \
        --arch resnet50 --weights /path/to/keras.h5 --output backbone.npz
    python -m detectax_torch.tools.port_tf_weights \
        --arch resnext50 --weights resnext50_32x4d.pth --output backbone.npz
Load with `load_ported(path)`, or train with ``--init_backbone
backbone.npz --backbone resnet50:keras``.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from detectax_torch.tools.from_flax import load_npz, save_npz

STAGE_SIZES = {
    "resnet50": (3, 4, 6, 3),
    "resnet101": (3, 4, 23, 3),
    "resnet152": (3, 8, 36, 3),
}


def _conv_bn(keras_model, conv_name, bn_name):
    conv = keras_model.get_layer(conv_name)
    bn = keras_model.get_layer(bn_name)
    kernel, bias = conv.get_weights()
    gamma, beta, mean, var = bn.get_weights()
    params = {
        "Conv_0": {
            "kernel": np.asarray(kernel, np.float32),
            "bias": np.asarray(bias, np.float32),
        },
        "BatchNorm_0": {
            "scale": np.asarray(gamma, np.float32),
            "bias": np.asarray(beta, np.float32),
        },
    }
    stats = {
        "BatchNorm_0": {
            "mean": np.asarray(mean, np.float32),
            "var": np.asarray(var, np.float32),
        }
    }
    return params, stats


def port_resnet(keras_model, arch: str = "resnet50"):
    """Return ``{"params": ..., "batch_stats": ...}`` for
    ``ResNet(stage_sizes=STAGE_SIZES[arch], keras_compat=True)``."""
    stage_sizes = STAGE_SIZES[arch]
    params: dict = {}
    stats: dict = {}

    params["stem"], stats["stem"] = _conv_bn(
        keras_model, "conv1_conv", "conv1_bn"
    )

    for stage_idx, n_blocks in enumerate(stage_sizes):
        ks = stage_idx + 2  # keras conv2..conv5
        for blk in range(n_blocks):
            kb = blk + 1
            name = f"stage{ks}_block{blk}"
            block_p: dict = {}
            block_s: dict = {}
            if blk == 0:
                block_p["proj"], block_s["proj"] = _conv_bn(
                    keras_model,
                    f"conv{ks}_block{kb}_0_conv",
                    f"conv{ks}_block{kb}_0_bn",
                )
            for i in range(3):
                sub = f"ConvBN_{i}"
                block_p[sub], block_s[sub] = _conv_bn(
                    keras_model,
                    f"conv{ks}_block{kb}_{i + 1}_conv",
                    f"conv{ks}_block{kb}_{i + 1}_bn",
                )
            params[name] = block_p
            stats[name] = block_s
    return {"params": params, "batch_stats": stats}


def _conv_bn_nobias(keras_model, conv_name, bn_name, depthwise=False):
    """Keras no-bias conv (+BN) -> our ConvBN / depthwise Conv params."""
    conv = keras_model.get_layer(conv_name)
    bn = keras_model.get_layer(bn_name)
    (kernel,) = conv.get_weights()
    if depthwise:
        # Keras DepthwiseConv2D kernel is (kh, kw, C, 1); flax grouped
        # Conv with feature_group_count=C expects (kh, kw, 1, C)
        kernel = np.transpose(kernel, (0, 1, 3, 2))
    gamma, beta, mean, var = bn.get_weights()
    params = {"kernel": np.asarray(kernel, np.float32)}
    bn_params = {
        "scale": np.asarray(gamma, np.float32),
        "bias": np.asarray(beta, np.float32),
    }
    bn_stats = {
        "mean": np.asarray(mean, np.float32),
        "var": np.asarray(var, np.float32),
    }
    return params, bn_params, bn_stats


MBV2_GROUPS = ((1, 1), (6, 2), (6, 3), (6, 4), (6, 3), (6, 3), (6, 1))


def port_mobilenetv2(keras_model):
    """Return ``{"params", "batch_stats"}`` for
    `detectax_torch.models.backbones.MobileNetV2` (default bn_eps=1e-3
    matches Keras) from ``tf.keras.applications.MobileNetV2`` — the
    reference's FCOS inference backbone (`FCOS/infer_fcos.py:126-150`,
    `FCOS/fcos.py:37-41`)."""

    def convbn(conv_name, bn_name):
        p, bnp, bns = _conv_bn_nobias(keras_model, conv_name, bn_name)
        return (
            {"Conv_0": p, "BatchNorm_0": bnp},
            {"BatchNorm_0": bns},
        )

    params: dict = {}
    stats: dict = {}
    params["stem"], stats["stem"] = convbn("Conv1", "bn_Conv1")

    kblock = 0
    for gi, (_exp, reps) in enumerate(MBV2_GROUPS):
        for r in range(reps):
            prefix = (
                "expanded_conv" if kblock == 0 else f"block_{kblock}"
            )
            bp: dict = {}
            bs: dict = {}
            if kblock != 0:
                bp["expand"], ex_s = convbn(
                    f"{prefix}_expand", f"{prefix}_expand_BN"
                )
                bs["expand"] = ex_s
            dw_p, dw_bnp, dw_bns = _conv_bn_nobias(
                keras_model, f"{prefix}_depthwise",
                f"{prefix}_depthwise_BN", depthwise=True,
            )
            bp["depthwise"] = dw_p
            bp["BatchNorm_0"] = dw_bnp
            bs["BatchNorm_0"] = dw_bns
            bp["project"], pr_s = convbn(
                f"{prefix}_project", f"{prefix}_project_BN"
            )
            bs["project"] = pr_s
            params[f"group{gi}_block{r}"] = bp
            stats[f"group{gi}_block{r}"] = bs
            kblock += 1

    params["head_conv"], stats["head_conv"] = convbn("Conv_1", "Conv_1_bn")
    return {"params": params, "batch_stats": stats}


RESNEXT_STAGE_SIZES = {
    "resnext50": (3, 4, 6, 3),
    "resnext101": (3, 4, 23, 3),
}


def _np(v):
    """torch tensor or array-like -> float32 numpy."""
    if hasattr(v, "detach"):
        v = v.detach().cpu().numpy()
    return np.asarray(v, np.float32)


def _torch_conv_bn(sd, conv_key, bn_key):
    """torch ``conv.weight [O,I/g,kh,kw]`` + BN -> ConvBN params/stats."""
    kernel = _np(sd[f"{conv_key}.weight"]).transpose(2, 3, 1, 0)
    params = {
        "Conv_0": {"kernel": kernel},
        "BatchNorm_0": {
            "scale": _np(sd[f"{bn_key}.weight"]),
            "bias": _np(sd[f"{bn_key}.bias"]),
        },
    }
    stats = {
        "BatchNorm_0": {
            "mean": _np(sd[f"{bn_key}.running_mean"]),
            "var": _np(sd[f"{bn_key}.running_var"]),
        }
    }
    return params, stats


def port_torch_resnext(state_dict, arch: str = "resnext50"):
    """torchvision ``resnext50_32x4d``/``resnext101_32x8d``-layout state
    dict -> ``{"params", "batch_stats"}`` for
    ``ResNet(stage_sizes, groups=32, width_factor=2, expansion=2,
    torch_compat=True)``.

    Fills the reference's ResNeXt backbone option
    (`RetinaNet/retinanet_module.py:53-66`, qubvel
    ``Classifiers.get("resnext50")``) from the canonical public pretrained
    ResNeXt source that is loadable offline (a torch ``.pth`` state dict);
    the 32x4d channel plan (widths 128..1024, stage outputs 256..2048) is
    identical between the two zoos.
    """
    stage_sizes = RESNEXT_STAGE_SIZES[arch]
    params: dict = {}
    stats: dict = {}
    params["stem"], stats["stem"] = _torch_conv_bn(state_dict, "conv1", "bn1")
    for stage_idx, n_blocks in enumerate(stage_sizes):
        for blk in range(n_blocks):
            t = f"layer{stage_idx + 1}.{blk}"
            name = f"stage{stage_idx + 2}_block{blk}"
            block_p: dict = {}
            block_s: dict = {}
            if blk == 0:
                block_p["proj"], block_s["proj"] = _torch_conv_bn(
                    state_dict, f"{t}.downsample.0", f"{t}.downsample.1"
                )
            for i in range(3):
                sub = f"ConvBN_{i}"
                block_p[sub], block_s[sub] = _torch_conv_bn(
                    state_dict, f"{t}.conv{i + 1}", f"{t}.bn{i + 1}"
                )
            params[name] = block_p
            stats[name] = block_s
    return {"params": params, "batch_stats": stats}


def save_ported(variables: dict, path: str):
    """Write ``{"params", "batch_stats"}`` as the port's ``.npz``."""
    save_npz(path, variables["params"], variables.get("batch_stats"))


def load_ported(path: str) -> dict:
    """``{"params", "batch_stats"}`` of a file written by `save_ported`."""
    params, batch_stats = load_npz(path)
    return {"params": params, "batch_stats": batch_stats}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--arch",
                   choices=sorted(STAGE_SIZES) + ["mobilenetv2"]
                   + sorted(RESNEXT_STAGE_SIZES),
                   default="resnet50")
    p.add_argument("--weights", required=True,
                   help="Keras .h5/.keras weights path, or 'imagenet'; "
                        "for resnext*: a torchvision state-dict .pth")
    p.add_argument("--output", required=True, help="output .npz path")
    args = p.parse_args(argv)

    if args.arch in RESNEXT_STAGE_SIZES:
        sd = torch.load(args.weights, map_location="cpu")
        if hasattr(sd, "state_dict"):
            sd = sd.state_dict()
        variables = port_torch_resnext(sd, args.arch)
        save_ported(variables, args.output)
        print(f"ported {args.arch} -> {args.output}")
        return

    import tensorflow as tf

    ctor = {
        "resnet50": tf.keras.applications.ResNet50,
        "resnet101": tf.keras.applications.ResNet101,
        "resnet152": tf.keras.applications.ResNet152,
        "mobilenetv2": tf.keras.applications.MobileNetV2,
    }[args.arch]
    weights = args.weights if args.weights == "imagenet" else None
    model = ctor(include_top=False, weights=weights,
                 input_shape=[None, None, 3])
    if weights is None:
        model.load_weights(args.weights)
    if args.arch == "mobilenetv2":
        variables = port_mobilenetv2(model)
    else:
        variables = port_resnet(model, args.arch)
    save_ported(variables, args.output)
    print(f"ported {args.arch} -> {args.output}")


if __name__ == "__main__":
    main()
