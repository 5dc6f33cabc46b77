"""Shared conv towers and prediction heads.

Port of `detectax/models/heads.py`. The towers are 4-layer convs *shared
across FPN levels* and applied with no activation between layers — only one
ReLU after the 4th conv (a reference quirk kept, flag-switchable). Head
convs are per-level.
"""
from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from detectax_torch.models.layers import Conv


class ConvTower(nn.Module):
    """4 x 3x3 conv (no bias) shared tower; ReLU applied once at the end by
    default, or between layers with `act_between`."""

    def __init__(self, in_features: int = 256, features: int = 256,
                 n_layers: int = 4, act_between: bool = False):
        super().__init__()
        self.n_layers = n_layers
        self.act_between = act_between
        ch = in_features
        for i in range(n_layers):
            self.add_module(f"layer_{i + 1}",
                            Conv(ch, features, 3, use_bias=False))
            ch = features

    def forward(self, x):
        for i in range(self.n_layers):
            x = getattr(self, f"layer_{i + 1}")(x)
            if self.act_between and i < self.n_layers - 1:
                x = F.relu(x)
        return F.relu(x)


class HeadConv(nn.Module):
    """3x3 prediction conv; `focal_bias=True` marks the conv so that
    `layers.init_parameters` starts its bias at log(0.01/0.99)."""

    def __init__(self, in_features: int, features: int,
                 focal_bias: bool = False):
        super().__init__()
        self.Conv_0 = Conv(in_features, features, 3, use_bias=True)
        self.Conv_0.focal_bias = focal_bias

    def forward(self, x):
        return self.Conv_0(x)
