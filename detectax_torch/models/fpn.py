"""Feature pyramid network.

Port of `detectax/models/fpn.py::FPN`: the P3-P7 topology — 1x1 laterals on
C3-C5, nearest-neighbour upsample residual adds (the reference adds
up(P4_1x1), not up(P4_residual), at P3 — reproduced), 3x3 output convs,
stride-2 P6 from C5 and P7 from relu(P6). `S8CollapseFPN` is not ported
yet.
"""
from __future__ import annotations

from typing import Mapping

import torch.nn.functional as F
from torch import nn

from detectax_torch.models.layers import Conv, _upsample_to_nchw


class FPN(nn.Module):
    def __init__(self, in_channels: Mapping[str, int], features: int = 256):
        super().__init__()
        self.c3_1x1 = Conv(in_channels["c3"], features, 1)
        self.c4_1x1 = Conv(in_channels["c4"], features, 1)
        self.c5_1x1 = Conv(in_channels["c5"], features, 1)
        self.c3_3x3 = Conv(features, features, 3)
        self.c4_3x3 = Conv(features, features, 3)
        self.c5_3x3 = Conv(features, features, 3)
        self.c6_3x3 = Conv(in_channels["c5"], features, 3, stride=2)
        self.c7_3x3 = Conv(features, features, 3, stride=2)

    def forward(self, taps):
        p3_1x1 = self.c3_1x1(taps["c3"])
        p4_1x1 = self.c4_1x1(taps["c4"])
        p5_1x1 = self.c5_1x1(taps["c5"])

        p4_res = p4_1x1 + _upsample_to_nchw(
            p5_1x1, p4_1x1.shape[2:], "nearest")
        # Reference quirk kept: P3 adds up(P4_1x1), not up(P4_residual).
        p3_res = p3_1x1 + _upsample_to_nchw(
            p4_1x1, p3_1x1.shape[2:], "nearest")

        p3 = self.c3_3x3(p3_res)
        p4 = self.c4_3x3(p4_res)
        p5 = self.c5_3x3(p5_1x1)
        p6 = self.c6_3x3(taps["c5"])
        p7 = self.c7_3x3(F.relu(p6))
        return [p3, p4, p5, p6, p7]
