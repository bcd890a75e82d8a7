"""FCN head (Testing/model/pspnet/td4_psp18.py:287-302), eval:
3x3 conv (no bias) -> BN -> ReLU -> 1x1 conv with bias to nclass."""

from __future__ import annotations

import torch
from torch import nn

from tdnet_tpu_torch.ops import BatchNorm, Conv2d, init_conv_kaiming


class FCNHead(nn.Module):
    def __init__(self, in_channels: int, nclass: int, *, chn_down: int = 4, device=None):
        super().__init__()
        inter = in_channels // chn_down
        self.conv = Conv2d(in_channels, inter, 3, padding=1, device=device)
        self.bn = BatchNorm(inter, device=device)
        self.out = Conv2d(inter, nclass, 1, bias=True, device=device)


def apply_fcn_head(head: FCNHead, x: torch.Tensor) -> torch.Tensor:
    return head.out(head.bn(head.conv(x), "relu"))


def init_fcn_head(head: FCNHead, generator: torch.Generator) -> None:
    init_conv_kaiming(head.conv, generator)
    init_conv_kaiming(head.out, generator)
