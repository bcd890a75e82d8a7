"""Prediction heads (``tdnet_tpu/nn/heads.py``).

- FCNHead (Testing/model/pspnet/td4_psp18.py:287-302): 3x3 conv (no bias) ->
  BN -> ReLU -> Dropout2d(0.1) in training -> 1x1 conv with bias to nclass.
- PredLayer, the frozen teacher's shared head (Training/.../td4_psp/
  pspnet_4p.py:197-207), eval: BN -> ReLU -> 1x1 conv with bias (its
  Dropout2d(0.1) never runs in eval).
- The teacher's per-group 3x3 conv (pspnet_4p.py:182-194 with BNLU=False) is
  a plain ``Conv2d`` without bias or norm.
"""

from __future__ import annotations

import torch
from torch import nn

from tdnet_tpu_torch.nn.module import Ctx
from tdnet_tpu_torch.ops import BatchNorm, Conv2d, init_conv_kaiming


class FCNHead(nn.Module):
    def __init__(self, in_channels: int, nclass: int, *, chn_down: int = 4, device=None):
        super().__init__()
        inter = in_channels // chn_down
        self.conv = Conv2d(in_channels, inter, 3, padding=1, device=device)
        self.bn = BatchNorm(inter, device=device)
        self.out = Conv2d(inter, nclass, 1, bias=True, device=device)


def apply_fcn_head(head: FCNHead, x: torch.Tensor, ctx: Ctx | None = None) -> torch.Tensor:
    y = head.bn(head.conv(x), "relu")
    if ctx is not None:
        y = ctx.dropout2d(y, 0.1)
    return head.out(y)


def init_fcn_head(head: FCNHead, generator: torch.Generator) -> None:
    init_conv_kaiming(head.conv, generator)
    init_conv_kaiming(head.out, generator)


class PredLayer(nn.Module):
    def __init__(self, in_channels: int, nclass: int, device=None):
        super().__init__()
        self.bn = BatchNorm(in_channels, device=device)
        self.out = Conv2d(in_channels, nclass, 1, bias=True, device=device)


def apply_pred_layer(head: PredLayer, x: torch.Tensor) -> torch.Tensor:
    return head.out(head.bn(x, "relu"))


def init_pred_layer(head: PredLayer, generator: torch.Generator) -> None:
    init_conv_kaiming(head.out, generator)
