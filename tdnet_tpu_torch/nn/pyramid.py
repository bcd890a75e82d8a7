"""Grouped pyramid pooling (Testing/model/pspnet/td4_psp18.py:243-284).

Four adaptive-average-pool branches {1, 2, 3, 6} -> 1x1 conv to C/4 ->
BN+ReLU -> channel group ``pid`` -> align-corners upsample; concatenated
after channel group ``pid`` of the input: 2C/groups channels out; with
``groups=1`` it is the full pyramid of the PSPNet baseline.
``apply_pyramid_pooling_groups`` gives every group's output with the branch
work shared, as the grouped teacher needs (``tdnet_tpu/nn/pyramid.py:79-106``).

``PSPHead`` is the PSPNet baseline's head (Testing/model/pspnet/pspnet.py:
102-153, ``tdnet_tpu/nn/pyramid.py:109-131``): the full pyramid -> 3x3 conv
2C -> C/4 + BN + ReLU -> Dropout2d(0.1) in training -> 1x1 conv with bias.
"""

from __future__ import annotations

import torch
from torch import nn

from tdnet_tpu_torch.nn.module import Ctx
from tdnet_tpu_torch.ops import (BatchNorm, Conv2d, adaptive_avg_pool_multi,
                                 init_conv_kaiming, resize_bilinear)

_BINS = (1, 2, 3, 6)


class ConvBN(nn.Module):
    """A k x k conv (padding k // 2, no bias) and its BatchNorm."""

    def __init__(self, cin: int, cout: int, k: int = 1, device=None):
        super().__init__()
        self.conv = Conv2d(cin, cout, k, padding=k // 2, device=device)
        self.bn = BatchNorm(cout, device=device)


class PyramidPooling(nn.Module):
    def __init__(self, in_channels: int, device=None):
        super().__init__()
        for i in range(4):
            self.add_module(f"conv{i + 1}", ConvBN(in_channels, in_channels // 4, device=device))


def apply_pyramid_pooling(psp: PyramidPooling, x: torch.Tensor, *, groups: int,
                          pid: int) -> torch.Tensor:
    """NCHW c4 -> grouped pyramid feature z [n, 2C/groups, h, w]."""
    n, c, h, w = x.shape
    g, gq = c // groups, c // (groups * 4)
    feats = [x[:, pid * g:(pid + 1) * g]]
    for i, f in enumerate(adaptive_avg_pool_multi(x, _BINS)):
        br = getattr(psp, f"conv{i + 1}")
        f = br.bn(br.conv(f), "relu")
        # slicing commutes with the upsample: slice first, upsample less
        feats.append(resize_bilinear(f[:, pid * gq:(pid + 1) * gq], (h, w)))
    return torch.cat(feats, dim=1)


def apply_pyramid_pooling_groups(psp: PyramidPooling, x: torch.Tensor,
                                 groups: int) -> list[torch.Tensor]:
    """NCHW c4 -> the ``groups`` grouped pyramid features, each
    [n, 2C/groups, h, w]; each branch runs once at full width."""
    n, c, h, w = x.shape
    g, gq = c // groups, c // (groups * 4)
    feats = []
    for i, f in enumerate(adaptive_avg_pool_multi(x, _BINS)):
        br = getattr(psp, f"conv{i + 1}")
        feats.append(resize_bilinear(br.bn(br.conv(f), "relu"), (h, w)))
    return [torch.cat([x[:, p * g:(p + 1) * g]] + [f[:, p * gq:(p + 1) * gq] for f in feats],
                      dim=1) for p in range(groups)]


def init_pyramid_pooling(psp: PyramidPooling, generator: torch.Generator) -> None:
    for i in range(4):
        init_conv_kaiming(getattr(psp, f"conv{i + 1}").conv, generator)


class PSPHead(nn.Module):
    def __init__(self, in_channels: int, nclass: int, device=None):
        super().__init__()
        self.psp = PyramidPooling(in_channels, device)
        self.conv = ConvBN(2 * in_channels, in_channels // 4, 3, device=device)
        self.out = Conv2d(in_channels // 4, nclass, 1, bias=True, device=device)


def apply_psp_head(head: PSPHead, x: torch.Tensor, ctx: Ctx | None = None) -> torch.Tensor:
    """NCHW c4 [n, C, h, w] -> logits [n, nclass, h, w]."""
    z = apply_pyramid_pooling(head.psp, x, groups=1, pid=0)
    z = head.conv.bn(head.conv.conv(z), "relu")
    if ctx is not None:
        z = ctx.dropout2d(z, 0.1)
    return head.out(z)


def init_psp_head(head: PSPHead, generator: torch.Generator) -> None:
    init_pyramid_pooling(head.psp, generator)
    init_conv_kaiming(head.conv.conv, generator)
    init_conv_kaiming(head.out, generator)
