"""Convolution and its initializers (NCHW activations, OIHW kernels).

Initializers follow the reference:
- ``kaiming_normal(a=1)`` and zero bias for the PSP, head and encoding convs
  (Training/.../td4_psp/td4_psp.py:496-505 ``init_weight``);
- ``normal(0, sqrt(2/n))`` with n = kh*kw*out_ch for the backbone convs
  (Testing/model/pspnet/resnet.py:162-168).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


def conv2d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None, *,
           stride: int = 1, padding: int = 0, dilation: int = 1) -> torch.Tensor:
    """2-D convolution with symmetric padding, NCHW input, OIHW kernel."""
    return F.conv2d(x, w, b, stride=stride, padding=padding, dilation=dilation)


def tap_wgrad(x: torch.Tensor, dy: torch.Tensor, padding: int, dilation: int,
              k: int = 3) -> torch.Tensor:
    """The weight gradient [co, ci, k, k] of a stride-1 conv of ``x`` [n, ci, H, W]
    giving ``dy`` [n, co, Ho, Wo]: per tap one [ci, L] x [L, co] matmul of the
    shifted input against dy, L = n * Ho * Wo (``tdnet_tpu/ops/conv.py:_tap_wgrad``)."""
    n, ci = x.shape[:2]
    co, ho, wo = dy.shape[1:]
    d = dilation
    xp = F.pad(x, (padding,) * 4)
    dy_t = dy.transpose(0, 1).reshape(co, -1).t()                      # [L, co]
    taps = []
    for i in range(k):
        for j in range(k):
            xs = xp[:, :, i * d:i * d + ho, j * d:j * d + wo]
            taps.append(torch.matmul(xs.transpose(0, 1).reshape(ci, -1), dy_t))  # [ci, co]
    return torch.stack(taps, dim=-1).reshape(ci, co, k, k).transpose(0, 1)


class Conv2d(nn.Module):
    """A conv layer whose weights are left empty for the init functions below
    or a loaded state (it draws nothing from the global generator)."""

    def __init__(self, cin: int, cout: int, k: int, *, stride: int = 1, padding: int = 0,
                 dilation: int = 1, bias: bool = False, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k, device=device))
        self.bias = nn.Parameter(torch.empty(cout, device=device)) if bias else None
        self.stride, self.padding, self.dilation = stride, padding, dilation

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv2d(x, self.weight, self.bias, stride=self.stride,
                      padding=self.padding, dilation=self.dilation)


def normal_(t: torch.Tensor, std: float, generator: torch.Generator) -> None:
    """Fill ``t`` with normal(0, std) draws from ``generator`` (on its device)."""
    with torch.no_grad():
        draw = torch.randn(t.shape, generator=generator, device=generator.device)
        t.copy_(draw * std)


def init_conv_kaiming(conv: Conv2d, generator: torch.Generator, *, a: float = 1.0) -> None:
    """torch ``kaiming_normal_(w, a=a)`` (fan_in, leaky_relu gain), zero bias."""
    cout, cin, kh, kw = conv.weight.shape
    gain = math.sqrt(2.0 / (1.0 + a * a))
    normal_(conv.weight, gain / math.sqrt(kh * kw * cin), generator)
    if conv.bias is not None:
        nn.init.zeros_(conv.bias)


def init_conv_msra_out(conv: Conv2d, generator: torch.Generator) -> None:
    """Backbone init: normal(0, sqrt(2/n)), n = kh*kw*cout, zero bias."""
    cout, cin, kh, kw = conv.weight.shape
    normal_(conv.weight, math.sqrt(2.0 / (kh * kw * cout)), generator)
    if conv.bias is not None:
        nn.init.zeros_(conv.bias)
