"""Pooling with the reference's semantics (NCHW).

- ``adaptive_avg_pool_multi``: ``nn.AdaptiveAvgPool2d(s)`` for each PSP
  pyramid bin (Testing/model/pspnet/td4_psp18.py:250-253);
- ``grid_subsample``: ``nn.MaxPool2d(kernel_size=1, stride=s)``, i.e. every
  s-th pixel from the first, so the output is ceil(H/s) x ceil(W/s)
  (Testing/model/pspnet/transformer.py:26);
- ``max_pool``: the ResNet stem ``MaxPool2d(3, 2, padding=1)``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tdnet_tpu_torch.ops.dtype import at_least_f32


def adaptive_avg_pool_multi(x: torch.Tensor, sizes: tuple[int, ...]) -> list[torch.Tensor]:
    """One [n, c, s, s] adaptive average pool per size in ``sizes``, in f32."""
    xf = at_least_f32(x)
    return [F.adaptive_avg_pool2d(xf, s).to(x.dtype) for s in sizes]


def grid_subsample(x: torch.Tensor, stride: int) -> torch.Tensor:
    return x if stride == 1 else x[:, :, ::stride, ::stride]


def max_pool(x: torch.Tensor, window: int = 3, stride: int = 2, padding: int = 1) -> torch.Tensor:
    return F.max_pool2d(x, window, stride, padding)
