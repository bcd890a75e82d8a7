"""Pooling with the reference's semantics (NCHW).

- ``adaptive_avg_pool_multi``: ``nn.AdaptiveAvgPool2d(s)`` for each PSP
  pyramid bin (Testing/model/pspnet/td4_psp18.py:250-253); in f32, or in
  bf16 at the JAX package's rounding points (``tdnet_tpu/ops/pool.py:64-95``:
  each cell's sum over rows, then over columns, by 0/1 matrices with bf16
  outputs, divided by its count in f32);
- ``grid_subsample``: ``nn.MaxPool2d(kernel_size=1, stride=s)``, i.e. every
  s-th pixel from the first, so the output is ceil(H/s) x ceil(W/s)
  (Testing/model/pspnet/transformer.py:26);
- ``max_pool``: the ResNet stem ``MaxPool2d(3, 2, padding=1)``.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from tdnet_tpu_torch.ops.dtype import at_least_f32


@functools.cache
def _sum_matrix(inp: int, out: int, dtype: torch.dtype, device: torch.device):
    """The [out, inp] 0/1 membership matrix of torch's adaptive-pool cells and
    the cells' element counts [out] (f32), built once; normal tensors even when
    first asked for under ``torch.inference_mode`` (a stream), so that a train
    step can use them too."""
    with torch.inference_mode(False):
        m = torch.zeros(out, inp)
        counts = torch.zeros(out)
        for i in range(out):
            s, e = (i * inp) // out, -((-(i + 1) * inp) // out)
            m[i, s:e] = 1.0
            counts[i] = e - s
        return m.to(device, dtype), counts.to(device)


def adaptive_avg_pool_multi(x: torch.Tensor, sizes: tuple[int, ...]) -> list[torch.Tensor]:
    """One [n, c, s, s] adaptive average pool per size in ``sizes``, in f32, or
    for a bf16 ``x`` as the JAX package's bf16 pool rounds."""
    if x.dtype != torch.bfloat16:
        xf = at_least_f32(x)
        return [F.adaptive_avg_pool2d(xf, s).to(x.dtype) for s in sizes]
    h, w = x.shape[-2:]
    outs = []
    for s in sizes:
        rh, ch = _sum_matrix(h, s, x.dtype, x.device)
        rw, cw = _sum_matrix(w, s, x.dtype, x.device)
        t = torch.matmul(torch.matmul(rh, x), rw.t())
        outs.append((t.float() / (ch[:, None] * cw[None, :])).to(x.dtype))
    return outs


def grid_subsample(x: torch.Tensor, stride: int) -> torch.Tensor:
    return x if stride == 1 else x[:, :, ::stride, ::stride]


def max_pool(x: torch.Tensor, window: int = 3, stride: int = 2, padding: int = 1) -> torch.Tensor:
    return F.max_pool2d(x, window, stride, padding)
