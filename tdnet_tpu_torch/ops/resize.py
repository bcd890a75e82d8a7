"""Bilinear resize with ``align_corners=True`` (NCHW).

Every upsample in the reference nets is
``F.interpolate(mode='bilinear', align_corners=True)``
(Testing/model/pspnet/td4_psp18.py:27). The port's forward calls it
directly, in f32. Its backward is not ``F.interpolate``'s, which sums with
atomics and so differs from run to run on the card: the resize is
y = A_h x A_wᵀ with the interpolation matrices of the JAX package
(``tdnet_tpu/ops/resize.py:_interp_matrix_np``), so dx = A_hᵀ g A_w, two
matrix products, which repeat bit for bit.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from tdnet_tpu_torch.ops.dtype import at_least_f32


@functools.cache
def _interp_matrix_np(in_size: int, out_size: int) -> np.ndarray:
    """Dense [out_size, in_size] align-corners linear interpolation matrix, float64."""
    if in_size == 1:
        return np.ones((out_size, 1), dtype=np.float64)
    if out_size == 1:
        src = np.zeros((1,), dtype=np.float64)
    else:
        src = np.arange(out_size, dtype=np.float64) * (in_size - 1) / (out_size - 1)
    i0 = np.clip(np.floor(src).astype(np.int64), 0, in_size - 2)
    w1 = src - i0
    mat = np.zeros((out_size, in_size), dtype=np.float64)
    rows = np.arange(out_size)
    mat[rows, i0] += 1.0 - w1
    mat[rows, i0 + 1] += w1
    return mat


@functools.cache
def interp_matrix(in_size: int, out_size: int, dtype: torch.dtype,
                  device: torch.device) -> torch.Tensor:
    """``_interp_matrix_np`` as a tensor, built once per (sizes, dtype, device)."""
    return torch.from_numpy(_interp_matrix_np(in_size, out_size)).to(device=device, dtype=dtype)


class _ResizeBilinear(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, out_hw):
        ctx.in_hw = tuple(x.shape[-2:])
        return F.interpolate(x, size=out_hw, mode="bilinear", align_corners=True)

    @staticmethod
    def backward(ctx, g):
        (h, w), (oh, ow) = ctx.in_hw, g.shape[-2:]
        ah = interp_matrix(h, oh, g.dtype, g.device)
        aw = interp_matrix(w, ow, g.dtype, g.device)
        return torch.matmul(torch.matmul(ah.t(), g), aw), None


def resize_bilinear(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """Align-corners bilinear resize of NCHW ``x`` to ``out_hw``, computed in f32
    (or wider); the backward is deterministic."""
    if tuple(x.shape[-2:]) == tuple(out_hw):
        return x
    return _ResizeBilinear.apply(at_least_f32(x), tuple(out_hw)).to(x.dtype)
