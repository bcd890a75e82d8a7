"""TF32 arithmetic of Hopper's tensor cores, emulated in torch on the CPU, for
the tests of the 3xTF32 kernels (``csrc/tf32x3.cuh``: K1's and K2's f32
attention, K5's dilated conv).

An f32 operand v splits into hi = rna_tf32(v) and lo = rna_tf32(v - hi);
``mma.sync`` m16n8k8 adds its products to an accumulator that it truncates,
which ``round_toward_zero`` stands for.
"""

from __future__ import annotations

import torch


def rna_tf32(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32 of finite f32 values as integer operations on their
    bits: 10 mantissa bits kept, ties away from zero."""
    u = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    u = (u + 0x1000) & 0xFFFFE000
    return torch.where(u >= 2**31, u - 2**32, u).to(torch.int32).view(torch.float32)


def split_tf32(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) = (rna_tf32(x), rna_tf32(x - hi))."""
    hi = rna_tf32(x)
    return hi, rna_tf32(x - hi)


def round_toward_zero(x: torch.Tensor) -> torch.Tensor:
    """float64 -> float32, truncated: the tensor core's accumulator."""
    f = x.float()
    return torch.where(f.double().abs() > x.abs(), torch.nextafter(f, torch.zeros_like(f)), f)
