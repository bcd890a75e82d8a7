"""Scaled dot-product attention, the plain spec of propagation (inference and
training).

softmax(q k^T / temperature) v with the softmax in f32 and the PV product
accumulated in f32 (Testing/model/pspnet/transformer.py:117-139, eval).
"""

from __future__ import annotations

import torch

from tdnet_tpu_torch.ops.dtype import at_least_f32


def scaled_dot_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         temperature: float) -> torch.Tensor:
    """q [n, Lq, dk], k [n, Lk, dk], v [n, Lk, dv] -> [n, Lq, dv] in v's dtype."""
    logits = torch.matmul(q.float(), k.float().transpose(1, 2)) / temperature
    attn = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.matmul(attn.float(), v.float()).to(v.dtype)


def attention_train(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, temperature: float,
                    keep: torch.Tensor | None = None, rate: float = 0.0) -> torch.Tensor:
    """The training attention (Training/.../td4_psp/transformer.py:117-139):
    softmax(q k^T / temperature), then attention dropout with an explicit
    keep mask ``keep`` [n, Lq, Lk] and a 1 / (1 - rate) scale, then @ v.

    Softmax in f32 (or wider), PV accumulated in f32; differentiable through autograd.
    ``keep=None``: no dropout. Returns [n, Lq, dv] in v's dtype.
    """
    logits = torch.matmul(at_least_f32(q), at_least_f32(k).transpose(1, 2)) / temperature
    attn = torch.softmax(logits, dim=-1)
    if keep is not None:
        inv_keep = torch.tensor(1.0 / (1.0 - rate), dtype=torch.float32)
        attn = torch.where(keep, attn * inv_keep, torch.zeros((), dtype=attn.dtype))
    return torch.matmul(at_least_f32(attn.to(v.dtype)), at_least_f32(v)).to(v.dtype)
