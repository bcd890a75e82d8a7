"""Scaled dot-product attention, the plain spec of propagation.

softmax(q k^T / temperature) v with the softmax in f32 and the PV product
accumulated in f32 (Testing/model/pspnet/transformer.py:117-139, eval).
"""

from __future__ import annotations

import torch


def scaled_dot_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         temperature: float) -> torch.Tensor:
    """q [n, Lq, dk], k [n, Lk, dk], v [n, Lk, dv] -> [n, Lq, dv] in v's dtype."""
    logits = torch.matmul(q.float(), k.float().transpose(1, 2)) / temperature
    attn = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.matmul(attn.float(), v.float()).to(v.dtype)
