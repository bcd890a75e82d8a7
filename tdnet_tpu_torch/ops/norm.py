"""Normalization layers in eval mode (NCHW).

- ``batch_norm``: torch ``BatchNorm2d`` eval semantics (eps 1e-5) with the
  reference's fused activation (relu, or leaky_relu with slope 0.01) and an
  optional residual, added after the affine and before the activation
  (Testing/model/pspnet/td4_psp18.py:11-24, resnet.py blocks).
- ``fold_bn_eval``: the eval affine folded once into (fscale, fbias).
- ``layer_norm_2d``: torch ``nn.LayerNorm([H, W])`` over each (n, c) plane
  with the learned [H, W] affine (td4_psp18.py:306-312).

The affine runs in f32 and rounds to the input's dtype, as the JAX package's
``ops/norm.py`` does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

EPS = 1e-5


def _activate(y: torch.Tensor, activation: str | None) -> torch.Tensor:
    if activation == "relu":
        return F.relu(y, inplace=True)
    if activation == "leaky_relu":
        return F.leaky_relu(y, 0.01, inplace=True)
    if activation is None:
        return y
    raise ValueError(f"unknown activation {activation}")


def fold_bn_eval(weight: torch.Tensor, bias: torch.Tensor, mean: torch.Tensor,
                 var: torch.Tensor, eps: float = EPS) -> tuple[torch.Tensor, torch.Tensor]:
    """(fscale, fbias) in f32 with fscale = weight * rsqrt(var + eps) and
    fbias = bias - mean * fscale: the coefficients the eval affine uses."""
    fscale = weight.float() * torch.rsqrt(var.float() + eps)
    return fscale, bias.float() - mean.float() * fscale


def batch_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               mean: torch.Tensor, var: torch.Tensor, *, activation: str | None = None,
               residual: torch.Tensor | None = None, eps: float = EPS) -> torch.Tensor:
    """Eval batch norm: act(((x - mean) * inv + bias) + residual)."""
    inv = (torch.rsqrt(var.float() + eps) * weight.float())[:, None, None]
    y = ((x.float() - mean.float()[:, None, None]) * inv
         + bias.float()[:, None, None]).to(x.dtype)
    if residual is not None:
        y = y + residual
    return _activate(y, activation)


def batch_norm_folded(x: torch.Tensor, fscale: torch.Tensor, fbias: torch.Tensor, *,
                      activation: str | None = None,
                      residual: torch.Tensor | None = None) -> torch.Tensor:
    """The eval batch norm on pre-folded f32 coefficients: x * fscale + fbias."""
    y = torch.addcmul(fbias[:, None, None], x, fscale[:, None, None]).to(x.dtype)
    if residual is not None:
        y = y.add_(residual)
    return _activate(y, activation)


class BatchNorm(nn.Module):
    """BatchNorm2d in eval mode, with the activation and residual fused in.

    ``fold()`` computes the folded affine once (after any dtype cast); from
    then on the forward uses it."""

    def __init__(self, c: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c, device=device))
        self.bias = nn.Parameter(torch.zeros(c, device=device))
        self.register_buffer("running_mean", torch.zeros(c, device=device))
        self.register_buffer("running_var", torch.ones(c, device=device))
        self.folded: tuple[torch.Tensor, torch.Tensor] | None = None

    def fold(self) -> None:
        self.folded = fold_bn_eval(self.weight.detach(), self.bias.detach(),
                                   self.running_mean, self.running_var)

    def forward(self, x: torch.Tensor, activation: str | None = None,
                residual: torch.Tensor | None = None) -> torch.Tensor:
        if self.folded is not None:
            return batch_norm_folded(x, *self.folded, activation=activation,
                                     residual=residual)
        return batch_norm(x, self.weight, self.bias, self.running_mean, self.running_var,
                          activation=activation, residual=residual)


def layer_norm_2d(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                  eps: float = EPS) -> torch.Tensor:
    """nn.LayerNorm([H, W]) on NCHW ``x`` with the [H, W] affine, in f32."""
    h, w = x.shape[-2:]
    return F.layer_norm(x.float(), (h, w), weight.float(), bias.float(), eps).to(x.dtype)


class LayerNorm2d(nn.Module):
    def __init__(self, h: int, w: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(h, w, device=device))
        self.bias = nn.Parameter(torch.zeros(h, w, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm_2d(x, self.weight, self.bias)
