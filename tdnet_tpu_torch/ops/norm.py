"""Normalization layers (NCHW).

- ``batch_norm``: torch ``BatchNorm2d`` eval semantics (eps 1e-5) with the
  reference's fused activation (relu, or leaky_relu with slope 0.01) and an
  optional residual, added after the affine and before the activation
  (Testing/model/pspnet/td4_psp18.py:11-24, resnet.py blocks).
- ``batch_norm_train``: the train-mode twin (batch statistics, biased
  variance to normalize, unbiased variance into the running buffer with
  momentum 0.1), as ``tdnet_tpu/ops/norm.py:159-200``.
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

from tdnet_tpu_torch.ops.dtype import at_least_f32

EPS = 1e-5
MOMENTUM = 0.1


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
    inv = (torch.rsqrt(at_least_f32(var) + eps) * at_least_f32(weight))[:, None, None]
    y = ((at_least_f32(x) - at_least_f32(mean)[:, None, None]) * inv
         + at_least_f32(bias)[:, None, None]).to(x.dtype)
    if residual is not None:
        y = y + residual
    return _activate(y, activation)


def batch_norm_train(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                     running_mean: torch.Tensor, running_var: torch.Tensor, *,
                     activation: str | None = None, residual: torch.Tensor | None = None,
                     eps: float = EPS, momentum: float = MOMENTUM) -> torch.Tensor:
    """Train-mode batch norm: normalize with the batch mean and biased
    variance over (n, h, w), update the running buffers in place with the
    unbiased variance, then the residual and the activation.

    ``F.batch_norm`` does it where a channel has more than one value; with
    one value a channel (the PSP's 1x1 pool at batch 1, which torch's own
    op refuses) the variance is 0 and the output is the bias, as in the JAX
    package's E[x^2] - E[x]^2 form.

    Moments, affine and running statistics are f32 for a bf16 ``x`` and the
    output is rounded to x's dtype; with a residual, the residual joins the
    f32 affine before that one rounding, as the JAX package's fused
    ``_bn_add_act_train`` adds it (``tdnet_tpu/ops/norm.py:100-111``).
    """
    n = x.numel() // x.shape[1]
    if residual is not None and x.dtype.itemsize < 4:
        y = batch_norm_train(at_least_f32(x), weight, bias, running_mean, running_var, eps=eps,
                             momentum=momentum)
        return _activate((y + at_least_f32(residual)).to(x.dtype), activation)
    if n > 1:
        y = F.batch_norm(x, running_mean, running_var, weight, bias, training=True,
                         momentum=momentum, eps=eps)
    else:
        mean = at_least_f32(x).mean(dim=(0, 2, 3))
        var = (at_least_f32(x) - mean[:, None, None]).square().mean(dim=(0, 2, 3))
        with torch.no_grad():
            running_mean.mul_(1 - momentum).add_(momentum * mean)
            running_var.mul_(1 - momentum).add_(momentum * var)
        y = batch_norm(x, weight, bias, mean, var, eps=eps)
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
    """BatchNorm2d with the activation and residual fused in; ``train()``
    selects batch statistics (``batch_norm_train``), ``eval()`` the running
    ones.

    ``fold()`` computes the folded eval affine once (after any dtype cast);
    from then on the eval forward uses it. Any mode switch drops it, so that
    training never sees it and a later fold takes the new statistics."""

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

    def train(self, mode: bool = True) -> "BatchNorm":
        self.folded = None
        return super().train(mode)

    def forward(self, x: torch.Tensor, activation: str | None = None,
                residual: torch.Tensor | None = None) -> torch.Tensor:
        if self.training:
            return batch_norm_train(x, self.weight, self.bias, self.running_mean,
                                    self.running_var, activation=activation,
                                    residual=residual)
        if self.folded is not None:
            return batch_norm_folded(x, *self.folded, activation=activation,
                                     residual=residual)
        return batch_norm(x, self.weight, self.bias, self.running_mean, self.running_var,
                          activation=activation, residual=residual)


def layer_norm_2d(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                  eps: float = EPS) -> torch.Tensor:
    """nn.LayerNorm([H, W]) on NCHW ``x`` with the [H, W] affine, in f32."""
    h, w = x.shape[-2:]
    return F.layer_norm(at_least_f32(x), (h, w), at_least_f32(weight), at_least_f32(bias),
                        eps).to(x.dtype)


class LayerNorm2d(nn.Module):
    def __init__(self, h: int, w: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(h, w, device=device))
        self.bias = nn.Parameter(torch.zeros(h, w, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm_2d(x, self.weight, self.bias)
