"""Normalization layers (NCHW).

- ``batch_norm``: torch ``BatchNorm2d`` eval semantics (eps 1e-5) with the
  reference's fused activation (relu, or leaky_relu with slope 0.01) and an
  optional residual, added after the affine and before the activation
  (Testing/model/pspnet/td4_psp18.py:11-24, resnet.py blocks).
- ``batch_norm_train``: the train-mode twin (batch statistics, biased
  variance to normalize, unbiased variance into the running buffer with
  momentum 0.1), as ``tdnet_tpu/ops/norm.py:159-200``; with a data group
  (``parallel/mesh.py``; ``sync_batch_norm``) the statistics are those of
  every rank's batch, the counterpart of the reference's ``SyncBatchNorm``
  and of GSPMD's global batch moments.
- ``fold_bn_eval``: the eval affine folded once into (fscale, fbias).
- ``layer_norm_2d``: torch ``nn.LayerNorm([H, W])`` over each (n, c) plane
  with the learned [H, W] affine (td4_psp18.py:306-312).

The affine runs in f32 and rounds to the input's dtype, as the JAX package's
``ops/norm.py`` does.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch import nn

from tdnet_tpu_torch.ops.dtype import at_least_f32

EPS = 1e-5
MOMENTUM = 0.1


@contextlib.contextmanager
def sync_batch_norm(model: nn.Module, group):
    """Inside, the train-mode ``BatchNorm`` modules of ``model`` take their
    statistics over the ranks of ``group`` (a ``DataGroup``; None, or a world of
    1: this process's batch, the one-process op)."""
    norms = [m for m in model.modules() if isinstance(m, BatchNorm)]
    prev = [m.group for m in norms]
    for m in norms:
        m.group = group
    try:
        yield
    finally:
        for m, g in zip(norms, prev):
            m.group = g


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
                     eps: float = EPS, momentum: float = MOMENTUM,
                     group=None) -> torch.Tensor:
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

    ``group``, a ``DataGroup`` of more than one rank: ``_batch_norm_sync``.
    """
    if group is not None and group.world > 1:
        return _batch_norm_sync(x, weight, bias, running_mean, running_var, group,
                                activation=activation, residual=residual, eps=eps,
                                momentum=momentum)
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


class _SyncBatchNorm(torch.autograd.Function):
    """The affine of train-mode batch norm over every rank's batch, f32 in and out:
    y = (x - mean) / sqrt(var + eps) * weight + bias.

    Forward: each rank's (count, mean, biased variance) per channel
    (``torch.var_mean``, as accurate as torch's own op) in its row of a [world,
    2C + 1] table, the table all-reduced, the rows combined exactly (Chan et al.:
    the ranks' M2 plus each rank's count x its mean's squared distance from the
    global mean), where E[x^2] - E[x]^2, the JAX package's form
    (``tdnet_tpu/ops/norm.py:172-181``), cancels in f32; the running buffers
    updated. Backward in one pass, as the JAX package's custom VJP takes it
    under its data axis (``tdnet_tpu/ops/norm.py:72-92``): the per-channel sums
    of dy and dy * xhat all-reduced in one call, dx = weight / sqrt(var + eps) *
    (dy - sum(dy) / N - xhat * sum(dy * xhat) / N) with N and the sums global;
    the weight's and bias's gradients are this rank's sums, which the step's
    gradient all-reduce adds up."""

    @staticmethod
    def forward(ctx, xf, weight, bias, running_mean, running_var, group, eps, momentum):
        c = xf.shape[1]
        var, mean = torch.var_mean(xf, dim=(0, 2, 3), unbiased=False)
        table = xf.new_zeros(group.world, 2 * c + 1)
        table[group.rank] = torch.cat([xf.new_full((1,), xf.numel() // c), mean, var])
        group.all_reduce_(table)
        counts, means, variances = table[:, :1], table[:, 1:c + 1], table[:, c + 1:]
        n = counts.sum()
        mean = (counts * means).sum(dim=0) / n
        var = (counts * (variances + (means - mean).square())).sum(dim=0) / n
        running_mean.mul_(1 - momentum).add_(momentum * mean)
        running_var.mul_(1 - momentum).add_(momentum * var * (n / (n - 1).clamp(min=1)))
        inv = torch.rsqrt(var + eps)
        xhat = (xf - mean[:, None, None]) * inv[:, None, None]
        ctx.save_for_backward(xhat, weight, inv, n)
        ctx.group = group
        return xhat * weight[:, None, None] + bias[:, None, None]

    @staticmethod
    def backward(ctx, dy):
        xhat, weight, inv, n = ctx.saved_tensors
        c = dy.shape[1]
        db = dy.sum(dim=(0, 2, 3))
        ds = (dy * xhat).sum(dim=(0, 2, 3))
        total = ctx.group.all_reduce_(torch.cat([db, ds]))
        dx = (weight * inv)[:, None, None] * (dy - (total[:c] / n)[:, None, None]
                                              - xhat * (total[c:] / n)[:, None, None])
        return dx, ds, db, None, None, None, None, None


def _batch_norm_sync(x, weight, bias, running_mean, running_var, group, *, activation,
                     residual, eps, momentum) -> torch.Tensor:
    """``batch_norm_train`` over every rank's batch (``_SyncBatchNorm``): the
    count is global, so the PSP's 1x1 pool at one image a rank counts ``world``
    values a channel, and the running buffers take the global unbiased variance,
    the same on every rank. The affine and the residual run in f32 and round
    once to x's dtype."""
    y = _SyncBatchNorm.apply(at_least_f32(x), at_least_f32(weight), at_least_f32(bias),
                             running_mean, running_var, group, eps, momentum)
    if residual is not None:
        y = y + at_least_f32(residual)
    return _activate(y.to(x.dtype), activation)


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
        self.group = None   # the data group of its train-mode statistics (sync_batch_norm)

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
                                    residual=residual, group=self.group)
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
