"""QKV encoding and one cross-frame propagation hop.

Encoding (Testing/model/pspnet/transformer.py:9-56):
- ``w_qs`` / ``w_ks``: 1x1 conv(+bias) -> BN with leaky-ReLU -> 1x1 conv(+bias)
  to d_k = 64;
- ``w_vs``: one 1x1 conv(+bias) to d_v;
- a cached frame is grid-subsampled before the projections (stride 4 when
  streaming, 3 in TD4 training) or, in TD2 training, after them
  (``pool_before_proj=False``; Training/.../td2_psp/transformer.py:26-44).

Attention (transformer.py:60-92): softmax(q k^T / sqrt(d_k)) v, then the
per-token fc; the last hop turns the tokens back into a feature map. In
eval the fc rides inside the inference kernel (K1); in training
(``tdnet_tpu/nn/encoding.py:110-138``) the attention is the training kernel
(K2, attention dropout 0.1), the fc a ``torch.matmul`` whose weight takes a
gradient, and the fc output goes through dropout 0.1 (K3).

Tokens are [n, H*W, d] in row-major (h, w) order, as in the JAX package.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch import nn

from tdnet_tpu_torch.kernels.propagation_attention import fused_propagation_attention
from tdnet_tpu_torch.kernels.propagation_attention_train import propagation_attention_train
from tdnet_tpu_torch.nn.module import Ctx
from tdnet_tpu_torch.ops import BatchNorm, Conv2d, grid_subsample, init_conv_kaiming, normal_


class Proj2(nn.Module):
    """ConvBNReLU(d_model -> d_k, leaky) + Conv(d_k -> d_k), both with bias."""

    def __init__(self, d_model: int, d_k: int, device=None):
        super().__init__()
        self.conv0 = Conv2d(d_model, d_k, 1, bias=True, device=device)
        self.bn0 = BatchNorm(d_k, device=device)
        self.conv1 = Conv2d(d_k, d_k, 1, bias=True, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv1(self.bn0(self.conv0(x), "leaky_relu"))


class TrunkWeights(NamedTuple):
    """The three first-layer 1x1 weights (w_qs's conv0, w_vs, w_ks's conv0)
    stacked along their output channels [q | v | k], for the fused trunk
    (``nn/fused_trunk.py``): the identity slice's part [D, g, 1, 1], the bias
    [D], the four pyramid pieces' parts [4, D, g/4], and d_q, d_v."""
    w_id: torch.Tensor
    bias: torch.Tensor
    w_pieces: torch.Tensor
    dq: int
    dv: int


def trunk_weights(enc: "Encoding") -> TrunkWeights:
    convs = (enc.w_qs.conv0, enc.w_vs, enc.w_ks.conv0)
    weight = torch.cat([cv.weight for cv in convs])             # [D, 2g, 1, 1]
    g = weight.shape[1] // 2
    w_pieces = weight[:, g:, 0, 0].reshape(weight.shape[0], 4, g // 4).transpose(0, 1)
    return TrunkWeights(weight[:, :g].contiguous(), torch.cat([cv.bias for cv in convs]),
                        w_pieces.contiguous(), convs[0].weight.shape[0],
                        convs[1].weight.shape[0])


class Encoding(nn.Module):
    def __init__(self, d_model: int, d_k: int, d_v: int, device=None):
        super().__init__()
        self.w_qs = Proj2(d_model, d_k, device)
        self.w_ks = Proj2(d_model, d_k, device)
        self.w_vs = Conv2d(d_model, d_v, 1, bias=True, device=device)
        self.trunk: TrunkWeights | None = None

    def train(self, mode: bool = True) -> "Encoding":
        self.trunk = None    # as BatchNorm drops its fold
        return super().train(mode)

    def fold_trunk(self) -> None:
        """Lay out the fused trunk's stacked weights once (eval, after the
        model's cast); a mode switch drops them."""
        self.trunk = trunk_weights(self)


def init_encoding(enc: Encoding, generator: torch.Generator) -> None:
    for conv in (enc.w_qs.conv0, enc.w_qs.conv1, enc.w_ks.conv0, enc.w_ks.conv1, enc.w_vs):
        init_conv_kaiming(conv, generator)


def tokens(x: torch.Tensor) -> torch.Tensor:
    """NCHW map -> contiguous [n, H*W, C] tokens."""
    return x.flatten(2).transpose(1, 2).contiguous()


def apply_encoding_full(enc: Encoding, fea: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Current frame: (q tokens [n, H*W, d_k], v map [n, d_v, H, W])."""
    return tokens(enc.w_qs(fea)), enc.w_vs(fea)


def apply_encoding_cached(enc: Encoding, fea: torch.Tensor, *, kv_stride: int,
                          pool_before_proj: bool = True, with_q: bool = True):
    """Cached frame: subsampled (q, k, v) tokens, subsampled before the
    projections or after them. ``with_q=False`` skips w_qs (q is None): the
    training chain never reads the oldest frame's q, so its w_qs BN statistics
    must not move."""
    if pool_before_proj:
        fea = grid_subsample(fea, kv_stride)
        sub = lambda x: x
    else:
        sub = lambda x: grid_subsample(x, kv_stride)
    k = tokens(sub(enc.w_ks(fea)))
    v = tokens(sub(enc.w_vs(fea)))
    q = tokens(sub(enc.w_qs(fea))) if with_q else None
    return q, k, v


class Attention(nn.Module):
    """The per-token fc of one hop; ``w`` is stored [in, out]."""

    def __init__(self, d_v: int, device=None):
        super().__init__()
        self.w = nn.Parameter(torch.empty(d_v, d_v, device=device))
        self.b = nn.Parameter(torch.zeros(d_v, device=device))


def init_attention(atn: Attention, generator: torch.Generator) -> None:
    """kaiming_normal(a=1) of the reference's 1x1 fc conv (fan_in = d_v)."""
    normal_(atn.w, 1.0 / math.sqrt(atn.w.shape[0]), generator)
    nn.init.zeros_(atn.b)


def apply_attention(atn: Attention, k_src: torch.Tensor, v_src: torch.Tensor,
                    q_tgr: torch.Tensor, *, d_k: int, fea_hw: tuple[int, int] | None = None,
                    ctx: Ctx | None = None) -> torch.Tensor:
    """One hop: q_tgr attends over (k_src, v_src), then the fc.

    Token inputs [n, L, d]; returns tokens [n, Lq, d_v], or with ``fea_hw``
    (the last hop) the map [n, d_v, H, W]. ``ctx.train``: the training form.
    """
    temperature = math.sqrt(d_k)
    if ctx is not None and ctx.train:
        drop = ctx.dropping
        out = propagation_attention_train(q_tgr, k_src, v_src, temperature=temperature,
                                          dropout_rate=0.1 if drop else 0.0,
                                          seed=ctx.next_seed() if drop else 0)
        out = ctx.dropout(torch.matmul(out, atn.w) + atn.b, 0.1)
    else:
        out = fused_propagation_attention(q_tgr, k_src, v_src, temperature=temperature,
                                          fc_w=atn.w, fc_b=atn.b)
    if fea_hw is None:
        return out
    h, w = fea_hw
    return out.transpose(1, 2).reshape(out.shape[0], out.shape[2], h, w)
