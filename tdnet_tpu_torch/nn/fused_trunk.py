"""Fused grouped-PSP + QKV encoding, the streaming fast path
(``tdnet_tpu/nn/fused_trunk.py``).

The plain dataflow builds the grouped pyramid feature
``z = concat(identity slice, up(f1) .. up(f4))`` (2C/groups channels at the c4
grid) and runs three 1x1 projections over it. Three exact identities remove z:

1. a 1x1 conv distributes over a channel concat: ``conv(concat(xs), W) =
   sum_i conv(x_i, W_i)``, W split along its input channels (dim 1 of an OIHW
   kernel);
2. a 1x1 conv commutes with the bilinear upsample (both linear, the conv
   pointwise): project the pooled pyramid maps (at most 6x6) first, then
   upsample the d_k- or d_v-wide result;
3. upsampling and then taking every s-th pixel equals applying every s-th row
   of the interpolation matrices: ``resize(x, HW)[::s] == A_h[::s] x
   A_w[::s]ᵀ``.

So the identity slice of c4 feeds the projections directly, and each pyramid
branch adds an upsampled projection of its pooled map. Equal to the plain
dataflow up to the order of float sums. Eval only: the BatchNorms run on their
running (or folded) statistics, and training keeps the plain dataflow.

Rounding points follow the JAX module: the upsample runs in f32 (matrix
products without TF32 inside the runtime's ``no_tf32`` scope, JAX's HIGHEST
precision) and each upsampled piece is rounded to the activation dtype before
it is added.

The launches follow the host: the four pieces are zero-padded to 6x6 and
stacked, so that one product projects them for the three first-layer weights
at once and two products upsample them (full resolution for q and v, the
cache's stride for q, k and v). A call a piece and a projection, as the JAX
module writes it, made the host-bound TD4-PSP18 bf16 stream 40% slower on an
H100 (PERF.md §5, the fused trunk's run A1).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from tdnet_tpu_torch.nn.encoding import Encoding, tokens, trunk_weights
from tdnet_tpu_torch.nn.pyramid import PyramidPooling
from tdnet_tpu_torch.ops import adaptive_avg_pool_multi, conv2d
from tdnet_tpu_torch.ops.resize import _interp_matrix_np

_BINS = (1, 2, 3, 6)


@functools.cache
def _up_matrices(dst: int, stride: int | None, device: torch.device) -> torch.Tensor:
    """[4, rows, 6]: rows ``::stride`` of each bin's [dst, bin] align-corners
    interpolation matrix (the JAX package's), zero-padded to the largest bin,
    f32, built once; a normal tensor even when first asked for inside
    ``torch.inference_mode`` (a stream)."""
    mats = []
    for b in _BINS:
        a = _interp_matrix_np(b, dst)
        mats.append(np.pad(a[::stride] if stride else a, ((0, 0), (0, _BINS[-1] - b))))
    with torch.inference_mode(False):
        return torch.from_numpy(np.stack(mats)).to(device=device, dtype=torch.float32)


def _psp_pieces(psp: PyramidPooling, c4: torch.Tensor, pid: int, groups: int) -> torch.Tensor:
    """The four pooled, projected, activated branch maps, each sliced to
    channel group ``pid`` and not upsampled, zero-padded to 6x6 and stacked:
    [4, n, C/(4 groups), 6, 6]. The pools share one pass."""
    gq = c4.shape[1] // (groups * 4)
    pieces = []
    for i, f in enumerate(adaptive_avg_pool_multi(c4, _BINS)):
        br = getattr(psp, f"conv{i + 1}")
        f = br.bn(br.conv(f), "relu")[:, pid * gq:(pid + 1) * gq]
        pad = _BINS[-1] - f.shape[-1]
        pieces.append(F.pad(f, (0, pad, 0, pad)))
    return torch.stack(pieces)


def _upsampled(p: torch.Tensor, out_hw: tuple[int, int], stride: int | None) -> torch.Tensor:
    """The projected pieces p [4, n, d, 6, 6] upsampled to ``out_hw`` (rows
    ``::stride``): A_h p A_wᵀ in f32, rows first as the JAX einsums, each
    rounded to p's dtype. The zero padding adds exact zeros."""
    ah = _up_matrices(out_hw[0], stride, p.device)[:, None, None]
    aw = _up_matrices(out_hw[1], stride, p.device)[:, None, None]
    return torch.matmul(torch.matmul(ah, p.float()), aw.transpose(-1, -2)).to(p.dtype)


def _distributed(w: torch.Tensor, b: torch.Tensor, ident: torch.Tensor,
                 up: torch.Tensor) -> torch.Tensor:
    """``conv1x1(z)`` without z: the identity slice's conv, then each
    upsampled piece added in turn, one rounding an add."""
    y = conv2d(ident, w, b)
    for piece in up:
        y = y + piece
    return y


def fused_psp_encoding(psp: PyramidPooling, enc: Encoding, c4: torch.Tensor, *, pid: int,
                       groups: int, kv_stride: int):
    """NCHW c4 -> (q tokens, v map, q_c, k_c, v_c): what ``apply_encoding_full``
    and ``apply_encoding_cached(pool_before_proj=True)`` give on the grouped
    pyramid feature, computed without building it. Tokens are [n, L, d], the
    v map [n, d_v, H, W].

    The first layers of the three projections (w_qs's conv0, w_vs, w_ks's
    conv0) run as one weight of their stacked output channels (``enc.trunk``,
    laid out once by the ``Streamer``, or for this call): each output channel
    is still its own sum, rounded once. The pieces are projected once
    for both resolutions (as JAX's calls compute them twice, to the same
    values), upsampled at full resolution for q and v and at the cache's
    stride for q, k and v."""
    n, c, h, w = c4.shape
    g = c // groups
    id_map = c4[:, pid * g:(pid + 1) * g]
    pieces = _psp_pieces(psp, c4, pid, groups)                  # [4, n, gq, 6, 6]
    tw = enc.trunk if enc.trunk is not None else trunk_weights(enc)
    dqv = tw.dq + tw.dv
    p = torch.matmul(tw.w_pieces[:, None], pieces.flatten(-2))              # [4, n, D, 36]
    p = p.unflatten(-1, pieces.shape[-2:])
    full = _distributed(tw.w_id[:dqv], tw.bias[:dqv], id_map,
                        _upsampled(p[:, :, :dqv], (h, w), None))
    s = kv_stride
    sub = _distributed(tw.w_id, tw.bias, id_map[:, :, ::s, ::s], _upsampled(p, (h, w), s))
    proj2 = lambda p2, y: p2.conv1(p2.bn0(y, "leaky_relu"))
    q_full, v_map = proj2(enc.w_qs, full[:, :tw.dq]), full[:, tw.dq:]
    q_c, v_c, k_c = (proj2(enc.w_qs, sub[:, :tw.dq]), sub[:, tw.dq:dqv],
                     proj2(enc.w_ks, sub[:, dqv:]))
    return tokens(q_full), v_map, tokens(q_c), tokens(k_c), tokens(v_c)
