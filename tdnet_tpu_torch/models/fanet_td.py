"""TD2-FANet (``tdnet_tpu/models/fanet_td.py``): two FANet-18 sub-networks
with attention propagation.

The architecture of the reference's unfinished td2_fa
(Training/ptsemseg/models/td2_fanet/td2_fa.py), as the JAX package builds it:
a sub-network is the 4-scale FANet ResNet, then the FAModule chain
(32 -> 16 -> 8 -> 4, fast attention at every scale), z = cat(upsample(smooth16),
smooth4) at the 1/8 grid with 256 channels, the QKV encoding (d_model 256,
d_k 64, d_v 256, projected before the stride-3 subsample), one propagation
hop, the LayerNorm on the 1/8 grid and the ``FPNOutput`` head. ``head_aux``
is kept for checkpoint parity; no loss reads it (td2_fa.py:205-211).

``fa_stream_step`` steps one sub-network over a frame with the port's
``StreamCache`` ring (window 1), its hop through ``_hop_chain``: K1 with the
fc, at d_v 256. ``fa_clip_forward`` is the training twin, unrolled.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from tdnet_tpu_torch.models.tdnet import StreamCache, _hop_chain
from tdnet_tpu_torch.nn import (Attention, Ctx, Encoding, apply_encoding_cached,
                                apply_encoding_full, init_attention, init_encoding)
from tdnet_tpu_torch.nn.encoding import tokens
from tdnet_tpu_torch.nn.fanet import (FANET_BACKBONES, FAModule, FANetResNet, FPNOutput,
                                      apply_fa_module, init_fanet_module)
from tdnet_tpu_torch.ops import LayerNorm2d, grid_subsample, resize_bilinear


@dataclasses.dataclass(frozen=True)
class FATDConfig:
    nclass: int = 19
    backbone: str = "resnet18"
    path_num: int = 2
    in_size: tuple[int, int] = (768, 1536)
    d_k: int = 64
    d_model: int = 256
    kv_stride: int = 3
    pool_before_proj: bool = False
    aux: bool = False  # td2_fa has head_aux parameters but no aux loss

    @property
    def backbone_cfg(self):
        return FANET_BACKBONES[self.backbone]()

    @property
    def expansion(self) -> int:
        return self.backbone_cfg.expansion

    @property
    def d_v(self) -> int:
        return self.d_model

    @property
    def window(self) -> int:
        return self.path_num - 1

    @property
    def feat_hw(self) -> tuple[int, int]:
        """The z grid: stem, max-pool and layer1 each halve (``FANetResNetConfig``)."""
        h, w = self.in_size
        for _ in range(3):
            h, w = (h - 1) // 2 + 1, (w - 1) // 2 + 1
        return h, w

    @property
    def kv_hw(self) -> tuple[int, int]:
        h, w = self.feat_hw
        s = self.kv_stride
        return (h + s - 1) // s, (w + s - 1) // s

    @property
    def kv_tokens(self) -> int:
        h, w = self.kv_hw
        return h * w

    def psp_pid(self, p: int) -> int:  # the TDNetConfig's interface; FANet has no PSP
        return p


class FASubNet(nn.Module):
    def __init__(self, cfg: FATDConfig, device=None):
        super().__init__()
        e = cfg.expansion
        self.backbone = FANetResNet(cfg.backbone_cfg, device)
        self.ffm_32 = FAModule(512 * e, 128, device)
        self.ffm_16 = FAModule(256 * e, 128, device)
        self.ffm_8 = FAModule(128 * e, 128, device)
        self.ffm_4 = FAModule(64 * e, 128, device)
        self.enc = Encoding(cfg.d_model, cfg.d_k, cfg.d_v, device)
        self.ln = LayerNorm2d(*cfg.feat_hw, device=device)
        self.head = FPNOutput(cfg.d_model, 256, cfg.nclass, device)
        self.head_aux = FPNOutput(128, 64, cfg.nclass, device)


class FATD(nn.Module):
    """``paths[p]``: sub-network p; ``atn[p][0]``: its one hop's fc."""

    def __init__(self, cfg: FATDConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.paths = nn.ModuleList(FASubNet(cfg, device) for _ in range(cfg.path_num))
        self.atn = nn.ModuleList(
            nn.ModuleList(Attention(cfg.d_v, device) for _ in range(cfg.window))
            for _ in range(cfg.path_num))


def init_fatd(cfg: FATDConfig, generator: torch.Generator, device=None) -> FATD:
    """A trainable FATD with the JAX package's init distributions (every conv
    kaiming_normal(a=1)), drawn from ``generator``."""
    model = FATD(cfg, device)
    for sub in model.paths:
        for part in (sub.backbone, sub.ffm_32, sub.ffm_16, sub.ffm_8, sub.ffm_4, sub.head,
                     sub.head_aux):
            init_fanet_module(part, generator)
        init_encoding(sub.enc, generator)
    for row in model.atn:
        for atn in row:
            init_attention(atn, generator)
    return model


def init_fa_cache(cfg: FATDConfig, batch: int = 1, dtype=torch.float32,
                  device=None) -> StreamCache:
    w, l = cfg.window, cfg.kv_tokens
    z = lambda d: torch.zeros((w, batch, l, d), dtype=dtype, device=device)
    return StreamCache(q=z(cfg.d_k), k=z(cfg.d_k), v=z(cfg.d_v))


def fa_trunk(sub: FASubNet, x: torch.Tensor) -> torch.Tensor:
    """Backbone and the FAModule chain: NCHW image -> z [n, 256, *feat_hw]."""
    f4, f8, f16, f32 = sub.backbone(x)
    up32, = apply_fa_module(sub.ffm_32, f32, None, up_flag=True, smf_flag=True)
    up16, sm16 = apply_fa_module(sub.ffm_16, f16, up32, up_flag=True, smf_flag=True)
    up8, = apply_fa_module(sub.ffm_8, f8, up16, up_flag=True, smf_flag=False)
    sm4, = apply_fa_module(sub.ffm_4, f4, up8, up_flag=False, smf_flag=True)
    return torch.cat([resize_bilinear(sm16, sm4.shape[-2:]), sm4], dim=1)


def fa_stream_step(sub: FASubNet, atn_p, cache: StreamCache, img: torch.Tensor,
                   cfg: FATDConfig, pid: int | None = None, ctx: Ctx | None = None) -> torch.Tensor:
    """One frame through one sub-network; updates ``cache`` in place.

    ``img`` NHWC [n, H, W, 3] -> logits NHWC [n, H, W, nclass]. The cached q
    is the current q subsampled (the projections come before the subsample,
    so it is the JAX package's cached q); ``pid`` and ``ctx`` are the TDNet
    step's interface (eval only).
    """
    z = fa_trunk(sub, img.permute(0, 3, 1, 2).contiguous())
    q_cur, feat = apply_encoding_full(sub.enc, z)
    if cache.count >= cfg.window:
        # while the cache is cold the reference adds zeros: skip the hop
        feat = feat + _hop_chain(atn_p, cache.ordered(cache.k), cache.ordered(cache.v),
                                 cache.ordered(cache.q), q_cur, cfg)
    out = resize_bilinear(sub.head(sub.ln(feat)), cfg.in_size)

    _, k_c, v_c = apply_encoding_cached(sub.enc, z, kv_stride=cfg.kv_stride,
                                        pool_before_proj=cfg.pool_before_proj, with_q=False)
    n, h, w = z.shape[0], *cfg.feat_hw
    q_map = q_cur.transpose(1, 2).reshape(n, cfg.d_k, h, w)
    slot = cache.head
    cache.q[slot].copy_(tokens(grid_subsample(q_map, cfg.kv_stride)))
    cache.k[slot].copy_(k_c)
    cache.v[slot].copy_(v_c)
    cache.head = (slot + 1) % cfg.window
    cache.count += 1
    return out.permute(0, 2, 3, 1)


def _head_once(head: FPNOutput, x: torch.Tensor) -> torch.Tensor:
    """``head(x)`` leaving its BatchNorm's running statistics as they were: the
    JAX package runs the head's second pass on the original parameters and
    drops its update (``fanet_td.py:226-237``). The pass updates copies of the
    buffers (the originals stay as autograd saved them)."""
    bn = head.conv.bn
    saved = bn.running_mean, bn.running_var
    bn.running_mean, bn.running_var = saved[0].clone(), saved[1].clone()
    try:
        return head(x)
    finally:
        bn.running_mean, bn.running_var = saved


def fa_clip_forward(model: FATD, frames: torch.Tensor, pos_id: int, ctx: Ctx) -> dict:
    """A clip of P frames (axis 0: oldest .. current) in one step, the unrolled
    form of ``tdnet_tpu/models/fanet_td.py:fa_clip_forward``: ``out`` and
    ``out_sub`` (logits NCHW at the input size), ``out_lowres`` and
    ``out_sub_lowres`` (at the 1/8 grid, for KD); no aux output.

    BatchNorm statistics follow the JAX rules by running only what is used:
    every trunk once; the other paths' cached encodings (w_qs, w_ks, w_vs, no
    statistic frozen); the current path's encoding at full resolution only
    (the JAX package overwrites its cached pass's updates); the head's
    update once, from ``feat``, the second pass's dropped.
    """
    cfg = model.cfg
    p_num = cfg.path_num
    sigma = [(pos_id + 1 + j) % p_num for j in range(cfg.window)]
    cached = {}
    for s in range(p_num):
        sub = model.paths[s]
        z = fa_trunk(sub, frames[(s - pos_id - 1) % p_num].permute(0, 3, 1, 2).contiguous())
        if s == pos_id:
            z_cur = z
        else:
            cached[s] = apply_encoding_cached(sub.enc, z, kv_stride=cfg.kv_stride,
                                              pool_before_proj=cfg.pool_before_proj)
    sel = model.paths[pos_id]
    q_cur, v_cur = apply_encoding_full(sel.enc, z_cur)
    qs, ks, vs = zip(*(cached[s] for s in sigma))
    v_prop = _hop_chain(model.atn[pos_id], ks, vs, qs, q_cur, cfg, ctx)
    out_lr = sel.head(sel.ln(v_prop + v_cur))
    out_sub_lr = _head_once(sel.head, sel.ln(v_cur))
    return {"out": resize_bilinear(out_lr, cfg.in_size),
            "out_sub": resize_bilinear(out_sub_lr, cfg.in_size),
            "out_lowres": out_lr, "out_sub_lowres": out_sub_lr}
