"""TDNet: P sub-networks over P consecutive frames, with attention
propagation over the other P-1 frames' K/V/Q.

The streaming twins of the reference (Testing/model/pspnet/td4_psp18.py,
td2_psp50.py) and the clip twins used for training
(Training/ptsemseg/models/td4_psp/td4_psp.py, td2_psp/td2_psp.py), as in
``tdnet_tpu/models/tdnet.py``:
- hop h of path p uses attention instance atn{p+1}_{s+1} with
  s = (p + h + 1) mod P; the weights are stored rotated as ``atn[p][h]``;
- grouped-PSP pid = p % 2, in 2 groups for both P = 4 and P = 2;
- d_v = C for P = 4 and C/4 for P = 2; head chn_down 4 / 2;
- clip routing: sub-network s reads frame (s - pos_id - 1) mod P, frame P-1
  being the current one; the chain runs over sigma(j) = (pos_id + 1 + j) mod P.

The streaming cache is a preallocated ring of [W, n, L, d] tensors (W = P - 1) that
each step updates in place; the hop chain reads it oldest frame first.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from tdnet_tpu_torch.nn import (BACKBONES, Attention, Ctx, Encoding, FCNHead, PyramidPooling,
                                ResNet, apply_attention, apply_encoding_cached,
                                apply_encoding_full, apply_fcn_head, apply_pyramid_pooling,
                                init_attention, init_encoding, init_fcn_head,
                                init_pyramid_pooling, init_resnet)
from tdnet_tpu_torch.nn.fused_trunk import fused_psp_encoding
from tdnet_tpu_torch.ops import LayerNorm2d, resize_bilinear


def backbone_feat_hw(in_hw: tuple[int, int]) -> tuple[int, int]:
    """Spatial size of the stride-8 c4 grid for a given input size."""
    h, w = in_hw
    for _ in range(3):  # conv k7 p3 / k3 p1 stride 2, then two more stride-2 stages
        h, w = (h - 1) // 2 + 1, (w - 1) // 2 + 1
    return h, w


@dataclasses.dataclass(frozen=True)
class TDNetConfig:
    nclass: int = 19
    backbone: str = "resnet18"
    path_num: int = 4
    in_size: tuple[int, int] = (769, 1537)
    d_k: int = 64
    kv_stride: int = 4            # 4 when streaming, 3 in training
    pool_before_proj: bool = True  # False only in TD2 training
    aux: bool = False             # the training-only aux head on c3

    @property
    def expansion(self) -> int:
        return 4 if self.backbone in ("resnet50", "resnet101", "resnet152") else 1

    @property
    def channels(self) -> int:
        return 512 * self.expansion

    @property
    def d_v(self) -> int:
        return self.channels if self.path_num == 4 else self.channels // 4

    @property
    def head_chn_down(self) -> int:
        return 4 if self.path_num == 4 else 2

    @property
    def psp_groups(self) -> int:
        return 2

    def psp_pid(self, p: int) -> int:
        return p % 2

    @property
    def window(self) -> int:
        return self.path_num - 1

    @property
    def feat_hw(self) -> tuple[int, int]:
        return backbone_feat_hw(self.in_size)

    @property
    def kv_tokens(self) -> int:
        h, w = self.feat_hw
        s = self.kv_stride
        return ((h + s - 1) // s) * ((w + s - 1) // s)


class SubNet(nn.Module):
    def __init__(self, cfg: TDNetConfig, device=None):
        super().__init__()
        self.backbone = ResNet(BACKBONES[cfg.backbone](), device)
        self.psp = PyramidPooling(cfg.channels, device)
        self.enc = Encoding(cfg.channels, cfg.d_k, cfg.d_v, device)
        self.ln = LayerNorm2d(*cfg.feat_hw, device=device)
        head_in = cfg.d_v if cfg.path_num == 2 else cfg.channels
        self.head = FCNHead(head_in, cfg.nclass, chn_down=cfg.head_chn_down, device=device)
        if cfg.aux:
            self.aux = FCNHead(256 * cfg.expansion, cfg.nclass, chn_down=4, device=device)


class TDNet(nn.Module):
    """``paths[p]``: sub-network p; ``atn[p][h]``: its hop-h attention."""

    def __init__(self, cfg: TDNetConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.paths = nn.ModuleList(SubNet(cfg, device) for _ in range(cfg.path_num))
        self.atn = nn.ModuleList(
            nn.ModuleList(Attention(cfg.d_v, device) for _ in range(cfg.window))
            for _ in range(cfg.path_num))


def init_subnet(sub: SubNet, generator: torch.Generator) -> None:
    init_resnet(sub.backbone, generator)
    init_pyramid_pooling(sub.psp, generator)
    init_encoding(sub.enc, generator)
    init_fcn_head(sub.head, generator)
    if hasattr(sub, "aux"):
        init_fcn_head(sub.aux, generator)


def init_tdnet(cfg: TDNetConfig, generator: torch.Generator, device=None) -> TDNet:
    """A trainable TDNet with the reference's init distributions, drawn from
    ``generator`` (the streaming entry points set eval mode themselves)."""
    model = TDNet(cfg, device)
    for sub in model.paths:
        init_subnet(sub, generator)
    for row in model.atn:
        for atn in row:
            init_attention(atn, generator)
    return model


@dataclasses.dataclass
class StreamCache:
    q: torch.Tensor      # [W, n, L, d_k]
    k: torch.Tensor      # [W, n, L, d_k]
    v: torch.Tensor      # [W, n, L, d_v]
    head: int = 0        # slot of the oldest frame, written next
    count: int = 0       # frames seen

    def ordered(self, t: torch.Tensor) -> list[torch.Tensor]:
        """The W slots of ``t``, oldest frame first."""
        w = t.shape[0]
        return [t[(self.head + h) % w] for h in range(w)]


def init_cache(cfg: TDNetConfig, batch: int = 1, dtype=torch.float32,
               device=None) -> StreamCache:
    w, l = cfg.window, cfg.kv_tokens
    z = lambda d: torch.zeros((w, batch, l, d), dtype=dtype, device=device)
    return StreamCache(q=z(cfg.d_k), k=z(cfg.d_k), v=z(cfg.d_v))


def _hop_chain(atn_p, ks, vs, qs, q_cur, cfg: TDNetConfig, ctx: Ctx | None = None) -> torch.Tensor:
    """The propagation chain (reference td4_psp18.py:145-151).

    ks/vs/qs: per-hop tokens, oldest first, each [n, L, d]. Hop h queries
    with the next newer frame's q, the last hop with the current frame's
    full-resolution q. Returns the map [n, d_v, H, W].
    """
    w = cfg.window
    acc = None
    for h in range(w):
        vin = vs[h] if acc is None else vs[h] + acc
        q = qs[h + 1] if h + 1 < w else q_cur
        acc = apply_attention(atn_p[h], ks[h], vin, q, d_k=cfg.d_k,
                              fea_hw=cfg.feat_hw if h == w - 1 else None, ctx=ctx)
    return acc


def frame_trunk(sub: SubNet, img: torch.Tensor, cfg: TDNetConfig, pid: int, ctx: Ctx):
    """The frame-local work of one sub-network: NHWC ``img`` [n, H, W, 3] ->
    (q_cur, the v map ``feat``, the frame's cached token fields (q_c, k_c, v_c)).

    ``ctx`` (eval) carries the backbone's ``stem_impl`` and ``fused_trunk``:
    the z-free grouped-PSP + QKV encoding (``nn/fused_trunk.py``), taken in
    eval with the projections after the subsample and an int ``pid``, as
    ``tdnet_tpu/models/tdnet.py:209-221`` takes it.
    """
    x = img.permute(0, 3, 1, 2).contiguous()
    _, c4 = sub.backbone(x, ctx)
    if ctx.fused_trunk and not ctx.train and cfg.pool_before_proj and isinstance(pid, int):
        q_cur, feat, q_c, k_c, v_c = fused_psp_encoding(
            sub.psp, sub.enc, c4, pid=pid, groups=cfg.psp_groups, kv_stride=cfg.kv_stride)
    else:
        z = apply_pyramid_pooling(sub.psp, c4, groups=cfg.psp_groups, pid=pid)
        q_cur, feat = apply_encoding_full(sub.enc, z)
        q_c, k_c, v_c = apply_encoding_cached(sub.enc, z, kv_stride=cfg.kv_stride,
                                              pool_before_proj=cfg.pool_before_proj)
    return q_cur, feat, (q_c, k_c, v_c)


def frame_head(sub: SubNet, feat: torch.Tensor, cfg: TDNetConfig) -> torch.Tensor:
    """The recomposed features -> logits NHWC [n, H, W, nclass] at the input size."""
    out = apply_fcn_head(sub.head, sub.ln(feat))
    return resize_bilinear(out, cfg.in_size).permute(0, 2, 3, 1)


def stream_step(sub: SubNet, atn_p, cache: StreamCache, img: torch.Tensor,
                cfg: TDNetConfig, pid: int, ctx: Ctx) -> torch.Tensor:
    """One frame through one sub-network (``frame_trunk``, the hop chain over
    the cache, ``frame_head``); updates ``cache`` in place.

    ``img`` is NHWC [n, H, W, 3]; returns logits NHWC [n, H, W, nclass].
    """
    q_cur, feat, tokens = frame_trunk(sub, img, cfg, pid, ctx)
    if cache.count >= cfg.window:
        # while the cache is cold the reference adds zeros: skip the hops
        feat = feat + _hop_chain(atn_p, cache.ordered(cache.k), cache.ordered(cache.v),
                                 cache.ordered(cache.q), q_cur, cfg)
    out = frame_head(sub, feat, cfg)
    slot = cache.head
    for ring, t in zip((cache.q, cache.k, cache.v), tokens):
        ring[slot].copy_(t)
    cache.head = (slot + 1) % cfg.window
    cache.count += 1
    return out


def clip_forward(model: TDNet, frames: torch.Tensor, pos_id: int, ctx: Ctx) -> dict:
    """A clip of P frames (axis 0: oldest .. current) in one step, the
    unrolled form of ``tdnet_tpu/models/tdnet.py:clip_forward``.

    ``frames`` NHWC [P, n, H, W, 3]. Every sub-network runs on its routed
    frame; the chain recomposes the current frame's features; the current
    path's head gives ``out`` and ``out_sub`` (logits NCHW at the input size)
    and ``out_lowres`` / ``out_sub_lowres`` (at the c4 grid, for KD); in
    training the aux head on the current sub-network's c3 gives ``auxout``.

    BatchNorm statistics follow the JAX rules (tdnet.py:347-390) by running
    only what is used: the current path's head runs twice (two updates); its
    encoding runs only at full resolution (its cached encoding is never read);
    the oldest frame's w_qs does not run (hop h reads the q of frame h + 1).
    """
    cfg = model.cfg
    p_num = cfg.path_num
    sigma = [(pos_id + 1 + j) % p_num for j in range(cfg.window)]
    cached = {}
    for s in range(p_num):
        sub = model.paths[s]
        x = frames[(s - pos_id - 1) % p_num].permute(0, 3, 1, 2).contiguous()
        c3, c4 = sub.backbone(x, ctx)
        z = apply_pyramid_pooling(sub.psp, c4, groups=cfg.psp_groups, pid=cfg.psp_pid(s))
        if s == pos_id:
            c3_cur, z_cur = c3, z
        else:
            cached[s] = apply_encoding_cached(sub.enc, z, kv_stride=cfg.kv_stride,
                                              pool_before_proj=cfg.pool_before_proj,
                                              with_q=s != sigma[0])
    sel = model.paths[pos_id]
    q_cur, v_cur = apply_encoding_full(sel.enc, z_cur)
    qs, ks, vs = zip(*(cached[s] for s in sigma))
    v_prop = _hop_chain(model.atn[pos_id], ks, vs, qs, q_cur, cfg, ctx)
    out_lr = apply_fcn_head(sel.head, sel.ln(v_prop + v_cur), ctx)
    out_sub_lr = apply_fcn_head(sel.head, sel.ln(v_cur), ctx)
    res = {"out": resize_bilinear(out_lr, cfg.in_size),
           "out_sub": resize_bilinear(out_sub_lr, cfg.in_size),
           "out_lowres": out_lr, "out_sub_lowres": out_sub_lr}
    if cfg.aux and ctx.train:
        res["auxout"] = resize_bilinear(apply_fcn_head(sel.aux, c3_cur, ctx), cfg.in_size)
    return res
