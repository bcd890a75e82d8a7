"""FANet blocks (``tdnet_tpu/nn/fanet.py``): the standard-stride ResNet,
``FAModule`` (linear "fast attention" with the FPN lateral, up and smooth
convs) and the ``FPNOutput`` head, NCHW.

Reference: Training/ptsemseg/models/td2_fanet/{resnet.py,td2_fa.py}. Every
conv has no bias and a BatchNorm after it (``ConvBN``), its activation
fused in. Quirks kept for checkpoint parity, as the JAX package keeps them:
- ``FAModule.up`` is a 1x1 conv with padding 1 (td2_fa.py:348): it grows the
  map by 2 px a side, and the next upsample-add interpolates that away;
- the BasicBlock: leaky-ReLU fused into bn1, a linear bn2, a plain ReLU after
  the residual add (resnet.py:34-65);
- every backbone takes strides (2, 2, 2, 2), layer1's too (resnet.py:156-188),
  so the first feature is at 1/8 of the input.

The linear attention keeps the JAX package's rounding points
(``tdnet_tpu/nn/fanet.py:163-185``): the L2 norm summed in f32 and cast to
the input's dtype; k^T v and q f each summed in f32, f rounded to q's dtype
before the second product. Both products are plain matrix products.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from tdnet_tpu_torch.ops import BatchNorm, Conv2d, init_conv_kaiming, max_pool, resize_bilinear
from tdnet_tpu_torch.ops.dtype import at_least_f32


class ConvBN(nn.Module):
    """A conv without bias and its BatchNorm (``init_conv_bn``'s pair)."""

    def __init__(self, cin: int, cout: int, k: int, *, stride: int = 1, padding: int = 0,
                 device=None):
        super().__init__()
        self.conv = Conv2d(cin, cout, k, stride=stride, padding=padding, device=device)
        self.bn = BatchNorm(cout, device=device)

    def forward(self, x: torch.Tensor, activation: str | None = None) -> torch.Tensor:
        return self.bn(self.conv(x), activation)


@dataclasses.dataclass(frozen=True)
class FANetResNetConfig:
    block: str = "basic"
    layers: tuple[int, ...] = (2, 2, 2, 2)
    strides: tuple[int, ...] = (2, 2, 2, 2)

    @property
    def expansion(self) -> int:
        return 4 if self.block == "bottleneck" else 1


FANET_BACKBONES = {
    "resnet18": lambda: FANetResNetConfig("basic", (2, 2, 2, 2)),
    "resnet34": lambda: FANetResNetConfig("basic", (3, 4, 6, 3)),
    "resnet50": lambda: FANetResNetConfig("bottleneck", (3, 4, 6, 3)),
}


def block_plan(cfg: FANetResNetConfig):
    """Per layer, per block (stride, in channels, planes, whether it has a downsample)."""
    plan, inplanes = [], 64
    for planes, n, stride in zip((64, 128, 256, 512), cfg.layers, cfg.strides):
        layer = []
        for bi in range(n):
            s = stride if bi == 0 else 1
            cout = planes * cfg.expansion
            layer.append((s, inplanes, planes, inplanes != cout or s != 1))
            inplanes = cout
        plan.append(layer)
    return plan


class FABlock(nn.Module):
    """BasicBlock (conv1 3x3/s leaky, conv2 3x3 linear) or Bottleneck (1x1
    leaky, 3x3/s leaky, 1x1 linear); ReLU after the residual add."""

    def __init__(self, kind: str, s: int, cin: int, planes: int, down: bool, device=None):
        super().__init__()
        self.kind = kind
        if kind == "basic":
            self.conv1 = ConvBN(cin, planes, 3, stride=s, padding=1, device=device)
            self.conv2 = ConvBN(planes, planes, 3, padding=1, device=device)
            cout = planes
        else:
            self.conv1 = ConvBN(cin, planes, 1, device=device)
            self.conv2 = ConvBN(planes, planes, 3, stride=s, padding=1, device=device)
            self.conv3 = ConvBN(planes, planes * 4, 1, device=device)
            cout = planes * 4
        self.downsample = ConvBN(cin, cout, 1, stride=s, device=device) if down else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.conv1(x, "leaky_relu")
        if self.kind == "basic":
            out = self.conv2(out)
        else:
            out = self.conv3(self.conv2(out, "leaky_relu"))
        sc = x if self.downsample is None else self.downsample(x)
        return F.relu(sc + out)


class FANetResNet(nn.Module):
    def __init__(self, cfg: FANetResNetConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.stem = ConvBN(3, 64, 7, stride=2, padding=3, device=device)
        for li, layer in enumerate(block_plan(cfg)):
            self.add_module(f"layer{li + 1}", nn.ModuleList(
                FABlock(cfg.block, *spec, device=device) for spec in layer))

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        """NCHW image -> [feat4, feat8, feat16, feat32] (strides 8 to 64)."""
        x = max_pool(self.stem(x, "leaky_relu"), 3, 2, 1)
        feats = []
        for li in range(4):
            for blk in getattr(self, f"layer{li + 1}"):
                x = blk(x)
            feats.append(x)
        return feats


class FAModule(nn.Module):
    def __init__(self, in_chan: int, out_chan: int = 128, device=None):
        super().__init__()
        self.w_qs = ConvBN(in_chan, 32, 1, device=device)
        self.w_ks = ConvBN(in_chan, 32, 1, device=device)
        self.w_vs = ConvBN(in_chan, in_chan, 1, device=device)
        self.latlayer3 = ConvBN(in_chan, in_chan, 1, device=device)
        self.up = ConvBN(in_chan, in_chan // 2, 1, padding=1, device=device)
        self.smooth = ConvBN(in_chan, out_chan, 3, padding=1, device=device)


def _l2norm(x: torch.Tensor, dim: int, eps: float = 1e-12) -> torch.Tensor:
    n = at_least_f32(x).square().sum(dim, keepdim=True).sqrt()
    return x / n.clamp_min(eps).to(x.dtype)


def linear_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """y = l2norm(q)ᵀ (l2norm(k) vᵀ) over the tokens of NCHW maps (q, k
    [n, 32, H, W], v [n, C, H, W]) -> [n, C, H, W] in v's dtype."""
    n, c, h, w = v.shape
    qt, kt = _l2norm(q.flatten(2), 1), _l2norm(k.flatten(2), 1)        # [n, 32, L]
    f = torch.matmul(at_least_f32(kt), at_least_f32(v.flatten(2)).transpose(1, 2))  # [n, 32, C]
    y = torch.matmul(at_least_f32(f.to(qt.dtype)).transpose(1, 2), at_least_f32(qt))
    return y.to(v.dtype).reshape(n, c, h, w)


def apply_fa_module(fa: FAModule, feat: torch.Tensor, up_fea_in: torch.Tensor | None, *,
                    up_flag: bool, smf_flag: bool) -> tuple[torch.Tensor, ...]:
    """The reference's flag combinations (td2_fa.py:353-398): (up?, smooth?)."""
    y = linear_attention(fa.w_qs(feat), fa.w_ks(feat), fa.w_vs(feat, "leaky_relu"))
    p_feat = fa.latlayer3(y, "leaky_relu") + feat
    if up_fea_in is not None:
        p_feat = resize_bilinear(up_fea_in, p_feat.shape[-2:]) + p_feat
    outs = []
    if up_flag:
        outs.append(fa.up(p_feat, "leaky_relu"))
    if smf_flag and (not up_flag or up_fea_in is not None):
        outs.append(fa.smooth(p_feat, "leaky_relu"))
    return tuple(outs)


class FPNOutput(nn.Module):
    """3x3 ConvBN with leaky-ReLU, then a 1x1 conv to nclass without bias."""

    def __init__(self, in_chan: int, mid_chan: int, nclass: int, device=None):
        super().__init__()
        self.conv = ConvBN(in_chan, mid_chan, 3, padding=1, device=device)
        self.conv_out = Conv2d(mid_chan, nclass, 1, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv_out(self.conv(x, "leaky_relu"))


def init_fanet_module(module: nn.Module, generator: torch.Generator) -> None:
    """Every conv of a FANet part: kaiming_normal(a=1), as ``init_conv_bn``; BN
    scale 1, bias 0 (the modules' own)."""
    for m in module.modules():
        if isinstance(m, Conv2d):
            init_conv_kaiming(m, generator)
