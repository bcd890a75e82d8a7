"""Dilated multi-grid ResNet backbones (output stride 8); the BatchNorms
follow the module's ``train()`` / ``eval()``.

Reference: Testing/model/pspnet/resnet.py:114-215, the same geometry as
``tdnet_tpu/nn/resnet.py``:
- layer3: stride 1, dilation 2 (first block conv dilation 1, the rest 2);
- layer4: stride 1, multi-grid dilations [4, 8, 16];
- deep_base (resnet50/101/152): three 3x3 stem convs to 128 channels;
  resnet10/18/34: one 7x7 stem conv to 64 channels.

The forward takes the pass's ``Ctx``, whose options pick the kernels
(``tdnet_tpu/nn/resnet.py:34-68,247-271``): ``stem_impl="fused"`` runs the
deep-base stem's tail (conv1, conv2, the BNs and the max-pool) through K4 in
eval mode; ``conv_wgrad="kernel"`` runs the blocks' stride-1 3x3 convs with
dilation >= 4 through K5 in training. Otherwise the stem is one plain conv
per layer (the JAX package's TPU stem rewrites compute the same function) and
every conv is ``F.conv2d``.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from tdnet_tpu_torch.kernels.dilated_conv import conv2d_dil
from tdnet_tpu_torch.kernels.fused_stem import StemTail, fused_stem_tail, stem_tail
from tdnet_tpu_torch.nn.module import Ctx
from tdnet_tpu_torch.ops import BatchNorm, Conv2d, fold_bn_eval, init_conv_msra_out, max_pool

_MULTI_DILATIONS = (4, 8, 16)
_EVAL = Ctx()


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    block: str                 # 'basic' | 'bottleneck'
    layers: tuple[int, ...]
    deep_base: bool = False
    dilated: bool = True
    multi_grid: bool = True

    @property
    def expansion(self) -> int:
        return 4 if self.block == "bottleneck" else 1

    @property
    def out_channels(self) -> int:
        return 512 * self.expansion


BACKBONES = {
    "resnet10": lambda: ResNetConfig("basic", (1, 1, 1, 1)),
    "resnet18": lambda: ResNetConfig("basic", (2, 2, 2, 2)),
    "resnet34": lambda: ResNetConfig("basic", (3, 4, 6, 3)),
    "resnet50": lambda: ResNetConfig("bottleneck", (3, 4, 6, 3), deep_base=True),
    "resnet101": lambda: ResNetConfig("bottleneck", (3, 4, 23, 3), deep_base=True),
    "resnet152": lambda: ResNetConfig("bottleneck", (3, 8, 36, 3), deep_base=True),
}


def _block_plan(cfg: ResNetConfig):
    """Per-layer list of per-block (stride, dil, prev_dil, in_ch, mid_ch)."""
    plan = []
    inplanes = 128 if cfg.deep_base else 64
    for li, (planes, blocks) in enumerate(zip((64, 128, 256, 512), cfg.layers)):
        if cfg.dilated:
            stride = 1 if li in (2, 3) else (2 if li == 1 else 1)
            dilation = {0: 1, 1: 1, 2: 2, 3: 4}[li]
            multi_grid = cfg.multi_grid and li == 3
        else:
            stride = 1 if li == 0 else 2
            dilation = 1
            multi_grid = False
        layer = []
        for bi in range(blocks):
            if bi == 0:
                if multi_grid:
                    d = _MULTI_DILATIONS[0]
                elif dilation in (1, 2):
                    d = 1
                elif dilation == 4:
                    d = 2
                else:
                    raise ValueError(dilation)
                s = stride
            else:
                d = _MULTI_DILATIONS[bi] if multi_grid else dilation
                s = 1
            layer.append(dict(stride=s, dil=d, prev_dil=dilation,
                              in_ch=inplanes, mid_ch=planes))
            inplanes = planes * cfg.expansion
        plan.append(layer)
    return plan


def _conv3x3(conv: Conv2d, x: torch.Tensor, ctx: Ctx) -> torch.Tensor:
    """A block's 3x3 conv: through K5 in training with ``conv_wgrad="kernel"``
    when it has stride 1 and dilation >= 4 (``tdnet_tpu/nn/resnet.py:51-56``)."""
    if ctx.train and ctx.conv_wgrad == "kernel" and conv.stride == 1 and conv.dilation >= 4:
        return conv2d_dil(x, conv.weight, conv.padding, conv.dilation)
    return conv(x)


class Downsample(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int, device=None):
        super().__init__()
        self.conv = Conv2d(cin, cout, 1, stride=stride, device=device)
        self.bn = BatchNorm(cout, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.bn(self.conv(x))


class BasicBlock(nn.Module):
    def __init__(self, spec: dict, expansion: int = 1, device=None):
        super().__init__()
        cin, mid = spec["in_ch"], spec["mid_ch"]
        self.conv1 = Conv2d(cin, mid, 3, stride=spec["stride"], padding=spec["dil"],
                            dilation=spec["dil"], device=device)
        self.bn1 = BatchNorm(mid, device=device)
        self.conv2 = Conv2d(mid, mid, 3, padding=spec["prev_dil"],
                            dilation=spec["prev_dil"], device=device)
        self.bn2 = BatchNorm(mid, device=device)
        self.downsample = (Downsample(cin, mid, spec["stride"], device)
                           if spec["stride"] != 1 or cin != mid else None)

    def forward(self, x: torch.Tensor, ctx: Ctx = _EVAL) -> torch.Tensor:
        out = self.bn1(_conv3x3(self.conv1, x, ctx), "relu")
        res = x if self.downsample is None else self.downsample(x)
        return self.bn2(_conv3x3(self.conv2, out, ctx), "relu", residual=res)


class Bottleneck(nn.Module):
    def __init__(self, spec: dict, expansion: int = 4, device=None):
        super().__init__()
        cin, mid = spec["in_ch"], spec["mid_ch"]
        cout = mid * expansion
        self.conv1 = Conv2d(cin, mid, 1, device=device)
        self.bn1 = BatchNorm(mid, device=device)
        self.conv2 = Conv2d(mid, mid, 3, stride=spec["stride"], padding=spec["dil"],
                            dilation=spec["dil"], device=device)
        self.bn2 = BatchNorm(mid, device=device)
        self.conv3 = Conv2d(mid, cout, 1, device=device)
        self.bn3 = BatchNorm(cout, device=device)
        self.downsample = (Downsample(cin, cout, spec["stride"], device)
                           if spec["stride"] != 1 or cin != cout else None)

    def forward(self, x: torch.Tensor, ctx: Ctx = _EVAL) -> torch.Tensor:
        out = self.bn1(self.conv1(x), "relu")
        out = self.bn2(_conv3x3(self.conv2, out, ctx), "relu")
        res = x if self.downsample is None else self.downsample(x)
        return self.bn3(self.conv3(out), "relu", residual=res)


def _folded(bn: BatchNorm) -> torch.Tensor:
    """The eval BN's (scale; bias) as one [2, C] f32 tensor."""
    return torch.stack(bn.folded if bn.folded is not None else fold_bn_eval(
        bn.weight.detach(), bn.bias.detach(), bn.running_mean, bn.running_var))


class Stem(nn.Module):
    """7x7/2 conv, or for deep_base 3x3/2 -> BN+ReLU -> 3x3 -> BN+ReLU -> 3x3."""

    def __init__(self, deep_base: bool, device=None):
        super().__init__()
        self.deep_base = deep_base
        if deep_base:
            self.conv0 = Conv2d(3, 64, 3, stride=2, padding=1, device=device)
            self.bn0 = BatchNorm(64, device=device)
            self.conv1 = Conv2d(64, 64, 3, padding=1, device=device)
            self.bn1 = BatchNorm(64, device=device)
            self.conv2 = Conv2d(64, 128, 3, padding=1, device=device)
        else:
            self.conv0 = Conv2d(3, 64, 7, stride=2, padding=3, device=device)
        self.tail: StemTail | None = None

    def train(self, mode: bool = True) -> "Stem":
        self.tail = None    # as BatchNorm drops its fold
        return super().train(mode)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv0(x)
        if self.deep_base:
            x = self.bn0(x, "relu")
            x = self.bn1(self.conv1(x), "relu")
            x = self.conv2(x)
        return x

    def fold_tail(self, bn2: BatchNorm) -> None:
        """K4's weights laid out once, from the BNs' folds; ``bn2`` is the
        ResNet's bn1, the BN after conv2. A mode switch drops them."""
        self.tail = stem_tail(self.conv1.weight, _folded(self.bn1), self.conv2.weight,
                              _folded(bn2))

    def fused(self, x: torch.Tensor, bn2: BatchNorm) -> torch.Tensor:
        """The eval deep-base stem with its tail through K4 (the weights of
        ``fold_tail``, or laid out for this call). Ends after the max-pool."""
        x = self.bn0(self.conv0(x), "relu")
        tail = self.tail if self.tail is not None else stem_tail(
            self.conv1.weight, _folded(self.bn1), self.conv2.weight, _folded(bn2))
        return fused_stem_tail(x, tail)


class ResNet(nn.Module):
    def __init__(self, cfg: ResNetConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.stem = Stem(cfg.deep_base, device)
        self.bn1 = BatchNorm(128 if cfg.deep_base else 64, device=device)
        block = BasicBlock if cfg.block == "basic" else Bottleneck
        for li, layer in enumerate(_block_plan(cfg)):
            self.add_module(f"layer{li + 1}", nn.ModuleList(
                block(spec, cfg.expansion, device) for spec in layer))

    def fold_stem(self) -> None:
        """Lay out the deep-base stem tail's K4 weights once (eval, after the
        BNs' fold); a no-op for the 7x7 stem."""
        if self.cfg.deep_base:
            self.stem.fold_tail(self.bn1)

    def forward(self, x: torch.Tensor, ctx: Ctx = _EVAL) -> tuple[torch.Tensor, torch.Tensor]:
        """NCHW image -> (c3, c4)."""
        if ctx.stem_impl == "fused" and self.cfg.deep_base and not self.training:
            x = self.stem.fused(x, self.bn1)
        else:
            x = max_pool(self.bn1(self.stem(x), "relu"), 3, 2, 1)
        feats = []
        for li in range(4):
            for blk in getattr(self, f"layer{li + 1}"):
                x = blk(x, ctx)
            feats.append(x)
        return feats[2], feats[3]


def init_resnet(net: ResNet, generator: torch.Generator) -> None:
    """The reference's backbone init: msra-out convs; BN scale 1, bias 0."""
    for m in net.modules():
        if isinstance(m, Conv2d):
            init_conv_msra_out(m, generator)
