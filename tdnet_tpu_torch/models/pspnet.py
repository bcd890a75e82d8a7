"""The single-frame PSPNet baseline (reference Testing/model/pspnet/pspnet.py,
``tdnet_tpu/models/pspnet.py``): a dilated ResNet, the PSP head, and for
training an aux FCN head on c3. The reference's ``--model psp101`` runs it
with a ResNet-101 per frame, the speed/accuracy yardstick of TDNet.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from tdnet_tpu_torch.nn import (BACKBONES, Ctx, FCNHead, PSPHead, ResNet, apply_fcn_head,
                                apply_psp_head, init_fcn_head, init_psp_head, init_resnet)
from tdnet_tpu_torch.ops import resize_bilinear


@dataclasses.dataclass(frozen=True)
class PSPNetConfig:
    nclass: int = 19
    backbone: str = "resnet101"
    in_size: tuple[int, int] = (769, 1537)
    aux: bool = False

    @property
    def expansion(self) -> int:
        return 4 if self.backbone in ("resnet50", "resnet101", "resnet152") else 1

    @property
    def channels(self) -> int:
        return 512 * self.expansion

    @property
    def backbone_cfg(self):
        return BACKBONES[self.backbone]()


class PSPNet(nn.Module):
    def __init__(self, cfg: PSPNetConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.backbone = ResNet(cfg.backbone_cfg, device)
        self.head = PSPHead(cfg.channels, cfg.nclass, device)
        if cfg.aux:
            self.aux = FCNHead(256 * cfg.expansion, cfg.nclass, chn_down=4, device=device)


def init_pspnet(cfg: PSPNetConfig, generator: torch.Generator, device=None) -> PSPNet:
    """A PSPNet with the reference's init distributions, drawn from ``generator``."""
    net = PSPNet(cfg, device)
    init_resnet(net.backbone, generator)
    init_psp_head(net.head, generator)
    if cfg.aux:
        init_fcn_head(net.aux, generator)
    return net


def apply_pspnet(net: PSPNet, img: torch.Tensor, ctx: Ctx, return_aux: bool = False):
    """NHWC frame [n, H, W, 3] -> logits NHWC [n, H, W, nclass] at ``cfg.in_size``;
    with ``return_aux`` and an aux head, (logits, aux logits)."""
    cfg = net.cfg
    c3, c4 = net.backbone(img.permute(0, 3, 1, 2).contiguous(), ctx)
    out = resize_bilinear(apply_psp_head(net.head, c4, ctx), cfg.in_size).permute(0, 2, 3, 1)
    if return_aux and cfg.aux:
        aux = resize_bilinear(apply_fcn_head(net.aux, c3, ctx), cfg.in_size)
        return out, aux.permute(0, 2, 3, 1)
    return out
