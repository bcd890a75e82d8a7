"""The frozen grouped-PSP teacher for knowledge distillation
(``tdnet_tpu/models/teacher.py``; reference Training/.../td4_psp/pspnet_4p.py
and td2_psp/pspnet_2p.py).

A ResNet-101 trunk feeds ``path_num`` grouped pyramid-pooling slices (the
branch work shared); each group gets a 3x3 conv (no bias, no norm) to 512
channels; a shared PredLayer gives the full-sum logits and the per-group
logits. Reference quirks kept: with ``compat_swap`` the 4-path teacher's
groups 2 and 3 are crossed (the student at pos_id p trains against group
(0, 2, 1, 3)[p]); the 4-path per-group logits take their input scaled by 4.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from tdnet_tpu_torch.nn import (BACKBONES, Ctx, PredLayer, PyramidPooling, ResNet, apply_pred_layer,
                                apply_pyramid_pooling_groups, init_pred_layer,
                                init_pyramid_pooling, init_resnet)
from tdnet_tpu_torch.ops import Conv2d, init_conv_kaiming


@dataclasses.dataclass(frozen=True)
class TeacherConfig:
    nclass: int = 19
    backbone: str = "resnet101"
    path_num: int = 4
    compat_swap: bool = True  # the 4-path teacher's group order (0, 2, 1, 3)

    @property
    def channels(self) -> int:
        return BACKBONES[self.backbone]().out_channels

    @property
    def group_in(self) -> int:
        return 2 * self.channels // self.path_num


class Teacher(nn.Module):
    def __init__(self, cfg: TeacherConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.backbone = ResNet(BACKBONES[cfg.backbone](), device)
        self.psp = PyramidPooling(cfg.channels, device)
        self.groups = nn.ModuleList(Conv2d(cfg.group_in, 512, 3, padding=1, device=device)
                                    for _ in range(cfg.path_num))
        self.head = PredLayer(512, cfg.nclass, device)


def init_teacher(cfg: TeacherConfig, generator: torch.Generator, device=None) -> Teacher:
    """A frozen, eval-mode teacher with the reference's init distributions."""
    teacher = Teacher(cfg, device)
    init_resnet(teacher.backbone, generator)
    init_pyramid_pooling(teacher.psp, generator)
    for conv in teacher.groups:
        init_conv_kaiming(conv, generator)
    init_pred_layer(teacher.head, generator)
    return freeze(teacher)


def freeze(teacher: Teacher) -> Teacher:
    """Eval mode, no gradients: the reference calls teacher.eval() and freezes
    every parameter (pspnet_4p.py:124-128)."""
    return teacher.eval().requires_grad_(False)


@torch.no_grad()
def apply_teacher(teacher: Teacher, x: torch.Tensor, group_id: int,
                  stem_impl: str = "plain") -> tuple[torch.Tensor, torch.Tensor]:
    """NHWC frame [n, H, W, 3] -> (T_full, T_group) logits NCHW at the c4 grid,
    T_group the group the student at pos_id ``group_id`` trains against.
    ``stem_impl="fused"`` runs the frozen deep-base stem's tail through K4
    (``tdnet_tpu/models/teacher.py:81-86``); the trainer keeps it plain."""
    cfg = teacher.cfg
    if teacher.training:
        raise ValueError("the teacher runs in eval mode (freeze it)")
    _, c4 = teacher.backbone(x.permute(0, 3, 1, 2).contiguous(), Ctx(stem_impl=stem_impl))
    zs = apply_pyramid_pooling_groups(teacher.psp, c4, cfg.path_num)
    gs = [conv(z) for conv, z in zip(teacher.groups, zs)]
    full = apply_pred_layer(teacher.head, sum(gs))
    order = [0, 2, 1, 3] if cfg.path_num == 4 and cfg.compat_swap else list(range(cfg.path_num))
    scale = 4.0 if cfg.path_num == 4 else 1.0
    return full, apply_pred_layer(teacher.head, gs[order[group_id]] * scale)
