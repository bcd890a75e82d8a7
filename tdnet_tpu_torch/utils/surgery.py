"""Checkpoint surgery: a single-path PSPNet checkpoint -> teacher / student
(``tdnet_tpu/utils/surgery.py``; the reference's channel-regathering
splitters, Training/ptsemseg/utils.py:70-202).

The source PSPNet head's first conv consumes the full pyramid concat
[identity(C) | f1..f4(C/4 each)] (2C channels). The grouped nets consume
[identity_g | f1_g..f4_g] where slice g of the identity is C/G wide and of
each pyramid branch C/(4G) wide. Group g's conv weight is therefore the
source weight with input channels gathered at:
  identity: [g*C/G, (g+1)*C/G)
  branch j: [C + j*C/4 + g*C/(4G), ...)        (j = 0..3)
(reference utils.py:95-125: step1 = i_c/2/G, step2 = i_c/8/G with
i_c = 2C.)
"""

from __future__ import annotations

import torch

from tdnet_tpu_torch.nn.resnet import BACKBONES
from tdnet_tpu_torch.utils.torch_import import (_bn, _conv, _prefixed, fcn_head_from_torch,
                                                log_unread, pyramid_from_torch, reader,
                                                resnet_from_torch, strip_module_prefix)


def grouped_head_conv(w_oihw, groups: int, g: int):
    """Gather input channels of the source head conv for group ``g``."""
    i_c = w_oihw.shape[1]
    step1 = i_c // 2 // groups
    step2 = i_c // 8 // groups
    idx = list(range(g * step1, (g + 1) * step1))
    for j in range(4):
        off = i_c * (4 + j) // 8
        idx += list(range(off + g * step2, off + g * step2 + step2))
    return w_oihw[:, idx]


def _head_conv_groups(sd, groups: int) -> list[torch.Tensor]:
    w = _conv(sd, "head.conv5.1", "")["weight"]  # [inter, 2C, 3, 3] OIHW
    return [grouped_head_conv(w, groups, g).contiguous() for g in range(groups)]


def teacher_from_psp_checkpoint(sd, teacher_cfg) -> dict[str, torch.Tensor]:
    """split_psp_state_dict equivalent (reference utils.py:138-202): a
    ``Teacher`` state dict from the state dict of a vanilla grouped-source
    PSPNet (keys pretrained.*, head.conv5.*, auxlayer.*)."""
    sd = reader(strip_module_prefix(sd))
    # For P == 2 the reference's splitter also materializes groups 3,4 as
    # copies of 1,2 (utils.py:181-185) but pspnet_2p loads only
    # grp_state1/2 (pspnet_2p.py:102-107), so two groups are all there is.
    state = {**_prefixed(resnet_from_torch(sd, BACKBONES[teacher_cfg.backbone](),
                                           "pretrained."), "backbone."),
             **_prefixed(pyramid_from_torch(sd, "head.conv5.0."), "psp."),
             **_bn(sd, "head.conv5.2", "head.bn."), **_conv(sd, "head.conv5.5", "head.out.")}
    for g, w in enumerate(_head_conv_groups(sd, teacher_cfg.path_num)):
        state[f"groups.{g}.weight"] = w
    log_unread(sd, "teacher_from_psp_checkpoint")
    return state


def student_bootstrap_from_psp_checkpoint(sd, cfg, state: dict) -> dict[str, torch.Tensor]:
    """split_psp_dict equivalent (reference utils.py:70-135): a freshly
    initialized TDNet's ``state`` (its state dict) with the single-path
    PSPNet checkpoint ``sd`` copied in. Backbone/psp/aux are replicated to
    every path; for P=4 the heads get the 2-group channel-shuffled first conv
    plus the shared bn/out conv (reference td4_psp.py:421-443, heads 1,3 <-
    group 0 and 2,4 <- group 1); for P=2 heads stay at fresh init
    (td2_psp.py:215-233 loads only backbone/psp/aux). Encoding/attention/LN
    stay fresh."""
    sd = reader(strip_module_prefix(sd))
    parts = {"backbone": resnet_from_torch(sd, BACKBONES[cfg.backbone](), "pretrained."),
             "psp": pyramid_from_torch(sd, "head.conv5.0.")}
    if "auxlayer.conv5.0.weight" in sd and cfg.aux:
        parts["aux"] = fcn_head_from_torch(sd, "auxlayer.")
    out = dict(state)
    for p in range(cfg.path_num):
        for name, entries in parts.items():
            out.update(_prefixed(entries, f"paths.{p}.{name}."))
    if cfg.path_num == 4:
        gws = _head_conv_groups(sd, 2)
        shared = {**_bn(sd, "head.conv5.2", "bn."), **_conv(sd, "head.conv5.5", "out.")}
        for p in range(cfg.path_num):
            out[f"paths.{p}.head.conv.weight"] = gws[cfg.psp_pid(p)]  # (0, 1, 0, 1)
            out.update(_prefixed(shared, f"paths.{p}.head."))
    log_unread(sd, "student_bootstrap_from_psp_checkpoint")
    return out
