"""Bilinear resize with ``align_corners=True`` (NCHW).

Every upsample in the reference nets is
``F.interpolate(mode='bilinear', align_corners=True)``
(Testing/model/pspnet/td4_psp18.py:27); the port calls it directly, in f32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tdnet_tpu_torch.ops.dtype import at_least_f32


def resize_bilinear(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """Align-corners bilinear resize of NCHW ``x`` to ``out_hw``, computed in f32
    (or wider)."""
    if tuple(x.shape[-2:]) == tuple(out_hw):
        return x
    y = F.interpolate(at_least_f32(x), size=tuple(out_hw), mode="bilinear", align_corners=True)
    return y.to(x.dtype)
