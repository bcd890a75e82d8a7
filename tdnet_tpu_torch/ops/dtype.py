"""The compute type of the plain ops: float32, or the input's type where it
is wider (float64, which the parity tests use as their exact reference)."""

from __future__ import annotations

import torch


def at_least_f32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.promote_types(x.dtype, torch.float32))
