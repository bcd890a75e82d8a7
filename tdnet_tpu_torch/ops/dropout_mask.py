"""The dropout keep mask, computed in PyTorch as the CUDA kernels compute it.

``csrc/dropout_hash.cuh`` defines the mask that the training attention (K2)
and the dropout kernel (K3) draw: element ``idx`` is kept when
``hash(seed, idx) < round((1 - rate) * 2**32)``, with ``hash`` built from the
32-bit lowbias32 mixer. This module is the bit-exact twin in int64 tensor
arithmetic (products split into 16-bit halves so that nothing overflows), so
that the plain versions of K2 and K3 use the very mask the kernels use, on any
device. The index of attention element (b, i, j) is (b * Lq + i) * Lkv + j;
of dropout element (row, c) over [rows, C] it is row * C + c.
"""

from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF
_C1, _C2 = 0x7FEB352D, 0x846CA68B


def keep_threshold(rate: float) -> int:
    """round((1 - rate) * 2**32): keep when the hash is below it."""
    if not 0.0 < rate < 1.0:
        raise ValueError(f"dropout rate must lie in (0, 1), got {rate}")
    return round((1.0 - rate) * 2.0**32)


def mix32_int(x: int) -> int:
    """The mixer on one Python int (for the seed and the tests)."""
    x ^= x >> 16
    x = (x * _C1) & _M32
    x ^= x >> 15
    x = (x * _C2) & _M32
    return x ^ (x >> 16)


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for int64 x in [0, 2**32) without int64 overflow."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _M32


def mix32(x: torch.Tensor) -> torch.Tensor:
    x = x ^ (x >> 16)
    x = _mul32(x, _C1)
    x = x ^ (x >> 15)
    x = _mul32(x, _C2)
    return x ^ (x >> 16)


def dropout_hash(seed: int, idx: torch.Tensor) -> torch.Tensor:
    """hash(seed, idx) as int64 values in [0, 2**32), for int64 ``idx`` >= 0."""
    s = mix32_int(seed & _M32)
    return mix32((idx & _M32) ^ mix32((idx >> 32) ^ s))


def keep_mask(seed: int, rate: float, shape: tuple[int, ...], device=None) -> torch.Tensor:
    """The bool keep mask over a contiguous tensor of ``shape``, element index
    = its flat row-major offset."""
    n = 1
    for d in shape:
        n *= d
    idx = torch.arange(n, dtype=torch.int64, device=device)
    return (dropout_hash(seed, idx) < keep_threshold(rate)).reshape(shape)
