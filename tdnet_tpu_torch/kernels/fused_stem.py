"""The deep-base stem tail, fused (K4): conv1 + BN + ReLU -> conv2 + BN + ReLU ->
max-pool 3/2/1, inference only.

``stem_impl="fused"`` runs it on deep-base backbones (ResNet-50/101/152) in
eval mode, as ``tdnet_tpu/nn/resnet.py:247-271`` runs the TPU kernel
``tdnet_tpu/kernels/fused_stem.py``. The CUDA kernel is ``csrc/fused_stem.cu``;
``fused_stem_plain`` is its plain PyTorch version: the port's unfused eval
ops (``conv2d``, ``batch_norm_folded``, the same again, ``max_pool``), whose
rounding points the kernel keeps.

``stem_tail`` checks the weights and lays them out once per model (the
runners call it through ``ResNet.fold_stem``); ``fused_stem_tail`` takes the
plain version for CPU tensors and the kernel for CUDA tensors;
``fused_stem_tail.launches`` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from tdnet_tpu_torch.kernels.build import load_library
from tdnet_tpu_torch.ops.conv import conv2d
from tdnet_tpu_torch.ops.norm import batch_norm_folded
from tdnet_tpu_torch.ops.pool import max_pool

SOURCES = ("fused_stem.cu",)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
C_IN, C_MID, C_OUT = 64, 64, 128


def fused_stem_plain(x: torch.Tensor, w1: torch.Tensor, sb1: torch.Tensor, w2: torch.Tensor,
                     sb2: torch.Tensor) -> torch.Tensor:
    """x [n, 64, H, W] -> [n, 128, (H + 1) // 2, (W + 1) // 2] in x's dtype."""
    y = batch_norm_folded(conv2d(x, w1, padding=1), sb1[0], sb1[1], activation="relu")
    y = batch_norm_folded(conv2d(y, w2, padding=1), sb2[0], sb2[1], activation="relu")
    return max_pool(y, 3, 2, 1)


def build() -> ctypes.CDLL:
    """Compile (or reuse) the kernel library and declare its C interface; needs nvcc."""
    lib = load_library("fused_stem", SOURCES)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.tdnet_fused_stem.argtypes = [p] * 6 + [i] * 4 + [p]
    lib.tdnet_fused_stem.restype = ctypes.c_int
    lib.tdnet_cuda_error_string.argtypes = [ctypes.c_int]
    lib.tdnet_cuda_error_string.restype = ctypes.c_char_p
    return lib


class StemTail(NamedTuple):
    """The tail's weights, laid out once per model: OIHW w1 [64, 64, 3, 3] and
    w2 [128, 64, 3, 3] in the activations' dtype, the folded eval BN pairs sb1
    [2, 64] and sb2 [2, 128] in f32 (row 0 scale, row 1 bias: the stem's bn1
    and the ResNet's bn1), and on the card the kernel's tap-major copies
    [9, ci, co] of w1 and w2."""
    w1: torch.Tensor
    sb1: torch.Tensor
    w2: torch.Tensor
    sb2: torch.Tensor
    w1_taps: torch.Tensor | None
    w2_taps: torch.Tensor | None


def stem_tail(w1: torch.Tensor, sb1: torch.Tensor, w2: torch.Tensor,
              sb2: torch.Tensor) -> StemTail:
    """Check the tail's weights and lay them out for ``fused_stem_tail``."""
    want = {"w1": (C_MID, C_IN, 3, 3), "w2": (C_OUT, C_MID, 3, 3), "sb1": (2, C_MID),
            "sb2": (2, C_OUT)}
    for name, t in (("w1", w1), ("sb1", sb1), ("w2", w2), ("sb2", sb2)):
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{name} {tuple(t.shape)}: the fused stem takes {want[name]}")
        if t.device != w1.device:
            raise ValueError(f"{name} on {t.device}, w1 on {w1.device}")
    if w1.dtype not in _DTYPE_CODE or w2.dtype != w1.dtype:
        raise ValueError(f"the fused stem takes float32 or bfloat16 weights, got {w1.dtype}, "
                         f"{w2.dtype}")
    if sb1.dtype != torch.float32 or sb2.dtype != torch.float32:
        raise ValueError("the folded BN pairs are float32")
    taps = lambda wt: wt.permute(2, 3, 1, 0).reshape(9, wt.shape[1], wt.shape[0]).contiguous()
    on_card = w1.device.type == "cuda"
    return StemTail(w1, sb1.contiguous(), w2, sb2.contiguous(), taps(w1) if on_card else None,
                    taps(w2) if on_card else None)


def fused_stem_tail(x: torch.Tensor, tail: StemTail) -> torch.Tensor:
    """conv1 + BN + ReLU -> conv2 + BN + ReLU -> max-pool(3, 2, 1), fused.

    x: [n, 64, H, W], conv0's output after its BN + ReLU, in the dtype of the
    weights of ``tail`` (``stem_tail``). Returns [n, 128, (H+1)//2, (W+1)//2]."""
    if x.dim() != 4 or x.shape[1] != C_IN:
        raise ValueError(f"x {tuple(x.shape)}: the fused stem takes [n, {C_IN}, H, W]")
    if x.device != tail.w1.device or x.dtype != tail.w1.dtype:
        raise ValueError(f"x is {x.dtype} on {x.device}, the weights {tail.w1.dtype} on "
                         f"{tail.w1.device}")
    if x.device.type == "cpu":
        return fused_stem_plain(x, tail.w1, tail.sb1, tail.w2, tail.sb2)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    n, _, h, w = x.shape
    x = x.contiguous()
    y = torch.empty((n, C_OUT, (h + 1) // 2, (w + 1) // 2), dtype=x.dtype, device=x.device)
    lib = build()
    err = lib.tdnet_fused_stem(x.data_ptr(), tail.w1_taps.data_ptr(), tail.sb1.data_ptr(),
                               tail.w2_taps.data_ptr(), tail.sb2.data_ptr(), y.data_ptr(), n, h,
                               w, _DTYPE_CODE[x.dtype],
                               torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused stem kernel failed: CUDA error {err}: "
                           f"{lib.tdnet_cuda_error_string(err).decode()}")
    fused_stem_tail.launches += 1
    return y


fused_stem_tail.launches = 0
