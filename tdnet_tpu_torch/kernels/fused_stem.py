"""The deep-base stem tail, fused (K4): conv1 + BN + ReLU -> conv2 + BN + ReLU ->
max-pool 3/2/1, inference only.

``stem_impl="fused"`` runs it on deep-base backbones (ResNet-50/101/152) in
eval mode, as ``tdnet_tpu/nn/resnet.py:247-271`` runs the TPU kernel
``tdnet_tpu/kernels/fused_stem.py``. The CUDA kernel is ``csrc/fused_stem.cu``
(bf16 on wgmma, f32 in 3xTF32 on mma.sync; a block marches down a strip of
pooled columns); ``fused_stem_plain`` is its plain PyTorch version:
the port's unfused eval ops (``conv2d``, ``batch_norm_folded``, the same
again, ``max_pool``), whose rounding points the kernel keeps.

``stem_tail`` checks the weights and lays them out once per model (the
runners call it through ``ResNet.fold_stem``): on the card, the kernel's
weight chunks (``weight_chunks``). ``stem_plan`` sizes the kernel's grid;
``fused_stem_tail`` takes the plain version for CPU tensors and the kernel
for CUDA tensors; ``fused_stem_tail.launches`` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from tdnet_tpu_torch.kernels.build import load_library
from tdnet_tpu_torch.kernels.grid import sm_count
from tdnet_tpu_torch.ops.conv import conv2d
from tdnet_tpu_torch.ops.norm import batch_norm_folded
from tdnet_tpu_torch.ops.pool import max_pool

SOURCES = ("fused_stem.cu",)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
C_IN, C_MID, C_OUT = 64, 64, 128
# the kernel's window: GEMM rows of one image row, and the pooled columns of a strip,
# (WINDOW - 5) // 2 (csrc/fused_stem.cu: Bf16::WT, F32::WT, Geo::PW; the kernel refuses a
# strip count that its own strip width does not give)
WINDOW = {torch.bfloat16: 128, torch.float32: 64}
STRIP = {dt: (wt - 5) // 2 for dt, wt in WINDOW.items()}


def fused_stem_plain(x: torch.Tensor, w1: torch.Tensor, sb1: torch.Tensor, w2: torch.Tensor,
                     sb2: torch.Tensor) -> torch.Tensor:
    """x [n, 64, H, W] -> [n, 128, (H + 1) // 2, (W + 1) // 2] in x's dtype."""
    y = batch_norm_folded(conv2d(x, w1, padding=1), sb1[0], sb1[1], activation="relu")
    y = batch_norm_folded(conv2d(y, w2, padding=1), sb2[0], sb2[1], activation="relu")
    return max_pool(y, 3, 2, 1)


@functools.cache
def build() -> ctypes.CDLL:
    """Compile (or reuse) the kernel library and declare its C interface; needs nvcc."""
    lib = load_library("fused_stem", SOURCES)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.tdnet_fused_stem.argtypes = [p] * 5 + [i] * 6 + [p]
    lib.tdnet_fused_stem.restype = ctypes.c_int
    lib.tdnet_cuda_error_string.argtypes = [i]
    lib.tdnet_cuda_error_string.restype = ctypes.c_char_p
    return lib


def split_tf32(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) = (rna_tf32(x), rna_tf32(x - hi)) of finite f32 ``x``, as the
    kernel's 3xTF32 products take them (``csrc/tf32x3.cuh``: ``rna_tf32``)."""
    def rna(v):
        u = v.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
        u = (u + 0x1000) & 0xFFFFE000
        return torch.where(u >= 2**31, u - 2**32, u).to(torch.int32).view(torch.float32)
    hi = rna(x)
    return hi, rna(x - hi)


def weight_chunks(w1: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    """OIHW w1 [64, 64, 3, 3] and w2 [128, 64, 3, 3] -> the kernel's weight chunks,
    in the order a step reads them: 3 passes (conv1, conv2's output channels
    0-63, then 64-127) x 9 taps (3i + j) x, in bf16, [64 n][64 k] (a chunk is
    a kernel row of 3 taps); in f32, two chunks (input channels 0-31, 32-63)
    of [hi, lo][64 n][32 k]. The rows are 128 bytes; 16-byte vector c of row r
    is stored at c ^ (r % 8), the kernel's shared-memory swizzle (wgmma's
    128-byte swizzle), so a chunk is one linear bulk copy."""
    taps = torch.stack([w1, w2[:C_MID], w2[C_MID:]]).permute(0, 3, 4, 1, 2).reshape(3, 9, 64, 64)
    if w1.dtype == torch.float32:
        halves = taps.reshape(3, 9, 64, 2, 32).permute(0, 1, 3, 2, 4)
        taps = torch.stack(split_tf32(halves), dim=3)   # [pass, tap, half, hi/lo, n, 32 k]
    vec = 16 // taps.element_size()
    rows = taps.reshape(-1, 8, vec)
    r = torch.arange(rows.shape[0], device=rows.device)
    idx = torch.arange(8, device=rows.device)[None, :] ^ (r[:, None] % 8)
    return torch.gather(rows, 1, idx[:, :, None].expand(-1, -1, vec)).reshape(-1).contiguous()


class StemTail(NamedTuple):
    """The tail's weights, laid out once per model: OIHW w1 [64, 64, 3, 3] and
    w2 [128, 64, 3, 3] in the activations' dtype, the folded eval BN pairs sb1
    [2, 64] and sb2 [2, 128] in f32 (row 0 scale, row 1 bias: the stem's bn1
    and the ResNet's bn1), and on the card the kernel's ``weight_chunks``."""
    w1: torch.Tensor
    sb1: torch.Tensor
    w2: torch.Tensor
    sb2: torch.Tensor
    chunks: torch.Tensor | None


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
    chunks = weight_chunks(w1, w2) if w1.device.type == "cuda" else None
    return StemTail(w1, sb1.contiguous(), w2, sb2.contiguous(), chunks)


class StemPlan(NamedTuple):
    """The kernel's grid for [n, 64, h, w]: ``strips`` strips of ``STRIP[dtype]``
    pooled columns, ``bands`` bands of ``band_rows`` pooled rows (the last one
    shorter), n images; one block a (strip, band, image)."""
    strips: int
    band_rows: int
    bands: int


def stem_plan(n: int, h: int, w: int, dtype: torch.dtype, sms: int) -> StemPlan:
    """As many bands as leave every block an SM of its own (one block fills an
    SM), at least one: a block marches down its band, and each band costs
    two extra steps of conv1 and one of conv2 at its top."""
    hp, wp = (h + 1) // 2, (w + 1) // 2
    strips = -(-wp // STRIP[dtype])
    bands = max(1, min(hp, sms // (n * strips)))
    band_rows = -(-hp // bands)
    return StemPlan(strips, band_rows, -(-hp // band_rows))


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
    plan = stem_plan(n, h, w, x.dtype, sm_count(x.device.index))
    lib = build()
    err = lib.tdnet_fused_stem(x.data_ptr(), tail.chunks.data_ptr(), tail.sb1.data_ptr(),
                               tail.sb2.data_ptr(), y.data_ptr(), n, h, w, _DTYPE_CODE[x.dtype],
                               plan.strips, plan.band_rows,
                               torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused stem kernel failed: CUDA error {err}: "
                           f"{lib.tdnet_cuda_error_string(err).decode()}")
    fused_stem_tail.launches += 1
    return y


fused_stem_tail.launches = 0
