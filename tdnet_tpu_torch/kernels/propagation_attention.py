"""Propagation attention: softmax(q k^T / temperature) v [@ fc_w + fc_b].

The streaming hot path: the current frame's full-resolution queries attend
over a cached frame's subsampled keys and values, and the reference's
per-token output projection (Attention.fc) follows. The CUDA kernel is
``csrc/propagation_attention.cu``; ``propagation_attention_plain`` is its
plain PyTorch version with the same rounding points as the TPU kernel
(softmax in f32, p cast to v's dtype, PV accumulated in f32 and cast to v's
dtype, then the fc accumulated in f32 and cast to v's dtype).

``fused_propagation_attention`` takes the plain version for CPU tensors and
the kernel for CUDA tensors; ``fused_propagation_attention.launches`` counts
the calls that went to the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from tdnet_tpu_torch.kernels.build import load_library
from tdnet_tpu_torch.ops.attention import scaled_dot_attention

SOURCES = ("propagation_attention.cu",)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
D_K = 64        # the key width the kernel takes
DV_TILE = 128   # d_v must be a multiple of the kernel's column tile


def propagation_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                                temperature: float, fc_w: torch.Tensor | None = None,
                                fc_b: torch.Tensor | None = None) -> torch.Tensor:
    """q [n, Lq, dk], k [n, Lkv, dk], v [n, Lkv, dv] -> [n, Lq, dv] in v's dtype."""
    o = scaled_dot_attention(q, k, v, temperature=temperature)
    if fc_w is None:
        return o
    return (torch.matmul(o.float(), fc_w.float()) + fc_b.float()).to(v.dtype)


def build() -> ctypes.CDLL:
    """Compile (or reuse) the kernel library and declare its C interface; needs nvcc."""
    lib = load_library("propagation_attention", SOURCES)
    fn = lib.tdnet_propagation_attention
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.tdnet_cuda_error_string.argtypes = [ctypes.c_int]
    lib.tdnet_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check(q, k, v, fc_w, fc_b) -> None:
    tensors = [q, k, v] + ([fc_w, fc_b] if fc_w is not None else [])
    if (fc_w is None) != (fc_b is None):
        raise ValueError("fc_w and fc_b go together")
    for t in tensors:
        if t.device != q.device:
            raise ValueError(f"tensors on {t.device} and {q.device}")
        if t.dtype != v.dtype:
            raise ValueError(f"dtype {t.dtype} differs from v's {v.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("the kernel takes contiguous, 16-byte aligned tensors")
    if v.dtype not in _DTYPE_CODE:
        raise ValueError(f"the kernel takes float32 or bfloat16, not {v.dtype}")
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError("q, k and v are [n, L, d]")
    n, lq, dk = q.shape
    nk, lkv, dkk = k.shape
    nv, lkv_v, dv = v.shape
    if dk != D_K or dkk != D_K:
        raise ValueError(f"the kernel takes d_k = {D_K}, got {dk} and {dkk}")
    if nk != n or nv != n or lkv_v != lkv:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    if dv % DV_TILE or lq < 1 or lkv < 1:
        raise ValueError(f"the kernel takes d_v % {DV_TILE} == 0 and nonempty q, k")
    if fc_w is not None and (tuple(fc_w.shape) != (dv, dv) or tuple(fc_b.shape) != (dv,)):
        raise ValueError(f"fc_w {tuple(fc_w.shape)} / fc_b {tuple(fc_b.shape)} for d_v {dv}")


def fused_propagation_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                                temperature: float, fc_w: torch.Tensor | None = None,
                                fc_b: torch.Tensor | None = None) -> torch.Tensor:
    """softmax(q k^T / temperature) v [@ fc_w + fc_b], batched over axis 0.

    q [n, Lq, 64], k [n, Lkv, 64], v [n, Lkv, dv] -> [n, Lq, dv] in v's dtype;
    ``fc_w`` [dv, dv] is stored [in, out], ``fc_b`` [dv].
    """
    if q.device.type == "cpu":
        return propagation_attention_plain(q, k, v, temperature=temperature,
                                           fc_w=fc_w, fc_b=fc_b)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    _check(q, k, v, fc_w, fc_b)
    lib = build()
    n, lq, _ = q.shape
    lkv, dv = v.shape[1], v.shape[2]
    out = torch.empty((n, lq, dv), dtype=v.dtype, device=v.device)
    stats = torch.empty((2, n, lq), dtype=torch.float32, device=v.device)
    o_tmp = torch.empty_like(out) if fc_w is not None else None
    ptr = lambda t: None if t is None else t.data_ptr()
    stream = torch.cuda.current_stream(v.device).cuda_stream
    err = lib.tdnet_propagation_attention(
        ptr(q), ptr(k), ptr(v), ptr(fc_w), ptr(fc_b), ptr(o_tmp), ptr(out), ptr(stats),
        n, lq, lkv, dv, 1.0 / temperature, _DTYPE_CODE[v.dtype], stream)
    if err != 0:
        msg = lib.tdnet_cuda_error_string(err).decode()
        raise RuntimeError(f"propagation attention kernel failed: CUDA error {err}: {msg}")
    fused_propagation_attention.launches += 1
    return out


fused_propagation_attention.launches = 0
