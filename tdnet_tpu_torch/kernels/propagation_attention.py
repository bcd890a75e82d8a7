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
the calls that went to the kernel. In f32 the kernel forms the scores on the
CUDA cores (``csrc/attention_f32.cuh``, shared with the training kernel's
forward) and p v and the fc on the tensor cores in 3xTF32, f32's accuracy;
``forward_plan`` sizes that PV pass's grid and scratch. In bf16 every product
runs on Hopper's ``wgmma``, fed by TMA, in the tiling that
``grid.attention_bf16_plan`` picks for the shape; ``launch_bf16`` runs the
kernels in a given tiling (``cli/attention_sweep.py`` times the tilings).

A bf16 consumer warpgroup that gives up waiting on a barrier sets an error
word, one int32 a device that K1 shares with K5 (``kernels/fault.py``), and
exits: the launch then ends with part of its output unwritten.
``check_fault(device)`` (imported here from there) reads the word (a
synchronizing copy) and raises; the runtime calls it only where it
synchronizes anyway (``stream/runtime.py``), so the hot path gains no
synchronization.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from tdnet_tpu_torch.kernels.build import load_library
from tdnet_tpu_torch.kernels.device import on_device
from tdnet_tpu_torch.kernels.fault import check_fault, fault_word  # noqa: F401
from tdnet_tpu_torch.kernels.grid import (FC_FIXED, Q_BLOCK, Bf16Plan, attention_bf16_plan,
                                          column_width, sm_count)
from tdnet_tpu_torch.ops.attention import scaled_dot_attention

SOURCES = ("propagation_attention.cu",)
_DTYPES = (torch.float32, torch.bfloat16)
D_K = 64        # the key width the kernel takes
DV_TILE = 128   # d_v must be a multiple of the kernel's column tile
KEY_CHUNK = 32  # keys a chunk (one 3xTF32 chain) of the f32 PV pass
MAX_RANGES = 8  # key ranges of the f32 PV pass at most


def propagation_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                                temperature: float, fc_w: torch.Tensor | None = None,
                                fc_b: torch.Tensor | None = None) -> torch.Tensor:
    """q [n, Lq, dk], k [n, Lkv, dk], v [n, Lkv, dv] -> [n, Lq, dv] in v's dtype."""
    o = scaled_dot_attention(q, k, v, temperature=temperature)
    if fc_w is None:
        return o
    return (torch.matmul(o.float(), fc_w.float()) + fc_b.float()).to(v.dtype)


class ForwardPlan(NamedTuple):
    """The f32 PV pass's grid and scratch (``attention_f32`` in csrc/attention_f32.cuh)."""
    cols: int     # d_v columns a block of the PV pass owns
    fc_cols: int  # d_v columns a block of K1's fc owns
    k_per: int    # 32-key chunks a key range
    ranges: int   # key ranges, whose partial outputs are summed in order
    parts: tuple | None   # [ranges, n, Lq, d_v] partial outputs; None for one range


@functools.lru_cache(maxsize=64)
def forward_plan(n: int, lq: int, lkv: int, dv: int, sms: int) -> ForwardPlan:
    """Split the f32 PV pass over the card's ``sms`` SMs.

    A block owns 64 q rows and 512 columns (the largest of 512, 256 and 128
    that divides d_v), one block an SM. The keys split into at most 8 ranges,
    chosen to minimise waves x (chunks a block + 2), the 2 standing for a
    block's set-up and write-out, as ``propagation_attention_train.backward_plan``
    chooses. K1's fc takes ``grid.column_width`` of its rows.
    """
    ceil = lambda a, b: -(-a // b)
    cols = max(c for c in (DV_TILE, 2 * DV_TILE, 4 * DV_TILE) if dv % c == 0)
    chunks = ceil(lkv, KEY_CHUNK)
    blocks = ceil(lq, Q_BLOCK) * n * (dv // cols)
    cost = lambda per: (ceil(blocks * ceil(chunks, per), sms) * (per + 2), -per)
    k_per = min(range(ceil(chunks, MAX_RANGES), chunks + 1), key=cost)
    ranges = ceil(chunks, k_per)
    fc_cols = column_width(ceil(n * lq, Q_BLOCK), dv, sms, FC_FIXED)
    return ForwardPlan(cols, fc_cols, k_per, ranges,
                       (ranges, n, lq, dv) if ranges > 1 else None)


def library_name(defines: tuple[str, ...] = ()) -> str:
    return "propagation_attention" + "".join(f"-{d}" for d in defines)


@functools.lru_cache(maxsize=None)
def build(defines: tuple[str, ...] = ()) -> ctypes.CDLL:
    """Compile (or reuse) the kernel library and declare its C interface; needs nvcc.
    ``defines``: a debug build's ``-D`` flags (``chip_smoke.py``'s fault check)."""
    lib = load_library(library_name(defines), SOURCES, defines)
    lib.tdnet_propagation_attention_f32.argtypes = [ctypes.c_void_p] * 9 + [
        ctypes.c_int] * 4 + [ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.tdnet_propagation_attention_bf16.argtypes = [ctypes.c_void_p] * 9 + [
        ctypes.c_int] * 4 + [ctypes.c_float] + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    for fn in (lib.tdnet_propagation_attention_f32, lib.tdnet_propagation_attention_bf16):
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
    if v.dtype not in _DTYPES:
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
    n, lq, _ = q.shape
    lkv, dv = v.shape[1], v.shape[2]
    sms = sm_count(v.device.index)
    if v.dtype == torch.bfloat16:
        out = launch_bf16(q, k, v, temperature, fc_w, fc_b,
                          attention_bf16_plan(n, lq, lkv, dv, sms))
    else:
        out = _launch_f32(q, k, v, temperature, fc_w, fc_b, forward_plan(n, lq, lkv, dv, sms))
    fused_propagation_attention.launches += 1
    return out


def _outputs(q, v, fc_w):
    n, lq = q.shape[:2]
    out = torch.empty((n, lq, v.shape[2]), dtype=v.dtype, device=v.device)
    stats = torch.empty((2, n, lq), dtype=torch.float32, device=v.device)
    return out, stats, torch.empty_like(out) if fc_w is not None else None


def _raise_on(lib, err: int) -> None:
    if err != 0:
        msg = lib.tdnet_cuda_error_string(err).decode()
        raise RuntimeError(f"propagation attention kernel failed: CUDA error {err}: {msg}")


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def _launch_f32(q, k, v, temperature, fc_w, fc_b, plan: ForwardPlan) -> torch.Tensor:
    lib = build()
    out, stats, o_tmp = _outputs(q, v, fc_w)
    o_parts = (torch.empty(plan.parts, dtype=torch.float32, device=v.device)
               if plan.parts else None)
    n, lq, _ = q.shape
    with on_device(v) as stream:
        err = lib.tdnet_propagation_attention_f32(
            _ptr(q), _ptr(k), _ptr(v), _ptr(fc_w), _ptr(fc_b), _ptr(o_tmp), _ptr(out),
            _ptr(o_parts), _ptr(stats), n, lq, k.shape[1], v.shape[2], 1.0 / temperature,
            plan.cols, plan.fc_cols, plan.k_per, stream)
    _raise_on(lib, err)
    return out


def launch_bf16(q, k, v, temperature: float, fc_w, fc_b, plan: Bf16Plan,
                lib: ctypes.CDLL | None = None) -> torch.Tensor:
    """The bf16 kernels in the tiling ``plan`` on checked CUDA tensors (as
    ``fused_propagation_attention`` takes them), from ``lib`` (default
    ``build()``); counts no launch."""
    lib = lib or build()
    out, stats, o_tmp = _outputs(q, v, fc_w)
    n, lq, _ = q.shape
    with on_device(v) as stream:
        err = lib.tdnet_propagation_attention_bf16(
            _ptr(q), _ptr(k), _ptr(v), _ptr(fc_w), _ptr(fc_b), _ptr(o_tmp), _ptr(out),
            _ptr(stats), _ptr(fault_word(v.device)), n, lq, k.shape[1], v.shape[2],
            1.0 / temperature, *plan, stream)
    _raise_on(lib, err)
    return out


fused_propagation_attention.launches = 0
