"""Training propagation attention: dropout(softmax(q k^T / temperature)) v (K2).

The training twins' attention (reference Training/.../td4_psp/transformer.py:
117-139, attention dropout 0.1) with its gradient. The CUDA kernels are
``csrc/propagation_attention_train.cu`` (a forward, and a backward that
regenerates the dropout mask); ``propagation_attention_train_plain`` is the
plain PyTorch version, ``ops.attention.attention_train`` on the keep mask of
``ops/dropout_mask.py`` for element (b, i, j), which is the kernel's mask bit
for bit. f32 only.

``propagation_attention_train`` takes the plain version (autograd) for CPU
tensors and the kernels for CUDA tensors;
``propagation_attention_train.launches`` and ``.backward_launches`` count
the kernel's forward and backward launches. The forward runs on the CUDA
cores, shares the scores and p with K1's f32 path (``csrc/attention_f32.cuh``)
and sums p v over the keys in order as a plain f32 GEMM does; its blocks take
``grid.column_width`` columns. The backward runs on the
tensor cores in 3xTF32 and is sized by ``backward_plan``. Both take d_v 128,
256, 384 or 512: the backward keeps a block's dv [32, d_v] in registers.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from tdnet_tpu_torch.kernels.build import load_library
from tdnet_tpu_torch.kernels.grid import FORWARD_FIXED, Q_BLOCK, column_width, sm_count
from tdnet_tpu_torch.ops.attention import attention_train
from tdnet_tpu_torch.ops.dropout_mask import keep_mask, keep_threshold

SOURCES = ("propagation_attention_train.cu",)
D_K = 64        # the key width the kernel takes
DV_TILE = 128   # d_v must be a multiple of the kernel's column slice
DV_MAX = 512    # the backward keeps a block's dv [32, d_v] in registers
Q_CHUNK = 64    # q rows a step of the backward's KV-major pass
KEY_BLOCK = 32  # keys a block of the KV-major pass, and a step of the dq pass
DQ_ROWS = 64    # dq rows a block of the dq pass
MAX_QSPLIT = 16


def propagation_attention_train_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                                      temperature: float, dropout_rate: float = 0.0,
                                      seed: int = 0) -> torch.Tensor:
    """q [n, Lq, dk], k [n, Lkv, dk], v [n, Lkv, dv] -> [n, Lq, dv]."""
    keep = None
    if dropout_rate > 0.0:
        keep = keep_mask(seed, dropout_rate, (q.shape[0], q.shape[1], k.shape[1]),
                         device=q.device)
    return attention_train(q, k, v, temperature=temperature, keep=keep, rate=dropout_rate)


def build() -> ctypes.CDLL:
    """Compile (or reuse) the kernel library and declare its C interface; needs nvcc."""
    lib = load_library("propagation_attention_train", SOURCES)
    p, i, u, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float
    lib.tdnet_attention_train_fwd.argtypes = [p] * 5 + [i] * 4 + [f, i, u, u, f, p]
    lib.tdnet_attention_train_fwd.restype = ctypes.c_int
    lib.tdnet_attention_train_bwd.argtypes = [p] * 14 + [i] * 4 + [f, i, i, u, u, f, p]
    lib.tdnet_attention_train_bwd.restype = ctypes.c_int
    lib.tdnet_cuda_error_string.argtypes = [ctypes.c_int]
    lib.tdnet_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check(q, k, v) -> None:
    for t in (q, k, v):
        if t.device != q.device:
            raise ValueError(f"tensors on {t.device} and {q.device}")
        if t.dtype != torch.float32:
            raise ValueError(f"the training kernel takes float32, got {t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("the training kernel takes contiguous, 16-byte aligned tensors")
        if t.dim() != 3:
            raise ValueError("q, k and v are [n, L, d]")
    n, lq, dk = q.shape
    nk, lkv, dkk = k.shape
    nv, lkv_v, dv = v.shape
    if dk != D_K or dkk != D_K:
        raise ValueError(f"the kernel takes d_k = {D_K}, got {dk} and {dkk}")
    if nk != n or nv != n or lkv_v != lkv:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    _check_dv(dv)
    if lq < 1 or lkv < 1:
        raise ValueError("the kernel takes nonempty q and k")


def _check_dv(dv: int) -> None:
    if dv % DV_TILE or not DV_TILE <= dv <= DV_MAX:
        raise ValueError(f"the backward takes d_v in 128, 256, 384, 512, got {dv}")


def _drop_args(rate: float, seed: int) -> tuple[int, int, float]:
    """(seed, threshold, 1 / (1 - rate)); threshold 0 means no dropout."""
    if rate <= 0.0:
        return 0, 0, 1.0
    return seed & 0xFFFFFFFF, keep_threshold(rate), 1.0 / (1.0 - rate)


class BackwardPlan(NamedTuple):
    """The backward's grid and scratch shapes (see the C interface)."""
    q_per: int      # 64-row q chunks a block of the KV-major pass walks
    qsplit: int     # q ranges: dk and dv partials
    k_per: int      # 32-key steps a block of the dq pass walks
    ksplit: int     # key ranges: dq partials
    ds: tuple       # [n, Lq, Lkv rounded up to 32]
    dq_part: tuple  # [ksplit, n, Lq, 64]
    dk_part: tuple  # [qsplit, n, Lkv, 64]
    dv_part: tuple  # [qsplit, n, Lkv, d_v]


@functools.lru_cache(maxsize=64)
def backward_plan(n: int, lq: int, lkv: int, dv: int, sms: int) -> BackwardPlan:
    """Split the backward over the card's ``sms`` SMs.

    The KV-major pass runs one block an SM, a block per 32 keys and q range:
    the q ranges are chosen to minimise waves x (chunks a block + 2), with at
    most 16 ranges (the 2 stands for a block's set-up and write-out). The dq
    pass splits its keys until it has two blocks an SM.
    """
    _check_dv(dv)
    ceil = lambda a, b: -(-a // b)
    key_blocks, qchunks = ceil(lkv, KEY_BLOCK), ceil(lq, Q_CHUNK)
    cost = lambda per: (ceil(key_blocks * n * ceil(qchunks, per), sms) * (per + 2), -per)
    q_per = min(range(ceil(qchunks, MAX_QSPLIT), qchunks + 1), key=cost)
    qsplit = ceil(qchunks, q_per)
    k_per = ceil(key_blocks, max(1, ceil(2 * sms, ceil(lq, DQ_ROWS) * n)))
    ksplit = ceil(key_blocks, k_per)
    return BackwardPlan(q_per, qsplit, k_per, ksplit, ds=(n, lq, key_blocks * KEY_BLOCK),
                        dq_part=(ksplit, n, lq, D_K), dk_part=(qsplit, n, lkv, D_K),
                        dv_part=(qsplit, n, lkv, dv))


def _err(lib, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"training attention {what} failed: CUDA error {err}: "
                           f"{lib.tdnet_cuda_error_string(err).decode()}")


class _AttentionTrainKernel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, temperature, dropout_rate, seed):
        _check(q, k, v)
        lib = build()
        n, lq, _ = q.shape
        lkv, dv = v.shape[1], v.shape[2]
        cols = column_width(-(-lq // Q_BLOCK) * n, dv, sm_count(v.device.index), FORWARD_FIXED)
        o = torch.empty((n, lq, dv), dtype=v.dtype, device=v.device)
        stats = torch.empty((2, n, lq), dtype=torch.float32, device=v.device)
        drop = _drop_args(dropout_rate, seed)
        _err(lib, lib.tdnet_attention_train_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), stats.data_ptr(),
            n, lq, lkv, dv, 1.0 / temperature, cols, *drop,
            torch.cuda.current_stream(v.device).cuda_stream), "forward")
        propagation_attention_train.launches += 1
        ctx.save_for_backward(q, k, v, o, stats)
        ctx.scale, ctx.drop = 1.0 / temperature, drop
        return o

    @staticmethod
    def backward(ctx, dy):
        q, k, v, o, stats = ctx.saved_tensors
        dy = dy.contiguous()
        lib = build()
        n, lq, _ = q.shape
        lkv, dv = v.shape[1], v.shape[2]
        plan = backward_plan(n, lq, lkv, dv, sm_count(q.device.index))
        new = lambda shape: torch.empty(shape, dtype=torch.float32, device=q.device)
        dq, dk, dv_ = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
        dsum, ds = new((n, lq)), new(plan.ds)
        dq_part, dk_part, dv_part = new(plan.dq_part), new(plan.dk_part), new(plan.dv_part)
        _err(lib, lib.tdnet_attention_train_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), dy.data_ptr(),
            stats.data_ptr(), dsum.data_ptr(), ds.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv_.data_ptr(), dq_part.data_ptr(), dk_part.data_ptr(), dv_part.data_ptr(), n, lq,
            lkv, dv, ctx.scale, plan.q_per, plan.k_per, *ctx.drop,
            torch.cuda.current_stream(q.device).cuda_stream), "backward")
        propagation_attention_train.backward_launches += 1
        return dq, dk, dv_, None, None, None


def propagation_attention_train(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                                temperature: float, dropout_rate: float = 0.0,
                                seed: int = 0) -> torch.Tensor:
    """Differentiable dropout(softmax(q k^T / temperature)) v, batched over axis 0.

    q [n, Lq, 64], k [n, Lkv, 64], v [n, Lkv, dv] -> [n, Lq, dv], f32. The keep
    mask of element (b, i, j) is a function of (seed, (b * Lq + i) * Lkv + j);
    ``dropout_rate=0`` attends without dropout.
    """
    if q.device.type == "cpu":
        return propagation_attention_train_plain(q, k, v, temperature=temperature,
                                                 dropout_rate=dropout_rate, seed=seed)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    return _AttentionTrainKernel.apply(q, k, v, temperature, dropout_rate, seed)


propagation_attention_train.launches = 0
propagation_attention_train.backward_launches = 0
