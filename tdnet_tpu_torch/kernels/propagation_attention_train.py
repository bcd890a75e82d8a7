"""Training propagation attention: dropout(softmax(q k^T / temperature)) v (K2).

The training twins' attention (reference Training/.../td4_psp/transformer.py:
117-139, attention dropout 0.1) with its gradient. The CUDA kernels are
``csrc/propagation_attention_train.cu`` (a forward, and a backward that
regenerates the dropout mask); ``propagation_attention_train_plain`` is the
plain PyTorch version, ``ops.attention.attention_train`` on the keep mask of
``ops/dropout_mask.py`` for element (b, i, j), which is the kernel's mask bit
for bit.

It takes float32 and bfloat16 (the mixed-precision step's q, k and v; the plain
version also float64). In bfloat16 both follow the TPU kernel's rounding points
(``tdnet_tpu/kernels/propagation_attention_train.py:71-112``): s = q k^T with
f32 sums, the softmax, the mask and 1 / (1 - rate) in f32, pd rounded to
bfloat16 before p v, o summed in f32 and rounded once; in the backward pd
rounded for dv, dpd = dy v^T in f32, ds = p (dp - t) rounded to bfloat16
before dq and dk with t = sum_j dp p in f32, dq rounded from f32, dk and dv
summed in f32 and rounded once. The plain version's bfloat16 backward is that
formula (``_PlainLowPrecision``), not autograd, which would round dpd.

``propagation_attention_train`` takes the plain version (autograd) for CPU
tensors and the kernels for CUDA tensors;
``propagation_attention_train.launches`` and ``.backward_launches`` count
the f32 kernels' forward and backward launches, ``.bf16_launches`` and
``.bf16_backward_launches`` the bfloat16 kernels'. The forward runs on the CUDA
cores, shares the scores and p with K1's f32 path (``csrc/attention_f32.cuh``)
and sums p v over the keys in order as a plain f32 GEMM does; its blocks take
``grid.column_width`` columns. The backward runs on the
tensor cores in 3xTF32 and is sized by ``backward_plan``. Both take d_v 128,
256, 384 or 512: the backward keeps a block's dv [32, d_v] in registers.
The bfloat16 kernels run every product on ``mma.sync`` m16n8k16 (bf16
operands, f32 sums): a row-statistics pass and a p v pass of ``bf16_columns``
columns a block; the backward on ``backward_plan``'s q ranges, with ds in a
bfloat16 scratch.
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


DTYPES = (torch.float32, torch.bfloat16)


def _softmax_pd(q, k, temperature, keep, rate):
    """(p, pd) in f32: p = softmax(q k^T / temperature), pd = keep ? p / (1 - rate) : p."""
    p = torch.softmax(torch.matmul(q.float(), k.float().transpose(1, 2)) / temperature, dim=-1)
    if keep is None:
        return p, p
    inv_keep = torch.tensor(1.0 / (1.0 - rate), dtype=torch.float32)
    return p, torch.where(keep, p * inv_keep, torch.zeros((), dtype=p.dtype))


class _PlainLowPrecision(torch.autograd.Function):
    """The low-precision plain version with the TPU kernel's backward formula
    (see the module's docstring), in torch ops."""

    @staticmethod
    def forward(ctx, q, k, v, temperature, keep, rate):
        _, pd = _softmax_pd(q, k, temperature, keep, rate)
        o = torch.matmul(pd.to(v.dtype).float(), v.float()).to(v.dtype)
        ctx.save_for_backward(q, k, v)
        ctx.temperature, ctx.keep, ctx.rate = temperature, keep, rate
        return o

    @staticmethod
    def backward(ctx, dy):
        q, k, v = ctx.saved_tensors
        p, pd = _softmax_pd(q, k, ctx.temperature, ctx.keep, ctx.rate)
        dyf = dy.float()
        dv = torch.matmul(pd.to(v.dtype).float().transpose(1, 2), dyf).to(v.dtype)
        dp = torch.matmul(dyf, v.float().transpose(1, 2))
        if ctx.keep is not None:
            inv_keep = torch.tensor(1.0 / (1.0 - ctx.rate), dtype=torch.float32)
            dp = torch.where(ctx.keep, dp * inv_keep, torch.zeros((), dtype=dp.dtype))
        t = (dp * p).sum(-1, keepdim=True)
        ds = (p * (dp - t)).to(q.dtype).float()
        scale = 1.0 / ctx.temperature
        dq = (torch.matmul(ds, k.float()) * scale).to(q.dtype)
        dk = (torch.matmul(ds.transpose(1, 2), q.float()) * scale).to(k.dtype)
        return dq, dk, dv, None, None, None


def propagation_attention_train_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                                      temperature: float, dropout_rate: float = 0.0,
                                      seed: int = 0) -> torch.Tensor:
    """q [n, Lq, dk], k [n, Lkv, dk], v [n, Lkv, dv] -> [n, Lq, dv] in v's dtype;
    float32 and float64 through autograd, bfloat16 (and float16) with the
    kernel's rounding points."""
    keep = None
    if dropout_rate > 0.0:
        keep = keep_mask(seed, dropout_rate, (q.shape[0], q.shape[1], k.shape[1]),
                         device=q.device)
    if q.dtype.itemsize < 4:
        return _PlainLowPrecision.apply(q, k, v, temperature, keep, dropout_rate)
    return attention_train(q, k, v, temperature=temperature, keep=keep, rate=dropout_rate)


def build() -> ctypes.CDLL:
    """Compile (or reuse) the kernel library and declare its C interface; needs nvcc."""
    lib = load_library("propagation_attention_train", SOURCES)
    p, i, u, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float
    lib.tdnet_attention_train_fwd.argtypes = [p] * 5 + [i] * 4 + [f, i, u, u, f, p]
    lib.tdnet_attention_train_fwd.restype = ctypes.c_int
    lib.tdnet_attention_train_bwd.argtypes = [p] * 14 + [i] * 4 + [f, i, i, u, u, f, p]
    lib.tdnet_attention_train_bwd.restype = ctypes.c_int
    lib.tdnet_attention_train_fwd_bf16.argtypes = lib.tdnet_attention_train_fwd.argtypes
    lib.tdnet_attention_train_fwd_bf16.restype = ctypes.c_int
    lib.tdnet_attention_train_bwd_bf16.argtypes = [p] * 12 + [i] * 4 + [f, i, u, u, f, p]
    lib.tdnet_attention_train_bwd_bf16.restype = ctypes.c_int
    lib.tdnet_cuda_error_string.argtypes = [ctypes.c_int]
    lib.tdnet_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check(q, k, v) -> None:
    for t in (q, k, v):
        if t.device != q.device:
            raise ValueError(f"tensors on {t.device} and {q.device}")
        if t.dtype not in DTYPES or t.dtype != q.dtype:
            raise ValueError(f"the training kernel takes float32 or bfloat16 q, k and v of one "
                             f"dtype, got {t.dtype} and {q.dtype}")
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


def bf16_columns(n: int, lq: int, dv: int, sms: int) -> int:
    """The d_v columns a block of the bf16 p v pass owns: 256 (two blocks an
    SM) where those blocks fill the card, else 128."""
    blocks = -(-lq // Q_BLOCK) * n * (dv // 256)
    return 256 if dv % 256 == 0 and blocks >= sms else 128


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
        sms = sm_count(v.device.index)
        if v.dtype == torch.float32:
            launch = lib.tdnet_attention_train_fwd
            cols = column_width(-(-lq // Q_BLOCK) * n, dv, sms, FORWARD_FIXED)
        else:
            launch = lib.tdnet_attention_train_fwd_bf16
            cols = bf16_columns(n, lq, dv, sms)
        o = torch.empty((n, lq, dv), dtype=v.dtype, device=v.device)
        stats = torch.empty((2, n, lq), dtype=torch.float32, device=v.device)
        drop = _drop_args(dropout_rate, seed)
        _err(lib, launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), stats.data_ptr(),
            n, lq, lkv, dv, 1.0 / temperature, cols, *drop,
            torch.cuda.current_stream(v.device).cuda_stream), "forward")
        if v.dtype == torch.float32:
            propagation_attention_train.launches += 1
        else:
            propagation_attention_train.bf16_launches += 1
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
        new = lambda shape, dtype=torch.float32: torch.empty(shape, dtype=dtype, device=q.device)
        dq, dk, dv_ = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
        dsum, dk_part, dv_part = new((n, lq)), new(plan.dk_part), new(plan.dv_part)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if q.dtype == torch.bfloat16:
            ds = new(plan.ds, q.dtype)
            _err(lib, lib.tdnet_attention_train_bwd_bf16(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), dy.data_ptr(),
                stats.data_ptr(), dsum.data_ptr(), ds.data_ptr(),
                dq.data_ptr(), dk.data_ptr(), dv_.data_ptr(), dk_part.data_ptr(),
                dv_part.data_ptr(), n, lq, lkv, dv, ctx.scale, plan.q_per, *ctx.drop, stream),
                "backward")
            propagation_attention_train.bf16_backward_launches += 1
            return dq, dk, dv_, None, None, None
        ds, dq_part = new(plan.ds), new(plan.dq_part)
        _err(lib, lib.tdnet_attention_train_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), dy.data_ptr(),
            stats.data_ptr(), dsum.data_ptr(), ds.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv_.data_ptr(), dq_part.data_ptr(), dk_part.data_ptr(), dv_part.data_ptr(), n, lq,
            lkv, dv, ctx.scale, plan.q_per, plan.k_per, *ctx.drop, stream), "backward")
        propagation_attention_train.backward_launches += 1
        return dq, dk, dv_, None, None, None


def propagation_attention_train(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                                temperature: float, dropout_rate: float = 0.0,
                                seed: int = 0) -> torch.Tensor:
    """Differentiable dropout(softmax(q k^T / temperature)) v, batched over axis 0.

    q [n, Lq, 64], k [n, Lkv, 64], v [n, Lkv, dv] -> [n, Lq, dv], float32 or
    bfloat16 (one dtype for all), the output and gradients in it. The keep
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
propagation_attention_train.bf16_launches = 0
propagation_attention_train.bf16_backward_launches = 0
