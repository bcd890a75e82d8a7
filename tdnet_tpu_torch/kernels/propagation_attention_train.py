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
``.bf16_backward_launches`` the bfloat16 kernels'. The f32 forward runs on the
CUDA cores, shares the scores and p with K1's f32 path
(``csrc/attention_f32.cuh``) and sums p v over the keys in order as a plain f32
GEMM does; its blocks take ``grid.column_width`` columns. The f32 backward runs
on the tensor cores in 3xTF32 and is sized by ``backward_plan``. Both take d_v
128, 256, 384 or 512: the backward keeps a block's dv [32, d_v] in registers.

The bfloat16 kernels run every product on Hopper's ``wgmma`` (bf16 operands,
f32 sums), every tile brought in by TMA through a ring of shared-memory stages
that one producer thread fills. The forward (``launch_bf16_forward``) forms the
keep bits once (``keep_bits``: a hash is as many integer operations as an
element's share of the products) and runs K1's stats and p v kernels
(``csrc/attention_bf16.cuh``) with the mask: p = 2^(s c - m) (1 / l) in
registers, the mask and 1 / (1 - rate) on p in f32, rounded to bf16 as p v's
A operand; its tiling and key ranges are ``grid.train_forward_plan``'s, and it
saves the merged row statistics and the keep bits for the backward, not o. The
backward (``launch_bf16_backward``) runs three passes in
``grid.train_backward_plan``'s ranges: t (forward-shaped: q and dy resident, k
and v chunks streamed, the TPU kernel's t = sum_j dp p), dk/dv/ds (KV-major:
the block's 64 keys the M of s^T and dp^T, pd^T and ds^T the A operands of dv
and dk from registers, each of two warpgroups owning half of dv's columns) and
dq (ds k), partials summed in a fixed order (no atomics: two runs give the same
bits). Arithmetic bounds it: 2 Lq Lkv (64 + 512) FLOP forward and 2 Lq Lkv (2
512 + 3 64) backward at 989 TFLOP/s. One scratch allocation a call is carved
into the kernels' parts (``forward_scratch``, ``backward_scratch``). A consumer
warpgroup that gives up waiting on a barrier sets the error word of
``kernels/fault.py``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from tdnet_tpu_torch.kernels.build import load_library
from tdnet_tpu_torch.kernels.device import on_device
from tdnet_tpu_torch.kernels.fault import fault_word
from tdnet_tpu_torch.kernels.grid import (FORWARD_FIXED, Q_BLOCK, STATS_KEYS, TrainBwdPlan,
                                          TrainFwdPlan, ceil_div, column_width, sm_count,
                                          train_backward_plan, train_forward_plan)
from tdnet_tpu_torch.ops.attention import attention_train
from tdnet_tpu_torch.ops.dropout_mask import keep_mask, keep_threshold

SOURCES = ("propagation_attention_train.cu",)
D_K = 64        # the key width the kernel takes
DV_TILE = 128   # d_v must be a multiple of the kernel's column slice
DV_MAX = 512    # the backwards keep dv in registers: [32, d_v] a block (f32), half a row (bf16)
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


def library_name(defines: tuple[str, ...] = ()) -> str:
    """The library's name: a debug build's carries its defines."""
    return "propagation_attention_train" + "".join(f"-{d}" for d in defines)


@functools.lru_cache(maxsize=None)
def build(defines: tuple[str, ...] = ()) -> ctypes.CDLL:
    """Compile (or reuse) the kernel library, with ``-D`` ``defines`` for a debug
    build (the fault check's), and declare its C interface; needs nvcc."""
    lib = load_library(library_name(defines), SOURCES, defines)
    p, i, u, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float
    lib.tdnet_attention_train_fwd.argtypes = [p] * 5 + [i] * 4 + [f, i, u, u, f, p]
    lib.tdnet_attention_train_fwd.restype = ctypes.c_int
    lib.tdnet_attention_train_bwd.argtypes = [p] * 14 + [i] * 4 + [f, i, i, u, u, f, p]
    lib.tdnet_attention_train_bwd.restype = ctypes.c_int
    lib.tdnet_attention_train_fwd_bf16.argtypes = [p] * 9 + [i] * 4 + [f] + [i] * 5 + [u, u, f, p]
    lib.tdnet_attention_train_fwd_bf16.restype = ctypes.c_int
    lib.tdnet_attention_train_bwd_bf16.argtypes = [p] * 16 + [i] * 4 + [f] + [i] * 3 + [u, u, f, p]
    lib.tdnet_attention_train_bwd_bf16.restype = ctypes.c_int
    lib.tdnet_attention_train_bf16_attributes.argtypes = [i, p]
    lib.tdnet_attention_train_bf16_attributes.restype = ctypes.c_int
    lib.tdnet_cuda_error_string.argtypes = [ctypes.c_int]
    lib.tdnet_cuda_error_string.restype = ctypes.c_char_p
    return lib


BF16_KERNELS = ("stats", "pv128", "pv256", "t", "dkdv", "dq")   # the bf16 kernels of a call


def bf16_attributes(drop: bool) -> dict[str, dict[str, int]]:
    """Each bf16 kernel's registers a thread at launch (its consumer warpgroups take
    more by ``setmaxnreg``) and local memory a thread in bytes (spills), at d_v
    512, with or without the mask."""
    lib = build()
    out = (ctypes.c_int * (2 * len(BF16_KERNELS)))()
    _err(lib, lib.tdnet_attention_train_bf16_attributes(int(drop), out), "attributes")
    return {name: {"registers": out[2 * i], "local_bytes": out[2 * i + 1]}
            for i, name in enumerate(BF16_KERNELS)}


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


def _err(lib, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"training attention {what} failed: CUDA error {err}: "
                           f"{lib.tdnet_cuda_error_string(err).decode()}")


ALIGN = 256   # bytes: each part of a scratch allocation starts at a multiple


def carve(sizes: dict[str, int]) -> tuple[dict[str, int], int]:
    """Byte offsets of parts of the given byte sizes in one allocation, in
    order, each at a multiple of ``ALIGN``; and the allocation's bytes."""
    offsets, at = {}, 0
    for name, size in sizes.items():
        offsets[name] = at
        at += ceil_div(size, ALIGN) * ALIGN
    return offsets, at


def forward_scratch(plan: TrainFwdPlan, n: int, lq: int, lkv: int, dv: int) -> dict[str, int]:
    """Bytes of the bf16 forward's scratch parts: the stats kernel's partial
    (m, l) [2, ranges, n, lq] and the p v kernel's partial outputs [ranges, n,
    lq, dv], f32, each only where its keys split into more than one range."""
    stat_ranges = ceil_div(ceil_div(lkv, STATS_KEYS), plan.stat_kper)
    pv_ranges = ceil_div(ceil_div(lkv, plan.keys), plan.pv_kper)
    return dict(stats_part=4 * 2 * stat_ranges * n * lq if stat_ranges > 1 else 0,
                o_part=4 * pv_ranges * n * lq * dv if pv_ranges > 1 else 0)


def backward_scratch(plan: TrainBwdPlan, n: int, lq: int, lkv: int, dv: int) -> dict[str, int]:
    """Bytes of the bf16 backward's scratch parts, in the C interface's order:
    rows [n, lq, 4] f32 (m, 1 / l, t), t_part [t ranges, n, lq] f32, ds [n, lq,
    lds] bf16, dq_part [ksplit, n, lq, 64], dk_part [2 qsplit, n, lkv, 64] and
    dv_part [qsplit, n, lkv, dv] f32."""
    return dict(rows=16 * n * lq, t_part=4 * plan.t_ranges * n * lq, ds=2 * n * lq * plan.lds,
                dq_part=4 * plan.ksplit * n * lq * D_K,
                dk_part=4 * 2 * plan.qsplit * n * lkv * D_K,
                dv_part=4 * plan.qsplit * n * lkv * dv)


def _scratch(sizes: dict[str, int], device, carved=None) -> tuple[list[int], torch.Tensor]:
    """One allocation carved into ``sizes``' parts (``carve(sizes)``, or ``carved``
    where the caller has it): their addresses (0 for an empty part), and the
    tensor that holds them (keep it alive until the launch is queued)."""
    offsets, total = carved or carve(sizes)
    buf = torch.empty(max(total, 1), dtype=torch.uint8, device=device)
    base = buf.data_ptr()
    return [base + offsets[k] if size else 0 for k, size in sizes.items()], buf


@functools.lru_cache(maxsize=64)
def _layout(backward: bool, n: int, lq: int, lkv: int, dv: int, sms: int):
    """(plan, scratch sizes, their carve) of a bf16 call: the host work that
    repeats for every call of one shape."""
    if backward:
        plan = train_backward_plan(n, lq, lkv, dv, sms)
        sizes = backward_scratch(plan, n, lq, lkv, dv)
    else:
        plan = train_forward_plan(n, lq, lkv, dv, sms)
        sizes = forward_scratch(plan, n, lq, lkv, dv)
    return plan, sizes, carve(sizes)


def keep_words(lkv: int) -> int:
    """uint32 words a q row of the keep bits: ceil(lkv / 32) rounded up to 4."""
    return ceil_div(ceil_div(lkv, 32), 4) * 4


def launch_bf16_forward(q, k, v, temperature: float, dropout_rate: float, seed: int,
                        plan: TrainFwdPlan | None = None, lib: ctypes.CDLL | None = None):
    """The bf16 forward's kernels on checked CUDA tensors in the tiling ``plan``
    (default ``train_forward_plan``), from ``lib`` (default ``build()``); returns
    (o, stats [2, n, lq] f32, the keep bits [n, lq, keep_words] int32 or None
    without dropout) and counts no launch."""
    lib = lib or build()
    n, lq, _ = q.shape
    lkv, dv = v.shape[1], v.shape[2]
    if plan is None:
        plan, sizes, carved = _layout(False, n, lq, lkv, dv, sm_count(v.device.index))
    else:
        sizes, carved = forward_scratch(plan, n, lq, lkv, dv), None
    o = torch.empty((n, lq, dv), dtype=v.dtype, device=v.device)
    stats = torch.empty((2, n, lq), dtype=torch.float32, device=v.device)
    bits = (torch.empty((n, lq, keep_words(lkv)), dtype=torch.int32, device=v.device)
            if dropout_rate > 0.0 else None)
    (stats_part, o_part), buf = _scratch(sizes, v.device, carved)
    with on_device(v) as stream:
        _err(lib, lib.tdnet_attention_train_fwd_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), o_part, stats.data_ptr(),
            stats_part, 0 if bits is None else bits.data_ptr(), fault_word(v.device).data_ptr(),
            n, lq, lkv, dv, 1.0 / temperature, *plan, *_drop_args(dropout_rate, seed),
            stream), "forward")
    del buf
    return o, stats, bits


def launch_bf16_backward(q, k, v, dy, stats, bits, temperature: float, dropout_rate: float,
                         seed: int, lib: ctypes.CDLL | None = None):
    """The bf16 backward's kernels on checked CUDA tensors, given the forward's
    stats and keep bits; returns (dq, dk, dv) and counts no launch."""
    lib = lib or build()
    n, lq, _ = q.shape
    lkv, dv = v.shape[1], v.shape[2]
    plan, sizes, carved = _layout(True, n, lq, lkv, dv, sm_count(q.device.index))
    parts, buf = _scratch(sizes, q.device, carved)
    dq, dk, dv_ = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    with on_device(q) as stream:
        _err(lib, lib.tdnet_attention_train_bwd_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dy.data_ptr(), stats.data_ptr(),
            0 if bits is None else bits.data_ptr(), *parts, dq.data_ptr(), dk.data_ptr(),
            dv_.data_ptr(), fault_word(q.device).data_ptr(), n, lq, lkv, dv, 1.0 / temperature,
            plan.t_kper, plan.q_per, plan.dq_kper, *_drop_args(dropout_rate, seed),
            stream), "backward")
    del buf
    return dq, dk, dv_


class _AttentionTrainKernel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, temperature, dropout_rate, seed):
        _check(q, k, v)
        ctx.temperature, ctx.rate, ctx.seed = temperature, dropout_rate, seed
        if v.dtype == torch.bfloat16:
            o, stats, bits = launch_bf16_forward(q, k, v, temperature, dropout_rate, seed)
            propagation_attention_train.bf16_launches += 1
            ctx.save_for_backward(q, k, v, stats, bits)
            return o
        lib = build()
        n, lq, _ = q.shape
        lkv, dv = v.shape[1], v.shape[2]
        cols = column_width(-(-lq // Q_BLOCK) * n, dv, sm_count(v.device.index), FORWARD_FIXED)
        o = torch.empty((n, lq, dv), dtype=v.dtype, device=v.device)
        stats = torch.empty((2, n, lq), dtype=torch.float32, device=v.device)
        with on_device(v) as stream:
            _err(lib, lib.tdnet_attention_train_fwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), stats.data_ptr(),
                n, lq, lkv, dv, 1.0 / temperature, cols, *_drop_args(dropout_rate, seed),
                stream), "forward")
        propagation_attention_train.launches += 1
        ctx.save_for_backward(q, k, v, stats, o)
        return o

    @staticmethod
    def backward(ctx, dy):
        dy = dy.contiguous()
        if dy.dtype == torch.bfloat16:
            q, k, v, stats, bits = ctx.saved_tensors
            grads = launch_bf16_backward(q, k, v, dy, stats, bits, ctx.temperature, ctx.rate,
                                         ctx.seed)
            propagation_attention_train.bf16_backward_launches += 1
            return (*grads, None, None, None)
        q, k, v, stats, o = ctx.saved_tensors
        lib = build()
        n, lq, _ = q.shape
        lkv, dv = v.shape[1], v.shape[2]
        plan = backward_plan(n, lq, lkv, dv, sm_count(q.device.index))
        # the scratch tensors stay referenced until the launch is queued
        dsum, ds, dq_part, dk_part, dv_part = (
            torch.empty(shape, dtype=torch.float32, device=q.device)
            for shape in ((n, lq), plan.ds, plan.dq_part, plan.dk_part, plan.dv_part))
        dq, dk, dv_ = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
        with on_device(q) as stream:
            _err(lib, lib.tdnet_attention_train_bwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), dy.data_ptr(),
                stats.data_ptr(), dsum.data_ptr(), ds.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                dv_.data_ptr(), dq_part.data_ptr(), dk_part.data_ptr(), dv_part.data_ptr(), n,
                lq, lkv, dv, 1.0 / ctx.temperature, plan.q_per, plan.k_per,
                *_drop_args(ctx.rate, ctx.seed), stream), "backward")
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
