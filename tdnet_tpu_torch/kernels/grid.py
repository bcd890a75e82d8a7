"""Grid policy of the attention kernels: the f32 forward shared by K1's f32
path (``propagation_attention``) and K2's forward
(``propagation_attention_train``), and K1's bf16 path (``attention_bf16_plan``).

A block of either forward owns ``Q_BLOCK`` q rows and a column width that
``column_width`` picks from a cost model, one block an SM. A block's
``fixed`` work (whatever its width) is counted in columns of its product.
The two values the wrappers pass are not derived from the kernels' code:
``FORWARD_FIXED`` = 160 is fitted so that K2's forward takes the widths that
measured fastest on an H100 (run D5 in PERF.md: 512 columns at 18,721 x 2,145
and 256 at 2,145 x 2,145); ``FC_FIXED`` = 64 is an estimate of K1's fc block
splitting its rows of the PV result, not fitted to a measurement.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

Q_BLOCK = 64          # q rows a block of the f32 forward
WIDTHS = (512, 256, 128)   # the column widths a block may own
FORWARD_FIXED = 160   # K2's forward block: its scores, exp, divide and mask
FC_FIXED = 64         # K1's fc block


def column_width(row_blocks: int, dv: int, sms: int, fixed: int) -> int:
    """The columns (512, 256 or 128, dividing d_v) a block of ``Q_BLOCK`` rows
    owns: the width that minimises waves x (columns + ``fixed``), one block an
    SM. Narrower where few rows leave SMs idle."""
    ceil = lambda a, b: -(-a // b)
    widths = [c for c in WIDTHS if dv % c == 0]
    return min(widths, key=lambda c: (ceil(row_blocks * (dv // c), sms) * (c + fixed), -c))


@functools.lru_cache(maxsize=None)
def sm_count(device_index: int | None) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


SMEM = 232448          # bytes of shared memory a block of the card may have
RING_ROW = 128         # bytes of a row of a ring stage: 64 bf16 in the 128-byte swizzle


class Bf16Plan(NamedTuple):
    """The tiling of K1's bf16 kernels (``run_bf16`` in
    csrc/propagation_attention.cu): a block is a producer warpgroup and
    ``rows`` / 64 consumer warpgroups; (rows, cols, keys) one of ``BF16_TILES``."""
    rows: int     # q rows a block of the stats, p v and fc kernels
    cols: int     # d_v columns a consumer warpgroup of p v and the fc
    keys: int     # keys a chunk of the ring
    stages: int   # stages of the p v kernel's ring


# the p v kernel's (rows, cols, keys) the library takes (the fc takes its rows and cols)
BF16_TILES = ((64, 128, 64), (64, 128, 128), (64, 256, 64), (128, 128, 64), (128, 128, 128),
              (128, 256, 64))


def bf16_stage_bytes(cols: int, keys: int) -> int:
    """Bytes of a stage of the p v kernel's ring: a K chunk and cols / 64 V slabs."""
    return keys * RING_ROW * (1 + cols // 64)


def bf16_smem(plan: Bf16Plan) -> int:
    """Bytes of shared memory of a p v block: 1,024 of alignment slack, the q
    tile, the ring, and a full and an empty barrier a stage and one for q."""
    return (1024 + plan.rows * RING_ROW + plan.stages * (bf16_stage_bytes(plan.cols, plan.keys)
                                                         + 16) + 8)


def bf16_max_stages(rows: int, cols: int, keys: int) -> int:
    """The most stages of the p v kernel's ring that fit a block's shared memory."""
    return (SMEM - bf16_smem(Bf16Plan(rows, cols, keys, 0))) // (bf16_stage_bytes(cols, keys)
                                                                + 16)


def bf16_grid(plan: Bf16Plan, n: int, lq: int, dv: int) -> tuple[int, int, int]:
    """The p v kernel's grid: (q blocks, column blocks, batch)."""
    return -(-lq // plan.rows), dv // plan.cols, n


WIDE_WAVES = 3   # the wide tiling takes over where its blocks fill this many waves


@functools.lru_cache(maxsize=64)
def attention_bf16_plan(n: int, lq: int, lkv: int, dv: int, sms: int) -> Bf16Plan:
    """The bf16 tiling for a call on a card of ``sms`` SMs, from the tile sweep
    at the streaming hops (PERF.md): 64 q rows a block (two blocks an SM), 2
    stages; 256 columns a warpgroup and 64 keys a chunk where those blocks fill
    ``WIDE_WAVES`` waves of the card (the TD2 hop: half the score tiles of 128
    columns), else 128 columns and 128 keys (TD4's hops: twice the blocks)."""
    wide = Bf16Plan(64, 256, 64, 2)
    x, y, z = bf16_grid(wide, n, lq, dv)
    if dv % 256 == 0 and x * y * z >= WIDE_WAVES * 2 * sms:
        return wide
    return Bf16Plan(64, 128, 128, 2)


# ---- K2's bf16 path (``propagation_attention_train``): its forward runs K1's bf16 stats and
# p v kernels with the mask, its backward three passes on wgmma (csrc/propagation_attention_
# train.cu, ``k2::``). A block of the forward's kernels and of the dq pass is one consumer
# warpgroup (two blocks an SM); of the t and dk/dv passes two consumer warpgroups (one an SM).

# the p v kernel's (cols, keys) K2 takes: K1's tiles of one consumer warpgroup and 64-key
# chunks (128 keys a chunk spilled with the mask, ptxas)
TRAIN_TILES = ((128, 64), (256, 64))
STATS_KEYS = 128   # keys a chunk of the stats kernel
T_ROWS, T_KEYS = 128, 32     # q rows a block and keys a chunk of the t pass
KV_KEYS, KV_Q = 64, 32       # keys a block and q rows a chunk of the dk/dv pass
DQ_ROWS, DQ_KEYS = 64, 64    # q rows a block and keys a chunk of the dq pass
# ranges of a pass at most: the dk/dv pass's partials are [Lkv, d_v] f32 each (4.4 MB at
# 2,145 x 512), the others' a few hundred KB
MAX_SPLIT = 16
BF16_MAX_QSPLIT = 8


class TrainFwdPlan(NamedTuple):
    """K2's bf16 forward: the p v kernel's columns, keys a chunk and stages, and
    the key ranges of the stats and p v kernels (chunks a range)."""
    cols: int
    keys: int
    stages: int
    stat_kper: int   # 128-key chunks a range of the stats kernel
    pv_kper: int     # `keys`-key chunks a range of the p v kernel


class TrainBwdPlan(NamedTuple):
    """K2's bf16 backward: the key ranges of the t pass, the q ranges of the
    dk/dv pass and the key ranges of the dq pass (chunks a range, and ranges),
    and lds, the ds scratch's row length (Lkv rounded up to 64)."""
    t_kper: int
    t_ranges: int
    q_per: int
    qsplit: int
    dq_kper: int
    ksplit: int
    lds: int


def ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def split_units(units: int, blocks: int, slots: int, fixed: int,
                cap: int = MAX_SPLIT) -> int:
    """Units (chunks) a range, for a pass of ``blocks`` blocks a range over
    ``units`` chunks on ``slots`` block slots of the card: of the splits into at
    most ``cap`` ranges whose grid fills at least one wave, the one that
    minimises waves x (chunks a block + ``fixed``), ``fixed`` standing for a
    block's set-up and write-out; fewer ranges on a tie. Where no split fills
    a wave, the most ranges."""
    options = []
    for per in range(ceil_div(units, cap), units + 1):
        grid = blocks * ceil_div(units, per)
        options.append((grid < slots, ceil_div(grid, slots) * (per + fixed), -per))
    return -min(options)[2]


def fill_units(units: int, blocks: int, slots: int) -> int:
    """Units (chunks) a range: the fewest ranges (at most ``MAX_SPLIT``) whose
    grid of ``blocks`` blocks a range fills the card's ``slots`` block slots;
    one range where the blocks alone fill them (a split adds partial outputs to
    sum)."""
    for ranges in range(1, MAX_SPLIT + 1):
        per = ceil_div(units, ranges)
        if blocks * ceil_div(units, per) >= slots:
            return per
    return ceil_div(units, MAX_SPLIT)


def train_waves(blocks: int, per_sm: int, sms: int) -> float:
    """A grid's blocks over the card's block slots."""
    return blocks / (per_sm * sms)


# the p v kernel's (cols, keys, stages): the tile sweep at the training hops
# (``cli/attention_sweep.py --train``, PERF.md)
TRAIN_FWD_TILE = (256, 64, 2)
MAX_SMEM_TRAIN_STAGES = 4   # the sweep's stages at most (a stage of 128 x 64 is 24 KB)


@functools.lru_cache(maxsize=64)
def train_forward_plan(n: int, lq: int, lkv: int, dv: int, sms: int) -> TrainFwdPlan:
    """K2's bf16 forward for a call on a card of ``sms`` SMs: ``TRAIN_FWD_TILE``,
    and the keys split (``fill_units``) where q blocks alone leave the card's
    slots (two blocks an SM) idle."""
    cols, keys, stages = TRAIN_FWD_TILE
    if dv % cols:
        cols = 128
    q_blocks = ceil_div(lq, 64) * n
    stat_kper = fill_units(ceil_div(lkv, STATS_KEYS), q_blocks, 2 * sms)
    pv_kper = fill_units(ceil_div(lkv, keys), q_blocks * (dv // cols), 2 * sms)
    return TrainFwdPlan(cols, keys, stages, stat_kper, pv_kper)


def train_forward_grids(plan: TrainFwdPlan, n: int, lq: int, lkv: int, dv: int) -> dict:
    """The forward kernels' grids (x, y, z), as ``k2::forward`` launches them."""
    q_blocks = ceil_div(lq, 64)
    stat_ranges = ceil_div(ceil_div(lkv, STATS_KEYS), plan.stat_kper)
    pv_ranges = ceil_div(ceil_div(lkv, plan.keys), plan.pv_kper)
    return dict(stats=(q_blocks, stat_ranges, n), pv=(q_blocks, pv_ranges * dv // plan.cols, n))


@functools.lru_cache(maxsize=64)
def train_backward_plan(n: int, lq: int, lkv: int, dv: int, sms: int) -> TrainBwdPlan:
    """K2's bf16 backward for a call on a card of ``sms`` SMs: each pass's
    ranges by ``split_units`` (the t and dk/dv passes one block an SM, the dq
    pass two)."""
    lds = ceil_div(lkv, KV_KEYS) * KV_KEYS
    t_kper = split_units(ceil_div(lkv, T_KEYS), ceil_div(lq, T_ROWS) * n, sms, 4)
    q_per = split_units(ceil_div(lq, KV_Q), (lds // KV_KEYS) * n, sms, 2, BF16_MAX_QSPLIT)
    dq_kper = split_units(lds // DQ_KEYS, ceil_div(lq, DQ_ROWS) * n, 2 * sms, 1)
    return TrainBwdPlan(t_kper, ceil_div(ceil_div(lkv, T_KEYS), t_kper), q_per,
                        ceil_div(ceil_div(lq, KV_Q), q_per), dq_kper,
                        ceil_div(lds // DQ_KEYS, dq_kper), lds)


def train_backward_grids(plan: TrainBwdPlan, n: int, lq: int, lkv: int) -> dict:
    """The backward kernels' grids (x, y, z), as ``k2::backward`` launches them."""
    return dict(t=(ceil_div(lq, T_ROWS), plan.t_ranges, n),
                dkdv=(plan.lds // KV_KEYS, plan.qsplit, n),
                dq=(ceil_div(lq, DQ_ROWS), plan.ksplit, n))


def train_smem(dv: int) -> dict:
    """Bytes of shared memory a block of each K2 bf16 kernel takes (1,024 of
    alignment slack, the resident tiles, the ring, 16 bytes of barriers a stage
    and 8 for the resident tiles'), as ``ring_smem`` in csrc/hopper.cuh counts; the
    p v kernel's at the most stages the tile sweep runs."""
    slabs = dv // 64
    ring = lambda stages, stage, head: 1024 + head + stages * (stage + 16) + 8
    return dict(
        stats=ring(4, STATS_KEYS * RING_ROW, 64 * RING_ROW),
        pv=max(ring(MAX_SMEM_TRAIN_STAGES, keys * RING_ROW * (1 + c // 64), 64 * RING_ROW)
               for c, keys in TRAIN_TILES),
        t=ring(2, T_KEYS * RING_ROW * (1 + slabs), T_ROWS * RING_ROW * (1 + slabs)),
        dkdv=ring(4, KV_Q * RING_ROW * (1 + slabs) + 1024, KV_KEYS * RING_ROW * (1 + slabs)),
        dq=ring(4, 2 * DQ_KEYS * RING_ROW, 0))
