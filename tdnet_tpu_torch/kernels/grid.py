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
