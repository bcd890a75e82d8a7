"""The bf16 dilated-conv kernel (K5, ``csrc/dilated_conv.cu``: ``dil_wgmma``
on ``wgmma`` fed by TMA), what a CPU can hold it to.

There is no card here, so this file holds the kernel's plan and its
arithmetic's shape, not the kernel: ``conv_plan(..., torch.bfloat16)``
against a Python statement of the checks ``tdnet_dilated_conv_bf16`` makes
and of the TMA and shared-memory limits the kernel works within, at every
dilated conv the recipes run (layer4 of TD4-PSP18 and TD2-PSP50 at 97x193)
and at the CPU tests' sizes, forward and dgrad; a float64 twin of the
kernel's sum (a stage one tap and 64 channels, tap-major: a box of BM input
rows at the tap's row shift, one chain a stage, added in order) against the
plain version; ``chip_smoke.py`` phase 13b's rounding gate, which
must flag a bf16 output from an f32 sum truncated toward zero and pass one
rounded to nearest in another order; the profiler's family of the kernel's
names; and the error word that K5 shares with K1. The kernel against its
plain version, and the gate on its outputs, run on the card (phase 13b).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import chip_smoke
from tdnet_tpu_torch.cli.profile import kernel_family
from tdnet_tpu_torch.kernels import fault, propagation_attention
from tdnet_tpu_torch.kernels.dilated_conv import (BK_BF16, BM, BN, K, conv_plan, dgrad_weights,
                                                  dilated_conv_plain)
from tests.test_torch_dilated_conv import CASES
from tests.test_torch_dilated_conv_tf32 import input_layout, weight_layout

BF16 = torch.bfloat16
GRID = (97, 193)   # layer4's grid at the recipes' 769x1537 crop
# layer4's dilated convs (ci, co, dilation): TD4-PSP18's 256->512 d4, 512->512 d4 and d8;
# TD2-PSP50's 512->512 d4, d8 and d16 (padding = dilation)
RECIPE = [(256, 512, 4), (512, 512, 4), (512, 512, 8), (512, 512, 16)]
CONVS = ([(ci, co, *GRID, d, d) for ci, co, d in RECIPE]
         + [(16, 32, 13, 21, p, d) for d, p in CASES])
MAX_SMEM = 232448   # bytes of shared memory a block may have (227 KB)
MAX_BOX = 256       # rows of a TMA box
ROW = 128           # bytes of a swizzled tile row: 64 bf16
SWIZZLE = 1024      # a 128-byte-swizzled box starts on a 1024-byte boundary
# the C side's ring (k5::STAGES, STAGE, SMEM): stages of the input box's BM rows, then the
# tap's [BN][64] weights, and the barriers
STAGES, STAGE = 4, BM * ROW + BN * ROW
SMEM = 1024 + STAGES * (STAGE + 16) + 8


@pytest.mark.parametrize("dgrad", [False, True])
@pytest.mark.parametrize("cin,cout,h,w,pad,dil", CONVS)
def test_bf16_plan_meets_the_kernel(cin, cout, h, w, pad, dil, dgrad):
    """The plan passes ``tdnet_dilated_conv_bf16``'s checks and fits the
    kernel: channels to whole 64-channel stages, rows the last box reaches,
    a TMA box of at most 256 rows, 16-byte global strides, 1024-byte-aligned
    boxes, and the ring in 227 KB."""
    if dgrad:   # the same conv of dy, IO-swapped, padding 2d - p
        cin, cout, pad = cout, cin, (K - 1) * dil - pad
    plan = conv_plan(cin, cout, h, w, pad, dil, BF16)
    hp = h + 2 * pad
    assert (plan.wp, plan.ho, plan.wo) == (w + 2 * pad, hp - 2 * dil, w + 2 * pad - 2 * dil)
    tiles = -(-plan.ho * plan.wp // BM)
    # Geometry::check
    assert plan.hr >= hp and tiles <= 65535 and plan.hr * plan.wp < 2 ** 31
    assert plan.kp == -(-cin // BK_BF16) * BK_BF16 and plan.np_ == -(-cout // BN) * BN
    assert plan.kp // 32 <= 65535
    # the last row tile's last tap (2, 2): its box is rows [m0 + 2 d wp + 2 d, + BM)
    last_box_end = (tiles - 1) * BM + (K - 1) * dil * plan.wp + (K - 1) * dil + BM
    assert last_box_end <= plan.hr * plan.wp
    assert plan.hr * plan.wp >= tiles * BM + 2 * dil * plan.wp + 2 * dil
    # TMA: boxes of 64 channels (one 128-byte swizzle row) x BM or BN rows; strides
    assert BM <= MAX_BOX and BN <= MAX_BOX
    assert plan.kp * 2 % 16 == 0 and BK_BF16 * 2 == ROW
    assert SMEM <= MAX_SMEM and STAGE % SWIZZLE == 0 and BM * ROW % SWIZZLE == 0


def test_bf16_plan_at_the_recipe_shapes():
    """97x193: 612 blocks at d4 (4.64 waves on 132 SMs), 636 at d8, 684 at
    d16; a block's ring of 4 stages of 32 KB."""
    for d, blocks in ((4, 612), (8, 636), (16, 684)):
        plan = conv_plan(512, 512, *GRID, d, d, BF16)
        assert -(-plan.ho * plan.wp // BM) * (plan.np_ // BN) == blocks
    assert (STAGE, SMEM) == (32768, 132168)


def test_bf16_plan_takes_a_wide_dilation():
    """The box is BM rows at any dilation: the plan of d 65 (beyond a 256-row
    box of BM + 2d rows) is the f32 plan with channels to 64."""
    wide, f32 = conv_plan(512, 512, *GRID, 65, 65, BF16), conv_plan(512, 512, *GRID, 65, 65)
    assert wide.hr == f32.hr and wide.kp == f32.kp == 512


def wgmma_twin(x: torch.Tensor, w: torch.Tensor, pad: int, dil: int,
               flip: bool = False) -> torch.Tensor:
    """``dil_wgmma``'s sum in float64 (products exact), in its tiles: a block
    of BM GEMM rows from m0 and BN channels from n0; stage (tap (i, j), 64
    channels from c0), tap-major, loads the box of padded-input rows
    [m0 + i d wp + j d, + BM) and the tap's [BN, 64] weights, one chain added
    to the tile's sum; the rows with w >= wo are dropped. Unwritten slots stay
    NaN."""
    n, cin = x.shape[:2]
    cout = w.shape[1] if flip else w.shape[0]
    plan = conv_plan(cin, cout, x.shape[2], x.shape[3], pad, dil, BF16)
    a = input_layout(x.double(), plan, pad)    # prep_input_bf16's [n, hr * wp, kp]
    b = weight_layout(w.double(), plan, flip)  # prep_weights' [9, np_, kp]
    tiles = -(-plan.ho * plan.wp // BM)
    y = torch.full((n, tiles * BM, plan.np_), float("nan"), dtype=torch.float64)
    for m0 in range(0, tiles * BM, BM):
        for n0 in range(0, plan.np_, BN):
            acc = torch.zeros(n, BM, BN, dtype=torch.float64)
            for tap in range(K * K):
                row0 = m0 + (tap // K) * dil * plan.wp + (tap % K) * dil
                for c0 in range(0, plan.kp, BK_BF16):
                    box = a[:, row0:row0 + BM, c0:c0 + BK_BF16]
                    assert box.shape[1] == BM   # inside the scratch
                    acc = acc + box @ b[tap, n0:n0 + BN, c0:c0 + BK_BF16].T
            y[:, m0:m0 + BM, n0:n0 + BN] = acc
    y = y[:, :plan.ho * plan.wp].reshape(n, plan.ho, plan.wp, plan.np_)
    return y[:, :, :plan.wo, :cout].permute(0, 3, 1, 2)


@pytest.mark.parametrize("d,p", CASES)
def test_twin_is_the_conv(d, p):
    """The twin's stages, boxes and row shifts give the conv, forward and dgrad,
    with channels that fill neither a stage nor a channel tile."""
    rng = np.random.RandomState(d + p)
    x = torch.from_numpy(rng.randn(2, 70, 13, 21))
    w = torch.from_numpy(rng.randn(130, 70, 3, 3) / np.sqrt(9 * 70))
    torch.testing.assert_close(wgmma_twin(x, w, p, d), dilated_conv_plain(x, w, p, d),
                               atol=1e-12, rtol=1e-12)
    dy = torch.from_numpy(rng.randn(2, 130, 13 + 2 * p - 2 * d, 21 + 2 * p - 2 * d))
    pd = (K - 1) * d - p
    torch.testing.assert_close(wgmma_twin(dy, w, pd, d, flip=True),
                               dilated_conv_plain(dy, dgrad_weights(w), pd, d),
                               atol=1e-12, rtol=1e-12)


def _bf16_of_f32_sums(bits: int | None):
    """Sums of bf16 products as the kernel and the plain version round them,
    with the float64 sum: each f32 sum (taken to nearest, in order and in
    reverse) rounded once to bf16; and the in-order f32 sum truncated toward
    zero to ``bits`` fraction bits first (an accumulator that truncates)."""
    rng = np.random.RandomState(0)
    a = torch.from_numpy(rng.randn(1 << 18, 96)).bfloat16().double()
    b = torch.from_numpy(rng.randn(1 << 18, 96) / np.sqrt(96)).bfloat16().double()
    p = (a * b).float()   # exact: bf16 products have 16 significant bits
    exact = (a * b).sum(1)
    fwd, rev = p.sum(1), p.flip(1).sum(1)
    out = {"plain": fwd.bfloat16(), "reversed": rev.bfloat16()}
    if bits is not None:
        q = 2.0 ** (torch.floor(torch.log2(fwd.abs().double())) - bits)
        out["truncated"] = (torch.trunc(fwd.double() / q) * q).float().bfloat16()
    return exact, out


def test_rounding_gate_flags_a_truncating_sum():
    """An f32 sum truncated toward zero to 14 fraction bits before its one
    rounding reads about -3.7e-3 ulp against the plain version's bias, the
    size an mma.sync chain over all of K read (PERF.md §6): the gate flags
    it. To 20 bits it reads about -5e-5, within the gate."""
    exact, out = _bf16_of_f32_sums(14)
    bias, plain_bias, ok = chip_smoke.rounding_gate(out["truncated"], out["plain"], exact)
    assert not ok and bias - plain_bias < -2 * chip_smoke.K5_BIAS_GATE
    exact, out = _bf16_of_f32_sums(20)
    assert chip_smoke.rounding_gate(out["truncated"], out["plain"], exact)[2]


def test_rounding_gate_passes_another_order():
    """The same sums rounded to nearest in reverse order differ from the plain
    version's in a few outputs, both ways: the gate passes them, and the plain
    version against itself."""
    exact, out = _bf16_of_f32_sums(None)
    assert (out["reversed"] != out["plain"]).any()
    bias, plain_bias, ok = chip_smoke.rounding_gate(out["reversed"], out["plain"], exact)
    assert ok and abs(bias - plain_bias) < chip_smoke.K5_BIAS_GATE / 10
    assert chip_smoke.rounding_gate(out["plain"], out["plain"], exact)[2]


@pytest.mark.parametrize("name", [
    "(anonymous namespace)::k5::dil_wgmma(CUtensorMap_st, CUtensorMap_st, __nv_bfloat16*, "
    "unsigned int*, int, int, int, int, int, int, int)",
    "(anonymous namespace)::prep_input_bf16(__nv_bfloat16 const*, __nv_bfloat16*, int, int, "
    "int, int, int, int)",
    "void (anonymous namespace)::prep_weights<__nv_bfloat16>(__nv_bfloat16 const*, "
    "__nv_bfloat16*, __nv_bfloat16*, int, int, int, int, int)",
    "void (anonymous namespace)::dil_tc<(anonymous namespace)::F32>(float const*, float const*, "
    "float const*, float const*, float*, int, int, int, int, int, int, int, int)"])
def test_profile_family_of_the_kernels(name):
    assert kernel_family(name, train=True) == "K5 dilated conv"
    assert kernel_family(name) == "K5 dilated conv"


def test_one_error_word_for_k1_and_k5():
    """K1's module reads the word that K5's launches write (``kernels/fault.py``),
    so ``Streamer``'s import of ``check_fault`` reads both; a CPU device has no
    word to read."""
    assert propagation_attention.check_fault is fault.check_fault
    assert fault.check_fault("cpu") is None
