"""The numerics, the layout and the grid of the dilated-conv kernel (K5,
``csrc/dilated_conv.cu``), emulated in torch on the CPU.

The kernel runs a stride-1 dilated 3x3 conv as an implicit GEMM on the tensor
cores in 3xTF32 (``mma.sync`` m16n8k8): two prep passes write the input as
NHWC images zero-padded by p on every side and the weights as [9, N, K], each
split into hi = rna_tf32(v) and lo = rna_tf32(v - hi); output pixel (h, w) is
GEMM row h * Wp + w over the whole padded width, so tap (i, j) reads the rows
shifted by i*d*Wp + j*d; K runs tap-major in stages of 32 channels, and each
stage's 4 k-steps of lo*hi, hi*lo, hi*hi go to a fresh accumulator that the
tensor core truncates as it adds, added to the output in round-to-nearest f32.
There is no card here, so this file emulates that sum in that order (TF32
rounding as int32 bit operations, the accumulator as a sum rounded toward
zero) and holds it, forward and dgrad (the weights flipped and IO-swapped by
the weight pass), to ``chip_smoke.py`` phase 13's 5e-5 x max|ref| of the
float64 conv, and to the JAX package's ``conv2d_pallas_dil`` in interpret
mode at ``test_torch_dilated_conv.py``'s tolerance (atol 1e-5, rtol 1e-5).
One chain over all of K lands farther from float64. The prep passes' layouts
have plain twins here, held to what the kernel assumes of them, and
``conv_plan`` to the checks ``tdnet_dilated_conv`` makes before it launches.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from tdnet_tpu.kernels import dilated_conv as jdc
from tdnet_tpu_torch.kernels.dilated_conv import (
    BK, BM, BN, K, conv_plan, dgrad_weights, dilated_conv_plain)
from tf32_emulation import rna_tf32, round_toward_zero, split_tf32

PHASE13 = 5e-5   # chip_smoke.py phase 13: output and dx to 5e-5 x max|ref|
CHAIN = BK // 8   # k-steps a fresh accumulator sums: one stage of BK channels
# (dilation, padding, ci, co, H, W): small odd grids, the channels not multiples of 32
CASES = [(2, 2, 16, 24, 13, 21), (4, 4, 48, 40, 11, 23), (8, 8, 64, 16, 19, 17),
         (4, 2, 24, 56, 15, 19)]


@pytest.fixture(autouse=True)
def one_thread():
    """The emulation is hundreds of small ops, which threads only slow down."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def tap_offset(plan, dil, tap):
    """The shift of the GEMM rows that tap (i, j) reads: i * dil * wp + j * dil."""
    return (tap // K) * dil * plan.wp + (tap % K) * dil


def input_layout(x, plan, pad):
    """x [n, cin, H, W] as the kernel reads it: [n, hr * wp, kp], NHWC,
    zero-padded by ``pad`` on every side, with zero rows below and zero
    channels beyond cin. The kernel's ``prep_input`` writes its split_tf32."""
    n, cin, h = x.shape[:3]
    xp = F.pad(x, (pad, pad, pad, plan.hr - h - pad))
    xp = F.pad(xp.permute(0, 2, 3, 1), (0, plan.kp - cin))
    return xp.reshape(n, plan.hr * plan.wp, plan.kp)


def weight_layout(w, plan, flip):
    """w [cout, cin, 3, 3] (with ``flip``, the forward's [cin, cout, 3, 3],
    used as ``dgrad_weights``) as the kernel reads it: [9, np_, kp],
    K-contiguous, zero-padded. The kernel's ``prep_weights`` writes its
    split_tf32."""
    w = dgrad_weights(w) if flip else w
    cout, cin = w.shape[:2]
    w9 = w.permute(2, 3, 0, 1).reshape(K * K, cout, cin)
    return F.pad(w9, (0, plan.kp - cin, 0, plan.np_ - cout))


def padded_gemm(a, b, plan, dil, cout):
    """The kernel's GEMM in plain torch: a [n, hr * wp, kp] (the padded input),
    b [9, np_, kp] -> y [n, cout, ho, wo], y's GEMM row m the sum over taps of
    a[m + tap_offset] b[tap]^T, the rows with w >= wo dropped."""
    rows = plan.ho * plan.wp
    y = sum(a[:, tap_offset(plan, dil, t):tap_offset(plan, dil, t) + rows] @ b[t].T
            for t in range(K * K))
    y = y.reshape(a.shape[0], plan.ho, plan.wp, plan.np_)[:, :, :plan.wo, :cout]
    return y.permute(0, 3, 1, 2)


def kernel_emulated(x, w, pad, dil, flip=False, chain=CHAIN):
    """The kernel's output for x [n, cin, H, W] and w ([cout, cin, 3, 3], or
    the forward's [cin, cout, 3, 3] with ``flip``): the prep passes' split
    layouts, then per tap and 8-channel k-step the three products into a
    truncating accumulator, added to the output in f32 every ``chain``
    k-steps (the kernel: every stage of BK channels)."""
    n, cin = x.shape[:2]
    cout = w.shape[1] if flip else w.shape[0]
    plan = conv_plan(cin, cout, x.shape[2], x.shape[3], pad, dil)
    ah, al = split_tf32(input_layout(x, plan, pad))
    bh, bl = split_tf32(weight_layout(w, plan, flip))
    y = torch.zeros(n, plan.ho * plan.wp, plan.np_)
    t = torch.zeros_like(y)
    steps = 0
    for tap in range(K * K):
        rows = slice(tap_offset(plan, dil, tap), tap_offset(plan, dil, tap) + plan.ho * plan.wp)
        for k0 in range(0, plan.kp, 8):
            ks = slice(k0, k0 + 8)
            for a, b in ((al, bh), (ah, bl), (ah, bh)):
                t = round_toward_zero(t.double() + a[:, rows, ks].double() @ b[tap, :, ks].double().T)
            steps += 1
            if steps % chain == 0:
                y, t = y + t, torch.zeros_like(y)
    y = y + t
    return y.reshape(n, plan.ho, plan.wp, plan.np_)[:, :, :plan.wo, :cout].permute(0, 3, 1, 2)


def _case(ci, co, h, w, seed=0, n=1):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(n, ci, h, w).astype(np.float32))
    wt = torch.from_numpy((rng.randn(co, ci, 3, 3) / np.sqrt(9 * ci)).astype(np.float32))
    return x, wt


def _float64_conv(x, w, pad, dil):
    return dilated_conv_plain(x.double(), w.double(), pad, dil)


@pytest.mark.parametrize("d,p,ci,co,h,w", CASES)
def test_emulated_kernel_within_phase13_tolerance_of_float64(d, p, ci, co, h, w):
    x, wt = _case(ci, co, h, w, seed=d + ci)
    want = _float64_conv(x, wt, p, d)
    got = kernel_emulated(x, wt, p, d)
    assert got.shape == want.shape
    assert (got.double() - want).abs().max().item() <= PHASE13 * want.abs().max().item()


@pytest.mark.parametrize("d,p,ci,co,h,w", CASES)
def test_emulated_dgrad_within_phase13_tolerance_of_float64(d, p, ci, co, h, w):
    """The dgrad: the kernel on dy [n, co, Ho, Wo] with the forward's weights,
    flipped and IO-swapped by the weight pass, and padding 2d - p."""
    x, wt = _case(ci, co, h, w, seed=d + co)
    ho, wo = h + 2 * p - 2 * d, w + 2 * p - 2 * d
    dy = torch.from_numpy(np.random.RandomState(d).randn(1, co, ho, wo).astype(np.float32))
    want = _float64_conv(dy, dgrad_weights(wt), 2 * d - p, d)
    got = kernel_emulated(dy, wt, 2 * d - p, d, flip=True)
    assert got.shape == want.shape == (1, ci, h, w)
    assert (got.double() - want).abs().max().item() <= PHASE13 * want.abs().max().item()


@pytest.mark.parametrize("d,p", [(4, 4), (8, 8), (4, 2)])
def test_emulated_kernel_matches_pallas_interpret(d, p, monkeypatch):
    orig = jdc.pl.pallas_call
    monkeypatch.setattr(jdc.pl, "pallas_call",
                        lambda *a, **kw: orig(*a, **{**kw, "interpret": True}))
    x, wt = _case(16, 32, 13, 21, seed=d + p)
    want = jdc.conv2d_pallas_dil(jnp.asarray(x.permute(0, 2, 3, 1).numpy()),
                                 jnp.asarray(wt.permute(2, 3, 1, 0).numpy()), p, d)
    got = kernel_emulated(x, wt, p, d)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want),
                               atol=1e-5, rtol=1e-5)


def test_one_chain_over_all_of_k_is_farther_from_float64():
    """The tensor core truncates as it accumulates: one accumulator over all
    9 x 64 channels' k-steps drifts toward zero, a fresh one a stage does not."""
    x, wt = _case(64, 64, 15, 17, seed=3)
    want = _float64_conv(x, wt, 4, 4)
    err = lambda y: (y.double() - want).abs().mean().item()
    chained = err(kernel_emulated(x, wt, 4, 4))
    one_chain = err(kernel_emulated(x, wt, 4, 4, chain=10**6))
    assert 3 * chained < one_chain


def test_rna_tf32_rounds_to_ten_mantissa_bits_ties_away():
    rng = np.random.RandomState(0)
    v = np.concatenate([rng.randn(1000) * 10.0 ** rng.randint(-20, 20, 1000),
                        [1 + 2**-11, -(1 + 2**-11), 1 + 2**-12, 0.0, 3.0]]).astype(np.float32)
    e = np.floor(np.log2(np.abs(v.astype(np.float64)) + (v == 0)))
    ulp = 2.0 ** (e - 10)
    want = np.sign(v) * np.floor(np.abs(v.astype(np.float64)) / ulp + 0.5) * ulp
    np.testing.assert_array_equal(rna_tf32(torch.from_numpy(v)).double().numpy(), want)


@pytest.mark.parametrize("d,p,ci,co,h,w", CASES)
def test_prep_layouts(d, p, ci, co, h, w):
    """hi + lo gives back v to 2^-21 of it; the padding, the rows below and
    the channels beyond cin are zeros; the weights' flip is the dgrad's."""
    x, wt = _case(ci, co, h, w, seed=1)
    plan = conv_plan(ci, co, h, w, p, d)
    hi, lo = split_tf32(input_layout(x, plan, p))
    assert hi.shape == (1, plan.hr * plan.wp, plan.kp)
    img = (hi + lo).reshape(plan.hr, plan.wp, plan.kp)
    inner = img[p:p + h, p:p + w, :ci].permute(2, 0, 1)
    assert (inner - x[0]).abs().max() <= 2**-21 * x.abs().max()
    assert torch.equal(rna_tf32(hi), hi) and torch.equal(rna_tf32(lo), lo)
    mask = torch.ones_like(img, dtype=torch.bool)
    mask[p:p + h, p:p + w, :ci] = False
    assert not img[mask].any() and not hi.reshape(img.shape)[mask].any()
    for flip, want in ((False, wt), (True, dgrad_weights(wt))):
        cout, cin = want.shape[:2]
        plan = conv_plan(cin, cout, h, w, p, d)
        wh, wl = split_tf32(weight_layout(wt, plan, flip))
        assert wh.shape == (K * K, plan.np_, plan.kp)
        for tap in range(K * K):
            got = (wh + wl)[tap, :cout, :cin]
            assert (got - want[:, :, tap // K, tap % K]).abs().max() <= 2**-21 * wt.abs().max()
        assert not wh[:, cout:].any() and not wh[:, :, cin:].any()


@pytest.mark.parametrize("d,p,ci,co,h,w", CASES)
def test_padded_width_gemm_is_the_conv(d, p, ci, co, h, w):
    x, wt = _case(ci, co, h, w, seed=2, n=2)
    plan = conv_plan(ci, co, h, w, p, d)
    got = padded_gemm(input_layout(x, plan, p), weight_layout(wt, plan, False), plan, d, co)
    torch.testing.assert_close(got, dilated_conv_plain(x, wt, p, d), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("cin,cout,h,w,p,d", [
    (512, 512, 97, 193, 4, 4), (512, 512, 97, 193, 8, 8), (512, 256, 97, 193, 4, 4),
    (16, 24, 13, 21, 2, 4), (40, 130, 11, 23, 6, 4), (1, 1, 5, 5, 0, 2)])
def test_conv_plan(cin, cout, h, w, p, d):
    """The plan meets what ``tdnet_dilated_conv`` checks before it launches:
    kp and np_ are cin and cout rounded up to the tiles, and the padded image
    has every row that the last row tile's last tap reads, and no row more."""
    plan = conv_plan(cin, cout, h, w, p, d)
    hp = h + 2 * p
    assert (plan.ho, plan.wo) == (hp - 2 * d, w + 2 * p - 2 * d)
    assert plan.wp == w + 2 * p and plan.wp - plan.wo == 2 * d
    assert plan.kp % BK == 0 and 0 <= plan.kp - cin < BK
    assert plan.np_ % BN == 0 and 0 <= plan.np_ - cout < BN
    tiles = -(-plan.ho * plan.wp // BM)   # the row tiles of the kernel's grid
    last_read = tiles * BM - 1 + tap_offset(plan, d, K * K - 1)
    assert plan.hr >= hp and last_read < plan.hr * plan.wp <= last_read + plan.wp


@pytest.mark.parametrize("h,w,p,d", [(5, 9, 0, 4), (9, 5, 1, 4), (3, 3, 0, 2)])
def test_conv_plan_refuses_an_empty_output(h, w, p, d):
    with pytest.raises(ValueError, match="empty output"):
        conv_plan(16, 16, h, w, p, d)


def test_conv_plan_at_the_recipe_shape():
    """97x193 at d4: 153 row tiles of 128 padded-width rows, times 4 column
    tiles: 612 blocks; the dropped columns are 4% of the rows."""
    plan = conv_plan(512, 512, 97, 193, 4, 4)
    assert plan.wp == 201 and -(-plan.ho * plan.wp // BM) == 153 and plan.np_ // BN == 4
    assert abs((plan.wp - plan.wo) / plan.wp - 0.04) < 0.001
    assert conv_plan(512, 512, 97, 193, 8, 8).wp == 209
