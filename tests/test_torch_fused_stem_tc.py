"""The tiling, layouts and numerics of the fused-stem kernel (K4,
``csrc/fused_stem.cu``), emulated in torch on the CPU.

The kernel gives a block a strip of ``STRIP[dtype]`` pooled columns and a
band of pooled rows (``stem_plan``) and marches down the band two image rows
a step: the input and the conv1 results live in rings of 4 rows of
``WINDOW[dtype]`` + 2 pixels; a conv is a GEMM over two rows of
``WINDOW[dtype]`` columns, a tap (i, j) reading ring row r + i, column c + j,
so the columns past the strip's are computed and dropped; conv2 runs in two
halves of 64 channels whose vertical pool max is carried from step to step;
the horizontal max writes a pooled row. The input rows come in as 16-byte
vectors along W, aligned down, into a channel-major staging tile and are
transposed into the ring with the image's zero padding; the weights come
pre-swizzled from ``weight_chunks``. There is no card here, so
``kernel_twin`` walks the same grid, steps, rings, vector loads, masks and
carries in torch, with every ring slot that the kernel never writes set to
NaN (a junk column that reached a kept output would show), and the products
either in float64 (bf16: the tensor core sums exact bf16 products in f32) or
in the kernel's 3xTF32 order (f32: per chunk of 32 channels of one tap, 4
k-steps of lo*hi, hi*lo, hi*hi into an accumulator that truncates, added to
the sum in round-to-nearest f32; ``tests/tf32_emulation.py``).

Tolerances: ``chip_smoke.py`` phase 10's, f32 1e-4 and bf16 2e-2 x max|ref|
against ``fused_stem_plain``; against the JAX kernel in interpret mode the
same (its f32 sum order differs from both; bf16 rounds its conv outputs
where the port does).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tdnet_tpu.kernels import fused_stem as jfs
from tdnet_tpu_torch.kernels.fused_stem import (STRIP, WINDOW, fused_stem_plain, split_tf32,
                                                stem_plan, weight_chunks)
from tf32_emulation import round_toward_zero
from tf32_emulation import split_tf32 as split_tf32_emulated

PHASE10 = {torch.float32: 1e-4, torch.bfloat16: 2e-2}   # x max|ref|
NAN = float("nan")
# (H, W) of the tail's input: ragged; past one strip and not a multiple of the strip in
# either dtype; the deep-base ResNet's stem at a 65x129 frame (test_torch_fused_stem.py)
SHAPES = [(21, 35), (40, 131), (33, 65)]


@pytest.fixture(autouse=True)
def one_thread():
    """The emulation is many small ops, which threads only slow down."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def unchunk(chunks: torch.Tensor, dtype) -> tuple[torch.Tensor, torch.Tensor | None]:
    """``weight_chunks``' inverse: [3 passes, 9 taps, 64 n, 64 k] of the
    weights (bf16), or of their TF32 hi and lo parts (f32)."""
    vec = 16 // chunks.element_size()
    rows = chunks.reshape(-1, 8, vec)
    r = torch.arange(rows.shape[0])
    idx = torch.arange(8)[None, :] ^ (r[:, None] % 8)   # the swizzle is its own inverse
    rows = torch.gather(rows, 1, idx[:, :, None].expand(-1, -1, vec))
    if dtype == torch.bfloat16:
        return rows.reshape(3, 9, 64, 64), None
    parts = rows.reshape(3, 9, 2, 2, 64, 32).permute(0, 1, 3, 4, 2, 5).reshape(3, 9, 2, 64, 64)
    return parts[:, :, 0], parts[:, :, 1]


def _product(a, hi, lo):
    """a [rows, 9, 64] (the taps' inputs) times a pass's weights [9, 64 n, 64 k]:
    [rows, 64] in f32, summed as the kernel sums it."""
    if lo is None:   # bf16: exact products, summed in f32 (float64 here)
        return torch.einsum("rtk,tnk->rn", a.double(), hi.double()).float()
    ah, al = split_tf32_emulated(a.float())
    acc = torch.zeros(a.shape[0], 64)
    for tap in range(9):
        for half in range(2):   # a chunk: 32 input channels of one tap, one chain
            t = torch.zeros_like(acc)
            for k0 in range(32 * half, 32 * half + 32, 8):
                ks = slice(k0, k0 + 8)
                for x, w in ((al, hi), (ah, lo), (ah, hi)):
                    t = round_toward_zero(t.double() + x[:, tap, ks].double()
                                          @ w[tap, :, ks].double().T)
            acc = acc + t
    return acc


def _bn_relu(acc, sb, dtype):
    """relu(round(fma(round(acc), scale, bias))) per channel, in f32."""
    rnd = lambda v: v.to(dtype).float()
    v = rnd((rnd(acc).double() * sb[0].double() + sb[1].double()).float())
    return v.clamp_min(0.0)


def kernel_twin(x, w1, sb1, w2, sb2, sms=132):
    """The kernel's output for x [n, 64, H, W] (bf16 or f32), block by block."""
    dtype = x.dtype
    n, _, h, w = x.shape
    hp, wp = (h + 1) // 2, (w + 1) // 2
    wt, pw, vec = WINDOW[dtype], STRIP[dtype], 16 // x.element_size()
    rs = wt + 2
    span = (rs + 2 * (vec - 1)) // vec * vec
    plan = stem_plan(n, h, w, dtype, sms)
    hi, lo = unchunk(weight_chunks(w1, w2), dtype)
    flat = x.reshape(-1).float()
    y = torch.full((n, 128, hp, wp), NAN)
    taps = [(i, j) for i in range(3) for j in range(3)]
    for b in range(n):
        base, limit = b * 64 * h * w, (n - b) * 64 * h * w
        for strip in range(plan.strips):
            for band in range(plan.bands):
                pc0, p0 = strip * pw, band * plan.band_rows
                pb = min(plan.band_rows, hp - p0)
                x0 = 2 * pc0 - 3
                xlo, xhi = max(x0, 0), min(x0 + rs, w)
                ch = torch.arange(64)
                xring, cring = torch.full((4, rs, 64), NAN), torch.full((4, rs, 64), NAN)

                def load_pair(row):
                    """The kernel's vector loads: from each (row, channel)'s first
                    element aligned down to a vector, while a vector starts
                    before the row's last needed element; past x's end, zeros."""
                    stage = torch.full((2, 64, span), NAN)
                    for rr in range(2):
                        yy = 2 * p0 - 3 + row + rr
                        if not 0 <= yy < h or xlo >= xhi:
                            continue
                        first = ch * h * w + yy * w + xlo
                        start = first - first % vec
                        src = start[:, None] + torch.arange(span)[None, :]
                        loaded = (src - src % vec) < (first + xhi - xlo)[:, None]
                        inside = src < limit
                        vals = flat[(base + src).clamp(max=flat.numel() - 1)]
                        stage[rr] = torch.where(loaded, torch.where(inside, vals, 0.0), NAN)
                    return stage

                def store_pair(row, stage):
                    for rr in range(2):
                        yy = 2 * p0 - 3 + row + rr
                        xx = x0 + torch.arange(rs)
                        ok = (0 <= yy < h) & (xx >= 0) & (xx < w)
                        first = ch * h * w + yy * w + xlo
                        idx = (first % vec)[None, :] + (xx - xlo).clamp(min=0)[:, None]
                        got = stage[rr].T.gather(0, idx.clamp(max=span - 1))   # [rs, 64]
                        xring[(row + rr) % 4] = torch.where(ok[:, None], got, 0.0)

                def gemm(ring, row0, p):
                    """Two rows of wt columns: [2, wt, 64] of pass p."""
                    a = torch.stack([torch.stack([ring[(row0 + r + i) % 4, j:j + wt]
                                                  for i, j in taps], dim=1)
                                     for r in range(2)])          # [2, wt, 9, 64]
                    got = _product(a.reshape(2 * wt, 9, 64), hi[p], None if lo is None
                                   else lo[p])
                    return got.reshape(2, wt, 64)

                store_pair(0, load_pair(0))
                store_pair(2, load_pair(2))
                carry, held = [None, None], [None, None]
                for k in range(pb + 2):
                    stage = load_pair(2 * k + 4) if k <= pb else None
                    acc = gemm(xring, 2 * k, 0)
                    for r in range(2):
                        yy = 2 * p0 - 2 + 2 * k + r
                        xx = 2 * pc0 - 2 + torch.arange(wt)
                        ok = (0 <= yy < h) & (xx >= 0) & (xx < w)
                        cring[(2 * k + r) % 4, :wt] = torch.where(
                            ok[:, None], _bn_relu(acc[r], sb1, dtype), 0.0)
                    if k >= 1:
                        jp = k - 1
                        for hf in range(2):
                            acc = gemm(cring, 2 * jp, 1 + hf)
                            v = []
                            for r in range(2):
                                yy = 2 * p0 - 1 + 2 * jp + r
                                xx = 2 * pc0 - 1 + torch.arange(wt)
                                ok = (0 <= yy < h) & (xx >= 0) & (xx < w)
                                v.append(torch.where(ok[:, None], _bn_relu(
                                    acc[r], sb2[:, 64 * hf:64 * hf + 64], dtype), -np.inf))
                            if jp >= 1:
                                held[hf] = torch.maximum(carry[hf], v[0])
                            carry[hf] = torch.maximum(v[0], v[1])
                    if stage is not None:
                        store_pair(2 * k + 4, stage)
                    if k >= 2:
                        vmax = torch.cat(held, dim=1)   # [wt, 128]
                        pr = p0 + k - 2
                        for jj in range(pw):
                            if pc0 + jj < wp:
                                y[b, :, pr, pc0 + jj] = vmax[2 * jj:2 * jj + 3].amax(0)
    return y.to(dtype)


def _case(h, w, dtype, n=1, seed=0):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(np.maximum(rng.randn(n, 64, h, w), 0).astype(np.float32)).to(dtype)
    w1 = torch.from_numpy((rng.randn(64, 64, 3, 3) * 0.06).astype(np.float32)).to(dtype)
    w2 = torch.from_numpy((rng.randn(128, 64, 3, 3) * 0.06).astype(np.float32)).to(dtype)
    sb1, sb2 = (torch.from_numpy(np.stack([rng.rand(c) + 0.5, rng.randn(c) * 0.1]).astype(
        np.float32)) for c in (64, 128))
    return x, w1, sb1, w2, sb2


def _close(got, want, dtype):
    assert got.shape == want.shape and not torch.isnan(got.float()).any()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= PHASE10[dtype] * want.float().abs().max().item(), err


@pytest.mark.parametrize("hw", SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_twin_matches_plain(hw, dtype):
    args = _case(*hw, dtype, seed=hw[0])
    _close(kernel_twin(*args), fused_stem_plain(*args), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sms", [5, 12])
def test_twin_with_longer_bands_and_a_batch(dtype, sms):
    """Fewer SMs than strips x rows: bands of several pooled rows, two images
    (the second image's rows end at x's end)."""
    args = _case(23, 70, dtype, n=2, seed=sms)
    plan = stem_plan(2, 23, 70, dtype, sms)
    assert plan.band_rows > 1
    _close(kernel_twin(*args, sms=sms), fused_stem_plain(*args), dtype)


@pytest.mark.parametrize("hw", SHAPES[1:])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_twin_matches_jax_kernel(hw, dtype, monkeypatch):
    orig = jfs.pl.pallas_call
    monkeypatch.setattr(jfs.pl, "pallas_call",
                        lambda *a, **kw: orig(*a, **{**kw, "interpret": True}))
    x, w1, sb1, w2, sb2 = _case(*hw, dtype, seed=7)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    hwio = lambda t: jnp.asarray(t.float().numpy().transpose(2, 3, 1, 0), dtype=jdt)
    want = jfs.fused_stem_tail(jnp.asarray(x.float().numpy().transpose(0, 2, 3, 1), dtype=jdt),
                               hwio(w1), jnp.asarray(sb1.numpy()), hwio(w2),
                               jnp.asarray(sb2.numpy()))
    want = torch.from_numpy(np.array(want.astype(jnp.float32)).transpose(0, 3, 1, 2))
    _close(kernel_twin(x, w1, sb1, w2, sb2), want, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_weight_chunks_hold_the_taps(dtype):
    _, w1, _, w2, _ = _case(5, 5, dtype)
    hi, lo = unchunk(weight_chunks(w1, w2), dtype)
    taps = torch.stack([w1, w2[:64], w2[64:]]).permute(0, 3, 4, 1, 2).reshape(3, 9, 64, 64)
    if dtype == torch.bfloat16:
        assert torch.equal(hi, taps)
    else:
        want_hi, want_lo = split_tf32_emulated(taps)
        assert torch.equal(hi, want_hi) and torch.equal(lo, want_lo)
        assert torch.equal(torch.stack(split_tf32(taps)), torch.stack([want_hi, want_lo]))
        assert (hi.double() + lo.double() - taps.double()).abs().max() <= \
            2.0 ** -21 * taps.abs().max()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,h,w", [(1, 513, 1025), (1, 385, 769), (1, 21, 35), (3, 97, 193),
                                   (40, 33, 65)])
def test_stem_plan_covers_the_output(dtype, n, h, w):
    hp, wp = (h + 1) // 2, (w + 1) // 2
    plan = stem_plan(n, h, w, dtype, 132)
    assert plan.strips * STRIP[dtype] >= wp > (plan.strips - 1) * STRIP[dtype]
    assert plan.bands * plan.band_rows >= hp > (plan.bands - 1) * plan.band_rows
    assert n * plan.strips * plan.bands <= 132 or plan.bands == 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_the_window_holds_a_strip(dtype):
    """A strip's input columns (2 PW + 5) fit in a ring row, and the vertical
    max of a pooled row (WINDOW x 128 channels) in the two conv1 rows a step
    frees (csrc/fused_stem.cu: Geo's static_asserts)."""
    wt, pw = WINDOW[dtype], STRIP[dtype]
    assert 2 * pw + 5 <= wt and wt % 64 == 0
    assert wt * 128 <= 2 * (wt + 2) * 64
