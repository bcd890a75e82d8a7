"""The tiling, masks and numerics of K1's bf16 path (``csrc/propagation_attention.cu``,
``run_bf16``), emulated in torch on the CPU.

The bf16 path runs three kernels on ``wgmma``: ``attn_bf16<.., true>`` (each q
row's m = max s c and l = sum 2^(s c - m), c = log2(e) / temperature, a block
of 64 q rows walking the keys in chunks of 128, ``STATS_TILE``, each
thread of a quad folding its own keys 8 j + 2 t + {0, 1} of a chunk, the
quad's four partials merged at the end), then, in the tiling ``grid.Bf16Plan``,
``attn_bf16<.., false>`` (p =
2^(s c - m) (1 / l) rounded to bf16, p v summed in f32 over the chunks, a block
owning ``rows`` q rows and ``cols`` columns) and ``fc_bf16`` (o w + b over
64-deep chunks, a block owning ``rows`` rows of the [n Lq, d_v] PV result and
``cols`` columns). K and V come in by TMA, which fills rows past the keys with
zeros. There is no card here, so ``kernel_twin`` walks the same grids, chunks,
quads and masks in torch: every slot of the statistics, the PV result and the
output that no block writes stays NaN (a block the grid missed would show),
products are taken in float64 on bf16-exact operands and summed in f32 once a
chunk (the tensor core sums exact bf16 products in f32), ex2.approx.ftz is
``torch.exp2`` with results below 2^-126 flushed to zero, and fmaf is taken in
float64 and rounded to f32.

Tolerance: ``chip_smoke.py`` phase 2's bf16 rule, 3e-2 x max|ref|, against
``propagation_attention_plain`` and against the JAX kernel in interpret mode
(as ``tests/test_torch_attention.py`` runs it), both on the same bf16 inputs.
"""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tdnet_tpu.kernels import propagation_attention as jax_pa
from tdnet_tpu_torch.kernels import grid
from tdnet_tpu_torch.kernels.grid import (BF16_TILES, SMEM, Bf16Plan, attention_bf16_plan,
                                          bf16_grid, bf16_max_stages, bf16_smem)
from tdnet_tpu_torch.kernels.propagation_attention import propagation_attention_plain

RULE = 3e-2                     # phase 2's bf16 rule, x max|ref|
STATS_TILE = (64, 128)          # the stats kernel's rows and keys, whatever the plan (run_bf16)
HOPS = [(33153, 2145), (18721, 1225), (1225, 1225)]   # the streaming hops (Lq, Lkv)
D_K = 64
NEG = float("-inf")


def ex2(x: torch.Tensor) -> torch.Tensor:
    """ex2.approx.ftz.f32: 2^x, results below f32's normal range flushed to zero."""
    y = torch.exp2(x)
    return torch.where(y < 2.0 ** -126, torch.zeros_like(y), y)


def fmaf(a, b, c) -> torch.Tensor:
    return (a.double() * b.double() + c.double()).float()


def chunk_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A chunk's product on the tensor cores: exact bf16 products, one f32 sum."""
    return (a.double() @ b.double()).float()


def merge2(m, l, mo, lo):
    """The kernel's merge of two (max, sum of 2^(x - max)) pairs; max -inf: empty."""
    mn = torch.maximum(m, mo)
    a = torch.where(m == NEG, torch.zeros_like(l), l * ex2(m - mn))
    b = torch.where(mo == NEG, torch.zeros_like(lo), lo * ex2(mo - mn))
    return mn, a + b


def quad_keys(keys: int, t: int) -> list[int]:
    """The positions in a chunk of the keys that quad lane t holds, in its order."""
    return [8 * j + 2 * t + e for j in range(keys // 8) for e in range(2)]


def stats_rows(q, k, c, keys):
    """(m, l) of every row of q [rows, 64] over k [lkv, 64], as the stats kernel
    folds them: a chunk at a time, each quad lane over its own keys, then the
    lanes merged (0 with 1, 2 with 3, then the two)."""
    lkv, rows = k.shape[0], q.shape[0]
    chunks = -(-lkv // keys)
    kz = torch.zeros(chunks * keys, D_K)
    kz[:lkv] = k                         # TMA fills rows past the keys with zeros
    m = torch.full((4, rows), NEG)
    l = torch.zeros(4, rows)
    for ch in range(chunks):
        s = chunk_product(q, kz[ch * keys:(ch + 1) * keys].T)
        for t in range(4):
            pos = [p for p in quad_keys(keys, t) if ch * keys + p < lkv]
            if not pos:
                continue
            cm = (s[:, pos] * c).amax(1)
            up = cm > m[t]
            l[t] = torch.where(up, l[t] * ex2(m[t] - cm), l[t])
            m[t] = torch.where(up, cm, m[t])
            acc = torch.zeros(rows)
            for p in pos:
                acc = acc + ex2(fmaf(s[:, p], c, -m[t]))
            l[t] = l[t] + acc
    m01, l01 = merge2(m[0], l[0], m[1], l[1])
    m23, l23 = merge2(m[2], l[2], m[3], l[3])
    return merge2(m01, l01, m23, l23)


def pv_rows(q, k, v, m, l, c, keys):
    """o (f32) of every row of q: p = 2^(s c - m) (1 / l) rounded to bf16 a chunk
    at a time, keys past lkv masked to 0, p v summed in f32 a chunk."""
    lkv = k.shape[0]
    chunks = -(-lkv // keys)
    kz, vz = torch.zeros(chunks * keys, D_K), torch.zeros(chunks * keys, v.shape[1])
    kz[:lkv], vz[:lkv] = k, v
    il = 1.0 / l
    acc = torch.zeros(q.shape[0], v.shape[1])
    for ch in range(chunks):
        sl = slice(ch * keys, (ch + 1) * keys)
        s = chunk_product(q, kz[sl].T)
        p = ex2(fmaf(s, c, -m[:, None])) * il[:, None]
        p[:, torch.arange(ch * keys, (ch + 1) * keys) >= lkv] = 0.0
        acc = acc + chunk_product(p.bfloat16().float(), vz[sl])
    return acc


def kernel_twin(q, k, v, temperature, plan: Bf16Plan, fc_w=None, fc_b=None):
    """K1's bf16 path in the tiling ``plan`` on bf16 tensors q [n, Lq, 64],
    k [n, Lkv, 64], v [n, Lkv, dv]: the three kernels' grids walked block by
    block; what no block writes stays NaN."""
    n, lq, _ = q.shape
    dv = v.shape[2]
    c = torch.tensor(math.log2(math.e) / temperature, dtype=torch.float32)
    q, k, v = q.float(), k.float(), v.float()
    gx, gy, gz = bf16_grid(plan, n, lq, dv)
    stats_rows_a_block, stats_keys = STATS_TILE
    rows_pad = -(-lq // 128) * 128
    stats = torch.full((2, n, lq), float("nan"))
    o = torch.full((n, lq, dv), float("nan"), dtype=torch.bfloat16)
    for z in range(gz):
        qz = torch.zeros(rows_pad, D_K)   # rows past Lq load as zeros
        qz[:lq] = q[z]
        m, l = stats_rows(qz, k[z], c, stats_keys)
        for x in range(-(-lq // stats_rows_a_block)):   # the stats kernel's blocks
            r0, r1 = x * stats_rows_a_block, min((x + 1) * stats_rows_a_block, lq)
            stats[0, z, r0:r1], stats[1, z, r0:r1] = m[r0:r1], l[r0:r1]
        # the p v kernel reads the statistics of rows below Lq, and (0, 1) past it
        ms = torch.zeros(rows_pad)
        ls = torch.ones(rows_pad)
        ms[:lq], ls[:lq] = stats[0, z], stats[1, z]
        for y in range(gy):
            cols = slice(y * plan.cols, (y + 1) * plan.cols)
            acc = pv_rows(qz, k[z], v[z][:, cols], ms, ls, c, plan.keys)
            for x in range(gx):
                r0, r1 = x * plan.rows, min((x + 1) * plan.rows, lq)
                o[z, r0:r1, cols] = acc[r0:r1].bfloat16()
    if fc_w is None:
        return o
    rows = n * lq
    x_in = o.reshape(rows, dv).float()
    y = torch.full((rows, dv), float("nan"), dtype=torch.bfloat16)
    w, bias = fc_w.float(), fc_b.float()
    for x in range(-(-rows // plan.rows)):
        r0, r1 = x * plan.rows, min((x + 1) * plan.rows, rows)
        for cb in range(dv // plan.cols):
            cols = slice(cb * plan.cols, (cb + 1) * plan.cols)
            acc = torch.zeros(r1 - r0, plan.cols)
            for kc in range(dv // 64):
                ks = slice(64 * kc, 64 * kc + 64)
                acc = acc + chunk_product(x_in[r0:r1, ks], w[ks, cols])
            y[r0:r1, cols] = (acc + bias[cols]).bfloat16()
    return y.reshape(n, lq, dv)


def _inputs(n, lq, lkv, dv, seed, q_scale=1.0):
    rng = np.random.RandomState(seed)
    x = dict(q=rng.randn(n, lq, D_K) * q_scale, k=rng.randn(n, lkv, D_K),
             v=rng.randn(n, lkv, dv), w=rng.randn(dv, dv) * 0.05, b=rng.randn(dv) * 0.1)
    return {name: torch.tensor(a, dtype=torch.float32).bfloat16() for name, a in x.items()}


def _check(got, ref):
    assert not torch.isnan(got.float()).any(), "a slot no block writes"
    err = (got.float() - ref.float()).abs().max().item()
    tol = RULE * ref.float().abs().max().item()
    assert err <= tol, f"max abs err {err} > {tol}"


# (n, Lq, Lkv, q scale): ragged Lq and Lkv, a batch of 2, and a softmax as peaked as the
# stream's at random init (PERF.md, run S1: most of exp(s - m) below 2^-126)
CASES = [(1, 700, 130, 1.0), (2, 700, 130, 1.0), (1, 333, 200, 1.0), (1, 200, 97, 40.0)]


@pytest.fixture(autouse=True)
def one_thread():
    """The emulation is many small ops, which threads only slow down."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("fc", [False, True], ids=["attn", "attn_fc"])
@pytest.mark.parametrize("tile", BF16_TILES, ids=lambda t: "r{}c{}k{}".format(*t))
@pytest.mark.parametrize("case", CASES, ids=lambda c: "{}x{}x{}q{:g}".format(*c))
def test_twin_matches_plain(case, tile, fc):
    n, lq, lkv, q_scale = case
    t = _inputs(n, lq, lkv, 512, seed=lq + lkv, q_scale=q_scale)
    kw = dict(fc_w=t["w"], fc_b=t["b"]) if fc else {}
    got = kernel_twin(t["q"], t["k"], t["v"], 8.0, Bf16Plan(*tile, 4), **kw)
    ref = propagation_attention_plain(*(t[x].float() for x in "qkv"), temperature=8.0,
                                      **{key: a.float() for key, a in kw.items()})
    _check(got, ref)


def _interpret(monkeypatch):
    orig = jax_pa.pl.pallas_call
    monkeypatch.setattr(jax_pa.pl, "pallas_call",
                        lambda *a, **kw: orig(*a, **{**kw, "interpret": True}))


@pytest.mark.parametrize("fc", [False, True], ids=["attn", "attn_fc"])
@pytest.mark.parametrize("case", CASES[:3], ids=lambda c: "{}x{}x{}".format(*c[:3]))
def test_twin_matches_pallas_interpret(case, fc, monkeypatch):
    """The twin in the tiling the plan picks against the TPU kernel on the same
    bf16 inputs (its softmax, p and PV result rounded where the port rounds)."""
    _interpret(monkeypatch)
    n, lq, lkv, _ = case
    t = _inputs(n, lq, lkv, 512, seed=7 + lq)
    j = {name: jnp.asarray(a.float().numpy()).astype(jnp.bfloat16) for name, a in t.items()}
    jkw = dict(fc_w=j["w"], fc_b=j["b"]) if fc else {}
    want = jax_pa.fused_propagation_attention(j["q"], j["k"], j["v"], temperature=8.0, **jkw)
    want = torch.from_numpy(np.array(want.astype(jnp.float32)))
    kw = dict(fc_w=t["w"], fc_b=t["b"]) if fc else {}
    plan = attention_bf16_plan(n, lq, lkv, 512, 132)
    _check(kernel_twin(t["q"], t["k"], t["v"], 8.0, plan, **kw), want)


def test_twin_shows_a_block_the_grid_misses(monkeypatch):
    """The NaN fill catches a p v grid one q block short."""
    t = _inputs(1, 333, 70, 256, seed=3)
    plan = Bf16Plan(64, 128, 64, 4)
    real = grid.bf16_grid
    monkeypatch.setitem(globals(), "bf16_grid",
                        lambda p, n, lq, dv: (real(p, n, lq, dv)[0] - 1, *real(p, n, lq, dv)[1:]))
    got = kernel_twin(t["q"], t["k"], t["v"], 8.0, plan)
    nan_rows = torch.isnan(got.float()).any(-1)[0].nonzero().flatten()
    assert nan_rows.tolist() == list(range(320, 333))


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("hop", HOPS, ids=lambda h: "{}x{}".format(*h))
def test_plan_covers_each_row_column_and_key_once(hop, sms):
    """The plan's grids give every q row of every column block, every column and
    every key exactly one owner, and its ring fits a block's shared memory."""
    lq, lkv = hop
    dv = 512
    plan = attention_bf16_plan(1, lq, lkv, dv, sms)
    assert plan[:3] in BF16_TILES and dv % plan.cols == 0
    assert 1 <= plan.stages <= bf16_max_stages(*plan[:3])
    assert bf16_smem(plan) <= SMEM
    gx, gy, gz = bf16_grid(plan, 1, lq, dv)
    owners = torch.zeros(lq, dv, dtype=torch.int32)
    for x in range(gx):
        for y in range(gy):
            owners[x * plan.rows:(x + 1) * plan.rows, y * plan.cols:(y + 1) * plan.cols] += 1
    assert gz == 1 and bool((owners == 1).all())
    chunks = -(-lkv // plan.keys)
    seen = torch.zeros(chunks * plan.keys, dtype=torch.int32)
    for ch in range(chunks):
        for t in range(4):   # each quad lane's keys of the chunk
            seen[[ch * plan.keys + p for p in quad_keys(plan.keys, t)]] += 1
    assert bool((seen == 1).all())
    # the keys past lkv are the last chunk's, masked there
    assert chunks * plan.keys - lkv < plan.keys


def test_plan_picks_by_how_full_the_card_is():
    """256 columns and 64 keys where those blocks fill three waves, else 128 and 128."""
    assert attention_bf16_plan(1, 33153, 2145, 512, 132) == Bf16Plan(64, 256, 64, 2)
    assert attention_bf16_plan(1, 33153, 2145, 512, 114) == Bf16Plan(64, 256, 64, 2)
    assert attention_bf16_plan(1, 18721, 1225, 512, 132) == Bf16Plan(64, 128, 128, 2)
    assert attention_bf16_plan(1, 1225, 1225, 512, 132) == Bf16Plan(64, 128, 128, 2)
    assert attention_bf16_plan(1, 33153, 2145, 384, 132).cols == 128   # 256 must divide d_v
