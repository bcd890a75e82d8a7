"""K2's bf16 path on ``wgmma`` fed by TMA (``csrc/propagation_attention_train.cu``,
``k2::``, with K1's kernels of ``csrc/attention_bf16.cuh`` for the forward),
what a CPU can hold it to.

There is no card here, so this file holds the kernels' arithmetic and plans,
not the kernels:

- a float64 twin of the forward's arithmetic in the kernels' order: scores
  scaled to log2 units, each key range's (m, l) merged in order, p = 2^(s c - m)
  (1 / l), the keep bits and 1 / (1 - rate) on p, pd rounded to bf16, p v
  summed a 64-key chunk at a time into an f32 sum, the key ranges' partial
  outputs added in order and rounded once; held to the plain version by phase
  7b's rule (one bf16 ulp of max|plain output|);
- a float64 twin of the backward (t summed over the plan's key ranges in order,
  ds rounded to bf16, dv and dk over the plan's q ranges and warpgroup halves,
  dq over its key splits, summed in order, scaled and rounded once) held to
  ``_PlainLowPrecision``'s backward at 1e-2 x max|grad|;
- without dropout, both twins held to the JAX Pallas kernel in interpret mode
  by ``test_torch_train_bf16_kernels.py``'s rule for the plain version;
- the plans: every q row, key and column covered once, each kernel's shared
  memory within 232,448 bytes and its TMA boxes within 256 rows, and each grid
  at least one wave at both training hops on 132 SMs; the scratch carved into
  aligned parts that do not overlap; the keep bits' words;
- the forward and the backward take exactly d_v 128-512; the profiler's
  families of the kernels' names; the K2 fault child among chip_smoke's.

The kernels against their plain version run on the card (``chip_smoke.py``
phases 7b and 7c).
"""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
from tdnet_tpu.kernels import propagation_attention_train as jax_pat
from tdnet_tpu_torch.cli.profile import kernel_family
from tdnet_tpu_torch.kernels import grid
from tdnet_tpu_torch.kernels import propagation_attention_train as pat
from tdnet_tpu_torch.ops.dropout_mask import keep_mask

BF16 = torch.bfloat16
LOG2E = np.float32(1.4426950408889634)
RATE, SEED, TEMPERATURE = 0.1, 11, 8.0
SMS = 132
MAX_SMEM = 232448   # bytes of shared memory a block may have
MAX_BOX = 256       # rows of a TMA box
# (n, Lq, Lkv, d_v): ragged rows and keys, a batch of 2, both widths
CASES = [(1, 1000, 260, 512), (2, 700, 130, 128), (1, 130, 28, 512), (2, 257, 97, 128)]
TRAIN_HOPS = [(1, 2145, 2145), (1, 18721, 2145)]


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(BF16).double()


def _inputs(n, lq, lkv, dv, seed):
    """q, k, v, dy rounded to bf16 (torch), made from a seed with numpy."""
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(rng.randn(n, m, d).astype(np.float32)).to(BF16)
            for m, d in ((lq, 64), (lkv, 64), (lkv, dv), (lq, dv))]


def _f32_add(acc, x):
    """acc + x rounded to f32 (an f32 accumulator)."""
    return (acc + x).float().double()


def _merge(m, l, mo, lo):
    """Merge two (max, sum of 2^(x - max)) pairs, as merge2 does."""
    mn = torch.maximum(m, mo)
    return mn, l * torch.exp2(m - mn) + lo * torch.exp2(mo - mn)


def _ranges(units: int, per: int):
    return [(a, min(a + per, units)) for a in range(0, units, per)]


def _keep(n, lq, lkv, rate):
    if rate == 0.0:
        return torch.ones(n, lq, lkv, dtype=torch.float64)
    inv = float(np.float32(1.0 / (1.0 - rate)))
    return keep_mask(SEED, rate, (n, lq, lkv)).double() * inv


def forward_twin(q, k, v, rate, plan):
    """The forward in float64 in the kernels' order (see the module's docstring);
    returns (o bf16, m, l, x = s c) with (m, l) the merged row statistics."""
    n, lq, _ = q.shape
    lkv = k.shape[1]
    c = float(np.float32(1.0 / TEMPERATURE) * LOG2E)
    x = torch.matmul(q.double(), k.double().transpose(1, 2)) * c
    m = l = None
    for a, b in _ranges(math.ceil(lkv / grid.STATS_KEYS), plan.stat_kper):
        xr = x[..., a * grid.STATS_KEYS:b * grid.STATS_KEYS]
        mr = xr.amax(-1)
        lr = torch.exp2(xr - mr[..., None]).sum(-1)
        m, l = (mr, lr) if m is None else _merge(m, l, mr, lr)
    p = torch.exp2(x - m[..., None]) * (1.0 / l[..., None])
    pd = _bf16(p * _keep(n, lq, lkv, rate))
    out = torch.zeros(n, lq, v.shape[2], dtype=torch.float64)
    for a, b in _ranges(math.ceil(lkv / plan.keys), plan.pv_kper):
        part = torch.zeros_like(out)
        for ch in range(a, b):
            keys = slice(ch * plan.keys, (ch + 1) * plan.keys)
            part = _f32_add(part, torch.matmul(pd[..., keys], v.double()[:, keys]))
        out = _f32_add(out, part)
    return out.to(BF16), m, l, x


def backward_twin(q, k, v, dy, rate, m, l, x, plan):
    """The backward in float64 in the kernels' order, from the forward's merged
    (m, l) and its scores x; returns (dq, dk, dv) bf16."""
    n, lq, _ = q.shape
    lkv, dv = v.shape[1], v.shape[2]
    scale = float(np.float32(1.0 / TEMPERATURE))
    p = torch.exp2(x - m[..., None]) * (1.0 / l[..., None])
    keep = _keep(n, lq, lkv, rate)
    dp = torch.matmul(dy.double(), v.double().transpose(1, 2)) * keep
    t = torch.zeros(n, lq, dtype=torch.float64)
    for a, b in _ranges(math.ceil(lkv / grid.T_KEYS), plan.t_kper):
        keys = slice(a * grid.T_KEYS, b * grid.T_KEYS)
        t = _f32_add(t, (dp[..., keys] * p[..., keys]).sum(-1).float().double())
    ds = _bf16(p * (dp - t[..., None]))
    pd = _bf16(p * keep)
    dvs = torch.zeros(n, lkv, dv, dtype=torch.float64)
    dks = torch.zeros(n, lkv, 64, dtype=torch.float64)
    for a, b in _ranges(math.ceil(lq / grid.KV_Q), plan.q_per):
        dv_part = torch.zeros_like(dvs)
        dk_part = [torch.zeros_like(dks), torch.zeros_like(dks)]   # the two warpgroups
        for ch in range(a, b):
            rows = slice(ch * grid.KV_Q, (ch + 1) * grid.KV_Q)
            dv_part = _f32_add(dv_part, torch.matmul(pd[:, rows].transpose(1, 2),
                                                     dy.double()[:, rows]))
            for cg in range(2):
                half = slice(ch * grid.KV_Q + 16 * cg, ch * grid.KV_Q + 16 * cg + 16)
                dk_part[cg] = _f32_add(dk_part[cg], torch.matmul(ds[:, half].transpose(1, 2),
                                                                 q.double()[:, half]))
        dvs = _f32_add(dvs, dv_part)
        for part in dk_part:
            dks = _f32_add(dks, part)
    dqs = torch.zeros(n, lq, 64, dtype=torch.float64)
    for a, b in _ranges(plan.lds // grid.DQ_KEYS, plan.dq_kper):
        part = torch.zeros_like(dqs)
        for ch in range(a, b):
            keys = slice(ch * grid.DQ_KEYS, (ch + 1) * grid.DQ_KEYS)
            part = _f32_add(part, torch.matmul(ds[..., keys], k.double()[:, keys]))
        dqs = _f32_add(dqs, part)
    return ((dqs * scale).float().to(BF16), (dks * scale).float().to(BF16),
            dvs.float().to(BF16))


def _plans(n, lq, lkv, dv):
    return (grid.train_forward_plan(n, lq, lkv, dv, SMS),
            grid.train_backward_plan(n, lq, lkv, dv, SMS))


def _plain(q, k, v, dy, rate):
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = pat.propagation_attention_train_plain(*leaves, temperature=TEMPERATURE,
                                                dropout_rate=rate, seed=SEED)
    out.backward(dy)
    return [out.detach()] + [t.grad for t in leaves]


def _twins(q, k, v, dy, rate):
    fwd, bwd = _plans(q.shape[0], q.shape[1], k.shape[1], v.shape[2])
    o, m, l, x = forward_twin(q, k, v, rate, fwd)
    return [o, *backward_twin(q, k, v, dy, rate, m, l, x, bwd)]


@pytest.mark.parametrize("rate", [0.0, RATE])
@pytest.mark.parametrize("n,lq,lkv,dv", CASES)
def test_twins_match_the_plain_version(n, lq, lkv, dv, rate):
    """Phase 7b's rule: the output within one bf16 ulp of max|plain output|,
    dq, dk, dv within 1e-2 x max|grad| of each tensor; all bf16."""
    q, k, v, dy = _inputs(n, lq, lkv, dv, seed=lq + lkv + n)
    got, want = _twins(q, k, v, dy, rate), _plain(q, k, v, dy, rate)
    assert all(g.dtype == BF16 for g in got)
    ulp = chip_smoke.bf16_ulp(want[0].float().abs().max()).item()
    assert (got[0].float() - want[0].float()).abs().max().item() <= ulp
    for name, g, w in zip(("dq", "dk", "dv"), got[1:], want[1:]):
        share = (g.float() - w.float()).abs().max().item() / w.float().abs().max().item()
        assert share <= chip_smoke.BF16_GRAD_RTOL, f"{name}: {share}"


def _interpret(monkeypatch):
    orig = jax_pat.pl.pallas_call
    monkeypatch.setattr(jax_pat.pl, "pallas_call",
                        lambda *a, **kw: orig(*a, **{**kw, "interpret": True}))


@pytest.mark.parametrize("n,lq,lkv,dv", [(1, 1000, 260, 512), (1, 513, 28, 128)])
def test_twins_match_the_pallas_kernel(n, lq, lkv, dv, monkeypatch):
    """Without dropout, against the JAX Pallas kernel in interpret mode by
    ``test_torch_train_bf16_kernels.py``'s rule for the plain version: each
    output within one bf16 ulp of max(|o_ij|, sum_k p_ik |v_kj|), each gradient
    within 5e-3 x max|grad|."""
    _interpret(monkeypatch)
    q, k, v, dy = _inputs(n, lq, lkv, dv, seed=7 * lq + lkv)
    jb = [jnp.asarray(t.float().numpy()).astype(jnp.bfloat16) for t in (q, k, v, dy)]
    ker = lambda q, k, v: jax_pat.fused_propagation_attention_train(q, k, v,
                                                                    temperature=TEMPERATURE)
    out, vjp = jax.vjp(ker, *jb[:3])
    want = [torch.from_numpy(np.array(w.astype(jnp.float32)))
            for w in [out] + list(vjp(jb[3]))]
    got = _twins(q, k, v, dy, 0.0)
    p = torch.softmax(torch.matmul(q.double(), k.double().transpose(1, 2)) / TEMPERATURE, -1)
    mag = torch.maximum(want[0].abs().double(), torch.matmul(p, v.double().abs()))
    assert bool(((got[0].double() - want[0].double()).abs() <= chip_smoke.bf16_ulp(mag)).all())
    for name, g, w in zip(("dq", "dk", "dv"), got[1:], want[1:]):
        err = (g.float() - w).abs().max().item()
        assert err <= 5e-3 * w.abs().max().item(), f"{name}: {err}"


def _covered(ranges, units):
    """Each unit in exactly one range."""
    seen = [u for a, b in ranges for u in range(a, b)]
    return sorted(seen) == list(range(units)) and all(a < b for a, b in ranges)


SHAPES = TRAIN_HOPS + [(n, lq, lkv) for n, lq, lkv, _ in CASES]


@pytest.mark.parametrize("dv", [128, 256, 384, 512])
@pytest.mark.parametrize("n,lq,lkv", SHAPES)
def test_plans_cover_every_row_key_and_column_once(n, lq, lkv, dv):
    fwd, bwd = _plans(n, lq, lkv, dv)
    assert dv % fwd.cols == 0 and (fwd.cols, fwd.keys) in grid.TRAIN_TILES
    stat_chunks, pv_chunks = math.ceil(lkv / grid.STATS_KEYS), math.ceil(lkv / fwd.keys)
    assert _covered(_ranges(stat_chunks, fwd.stat_kper), stat_chunks)
    assert _covered(_ranges(pv_chunks, fwd.pv_kper), pv_chunks)
    grids = grid.train_forward_grids(fwd, n, lq, lkv, dv)
    assert grids["stats"][0] * 64 >= lq > (grids["stats"][0] - 1) * 64
    assert grids["pv"][1] == len(_ranges(pv_chunks, fwd.pv_kper)) * dv // fwd.cols
    t_chunks, q_chunks = math.ceil(lkv / grid.T_KEYS), math.ceil(lq / grid.KV_Q)
    assert _covered(_ranges(t_chunks, bwd.t_kper), t_chunks)
    assert len(_ranges(t_chunks, bwd.t_kper)) == bwd.t_ranges
    assert _covered(_ranges(q_chunks, bwd.q_per), q_chunks)
    assert len(_ranges(q_chunks, bwd.q_per)) == bwd.qsplit <= grid.BF16_MAX_QSPLIT
    assert bwd.lds % grid.KV_KEYS == 0 and bwd.lds - grid.KV_KEYS < lkv <= bwd.lds
    assert _covered(_ranges(bwd.lds // grid.DQ_KEYS, bwd.dq_kper), bwd.lds // grid.DQ_KEYS)
    assert len(_ranges(bwd.lds // grid.DQ_KEYS, bwd.dq_kper)) == bwd.ksplit
    bgrids = grid.train_backward_grids(bwd, n, lq, lkv)
    assert bgrids["t"][0] * grid.T_ROWS >= lq and bgrids["dq"][0] * grid.DQ_ROWS >= lq
    assert bgrids["dkdv"][0] * grid.KV_KEYS == bwd.lds


@pytest.mark.parametrize("dv", [128, 256, 384, 512])
def test_kernels_fit_shared_memory_and_tma_boxes(dv):
    smem = grid.train_smem(dv)
    assert all(b <= MAX_SMEM for b in smem.values()), smem
    boxes = [grid.STATS_KEYS, grid.T_ROWS, grid.T_KEYS, grid.KV_KEYS, grid.KV_Q, grid.DQ_ROWS,
             grid.DQ_KEYS] + [keys for _, keys in grid.TRAIN_TILES]
    assert max(boxes) <= MAX_BOX


@pytest.mark.parametrize("n,lq,lkv", TRAIN_HOPS)
def test_plans_fill_a_wave_at_the_training_hops(n, lq, lkv):
    """Every kernel's grid holds at least as many blocks as the card's 132 SMs
    have slots: two an SM for the stats, p v and dq kernels, one for the t and
    dk/dv passes."""
    fwd, bwd = _plans(n, lq, lkv, 512)
    grids = {**grid.train_forward_grids(fwd, n, lq, lkv, 512),
             **grid.train_backward_grids(bwd, n, lq, lkv)}
    per_sm = dict(stats=2, pv=2, t=1, dkdv=1, dq=2)
    for name, (x, y, z) in grids.items():
        assert grid.train_waves(x * y * z, per_sm[name], SMS) >= 1.0, (name, x, y, z)


@pytest.mark.parametrize("n,lq,lkv,dv", CASES + [(1, 18721, 2145, 512)])
def test_scratch_parts_are_aligned_and_disjoint(n, lq, lkv, dv):
    fwd, bwd = _plans(n, lq, lkv, dv)
    for sizes in (pat.forward_scratch(fwd, n, lq, lkv, dv),
                  pat.backward_scratch(bwd, n, lq, lkv, dv)):
        offsets, total = pat.carve(sizes)
        spans = sorted((offsets[k], offsets[k] + size) for k, size in sizes.items() if size)
        assert all(a % pat.ALIGN == 0 for a, _ in spans)
        assert all(b0 <= a1 for (_, b0), (a1, _) in zip(spans, spans[1:]))
        assert not spans or spans[-1][1] <= total
    back = pat.backward_scratch(bwd, n, lq, lkv, dv)
    assert back["ds"] == 2 * n * lq * bwd.lds
    assert back["dv_part"] == 4 * bwd.qsplit * n * lkv * dv
    assert back["dk_part"] == 4 * 2 * bwd.qsplit * n * lkv * 64


@pytest.mark.parametrize("lkv", [28, 97, 130, 2145, 32, 128])
def test_keep_words_cover_the_keys_in_16_byte_rows(lkv):
    words = pat.keep_words(lkv)
    assert words * 32 >= lkv and words % 4 == 0 and (words - 4) * 32 < lkv
    # the p v kernel's 64-key chunks read words [2 c, 2 c + 2) of a row
    assert 2 * math.ceil(lkv / 64) <= words


@pytest.mark.parametrize("dv", [64, 128, 192, 256, 384, 512, 640])
def test_forward_and_backward_take_dv_128_to_512(dv):
    q, k = torch.zeros(1, 70, 64, dtype=BF16), torch.zeros(1, 30, 64, dtype=BF16)
    v = torch.zeros(1, 30, dv, dtype=BF16)
    ok = dv in (128, 256, 384, 512)
    if ok:
        pat._check(q, k, v)
        grid.train_backward_plan(1, 70, 30, dv, SMS)
    else:
        with pytest.raises(ValueError):
            pat._check(q, k, v)


def test_profile_families_of_the_kernels():
    backward = ("void (anonymous namespace)::k2::rowt_wgmma<4, true>(CUtensorMap_st)",
                "void (anonymous namespace)::k2::dkdv_wgmma<4, false>(CUtensorMap_st)",
                "(anonymous namespace)::k2::dq_wgmma(CUtensorMap_st, CUtensorMap_st)",
                "(anonymous namespace)::k2::row_terms(float const*)",
                "void (anonymous namespace)::k2::sum_scaled<1>((anonymous namespace)::k2::SumJobs)")
    forward = ("void (anonymous namespace)::attn::attn_bf16<1, 128, 64, false, true>(CUtensorMap)",
               "void (anonymous namespace)::attn::attn_bf16<1, 128, 128, true, false>(CUtensor)",
               "void (anonymous namespace)::k2::sum_scaled<0>((anonymous namespace)::k2::SumJobs)",
               "(anonymous namespace)::k2::keep_bits(unsigned int*, int, int, unsigned long)")
    assert {kernel_family(name, train=True) for name in backward} == {
        "K2 training attention backward"}
    assert {kernel_family(name, train=True) for name in forward} == {"K1 propagation attention"}


def test_fault_check_covers_k2():
    assert chip_smoke.K2_FAULT_DEFINES == ("TDNET_CONSUMER_POLLS=4", "TDNET_K2_STARVE")
    assert pat.library_name(chip_smoke.K2_FAULT_DEFINES) != pat.library_name()
