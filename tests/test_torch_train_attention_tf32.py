"""The numerics and the grids of the f32 attention kernels: K2, the training
attention (``csrc/propagation_attention_train.cu``), and K1's f32 path
(``csrc/propagation_attention.cu``), which share the scores and p
(``csrc/attention_f32.cuh``).

The tensor-core products (K2's backward: dpd, dv, dk and dq; K1's p v and fc)
run as ``mma.sync`` m16n8k8 in 3xTF32: each operand x splits into hi =
rna_tf32(x) and lo = rna_tf32(x - hi), and a b accumulates as a_lo b_hi +
a_hi b_lo + a_hi b_hi, 8 terms of the depth an instruction. The tensor core
truncates as it accumulates, so the kernels sum short chains (2 k-steps of
dpd, a 64-row chunk of dv and dk, 32 keys of dq; 32 keys of K1's p v and of
its fc's depth) in a fresh accumulator that they add in round-to-nearest f32;
and they form the scores s with the same FMAs everywhere, so p is the same to
the bit. K2's forward sums p v on the CUDA cores, one fmaf a key in key order,
as a plain f32 GEMM does. There is no card here, so this file emulates TF32
round-to-nearest-away as int32 bit operations on the f32 view and the
accumulator as a sum rounded toward zero, runs each kernel in its order (each
key range of ``forward_plan`` for K1's p v; each q range of ``backward_plan``
for dv and dk, each key range for dq; all summed in order as ``sum_parts``
does), and holds K2's forward output to
``chip_smoke.py`` phase 7's tolerance (1e-5 x max|o|) and dq, dk and dv to its
atol 2e-4, rtol 1e-3 of the float64 result, with dropout on; K1's f32 path to
1e-5 x max|o| of float64 and, with the fc, to the JAX kernel in interpret mode.
Plain TF32 (one product a product), and one chain over all 2,145 keys of the
recipe's hops, land farther from float64. The gradient of a bias shared by all
keys is zero in exact arithmetic (softmax's invariance: sum_j ds_ij = 0); the
kernels keep it near the plain f32 version's, where s in 3xTF32 and unchunked
chains (the design that failed ``chip_smoke.py`` phase 9 on ``w_ks.conv1.bias``)
do not.
"""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tdnet_tpu.kernels import propagation_attention as jax_pa
from tdnet_tpu_torch.kernels.grid import FC_FIXED, FORWARD_FIXED, Q_BLOCK, column_width
from tdnet_tpu_torch.kernels.propagation_attention import KEY_CHUNK, MAX_RANGES, forward_plan
from tdnet_tpu_torch.kernels.propagation_attention_train import (
    DQ_ROWS, D_K, KEY_BLOCK, MAX_QSPLIT, Q_CHUNK, _check, backward_plan,
    propagation_attention_train_plain)
from tdnet_tpu_torch.ops.dropout_mask import keep_mask
from tf32_emulation import rna_tf32, round_toward_zero

N, LQ, LKV, DV = 1, 96, 80, 256
TEMPERATURE, RATE, SEED = 8.0, 0.1, 11
SMS = 132   # the H100's SM count: the plan splits q over 2 ranges and keys over 3
# k-steps a fresh accumulator sums in the kernel: dpd, dv and dk (a 64-row chunk), dq
# (32 keys); ONE_CHAIN sums each range in a single accumulator
KERNEL_CHAINS = dict(dpd=2, dv=Q_CHUNK // 8, dk=Q_CHUNK // 8, dq=KEY_BLOCK // 8)
ONE_CHAIN = dict(dpd=10**6, dv=10**6, dk=10**6, dq=10**6)
FWD_CHAIN = KEY_CHUNK // 8   # k-steps a fresh accumulator sums in K1's p v and fc: 4


def three_tf32(a, b):
    """The products of a k-step in the kernel's order, small terms first."""
    a_hi, b_hi = rna_tf32(a), rna_tf32(b)
    a_lo, b_lo = rna_tf32(a - a_hi), rna_tf32(b - b_hi)
    return [(a_lo, b_hi), (a_hi, b_lo), (a_hi, b_hi)]


def one_tf32(a, b):
    return [(rna_tf32(a), rna_tf32(b))]


def mma_chain(c, a, b, terms, steps):
    """c += a b as m16n8k8 instructions along the depth: each adds its 8-term
    products to a truncating accumulator, which is added to c in f32 every
    ``steps`` k-steps and starts again from zero."""
    t = torch.zeros_like(c)
    for i, k0 in enumerate(range(0, a.shape[-1], 8)):
        for x, y in terms(a[:, k0:k0 + 8], b[k0:k0 + 8]):
            t = round_toward_zero(t.double() + x.double() @ y.double())
        if (i + 1) % steps == 0:
            c, t = c + t, torch.zeros_like(c)
    return c + t


def forward_scores(q, k):
    """s^T [keys, q] as the forward forms it: one fmaf a depth step from 0."""
    acc = torch.zeros(k.shape[0], q.shape[0])
    for d in range(q.shape[1]):
        acc = (k[:, d, None].double() * q[None, :, d].double() + acc.double()).float()
    return acc / TEMPERATURE


def sum_parts(parts):
    out = torch.zeros_like(parts[0])
    for p in parts:
        out = out + p
    return out


def forward_p(q, k, keep=None, rate=RATE):
    """p [q, keys] as the kernels form it, from the forward's scores, the mask applied."""
    s = forward_scores(q, k).T.contiguous()
    e = torch.exp(s - s.max(1, keepdim=True).values)
    p = e / e.sum(1, keepdim=True)
    if keep is not None:
        p = torch.where(keep, p * (1.0 / (1.0 - rate)), torch.zeros(()))
    return p


def k1_forward(q, k, v, terms=three_tf32, chain=FWD_CHAIN, sms=SMS):
    """K1's f32 p v for one batch element in its order and rounding: over each key range of
    ``forward_plan``, ``chain`` k-steps a fresh accumulator, the ranges summed in order."""
    lq, lkv, dv = q.shape[0], k.shape[0], v.shape[1]
    plan = forward_plan(1, lq, lkv, dv, sms)
    p = forward_p(q, k)
    pad = math.ceil(lkv / KEY_CHUNK) * KEY_CHUNK - lkv
    p = torch.cat([p, p.new_zeros(lq, pad)], 1)
    v = torch.cat([v, v.new_zeros(pad, dv)])
    span = plan.k_per * KEY_CHUNK
    return sum_parts([mma_chain(torch.zeros(lq, dv), p[:, r:r + span].contiguous(),
                                v[r:r + span], terms, chain) for r in range(0, p.shape[1], span)])


def k2_forward(q, k, v, keep):
    """K2's forward for one batch element: one f32 fmaf a key, from 0 in key order."""
    p = forward_p(q, k, keep)
    acc = torch.zeros(q.shape[0], v.shape[1])
    for j in range(k.shape[0]):
        acc = (p[:, j:j + 1].double() * v[j].double() + acc.double()).float()
    return acc


def kernel_fc(x, w, b):
    """K1's fc x w + b in 3xTF32, each 32-deep chunk a fresh accumulator."""
    return mma_chain(torch.zeros(x.shape[0], w.shape[1]), x, w, three_tf32, FWD_CHAIN) + b


def kernel_backward(q, k, v, o, dy, keep, terms=three_tf32, chains=KERNEL_CHAINS,
                    s_forward=True, sms=SMS):
    """dq, dk, dv of one batch element in the kernel's order and rounding."""
    lq, lkv, dv = q.shape[0], k.shape[0], v.shape[1]
    plan = backward_plan(1, lq, lkv, dv, sms)
    scale, inv_keep = 1.0 / TEMPERATURE, 1.0 / (1.0 - RATE)
    s_fwd = forward_scores(q, k)
    m = s_fwd.max(0).values
    l = torch.exp(s_fwd - m).sum(0)   # the saved stats, [q]
    lds = plan.ds[2]
    pad_q = math.ceil(lq / Q_CHUNK) * Q_CHUNK
    zq = lambda x: torch.cat([x, x.new_zeros(pad_q - lq, *x.shape[1:])])
    zk = lambda x: torch.cat([x, x.new_zeros(lds - lkv, *x.shape[1:])])
    pad = lambda x: zk(zq(x.T).T)   # [keys, q] -> [lds, pad_q]
    st = s_fwd if s_forward else mma_chain(torch.zeros(lkv, lq), k, q.T.contiguous(), terms,
                                           10**6) * scale
    keep_t = pad(keep.T)
    p = pad(torch.exp(st - m) / l)
    d = zq((dy * o).sum(-1))
    q, dy, k, v = zq(q), zq(dy), zk(k), zk(v)
    pd = torch.where(keep_t, p * inv_keep, torch.zeros(()))
    dpd = mma_chain(torch.zeros(lds, pad_q), v, dy.T.contiguous(), terms, chains["dpd"])
    ds_t = p * (torch.where(keep_t, dpd * inv_keep, torch.zeros(())) - d)
    dv_parts, dk_parts = [], []
    for s in range(plan.qsplit):
        r = slice(s * plan.q_per * Q_CHUNK, min(pad_q, (s + 1) * plan.q_per * Q_CHUNK))
        dv_parts.append(mma_chain(torch.zeros(lds, dv), pd[:, r].contiguous(), dy[r], terms,
                                  chains["dv"]))
        dk_parts.append(mma_chain(torch.zeros(lds, D_K), ds_t[:, r].contiguous(), q[r], terms,
                                  chains["dk"]) * scale)
    ds = ds_t.T.contiguous()
    dq_parts = []
    for s in range(plan.ksplit):
        r = slice(s * plan.k_per * KEY_BLOCK, min(lds, (s + 1) * plan.k_per * KEY_BLOCK))
        dq_parts.append(mma_chain(torch.zeros(pad_q, D_K), ds[:, r].contiguous(), k[r], terms,
                                  chains["dq"]) * scale)
    return (sum_parts(dq_parts)[:lq], sum_parts(dk_parts)[:lkv], sum_parts(dv_parts)[:lkv])


def _case(sigma: float = 1.0):
    """Seeded inputs ([96, 64] q against [80, 64] k, scaled by ``sigma``, d_v 256),
    the forward's output in f32, the keep mask, and the float64 and f32 plain
    gradients."""
    rng = np.random.RandomState(5)
    q, k = (torch.from_numpy((sigma * rng.randn(n, D_K)).astype(np.float32)) for n in (LQ, LKV))
    v = torch.from_numpy(rng.randn(LKV, DV).astype(np.float32))
    dy = torch.from_numpy(rng.randn(LQ, DV).astype(np.float32))
    keep = keep_mask(SEED, RATE, (N, LQ, LKV))[0]
    o = propagation_attention_train_plain(q[None], k[None], v[None], temperature=TEMPERATURE,
                                          dropout_rate=RATE, seed=SEED)[0]
    grads = []
    for dtype in (torch.float64, torch.float32):
        leaves = [t.to(dtype)[None].requires_grad_(True) for t in (q, k, v)]
        out = propagation_attention_train_plain(*leaves, temperature=TEMPERATURE,
                                                dropout_rate=RATE, seed=SEED)
        out.backward(dy.to(dtype)[None])
        grads.append([t.grad[0] for t in leaves])
    return (q, k, v, o, dy, keep), grads[0], grads[1]


@pytest.fixture(scope="module")
def case():
    return _case()


def _errors(got, ref):
    return [(a.double() - b).abs().max().item() for a, b in zip(got, ref)]


def test_three_tf32_backward_within_phase7_tolerance_of_float64(case):
    args, ref, _ = case
    got = kernel_backward(*args)
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        assert torch.allclose(a.double(), b, atol=2e-4, rtol=1e-3), \
            (name, (a.double() - b).abs().max().item())
    assert max(_errors(got, ref)) < 2e-5


def test_one_tf32_is_farther_from_float64_than_three_tf32(case):
    args, ref, _ = case
    err3 = _errors(kernel_backward(*args), ref)
    err1 = _errors(kernel_backward(*args, terms=one_tf32), ref)
    for e1, e3 in zip(err1, err3):
        assert e1 > 10 * e3, (err1, err3)


def test_the_split_does_not_move_the_result_beyond_f32_rounding(case):
    """One SM (one q range, one key range) against the H100's 132: the same
    numbers up to the order of the partial sums."""
    args, _, _ = case
    split = kernel_backward(*args)
    whole = kernel_backward(*args, sms=1)
    assert backward_plan(N, LQ, LKV, DV, 1)[:4] == (2, 1, 3, 1)
    for a, b in zip(split, whole):
        assert torch.allclose(a, b, atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("sigma", [1.0, 3.0])
def test_the_gradient_of_a_key_bias_stays_near_zero(sigma):
    """sum_j dk_j is zero in exact arithmetic. The kernel's design keeps it
    within 4x of the plain f32 version's, also where D = dy . o reads K2's
    forward's o, or an o from p v in 3xTF32 as K1's path forms it; s in 3xTF32
    with each range in one accumulator (the design that failed phase 9) lands
    at least 3x farther."""
    args, _, plain32 = _case(sigma)
    q, k, v, _, dy, keep = args
    key_bias = lambda dk: dk.double().sum(0).abs().max().item()
    kernel = key_bias(kernel_backward(*args)[1])
    through_k2 = key_bias(kernel_backward(q, k, v, k2_forward(q, k, v, keep), dy, keep)[1])
    pd = forward_p(q, k, keep)
    o_tc = mma_chain(torch.zeros(LQ, DV), pd, v, three_tf32, FWD_CHAIN)
    through_tc = key_bias(kernel_backward(q, k, v, o_tc, dy, keep)[1])
    unchunked = key_bias(kernel_backward(*args, chains=ONE_CHAIN, s_forward=False)[1])
    for got in (kernel, through_k2, through_tc):
        assert got < 4 * key_bias(plain32[1]), (got, key_bias(plain32[1]))
    assert unchunked > 3 * kernel, (unchunked, kernel)


def _forward_case(lq, lkv, dv, rate, seed=5):
    rng = np.random.RandomState(seed)
    q, k = (torch.from_numpy(rng.randn(n, D_K).astype(np.float32)) for n in (lq, lkv))
    v = torch.from_numpy(rng.randn(lkv, dv).astype(np.float32))
    keep = keep_mask(SEED, rate, (N, lq, lkv))[0] if rate else None
    o64 = propagation_attention_train_plain(q.double()[None], k.double()[None], v.double()[None],
                                            temperature=TEMPERATURE, dropout_rate=rate,
                                            seed=SEED)[0]
    return q, k, v, keep, o64


FORWARD_SHAPES = [(LQ, LKV, DV), (70, 200, 384), (64, 2145, 128)]


@pytest.mark.parametrize("lq,lkv,dv", FORWARD_SHAPES)
def test_three_tf32_forward_within_phase7_tolerance_of_float64(lq, lkv, dv):
    """K1's f32 p v as the kernel runs it, key split included (3 ranges at
    96 x 80, 7 at 70 x 200, 8 at 64 x 2,145 on 132 SMs)."""
    q, k, v, _, o64 = _forward_case(lq, lkv, dv, 0.0)
    assert forward_plan(1, lq, lkv, dv, SMS).ranges == {80: 3, 200: 7, 2145: 8}[lkv]
    got = k1_forward(q, k, v)
    err = (got.double() - o64).abs().max().item()
    assert err <= 1e-5 * o64.abs().max().item(), (err, o64.abs().max().item())


@pytest.mark.parametrize("lq,lkv,dv", FORWARD_SHAPES)
def test_k2_forward_in_key_order_within_phase7_tolerance_of_float64(lq, lkv, dv):
    """K2's forward, one fmaf a key in key order, with dropout on."""
    q, k, v, keep, o64 = _forward_case(lq, lkv, dv, RATE)
    err = (k2_forward(q, k, v, keep).double() - o64).abs().max().item()
    assert err <= 1e-5 * o64.abs().max().item(), (err, o64.abs().max().item())


def test_the_three_tf32_forward_is_closer_to_float64_than_the_key_order_sum():
    """At the recipe's 2,145 keys K1's 3xTF32 p v lies closer to float64 (rms)
    than a sum in key order, as a plain f32 GEMM forms it: K2 keeps the key
    order for its rounding, not its accuracy."""
    q, k, v, _, o64 = _forward_case(64, 2145, 128, 0.0)
    rms = lambda o: (o.double() - o64).pow(2).mean().sqrt().item()
    assert rms(k1_forward(q, k, v)) < 0.7 * rms(k2_forward(q, k, v, None))


def test_one_chain_over_all_keys_is_farther_from_float64():
    """At the recipe's 2,145 keys one truncating chain over all keys lands
    more than 5x farther from float64 than the kernel's 32-key chains, and
    beyond phase 7's tolerance; plain TF32 farther still."""
    q, k, v, _, o64 = _forward_case(64, 2145, 128, 0.0)
    err = lambda o: (o.double() - o64).abs().max().item()
    chunked = err(k1_forward(q, k, v))
    one_chain = err(k1_forward(q, k, v, chain=10**6, sms=1))
    plain_tf32 = err(k1_forward(q, k, v, terms=one_tf32))
    assert forward_plan(1, 64, 2145, 128, 1).ranges == 1
    assert one_chain > 5 * chunked, (one_chain, chunked)
    assert one_chain > 1e-5 * o64.abs().max().item()
    assert plain_tf32 > 10 * chunked, (plain_tf32, chunked)


def _interpret(monkeypatch):
    orig = jax_pa.pl.pallas_call
    monkeypatch.setattr(jax_pa.pl, "pallas_call",
                        lambda *a, **kw: orig(*a, **{**kw, "interpret": True}))


@pytest.mark.parametrize("fc", [False, True], ids=["attn", "attn_fc"])
@pytest.mark.parametrize("lq,lkv,dv", [(513, 28, 128), (700, 130, 512)])
def test_k1_f32_emulated_matches_pallas_interpret(lq, lkv, dv, fc, monkeypatch):
    """K1's f32 path as the kernels run it (p v in 3xTF32 over forward_plan's
    key ranges, then the fc in 3xTF32) against the JAX kernel in interpret
    mode, at tests/test_torch_attention.py's tolerances (atol 2e-5 / rtol 1e-4,
    5e-4 / 1e-3 with the fc)."""
    _interpret(monkeypatch)
    rng = np.random.RandomState(lq + lkv)
    x = dict(q=rng.randn(1, lq, 64), k=rng.randn(1, lkv, 64), v=rng.randn(1, lkv, dv),
             w=rng.randn(dv, dv) * 0.05, b=rng.randn(dv) * 0.1)
    x = {n: a.astype(np.float32) for n, a in x.items()}
    t = {n: torch.from_numpy(a) for n, a in x.items()}
    jkw = dict(fc_w=jnp.asarray(x["w"]), fc_b=jnp.asarray(x["b"])) if fc else {}
    want = np.asarray(jax_pa.fused_propagation_attention(
        jnp.asarray(x["q"]), jnp.asarray(x["k"]), jnp.asarray(x["v"]), temperature=8.0,
        **jkw))[0]
    got = k1_forward(t["q"][0], t["k"][0], t["v"][0])
    if fc:
        got = kernel_fc(got, t["w"], t["b"])
    atol, rtol = (5e-4, 1e-3) if fc else (2e-5, 1e-4)
    np.testing.assert_allclose(got.numpy(), want, atol=atol, rtol=rtol)


def test_rna_tf32_rounds_to_nearest_ties_away():
    one_ulp = 2.0 ** -10
    x = torch.tensor([1.0, 1.0 + one_ulp / 2, 1.0 + one_ulp / 4, -(1.0 + one_ulp / 2),
                      -(1.0 + 3 * one_ulp / 4), 0.0], dtype=torch.float32)
    want = torch.tensor([1.0, 1.0 + one_ulp, 1.0, -(1.0 + one_ulp), -(1.0 + one_ulp), 0.0])
    assert torch.equal(rna_tf32(x), want)
    assert (rna_tf32(x).view(torch.int32) & 0x1FFF).eq(0).all()


@pytest.mark.parametrize("n,lq,lkv,dv,sms", [
    (1, 18721, 2145, 512, 132),   # the recipe's last hop
    (1, 2145, 2145, 512, 132),    # its first two hops
    (2, 700, 130, 512, 132),
    (1, LQ, LKV, DV, SMS),
    (1, 1, 1, 128, 132),
    (3, 5000, 33, 384, 7),
    (1, 96, 80, 256, 2),
])
def test_backward_plan(n, lq, lkv, dv, sms):
    plan = backward_plan(n, lq, lkv, dv, sms)
    assert plan == backward_plan(n, lq, lkv, dv, sms)
    qchunks, key_blocks = math.ceil(lq / Q_CHUNK), math.ceil(lkv / KEY_BLOCK)
    assert min(plan.q_per, plan.qsplit, plan.k_per, plan.ksplit) >= 1
    # every split is nonempty and together they cover the range once
    assert plan.qsplit == math.ceil(qchunks / plan.q_per) <= MAX_QSPLIT
    assert (plan.qsplit - 1) * plan.q_per < qchunks
    assert plan.ksplit == math.ceil(key_blocks / plan.k_per)
    assert (plan.ksplit - 1) * plan.k_per < key_blocks
    # at least half the SMs busy where the work allows it
    assert key_blocks * n * plan.qsplit >= min(sms / 2, key_blocks * n * qchunks)
    assert math.ceil(lq / DQ_ROWS) * n * plan.ksplit >= min(sms, math.ceil(lq / DQ_ROWS) * n
                                                             * key_blocks)
    lds = plan.ds[2]
    assert plan.ds == (n, lq, lds) and lds % KEY_BLOCK == 0 and lkv <= lds < lkv + KEY_BLOCK
    assert plan.dq_part == (plan.ksplit, n, lq, D_K)
    assert plan.dk_part == (plan.qsplit, n, lkv, D_K)
    assert plan.dv_part == (plan.qsplit, n, lkv, dv)


@pytest.mark.parametrize("dv", [64, 192, 640, 1024])
def test_backward_plan_rejects_d_v_it_cannot_hold(dv):
    with pytest.raises(ValueError):
        backward_plan(1, 100, 100, dv, 132)


def test_the_forward_takes_the_d_v_the_backward_takes():
    """The forward's check refuses what backward_plan refuses, so a d_v the
    backward cannot hold fails at the forward, not at loss.backward()."""
    q = k = torch.zeros(1, 4, D_K)
    forward, backward = set(), set()
    for dv in range(128, 2049):
        for taken, call in ((forward, lambda: _check(q, k, torch.zeros(1, 4, dv))),
                            (backward, lambda: backward_plan(1, 4, 4, dv, SMS))):
            try:
                call()
                taken.add(dv)
            except ValueError as e:
                assert "the backward takes d_v in 128, 256, 384, 512" in str(e)
    assert forward == backward == {128, 256, 384, 512}


@pytest.mark.parametrize("n,lq,lkv,dv,sms", [
    (1, 18721, 2145, 512, 132),   # the recipe's last hop
    (1, 2145, 2145, 512, 132),    # its first two hops
    (1, 33153, 2145, 512, 132),   # TD2-PSP50's streaming hop
    (1, 1225, 1225, 512, 132),    # TD4-PSP18's first streaming hops
    (2, 700, 130, 512, 132),
    (1, LQ, LKV, DV, SMS),
    (1, 1, 1, 128, 132),
    (3, 5000, 33, 384, 7),
])
def test_forward_plan(n, lq, lkv, dv, sms):
    plan = forward_plan(n, lq, lkv, dv, sms)
    assert plan == forward_plan(n, lq, lkv, dv, sms)
    chunks = math.ceil(lkv / KEY_CHUNK)
    assert plan.cols == max(c for c in (128, 256, 512) if dv % c == 0)
    assert plan.fc_cols == column_width(math.ceil(n * lq / Q_BLOCK), dv, sms, FC_FIXED)
    # every range is nonempty and together they cover the keys once
    assert 1 <= plan.ranges == math.ceil(chunks / plan.k_per) <= MAX_RANGES
    assert (plan.ranges - 1) * plan.k_per < chunks
    assert plan.parts == ((plan.ranges, n, lq, dv) if plan.ranges > 1 else None)
    # at least half the SMs busy where the work allows it
    blocks = math.ceil(lq / Q_BLOCK) * n * dv // plan.cols
    assert blocks * plan.ranges >= min(sms / 2, blocks * chunks)


@pytest.mark.parametrize("rows,dv,fixed,want", [
    (18721, 512, FC_FIXED, 256),   # K1's fc at 18,721 rows: 586 blocks fill the card, 293 not
    (33153, 512, FC_FIXED, 512),   # TD2-PSP50's hop: 519 blocks of 512 columns, 4 waves
    (1225, 512, FC_FIXED, 128),    # TD4-PSP18's first hops: 20 row blocks, 80 blocks of 128
    (700, 384, FC_FIXED, 128),     # the only width that divides 384
    (5000, 256, FC_FIXED, 256),
    (18721, 512, FORWARD_FIXED, 512),   # K2's forward at the recipe's last hop
    (2145, 512, FORWARD_FIXED, 256),    # and at its first two hops
])
def test_column_width(rows, dv, fixed, want):
    width = column_width(math.ceil(rows / Q_BLOCK), dv, SMS, fixed)
    assert width == want and dv % width == 0
