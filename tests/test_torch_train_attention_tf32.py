"""The numerics and the grid of K2's backward (``csrc/propagation_attention_train.cu``).

The kernel runs the backward's products dpd, dv, dk and dq as ``mma.sync``
m16n8k8 in 3xTF32: each operand x splits into hi = rna_tf32(x) and lo =
rna_tf32(x - hi), and a b accumulates as a_lo b_hi + a_hi b_lo + a_hi b_hi, 8
terms of the depth an instruction. The tensor core truncates as it
accumulates, so the kernel sums short chains (2 k-steps of dpd, a 64-row
chunk of dv and dk, 32 keys of dq) in a fresh accumulator that it adds in
round-to-nearest f32; and it recomputes the scores s with the forward's FMAs,
so p is the forward's p. There is no card here, so this file emulates TF32
round-to-nearest-away as int32 bit operations on the f32 view and the
accumulator as a sum rounded toward zero, runs the backward in the kernel's
order (each q range of ``backward_plan`` for dv and dk, each key range for dq,
the partials summed in order as ``sum_parts`` does), and holds dq, dk and dv
to ``chip_smoke.py`` phase 7's tolerance (atol 2e-4, rtol 1e-3) of the float64
result, with dropout on. Plain TF32 (one product a product) lands farther
from float64. The gradient of a bias shared by all keys is zero in exact
arithmetic (softmax's invariance: sum_j ds_ij = 0); the kernel keeps it near
the plain f32 version's, where s in 3xTF32 and unchunked chains (the design
that failed ``chip_smoke.py`` phase 9 on ``w_ks.conv1.bias``) do not.
"""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from tdnet_tpu_torch.kernels.propagation_attention_train import (
    DQ_ROWS, D_K, KEY_BLOCK, MAX_QSPLIT, Q_CHUNK, backward_plan,
    propagation_attention_train_plain)
from tdnet_tpu_torch.ops.dropout_mask import keep_mask

N, LQ, LKV, DV = 1, 96, 80, 256
TEMPERATURE, RATE, SEED = 8.0, 0.1, 11
SMS = 132   # the H100's SM count: the plan splits q over 2 ranges and keys over 3
# k-steps a fresh accumulator sums in the kernel: dpd, dv and dk (a 64-row chunk), dq
# (32 keys); ONE_CHAIN sums each range in a single accumulator
KERNEL_CHAINS = dict(dpd=2, dv=Q_CHUNK // 8, dk=Q_CHUNK // 8, dq=KEY_BLOCK // 8)
ONE_CHAIN = dict(dpd=10**6, dv=10**6, dk=10**6, dq=10**6)


def rna_tf32(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32: keep 10 mantissa bits, ties away from zero."""
    u = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    u = (u + 0x1000) & 0xFFFFE000
    u = torch.where(u >= 2**31, u - 2**32, u)
    return u.to(torch.int32).view(torch.float32)


def round_toward_zero(x: torch.Tensor) -> torch.Tensor:
    """float64 -> float32, truncated: the tensor core's accumulator."""
    f = x.float()
    return torch.where(f.double().abs() > x.abs(), torch.nextafter(f, torch.zeros_like(f)), f)


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
    within 4x of the plain f32 version's; s in 3xTF32 with each range in one
    accumulator (the design that failed phase 9) lands at least 3x farther."""
    args, _, plain32 = _case(sigma)
    key_bias = lambda dk: dk.double().sum(0).abs().max().item()
    kernel = key_bias(kernel_backward(*args)[1])
    unchunked = key_bias(kernel_backward(*args, chains=ONE_CHAIN, s_forward=False)[1])
    assert kernel < 4 * key_bias(plain32[1]), (kernel, key_bias(plain32[1]))
    assert unchunked > 3 * kernel, (unchunked, kernel)


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
