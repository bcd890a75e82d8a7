"""The bfloat16 plain versions of the training kernels K2 (training attention)
and K3 (dropout) on the CPU: the spec the bfloat16 CUDA kernels are held to on
the card (``chip_smoke.py`` phases 7b and 8b).

- K2's plain version in bfloat16 against the JAX Pallas training kernel in
  interpret mode in bfloat16, dropout off, at (1000, 130, 256) and
  (513, 28, 128); every output dtype is JAX's (bfloat16).
  The forward: each element within one bfloat16 ulp of max(|o_ij|,
  sum_k pd_ik |v_kj|), the magnitude its f32 sum carries. Exactly one ulp of
  |o_ij| does not hold: XLA's CPU dot and exp differ from torch's in the last
  f32 bit, so a few p round to the other bfloat16 neighbour (2 of 130,000 at
  the first shape), and where o_ij cancels to near 0 that moves it by a few of
  its own ulps.
  The backward: dq, dk and dv each within 5e-3 x max|grad| of that tensor
  (the largest seen, 2.4e-3, is dk at the first shape: ds rounds to bfloat16
  from f32 sums taken in other orders).
- K3's plain version in bfloat16 equals where(keep, x * bf16(1 / (1 - rate)), 0)
  bitwise, forward and backward; the scale the bfloat16 launch passes is
  1.109375 at rate 0.1.
- With dropout on, K2's bfloat16 plain version equals the explicit-mask
  formula at the kernel's rounding points, forward and backward.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tdnet_tpu.kernels import propagation_attention_train as jax_pat
from tdnet_tpu_torch.kernels.dropout import _rate_args, dropout_plain
from tdnet_tpu_torch.kernels.propagation_attention_train import propagation_attention_train
from tdnet_tpu_torch.ops.dropout_mask import keep_mask

RATE = 0.1
BF16 = torch.bfloat16


def _interpret(monkeypatch):
    orig = jax_pat.pl.pallas_call
    monkeypatch.setattr(jax_pat.pl, "pallas_call",
                        lambda *a, **kw: orig(*a, **{**kw, "interpret": True}))


def _inputs(lq, lk, dv, seed):
    """q, k, v, dy rounded to bfloat16: as jax arrays and as torch tensors."""
    rng = np.random.RandomState(seed)
    arrs = [rng.randn(1, lq, 64), rng.randn(1, lk, 64), rng.randn(1, lk, dv), rng.randn(1, lq, dv)]
    jb = [jnp.asarray(a, jnp.float32).astype(jnp.bfloat16) for a in arrs]
    tb = [torch.from_numpy(np.asarray(a.astype(jnp.float32))).to(BF16) for a in jb]
    return jb, tb


def _fwd_grads(fn, q, k, v, dy):
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = fn(*leaves)
    out.backward(dy)
    return [out.detach()] + [t.grad for t in leaves]


def _bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """The spacing of bfloat16 numbers at |x| (7 fraction bits), normals only."""
    return 2.0 ** (torch.floor(torch.log2(x.abs().float().clamp(min=2.0 ** -126))) - 7)


def _abs_sum(q, k, v, keep=None):
    """sum_k pd_ik |v_kj| in float64: the magnitude of each output's f32 sum."""
    p = torch.softmax(torch.matmul(q.double(), k.double().transpose(1, 2)) / 8.0, dim=-1)
    if keep is not None:
        p = torch.where(keep, p / (1 - RATE), torch.zeros((), dtype=p.dtype))
    return torch.matmul(p, v.double().abs())


@pytest.mark.parametrize("lq,lk,dv", [(1000, 130, 256), (513, 28, 128)])
def test_bf16_plain_matches_pallas_train_kernel(lq, lk, dv, monkeypatch):
    _interpret(monkeypatch)
    jb, (q, k, v, dy) = _inputs(lq, lk, dv, seed=lq + lk)
    ker = lambda q, k, v: jax_pat.fused_propagation_attention_train(q, k, v, temperature=8.0)
    out, vjp = jax.vjp(ker, *jb[:3])
    want = [out] + list(vjp(jb[3]))
    assert all(w.dtype == jnp.bfloat16 for w in want)
    want = [torch.from_numpy(np.asarray(w.astype(jnp.float32))) for w in want]
    got = _fwd_grads(lambda q, k, v: propagation_attention_train(q, k, v, temperature=8.0),
                     q, k, v, dy)
    assert all(g.dtype == BF16 for g in got)
    o, o_ref = got[0].float(), want[0]
    bound = _bf16_ulp(torch.maximum(o_ref.abs().double(), _abs_sum(q, k, v)))
    assert bool(((o - o_ref).abs().double() <= bound).all())
    for name, g, w in zip(("dq", "dk", "dv"), got[1:], want[1:]):
        err = (g.float() - w).abs().max().item()
        assert err <= 5e-3 * w.abs().max().item(), f"{name}: {err} vs max|grad| {w.abs().max()}"


def _explicit_bf16(q, k, v, keep):
    """K2's forward at the kernel's rounding points with an explicit mask,
    differentiated by hand as the kernel does."""
    qf, kf, vf = q.float(), k.float(), v.float()
    p = torch.softmax(torch.matmul(qf, kf.transpose(1, 2)) / 8.0, dim=-1)
    inv = torch.tensor(1 / (1 - RATE), dtype=torch.float32)
    pd = torch.where(keep, p * inv, torch.zeros(()))
    o = torch.matmul(pd.to(BF16).float(), vf).to(BF16)

    def backward(dy):
        dyf = dy.float()
        dv = torch.matmul(pd.to(BF16).float().transpose(1, 2), dyf).to(BF16)
        dp = torch.where(keep, torch.matmul(dyf, vf.transpose(1, 2)) * inv, torch.zeros(()))
        ds = (p * (dp - (dp * p).sum(-1, keepdim=True))).to(BF16).float()
        return ((torch.matmul(ds, kf) / 8.0).to(BF16),
                (torch.matmul(ds.transpose(1, 2), qf) / 8.0).to(BF16), dv)
    return o, backward


def test_bf16_plain_dropout_is_the_explicit_mask_formula():
    _, (q, k, v, dy) = _inputs(300, 70, 128, seed=4)
    seed = 123
    keep = keep_mask(seed, RATE, (1, 300, 70))
    got = _fwd_grads(lambda q, k, v: propagation_attention_train(
        q, k, v, temperature=8.0, dropout_rate=RATE, seed=seed), q, k, v, dy)
    o, backward = _explicit_bf16(q, k, v, keep)
    assert torch.equal(got[0], o)
    for g, w in zip(got[1:], backward(dy)):
        assert g.dtype == BF16 and torch.equal(g, w)


def test_bf16_dropout_plain_is_bitwise_the_formula():
    rng = np.random.RandomState(5)
    x = torch.from_numpy(rng.randn(2145, 512).astype(np.float32)).to(BF16).requires_grad_(True)
    seed = 77
    keep = keep_mask(seed, RATE, (2145, 512))
    scale = torch.tensor(1 / (1 - RATE), dtype=BF16)
    assert scale.item() == 1.109375
    y = dropout_plain(x, RATE, seed)
    zero = torch.zeros((), dtype=BF16)
    want = torch.where(keep, (x.detach().float() * scale.float()).to(BF16), zero)
    assert y.dtype == BF16 and torch.equal(y, want)
    dy = torch.from_numpy(rng.randn(2145, 512).astype(np.float32)).to(BF16)
    y.backward(dy)
    assert torch.equal(x.grad, torch.where(keep, (dy.float() * scale.float()).to(BF16), zero))


def test_bf16_launch_scale_is_rounded():
    threshold, inv_keep = _rate_args(RATE, BF16)
    assert inv_keep == 1.109375
    assert (threshold, np.float32(_rate_args(RATE)[1])) == (_rate_args(RATE)[0],
                                                            np.float32(1 / (1 - RATE)))
