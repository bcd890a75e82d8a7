"""The plain versions of the training kernels K2 (training attention) and K3
(dropout), and the dropout mask they share, on the CPU.

- K2's plain version against the JAX Pallas training kernel in interpret mode,
  dropout off: forward to rtol 1e-5 and dq, dk, dv to atol 2e-4 / rtol 1e-3,
  the tolerances of tests/test_pallas_attention.py:84-90.
- The mask (``ops/dropout_mask.py``, the twin of ``csrc/dropout_hash.cuh``):
  the int64 tensor hash equals a pure-Python one, is a function of
  (seed, index) alone whatever the tiling, differs across seeds, keeps within
  4 sigma of 1 - rate.
- With dropout on, K2's and K3's plain versions equal the explicit-mask
  formula (K2's gradients against JAX autodiff of that formula on the same
  mask, same tolerances), and their backward applies the same mask.
The CUDA kernels are held against these plain versions on the card by
``chip_smoke.py`` (phases 7 and 8).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tdnet_tpu.kernels import propagation_attention_train as jax_pat
from tdnet_tpu_torch.kernels.dropout import _rate_args, dropout, dropout_plain
from tdnet_tpu_torch.kernels.propagation_attention_train import (
    propagation_attention_train, propagation_attention_train_plain)
from tdnet_tpu_torch.nn import Ctx
from tdnet_tpu_torch.ops.dropout_mask import (dropout_hash, keep_mask, keep_threshold,
                                              mix32_int)

RATE = 0.1


def _interpret(monkeypatch):
    orig = jax_pat.pl.pallas_call
    monkeypatch.setattr(jax_pat.pl, "pallas_call",
                        lambda *a, **kw: orig(*a, **{**kw, "interpret": True}))


def _inputs(lq, lk, dv, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(1, lq, 64).astype(np.float32), rng.randn(1, lk, 64).astype(np.float32),
            rng.randn(1, lk, dv).astype(np.float32), rng.randn(1, lq, dv).astype(np.float32)]


def _torch_fwd_grads(fn, q, k, v, dy):
    t = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = fn(*t)
    out.backward(torch.from_numpy(dy))
    return [out.detach().numpy()] + [x.grad.numpy() for x in t]


def _assert_fwd_grads(got, want):
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-6)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g, w, atol=2e-4, rtol=1e-3)


@pytest.mark.parametrize("lq,lk,dv", [(1000, 130, 256), (513, 28, 128)])
def test_plain_matches_pallas_train_kernel(lq, lk, dv, monkeypatch):
    _interpret(monkeypatch)
    q, k, v, dy = _inputs(lq, lk, dv, seed=lq + lk)
    ker = lambda q, k, v: jax_pat.fused_propagation_attention_train(q, k, v, temperature=8.0)
    out, vjp = jax.vjp(ker, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = [np.asarray(out)] + [np.asarray(g) for g in vjp(jnp.asarray(dy))]
    got = _torch_fwd_grads(lambda q, k, v: propagation_attention_train(
        q, k, v, temperature=8.0), q, k, v, dy)
    _assert_fwd_grads(got, want)


def _mix32_py(x):
    x ^= x >> 16
    x = (x * 0x7FEB352D) & 0xFFFFFFFF
    x ^= x >> 15
    x = (x * 0x846CA68B) & 0xFFFFFFFF
    return x ^ (x >> 16)


def test_hash_matches_python_reference():
    idx = [0, 1, 2, 1000, 2**31 - 1, 2**31, 2**32 - 1, 2**32, 2**32 + 7, 3 * 2**33 + 5]
    for seed in (0, 1, 0xDEADBEEF, 2**32 - 1):
        got = dropout_hash(seed, torch.tensor(idx, dtype=torch.int64)).tolist()
        want = [_mix32_py((i & 0xFFFFFFFF) ^ _mix32_py((i >> 32) ^ _mix32_py(seed)))
                for i in idx]
        assert got == want
        assert mix32_int(seed) == _mix32_py(seed)


def test_mask_is_deterministic_and_differs_across_seeds():
    a = keep_mask(5, RATE, (3, 40, 50))
    assert torch.equal(a, keep_mask(5, RATE, (3, 40, 50)))
    assert (a != keep_mask(6, RATE, (3, 40, 50))).float().mean() > 0.1


@pytest.mark.parametrize("block", [1, 7, 64])
def test_mask_does_not_depend_on_tiling(block):
    """Element (b, i, j) of an [n, Lq, Lkv] mask, drawn block by block of q
    rows from its global index, is the element of the whole mask."""
    n, lq, lkv, seed = 2, 100, 37, 123
    whole = keep_mask(seed, RATE, (n, lq, lkv))
    thr = keep_threshold(RATE)
    for b in range(n):
        for i0 in range(0, lq, block):
            rows = torch.arange(i0, min(lq, i0 + block))
            idx = (b * lq + rows[:, None]) * lkv + torch.arange(lkv)[None]
            assert torch.equal(dropout_hash(seed, idx) < thr, whole[b, i0:i0 + block])


@pytest.mark.parametrize("seed", [0, 1, 2**31 + 11])
def test_keep_rate_within_4_sigma(seed):
    n = 1 << 20
    rate = keep_mask(seed, RATE, (n,)).double().mean().item()
    assert abs(rate - (1 - RATE)) < 4 * np.sqrt(RATE * (1 - RATE) / n)


def test_attention_plain_with_dropout_matches_explicit_mask_formula():
    """Forward and dq, dk, dv of K2's plain version with dropout on, against
    JAX autodiff of softmax -> where(keep, p / 0.9, 0) -> @ v on the same mask."""
    lq, lk, dv, seed = 300, 70, 128, 99
    q, k, v, dy = _inputs(lq, lk, dv, seed=4)
    keep = keep_mask(seed, RATE, (1, lq, lk)).numpy()
    assert 0.85 < keep.mean() < 0.95

    def ref(q, k, v):
        p = jax.nn.softmax(jnp.einsum("nqd,nkd->nqk", q, k) / 8.0, axis=-1)
        return jnp.einsum("nqk,nkv->nqv", jnp.where(keep, p / (1 - RATE), 0.0), v)

    out, vjp = jax.vjp(ref, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = [np.asarray(out)] + [np.asarray(g) for g in vjp(jnp.asarray(dy))]
    got = _torch_fwd_grads(lambda q, k, v: propagation_attention_train(
        q, k, v, temperature=8.0, dropout_rate=RATE, seed=seed), q, k, v, dy)
    _assert_fwd_grads(got, want)
    plain = propagation_attention_train_plain(*[torch.from_numpy(a) for a in (q, k, v)],
                                              temperature=8.0, dropout_rate=RATE, seed=seed)
    np.testing.assert_array_equal(plain.numpy(), got[0])


def test_attention_backward_applies_the_forward_mask():
    """v = identity makes the forward return the dropped probability matrix;
    dv = pd^T dy must then vanish exactly where the forward dropped."""
    lq, lk, seed = 64, 128, 7
    rng = np.random.RandomState(8)
    q = torch.from_numpy(rng.randn(1, lq, 64).astype(np.float32))
    k = torch.from_numpy(rng.randn(1, lk, 64).astype(np.float32))
    v = torch.eye(lk)[None].requires_grad_(True)
    pd = propagation_attention_train(q, k, v, temperature=8.0, dropout_rate=RATE, seed=seed)
    assert torch.equal(pd[0] != 0, keep_mask(seed, RATE, (1, lq, lk))[0])
    dy = torch.zeros(1, lq, lk)
    dy[0, 5] = 1.0   # dv[j] = pd[5, j] * e_j
    pd.backward(dy)
    np.testing.assert_array_equal(torch.diagonal(v.grad[0]).numpy(), pd[0, 5].detach().numpy())


def test_dropout_plain_formula_and_backward():
    rng = np.random.RandomState(9)
    x = torch.from_numpy(rng.randn(700, 96).astype(np.float32)).requires_grad_(True)
    seed = 31
    keep = keep_mask(seed, RATE, (700, 96))
    y = dropout(x, RATE, seed)
    inv = torch.tensor(1 / (1 - RATE), dtype=torch.float32)
    assert torch.equal(y, torch.where(keep, x * inv, torch.zeros(())))
    assert torch.equal(y, dropout_plain(x, RATE, seed))
    dy = torch.from_numpy(rng.randn(700, 96).astype(np.float32))
    y.backward(dy)
    assert torch.equal(x.grad, torch.where(keep, dy * inv, torch.zeros(())))


@pytest.mark.parametrize("rate", [0.1, 0.25, 0.5])
def test_kernel_rate_args_are_the_plain_versions(rate):
    """The threshold and scale the kernel is launched with, cached a rate,
    are the mask's threshold and the scale of ``dropout_plain``."""
    threshold, inv_keep = _rate_args(rate)
    assert threshold == keep_threshold(rate)
    assert np.float32(inv_keep) == np.float32(1.0 / (1.0 - rate))
    assert _rate_args(rate) is _rate_args(rate)


def test_ctx_dropout_routes_and_switches_off():
    x = torch.ones(512, 64)
    g = torch.Generator().manual_seed(0)
    on = Ctx(train=True, generator=g)
    y = on.dropout(x, RATE)
    assert abs((y != 0).float().mean().item() - 0.9) < 0.02
    torch.testing.assert_close(y[y != 0], torch.full_like(y[y != 0], 1 / 0.9))
    assert Ctx(train=False).dropout(x, RATE) is x
    assert Ctx(train=True, use_dropout=False).dropout(x, RATE) is x
    # the seed comes from the generator: the same state gives the same mask
    y2 = Ctx(train=True, generator=torch.Generator().manual_seed(0)).dropout(x, RATE)
    assert torch.equal(y, y2)


def test_ctx_dropout2d_drops_whole_planes():
    x = torch.randn(4, 256, 5, 6, requires_grad=True)
    ctx = Ctx(train=True, generator=torch.Generator().manual_seed(1))
    y = ctx.dropout2d(x, RATE)
    dropped = (y == 0).all(dim=(2, 3))
    kept = (y != 0).all(dim=(2, 3))
    assert bool((dropped | kept).all())
    assert 0.8 < kept.float().mean().item() < 0.97
    torch.testing.assert_close(y[kept], x[kept] / (1 - RATE))
    y.sum().backward()
    torch.testing.assert_close(x.grad, kept[:, :, None, None].float().expand_as(x) / (1 - RATE))
    assert Ctx(train=True, use_dropout=False).dropout2d(x, RATE) is x
