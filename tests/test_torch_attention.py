"""The port's propagation attention (plain version of the CUDA kernel) against
the JAX Pallas kernel in interpret mode and against the JAX plain spec.

f32 on the CPU; inputs from numpy, made as tests/test_pallas_attention.py
makes them. Tolerances are the JAX tests': atol 2e-5 / rtol 1e-4 without the
fc, 5e-4 / 1e-3 with it. The CUDA kernel itself is checked against the
plain version on the card by ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tdnet_tpu.kernels import propagation_attention as jax_pa
from tdnet_tpu.ops.attention import scaled_dot_attention as jax_sdpa
from tdnet_tpu_torch.kernels.propagation_attention import (fused_propagation_attention,
                                                           propagation_attention_plain)
from tdnet_tpu_torch.ops.attention import scaled_dot_attention

SHAPES = [(1000, 130, 256), (513, 28, 128), (700, 130, 512)]


def _inputs(lq, lk, dv, seed):
    rng = np.random.RandomState(seed)
    return dict(q=rng.randn(1, lq, 64).astype(np.float32),
                k=rng.randn(1, lk, 64).astype(np.float32),
                v=rng.randn(1, lk, dv).astype(np.float32),
                w=(rng.randn(dv, dv) * 0.05).astype(np.float32),
                b=(rng.randn(dv) * 0.1).astype(np.float32))


def _interpret(monkeypatch):
    orig = jax_pa.pl.pallas_call
    monkeypatch.setattr(jax_pa.pl, "pallas_call",
                        lambda *a, **kw: orig(*a, **{**kw, "interpret": True}))


@pytest.mark.parametrize("fc", [False, True], ids=["attn", "attn_fc"])
@pytest.mark.parametrize("lq,lk,dv", SHAPES)
def test_plain_matches_pallas_interpret(lq, lk, dv, fc, monkeypatch):
    _interpret(monkeypatch)
    x = _inputs(lq, lk, dv, seed=lq + lk)
    j = {n: jnp.asarray(a) for n, a in x.items()}
    t = {n: torch.from_numpy(a) for n, a in x.items()}
    jkw = dict(fc_w=j["w"], fc_b=j["b"]) if fc else {}
    tkw = dict(fc_w=t["w"], fc_b=t["b"]) if fc else {}
    want = np.asarray(jax_pa.fused_propagation_attention(j["q"], j["k"], j["v"],
                                                         temperature=8.0, **jkw))
    got = fused_propagation_attention(t["q"], t["k"], t["v"], temperature=8.0, **tkw)
    atol, rtol = (5e-4, 1e-3) if fc else (2e-5, 1e-4)
    np.testing.assert_allclose(got.numpy(), want, atol=atol, rtol=rtol)


@pytest.mark.parametrize("lq,lk,dv", SHAPES)
def test_plain_matches_jax_spec(lq, lk, dv):
    x = _inputs(lq, lk, dv, seed=7)
    j = {n: jnp.asarray(a) for n, a in x.items()}
    t = {n: torch.from_numpy(a) for n, a in x.items()}
    o = jax_sdpa(j["q"], j["k"], j["v"], temperature=8.0)
    np.testing.assert_allclose(
        scaled_dot_attention(t["q"], t["k"], t["v"], temperature=8.0).numpy(),
        np.asarray(o), atol=2e-5, rtol=1e-4)
    want = np.asarray(jnp.einsum("nld,de->nle", o, j["w"]) + j["b"])
    got = propagation_attention_plain(t["q"], t["k"], t["v"], temperature=8.0,
                                      fc_w=t["w"], fc_b=t["b"])
    np.testing.assert_allclose(got.numpy(), want, atol=5e-4, rtol=1e-3)


def test_plain_bf16_rounding_points():
    """bf16: p and the PV result round to v's dtype before the fc, as in the
    TPU kernel; the result is bf16."""
    x = _inputs(300, 70, 128, seed=3)
    t = {n: torch.from_numpy(a).to(torch.bfloat16) for n, a in x.items()}
    got = propagation_attention_plain(t["q"], t["k"], t["v"], temperature=8.0,
                                      fc_w=t["w"], fc_b=t["b"])
    assert got.dtype == torch.bfloat16
    f = {n: a.float() for n, a in t.items()}
    p = torch.softmax(f["q"] @ f["k"].transpose(1, 2) / 8.0, -1).to(torch.bfloat16).float()
    o = (p @ f["v"]).to(torch.bfloat16).float()
    want = (o @ f["w"] + f["b"]).to(torch.bfloat16)
    torch.testing.assert_close(got, want, atol=0, rtol=0)


def test_wrapper_launch_count_untouched_on_cpu():
    x = _inputs(64, 16, 128, seed=9)
    t = {n: torch.from_numpy(a) for n, a in x.items()}
    before = fused_propagation_attention.launches
    fused_propagation_attention(t["q"], t["k"], t["v"], temperature=8.0)
    assert fused_propagation_attention.launches == before


@pytest.mark.parametrize("case", ["dk", "dv", "dtype", "contig", "fc_shape", "fc_pair"])
def test_wrapper_rejects_what_the_kernel_does_not_take(case):
    from tdnet_tpu_torch.kernels.propagation_attention import _check
    t = {n: torch.from_numpy(a) for n, a in _inputs(64, 16, 128, seed=2).items()}
    q, k, v, w, b = t["q"], t["k"], t["v"], t["w"], t["b"]
    if case == "dk":
        q, k = q[..., :32].contiguous(), k[..., :32].contiguous()
    elif case == "dv":
        v = v[..., :96].contiguous()
        w, b = w[:96, :96].contiguous(), b[:96]
    elif case == "dtype":
        q = q.double()
    elif case == "contig":
        v = torch.from_numpy(np.asfortranarray(v.numpy()[0]))[None]
    elif case == "fc_shape":
        w = w[:, :64].contiguous()
    else:
        b = None
    with pytest.raises(ValueError):
        _check(q, k, v, w, b)
    _check(t["q"], t["k"], t["v"], t["w"], t["b"])
