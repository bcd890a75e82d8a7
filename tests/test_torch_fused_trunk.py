"""The port's fused grouped-PSP + QKV encoding (``nn/fused_trunk.py``) and
the fused stream against the JAX package, on the CPU.

Same weights (JAX ``init_tdnet``, every BatchNorm given non-trivial
statistics, through ``utils/from_jax.py``) and the same numpy inputs go
through both. Two geometries with a ResNet-10 trunk (C = 512): TD4 (4 paths,
d_v = C) and TD2 (2 paths, d_v = C/4), both with the kv_stride of the stream.

Tolerances:
- f32: atol 2e-5, rtol 2e-5, the repo's class for the stream
  (``tests/test_torch_stream.py``); the two sides sum in another order;
- bf16: two bf16 ulps of the output's scale (2^-7 x max|JAX output|): both
  sides round at the same points (each upsampled piece rounded before its
  add, BN's affine in f32), and a product whose f32 sum lies near a rounding
  boundary rounds either way on the two sides. The share of elements off the
  JAX bits is printed and held below 5% (0-2.2% seen: an element one ulp
  off feeds the next conv of q and k).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tdnet_tpu.models.tdnet import TDNetConfig as JaxConfig
from tdnet_tpu.models.tdnet import init_tdnet as jax_init_tdnet
from tdnet_tpu.models.tdnet import select_path
from tdnet_tpu.nn.fused_trunk import fused_psp_encoding as jax_fused
from tdnet_tpu.nn.module import Ctx as JaxCtx
from tdnet_tpu.stream.runtime import Streamer as JaxStreamer
from tdnet_tpu_torch.models import TDNetConfig
from tdnet_tpu_torch.nn import apply_encoding_cached, apply_encoding_full, apply_pyramid_pooling
from tdnet_tpu_torch.nn.fused_trunk import fused_psp_encoding
from tdnet_tpu_torch.stream.runtime import Streamer
from tdnet_tpu_torch.utils.from_jax import tdnet_from_jax
from tests.test_torch_modules import _randomize_bn
from torch_threads import few_threads  # noqa: F401  (the file runs on two threads)

IN_SIZE = (65, 129)
FEAT = (9, 17)


@functools.cache
def _weights(p: int):
    """JAX config, params (BN statistics randomized) and the port's config of
    a P-path net, built once for the file."""
    jcfg = JaxConfig(nclass=19, backbone="resnet10", path_num=p, in_size=IN_SIZE,
                     kv_stride=4, aux=False)
    params = _randomize_bn(jax_init_tdnet(jax.random.PRNGKey(p), jcfg),
                           np.random.RandomState(p))
    cfg = TDNetConfig(nclass=19, backbone="resnet10", path_num=p, in_size=IN_SIZE, kv_stride=4)
    return jcfg, params, cfg


def _nets(p: int, seed: int):
    return (*_weights(p), np.random.RandomState(seed))


def _jax_outputs(params, c4, pid, dtype):
    pp = select_path(params["paths"], pid)
    if dtype == jnp.bfloat16:
        pp = jax.tree.map(lambda a: a.astype(jnp.bfloat16), pp)
    out = jax_fused(pp["psp"], pp["enc"], jnp.asarray(c4, dtype), JaxCtx(train=False),
                    pid=pid, groups=2, kv_stride=4)
    q, v, qc, kc, vc = (np.asarray(o.astype(jnp.float32)) for o in out)
    return [q, v.transpose(0, 3, 1, 2), qc, kc, vc]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("p", [4, 2], ids=["TD4", "TD2"])
def test_fused_psp_encoding_matches_jax(p, dtype):
    jcfg, params, cfg, rng = _nets(p, seed=p)
    model = tdnet_from_jax(params, cfg).eval()
    tdt = getattr(torch, dtype)
    model.to(tdt)
    c4 = np.abs(rng.randn(1, *FEAT, 512)).astype(np.float32)
    for pid in range(2):
        want = _jax_outputs(params, c4, pid, getattr(jnp, dtype))
        sub = model.paths[pid]
        x = torch.from_numpy(c4).permute(0, 3, 1, 2).contiguous().to(tdt)
        with torch.no_grad():
            got = fused_psp_encoding(sub.psp, sub.enc, x, pid=pid, groups=2, kv_stride=4)
        names = ("q tokens", "v map", "q_c", "k_c", "v_c")
        for name, g, w in zip(names, got, want):
            g = g.float().numpy()
            assert g.shape == w.shape, (name, g.shape, w.shape)
            if dtype == "float32":
                np.testing.assert_allclose(g, w, atol=2e-5, rtol=2e-5,
                                           err_msg=f"{name}, pid {pid}")
            else:
                scale = np.abs(w).max()
                np.testing.assert_allclose(g, w, atol=2.0 ** -7 * scale, rtol=0,
                                           err_msg=f"{name}, pid {pid}")
                off = float(np.mean(g != w))
                print(f"{name} pid {pid}: {off:.4%} of elements off the JAX bits")
                assert off < 0.05, (name, off)


@pytest.mark.parametrize("p", [4, 2], ids=["TD4", "TD2"])
def test_fused_equals_pyramid_dataflow(p):
    """The fused encoding equals the port's own plain dataflow (z built, the
    projections over it, subsampled before them) to f32 rounding."""
    _, params, cfg, rng = _nets(p, seed=10 + p)
    sub = tdnet_from_jax(params, cfg).eval().paths[1]
    x = torch.from_numpy(np.abs(rng.randn(1, 512, *FEAT)).astype(np.float32))
    with torch.no_grad():
        got = fused_psp_encoding(sub.psp, sub.enc, x, pid=1, groups=2, kv_stride=4)
        z = apply_pyramid_pooling(sub.psp, x, groups=2, pid=1)
        q, v = apply_encoding_full(sub.enc, z)
        qc, kc, vc = apply_encoding_cached(sub.enc, z, kv_stride=4)
    for g, w in zip(got, (q, v, qc, kc, vc)):
        torch.testing.assert_close(g, w, atol=2e-5, rtol=2e-5)


@pytest.fixture(scope="module")
def fused_streams():
    """Per-frame logits of JAX's fused Streamer and of the port's (fused by
    default) and unfused Streamers over 2P+1 frames of TD4, cold and warm,
    with every BatchNorm's statistics randomized so that both runtimes' folds
    matter (``tests/test_torch_stream.py`` runs both geometries at init's
    statistics)."""
    p = 4
    jcfg, params, cfg, rng = _nets(p, seed=20 + p)
    frames = [rng.randn(1, *IN_SIZE, 3).astype(np.float32) * 0.5 for _ in range(2 * p + 1)]
    jax_fused_stream = JaxStreamer(params, jcfg)
    port = Streamer(tdnet_from_jax(params, cfg))
    port_plain = Streamer(tdnet_from_jax(params, cfg), fused_trunk=False)
    out = {"jax": [], "port": [], "plain": []}
    for f in frames:
        out["jax"].append(np.asarray(jax_fused_stream.step(jnp.asarray(f), timed=False)[0]))
        out["port"].append(port.step(torch.from_numpy(f), timed=False)[0].numpy())
        out["plain"].append(port_plain.step(torch.from_numpy(f), timed=False)[0].numpy())
    assert port.ctx.fused_trunk and not port_plain.ctx.fused_trunk
    return out


def test_fused_stream_matches_jax_fused_streamer(fused_streams):
    for i, (got, want) in enumerate(zip(fused_streams["port"], fused_streams["jax"])):
        assert got.shape == want.shape == (1, *IN_SIZE, 19)
        np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5, err_msg=f"frame {i}")


def test_unfused_stream_is_the_previous_path(fused_streams):
    """``fused_trunk=False`` builds z as before; the two forms agree to the
    order of f32 sums."""
    for i, (got, want) in enumerate(zip(fused_streams["plain"], fused_streams["port"])):
        np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5, err_msg=f"frame {i}")


def test_fused_path_is_eval_only():
    """Training and an unsubsampled cache take the plain dataflow, as JAX's
    ``stream_step`` decides (``tdnet_tpu/models/tdnet.py:209-210``)."""
    from tdnet_tpu_torch.models import init_cache, stream_step
    from tdnet_tpu_torch.models.tdnet import init_tdnet
    from tdnet_tpu_torch.nn import Ctx
    from tdnet_tpu_torch.nn import fused_trunk
    cfg = TDNetConfig(nclass=19, backbone="resnet10", path_num=2, in_size=IN_SIZE, kv_stride=4)
    model = init_tdnet(cfg, torch.Generator().manual_seed(0)).eval()
    calls = []
    real = fused_trunk.fused_psp_encoding

    def spy(*a, **kw):
        calls.append(1)
        return real(*a, **kw)
    import tdnet_tpu_torch.models.tdnet as tdm
    img = torch.randn(1, *IN_SIZE, 3, generator=torch.Generator().manual_seed(1))
    try:
        tdm.fused_psp_encoding = spy
        with torch.no_grad():
            for ctx, c, expect in ((Ctx(fused_trunk=True), cfg, 1),
                                   (Ctx(fused_trunk=False), cfg, 0),
                                   (Ctx(fused_trunk=True),
                                    TDNetConfig(nclass=19, backbone="resnet10", path_num=2,
                                                in_size=IN_SIZE, kv_stride=4,
                                                pool_before_proj=False), 0)):
                calls.clear()
                stream_step(model.paths[0], model.atn[0], init_cache(c), img, c, 0, ctx)
                assert len(calls) == expect, (ctx, c.pool_before_proj)
    finally:
        tdm.fused_psp_encoding = real


def test_streamer_lays_out_trunk_weights_once():
    """The fused ``Streamer`` stacks the three first-layer weights once, at
    construction; the encoding on those weights equals the one that lays them
    out for its call, bitwise, and a mode switch drops them."""
    from tdnet_tpu_torch.models.tdnet import init_tdnet
    from tdnet_tpu_torch.nn.encoding import trunk_weights
    cfg = TDNetConfig(nclass=19, backbone="resnet10", path_num=2, in_size=IN_SIZE, kv_stride=4)
    port = Streamer(init_tdnet(cfg, torch.Generator().manual_seed(0)))
    plain = Streamer(init_tdnet(cfg, torch.Generator().manual_seed(0)), fused_trunk=False)
    assert all(sub.enc.trunk is not None for sub in port.model.paths)
    assert all(sub.enc.trunk is None for sub in plain.model.paths)
    sub = port.model.paths[1]
    c4 = torch.randn(1, 512, 9, 17, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        folded = fused_psp_encoding(sub.psp, sub.enc, c4, pid=1, groups=2, kv_stride=4)
        for a, b in zip(sub.enc.trunk, trunk_weights(sub.enc)):
            assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))
        sub.enc.trunk = None
        per_call = fused_psp_encoding(sub.psp, sub.enc, c4, pid=1, groups=2, kv_stride=4)
    for a, b in zip(folded, per_call):
        assert torch.equal(a, b)
    port.model.train()
    assert all(s.enc.trunk is None for s in port.model.paths)
