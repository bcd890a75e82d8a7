"""The port's network modules against the JAX package's, f32 on the CPU.

Weights come from the JAX initializers through ``utils/from_jax.py``; inputs
from numpy. The JAX side runs eval mode (``Ctx(train=False)``) on NHWC, the
port on NCHW; tokens are [n, H*W, d] on both.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tdnet_tpu import nn as jnn
from tdnet_tpu.nn.module import Ctx
from tdnet_tpu.nn.resnet import ResNetConfig as JaxResNetConfig
from tdnet_tpu_torch import nn as tnn
from tdnet_tpu_torch.nn.resnet import ResNetConfig, _block_plan
from tdnet_tpu_torch.utils.from_jax import convert_tree

CTX = Ctx(train=False)
ATOL, RTOL = 2e-5, 2e-5


def nchw(x_nhwc) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x_nhwc).transpose(0, 3, 1, 2)))


def nhwc(x: torch.Tensor) -> np.ndarray:
    return x.detach().permute(0, 2, 3, 1).numpy()


def _randomize_bn(tree, rng):
    """Non-trivial BN statistics, so that the eval affine is exercised."""
    if isinstance(tree, dict):
        if set(tree) == {"scale", "bias", "mean", "var"}:
            c = tree["scale"].shape
            return dict(scale=jnp.asarray(rng.rand(*c) + 0.5, jnp.float32),
                        bias=jnp.asarray(rng.randn(*c) * 0.1, jnp.float32),
                        mean=jnp.asarray(rng.randn(*c) * 0.1, jnp.float32),
                        var=jnp.asarray(rng.rand(*c) + 0.5, jnp.float32))
        return {k: _randomize_bn(v, rng) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_randomize_bn(v, rng) for v in tree]
    return tree


def _load(module, tree):
    module.load_state_dict(convert_tree(tree))
    return module.eval()


@pytest.mark.parametrize("name", ["resnet10", "bottleneck_deep_base"])
def test_resnet(name):
    if name == "resnet10":
        jcfg, cfg = JaxResNetConfig("basic", (1, 1, 1, 1)), ResNetConfig("basic", (1, 1, 1, 1))
    else:
        jcfg = JaxResNetConfig("bottleneck", (1, 1, 1, 1), deep_base=True)
        cfg = ResNetConfig("bottleneck", (1, 1, 1, 1), deep_base=True)
    rng = np.random.RandomState(0)
    params = _randomize_bn(jnn.init_resnet(jax.random.PRNGKey(0), jcfg), rng)
    x = rng.randn(1, 49, 97, 3).astype(np.float32)
    c3, c4 = jax.jit(lambda p, x: jnn.apply_resnet(p, x, jcfg, CTX)[:2])(
        params, jnp.asarray(x))
    net = _load(tnn.ResNet(cfg), params)
    with torch.no_grad():
        g3, g4 = net(nchw(x))
    np.testing.assert_allclose(nhwc(g3), np.asarray(c3), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(nhwc(g4), np.asarray(c4), atol=ATOL, rtol=RTOL)


def test_block_plan_matches_jax():
    from tdnet_tpu.nn.resnet import BACKBONES as JB, _block_plan as jplan
    for name, make in tnn.BACKBONES.items():
        assert _block_plan(make()) == jplan(JB[name]())


@pytest.mark.parametrize("pid", [0, 1])
def test_grouped_pyramid_pooling(pid):
    rng = np.random.RandomState(1)
    params = _randomize_bn(jnn.init_pyramid_pooling(jax.random.PRNGKey(1), 512), rng)
    x = rng.rand(1, 13, 25, 512).astype(np.float32)
    want = jax.jit(lambda p, x: jnn.apply_pyramid_pooling(p, x, CTX, path_num=2, pid=pid)[0])(
        params, jnp.asarray(x))
    psp = _load(tnn.PyramidPooling(512), params)
    with torch.no_grad():
        got = tnn.apply_pyramid_pooling(psp, nchw(x), groups=2, pid=pid)
    assert got.shape[1] == 512
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=ATOL, rtol=RTOL)


@pytest.fixture(scope="module")
def encoding():
    rng = np.random.RandomState(2)
    params = _randomize_bn(jnn.init_encoding(jax.random.PRNGKey(2), 512, 64, 512), rng)
    z = rng.randn(1, 13, 25, 512).astype(np.float32)
    return params, z, _load(tnn.Encoding(512, 64, 512), params)


def test_encoding_full(encoding):
    params, z, enc = encoding
    q, v, _ = jnn.apply_encoding_full(params, jnp.asarray(z), CTX)
    with torch.no_grad():
        tq, tv = tnn.apply_encoding_full(enc, nchw(z))
    assert tq.shape == (1, 13 * 25, 64) and tq.is_contiguous()
    np.testing.assert_allclose(tq.numpy(), np.asarray(q), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(nhwc(tv), np.asarray(v), atol=ATOL, rtol=RTOL)


def test_encoding_cached(encoding):
    params, z, enc = encoding
    want = jnn.apply_encoding_cached(params, jnp.asarray(z), CTX, kv_stride=4,
                                     pool_before_proj=True)[:3]
    with torch.no_grad():
        got = tnn.apply_encoding_cached(enc, nchw(z), kv_stride=4)
    for g, w in zip(got, want):
        assert g.shape == w.shape == (1, 4 * 7, g.shape[-1])
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("in_ch,chn_down", [(512, 4), (512, 2)])
def test_fcn_head(in_ch, chn_down):
    rng = np.random.RandomState(3)
    params = _randomize_bn(jnn.init_fcn_head(jax.random.PRNGKey(3), in_ch, 19,
                                             chn_down=chn_down), rng)
    x = rng.randn(1, 13, 25, in_ch).astype(np.float32)
    want, _ = jnn.apply_fcn_head(params, jnp.asarray(x), CTX)
    head = _load(tnn.FCNHead(in_ch, 19, chn_down=chn_down), params)
    with torch.no_grad():
        got = tnn.apply_fcn_head(head, nchw(x))
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("last", [False, True], ids=["tokens", "last_hop_map"])
def test_one_hop(last):
    rng = np.random.RandomState(4)
    params = jnn.init_attention(jax.random.PRNGKey(4), 512)
    params = {"fc": {"w": params["fc"]["w"],
                     "b": jnp.asarray(rng.randn(512) * 0.1, jnp.float32)}}
    hw = (13, 25)
    k = rng.randn(1, 28, 64).astype(np.float32)
    v = rng.randn(1, 28, 512).astype(np.float32)
    q = rng.randn(1, hw[0] * hw[1], 64).astype(np.float32)
    want = jnn.apply_attention(params, jnp.asarray(k), jnp.asarray(v), jnp.asarray(q), CTX,
                               d_k=64, fea_hw=hw if last else None)
    atn = tnn.Attention(512)
    atn.load_state_dict({"w": torch.from_numpy(np.array(params["fc"]["w"][0, 0])),
                         "b": torch.from_numpy(np.array(params["fc"]["b"]))})
    with torch.no_grad():
        got = tnn.apply_attention(atn, torch.from_numpy(k), torch.from_numpy(v),
                                  torch.from_numpy(q), d_k=64, fea_hw=hw if last else None)
    got = nhwc(got) if last else got.numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=5e-4, rtol=1e-3)
