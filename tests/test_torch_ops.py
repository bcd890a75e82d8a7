"""The port's plain ops against the JAX package's, f32 on the CPU, atol 1e-5.

Inputs come from numpy; the JAX side takes NHWC / HWIO, the port NCHW / OIHW.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tdnet_tpu import ops as jops
from tdnet_tpu_torch import ops

ATOL = 1e-5


def nchw(x_nhwc: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x_nhwc.transpose(0, 3, 1, 2)))


def nhwc(x: torch.Tensor) -> np.ndarray:
    return x.detach().permute(0, 2, 3, 1).numpy()


def _bn_params(rng, c):
    return dict(scale=rng.rand(c).astype(np.float32) + 0.5,
                bias=rng.randn(c).astype(np.float32) * 0.1,
                mean=rng.randn(c).astype(np.float32) * 0.1,
                var=rng.rand(c).astype(np.float32) + 0.5)


@pytest.mark.parametrize("stride,padding,dilation,bias", [
    (1, 0, 1, True), (2, 3, 1, False), (1, 4, 4, False), (2, 1, 1, True)])
def test_conv2d(stride, padding, dilation, bias):
    rng = np.random.RandomState(0)
    k = 1 if padding == 0 else (7 if padding == 3 else 3)
    x = rng.randn(2, 19, 23, 8).astype(np.float32)
    w = rng.randn(k, k, 8, 16).astype(np.float32) * 0.1
    b = rng.randn(16).astype(np.float32) if bias else None
    want = jops.conv2d(jnp.asarray(x), jnp.asarray(w), None if b is None else jnp.asarray(b),
                       stride=stride, padding=padding, dilation=dilation)
    got = ops.conv2d(nchw(x), torch.from_numpy(w.transpose(3, 2, 0, 1).copy()),
                     None if b is None else torch.from_numpy(b),
                     stride=stride, padding=padding, dilation=dilation)
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=ATOL, rtol=1e-5)


@pytest.mark.parametrize("activation", [None, "relu", "leaky_relu"])
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("folded", [False, True])
def test_batch_norm_eval(activation, residual, folded):
    rng = np.random.RandomState(1)
    x = rng.randn(2, 9, 11, 16).astype(np.float32)
    r = rng.randn(2, 9, 11, 16).astype(np.float32) if residual else None
    p = _bn_params(rng, 16)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    if folded:
        jp = jops.fold_bn_eval({"bn": jp})["bn"]
    want = jops.batch_norm(jnp.asarray(x), jp, train=False, activation=activation,
                           residual=None if r is None else jnp.asarray(r))
    bn = ops.BatchNorm(16).eval()   # a new module trains; this is the eval form
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(p["scale"]))
        bn.bias.copy_(torch.from_numpy(p["bias"]))
        bn.running_mean.copy_(torch.from_numpy(p["mean"]))
        bn.running_var.copy_(torch.from_numpy(p["var"]))
    if folded:
        bn.fold()
    got = bn(nchw(x), activation, residual=None if r is None else nchw(r))
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=ATOL, rtol=1e-5)


def test_fold_bn_eval():
    rng = np.random.RandomState(2)
    p = _bn_params(rng, 32)
    want = jops.fold_bn_eval({k: jnp.asarray(v) for k, v in p.items()})
    fscale, fbias = ops.fold_bn_eval(*(torch.from_numpy(p[k])
                                       for k in ("scale", "bias", "mean", "var")))
    np.testing.assert_allclose(fscale.numpy(), np.asarray(want["fscale"]), atol=ATOL, rtol=1e-6)
    np.testing.assert_allclose(fbias.numpy(), np.asarray(want["fbias"]), atol=ATOL, rtol=1e-6)


def test_layer_norm_2d():
    rng = np.random.RandomState(3)
    x = rng.randn(2, 13, 25, 8).astype(np.float32) * 2 + 1
    scale = rng.rand(13, 25).astype(np.float32) + 0.5
    bias = rng.randn(13, 25).astype(np.float32)
    want = jops.layer_norm_2d(jnp.asarray(x), {"scale": jnp.asarray(scale),
                                               "bias": jnp.asarray(bias)})
    ln = ops.LayerNorm2d(13, 25)
    with torch.no_grad():
        ln.weight.copy_(torch.from_numpy(scale))
        ln.bias.copy_(torch.from_numpy(bias))
    np.testing.assert_allclose(nhwc(ln(nchw(x))), np.asarray(want), atol=ATOL, rtol=1e-5)


@pytest.mark.parametrize("src,dst", [((13, 25), (97, 193)),    # integer ratio (x8)
                                     ((6, 6), (13, 25)),       # pyramid bins, not integer
                                     ((1, 1), (13, 25)),
                                     ((13, 25), (65, 129))])
def test_resize_bilinear_align_corners(src, dst):
    x = np.random.RandomState(4).randn(1, *src, 5).astype(np.float32)
    want = jops.resize_bilinear(jnp.asarray(x), dst)
    got = ops.resize_bilinear(nchw(x), dst)
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=ATOL, rtol=1e-5)


@pytest.mark.parametrize("hw", [(13, 25), (97, 193), (7, 7)])
def test_adaptive_avg_pool_multi(hw):
    x = np.random.RandomState(5).randn(2, *hw, 6).astype(np.float32)
    sizes = (1, 2, 3, 6)
    want = jops.adaptive_avg_pool_multi(jnp.asarray(x), sizes)
    got = ops.adaptive_avg_pool_multi(nchw(x), sizes)
    for g, w in zip(got, want):
        np.testing.assert_allclose(nhwc(g), np.asarray(w), atol=ATOL, rtol=1e-5)


@pytest.mark.parametrize("stride", [1, 3, 4])
def test_grid_subsample(stride):
    x = np.random.RandomState(6).randn(1, 13, 25, 4).astype(np.float32)
    want = np.asarray(jops.grid_subsample(jnp.asarray(x), stride))
    got = nhwc(ops.grid_subsample(nchw(x), stride))
    assert got.shape == want.shape   # ceil(H/s) x ceil(W/s)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("hw", [(49, 97), (50, 96)])
def test_max_pool_stem(hw):
    x = np.random.RandomState(7).randn(1, *hw, 8).astype(np.float32)
    want = np.asarray(jops.max_pool(jnp.asarray(x), 3, 2, 1))
    np.testing.assert_array_equal(nhwc(ops.max_pool(nchw(x), 3, 2, 1)), want)


@pytest.mark.parametrize("init", ["kaiming", "msra_out"])
def test_conv_init_distributions(init):
    """The port draws from the reference's distributions (its own generator)."""
    conv = ops.Conv2d(64, 128, 3, bias=True)
    gen = torch.Generator().manual_seed(0)
    if init == "kaiming":
        ops.init_conv_kaiming(conv, gen)
        std = 1.0 / np.sqrt(3 * 3 * 64)
    else:
        ops.init_conv_msra_out(conv, gen)
        std = np.sqrt(2.0 / (3 * 3 * 128))
    w = conv.weight.detach().numpy()
    assert abs(w.std() / std - 1) < 0.02 and abs(w.mean()) < 0.05 * std
    assert not conv.bias.detach().any()
