"""The dilated-conv kernel's function (K5) against the JAX package, f32 on the CPU.

On the CPU ``conv2d_dil`` runs the same ``torch.autograd.Function`` as on the
card with the plain forward in both of its places (the forward, and the
dgrad as a conv of dy with the flipped, IO-swapped kernel), and the per-tap
matmul weight gradient; the JAX side runs ``conv2d_pallas_dil`` and its VJP
with the Pallas kernel in interpret mode. The kernel itself is checked
against the plain version on the card (``chip_smoke.py`` phase 13).

Tolerances: an output, dx or dW entry is an f32 sum of 9 x 16 products
(dW: of 13 x 21 pixels) taken in another order on each side, about 1e-6 of
its terms' size: atol 1e-5 / rtol 1e-5 with inputs of order 1. The train-mode
ResNet's c4 to 1e-4, and each parameter gradient to 1e-3 x max|gradient| of
that tensor: through the train BatchNorms the gradients are sums that
cancel, and the port's own cuDNN path differs from its K5 path by up to
about 1e-4 of that scale at this size.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from tdnet_tpu import nn as jnn
from tdnet_tpu.kernels import dilated_conv as jdc
from tdnet_tpu.nn.module import Ctx as JaxCtx
from tdnet_tpu.nn.resnet import ResNetConfig as JaxResNetConfig
from tdnet_tpu.ops.conv import _tap_wgrad
from tdnet_tpu_torch.kernels.dilated_conv import conv2d_dil, dilated_conv_plain
from tdnet_tpu_torch.nn import Ctx, ResNet
from tdnet_tpu_torch.nn import resnet as tresnet
from tdnet_tpu_torch.nn.resnet import ResNetConfig
from tdnet_tpu_torch.ops.conv import tap_wgrad
from tdnet_tpu_torch.utils.from_jax import convert_tree
from tests.test_torch_modules import _randomize_bn, nchw, nhwc

CASES = [(4, 4), (8, 8), (4, 2)]   # (dilation, padding); the recipe's convs have p = d


@pytest.fixture
def interpret(monkeypatch):
    orig = jdc.pl.pallas_call
    monkeypatch.setattr(jdc.pl, "pallas_call",
                        lambda *a, **kw: orig(*a, **{**kw, "interpret": True}))


def _conv_data(seed, ci=16, co=32, hw=(13, 21)):
    rng = np.random.RandomState(seed)
    x = rng.randn(1, *hw, ci).astype(np.float32)
    w = (rng.randn(3, 3, ci, co) / np.sqrt(9 * ci)).astype(np.float32)
    return rng, x, w


def oihw(w_hwio: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(w_hwio.transpose(3, 2, 0, 1)))


@pytest.mark.parametrize("d,p", CASES)
def test_conv2d_dil_matches_jax_vjp(d, p, interpret):
    rng, x, w = _conv_data(d + p)
    y, vjp = jax.vjp(lambda a, b: jdc.conv2d_pallas_dil(a, b, p, d), jnp.asarray(x),
                     jnp.asarray(w))
    dy = rng.randn(*y.shape).astype(np.float32)
    dx, dw = vjp(jnp.asarray(dy))

    tx = nchw(x).requires_grad_(True)
    tw = oihw(w).requires_grad_(True)
    got = conv2d_dil(tx, tw, p, d)
    got.backward(nchw(dy))
    np.testing.assert_allclose(nhwc(got), np.asarray(y), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(nhwc(tx.grad), np.asarray(dx), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(tw.grad.permute(2, 3, 1, 0).numpy(), np.asarray(dw),
                               atol=1e-5, rtol=1e-5)
    assert conv2d_dil.launches == 0 and conv2d_dil.backward_launches == 0   # CPU: no kernel


@pytest.mark.parametrize("d,p", CASES)
def test_conv2d_dil_matches_conv2d_autograd(d, p):
    torch.manual_seed(d + p)
    x = torch.randn(2, 16, 13, 21, requires_grad=True)
    w = (torch.randn(24, 16, 3, 3) / 12).requires_grad_(True)
    x2, w2 = (t.detach().clone().requires_grad_(True) for t in (x, w))
    y = conv2d_dil(x, w, p, d)
    want = F.conv2d(x2, w2, padding=p, dilation=d)
    dy = torch.randn_like(want)
    y.backward(dy)
    want.backward(dy)
    torch.testing.assert_close(y, want, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(x.grad, x2.grad, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(w.grad, w2.grad, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(dilated_conv_plain(x.detach(), w.detach(), p, d), want.detach(),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("d,p", CASES)
def test_tap_wgrad_matches_jax(d, p):
    rng, x, w = _conv_data(10 + d)
    ho, wo = 13 + 2 * p - 2 * d, 21 + 2 * p - 2 * d
    dy = rng.randn(1, ho, wo, 32).astype(np.float32)
    want = _tap_wgrad(jnp.asarray(x), jnp.asarray(dy), p, d, 3, 3, 16)   # HWIO
    got = tap_wgrad(nchw(x), nchw(dy), p, d)
    assert got.shape == (32, 16, 3, 3)
    np.testing.assert_allclose(got.permute(2, 3, 1, 0).numpy(), np.asarray(want),
                               atol=1e-5, rtol=1e-5)


def test_conv2d_dil_rejects_what_the_kernel_does_not_take():
    x, w = torch.zeros(1, 16, 13, 21), torch.zeros(32, 16, 3, 3)
    for args in [(x.double(), w.double(), 4, 4), (x, torch.zeros(32, 16, 5, 5), 4, 4),
                 (x, torch.zeros(32, 8, 3, 3), 4, 4), (x, w, 0, 8)]:
        with pytest.raises(ValueError):
            conv2d_dil(*args)


@pytest.fixture
def calls(monkeypatch):
    """The (dilation, stride) of every conv the ResNet sends to K5."""
    seen = []

    def spy(x, w, padding, dilation):
        seen.append(dilation)
        return conv2d_dil(x, w, padding, dilation)

    monkeypatch.setattr(tresnet, "conv2d_dil", spy)
    return seen


NETS = {"resnet10": ("basic", (1, 1, 1, 1), False, [4, 4]),
        "resnet18": ("basic", (2, 2, 2, 2), False, [4, 4, 8, 4]),
        "bottleneck": ("bottleneck", (1, 1, 1, 1), True, [4])}


@pytest.mark.parametrize("name", list(NETS))
def test_routing_only_dilated_stride1_convs(name, calls):
    """Only training passes with ``conv_wgrad="kernel"`` route, and only the
    stride-1 3x3 convs with dilation >= 4: layer4's."""
    block, layers, deep, want = NETS[name]
    net = ResNet(ResNetConfig(block, layers, deep_base=deep))
    tresnet.init_resnet(net, torch.Generator().manual_seed(0))
    x = torch.randn(1, 3, 33, 49)
    net.train()
    net(x, Ctx(train=True))
    assert calls == []
    net(x, Ctx(train=True, conv_wgrad="kernel"))
    assert calls == want
    net.eval()
    with torch.no_grad():
        net(x, Ctx(conv_wgrad="kernel"))
    assert calls == want


def _grads_jax(params, x, g3, g4, jcfg, conv_wgrad):
    ctx = JaxCtx(train=True, rng=jax.random.PRNGKey(0), use_dropout=False, conv_wgrad=conv_wgrad)

    def loss(p):
        c3, c4, _ = jnn.apply_resnet(p, x, jcfg, ctx)
        return jnp.sum(c3 * g3) + jnp.sum(c4 * g4), c4
    (_, c4), grads = jax.value_and_grad(loss, has_aux=True)(params)
    return c4, grads


def _grads_port(net, x, g3, g4, conv_wgrad):
    net.zero_grad(set_to_none=True)
    c3, c4 = net(x, Ctx(train=True, conv_wgrad=conv_wgrad))
    ((c3 * g3).sum() + (c4 * g4).sum()).backward()
    return c4.detach(), {k: p.grad.clone() for k, p in net.named_parameters()}


@pytest.mark.parametrize("name", ["resnet10", "bottleneck"])
def test_resnet_train_k5_matches_jax(name, interpret):
    block, layers, deep, _ = NETS[name]
    jcfg = JaxResNetConfig(block, layers, deep_base=deep)
    rng = np.random.RandomState(7)
    params = _randomize_bn(jnn.init_resnet(jax.random.PRNGKey(7), jcfg), rng)
    x = rng.randn(1, 49, 97, 3).astype(np.float32)
    c3_hw = c4_hw = (7, 13)   # layer3 and layer4 share the stride-8 grid
    ch = 512 * (4 if block == "bottleneck" else 1)
    g3 = rng.randn(1, *c3_hw, ch // 2).astype(np.float32)
    g4 = rng.randn(1, *c4_hw, ch).astype(np.float32)
    # eager: under jax.jit the CPU build of the bottleneck net's VJP gives layer3
    # gradients up to 9% of their scale away from its own eager run and from the
    # port's float64 run, which agree to 1e-5
    c4_j, grads_j = _grads_jax(params, jnp.asarray(x), jnp.asarray(g3), jnp.asarray(g4), jcfg,
                               "pallas")
    want = convert_tree(grads_j)

    net = ResNet(ResNetConfig(block, layers, deep_base=deep))
    net.load_state_dict(convert_tree(params))
    net.train()
    state = {k: v.clone() for k, v in net.state_dict().items()}
    c4, got = _grads_port(net, nchw(x), nchw(g3), nchw(g4), "kernel")
    net.load_state_dict(state)
    _, ref = _grads_port(net, nchw(x), nchw(g3), nchw(g4), "cudnn")
    np.testing.assert_allclose(nhwc(c4), np.asarray(c4_j), atol=1e-4, rtol=1e-4)
    assert set(got) <= set(want) and len(got) > 20
    for k, g in got.items():
        scale = float(np.abs(want[k].numpy()).max())
        np.testing.assert_allclose(g.numpy(), want[k].numpy(), atol=1e-3 * scale, rtol=0,
                                   err_msg=k)
        np.testing.assert_allclose(g.numpy(), ref[k].numpy(), atol=1e-3 * scale, rtol=0,
                                   err_msg=k)
