"""The PSPNet baseline (``--model psp101``) against the JAX package, f32 on the CPU.

Same weights (JAX ``init_pspnet`` through ``utils/from_jax.pspnet_from_jax``)
and the same numpy frame go through both, in eval mode. The backbone is the
deep-base bottleneck ResNet with one block per layer, put in place of
``resnet50`` in both packages' ``BACKBONES`` for the test, so that the head
sees the 2,048 channels of the real model at a fraction of its depth. The
fused stem runs the JAX Pallas kernel in interpret mode and the port's plain
version (``kernels/fused_stem.py``).

Tolerances: 1e-4 x max|logits| (atol) and 1e-4 (rtol): the logits are f32
sums through the whole net, taken in another order on each side (the
backbone alone holds to 1e-4 in ``test_torch_fused_stem.py``); the runner
folds the BNs into one affine, which moves a value by an f32 rounding.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tdnet_tpu import nn as jnn
from tdnet_tpu.kernels import fused_stem as jfs
from tdnet_tpu.models.pspnet import PSPNetConfig as JaxPSPNetConfig
from tdnet_tpu.models.pspnet import apply_pspnet as jax_apply_pspnet
from tdnet_tpu.models.pspnet import init_pspnet as jax_init_pspnet
from tdnet_tpu.nn.module import Ctx as JaxCtx
from tdnet_tpu.nn.resnet import ResNetConfig as JaxResNetConfig
from tdnet_tpu_torch import nn as tnn
from tdnet_tpu_torch.models import STREAM_SIZE, PSPNetConfig, apply_pspnet, init_pspnet
from tdnet_tpu_torch.nn import Ctx
from tdnet_tpu_torch.nn.resnet import ResNetConfig
from tdnet_tpu_torch.stream.runtime import FrameRunner
from tdnet_tpu_torch.utils.from_jax import pspnet_from_jax
from tests.test_torch_modules import _randomize_bn, nhwc

IN_SIZE = (65, 129)


@pytest.fixture
def one_block_resnet50(monkeypatch):
    """``resnet50`` is a one-block-per-layer deep-base net in both packages."""
    monkeypatch.setitem(jnn.BACKBONES, "resnet50",
                        lambda: JaxResNetConfig("bottleneck", (1, 1, 1, 1), deep_base=True))
    monkeypatch.setitem(tnn.BACKBONES, "resnet50",
                        lambda: ResNetConfig("bottleneck", (1, 1, 1, 1), deep_base=True))
    orig = jfs.pl.pallas_call
    monkeypatch.setattr(jfs.pl, "pallas_call",
                        lambda *a, **kw: orig(*a, **{**kw, "interpret": True}))


def _nets(aux: bool, seed: int = 3):
    jcfg = JaxPSPNetConfig(nclass=19, backbone="resnet50", in_size=IN_SIZE, aux=aux)
    rng = np.random.RandomState(seed)
    params = _randomize_bn(jax_init_pspnet(jax.random.PRNGKey(seed), jcfg), rng)
    x = rng.randn(1, *IN_SIZE, 3).astype(np.float32) * 0.5
    cfg = PSPNetConfig(nclass=19, backbone="resnet50", in_size=IN_SIZE, aux=aux)
    return jcfg, params, x, cfg


def _close(got: np.ndarray, want: np.ndarray, what: str) -> None:
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max(), rtol=1e-4,
                               err_msg=what)


@pytest.mark.parametrize("stem_impl", ["plain", "fused"])
def test_pspnet_matches_jax(stem_impl, one_block_resnet50):
    jcfg, params, x, cfg = _nets(aux=True)
    jax_stem = "xla" if stem_impl == "plain" else "fused"
    out_j, aux_j, _ = jax_apply_pspnet(params, jnp.asarray(x), jcfg,
                                       JaxCtx(train=False, stem_impl=jax_stem), return_aux=True)
    net = pspnet_from_jax(params, cfg).eval()
    with torch.no_grad():
        out, aux = apply_pspnet(net, torch.from_numpy(x), Ctx(stem_impl=stem_impl),
                                return_aux=True)
        only = apply_pspnet(net, torch.from_numpy(x), Ctx(stem_impl=stem_impl))
    assert out.shape == (1, *IN_SIZE, 19)
    _close(out.numpy(), np.asarray(out_j), "logits")
    _close(aux.numpy(), np.asarray(aux_j), "aux logits")
    assert torch.equal(only, out)


def test_frame_runner_matches_jax(one_block_resnet50):
    """The ``--model psp101`` runner (folded BNs, fused stem) frame by frame."""
    jcfg, params, x, cfg = _nets(aux=False, seed=4)
    want, _ = jax_apply_pspnet(params, jnp.asarray(x), jcfg, JaxCtx(train=False))
    runner = FrameRunner(pspnet_from_jax(params, cfg), stem_impl="fused")
    for _ in range(2):
        got, dt = runner.step(torch.from_numpy(x))
        _close(got.numpy(), np.asarray(want), "runner logits")
        assert dt >= 0
    assert runner.frame_idx == 2


def test_pspnet_from_jax_takes_the_aux_head_only_when_configured(one_block_resnet50):
    _, params, _, cfg = _nets(aux=True)
    no_aux = PSPNetConfig(nclass=19, backbone="resnet50", in_size=IN_SIZE, aux=False)
    net = pspnet_from_jax(params, no_aux)
    assert not hasattr(net, "aux")
    assert hasattr(pspnet_from_jax(params, cfg), "aux")


def test_init_pspnet_is_seeded():
    cfg = PSPNetConfig(nclass=5, backbone="resnet10", in_size=(33, 49), aux=True)
    a, b = (init_pspnet(cfg, torch.Generator().manual_seed(1)) for _ in range(2))
    for (k, u), (_, v) in zip(a.state_dict().items(), b.state_dict().items()):
        assert torch.equal(u, v), k
    assert STREAM_SIZE["psp101"] == (769, 1537)
    with torch.no_grad():
        out = apply_pspnet(a.eval(), torch.zeros(1, 33, 49, 3), Ctx())
    assert out.shape == (1, 33, 49, 5) and torch.isfinite(out).all()
