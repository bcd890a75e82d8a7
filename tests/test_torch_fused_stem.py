"""The fused deep-base stem tail (K4) against the JAX package, f32 on the CPU.

On the CPU the port's ``fused_stem_tail`` takes its plain version (the
unfused eval ops); the JAX side runs the Pallas kernel in interpret mode
(``pl.pallas_call`` patched as ``tests/test_fused_stem.py`` does). The
kernel itself is checked against the plain version on the card
(``chip_smoke.py`` phase 10).

Tolerances: the tail alone to atol 3e-5 / rtol 1e-4, as
``tests/test_fused_stem.py`` holds the TPU kernel against the unfused ops
(two f32 sums of 576 products in another order); the ResNet's c3 and c4
after the fused stem to 1e-4, the same sums carried through the blocks; the
teacher's logits to atol 2e-4 / rtol 1e-4, as ``test_torch_train_parts.py``
holds its plain-stem teacher.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tdnet_tpu import nn as jnn
from tdnet_tpu.kernels import fused_stem as jfs
from tdnet_tpu.models.teacher import TeacherConfig as JaxTeacherConfig
from tdnet_tpu.models.teacher import apply_teacher as jax_apply_teacher
from tdnet_tpu.models.teacher import init_teacher as jax_init_teacher
from tdnet_tpu.nn.module import Ctx as JaxCtx
from tdnet_tpu.nn.resnet import ResNetConfig as JaxResNetConfig
from tdnet_tpu_torch.kernels import fused_stem as tfs
from tdnet_tpu_torch.models import PSPNet, PSPNetConfig, TeacherConfig, apply_teacher, init_pspnet
from tdnet_tpu_torch.nn import Ctx, ResNet
from tdnet_tpu_torch.nn import resnet as tresnet
from tdnet_tpu_torch.nn.resnet import ResNetConfig
from tdnet_tpu_torch.stream.runtime import FrameRunner
from tdnet_tpu_torch.utils.from_jax import convert_tree, teacher_from_jax
from tests.test_torch_modules import _randomize_bn, nchw, nhwc


@pytest.fixture
def interpret(monkeypatch):
    orig = jfs.pl.pallas_call
    monkeypatch.setattr(jfs.pl, "pallas_call",
                        lambda *a, **kw: orig(*a, **{**kw, "interpret": True}))


@pytest.fixture
def calls(monkeypatch):
    """Counts the port's calls of ``fused_stem_tail`` from the ResNet."""
    seen = []

    def spy(*args):
        seen.append(args[0].shape)
        return tfs.fused_stem_tail(*args)

    monkeypatch.setattr(tresnet, "fused_stem_tail", spy)
    return seen


def _bn(rng, c):
    return {"scale": rng.rand(c).astype(np.float32) + 0.5,
            "bias": rng.randn(c).astype(np.float32),
            "mean": rng.randn(c).astype(np.float32),
            "var": rng.rand(c).astype(np.float32) + 0.5}


@pytest.mark.parametrize("hw", [(65, 129), (64, 96)])
def test_fused_stem_plain_matches_jax_kernel(hw, interpret):
    rng = np.random.RandomState(0)
    x = np.maximum(rng.randn(1, *hw, 64).astype(np.float32), 0)
    w1 = rng.randn(3, 3, 64, 64).astype(np.float32) * 0.1
    w2 = rng.randn(3, 3, 64, 128).astype(np.float32) * 0.1
    bn1, bn2 = _bn(rng, 64), _bn(rng, 128)
    sb1, sb2 = (np.asarray(jfs.fold_bn_eval({k: jnp.asarray(v) for k, v in b.items()}))
                for b in (bn1, bn2))
    want = jfs.fused_stem_tail(jnp.asarray(x), jnp.asarray(w1), jnp.asarray(sb1),
                               jnp.asarray(w2), jnp.asarray(sb2))
    oihw = lambda w: torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))
    got = tfs.fused_stem_tail(nchw(x), tfs.stem_tail(oihw(w1), torch.from_numpy(sb1), oihw(w2),
                                                     torch.from_numpy(sb2)))
    assert got.shape == (1, 128, (hw[0] + 1) // 2, (hw[1] + 1) // 2)
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=3e-5, rtol=1e-4)


def test_fused_stem_rejects_other_shapes():
    x = torch.zeros(1, 64, 9, 9)
    w1, w2 = torch.zeros(64, 64, 3, 3), torch.zeros(128, 64, 3, 3)
    sb1, sb2 = torch.zeros(2, 64), torch.zeros(2, 128)
    tfs.fused_stem_tail(x, tfs.stem_tail(w1, sb1, w2, sb2))
    bad = [(torch.zeros(1, 32, 9, 9), w1, sb1, w2, sb2),             # 32 input channels
           (x, torch.zeros(64, 64, 5, 5), sb1, w2, sb2),             # 5x5
           (x, w1, sb1, torch.zeros(256, 64, 3, 3), sb2),            # 64 -> 256
           (x, w1, sb1, w2, torch.zeros(128)),                       # an unstacked pair
           (x.half(), w1.half(), sb1, w2.half(), sb2),               # float16
           (x, w1, sb1.double(), w2, sb2)]                           # float64 affine
    for args in bad:
        with pytest.raises(ValueError):
            tfs.fused_stem_tail(args[0], tfs.stem_tail(*args[1:]))


@pytest.fixture(scope="module")
def deep_base():
    jcfg = JaxResNetConfig("bottleneck", (1, 1, 1, 1), deep_base=True)
    rng = np.random.RandomState(5)
    params = _randomize_bn(jnn.init_resnet(jax.random.PRNGKey(5), jcfg), rng)
    x = rng.randn(1, 65, 129, 3).astype(np.float32)
    net = ResNet(ResNetConfig("bottleneck", (1, 1, 1, 1), deep_base=True))
    net.load_state_dict(convert_tree(params))
    return jcfg, params, x, net.eval()


def test_resnet_fused_stem_matches_jax(deep_base, interpret, calls):
    jcfg, params, x, net = deep_base
    c3, c4, _ = jnn.apply_resnet(params, jnp.asarray(x), jcfg, JaxCtx(stem_impl="fused"))
    with torch.no_grad():
        g3, g4 = net(nchw(x), Ctx(stem_impl="fused"))
    assert calls == [(1, 64, 33, 65)]
    np.testing.assert_allclose(nhwc(g3), np.asarray(c3), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(nhwc(g4), np.asarray(c4), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("case", ["resnet18", "deep_base_train"])
def test_fused_stem_falls_back(case, deep_base, calls):
    """``stem_impl="fused"`` on a 7x7 stem, or in train mode, runs the plain
    stem: nothing goes to the fused tail and the output is bit for bit the
    plain one."""
    _, _, x, net = deep_base
    if case == "resnet18":
        net = ResNet(ResNetConfig("basic", (2, 2, 2, 2)))
        tresnet.init_resnet(net, torch.Generator().manual_seed(0))
        net.eval()
    else:
        net = ResNet(net.cfg)
        net.load_state_dict(deep_base[3].state_dict())
        net.train()
    with torch.no_grad():
        state = {k: v.clone() for k, v in net.state_dict().items()}
        a = net(nchw(x), Ctx(train=net.training, stem_impl="fused"))
        net.load_state_dict(state)     # train mode moved the running statistics
        b = net(nchw(x), Ctx(train=net.training))
    assert calls == []
    for u, v in zip(a, b):
        assert torch.equal(u, v)


def test_teacher_fused_stem_matches_jax(interpret, calls):
    """``apply_teacher(stem_impl="fused")`` against JAX ``apply_teacher`` with
    the Pallas tail in interpret mode: the full and the group logits."""
    jcfg = JaxTeacherConfig(nclass=19, backbone="resnet50", path_num=2)
    rng = np.random.RandomState(2)
    params = jax_init_teacher(jax.random.PRNGKey(2), jcfg)
    params = {**params, "backbone": _randomize_bn(params["backbone"], rng)}
    x = rng.randn(1, 49, 65, 3).astype(np.float32)
    want = jax_apply_teacher(params, jnp.asarray(x), jcfg, stem_impl="fused")
    port = teacher_from_jax(params, TeacherConfig(nclass=19, backbone="resnet50", path_num=2))
    full, grp = apply_teacher(port, torch.from_numpy(x), group_id=1, stem_impl="fused")
    assert calls == [(1, 64, 25, 33)]
    np.testing.assert_allclose(nhwc(full), np.asarray(want[0]), atol=2e-4, rtol=1e-4)
    np.testing.assert_allclose(nhwc(grp), np.asarray(want[2]), atol=2e-4, rtol=1e-4)


def test_runner_lays_out_the_stem_tail_once():
    """A fused-stem runner lays out K4's weights once, from the folded BNs; a
    mode switch drops them, and a ResNet called without them lays them out
    for the call: the same output either way."""
    cfg = PSPNetConfig(backbone="resnet50", in_size=(33, 49))
    net = init_pspnet(cfg, torch.Generator().manual_seed(3))
    plain = PSPNet(cfg)
    plain.load_state_dict(net.state_dict())
    runner = FrameRunner(net, stem_impl="fused")
    stem, bn2 = net.backbone.stem, net.backbone.bn1
    assert stem.tail is not None
    assert torch.equal(stem.tail.sb2, torch.stack(bn2.folded))
    x = torch.randn(1, 3, 33, 49, generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        once = stem.fused(x, bn2)
        plain.eval()
        per_call = plain.backbone.stem.fused(x, plain.backbone.bn1)
    assert plain.backbone.stem.tail is None
    torch.testing.assert_close(once, per_call, atol=1e-5, rtol=1e-5)
    assert runner.step(x.permute(0, 2, 3, 1))[0].shape == (1, 33, 49, 19)
    net.train()
    assert stem.tail is None
