"""The port's FANet blocks (``tdnet_tpu_torch/nn/fanet.py``) against the JAX
package's (``tdnet_tpu/nn/fanet.py``), on the CPU.

The same JAX trees (the inits' shapes with seeded He-normal weights, BatchNorm
statistics and affines drawn from a seeded numpy stream so that the eval
affine is not the identity) go into the
port's modules through ``utils/from_jax.convert_tree``; the same numpy inputs
go through both.

- the FANet ResNet (the BasicBlock ResNet-18 and the Bottleneck ResNet-50),
  ``FAModule`` in each flag combination ``_fa_trunk`` uses (up and smooth
  with no input from above, up and smooth, up alone, smooth alone) and
  ``FPNOutput``: eval and train mode, f32 to atol / rtol 2e-5; in train mode
  every updated BatchNorm running statistic to atol / rtol 2e-5, and a conv
  that did not run leaves its statistics as they were. The ResNets in train
  mode compare in float64 (JAX with x64): layer4 normalizes over 12 values a
  channel, and 16 or more such layers carry the two sides' f32 conv rounding
  to 1e-4 (ResNet-50) of the features;
- the padding-1 ``up`` conv grows the map by 2 px a side, as JAX's;
- ``FAModule`` in bf16 (every parameter cast, as the ``Streamer`` casts
  them): within 2^-6 x max|JAX output|, four bf16 ulps at the largest output
  (both round the L2 norm, k^T v and q f at the same points; their convs sum
  in other orders, and an input one ulp apart moves the 3x3 smooth conv's
  rounded output by up to two ulps: one output of 30,720 does);
- the linear attention alone in bf16: JAX's to one bf16 ulp of the output's
  scale.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tdnet_tpu.nn import fanet as jfa
from tdnet_tpu.nn.module import Ctx as JaxCtx
from tdnet_tpu_torch.nn import fanet
from tdnet_tpu_torch.utils.from_jax import convert_tree
from tests.test_torch_train_bf16 import seeded_tree

_BN = {"scale", "bias", "mean", "var"}
FLAGS = [(True, True, False), (True, True, True), (True, False, True), (False, True, True)]


def randomized_bn(tree, seed: int):
    """``tree`` with every BatchNorm's scale, bias, mean and var drawn from a
    seeded stream (scale in [0.5, 1], var in [1, 2]: each eval BN shrinks, so
    that the activations of a deep random net stay of order one)."""
    rng = np.random.RandomState(seed)

    def walk(t):
        if isinstance(t, dict) and set(t) == _BN:
            c = np.asarray(t["scale"]).shape
            return {"scale": jnp.asarray(rng.uniform(0.5, 1.0, c), jnp.float32),
                    "bias": jnp.asarray(rng.randn(*c) * 0.1, jnp.float32),
                    "mean": jnp.asarray(rng.randn(*c) * 0.1, jnp.float32),
                    "var": jnp.asarray(rng.uniform(1.0, 2.0, c), jnp.float32)}
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        if isinstance(t, list):
            return [walk(v) for v in t]
        return t
    return walk(tree)


def load(module: torch.nn.Module, tree) -> torch.nn.Module:
    module.load_state_dict(convert_tree(tree))
    return module


def nchw(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.transpose(np.asarray(a), (0, 3, 1, 2))))


def nhwc(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    return (t.float() if t.dtype == torch.bfloat16 else t).permute(0, 2, 3, 1).numpy()


def jctx(train: bool) -> JaxCtx:
    return JaxCtx(train=True, rng=jax.random.PRNGKey(0), use_dropout=False) if train \
        else JaxCtx(train=False)


def close(got: torch.Tensor, want, what: str) -> None:
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=2e-5, rtol=2e-5, err_msg=what)


def check_stats(module: torch.nn.Module, updated, before: dict) -> int:
    """Every running statistic of ``module`` against JAX's updated tree; returns
    how many moved."""
    want = {k: v for k, v in convert_tree(updated).items() if "running_" in k}
    mine = {k: v for k, v in module.state_dict().items() if "running_" in k}
    assert set(mine) == set(want)
    for k in mine:
        np.testing.assert_allclose(mine[k].numpy(), want[k].numpy(), atol=2e-5, rtol=2e-5,
                                   err_msg=k)
    return sum(not torch.equal(mine[k], before[k]) for k in mine)


def stats(module: torch.nn.Module) -> dict:
    return {k: v.clone() for k, v in module.state_dict().items() if "running_" in k}


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("name", ["resnet18", "resnet50"])
def test_fanet_resnet(name, train):
    jcfg = jfa.FANET_BACKBONES[name]()
    tree = randomized_bn(seeded_tree(lambda k: jfa.init_fanet_resnet(k, jcfg), 1), 2)
    dt = np.float64 if train else np.float32
    x = (np.random.RandomState(3).randn(2, 64, 96, 3) * 0.5).astype(dt)
    with jax.enable_x64(train):
        feats, upd = jfa.apply_fanet_resnet(jax.tree.map(lambda a: jnp.asarray(a, dt), tree),
                                            jnp.asarray(x), jcfg, jctx(train))
        feats, upd = jax.tree.map(np.asarray, (feats, upd))
    net = load(fanet.FANetResNet(fanet.FANET_BACKBONES[name]()).to(torch.from_numpy(x).dtype),
               tree).train(train)
    before = stats(net)
    got = net(nchw(x))
    assert [tuple(g.shape[-2:]) for g in got] == [(8, 12), (4, 6), (2, 3), (1, 2)]
    for i, (g, w) in enumerate(zip(got, feats)):
        close(g, w, f"feat {i}")
    moved = check_stats(net, upd, before)
    assert moved == (len(before) if train else 0)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("up_flag,smf_flag,from_above", FLAGS,
                         ids=["ffm_32", "ffm_16", "ffm_8", "ffm_4"])
def test_fa_module(up_flag, smf_flag, from_above, train):
    c = 64
    tree = randomized_bn(seeded_tree(lambda k: jfa.init_fa_module(k, c, 32), 4), 5)
    rng = np.random.RandomState(6)
    feat = rng.randn(2, 12, 20, c).astype(np.float32)
    up_in = rng.randn(2, 8, 12, c).astype(np.float32) if from_above else None
    *want, upd = jfa.apply_fa_module(tree, jnp.asarray(feat),
                                     None if up_in is None else jnp.asarray(up_in), jctx(train),
                                     up_flag=up_flag, smf_flag=smf_flag)
    fa = load(fanet.FAModule(c, 32), tree).train(train)
    before = stats(fa)
    got = fanet.apply_fa_module(fa, nchw(feat), None if up_in is None else nchw(up_in),
                                up_flag=up_flag, smf_flag=smf_flag)
    assert len(got) == len(want) == up_flag + (smf_flag and (not up_flag or from_above))
    for i, (g, w) in enumerate(zip(got, want)):
        close(g, w, f"output {i}")
    if up_flag:   # the padding-1 1x1 conv: 2 px more a side
        assert tuple(got[0].shape) == (2, c // 2, 14, 22)
    moved = check_stats(fa, upd, before)
    ran = 4 + up_flag + (len(got) > up_flag)        # w_qs, w_ks, w_vs, latlayer3 (+ up, smooth)
    assert moved == (2 * ran if train else 0)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_fpn_output(train):
    tree = randomized_bn(seeded_tree(lambda k: jfa.init_fpn_output(k, 48, 32, 19), 7), 8)
    x = np.random.RandomState(9).randn(2, 10, 14, 48).astype(np.float32)
    want, upd = jfa.apply_fpn_output(tree, jnp.asarray(x), jctx(train))
    head = load(fanet.FPNOutput(48, 32, 19), tree).train(train)
    before = stats(head)
    close(head(nchw(x)), want, "logits")
    assert check_stats(head, upd, before) == (2 if train else 0)


def test_fa_module_bf16():
    c = 64
    tree = randomized_bn(seeded_tree(lambda k: jfa.init_fa_module(k, c, 32), 10), 11)
    rng = np.random.RandomState(12)
    feat = rng.randn(1, 24, 40, c).astype(np.float32)
    up_in = rng.randn(1, 14, 22, c).astype(np.float32)
    jtree = jax.tree.map(lambda a: a.astype(jnp.bfloat16), tree)
    up16, sm16, _ = jfa.apply_fa_module(jtree, jnp.asarray(feat, jnp.bfloat16),
                                        jnp.asarray(up_in, jnp.bfloat16), jctx(False),
                                        up_flag=True, smf_flag=True)
    fa = load(fanet.FAModule(c, 32), tree).to(torch.bfloat16).eval()
    got = fanet.apply_fa_module(fa, nchw(feat).to(torch.bfloat16),
                                nchw(up_in).to(torch.bfloat16), up_flag=True, smf_flag=True)
    for g, w, what in zip(got, (up16, sm16), ("up", "smooth")):
        assert g.dtype == torch.bfloat16
        w = np.asarray(w.astype(jnp.float32))
        scale = np.abs(w).max()
        np.testing.assert_allclose(nhwc(g), w, atol=2.0 ** -6 * scale, rtol=0, err_msg=what)


def test_linear_attention_rounding_points_bf16():
    """k^T v and q f each summed in f32, f rounded to bf16 between them: the
    port's ``linear_attention`` on bf16 maps is JAX's to a bf16 ulp."""
    rng = np.random.RandomState(13)
    q, k = (rng.randn(1, 32, 6, 9).astype(np.float32) for _ in range(2))
    v = rng.randn(1, 16, 6, 9).astype(np.float32)
    tb = lambda a: torch.from_numpy(a).to(torch.bfloat16)
    got = fanet.linear_attention(tb(q), tb(k), tb(v))
    jb = lambda a: jnp.asarray(np.transpose(a, (0, 2, 3, 1)).reshape(1, 54, -1), jnp.bfloat16)
    qt, kt = jfa._l2norm(jb(q), axis=2), jfa._l2norm(jb(k), axis=2)
    f = jnp.einsum("nlk,nlc->nkc", kt, jb(v), preferred_element_type=jnp.float32)
    y = jnp.einsum("nlk,nkc->nlc", qt, f.astype(qt.dtype),
                   preferred_element_type=jnp.float32).astype(jnp.bfloat16)
    want = np.asarray(y.astype(jnp.float32)).reshape(1, 6, 9, 16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(nhwc(got), want, atol=2.0 ** -8 * np.abs(want).max(), rtol=0)
