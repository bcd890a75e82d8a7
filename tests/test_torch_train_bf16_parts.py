"""The modules of the bf16 mixed-precision train step against the JAX package's
in bf16, on the CPU: where each rounds to bf16 and where it stays f32.

- ``adaptive_avg_pool_multi`` in bf16: the cell sums over rows, then columns,
  rounded to bf16, divided by the count in f32 (``tdnet_tpu/ops/pool.py:64-95``):
  bitwise JAX's, and its gradient bf16.
- ``resize_bilinear`` in bf16: the port interpolates in f32 and rounds once,
  where JAX rounds its matrices and each product to bf16; the two lie within
  two bf16 ulps of the output's scale, and the gradient is bf16, as
  ``jax.grad``'s is.
- ``batch_norm_train`` in bf16 with a residual and ReLU: moments, affine and
  residual in f32, one rounding to bf16, running statistics f32
  (``tdnet_tpu/ops/norm.py:100-111, 172-191``): the output within one bf16 ulp
  of JAX's and the statistics to f32 rounding.
- The losses on bf16 logits (OHEM CE, KL) upcast to f32 as JAX's do: equal to
  the f32 losses on the bf16-rounded logits, within f32 rounding of JAX's.
- The frozen teacher in bf16 (``_cast_wb`` of its weights, the bf16 frame; a
  ResNet-18 teacher at (65, 129)): both logits within twice JAX's own
  |bf16 - f32| distance plus 1e-3 x max|logits|.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tdnet_tpu import ops as jops
from tdnet_tpu.models.teacher import TeacherConfig as JaxTeacherConfig
from tdnet_tpu.models.teacher import apply_teacher as jax_apply_teacher
from tdnet_tpu.models.teacher import init_teacher as jax_init_teacher
from tdnet_tpu.train import loss as jloss
from tdnet_tpu.train.trainer import _cast_wb
from tdnet_tpu_torch import ops
from tdnet_tpu_torch.models import TeacherConfig, apply_teacher
from tdnet_tpu_torch.train import loss as tloss
from tdnet_tpu_torch.train.trainer import call_cast
from tdnet_tpu_torch.utils.from_jax import teacher_from_jax

BF16 = torch.bfloat16


def nchw(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(jnp.asarray(a).astype(jnp.float32))).permute(0, 3, 1, 2)


def nhwc(t: torch.Tensor) -> np.ndarray:
    return t.float().permute(0, 2, 3, 1).detach().numpy()


def _bf16_input(shape, seed):
    return jnp.asarray(np.random.RandomState(seed).randn(*shape), jnp.float32).astype(jnp.bfloat16)


def _ulp(x: np.ndarray) -> np.ndarray:
    return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126))) - 7)


@pytest.mark.parametrize("hw", [(13, 25), (97, 193)])
def test_bf16_pool_is_jaxs(hw):
    x = _bf16_input((1, *hw, 6), seed=5)
    want = jops.adaptive_avg_pool_multi(x, (1, 2, 3, 6))
    xt = nchw(x).to(BF16).requires_grad_(True)
    got = ops.adaptive_avg_pool_multi(xt, (1, 2, 3, 6))
    for g, w in zip(got, want):
        assert g.dtype == BF16 and w.dtype == jnp.bfloat16
        np.testing.assert_array_equal(nhwc(g), np.asarray(w.astype(jnp.float32)))
    sum(g.float().sum() for g in got).backward()
    assert xt.grad.dtype == BF16


@pytest.mark.parametrize("src,dst", [((13, 25), (65, 129)), ((6, 6), (97, 193))])
def test_bf16_resize_tracks_jax(src, dst):
    x = _bf16_input((1, *src, 5), seed=4)
    want, vjp = jax.vjp(lambda t: jops.resize_bilinear(t, dst), x)
    xt = nchw(x).to(BF16).requires_grad_(True)
    got = ops.resize_bilinear(xt, dst)
    w = np.asarray(want.astype(jnp.float32))
    assert got.dtype == BF16 and want.dtype == jnp.bfloat16
    assert np.abs(nhwc(got) - w).max() <= 2 * _ulp(np.abs(w).max())
    g = _bf16_input(want.shape, seed=6)
    (dx,) = vjp(g)
    got.backward(nchw(g).to(BF16))
    assert xt.grad.dtype == BF16 and dx.dtype == jnp.bfloat16


@pytest.mark.parametrize("activation", ["relu", None])
def test_bf16_batch_norm_train_rounds_once(activation):
    x = _bf16_input((2, 9, 11, 16), seed=7)
    r = _bf16_input((2, 9, 11, 16), seed=8)
    rng = np.random.RandomState(9)
    p = {"scale": jnp.asarray(rng.rand(16) + 0.5, jnp.float32),
         "bias": jnp.asarray(rng.randn(16), jnp.float32),
         "mean": jnp.zeros(16, jnp.float32), "var": jnp.ones(16, jnp.float32)}
    want, stats = jops.batch_norm(x, p, train=True, activation=activation, residual=r)
    bn = ops.BatchNorm(16)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(np.asarray(p["scale"])))
        bn.bias.copy_(torch.from_numpy(np.asarray(p["bias"])))
    got = bn.train()(nchw(x).to(BF16), activation, nchw(r).to(BF16))
    w = np.asarray(want.astype(jnp.float32))
    assert got.dtype == BF16
    assert (np.abs(nhwc(got) - w) <= _ulp(w)).all()
    assert bn.running_mean.dtype == torch.float32 and bn.running_var.dtype == torch.float32
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(stats["mean"]), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(stats["var"]), rtol=1e-5)


def test_bf16_losses_upcast():
    logits = _bf16_input((1, 19, 9, 11), seed=10)   # NCHW for the port
    labels = np.random.RandomState(11).randint(0, 19, (1, 9, 11))
    labels[0, 0] = 250
    lt = torch.from_numpy(np.asarray(logits.astype(jnp.float32))).to(BF16)
    lab = torch.from_numpy(labels)
    jlog = jnp.transpose(logits, (0, 2, 3, 1))
    for got, want, f32 in (
            (tloss.ohem_cross_entropy(lt, lab, n_min=20), jloss.ohem_cross_entropy(
                jlog, jnp.asarray(labels), n_min=20), tloss.ohem_cross_entropy(
                lt.float(), lab, n_min=20)),
            (tloss.kl_divergence(lt, lt.flip(1)), jloss.kl_divergence(jlog, jlog[..., ::-1]),
             tloss.kl_divergence(lt.float(), lt.float().flip(1)))):
        assert got.dtype == torch.float32 and got.item() == f32.item()
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)


def test_bf16_teacher_tracks_jax():
    jcfg = JaxTeacherConfig(nclass=19, backbone="resnet18", path_num=4)
    params = jax_init_teacher(jax.random.PRNGKey(12), jcfg)
    frame = np.random.RandomState(13).randn(1, 65, 129, 3).astype(np.float32) * 0.5
    run = jax.jit(lambda p, x: jax_apply_teacher(p, x, jcfg, group_id=2))
    want16 = run(_cast_wb(params, jnp.bfloat16), jnp.asarray(frame).astype(jnp.bfloat16))
    want32 = run(params, jnp.asarray(frame))
    teacher = teacher_from_jax(jax.tree.map(np.asarray, params),
                               TeacherConfig(nclass=19, backbone="resnet18"))
    got = call_cast(apply_teacher, teacher, BF16, torch.from_numpy(frame).to(BF16), 2)
    assert all(p.dtype == torch.float32 for p in teacher.parameters())
    for g, w16, w32 in zip(got, want16, want32):
        assert g.dtype == BF16 and w16.dtype == jnp.bfloat16
        w16 = np.asarray(w16.astype(jnp.float32))
        gap = np.abs(w16 - np.asarray(w32)).max()
        err = np.abs(nhwc(g) - w16).max()
        assert err <= 2 * gap + 1e-3 * np.abs(w16).max(), (err, gap)
