"""The port's bf16 mixed-precision train step against the JAX package's, on the CPU.

TD4-PSP18 at (65, 129), kv_stride 3, aux head, OHEM, dropout off on both sides
(masks are impl-defined), JAX on its XLA attention. The JAX tree's shapes come
from ``jax.eval_shape`` and its leaves from a seeded numpy draw (He-normal
conv and fc weights, small biases, unit BN and LayerNorm scales); the port
takes them through ``utils/from_jax.py``.

- The port's ``make_loss_of(compute_dtype=torch.bfloat16)`` against JAX's
  ``make_loss_of(compute_dtype=jnp.bfloat16)``. bf16 rounds every conv's
  output, and the two sum each conv in other orders, so they differ by bf16
  noise. JAX's own bf16 run against its f32 run measures that noise: the
  port's loss lies within twice JAX's |bf16 - f32| loss gap plus 1e-4
  relative, and each gradient within twice JAX's per-tensor
  max |bf16 - f32| distance plus 1e-3 x max|grad| of that tensor.
- The contract of ``tests/test_mixed_precision.py``, held for the port: after a
  bf16 step every master parameter and every ``.grad`` is f32; the BatchNorm
  running statistics are f32, within atol / rtol 5e-2 of the f32 step's, and
  moved; the parameters cast are ``_cast_wb``'s ``w``/``b`` leaves mapped
  through the weight bridge's names.
- ``compute_dtype`` other than None and bf16 (float16) raises. bf16 with
  ``conv_wgrad="kernel"`` (K5 in bf16) is held in
  ``tests/test_torch_train_bf16_k5.py``.
The KD term's bf16 teacher is held in ``tests/test_torch_train_bf16_parts.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tdnet_tpu.models.tdnet import TDNetConfig as JaxConfig
from tdnet_tpu.models.tdnet import init_tdnet as jax_init_tdnet
from tdnet_tpu.train import loss as jloss
from tdnet_tpu.train.trainer import _cast_wb
from tdnet_tpu.train.trainer import make_loss_of as jax_make_loss_of
from tdnet_tpu_torch.models import tdnet_config
from tdnet_tpu_torch.nn import step_generator
from tdnet_tpu_torch.train import loss as tloss
from tdnet_tpu_torch.train.trainer import (cast_names, make_loss_of, make_train_state,
                                           make_train_step)
from tdnet_tpu_torch.utils.from_jax import tdnet_from_jax, tdnet_state_from_jax

IN_HW = (65, 129)
N_MIN = IN_HW[0] * IN_HW[1] // 16
POS_ID = 1
# XLA's CPU backend at its lowest optimization level: these tests compare values, and the
# compile of the step's gradient takes a third less
FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


def _configs():
    jcfg = JaxConfig(nclass=19, in_size=IN_HW, kv_stride=3, aux=True, backbone="resnet18",
                     path_num=4, pool_before_proj=True)
    return jcfg, tdnet_config("td4-psp18", in_size=IN_HW, streaming=False)


def seeded_tree(init, seed: int):
    """``init``'s tree shapes (``jax.eval_shape``) with seeded numpy leaves: weights
    ``w`` (HWIO, stacked axes first) He-normal over their fan-in, biases
    N(0, 0.1), norm scales and variances 1, means 0."""
    rng = np.random.RandomState(seed)

    def fill(path, leaf):
        key, shape = path[-1].key, leaf.shape
        if key == "w":
            return (rng.randn(*shape) * np.sqrt(2.0 / np.prod(shape[-4:-1]))).astype(np.float32)
        if key in ("b", "bias"):
            return (rng.randn(*shape) * 0.1).astype(np.float32)
        return (np.ones if key in ("scale", "var") else np.zeros)(shape, np.float32)
    return jax.tree_util.tree_map_with_path(fill, jax.eval_shape(init, jax.random.PRNGKey(0)))


def _data():
    rng = np.random.RandomState(20)
    frames = (rng.randn(4, 1, *IN_HW, 3) * 0.5).astype(np.float32)
    labels = rng.randint(0, 19, (1, *IN_HW))
    labels[:, :7] = 250
    return frames, labels


@pytest.fixture(scope="module")
def runs():
    """Loss and gradients of JAX in bf16 and f32 and of the port in bf16, from
    one state, dropout off."""
    jcfg, cfg = _configs()
    params = seeded_tree(lambda k: jax_init_tdnet(k, jcfg), seed=11)
    frames, labels = _data()
    out = {}
    args = (params, jnp.asarray(frames), jnp.asarray(labels.astype(np.int32)),
            jnp.int32(POS_ID), jax.random.PRNGKey(0), None)
    for name, dt in (("jax_bf16", jnp.bfloat16), ("jax_f32", None)):
        loss_of = jax_make_loss_of(jcfg, use_dropout=False, attn_impl="xla", compute_dtype=dt,
                                   loss_fn=lambda lg, lb: jloss.ohem_cross_entropy(
                                       lg, lb, n_min=N_MIN))
        vg = jax.jit(jax.value_and_grad(loss_of, has_aux=True)).lower(*args).compile(
            compiler_options=FAST_COMPILE)
        (loss, _), grads = vg(*args)
        out[name] = (float(loss), {k: g.float() for k, g in
                                   tdnet_state_from_jax(grads, cfg).items()})
    model = tdnet_from_jax(params, cfg)
    loss_of = make_loss_of(use_dropout=False, compute_dtype=torch.bfloat16,
                           loss_fn=lambda lg, lb: tloss.ohem_cross_entropy(lg, lb, n_min=N_MIN))
    loss, _ = loss_of(model, torch.from_numpy(frames), torch.from_numpy(labels), POS_ID,
                      step_generator(0, 0))
    loss.backward()
    out["port_bf16"] = (loss.item(), {k: p.grad for k, p in model.named_parameters()
                                      if p.grad is not None})
    return out


def test_bf16_loss_tracks_jax(runs):
    (pl, _), (jl, _), (fl, _) = runs["port_bf16"], runs["jax_bf16"], runs["jax_f32"]
    assert np.isfinite(pl) and jl != fl
    assert abs(pl - jl) <= 2 * abs(jl - fl) + 1e-4 * abs(jl), (pl, jl, fl)


def test_bf16_gradients_track_jax(runs):
    got, want, f32 = runs["port_bf16"][1], runs["jax_bf16"][1], runs["jax_f32"][1]
    assert set(got) <= set(want) and len(got) > 100
    for k, g in got.items():
        assert g.dtype == torch.float32, k
        gap = (want[k] - f32[k]).abs().max().item()
        err = (g - want[k]).abs().max().item()
        assert err <= 2 * gap + 1e-3 * want[k].abs().max().item(), \
            f"{k}: {err} from JAX bf16, JAX's bf16 - f32 {gap}, max|grad| {want[k].abs().max()}"


def test_bf16_step_keeps_f32_masters_and_statistics():
    jcfg, cfg = _configs()
    params = seeded_tree(lambda k: jax_init_tdnet(k, jcfg), seed=11)
    frames, labels = (torch.from_numpy(a) for a in _data())
    opt = dict(lr0=1e-2, momentum=0.9, wd=1e-4, warmup_steps=1, warmup_start_lr=1e-3,
               max_iter=4, power=0.9)
    stats = {}
    for name, dt in (("f32", None), ("bf16", torch.bfloat16)):
        model = tdnet_from_jax(params, cfg)
        start = {k: b.clone() for k, b in model.named_buffers()}
        state = make_train_state(model, opt_kwargs=opt)
        m = make_train_step(use_dropout=False, compute_dtype=dt)(state, frames, labels, POS_ID)
        assert np.isfinite(m["loss"].item())
        stats[name] = dict(model.named_buffers())
        if dt is not None:
            for k, p in model.named_parameters():
                assert p.dtype == torch.float32 and p.grad.dtype == torch.float32, k
            assert all(b.dtype == torch.float32 for b in stats[name].values())
            moved = sum((stats[name][k] - start[k]).abs().max().item() for k in start)
            assert moved > 1e-3
    for k, b in stats["bf16"].items():
        np.testing.assert_allclose(b.numpy(), stats["f32"][k].numpy(), atol=5e-2, rtol=5e-2,
                                   err_msg=k)


def test_cast_set_is_cast_wbs():
    jcfg, cfg = _configs()
    params = seeded_tree(lambda k: jax_init_tdnet(k, jcfg), seed=11)
    # _cast_wb casts the w/b leaves; cast to float64, they stand out after the bridge
    marked = tdnet_state_from_jax(_cast_wb(params, np.float64), cfg)
    want = {k for k, t in marked.items() if t.dtype == torch.float64}
    assert want and set(cast_names(tdnet_from_jax(params, cfg))) == want


def test_refuses_float16_compute():
    with pytest.raises(ValueError):
        make_train_step(compute_dtype=torch.float16)
