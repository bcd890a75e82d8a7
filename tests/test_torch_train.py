"""The port's full-recipe train step against the JAX package's, on the CPU.

Same weights (JAX ``init_tdnet`` / ``init_teacher`` through
``utils/from_jax.py``), the same numpy frames and labels (some pixels at the
ignore label 250), dropout off on both sides (masks are impl-defined,
docs/PARITY.md), the JAX side jitted with its XLA attention.

- The full step (OHEM, KD from a ResNet-50 teacher, aux head, AdaOptimizer
  across the warm-up) against ``make_loss_of`` + ``jax.value_and_grad`` +
  ``ada_optimizer`` for two steps. JAX runs with x64 enabled (its attention
  and losses keep float32 inside), the port in float64 and in float32. At
  this size some backbone gradients are sums that cancel: the port's own
  float32 run moves them by up to a fifth of their largest entry against its
  float64 run, where the other gradients move by 1e-6. So each gradient of
  the float64 port is held to JAX's within 2e-3 x max|gradient| of that
  tensor, plus 1e-7 (gradients that vanish in exact arithmetic, such as a
  bias before a LayerNorm, read up to 1e-8), plus the port's own float32
  noise on that tensor (|float32 - float64|), which bounds what JAX's float32
  islands can move it by; the parameters after two steps to 1e-5 plus that noise. Both steps
  take the same seeded frames (pos_id 2, then 0): with other frames a ReLU
  whose input JAX's float32 attention rounds to the other side of zero moves
  a few gradient tensors of one path by up to a few percent, a difference of
  rounding that neither float64 nor this test can remove. The loss and KD
  agree to rtol 1e-6 in float64 and 1e-4 in float32.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from tdnet_tpu.models.tdnet import TDNetConfig as JaxConfig
from tdnet_tpu.models.tdnet import init_tdnet as jax_init_tdnet
from tdnet_tpu.models.teacher import TeacherConfig as JaxTeacherConfig
from tdnet_tpu.models.teacher import init_teacher as jax_init_teacher
from tdnet_tpu.train import loss as jloss
from tdnet_tpu.train.optim import ada_optimizer as jax_ada_optimizer
from tdnet_tpu.train.trainer import make_loss_of as jax_make_loss_of
from tdnet_tpu_torch.models import TeacherConfig, tdnet_config
from tdnet_tpu_torch.train import loss as tloss
from tdnet_tpu_torch.train.trainer import make_train_state, make_train_step
from tdnet_tpu_torch.utils.from_jax import teacher_from_jax, tdnet_from_jax, tdnet_state_from_jax
from torch_threads import few_threads  # noqa: F401  (the file runs on two threads)

IN_HW = (65, 129)
ARCHS = {"td4-psp18": dict(backbone="resnet18", path_num=4, pool_before_proj=True),
         "td2-psp50": dict(backbone="resnet50", path_num=2, pool_before_proj=False)}


def _configs(arch):
    jcfg = JaxConfig(nclass=19, in_size=IN_HW, kv_stride=3, aux=True, **ARCHS[arch])
    cfg = tdnet_config(arch, in_size=IN_HW, streaming=False)
    assert (cfg.kv_stride, cfg.pool_before_proj, cfg.aux) == (3, jcfg.pool_before_proj, True)
    return jcfg, cfg


def _data(p, seed):
    rng = np.random.RandomState(seed)
    frames = (rng.randn(p, 1, *IN_HW, 3) * 0.5).astype(np.float32)
    labels = rng.randint(0, 19, (1, *IN_HW))
    labels[:, :7] = 250
    return frames, labels


@pytest.fixture(scope="module")
def full_step():
    """Two steps of the full recipe: JAX (x64) and the port in float64, and
    the port in float32: loss, kd and gradients per step, and the final
    parameters."""
    jcfg, cfg = _configs("td4-psp18")
    jtcfg = JaxTeacherConfig(nclass=19, backbone="resnet50", path_num=4)
    n_min = IN_HW[0] * IN_HW[1] // 16
    opt = dict(lr0=1e-2, momentum=0.9, wd=1e-4, warmup_steps=1, warmup_start_lr=1e-3,
               max_iter=4, power=0.9)
    steps = [(_data(4, seed=20), 2), (_data(4, seed=20), 0)]
    rec = {"jax": []}
    with jax.enable_x64(True):
        f64 = lambda tree: jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), tree)
        params = f64(jax_init_tdnet(jax.random.PRNGKey(11), jcfg))
        tparams = f64(jax_init_teacher(jax.random.PRNGKey(12), jtcfg))
        init_params = params
        loss_of = jax_make_loss_of(jcfg, teacher_cfg=jtcfg, use_dropout=False, attn_impl="xla",
                                   loss_fn=lambda lg, lb: jloss.ohem_cross_entropy(
                                       lg, lb, n_min=n_min))
        vg = jax.jit(jax.value_and_grad(loss_of, has_aux=True))  # one compile: pos_id traced
        tx, _ = jax_ada_optimizer(params, **opt)
        ostate = tx.init(params)
        update = jax.jit(lambda g, o, p, upd: (lambda u, o2: (optax.apply_updates(upd, u), o2))(
            *tx.update(g, o, p)))
        for (frames, labels), pos in steps:
            (loss, aux), grads = vg(params, jnp.asarray(frames, jnp.float64),
                                    jnp.asarray(labels.astype(np.int32)), jnp.int32(pos),
                                    jax.random.PRNGKey(0), tparams)
            params, ostate = update(grads, ostate, params, aux["updated_params"])
            rec["jax"].append((float(loss), float(aux["kd"]), tdnet_state_from_jax(grads, cfg)))
        rec["params"] = tdnet_state_from_jax(params, cfg)
        init_params, tparams = jax.tree.map(np.asarray, (init_params, tparams))

    step = make_train_step(use_dropout=False, loss_fn=lambda lg, lb: tloss.ohem_cross_entropy(
        lg, lb, n_min=n_min))
    for dt in (torch.float64, torch.float32):
        model = tdnet_from_jax(init_params, cfg).to(dt)
        teacher = teacher_from_jax(tparams, TeacherConfig(nclass=19, backbone="resnet50")).to(dt)
        state = make_train_state(model, opt_kwargs=opt)
        rec[dt] = []
        for (frames, labels), pos in steps:
            m = step(state, torch.from_numpy(frames).to(dt), torch.from_numpy(labels), pos, teacher)
            rec[dt].append((float(m["loss"]), float(m["kd"]),
                            {k: p.grad.clone() for k, p in model.named_parameters()}))
        rec[("params", dt)] = model.state_dict()
    return rec


@pytest.mark.parametrize("it", [0, 1])
def test_full_step_loss(full_step, it):
    (jl, jkd, _), (tl, tkd, _) = full_step["jax"][it], full_step[torch.float64][it]
    assert jkd > 0.0
    np.testing.assert_allclose(tl, jl, rtol=1e-6)
    np.testing.assert_allclose(tkd, jkd, rtol=1e-6)
    l32, kd32, _ = full_step[torch.float32][it]
    np.testing.assert_allclose([l32, kd32], [jl, jkd], rtol=1e-4)


@pytest.mark.parametrize("it", [0, 1])
def test_full_step_gradients(full_step, it):
    want, got = full_step["jax"][it][2], full_step[torch.float64][it][2]
    f32 = full_step[torch.float32][it][2]
    assert set(got) <= set(want) and len(got) > 100
    nonzero = 0
    for k, g in got.items():
        w = want[k].double()
        scale = float(w.abs().max())
        nonzero += scale > 1e-6
        noise = float((f32[k].double() - g).abs().max())
        err = float((g - w).abs().max())
        assert err <= 2e-3 * scale + 1e-7 + noise, \
            f"{k}: {err} vs max|grad| {scale}, float32 noise {noise}"
    assert nonzero > 100


def test_full_step_parameters_after_two_steps(full_step):
    want, got = full_step["params"], full_step[("params", torch.float64)]
    f32 = full_step[("params", torch.float32)]
    assert set(got) == set(want)
    for k, v in got.items():
        noise = float((f32[k].double() - v).abs().max())
        err = float((v - want[k].double()).abs().max())
        assert err <= 1e-5 + noise, f"{k}: {err}, float32 noise {noise}"
