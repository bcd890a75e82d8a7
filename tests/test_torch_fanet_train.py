"""The port's TD2-FANet train step against the JAX package's, on the CPU, and the
TD2-FANet full recipe's pieces against what the JAX package reads from its YAML.

Same weights (JAX's FATD tree shapes with seeded numpy leaves, BatchNorms
drawn, through ``utils/from_jax.fatd_from_jax``), a 2-path ResNet-18 teacher
(``init_teacher``'s shapes, seeded numpy leaves, through ``teacher_from_jax``), the same numpy frames and
labels (some at the ignore label 250), dropout off on both sides (masks are
impl-defined), OHEM, KD, no aux term, AdaOptimizer across its warm-up, at
128x256 (layer4 and ffm_32 normalize over 8 values a channel). As
``tests/test_torch_train.py``: JAX with x64 (``make_loss_of`` +
``jax.value_and_grad`` + ``ada_optimizer``) against the port in float64 and
in float32 for two steps (pos_id 1, then 0): the loss and KD to rtol 1e-6 in
float64 and 1e-4 in float32; each gradient of the float64 port within 2e-3 x
max|gradient| of that tensor plus 1e-7 plus the port's own float32 noise on it
(|float32 - float64|); the parameters after two steps to 1e-5 plus that
noise. Every parameter of ``head_aux`` gets a zero gradient, as JAX's.

``td2_fa_full_recipe(device="cpu")``: the model config, the teacher config,
the OHEM loss's ``n_min`` and the optimizer's arguments against
``tdnet_tpu/utils/config.py`` on ``configs/td2_fa_cityscapes.yml``.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from tdnet_tpu.models.fanet_td import FATDConfig as JaxConfig
from tdnet_tpu.models.fanet_td import init_fatd as jax_init_fatd
from tdnet_tpu.models.teacher import TeacherConfig as JaxTeacherConfig
from tdnet_tpu.models.teacher import init_teacher as jax_init_teacher
from tdnet_tpu.train import loss as jloss
from tdnet_tpu.train.optim import ada_optimizer as jax_ada_optimizer
from tdnet_tpu.train.trainer import make_loss_of as jax_make_loss_of
from tdnet_tpu.utils import config as jconfig
from tdnet_tpu_torch.models import FATD, TeacherConfig, tdnet_config
from tdnet_tpu_torch.train import loss as tloss
from tdnet_tpu_torch.train.trainer import (TD2_FA_RECIPE_YAML, make_train_state, make_train_step,
                                           td2_fa_full_recipe)
from tdnet_tpu_torch.utils import config as tconfig
from tdnet_tpu_torch.utils.from_jax import fatd_from_jax, fatd_state_from_jax, teacher_from_jax
from tests.test_torch_fanet import randomized_bn
from tests.test_torch_train_bf16 import seeded_tree

IN_HW = (128, 256)
N_MIN = IN_HW[0] * IN_HW[1] // 16
OPT = dict(lr0=1e-2, momentum=0.9, wd=1e-4, warmup_steps=1, warmup_start_lr=1e-3, max_iter=4,
           power=0.9)


def fa_setup(seed: int = 11):
    """(JAX config, port config, FATD tree, teacher configs and tree, data)."""
    jcfg = JaxConfig(in_size=IN_HW)
    cfg = tdnet_config("td2_fa", in_size=IN_HW, streaming=False)
    tree = randomized_bn(seeded_tree(lambda k: jax_init_fatd(k, jcfg), seed), seed + 1)
    jtcfg = JaxTeacherConfig(nclass=19, backbone="resnet18", path_num=2)
    ttree = seeded_tree(lambda k: jax_init_teacher(k, jtcfg), seed + 2)
    rng = np.random.RandomState(seed + 3)
    frames = (rng.randn(2, 1, *IN_HW, 3) * 0.5).astype(np.float32)
    labels = rng.randint(0, 19, (1, *IN_HW))
    labels[:, :9] = 250
    return jcfg, cfg, tree, jtcfg, ttree, frames, labels


@pytest.fixture(scope="module")
def full_step():
    jcfg, cfg, tree, jtcfg, ttree, frames, labels = fa_setup()
    steps = (1, 0)
    rec = {"jax": []}
    with jax.enable_x64(True):
        f64 = lambda t: jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), t)
        params, tparams = f64(tree), f64(ttree)
        loss_of = jax_make_loss_of(jcfg, teacher_cfg=jtcfg, use_dropout=False, attn_impl="xla",
                                   loss_fn=lambda lg, lb: jloss.ohem_cross_entropy(
                                       lg, lb, n_min=N_MIN))
        vg = jax.jit(jax.value_and_grad(loss_of, has_aux=True))
        tx, _ = jax_ada_optimizer(params, **OPT)
        ostate = tx.init(params)
        update = jax.jit(lambda g, o, p, upd: (lambda u, o2: (optax.apply_updates(upd, u), o2))(
            *tx.update(g, o, p)))
        for pos in steps:
            (loss, aux), grads = vg(params, jnp.asarray(frames, jnp.float64),
                                    jnp.asarray(labels.astype(np.int32)), jnp.int32(pos),
                                    jax.random.PRNGKey(0), tparams)
            params, ostate = update(grads, ostate, params, aux["updated_params"])
            rec["jax"].append((float(loss), float(aux["kd"]), fatd_state_from_jax(grads, cfg)))
        rec["params"] = fatd_state_from_jax(params, cfg)

    step = make_train_step(use_dropout=False, loss_fn=lambda lg, lb: tloss.ohem_cross_entropy(
        lg, lb, n_min=N_MIN))
    for dt in (torch.float64, torch.float32):
        model = fatd_from_jax(tree, cfg).to(dt)
        teacher = teacher_from_jax(ttree, TeacherConfig(nclass=19, backbone="resnet18",
                                                        path_num=2)).to(dt)
        state = make_train_state(model, opt_kwargs=OPT)
        rec[dt] = []
        for pos in steps:
            m = step(state, torch.from_numpy(frames).to(dt), torch.from_numpy(labels), pos,
                     teacher)
            rec[dt].append((float(m["loss"]), float(m["kd"]),
                            {k: p.grad.clone() for k, p in model.named_parameters()}))
        rec[("params", dt)] = model.state_dict()
    return rec


@pytest.mark.parametrize("it", [0, 1])
def test_step_loss(full_step, it):
    (jl, jkd, _), (tl, tkd, _) = full_step["jax"][it], full_step[torch.float64][it]
    assert jkd > 0.0
    np.testing.assert_allclose(tl, jl, rtol=1e-6)
    np.testing.assert_allclose(tkd, jkd, rtol=1e-6)
    l32, kd32, _ = full_step[torch.float32][it]
    np.testing.assert_allclose([l32, kd32], [jl, jkd], rtol=1e-4)


@pytest.mark.parametrize("it", [0, 1])
def test_step_gradients(full_step, it):
    want, got = full_step["jax"][it][2], full_step[torch.float64][it][2]
    f32 = full_step[torch.float32][it][2]
    assert set(got) == {k for k in want if "running_" not in k} and len(got) > 200
    nonzero = 0
    for k, g in got.items():
        w = want[k].double()
        scale = float(w.abs().max())
        nonzero += scale > 1e-6
        noise = float((f32[k].double() - g).abs().max())
        err = float((g - w).abs().max())
        assert err <= 2e-3 * scale + 1e-7 + noise, \
            f"{k}: {err} vs max|grad| {scale}, float32 noise {noise}"
        if ".head_aux." in k:
            assert not g.any(), k
    assert nonzero > 200


def test_step_parameters_after_two_steps(full_step):
    want, got = full_step["params"], full_step[("params", torch.float64)]
    f32 = full_step[("params", torch.float32)]
    assert set(got) == set(want)
    for k, v in got.items():
        noise = float((f32[k].double() - v).abs().max())
        err = float((v - want[k].double()).abs().max())
        assert err <= 1e-5 + noise, f"{k}: {err}, float32 noise {noise}"


@pytest.fixture(scope="module")
def recipe():
    yml = jconfig.load_config(TD2_FA_RECIPE_YAML)
    yml["training"]["batch_size"] = 1
    state, step, teacher, frames, labels, loss_fn = td2_fa_full_recipe(device="cpu")
    return dict(yml=yml, state=state, teacher=teacher, frames=frames, labels=labels,
                loss_fn=loss_fn)


def test_recipe_model_and_teacher(recipe):
    got = recipe["state"].model
    assert isinstance(got, FATD)
    assert dataclasses.asdict(got.cfg) == dataclasses.asdict(jconfig.model_config_from_yaml(
        recipe["yml"]))
    assert (got.cfg.in_size, got.cfg.d_v, got.cfg.kv_stride, got.cfg.aux) == (
        (768, 1536), 256, 3, False)
    assert dataclasses.asdict(recipe["teacher"].cfg) == dataclasses.asdict(
        jconfig.teacher_config_from_yaml(recipe["yml"]))
    assert (recipe["teacher"].cfg.backbone, recipe["teacher"].cfg.path_num) == ("resnet101", 2)


def test_recipe_loss_optimizer_and_data(recipe):
    code = recipe["loss_fn"].__code__
    got = dict(zip(code.co_freevars, (c.cell_contents for c in recipe["loss_fn"].__closure__)))
    want_fn = jconfig.loss_fn_from_yaml(recipe["yml"], n_devices=1)
    want = dict(zip(want_fn.__code__.co_freevars,
                    (c.cell_contents for c in want_fn.__closure__)))
    assert got["n_min"] == want["n_min"] == 768 * 1536 // 16
    assert got["thresh"] == want["thresh"] == 0.7
    assert tconfig.opt_kwargs_from_yaml(recipe["yml"]) == jconfig.opt_kwargs_from_yaml(
        recipe["yml"])
    assert recipe["frames"].shape == (2, 1, 768, 1536, 3)
    assert recipe["labels"].shape == (1, 768, 1536)
    assert all(t.device == torch.device("cpu") for t in
               [recipe["frames"], *recipe["state"].model.parameters()])
