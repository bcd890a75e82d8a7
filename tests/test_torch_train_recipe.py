"""The full recipes' pieces (``train/trainer.py:full_recipe``) against what the JAX
package reads from the same YAML, built on the CPU (``device="cpu"``, no step).

TD2-PSP50 (``configs/td2_psp50_cityscapes.yml``: ResNet-50, 2 paths, projected
before pooling, a 2-path ResNet-101 teacher, OHEM thresh 0.7) and TD4-PSP18
(``configs/td4_psp18_cityscapes.yml``), at batch 1 as the recipes run: the
model config, the teacher config, the OHEM loss's ``n_min`` and ``thresh``,
the optimizer's arguments and the data's shapes and device.
"""

import dataclasses

import pytest
import torch

from tdnet_tpu.utils import config as jconfig
from tdnet_tpu_torch.train.trainer import (RECIPE_YAML, TD2_RECIPE_YAML, td2_full_recipe,
                                           td4_full_recipe)
from tdnet_tpu_torch.utils import config as tconfig

RECIPES = {"td2-psp50": (td2_full_recipe, TD2_RECIPE_YAML),
           "td4-psp18": (td4_full_recipe, RECIPE_YAML)}


def _closure(fn) -> dict:
    """The names a function closes over, with their values."""
    return dict(zip(fn.__code__.co_freevars, (c.cell_contents for c in fn.__closure__)))


@pytest.fixture(scope="module", params=list(RECIPES))
def recipe(request):
    build, path = RECIPES[request.param]
    yml = jconfig.load_config(path)
    yml["training"]["batch_size"] = 1
    state, step, teacher, frames, labels, loss_fn = build(device="cpu")
    return dict(arch=request.param, yml=yml, state=state, teacher=teacher, frames=frames,
                labels=labels, loss_fn=loss_fn)


def test_model_config(recipe):
    got = recipe["state"].model.cfg
    assert dataclasses.asdict(got) == dataclasses.asdict(jconfig.model_config_from_yaml(
        recipe["yml"]))
    if recipe["arch"] == "td2-psp50":
        assert (got.backbone, got.path_num, got.pool_before_proj, got.kv_stride, got.aux,
                got.in_size) == ("resnet50", 2, False, 3, True, (769, 1537))


def test_teacher_config(recipe):
    got = recipe["teacher"].cfg
    assert dataclasses.asdict(got) == dataclasses.asdict(jconfig.teacher_config_from_yaml(
        recipe["yml"]))
    assert got.backbone == "resnet101" and got.path_num == recipe["state"].model.cfg.path_num


def test_loss_n_min_and_thresh(recipe):
    got = _closure(recipe["loss_fn"])
    want = _closure(jconfig.loss_fn_from_yaml(recipe["yml"], n_devices=1))
    assert got["n_min"] == want["n_min"] == 769 * 1537 // 16
    assert got["thresh"] == want["thresh"] == 0.7
    assert got["ignore_index"] == want["ignore_index"] == 250


def test_optimizer_kwargs(recipe):
    want = jconfig.opt_kwargs_from_yaml(recipe["yml"])
    assert tconfig.opt_kwargs_from_yaml(recipe["yml"]) == want
    opt, schedule = recipe["state"].optimizer, recipe["state"].schedule
    assert [g["weight_decay"] for g in opt.param_groups] == [want["wd"], 0.0]
    assert all(g["momentum"] == want["momentum"] for g in opt.param_groups)
    assert schedule(0) == pytest.approx(want["warmup_start_lr"], rel=1e-6)
    assert schedule(want["warmup_steps"]) == pytest.approx(want["lr0"], rel=1e-5)


def test_data_on_the_requested_device(recipe):
    p = recipe["state"].model.cfg.path_num
    assert recipe["frames"].shape == (p, 1, 769, 1537, 3)
    assert recipe["labels"].shape == (1, 769, 1537)
    tensors = [recipe["frames"], recipe["labels"], *recipe["state"].model.parameters(),
               *recipe["teacher"].parameters()]
    assert all(t.device == torch.device("cpu") for t in tensors)
