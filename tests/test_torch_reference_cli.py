"""The training and validation CLIs on the reference's checkpoints, against
the JAX package's.

The tiny Cityscapes-layout tree and YAML of ``tests/test_torch_train_cli.py``;
reference files from seeded port models (``chip_smoke.reference_state``,
``write_reference``), as in ``tests/test_torch_reference_checkpoints.py``.
``cli.train`` with ``training.resume`` and ``teacher.teacher_model``: the
students and the teacher before step 1 bitwise JAX's surgery's (the parts it
leaves, the port's own seeded init); without ``resume``, the TD2-PSP50 YAML's
deep-stem students take the encoding zoo's ResNet-50 from the backbone store,
never torchvision's 7x7-stem one; ``cli.validate`` on a reference best model: its confusion
matrix equal to JAX ``cli.validate``'s on the same file.
"""

import logging
import os
import types

import numpy as np
import pytest
import torch
import yaml

import chip_smoke
from tdnet_tpu.models.teacher import TeacherConfig as JaxTeacherConfig
from tdnet_tpu.train import metrics as jax_metrics
from tdnet_tpu.utils import surgery as jax_surgery
from tdnet_tpu_torch.cli import train as cli_train
from tdnet_tpu_torch.cli import validate as cli_validate
from tdnet_tpu_torch import models
from tdnet_tpu_torch.models import init_tdnet, tdnet_config
from tdnet_tpu_torch.train import trainer
from tdnet_tpu_torch.utils import model_store
from tdnet_tpu_torch.utils.config import model_config_from_yaml
from tdnet_tpu_torch.utils.from_jax import teacher_state_from_jax
from tests.test_torch_data import write_cityscapes_tree
from tests.test_torch_reference_checkpoints import (IN, assert_same, cache_file, imported,
                                                    jax_cfg, numpy_sd, psp_source, td_model)
from tests.test_torch_train_cli import REPO, tiny_cfg


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return write_cityscapes_tree(tmp_path_factory.mktemp("cityscapes"))


def test_train_bootstraps_from_reference_sources(tree, tmp_path, monkeypatch):
    """``training.resume`` a PSPNet-10 source, ``teacher_model`` a PSPNet-50 one
    (a ResNet-50 teacher: its group convs take the source's 512-wide head): the
    students and the teacher before step 1 are JAX's surgery's."""
    _, student_src = psp_source("resnet10", seed=21)
    _, teacher_src = psp_source("resnet50", seed=22)
    files = {}
    for name, sd in (("psp10", student_src), ("psp50", teacher_src)):
        files[name] = str(tmp_path / f"{name}.pkl")
        chip_smoke.write_reference(files[name], sd)
    cfg = tiny_cfg(tree, resume=files["psp10"])
    cfg["teacher"].update(backbone="resnet50", teacher_model=files["psp50"])
    seen = {}
    real_state, real_freeze = trainer.make_train_state, models.freeze

    def record_state(model, **kw):
        seen["model"] = {k: v.clone() for k, v in model.state_dict().items()}
        return real_state(model, **kw)

    def record_freeze(teacher):
        seen["teacher"] = {k: v.clone() for k, v in teacher.state_dict().items()}
        return real_freeze(teacher)
    monkeypatch.setattr(trainer, "make_train_state", record_state)
    monkeypatch.setattr(models, "freeze", record_freeze)
    stats = {}
    cli_train.train(cfg, logging.getLogger("test"), str(tmp_path), max_steps=1, device="cpu",
                    stats=stats)
    assert np.all(np.isfinite(stats["losses"]))
    mcfg = tdnet_config("td4_psp", in_size=IN, streaming=False, backbone="resnet10")
    jax_out = jax_surgery.student_bootstrap_from_psp_checkpoint(
        numpy_sd(student_src), jax_cfg(mcfg), {"paths": {"aux": None}, "atn": None})
    want = imported(jax_out, ["backbone", "psp", "aux", "head"], 4)
    fresh = init_tdnet(mcfg, torch.Generator().manual_seed(cli_train.SEED)).state_dict()
    want.update({k: v for k, v in fresh.items() if k not in want})
    assert_same(seen["model"], want)
    jax_teacher = jax_surgery.teacher_from_psp_checkpoint(
        numpy_sd(teacher_src), JaxTeacherConfig(backbone="resnet50", path_num=4))
    assert_same(seen["teacher"], teacher_state_from_jax(jax_teacher))


def offline_store(tmp_path, monkeypatch):
    """The store's caches and mirrors directories of this test; its cache."""
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    monkeypatch.setenv("TORCH_HOME", str(tmp_path / "torch_home"))
    nowhere = f"file://{tmp_path}/no_mirror"
    monkeypatch.setattr(model_store, "TORCHVISION_URL", nowhere + "/{name}-{sha}.pth")
    monkeypatch.setenv("ENCODING_REPO", nowhere + "/")
    return tmp_path / "torch_home" / "hub" / "checkpoints"


def test_td2_yaml_trains_past_torchvisions_resnet50(tree, tmp_path, monkeypatch):
    """The TD2-PSP50 YAML's model (a deep-stem ResNet-50 a path) with no
    ``resume``, and torchvision's ``resnet50-<its sha256 prefix>.pth`` (a 7x7
    stem) in the cache: not the students' backbone, so the run trains, its
    backbones at their seeded init."""
    cache_file(offline_store(tmp_path, monkeypatch), "resnet50",
               {"conv1.weight": torch.ones(64, 3, 7, 7), "bn1.weight": torch.ones(64)}, "sha256")
    td2 = yaml.safe_load(open(os.path.join(REPO, "configs", "td2_psp50_cityscapes.yml")))
    cfg = tiny_cfg(tree)
    cfg["model"] = td2["model"]
    cfg["teacher"] = dict(td2["teacher"], backbone="resnet10",
                          teacher_model=str(tmp_path / "no_teacher.pkl"))
    seen = {}
    real_state = trainer.make_train_state

    def record_state(model, **kw):
        seen["model"] = {k: v.clone() for k, v in model.state_dict().items()}
        return real_state(model, **kw)
    monkeypatch.setattr(trainer, "make_train_state", record_state)
    stats = {}
    cli_train.train(cfg, logging.getLogger("test"), str(tmp_path), max_steps=1, device="cpu",
                    stats=stats)
    assert np.all(np.isfinite(stats["losses"]))
    mcfg = model_config_from_yaml(cfg, nclass=19, streaming=False)
    assert mcfg.backbone == "resnet50" and mcfg.path_num == 2
    assert_same(seen["model"],
                init_tdnet(mcfg, torch.Generator().manual_seed(cli_train.SEED)).state_dict())


def test_deep_stem_backbones_come_from_the_zoo(tmp_path, monkeypatch):
    """With the zoo's ``resnet50s-<its sha1 prefix>.pth`` beside torchvision's
    ``resnet50`` in the cache, ``cli.train``'s ``imagenet_backbones`` gives
    every path of a TD2-PSP50 the zoo file's backbone."""
    cache = offline_store(tmp_path, monkeypatch)
    net, bcfg = chip_smoke.seeded_model("resnet50", None, seed=23)
    cache_file(cache, "resnet50s", chip_smoke.reference_state(net, bcfg, "torchvision"), "sha1")
    cache_file(cache, "resnet50", {"conv1.weight": torch.ones(64, 3, 7, 7)}, "sha256")
    mcfg = tdnet_config("td2_psp", in_size=IN, streaming=False, backbone="resnet50")
    model = init_tdnet(mcfg, torch.Generator().manual_seed(cli_train.SEED))
    want = dict(model.state_dict())
    want.update({f"paths.{p}.backbone.{k}": v for k, v in net.state_dict().items()
                 for p in range(mcfg.path_num)})
    assert cli_train.imagenet_backbones(model, "resnet50")
    assert_same(model.state_dict(), want)


def test_validate_reads_a_reference_best_model_as_jax_does(tree, tmp_path, monkeypatch):
    model, mcfg = td_model("td4_psp", backbone="resnet10", training=True, seed=8)
    path = str(tmp_path / "td4_psp_cityscapes_best_model.pkl")
    chip_smoke.write_reference(path, chip_smoke.reference_state(model, mcfg, "training"))
    cfg = tiny_cfg(tree)
    cfg["validating"]["resume"] = path
    scores = []

    class Recorded(jax_metrics.RunningScore):
        def __init__(self, n):
            super().__init__(n)
            scores.append(self)
    monkeypatch.setattr(jax_metrics, "RunningScore", Recorded)
    from tdnet_tpu.cli.validate import validate as jax_validate
    args = types.SimpleNamespace(measure_time=False, max_batches=None, device="cpu",
                                 native=False, quant=None)
    jax_validate(cfg, args)
    stats = {}
    cli_validate.validate(cfg, args, stats=stats)
    np.testing.assert_array_equal(stats["confusion"], np.asarray(scores[0].confusion))
    assert stats["confusion"].sum() > 0
