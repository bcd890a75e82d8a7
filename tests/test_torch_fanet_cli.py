"""The training and validation CLIs on a TD2-FANet, against the JAX package's.

The tiny Cityscapes-layout tree and YAML of ``tests/test_torch_train_cli.py``
with ``configs/td2_fa_cityscapes.yml``'s model section (two FANet-18 paths)
and a 2-path ResNet-10 teacher; reference files from seeded port FATDs
(``chip_smoke.reference_state``).

- ``cli.train`` with ``training.resume`` a single-path FANet file: the model
  before step 1 is JAX's ``fanet_bootstrap_from_checkpoint`` of it bitwise
  (the parts it leaves, the port's own seeded init), the losses finite;
- ``cli.train`` without ``resume``: the backbone store is never asked (as
  ``tdnet_tpu/cli/train.py:98`` skips it for FANet), the model at its seeded
  init;
- ``cli.validate`` on a td2_fa best model in the reference's naming: its
  confusion matrix JAX ``cli.validate``'s on the same file.
"""

import logging
import os
import types

import numpy as np
import pytest
import torch
import yaml

import chip_smoke
from tdnet_tpu.train import metrics as jax_metrics
from tdnet_tpu.utils import torch_import as jax_import
from tdnet_tpu_torch.cli import train as cli_train
from tdnet_tpu_torch.cli import validate as cli_validate
from tdnet_tpu_torch.models import FATD, init_fatd
from tdnet_tpu_torch.train import trainer
from tdnet_tpu_torch.utils.config import model_config_from_yaml
from tests.test_torch_data import write_cityscapes_tree
from tests.test_torch_fanet_checkpoints import PARTS, jax_cfg
from tests.test_torch_reference_checkpoints import assert_same, imported, numpy_sd
from tests.test_torch_train_cli import CROP, REPO, tiny_cfg


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return write_cityscapes_tree(tmp_path_factory.mktemp("cityscapes"))


def fa_cfg(tree, **training):
    cfg = tiny_cfg(tree, **training)
    fa = yaml.safe_load(open(os.path.join(REPO, "configs", "td2_fa_cityscapes.yml")))
    cfg["model"] = fa["model"]
    cfg["teacher"].update(path_num=2)
    return cfg


def recorded_start(monkeypatch) -> dict:
    seen = {}
    real_state = trainer.make_train_state

    def record_state(model, **kw):
        seen["model"] = {k: v.clone() for k, v in model.state_dict().items()}
        seen["type"] = type(model)
        return real_state(model, **kw)
    monkeypatch.setattr(trainer, "make_train_state", record_state)
    return seen


def test_train_bootstraps_from_a_fanet_source(tree, tmp_path, monkeypatch):
    mcfg = model_config_from_yaml(fa_cfg(tree), nclass=19, streaming=False)
    source, _ = chip_smoke.seeded_model("td2-fa", mcfg.in_size, seed=31)
    src = chip_smoke.reference_state(source, mcfg, "fanet_source")
    path = str(tmp_path / "fanet18.pkl")
    chip_smoke.write_reference(path, src)
    seen = recorded_start(monkeypatch)
    stats = {}
    cli_train.train(fa_cfg(tree, resume=path), logging.getLogger("test"), str(tmp_path),
                    max_steps=1, device="cpu", stats=stats)
    assert np.all(np.isfinite(stats["losses"])) and len(stats["losses"]) == 1
    assert seen["type"] is FATD and mcfg.in_size == tuple(CROP)
    jax_out = jax_import.fanet_bootstrap_from_checkpoint(numpy_sd(src), jax_cfg(mcfg),
                                                         {"paths": {}, "atn": None})
    want = imported(jax_out, PARTS, mcfg.path_num)
    fresh = init_fatd(mcfg, torch.Generator().manual_seed(cli_train.SEED)).state_dict()
    want.update({k: v for k, v in fresh.items() if k not in want})
    assert_same(seen["model"], want)


def test_train_without_resume_asks_no_store(tree, tmp_path, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the backbone store was asked for a FANet")
    monkeypatch.setattr(cli_train, "imagenet_backbones", refuse)
    seen = recorded_start(monkeypatch)
    cfg = fa_cfg(tree)
    stats = {}
    cli_train.train(cfg, logging.getLogger("test"), str(tmp_path), max_steps=1, device="cpu",
                    stats=stats)
    assert np.all(np.isfinite(stats["losses"]))
    mcfg = model_config_from_yaml(cfg, nclass=19, streaming=False)
    assert_same(seen["model"],
                init_fatd(mcfg, torch.Generator().manual_seed(cli_train.SEED)).state_dict())


def test_validate_reads_a_td2_fa_best_model_as_jax_does(tree, tmp_path, monkeypatch):
    cfg = fa_cfg(tree)
    mcfg = model_config_from_yaml(cfg, nclass=19, in_size=tuple(CROP), streaming=False)
    model, _ = chip_smoke.seeded_model("td2-fa", mcfg.in_size, seed=8)
    path = str(tmp_path / "td2_fa_cityscapes_best_model.pkl")
    chip_smoke.write_reference(path, chip_smoke.reference_state(model, mcfg, "td2_fa"))
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
