"""The port's training and validation entry points on the CPU: the metrics,
the eval step, the checkpoints, ``cli.train.train`` and ``cli.validate``,
against the JAX package where it has the same function.

A tiny Cityscapes-layout tree (``tests/test_torch_data.py:
write_cityscapes_tree``, 3 train and 2 val frames of 64x128, each with 6
predecessors) and the TD4-PSP18 YAML cut to a ResNet-10 student and teacher
at a 65x129 crop. The val clips are static scenes: validation draws its
predecessor gaps from an unseeded generator (``tdnet_tpu/cli/validate.py``
builds its dataset without a seed), so only a static clip gives two
validations the same input.

Tolerances: the confusion matrices and scores of the port's own runs are
equal; the port against JAX: predictions equal in all but a share of pixels
printed and held at or below 1e-3 (f32 logits summed in another order can
swap two near-equal classes; at these sizes 0 to 6e-5 of the pixels differ),
mean IoU within 1e-3.
"""

import copy
import logging
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from tdnet_tpu.models.tdnet import TDNetConfig as JaxConfig
from tdnet_tpu.models.tdnet import init_tdnet as jax_init_tdnet
from tdnet_tpu.train import metrics as jax_metrics
from tdnet_tpu.train import trainer as jax_trainer
from tdnet_tpu.utils import checkpoint as jax_ckpt
from tdnet_tpu_torch.cli import train as cli_train
from tdnet_tpu_torch.cli import validate as cli_validate
from tdnet_tpu_torch.models import tdnet_config
from tdnet_tpu_torch.train import trainer
from tdnet_tpu_torch.train.metrics import AverageMeter, RunningScore
from tdnet_tpu_torch.utils import checkpoint as ckpt
from tdnet_tpu_torch.utils.config import opt_kwargs_from_yaml
from tdnet_tpu_torch.utils.from_jax import tdnet_from_jax
from tests.test_torch_data import write_cityscapes_tree
from tests.test_torch_modules import _randomize_bn

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CROP = [65, 129]
PRED_SHARE = 1e-3


def tiny_cfg(root, **training):
    """configs/td4_psp18_cityscapes.yml with a ResNet-10 student and teacher,
    the crop and scale 65x129, one reading thread."""
    cfg = yaml.safe_load(open(os.path.join(REPO, "configs", "td4_psp18_cityscapes.yml")))
    cfg["model"]["backbone"] = cfg["teacher"]["backbone"] = "resnet10"
    cfg["teacher"]["teacher_model"] = os.path.join(str(root), "no_teacher.pkl")
    cfg["data"]["path"] = str(root)
    tr = cfg["training"]
    tr.update(n_workers=1, train_iters=4, batch_size=1, val_interval=2, print_interval=1,
              ckpt_interval=2, resume=os.path.join(str(root), "no_student.pkl"))
    tr["train_augmentations"].update(scale=CROP, rcrop=CROP, rscale=[0.75, 1.0, 1.25])
    tr.update(training)
    cfg["validating"].update(n_workers=1, batch_size=2)
    cfg["validating"]["val_augmentations"]["scale"] = CROP
    return cfg


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return write_cityscapes_tree(tmp_path_factory.mktemp("cityscapes"))


@pytest.fixture(scope="module")
def run(tree, tmp_path_factory):
    """4 CPU steps of ``cli.train.train`` and the files they leave."""
    logdir = str(tmp_path_factory.mktemp("run"))
    stats = {}
    state, best = cli_train.train(tiny_cfg(tree), logging.getLogger("test"), logdir,
                                  device="cpu", stats=stats)
    return types.SimpleNamespace(logdir=logdir, state=state, best=best, stats=stats)


def _jax_net(seed=0):
    jcfg = JaxConfig(nclass=19, backbone="resnet10", path_num=4, in_size=tuple(CROP),
                     kv_stride=3, aux=True)
    params = _randomize_bn(jax_init_tdnet(jax.random.PRNGKey(seed), jcfg),
                           np.random.RandomState(seed))
    return jcfg, params


# --- metrics ------------------------------------------------------------------

def test_running_score_matches_jax():
    rng = np.random.RandomState(0)
    ours, theirs = RunningScore(19), jax_metrics.RunningScore(19)
    for _ in range(3):
        labels = rng.randint(0, 19, (2, 33, 47))
        labels[:, :5] = 250
        preds = np.where(rng.rand(2, 33, 47) < 0.6, labels % 19, rng.randint(0, 19, (2, 33, 47)))
        ours.update(torch.from_numpy(labels), torch.from_numpy(preds))
        theirs.update(jnp.asarray(labels), jnp.asarray(preds))
    assert ours.confusion.dtype == torch.int64
    np.testing.assert_array_equal(ours.confusion_matrix(), np.asarray(theirs.confusion))
    (s1, c1), (s2, c2) = ours.get_scores(), theirs.get_scores()
    assert list(s1) == list(s2) == ["Overall Acc: \t", "Mean Acc : \t", "FreqW Acc : \t",
                                    "Mean IoU : \t"]
    for k in s1:
        np.testing.assert_allclose(s1[k], s2[k], rtol=1e-6)
    np.testing.assert_allclose([c1[i] for i in range(19)], [c2[i] for i in range(19)],
                               rtol=1e-6)
    meter = AverageMeter()
    for v in (1.0, 2.0, 6.0):
        meter.update(v)
    assert meter.avg == 3.0 and meter.count == 3


def test_running_score_counts_past_float32():
    """int64 counts stay exact where JAX's float32 matrix stops (2^24 a cell)."""
    score = RunningScore(2)
    ones = torch.ones(1 << 24, dtype=torch.int64)
    score.update(ones, ones)
    score.update(ones[:1], ones[:1])
    assert score.confusion_matrix()[1, 1] == (1 << 24) + 1


# --- the eval step --------------------------------------------------------------

def _pred_share(a, b):
    share = float(np.mean(np.asarray(a) != np.asarray(b)))
    print(f"predictions differing: {share:.6f}")
    return share


def test_eval_step_matches_jax():
    jcfg, params = _jax_net()
    cfg = tdnet_config("td4_psp", in_size=tuple(CROP), streaming=False, backbone="resnet10")
    model = tdnet_from_jax(params, cfg).train()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    frames = np.random.RandomState(1).randn(4, 2, *CROP, 3).astype(np.float32)
    jax_step = jax_trainer.make_eval_step(jcfg)
    step = trainer.make_eval_step()
    for pos_id in range(4):
        want = np.asarray(jax_step(params, jnp.asarray(frames), jnp.int32(pos_id)))
        got = step(model, torch.from_numpy(frames), pos_id)
        assert got.shape == want.shape == (2, *CROP)
        assert _pred_share(got.numpy(), want) <= PRED_SHARE
    assert model.training
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k


# --- cli.train ------------------------------------------------------------------

def test_train_writes_the_best_model_and_the_state(run):
    assert run.state.it == 4
    assert len(run.stats["losses"]) == 4 and np.all(np.isfinite(run.stats["losses"]))
    best = os.path.join(run.logdir, "td4_psp_cityscapes_best_model.pkl")
    assert ckpt.is_zip(best)
    payload = torch.load(best, weights_only=True)
    assert set(payload) == {"epoch", "model_state", "best_iou"}
    assert payload["best_iou"] == pytest.approx(run.best)
    assert set(payload["model_state"]) == set(run.state.model.state_dict())
    saved = torch.load(os.path.join(run.logdir, "state_latest.pkl"), weights_only=True)
    assert saved["it"] == 4 and saved["seed"] == cli_train.SEED
    for k, v in run.state.model.state_dict().items():
        assert torch.equal(saved["model_state"][k], v), k


def test_train_resumes_where_it_stopped(run, tree, tmp_path):
    latest = os.path.join(run.logdir, "state_latest.pkl")
    cfg = tiny_cfg(tree, train_iters=6)
    state = trainer.make_train_state(copy.deepcopy(run.state.model),
                                     opt_kwargs=opt_kwargs_from_yaml(cfg))
    ckpt.load_train_state(latest, state)
    saved = torch.load(latest, weights_only=True)
    assert state.it == 4
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, saved["model_state"][k]), k
    for a, b in zip(state.optimizer.state_dict()["state"].values(),
                    saved["optimizer_state"]["state"].values()):
        assert torch.equal(a["momentum_buffer"], b["momentum_buffer"])
    stats = {}
    resumed, _ = cli_train.train(cfg, logging.getLogger("test"), str(tmp_path), max_steps=2,
                                 resume_state=latest, device="cpu", stats=stats)
    assert resumed.it == 6 and len(stats["losses"]) == 2
    assert torch.load(str(tmp_path / "state_latest.pkl"), weights_only=True)["it"] == 6


def test_train_halts_on_a_poisoned_loss(tree, tmp_path, monkeypatch):
    real = trainer.make_train_step

    def poisoned(**kw):
        step = real(**kw)

        def run_step(*a, **k):
            out = step(*a, **k)
            out["loss"] = out["loss"] * float("nan")
            return out
        return run_step
    monkeypatch.setattr(trainer, "make_train_step", poisoned)
    with pytest.raises(FloatingPointError, match="non-finite training loss at iter 1"):
        cli_train.train(tiny_cfg(tree), logging.getLogger("test"), str(tmp_path), device="cpu")
    dump = torch.load(str(tmp_path / "state_nan_abort.pkl"), weights_only=True)
    assert dump["it"] == 1


def test_train_cli_refuses_what_is_not_ported(tree, tmp_path):
    with pytest.raises(NotImplementedError, match="multi-GPU not ported yet"):
        cli_train.main(["--config", "unused.yml", "--path_parallel", "2"])
    (tmp_path / "psp18.pkl").write_bytes(b"PK")
    cfg = tiny_cfg(tree, resume=str(tmp_path / "psp18.pkl"))
    with pytest.raises(NotImplementedError, match="not ported"):
        cli_train.train(cfg, logging.getLogger("test"), str(tmp_path), device="cpu")


# --- cli.validate -----------------------------------------------------------------

def _args(**kw):
    return types.SimpleNamespace(**{"measure_time": False, "max_batches": None,
                                    "device": "cpu", "native": True, "quant": None, **kw})


def test_validate_repeats_the_runs_own_validation(run, tree):
    """The best checkpoint through ``cli.validate`` gives the confusion matrix
    the run's validation gave those weights."""
    cfg = tiny_cfg(tree)
    cfg["validating"]["resume"] = os.path.join(run.logdir, "td4_psp_cityscapes_best_model.pkl")
    stats = {}
    score, _ = cli_validate.validate(cfg, _args(), stats=stats)
    np.testing.assert_array_equal(stats["confusion"], run.stats["best_confusion"])
    assert score["Mean IoU : \t"] == run.best


def test_validate_matches_jax_on_its_best_model(tree, tmp_path, monkeypatch):
    """The slice as a whole: JAX's ``save_best`` writes its pickle; JAX's
    ``validate()`` and the port's read it and score the same tree."""
    jcfg, params = _jax_net(seed=3)
    path = jax_ckpt.save_best(str(tmp_path), "td4_psp", "cityscapes", step=0, params=params,
                              best_iou=0.0)
    cfg = tiny_cfg(tree)
    cfg["validating"]["resume"] = path
    preds = {"jax": [], "port": []}

    def recorder(module, name):
        real = module.make_eval_step

        def make(*a, **kw):
            step = real(*a, **kw)

            def call(*sa):
                out = step(*sa)
                preds[name].append(np.asarray(out))
                return out
            return call
        monkeypatch.setattr(module, "make_eval_step", make)
    recorder(jax_trainer, "jax")
    recorder(trainer, "port")
    from tdnet_tpu.cli.validate import validate as jax_validate
    want, _ = jax_validate(cfg, _args())
    got, _ = cli_validate.validate(cfg, _args())
    assert len(preds["jax"]) == len(preds["port"]) == 1
    assert _pred_share(preds["port"][0], preds["jax"][0]) <= PRED_SHARE
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-3, err_msg=k)


def test_jax_best_model_carries_over(tmp_path):
    """A JAX ``*_best_model.pkl`` (a pickle of numpy arrays) through the port's
    loader: its predictions are JAX's ``make_eval_step``'s on the file."""
    import pickle
    jcfg, params = _jax_net(seed=5)
    path = jax_ckpt.save_best(str(tmp_path), "td4_psp", "cityscapes", step=7, params=params,
                              best_iou=0.5)
    assert not ckpt.is_zip(path)
    with open(path, "rb") as f:
        saved = pickle.load(f)
    cfg = tdnet_config("td4_psp", in_size=tuple(CROP), streaming=False, backbone="resnet10")
    model = cli_validate.load_weights(path, cfg, "cpu")
    frames = np.random.RandomState(6).randn(4, 1, *CROP, 3).astype(np.float32)
    jax_step = jax_trainer.make_eval_step(jcfg)
    for pos_id in (0, 3):
        want = jax_step(saved["model_state"], jnp.asarray(frames), jnp.int32(pos_id))
        got = trainer.make_eval_step()(model, torch.from_numpy(frames), pos_id)
        assert _pred_share(got.numpy(), want) <= PRED_SHARE


def test_validate_refuses_a_reference_checkpoint(tree, tmp_path):
    ref = tmp_path / "td4-psp18.pkl"
    torch.save({"state_dict": {"module.pretrained.conv1.weight": torch.zeros(1)}}, str(ref))
    cfg = tiny_cfg(tree)
    cfg["validating"]["resume"] = str(ref)
    with pytest.raises(NotImplementedError, match="reference checkpoints is not ported"):
        cli_validate.validate(cfg, _args())


# --- no image library ---------------------------------------------------------------

def test_data_pipeline_and_train_without_image_libraries(tmp_path):
    """PIL, imageio and cv2 blocked in a fresh interpreter that imports nothing
    of the JAX package: a tree is written, read, augmented and batched by the
    port, and two CPU steps of ``cli.train.train`` run on it."""
    code = f"""
import logging, os, sys
for name in ("PIL", "imageio", "cv2"):
    sys.modules[name] = None
import numpy as np, yaml
from tdnet_tpu_torch.cli.train import train
from tdnet_tpu_torch.data import get_loader
from tdnet_tpu_torch.data.augment import get_composed_augmentations
from tdnet_tpu_torch.data.cityscapes import ClipBatcher
from tdnet_tpu_torch.data.png import write_png
root, rng = {str(tmp_path / "tree")!r}, np.random.RandomState(0)
for split, n in (("train", 2), ("val", 1)):
    for i in range(n):
        stem = f"city_{{i:06d}}_{{19:06d}}"
        for base, name, img in (
                ("leftImg8bit", stem + "_leftImg8bit.png", rng.randint(0, 256, (64, 128, 3))),
                ("gtFine", stem + "_gtFine_labelIds.png", rng.randint(0, 34, (64, 128)))):
            os.makedirs(os.path.join(root, base, split, "city"), exist_ok=True)
            write_png(os.path.join(root, base, split, "city", name), img.astype(np.uint8))
        for k in range(7):
            d = os.path.join(root, "leftImg8bit_sequence", split, "city")
            os.makedirs(d, exist_ok=True)
            write_png(os.path.join(d, f"city_{{i:06d}}_{{19 - k:06d}}_leftImg8bit.png"),
                      rng.randint(0, 256, (64, 128, 3)).astype(np.uint8))
cfg = yaml.safe_load(open("configs/td4_psp18_cityscapes.yml"))
cfg["model"]["backbone"] = cfg["teacher"]["backbone"] = "resnet10"
cfg["data"]["path"] = root
cfg["training"].update(n_workers=2, train_iters=2, batch_size=1, val_interval=2,
                       print_interval=1)
cfg["training"]["train_augmentations"].update(scale=[65, 129], rcrop=[65, 129])
cfg["validating"].update(n_workers=1, batch_size=1)
cfg["validating"]["val_augmentations"]["scale"] = [65, 129]
ds = get_loader("cityscapes")(root, "train", get_composed_augmentations(
    cfg["training"]["train_augmentations"], seed=0), path_num=4, seed=0)
frames, labels = next(iter(ClipBatcher(ds, 2, num_workers=2)))
assert frames.shape == (4, 2, 65, 129, 3) and labels.shape == (2, 65, 129), frames.shape
state, _ = train(cfg, logging.getLogger("t"), {str(tmp_path)!r}, device="cpu")
assert state.it == 2
bad = [m for m in ("PIL", "imageio", "cv2", "jax") if sys.modules.get(m) is not None]
assert not bad, bad
print("ok")
"""
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0 and res.stdout.strip().endswith("ok"), res.stderr[-3000:]
