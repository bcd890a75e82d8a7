"""Checkpoints and run management (``tdnet_tpu/utils/checkpoint.py``).

- ``save_best``: the reference's best-mIoU checkpoint (Training/train.py:
  136-146): ``{arch}_{dataset}_best_model.pkl`` holding ``epoch``,
  ``model_state`` (the student's state dict, BN buffers included) and
  ``best_iou``;
- ``save_train_state`` / ``load_train_state``: the whole train state (the
  model's state dict, the optimizer's state, ``it`` and ``seed``) to resume a
  run where it stopped;
- ``load_checkpoint``: a file's payload, told apart by its first bytes: the
  port's own files are torch's zip format (``PK``) and load with
  ``torch.load(weights_only=True)``; the JAX package's are a raw pickle of
  numpy arrays.

Every file is written to a temporary name and moved into place
(``os.replace``), so a crash never leaves a half-written checkpoint. The JAX
package's Orbax backend (``ckpt_backend: orbax``) writes the same torch file
here; its asynchronous write is not ported.
"""

from __future__ import annotations

import datetime
import logging
import os
import pickle
import random

import torch

ZIP_MAGIC = b"PK"


def _save(path: str, payload) -> None:
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def _host_state(module: torch.nn.Module) -> dict[str, torch.Tensor]:
    return {k: v.detach().cpu().clone() for k, v in module.state_dict().items()}


def save_best(logdir: str, arch: str, dataset: str, *, step: int, model: torch.nn.Module,
              best_iou: float) -> str:
    """The reference-compatible best checkpoint (name and payload keys)."""
    path = os.path.join(logdir, f"{arch}_{dataset}_best_model.pkl")
    _save(path, {"epoch": step + 1, "model_state": _host_state(model),
                 "best_iou": float(best_iou)})
    return path


def save_train_state(path: str, state) -> None:
    """``state`` (``train.trainer.TrainState``) -> a file ``load_train_state``
    restores bit for bit."""
    _save(path, {"model_state": _host_state(state.model),
                 "optimizer_state": state.optimizer.state_dict(),
                 "it": int(state.it), "seed": int(state.seed)})


def is_zip(path: str) -> bool:
    with open(path, "rb") as f:
        return f.read(2) == ZIP_MAGIC


def load_checkpoint(path: str):
    """The payload of ``path``: torch's zip format through
    ``torch.load(weights_only=True)`` (tensors on the CPU), else a pickle."""
    if is_zip(path):
        return torch.load(path, map_location="cpu", weights_only=True)
    with open(path, "rb") as f:
        return pickle.load(f)


def load_train_state(path: str, state) -> None:
    """Restore ``save_train_state``'s file into ``state`` in place: the model's
    tensors, the optimizer's momentum, ``it`` and ``seed``."""
    saved = load_checkpoint(path)
    state.model.load_state_dict(saved["model_state"])
    state.optimizer.load_state_dict(saved["optimizer_state"])
    state.it = int(saved["it"])
    state.seed = int(saved["seed"])


def make_run_dir(config_path: str, base: str = "runs") -> str:
    """runs/<config-stem>/<random-id>/ with a copy of the config
    (reference train.py:165-175)."""
    import shutil
    stem = os.path.basename(config_path)
    stem = stem[:-4] if stem.endswith(".yml") else os.path.splitext(stem)[0]
    logdir = os.path.join(base, stem, str(random.randint(1, 100000)))
    os.makedirs(logdir, exist_ok=True)
    shutil.copy(config_path, logdir)
    return logdir


def get_logger(logdir: str) -> logging.Logger:
    """File logger run_<timestamp>.log (reference utils.py:222-232)."""
    logger = logging.getLogger("tdnet_tpu_torch")
    ts = str(datetime.datetime.now()).split(".")[0]
    ts = ts.replace(" ", "_").replace(":", "_").replace("-", "_")
    hdlr = logging.FileHandler(os.path.join(logdir, f"run_{ts}.log"))
    hdlr.setFormatter(logging.Formatter("%(asctime)s %(levelname)s %(message)s"))
    logger.addHandler(hdlr)
    logger.setLevel(logging.INFO)
    return logger
