"""Checkpoints and run management (``tdnet_tpu/utils/checkpoint.py``).

- ``save_best``: the reference's best-mIoU checkpoint (Training/train.py:
  136-146): ``{arch}_{dataset}_best_model.pkl`` holding ``epoch``,
  ``model_state`` (the student's state dict, BN buffers included) and
  ``best_iou``;
- ``save_train_state`` / ``load_train_state``: the whole train state (the
  model's state dict, the optimizer's state, ``it`` and ``seed``) to resume a
  run where it stopped;
- ``save_state``: a bare state dict as ``{"model_state": ...}`` (what
  ``cli/convert.py`` writes);
- ``load_checkpoint``: a file's payload and its format (``file_format``),
  told apart by its first bytes. A torch file (``zip``, the port's own, ``PK``;
  or ``legacy``, what the reference's PyTorch 1.1 wrote, which starts with a
  pickled magic number) loads with ``torch.load(weights_only=True)``, numpy's
  scalars allowed besides tensors and containers (the reference's
  ``best_iou`` may be one); anything else (``pickle``) is the JAX package's
  raw pickle of numpy arrays, read by an unpickler that builds numpy arrays
  and scalars and nothing else.

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

import numpy as np
import torch

ZIP_MAGIC = b"PK"
# torch.save's legacy (non-zip) format opens with this number, pickled at protocol 2
LEGACY_MAGIC = pickle.dumps(0x1950a86a20f9469cfc6c, protocol=2)


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


def save_state(path: str, state: dict[str, torch.Tensor]) -> None:
    """A model's state dict (host tensors) as ``{"model_state": state}``."""
    _save(path, {"model_state": {k: v.detach().cpu() for k, v in state.items()}})


def file_format(path: str) -> str:
    """``path``'s format by its first bytes: ``zip`` or ``legacy`` (the two that
    ``torch.load`` reads) or ``pickle``."""
    with open(path, "rb") as f:
        head = f.read(len(LEGACY_MAGIC))
    return "zip" if head[:2] == ZIP_MAGIC else "legacy" if head == LEGACY_MAGIC else "pickle"


NUMERIC_DTYPES = [type(np.dtype(c)) for c in "?bBhHiIlLqQefdg"]   # numpy.dtypes.Float64DType, ...


def _numpy_scalar():
    try:
        from numpy._core.multiarray import scalar
    except ImportError:     # numpy 1
        from numpy.core.multiarray import scalar
    return scalar


def _numpy_scalar_globals() -> list:
    """numpy's scalar constructor (under numpy 1's and 2's module names) and its
    numeric dtypes: what a pickled numpy scalar needs, and nothing more."""
    scalar = _numpy_scalar()
    return [np.dtype, *NUMERIC_DTYPES, (scalar, "numpy.core.multiarray.scalar"),
            (scalar, "numpy._core.multiarray.scalar")]


class _NumpyUnpickler(pickle.Unpickler):
    """Builds containers, numbers, numpy arrays and numpy scalars; refuses any
    other global."""

    ALLOWED = {("numpy", "ndarray"), ("numpy", "dtype")} | {
        (m, n) for m in ("numpy.core.multiarray", "numpy._core.multiarray")
        for n in ("_reconstruct", "scalar")} | {
        (t.__module__, t.__name__) for t in NUMERIC_DTYPES}

    def find_class(self, module, name):
        if (module, name) not in self.ALLOWED:
            raise pickle.UnpicklingError(f"global {module}.{name} is not allowed")
        return super().find_class(module, name)


def load_checkpoint(path: str):
    """(the payload of ``path``, its ``file_format``): a torch file through
    ``torch.load(weights_only=True)`` (tensors on the CPU), else the JAX
    package's numpy pickle. A file that holds other objects is refused; one
    that neither reads raises. Both errors name the file."""
    fmt = file_format(path)
    torch_file = fmt != "pickle"
    try:
        if torch_file:
            with torch.serialization.safe_globals(_numpy_scalar_globals()):
                return torch.load(path, map_location="cpu", weights_only=True), fmt
        with open(path, "rb") as f:
            return _NumpyUnpickler(f).load(), fmt
    except Exception as e:
        refusal = [ln.strip() for ln in str(e).splitlines()
                   if "global" in ln.lower() or "can only build" in ln.lower()]
        if refusal:
            raise pickle.UnpicklingError(
                f"{path}: refused, it holds more than tensors, containers and numpy values "
                f"({refusal[0][:300]})") from e
        what = "torch.load" if torch_file else "the JAX package's pickle format"
        raise ValueError(f"{path}: not a checkpoint that {what} reads ({e})") from e


def load_train_state(path: str, state) -> None:
    """Restore ``save_train_state``'s file into ``state`` in place: the model's
    tensors, the optimizer's momentum, ``it`` and ``seed``."""
    saved, _ = load_checkpoint(path)
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
