"""The reference's YAML experiment configs (``tdnet_tpu/utils/config.py``).

Configs (``configs/*.yml``, Training/configs/*.yml) have the top-level
schema {model, teacher, data, training, validating}. These helpers turn the
model, teacher, loss and optimizer sections into the port's objects.
"""

from __future__ import annotations


def load_config(path: str) -> dict:
    import yaml
    with open(path) as fp:
        return yaml.safe_load(fp)


def model_config_from_yaml(cfg: dict, nclass: int = 19, in_size=None, streaming: bool = False):
    """cfg['model'] (and the train crop) -> TDNetConfig, or FATDConfig for td2_fa."""
    from tdnet_tpu_torch.models import tdnet_config
    m = cfg["model"]
    if in_size is None:
        in_size = cfg["training"]["train_augmentations"].get("rcrop", [769, 1537])
    return tdnet_config(m["arch"], nclass=nclass, in_size=tuple(in_size), streaming=streaming,
                        backbone=m["backbone"], path_num=m["path_num"])


def teacher_config_from_yaml(cfg: dict, nclass: int = 19):
    from tdnet_tpu_torch.models import TeacherConfig
    t = cfg.get("teacher")
    if not t:
        return None
    return TeacherConfig(nclass=nclass, backbone=t.get("backbone", "resnet101"),
                         path_num=t["path_num"])


def loss_fn_from_yaml(cfg: dict, n_devices: int = 1):
    from tdnet_tpu_torch.train.loss import make_loss_fn
    tr = cfg["training"]
    crop = tr["train_augmentations"].get("rcrop", [769, 1537])
    return make_loss_fn(tr["loss"]["name"], {"batch_size": tr["batch_size"],
                                             "n_devices": n_devices, "crop_size": crop,
                                             "loss": tr["loss"]})


def opt_kwargs_from_yaml(cfg: dict) -> dict:
    """cfg['training']['optimizer'] -> keyword arguments of ``ada_optimizer``."""
    o = dict(cfg["training"]["optimizer"])
    name = o.pop("name", "adaoptimizer")
    if name != "adaoptimizer":
        raise NotImplementedError(f"optimizer {name!r}: only adaoptimizer is ported")
    o.setdefault("warmup_steps", 1000)
    o.setdefault("warmup_start_lr", 1e-5)
    max_iter = int(o.pop("max_iter", cfg["training"]["train_iters"]))
    return {k: (int(v) if k == "warmup_steps" else float(v)) for k, v in o.items()} | {
        "max_iter": max_iter}


def compute_dtype_from_yaml(cfg: dict):
    """cfg['training']['mixed_precision'] -> ``torch.bfloat16`` (mixed
    precision), else None (the f32 recipe), as ``tdnet_tpu/cli/train.py:167-170``
    reads it."""
    import torch
    return torch.bfloat16 if cfg["training"].get("mixed_precision") else None
