"""Model registry: the reference's model ids (Testing/test.py:22-38,
Training/ptsemseg/models/__init__.py:34-44)."""

from __future__ import annotations

import torch

from tdnet_tpu_torch.models.fanet_td import (FATD, FATDConfig, fa_clip_forward,
                                             fa_stream_step, init_fa_cache, init_fatd)
from tdnet_tpu_torch.models.pspnet import PSPNet, PSPNetConfig, apply_pspnet, init_pspnet
from tdnet_tpu_torch.models.tdnet import (StreamCache, SubNet, TDNet, TDNetConfig,
                                          backbone_feat_hw, clip_forward, init_cache,
                                          init_subnet, init_tdnet, stream_step)
from tdnet_tpu_torch.models.teacher import (Teacher, TeacherConfig, apply_teacher, freeze,
                                            init_teacher)

_PRESETS = {
    "td4_psp18": dict(backbone="resnet18", path_num=4),
    "td4_psp": dict(backbone="resnet18", path_num=4),
    "td2_psp50": dict(backbone="resnet50", path_num=2),
    "td2_psp": dict(backbone="resnet50", path_num=2),
}

# the streaming sizes (bench.py's geometry; PSP-101 at the reference's evaluation size;
# TD2-FANet at its YAML's crop, which a reference checkpoint's LayerNorm [96, 192] fixes)
STREAM_SIZE = {"td4-psp18": (769, 1537), "td2-psp50": (1025, 2049), "psp101": (769, 1537),
               "td2-fa": (768, 1536)}


def tdnet_config(arch: str, nclass: int = 19, in_size: tuple[int, int] = (769, 1537),
                 streaming: bool = True, **kw) -> TDNetConfig | FATDConfig:
    """The config of a reference model name. ``streaming``: the Testing
    twin (KV stride 4, subsampled before the projections, no aux head);
    otherwise the training twin (stride 3, TD2 projecting before it
    subsamples, the aux head), as ``tdnet_tpu.models.tdnet_config``.
    ``td2_fa`` gives a ``FATDConfig`` (two paths; ``streaming`` and
    ``path_num`` ignored, as the JAX package ignores them)."""
    arch = arch.replace("-", "_")
    if arch == "td2_fa":
        kw.pop("path_num", None)
        return FATDConfig(nclass=nclass, in_size=tuple(in_size), path_num=2,
                          **{"backbone": "resnet18", **kw})
    if arch not in _PRESETS:
        raise KeyError(f"unknown or not yet ported TDNet arch {arch!r}")
    base = {**_PRESETS[arch], **kw}
    if not streaming:
        base.setdefault("kv_stride", 3)
        base.setdefault("pool_before_proj", base["path_num"] == 4)
        base.setdefault("aux", True)
    return TDNetConfig(nclass=nclass, in_size=tuple(in_size), **base)


def init_model(cfg, generator: torch.Generator, device=None):
    """``init_fatd`` or ``init_tdnet``, by the config's type."""
    return (init_fatd if isinstance(cfg, FATDConfig) else init_tdnet)(cfg, generator, device)


def model_clip_forward(cfg):
    return fa_clip_forward if isinstance(cfg, FATDConfig) else clip_forward


def model_stream_step(cfg):
    return fa_stream_step if isinstance(cfg, FATDConfig) else stream_step


def model_init_cache(cfg):
    return init_fa_cache if isinstance(cfg, FATDConfig) else init_cache


__all__ = [
    "STREAM_SIZE", "StreamCache", "SubNet", "TDNet", "TDNetConfig", "backbone_feat_hw",
    "clip_forward", "init_cache", "init_subnet", "init_tdnet", "stream_step", "tdnet_config",
    "Teacher", "TeacherConfig", "apply_teacher", "freeze", "init_teacher",
    "PSPNet", "PSPNetConfig", "apply_pspnet", "init_pspnet",
    "FATD", "FATDConfig", "fa_clip_forward", "fa_stream_step", "init_fa_cache", "init_fatd",
    "init_model", "model_clip_forward", "model_init_cache", "model_stream_step",
]
