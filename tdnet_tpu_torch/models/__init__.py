"""Model registry: the reference's model ids (Testing/test.py:22-38,
Training/ptsemseg/models/__init__.py:34-44)."""

from __future__ import annotations

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

# the streaming sizes (bench.py's geometry; PSP-101 at the reference's evaluation size)
STREAM_SIZE = {"td4-psp18": (769, 1537), "td2-psp50": (1025, 2049), "psp101": (769, 1537)}


def tdnet_config(arch: str, nclass: int = 19, in_size: tuple[int, int] = (769, 1537),
                 streaming: bool = True, **kw) -> TDNetConfig:
    """The TDNetConfig of a reference model name. ``streaming``: the Testing
    twin (KV stride 4, subsampled before the projections, no aux head);
    otherwise the training twin (stride 3, TD2 projecting before it
    subsamples, the aux head), as ``tdnet_tpu.models.tdnet_config``."""
    arch = arch.replace("-", "_")
    if arch not in _PRESETS:
        raise KeyError(f"unknown or not yet ported TDNet arch {arch!r}")
    base = {**_PRESETS[arch], **kw}
    if not streaming:
        base.setdefault("kv_stride", 3)
        base.setdefault("pool_before_proj", base["path_num"] == 4)
        base.setdefault("aux", True)
    return TDNetConfig(nclass=nclass, in_size=tuple(in_size), **base)


__all__ = [
    "STREAM_SIZE", "StreamCache", "SubNet", "TDNet", "TDNetConfig", "backbone_feat_hw",
    "clip_forward", "init_cache", "init_subnet", "init_tdnet", "stream_step", "tdnet_config",
    "Teacher", "TeacherConfig", "apply_teacher", "freeze", "init_teacher",
    "PSPNet", "PSPNetConfig", "apply_pspnet", "init_pspnet",
]
