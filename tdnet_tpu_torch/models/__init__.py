"""Model registry: the reference's streaming model ids (Testing/test.py:22-38)."""

from __future__ import annotations

from tdnet_tpu_torch.models.tdnet import (StreamCache, SubNet, TDNet, TDNetConfig,
                                          backbone_feat_hw, init_cache, init_subnet,
                                          init_tdnet, stream_step)

_PRESETS = {
    "td4_psp18": dict(backbone="resnet18", path_num=4),
    "td4_psp": dict(backbone="resnet18", path_num=4),
    "td2_psp50": dict(backbone="resnet50", path_num=2),
    "td2_psp": dict(backbone="resnet50", path_num=2),
}

# the slice's streaming sizes (bench.py's geometry)
STREAM_SIZE = {"td4-psp18": (769, 1537), "td2-psp50": (1025, 2049)}


def tdnet_config(arch: str, nclass: int = 19, in_size: tuple[int, int] = (769, 1537),
                 **kw) -> TDNetConfig:
    """The streaming TDNetConfig of a reference model name (KV stride 4,
    subsampled before the projections)."""
    arch = arch.replace("-", "_")
    if arch not in _PRESETS:
        raise KeyError(f"unknown or not yet ported TDNet arch {arch!r}")
    return TDNetConfig(nclass=nclass, in_size=tuple(in_size), **{**_PRESETS[arch], **kw})


__all__ = [
    "STREAM_SIZE", "StreamCache", "SubNet", "TDNet", "TDNetConfig", "backbone_feat_hw", "init_cache",
    "init_subnet", "init_tdnet", "stream_step", "tdnet_config",
]
