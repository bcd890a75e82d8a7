"""The reference's PyTorch checkpoints -> the port's state dicts
(``tdnet_tpu/utils/torch_import.py``).

The reference (SURVEY.md section 5.4) names its modules otherwise than the
port: a trained TDNet in the Testing twin's naming (``pretrained{i}``,
``psp{i}``, ``enc{i}``, ``atn{p}_{s}``, ``layer_norm{i}``, ``head{i}``, and in
training ``auxlayer{i}``), a single-path PSPNet as ``pretrained``,
``head.conv5.*`` and ``auxlayer``, a torchvision ResNet as ``conv1``, ``bn1``,
``layerX.Y``. Both sides hold OIHW weights, so each function here is a name
map returning entries of the port's state dicts (``{port key: tensor}``);
only the attention fc is transposed (the port keeps it [in, out]). The
channel surgery of the PSPNet sources is ``utils/surgery.py``.

``sd`` is a flat ``{name: tensor}`` dict (numpy arrays are taken too). A key
that is needed and missing raises ``KeyError`` naming it; the reference's
``num_batches_tracked`` buffers are ignored, and any other key that an
import left unread is logged (``log_unread``).

``load_tdnet`` and ``load_pspnet`` read any file the port accepts into a
model: the port's own (``utils/checkpoint.py``; keys ``paths.`` or
``backbone.``), the JAX package's pickle (``utils/from_jax.py``) or the
reference's (torch's legacy or zip format, keys ``pretrained{i}.`` or
``module.``).
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from tdnet_tpu_torch.nn.resnet import BACKBONES, ResNetConfig, _block_plan
from tdnet_tpu_torch.utils.checkpoint import load_checkpoint
from tdnet_tpu_torch.utils.from_jax import tdnet_state_from_jax

log = logging.getLogger("tdnet_tpu_torch")


class StateReader(dict):
    """A state dict that records the keys read and names a missing one."""

    def __init__(self, sd):
        super().__init__(sd)
        self.read: set[str] = set()

    def __getitem__(self, key):
        if not super().__contains__(key):
            raise KeyError(f"{key!r} is missing from the checkpoint")
        self.read.add(key)
        return super().__getitem__(key)


def reader(sd) -> StateReader:
    return sd if isinstance(sd, StateReader) else StateReader(sd)


def log_unread(sd: StateReader, what: str) -> list[str]:
    """Logs (and returns) the keys of ``sd`` left unread, num_batches_tracked aside."""
    unread = sorted(k for k in sd if k not in sd.read and not k.endswith("num_batches_tracked"))
    if unread:
        log.warning(f"{what}: {len(unread)} keys of the checkpoint not read: "
                    f"{', '.join(unread[:8])}{' ...' if len(unread) > 8 else ''}")
    return unread


def load_torch_state(path: str) -> dict[str, torch.Tensor]:
    """The state dict of a torch checkpoint (legacy or zip format), unwrapped
    from ``{"model_state": ...}`` where it is one; tensors on the CPU."""
    state, fmt = load_checkpoint(path)
    if fmt == "pickle":
        raise ValueError(f"{path}: not a torch checkpoint (neither zip nor legacy format)")
    if isinstance(state, dict) and "model_state" in state:
        state = state["model_state"]
    if not (isinstance(state, dict) and all(torch.is_tensor(v) for v in state.values())):
        raise ValueError(f"{path}: holds no state dict of tensors")
    return dict(state)


def strip_module_prefix(sd: dict) -> dict:
    """DataParallel 'module.' prefix removal (reference utils.py:211-220)."""
    if sd and all(k.startswith("module.") for k in sd):
        return {k[7:]: v for k, v in sd.items()}
    return sd


def _t(x) -> torch.Tensor:
    return x if torch.is_tensor(x) else torch.from_numpy(np.asarray(x))


def _conv(sd, src: str, dst: str, bias=None) -> dict:
    out = {dst + "weight": _t(sd[src + ".weight"])}
    if bias is None:
        bias = src + ".bias" in sd
    if bias:
        out[dst + "bias"] = _t(sd[src + ".bias"])
    return out


def _bn(sd, src: str, dst: str) -> dict:
    return {dst + n: _t(sd[f"{src}.{n}"])
            for n in ("weight", "bias", "running_mean", "running_var")}


def _prefixed(entries: dict, prefix: str) -> dict:
    return {prefix + k: v for k, v in entries.items()}


def resnet_from_torch(sd, cfg: ResNetConfig, prefix: str = "") -> dict:
    """A ``ResNet``'s entries; ``prefix`` e.g. 'pretrained1.'."""
    g = lambda s: prefix + s
    if cfg.deep_base:
        p = {**_conv(sd, g("conv1.0"), "stem.conv0."), **_bn(sd, g("conv1.1"), "stem.bn0."),
             **_conv(sd, g("conv1.3"), "stem.conv1."), **_bn(sd, g("conv1.4"), "stem.bn1."),
             **_conv(sd, g("conv1.6"), "stem.conv2.")}
    else:
        p = _conv(sd, g("conv1"), "stem.conv0.")
    p.update(_bn(sd, g("bn1"), "bn1."))
    for li, layer in enumerate(_block_plan(cfg)):
        for bi in range(len(layer)):
            src, dst = g(f"layer{li + 1}.{bi}"), f"layer{li + 1}.{bi}."
            for j in (1, 2, 3) if cfg.block == "bottleneck" else (1, 2):
                p.update(_conv(sd, f"{src}.conv{j}", f"{dst}conv{j}."))
                p.update(_bn(sd, f"{src}.bn{j}", f"{dst}bn{j}."))
            if src + ".downsample.0.weight" in sd:
                p.update(_conv(sd, src + ".downsample.0", dst + "downsample.conv."))
                p.update(_bn(sd, src + ".downsample.1", dst + "downsample.bn."))
    return p


def pyramid_from_torch(sd, prefix: str) -> dict:
    p = {}
    for i in range(1, 5):
        p.update(_conv(sd, f"{prefix}conv{i}.0", f"conv{i}.conv."))
        p.update(_bn(sd, f"{prefix}conv{i}.1", f"conv{i}.bn."))
    return p


def _proj2_from_torch(sd, prefix: str, dst: str) -> dict:
    # nn.Sequential(ConvBNReLU(conv+bn), ConvBNReLU(conv))
    return {**_conv(sd, prefix + ".0.conv", dst + "conv0."),
            **_bn(sd, prefix + ".0.bn", dst + "bn0."),
            **_conv(sd, prefix + ".1.conv", dst + "conv1.")}


def encoding_from_torch(sd, prefix: str) -> dict:
    return {**_proj2_from_torch(sd, prefix + "w_qs", "w_qs."),
            **_proj2_from_torch(sd, prefix + "w_ks", "w_ks."),
            **_conv(sd, prefix + "w_vs.0.conv", "w_vs.")}


def attention_from_torch(sd, prefix: str) -> dict:
    """The hop's fc: the reference's 1x1 conv [out, in, 1, 1] -> ``w`` [in, out]."""
    return {"w": _t(sd[prefix + "fc.0.conv.weight"])[:, :, 0, 0].t().contiguous(),
            "b": _t(sd[prefix + "fc.0.conv.bias"])}


def fcn_head_from_torch(sd, prefix: str) -> dict:
    return {**_conv(sd, prefix + "conv5.0", "conv."), **_bn(sd, prefix + "conv5.1", "bn."),
            **_conv(sd, prefix + "conv5.4", "out.")}


def psp_head_from_torch(sd, prefix: str) -> dict:
    """PSPHead (baseline pspnet): conv5 = Sequential(PyramidPooling, conv,
    bn, relu, dropout, conv)."""
    return {**_prefixed(pyramid_from_torch(sd, prefix + "conv5.0."), "psp."),
            **_conv(sd, prefix + "conv5.1", "conv.conv."),
            **_bn(sd, prefix + "conv5.2", "conv.bn."), **_conv(sd, prefix + "conv5.5", "out.")}


def tdnet_from_torch(sd, cfg) -> dict[str, torch.Tensor]:
    """A trained TDNet (the Testing twin's naming, the training twin's aux
    heads read when ``cfg.aux`` asks for them and the file has them) -> a
    ``TDNet`` state dict. The LayerNorm weights fix the input size: a file
    trained at another one raises, naming both."""
    sd = reader(strip_module_prefix(sd))
    state: dict[str, torch.Tensor] = {}
    for p in range(cfg.path_num):
        i = p + 1
        parts = {"backbone": resnet_from_torch(sd, BACKBONES[cfg.backbone](), f"pretrained{i}."),
                 "psp": pyramid_from_torch(sd, f"psp{i}."),
                 "enc": encoding_from_torch(sd, f"enc{i}."),
                 "ln": {"weight": _t(sd[f"layer_norm{i}.ln.weight"]),
                        "bias": _t(sd[f"layer_norm{i}.ln.bias"])},
                 "head": fcn_head_from_torch(sd, f"head{i}.")}
        if tuple(parts["ln"]["weight"].shape) != tuple(cfg.feat_hw):
            raise ValueError(
                f"layer_norm{i}: the checkpoint's feature grid is "
                f"{tuple(parts['ln']['weight'].shape)}, the config's {tuple(cfg.feat_hw)} "
                f"(input {cfg.in_size[0]}x{cfg.in_size[1]}): the file was trained at another "
                f"input size")
        if cfg.aux and f"auxlayer{i}.conv5.0.weight" in sd:
            parts["aux"] = fcn_head_from_torch(sd, f"auxlayer{i}.")
        for name, entries in parts.items():
            state.update(_prefixed(entries, f"paths.{p}.{name}."))
        # P = 4: atn{p+1}_{s+1}, stored pre-rotated: hop h of path p -> s = (p + h + 1) % P;
        # P = 2: one hop a path named atn{p+1} (td2_psp50.py:81-82)
        for h in range(cfg.window):
            name = f"atn{i}." if cfg.path_num == 2 else f"atn{i}_{(p + h + 1) % cfg.path_num + 1}."
            state.update(_prefixed(attention_from_torch(sd, name), f"atn.{p}.{h}."))
    log_unread(sd, "tdnet_from_torch")
    return state


def pspnet_from_torch(sd, cfg) -> dict[str, torch.Tensor]:
    """The PSPNet baseline (the reference's psp101: ``pretrained.*`` and
    ``head.*``, as ``tdnet_tpu/cli/test.py:118-123`` reads it) -> a ``PSPNet``
    state dict (no aux head)."""
    sd = reader(strip_module_prefix(sd))
    state = {**_prefixed(resnet_from_torch(sd, cfg.backbone_cfg, "pretrained."), "backbone."),
             **_prefixed(psp_head_from_torch(sd, "head."), "head.")}
    log_unread(sd, "pspnet_from_torch")
    return state


def load_state_into(model: torch.nn.Module, state: dict, what: str) -> torch.nn.Module:
    """``model.load_state_dict(state)``, where a TDNet's aux heads that one side
    lacks are left as they are (JAX reads them only when both have them)."""
    aux = lambda k: ".aux." in k
    if not getattr(model.cfg, "aux", False):
        state = {k: v for k, v in state.items() if not aux(k)}
    missing, unexpected = model.load_state_dict(state, strict=False)
    missing = [k for k in missing if not aux(k)]
    if missing or unexpected:
        raise KeyError(f"{what}: not a checkpoint of this model (missing {missing[:4]}, "
                       f"unexpected {unexpected[:4]})")
    return model


def checkpoint_kind(path: str):
    """(the model state in ``path``, its kind: 'port', 'jax' or 'reference')."""
    payload, fmt = load_checkpoint(path)
    state = payload.get("model_state", payload) if isinstance(payload, dict) else payload
    if not isinstance(state, dict):
        raise ValueError(f"{path}: holds no state dict")
    if fmt == "pickle":
        return state, "jax"
    port = any(k.startswith(("paths.", "backbone.")) for k in state)
    return state, "port" if port else "reference"


def load_tdnet(model, path: str):
    """Loads the TDNet checkpoint in ``path`` (any of the three kinds) into ``model``."""
    state, kind = checkpoint_kind(path)
    if kind == "jax":
        state = tdnet_state_from_jax(state, model.cfg)
    elif kind == "reference":
        state = tdnet_from_torch(state, model.cfg)
    return load_state_into(model, state, path)


def load_pspnet(model, path: str):
    """Loads the PSPNet checkpoint in ``path`` (the port's or the reference's) into ``model``."""
    state, kind = checkpoint_kind(path)
    if kind == "jax":
        raise ValueError(f"{path}: a PSPNet is read from a torch checkpoint only")
    if kind == "reference":
        state = pspnet_from_torch(state, model.cfg)
    return load_state_into(model, state, path)
