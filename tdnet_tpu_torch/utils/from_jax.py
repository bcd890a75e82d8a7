"""Weight bridge: the JAX package's params pytree -> the port's state.

The pytree (``tdnet_tpu.models.tdnet.init_tdnet``) holds numpy-convertible
leaves with NHWC-era layouts:
- ``paths``: the P sub-network trees stacked on axis 0 -> ``paths.{p}``;
- ``atn``: [P, W]-stacked attention trees, already rotated so that
  ``atn[p][h]`` is path p's hop h -> ``atn.{p}.{h}``;
- conv kernels HWIO -> OIHW; biases as they are;
- BatchNorm {scale, bias, mean, var} -> {weight, bias, running_mean,
  running_var}; LayerNorm {scale, bias} stay [H, W] as {weight, bias};
- the attention fc ``fc.w[0, 0]`` is [in, out], which is the orientation the
  kernel takes (o @ W + b), so it is not transposed;
- ``fanet_td.init_fatd``'s FATD tree stacks its paths and hops the same way
  (``paths.{p}.ffm_32.w_qs.conv.weight``, ``atn.{p}.0``; ``head_aux`` carried);
- the teacher's tree (``tdnet_tpu.models.teacher.init_teacher``) and the
  PSPNet baseline's (``tdnet_tpu.models.pspnet.init_pspnet``) are not
  stacked and convert as they are.
"""

from __future__ import annotations

import numpy as np
import torch

from tdnet_tpu_torch.models.fanet_td import FATD, FATDConfig
from tdnet_tpu_torch.models.pspnet import PSPNet, PSPNetConfig
from tdnet_tpu_torch.models.tdnet import TDNet, TDNetConfig
from tdnet_tpu_torch.models.teacher import Teacher, TeacherConfig, freeze

_BN_KEYS = {"scale", "bias", "mean", "var"}


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_map(fn, v) for v in tree]
    return fn(tree)


def _float_type(a):
    """float64 leaves stay float64 (the float64 parity tests); the rest become
    float32."""
    return np.float64 if np.asarray(a).dtype == np.float64 else np.float32


def convert_tree(tree, prefix: str = "") -> dict[str, torch.Tensor]:
    """An unstacked JAX subtree (a backbone, a head, ...) -> state-dict entries."""
    out: dict[str, torch.Tensor] = {}
    t = lambda a: torch.from_numpy(np.array(a, dtype=_float_type(a)))
    if isinstance(tree, dict):
        keys = set(tree)
        if keys == _BN_KEYS:
            out[prefix + "weight"] = t(tree["scale"])
            out[prefix + "bias"] = t(tree["bias"])
            out[prefix + "running_mean"] = t(tree["mean"])
            out[prefix + "running_var"] = t(tree["var"])
        elif keys == {"scale", "bias"}:
            out[prefix + "weight"] = t(tree["scale"])
            out[prefix + "bias"] = t(tree["bias"])
        elif "w" in keys and keys <= {"w", "b"}:
            out[prefix + "weight"] = t(tree["w"]).permute(3, 2, 0, 1).contiguous()
            if "b" in keys:
                out[prefix + "bias"] = t(tree["b"])
        else:
            for k, v in tree.items():
                out.update(convert_tree(v, f"{prefix}{k}."))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(convert_tree(v, f"{prefix}{i}."))
    else:
        raise TypeError(f"unexpected leaf at {prefix!r}: {type(tree)}")
    return out


def _stacked_state(params: dict, cfg, drop: tuple[str, ...]) -> dict[str, torch.Tensor]:
    """A stacked {paths, atn} tree -> ``paths.{p}.`` and ``atn.{p}.{h}.`` entries;
    each path's subtrees named in ``drop`` left out."""
    state: dict[str, torch.Tensor] = {}
    fc_w = params["atn"]["fc"]["w"]  # [P, W, 1, 1, in, out]
    fc_b = params["atn"]["fc"]["b"]  # [P, W, out]
    fc_w = np.asarray(fc_w, dtype=_float_type(fc_w))
    fc_b = np.asarray(fc_b, dtype=_float_type(fc_b))
    for p in range(cfg.path_num):
        sub = _tree_map(lambda a: np.asarray(a)[p], params["paths"])
        for name in drop:
            sub.pop(name, None)
        state.update(convert_tree(sub, f"paths.{p}."))
        for h in range(cfg.window):
            state[f"atn.{p}.{h}.w"] = torch.from_numpy(fc_w[p, h, 0, 0].copy())
            state[f"atn.{p}.{h}.b"] = torch.from_numpy(fc_b[p, h].copy())
    return state


def tdnet_state_from_jax(params: dict, cfg: TDNetConfig) -> dict[str, torch.Tensor]:
    """The full params pytree (or a gradient tree of the same structure) -> a
    ``TDNet`` state dict. The aux heads are carried when ``cfg.aux`` and left
    out otherwise (the streaming model has none)."""
    return _stacked_state(params, cfg, () if cfg.aux else ("aux",))


def fatd_state_from_jax(params: dict, cfg: FATDConfig) -> dict[str, torch.Tensor]:
    """``init_fatd``'s pytree (or a gradient tree of the same structure) -> a
    ``FATD`` state dict, ``head_aux`` included."""
    return _stacked_state(params, cfg, ())


def fatd_from_jax(params: dict, cfg: FATDConfig, device=None) -> FATD:
    """A trainable FATD holding ``params`` (the Streamer sets eval itself)."""
    model = FATD(cfg, device)
    model.load_state_dict(fatd_state_from_jax(params, cfg))
    return model


def tdnet_from_jax(params: dict, cfg: TDNetConfig, device=None) -> TDNet:
    """A trainable TDNet holding ``params`` (the Streamer sets eval itself)."""
    model = TDNet(cfg, device)
    model.load_state_dict(tdnet_state_from_jax(params, cfg))
    return model


def teacher_state_from_jax(params: dict) -> dict[str, torch.Tensor]:
    """``init_teacher``'s tree {backbone, psp, groups[p], head} -> a
    ``Teacher`` state dict."""
    return convert_tree(params)


def teacher_from_jax(params: dict, cfg: TeacherConfig, device=None) -> Teacher:
    teacher = Teacher(cfg, device)
    teacher.load_state_dict(teacher_state_from_jax(params))
    return freeze(teacher)


def pspnet_from_jax(params: dict, cfg: PSPNetConfig, device=None) -> PSPNet:
    """``init_pspnet``'s tree {backbone, head, aux?} -> a ``PSPNet`` (the aux head
    carried when ``cfg.aux``; the runner sets eval itself)."""
    net = PSPNet(cfg, device)
    tree = {k: v for k, v in params.items() if k != "aux" or cfg.aux}
    net.load_state_dict(convert_tree(tree))
    return net
