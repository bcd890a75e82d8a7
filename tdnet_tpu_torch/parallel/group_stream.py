"""Group streaming: P devices, P frames a super-step
(``tdnet_tpu/parallel/group_stream.py:62-165``).

TDNet's heavy work on consecutive frames is independent: frame t's backbone,
PSP and QKV encodings depend on frame t alone, and only the propagation chain
reads the previous W = P - 1 frames' (q, k, v) token fields. So sub-network p
lives on ``devices[p]`` for good, and one super-step runs a group of P
consecutive frames, frame t0 + p on device p (t0 a multiple of P):

- each device runs its frame's trunk (the fused PSP+QKV trunk where the
  config pools before its projections, as the serial ``Streamer`` runs it);
- the group's token fields are copied to every device (the JAX package's
  ``all_gather``), where device p slices its window of W frames out of
  (carry ++ group) and runs the hop chain (K1 on CUDA devices) and the head;
- the carry, the last W frames' token fields, advances by P.

Every frame is computed by the serial ``Streamer``'s own ``frame_trunk`` and
``frame_head`` (``models/tdnet.py``) around the same hop chain, so on one kind
of device its logits are the serial stream's to the bit. The step runs in one process over a list of
devices; a device may repeat (the CPU tests, one card), and each device keeps
one copy of the carry.
"""

from __future__ import annotations

import contextlib

import torch

from tdnet_tpu_torch.models.tdnet import TDNet, _hop_chain, frame_head, frame_trunk
from tdnet_tpu_torch.nn import Ctx

FATD_REFUSAL = (
    "group streaming drives the grouped-PSP TDNet trunk; got {}. The FANet student "
    "(FATDConfig) has a different trunk — add a dedicated group step before using it.")


def path_devices(path_num: int, devices=None) -> list[torch.device]:
    """The P devices of a group step: ``devices`` (a device may repeat), or the
    first P CUDA cards, as ``make_path_mesh`` takes the first P devices; fewer
    cards than P is an error, never a sub-network on the CPU."""
    if devices is None:
        have = torch.cuda.device_count()
        if have < path_num:
            raise ValueError(f"group streaming needs {path_num} devices; have {have} "
                             f"(pass devices=, which may repeat one)")
        devices = [torch.device("cuda", i) for i in range(path_num)]
    devices = [torch.device(d) for d in devices]
    if len(devices) != path_num:
        raise ValueError(f"group streaming needs {path_num} devices; got {len(devices)}")
    return [torch.device("cuda", torch.cuda.current_device()) if
            d.type == "cuda" and d.index is None else d for d in devices]


def check_model(model) -> None:
    if not isinstance(model, TDNet):
        raise TypeError(FATD_REFUSAL.format(type(model.cfg).__name__))


def place_paths(model: TDNet, devices: list[torch.device]) -> None:
    """Sub-network p and its hops' attention weights onto ``devices[p]``, in place."""
    for p, dev in enumerate(devices):
        model.paths[p].to(dev)
        model.atn[p].to(dev)


def on(device: torch.device):
    """``device`` current, where it is a CUDA device."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


class GroupCarry:
    """The last W frames' token fields, oldest first, one copy on each device of
    the group, and the frames seen."""

    def __init__(self):
        self.tokens: dict[torch.device, list[tuple]] = {}
        self.count = 0


def group_stream_step(model: TDNet, carry: GroupCarry, frames: list[torch.Tensor],
                      devices: list[torch.device], ctx: Ctx) -> list[torch.Tensor]:
    """One super-step: NHWC frames [n, H, W, 3] t0 .. t0 + P - 1 (oldest first)
    -> their logits NHWC [n, H, W, nclass], frame p's on ``devices[p]``;
    advances ``carry`` by P frames. ``ctx`` is the eval context of the serial
    stream (``stem_impl``, ``fused_trunk``)."""
    cfg = model.cfg
    w, n_paths = cfg.window, cfg.path_num
    trunks = []
    for p, dev in enumerate(devices):            # queued on every device before any hop
        with on(dev):
            trunks.append(frame_trunk(model.paths[p], frames[p].to(dev), cfg, cfg.psp_pid(p),
                                      ctx))
    hist = {}
    for dev in dict.fromkeys(devices):           # the group's tokens copied to each device
        with on(dev):
            hist[dev] = carry.tokens.get(dev, []) + [
                tuple(t.contiguous().to(dev, non_blocking=True) for t in tok)
                for _, _, tok in trunks]
    held = min(carry.count, w)
    outs = []
    for p, dev in enumerate(devices):
        q_cur, feat, _ = trunks[p]
        with on(dev):
            if carry.count + p >= w:
                # while the carry is cold the reference adds zeros: skip the hops
                qs, ks, vs = zip(*hist[dev][held + p - w:held + p])
                feat = feat + _hop_chain(model.atn[p], ks, vs, qs, q_cur, cfg)
            outs.append(frame_head(model.paths[p], feat, cfg))
    carry.tokens = {dev: h[-w:] for dev, h in hist.items()}
    carry.count += n_paths
    return outs
