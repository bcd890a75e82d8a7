"""Multi-device streaming behind the serial ``Streamer``'s API
(``tdnet_tpu/stream/parallel_runtime.py``).

``GroupStreamer``: group streaming (``parallel/group_stream.py``), one
sub-network resident on each of P devices and P consecutive frames a
super-step. Frames are buffered until a group of P is there; ``flush`` pads a
trailing partial group with its last frame and drops the padding's outputs.
It yields per-frame (logits, seconds) as ``Streamer.step`` does, but the
seconds are a frame's share of the super-step's time (throughput, super-step
time / P); the super-step's latency is kept in ``superstep_meter``, and a
frame's time to its result also holds up to P - 1 frames of queueing while its
group fills. As the ``Streamer`` does, it casts the model to its dtype and folds
every BatchNorm once, lays out the fused trunk's weights (and K4's, with
``stem_impl="fused"``) once, runs every frame without TF32 and reads the bf16
kernels' error word of each card where it synchronizes.

``SpatialStreamer``, a frame's H axis over every device, is not ported
(ROADMAP Queue 1 item 9: every conv, pool and resize needs its halo exchange
written out, which GSPMD inserts for the JAX package).
"""

from __future__ import annotations

import time

import torch
from torch import nn

from tdnet_tpu_torch.kernels.fault import check_fault
from tdnet_tpu_torch.nn import Ctx, Encoding, ResNet
from tdnet_tpu_torch.ops import BatchNorm
from tdnet_tpu_torch.ops.dtype import no_tf32
from tdnet_tpu_torch.parallel.group_stream import (GroupCarry, check_model, group_stream_step,
                                                   path_devices, place_paths)
from tdnet_tpu_torch.stream.runtime import LatencyMeter, sync

SPATIAL = ("SpatialStreamer (--parallel spatial) is not ported: ROADMAP Queue 1 item 9 "
           "(spatial streaming needs a halo exchange written out for every conv, pool and "
           "resize)")


class GroupStreamer:
    """Group streaming of a ``TDNet`` over P devices (``devices``, which may
    repeat one; default: the first P cards). It takes the model over."""

    def __init__(self, model: nn.Module, *, dtype=torch.float32, stem_impl: str = "plain",
                 fused_trunk: bool = True, devices=None):
        check_model(model)
        self.cfg = model.cfg
        self.dtype = dtype
        self.devices = path_devices(self.cfg.path_num, devices)
        self.ctx = Ctx(stem_impl=stem_impl, fused_trunk=fused_trunk)
        self.model = model.to(dtype).eval().requires_grad_(False)
        place_paths(self.model, self.devices)
        # in the serial runtime's order: the BatchNorms first, then what reads them
        for kind, fold, wanted in ((BatchNorm, "fold", True),
                                   (ResNet, "fold_stem", stem_impl == "fused"),
                                   (Encoding, "fold_trunk", fused_trunk)):
            for m in self.model.modules():
                if wanted and isinstance(m, kind):
                    getattr(m, fold)()
        self._cards = [d for d in dict.fromkeys(self.devices) if d.type == "cuda"]
        self.reset()
        self.meter = LatencyMeter()
        # warm-up in super-steps ~ the frame meter's 6 frames
        self.superstep_meter = LatencyMeter(warmup=-(-6 // self.cfg.path_num))

    def reset(self):
        self.carry = GroupCarry()
        self._pending: list[torch.Tensor] = []

    def _sync(self):
        for d in dict.fromkeys(self.devices):
            sync(d)

    def _check(self):
        for d in self._cards:
            check_fault(d)

    @torch.inference_mode()
    def _run_group(self, frames: list[torch.Tensor], n_real: int, timed: bool) -> list:
        """One super-step over P frames; the first ``n_real`` (logits, seconds a
        frame of throughput) pairs."""
        frames = [f.to(d, self.dtype) for f, d in zip(frames, self.devices)]
        if timed:
            self._sync()
        t0 = time.perf_counter()
        with no_tf32():
            outs = group_stream_step(self.model, self.carry, frames, self.devices, self.ctx)
        if timed:
            self._sync()
        dt_super = time.perf_counter() - t0
        if timed:
            self._check()
            self.superstep_meter.add(dt_super)
        dt = dt_super / self.cfg.path_num
        if timed:
            for _ in range(n_real):
                self.meter.add(dt)
        return [(out, dt) for out in outs[:n_real]]

    def submit(self, img: torch.Tensor, timed: bool = True) -> list:
        """Buffer one NHWC frame [1, H, W, 3]; [] until a group of P frames is
        buffered, then their P (logits, seconds a frame) pairs."""
        self._pending.append(img)
        if len(self._pending) < self.cfg.path_num:
            return []
        group, self._pending = self._pending, []
        return self._run_group(group, len(group), timed)

    def flush(self, timed: bool = True) -> list:
        """Run a trailing partial group, padded with its last frame."""
        if not self._pending:
            return []
        n_real = len(self._pending)
        group = self._pending + [self._pending[-1]] * (self.cfg.path_num - n_real)
        self._pending = []
        return self._run_group(group, n_real, timed)

    def run_pipelined(self, frames):
        """Throughput mode: groups queued back to back, one synchronization at
        the end. Returns (last logits, seconds a frame)."""
        t0 = time.perf_counter()
        out, n = None, 0
        for img in frames:
            for out, _ in self.submit(img, timed=False):
                n += 1
        for out, _ in self.flush(timed=False):
            n += 1
        self._sync()
        seconds = time.perf_counter() - t0
        self._check()
        return out, seconds / n


class SpatialStreamer:
    """Not ported (``SPATIAL``)."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(SPATIAL)
