"""Stateful streaming inference runtime.

Replaces the reference's per-frame loop over a stateful nn.Module
(Testing/test.py:46-74) with:
- the model's weights cast once to the stream's dtype and every BatchNorm's
  eval affine folded once at construction, for the TDNet and TD2-FANet
  streams (``Streamer``) and the single-frame PSPNet baseline (``FrameRunner``);
- ``stem_impl``: the backbones' stem, plain or through the fused kernel K4;
- ``fused_trunk``: the grouped PSP and QKV projections without the pyramid
  feature (``nn/fused_trunk.py``), the ``Streamer``'s default;
- a preallocated K/V/Q ring cache updated in place;
- a seeded synthetic frame stream for driving it without a dataset;
- synchronized per-frame latency with the reference's 6-frame warm-up
  excluded (test.py:58-59), and a pipelined mode that synchronizes once;
- every frame computed without TF32 (``ops.dtype.no_tf32``), and K1's bf16
  error word read where a frame or a pipelined run synchronizes.
"""

from __future__ import annotations

import time

import numpy as np
import torch
from torch import nn

from tdnet_tpu_torch.data.streaming import IMAGENET_MEAN, IMAGENET_STD
from tdnet_tpu_torch.kernels.propagation_attention import check_fault
from tdnet_tpu_torch.models import TDNet, apply_pspnet, model_init_cache, model_stream_step
from tdnet_tpu_torch.nn import Ctx, Encoding, ResNet
from tdnet_tpu_torch.ops import BatchNorm
from tdnet_tpu_torch.ops.dtype import no_tf32


def sync(device: torch.device) -> None:
    """Wait for the device's queued work (no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class LatencyMeter:
    def __init__(self, warmup: int = 6):
        self.warmup = warmup
        self.times: list[float] = []
        self.count = 0

    def add(self, dt: float):
        if self.count > self.warmup - 1:
            self.times.append(dt)
        self.count += 1

    @property
    def avg(self) -> float:
        return float(np.mean(self.times)) if self.times else float("nan")

    @property
    def fps(self) -> float:
        return 1.0 / self.avg if self.times else float("nan")


class _Runner:
    """Runs a model frame by frame on its device. It takes the model over:
    casts it to ``dtype`` and folds its BatchNorms in place; ``stem_impl``
    goes into the eval ``Ctx`` of every frame, and ``"fused"`` lays out the
    backbones' K4 weights once."""

    def __init__(self, model: nn.Module, *, dtype=torch.float32, stem_impl: str = "plain"):
        self.cfg = model.cfg
        self.dtype = dtype
        self.ctx = Ctx(stem_impl=stem_impl)
        self.model = model.to(dtype).eval().requires_grad_(False)
        self.device = next(self.model.parameters()).device
        for m in self.model.modules():
            if isinstance(m, BatchNorm):
                m.fold()
        if stem_impl == "fused":
            for m in self.model.modules():
                if isinstance(m, ResNet):
                    m.fold_stem()
        self.reset()
        self.meter = LatencyMeter()

    def reset(self):
        self.frame_idx = 0

    def _forward(self, img: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    @torch.inference_mode()
    def step(self, img: torch.Tensor, timed: bool = True):
        """Run one NHWC frame [1, H, W, 3]; returns (logits [1, H, W, nclass],
        seconds)."""
        img = img.to(self.device, self.dtype)
        if timed:
            sync(self.device)
        t0 = time.perf_counter()
        with no_tf32():
            out = self._forward(img)
        if timed:
            sync(self.device)
        dt = time.perf_counter() - t0
        if timed:
            check_fault(self.device)
            self.meter.add(dt)
        self.frame_idx += 1
        return out, dt

    def run_pipelined(self, frames):
        """Throughput mode: queue frames back to back and synchronize at the
        end. Returns (last output, seconds per frame)."""
        t0 = time.perf_counter()
        out = None
        n = 0
        for n, img in enumerate(frames, 1):
            out, _ = self.step(img, timed=False)
        sync(self.device)
        seconds = time.perf_counter() - t0
        check_fault(self.device)
        return out, seconds / n


class Streamer(_Runner):
    """Drives a ``TDNet`` or a ``FATD`` over a frame stream, one sub-network per
    frame, with the K/V/Q ring cache (``models.model_stream_step``).
    ``fused_trunk=True`` (the default, as the JAX ``Streamer``'s) takes a
    TDNet's grouped PSP and QKV projections through ``nn/fused_trunk.py``;
    ``False`` builds the pyramid feature. A FATD has no PSP to fuse: its
    encoding keeps its own weights."""

    def __init__(self, model: nn.Module, *, dtype=torch.float32, stem_impl: str = "plain",
                 fused_trunk: bool = True):
        super().__init__(model, dtype=dtype, stem_impl=stem_impl)
        self._stream_step = model_stream_step(self.cfg)
        self.ctx.fused_trunk = fused_trunk = fused_trunk and isinstance(self.model, TDNet)
        if fused_trunk:
            for m in self.model.modules():
                if isinstance(m, Encoding):
                    m.fold_trunk()

    def reset(self):
        self.cache = model_init_cache(self.cfg)(self.cfg, 1, self.dtype, self.device)
        self.frame_idx = 0

    def _forward(self, img):
        p = self.frame_idx % self.cfg.path_num
        return self._stream_step(self.model.paths[p], self.model.atn[p], self.cache, img,
                                 self.cfg, self.cfg.psp_pid(p), self.ctx)


class FrameRunner(_Runner):
    """Runs the single-frame ``PSPNet`` baseline on each frame (the
    reference's ``--model psp101``, Testing/test.py:46-74)."""

    def _forward(self, img):
        return apply_pspnet(self.model, img, self.ctx)


def synthetic_frames(n: int, in_size: tuple[int, int], *, seed: int = 0,
                     device="cpu", dtype=torch.float32) -> list[torch.Tensor]:
    """``n`` normalized NHWC frames [1, H, W, 3]: a seeded uint8 RGB scene
    panned one pixel per frame, normalized with the ImageNet mean and std as
    the reference's loader does."""
    h, w = in_size
    scene = np.random.RandomState(seed).randint(0, 256, (h, w + n, 3), dtype=np.uint8)
    return [torch.from_numpy((scene[None, :, t:t + w].astype(np.float32) / 255.0
                              - IMAGENET_MEAN) / IMAGENET_STD).to(device, dtype)
            for t in range(n)]
