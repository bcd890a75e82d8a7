"""Launching a kernel on its tensors' device.

A C entry of the kernel libraries launches on the calling thread's current
CUDA device, and keeps what it sets up for a launch by that device: the
shared-memory opt-in (``csrc/hopper.cuh:allow_smem``) and the cached tensor
maps (``MapCache``). The stream it is handed must belong to that device. So
every wrapper launches inside ``on_device(t)``, which makes the device of its
tensor ``t`` current for the call and gives the raw handle of that device's
current stream; on a CPU tensor (index -1) it changes nothing.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def on_device(t: torch.Tensor):
    index = t.get_device()
    with torch.cuda.device(index):
        # torch's private getter (CUDA builds only) costs a tenth of current_stream's host time
        raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
        yield raw(index) if raw else torch.cuda.current_stream(index).cuda_stream
