"""The error word of the bf16 kernels whose consumer warpgroups may give up.

K1's bf16 kernels (``propagation_attention.py``), K2's bf16 kernels, forward and
backward (``propagation_attention_train.py``), and K5's bf16 kernel
(``dilated_conv.py``) run consumer warpgroups that take registers by
``setmaxnreg``; such a warpgroup must not trap, so one that gives up waiting
on a barrier sets this word (one int32 a CUDA device) and exits, and its
launch ends with part of its output unwritten (``csrc/hopper.cuh``:
``bar_wait_or_flag``). ``check_fault(device)`` reads the word, a
synchronizing copy, and raises; callers read it only where they synchronize
anyway (``stream/runtime.py``, ``chip_smoke.py``, ``cli/profile.py``), so no
hot path gains a synchronization.
"""

from __future__ import annotations

import torch

_words: dict[int, torch.Tensor] = {}   # CUDA device index -> its error word


def _index(device) -> int:
    device = torch.device(device)
    return torch.cuda.current_device() if device.index is None else device.index


def fault_word(device) -> torch.Tensor:
    """The error word of the CUDA ``device``, zero until a consumer gives up."""
    i = _index(device)
    if i not in _words:
        _words[i] = torch.zeros(1, dtype=torch.int32, device=device)
    return _words[i]


def check_fault(device) -> None:
    """Raise if a bf16 launch of K1, K2 or K5 on ``device`` since the last check had
    a consumer warpgroup give up on a barrier (and clear the word). Reads one
    int32 from the device, so it waits for the device's queued work."""
    if torch.device(device).type != "cuda":
        return
    word = _words.get(_index(device))
    if word is not None and word.item():
        word.zero_()
        raise RuntimeError("a bf16 kernel (K1, the propagation attention; K2, the training "
                           "attention; or K5, the dilated conv): a consumer warpgroup gave up "
                           "waiting on a barrier, so a launch left part of its output "
                           "unwritten")
