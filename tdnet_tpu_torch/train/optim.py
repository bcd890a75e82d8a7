"""AdaOptimizer (``tdnet_tpu/train/optim.py:75-155``; reference
Training/ptsemseg/optimizers/adaoptimizer.py).

SGD with momentum 0.9 (dampening 0) over two parameter groups: conv and
linear weights with weight decay 1e-4, and biases and norm affines without.
The learning rate warms up exponentially from ``warmup_start_lr`` to ``lr0``
over ``warmup_steps`` steps, then decays as poly 0.9 to ``max_iter``; update
``it`` (counted from 0) uses ``lr(it)``, as optax's scale_by_learning_rate
does. BatchNorm running statistics are buffers and are not optimized.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from tdnet_tpu_torch.nn import Attention
from tdnet_tpu_torch.ops import Conv2d


def warmup_poly_schedule(lr0: float, warmup_start_lr: float, warmup_steps: int,
                         max_iter: int, power: float):
    """lr(it): start * (lr0 / start)^(it / w) for it <= w, else poly decay;
    evaluated in float32 as the JAX schedule is."""
    factor = np.float32((lr0 / warmup_start_lr) ** (1.0 / warmup_steps))

    def schedule(it: int) -> float:
        it = np.float32(it)
        if it <= warmup_steps:
            return float(np.float32(warmup_start_lr) * np.power(factor, it))
        t = np.clip((it - np.float32(warmup_steps)) / np.float32(max_iter - warmup_steps),
                    np.float32(0.0), np.float32(1.0))
        return float(np.float32(lr0) * np.power(np.float32(1.0) - t, np.float32(power)))

    return schedule


def decayed_parameters(model: nn.Module) -> tuple[list[nn.Parameter], list[nn.Parameter]]:
    """(conv and linear weights, everything else): the weight-decay split."""
    decay = []
    for m in model.modules():
        if isinstance(m, Conv2d):
            decay.append(m.weight)
        elif isinstance(m, Attention):
            decay.append(m.w)
    ids = {id(p) for p in decay}
    return decay, [p for p in model.parameters() if id(p) not in ids]


def ada_optimizer(model: nn.Module, *, lr0: float = 1e-2, momentum: float = 0.9,
                  wd: float = 1e-4, warmup_steps: int = 1000, warmup_start_lr: float = 1e-5,
                  max_iter: int = 40000, power: float = 0.9):
    """Returns (torch.optim.SGD, schedule). Set every group's lr to
    ``schedule(it)`` before update ``it``."""
    schedule = warmup_poly_schedule(lr0, warmup_start_lr, warmup_steps, max_iter, power)
    decay, rest = decayed_parameters(model)
    opt = torch.optim.SGD([{"params": decay, "weight_decay": wd},
                           {"params": rest, "weight_decay": 0.0}],
                          lr=schedule(0), momentum=momentum, dampening=0.0)
    return opt, schedule
