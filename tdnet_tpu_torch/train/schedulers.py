"""LR scheduler registry (``tdnet_tpu/train/schedulers.py``).

Reference parity note: Training/ptsemseg/schedulers/ is DEAD CODE in the
reference — ``get_scheduler`` is never called (AdaOptimizer embeds its
own warmup+poly schedule; SURVEY.md item 24). The components exist here
for API completeness, as plain functions of the iteration returning the
learning rate, evaluated in float32 as the JAX schedules are; set a torch
optimizer's groups' ``lr`` to ``schedule(it)`` before update ``it``.
"""

from __future__ import annotations

import numpy as np

_F = np.float32


def constant_lr(lr: float):
    return lambda it: float(_F(lr))


def polynomial_lr(lr: float, max_iter: int, decay_iter: int = 1, power: float = 0.9):
    def schedule(it):
        eff = np.floor(_F(it) / _F(decay_iter)) * _F(decay_iter)
        return float(_F(lr) * np.power(_F(1.0) - eff / _F(max_iter), _F(power)))
    return schedule


def warmup_lr(base_schedule, warmup_iters: int = 500, mode: str = "linear",
              gamma: float = 0.2):
    """Wraps another schedule with a warmup phase (reference
    schedulers.py:27-52 semantics: 'linear' ramps gamma..1, 'constant'
    holds gamma)."""
    def schedule(it):
        base = _F(base_schedule(it))
        if mode == "linear":
            alpha = _F(it) / _F(warmup_iters)
            factor = _F(gamma) * (_F(1.0) - alpha) + alpha
        elif mode == "constant":
            factor = _F(gamma)
        else:
            raise KeyError(f"WarmUp type {mode} not implemented")
        return float(base * factor if it < warmup_iters else base)
    return schedule


KEY2SCHEDULER = {
    "constant_lr": constant_lr,
    "poly_lr": polynomial_lr,
}


def get_scheduler(name: str | None, **kwargs):
    if name is None:
        return None
    return KEY2SCHEDULER[name](**kwargs)
