"""AdaOptimizer (``tdnet_tpu/train/optim.py:75-155``; reference
Training/ptsemseg/optimizers/adaoptimizer.py).

SGD with momentum 0.9 (dampening 0) over two parameter groups: conv and
linear weights with weight decay 1e-4, and biases and norm affines without.
The learning rate warms up exponentially from ``warmup_start_lr`` to ``lr0``
over ``warmup_steps`` steps, then decays as poly 0.9 to ``max_iter``; update
``it`` (counted from 0) uses ``lr(it)``, as optax's scale_by_learning_rate
does. BatchNorm running statistics are buffers and are not optimized.

``get_optimizer`` is the reference's registry of seven plain optimizers
(``tdnet_tpu/train/optim.py:104-124``, Training/ptsemseg/optimizers/
__init__.py:8-17) with the numbers of the JAX package's optax transforms:
torch's own where it computes optax's function with optax's defaults (sgd,
adam, asgd, adamax, adadelta), written out where torch differs (adagrad:
optax starts the accumulator at 0.1 and adds eps 1e-7 inside the root;
rmsprop: optax decays by 0.9 and adds eps inside the root).
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


class _OptaxAdagrad(torch.optim.Optimizer):
    """optax.adagrad: s <- s + g^2 (s starting at ``initial_accumulator_value``),
    p <- p - lr * g / sqrt(s + eps) (0 where s is 0)."""

    def __init__(self, params, lr: float, initial_accumulator_value: float, eps: float):
        super().__init__(params, dict(lr=lr, initial=initial_accumulator_value, eps=eps))

    @torch.no_grad()
    def step(self):
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["sum"] = torch.full_like(p, group["initial"])
                s = state["sum"]
                s.copy_(p.grad * p.grad + s)
                scale = torch.where(s > 0, torch.rsqrt(s + group["eps"]), 0.0)
                p.add_(scale * p.grad, alpha=-group["lr"])


class _OptaxRMSprop(torch.optim.Optimizer):
    """optax.rmsprop (not centered): nu <- (1 - decay) g^2 + decay nu (nu starting
    at ``initial_scale``), u = -lr * g / sqrt(nu + eps), then with ``momentum``
    the trace t <- u + momentum t is the update."""

    def __init__(self, params, lr: float, decay: float, eps: float, initial_scale: float,
                 momentum: float | None):
        super().__init__(params, dict(lr=lr, decay=decay, eps=eps, initial=initial_scale,
                                      momentum=momentum))

    @torch.no_grad()
    def step(self):
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["nu"] = torch.full_like(p, group["initial"])
                nu, g = state["nu"], p.grad
                nu.copy_((1 - group["decay"]) * (g * g) + group["decay"] * nu)
                u = -group["lr"] * (torch.rsqrt(nu + group["eps"]) * g)
                if group["momentum"] is not None:
                    trace = state.setdefault("trace", torch.zeros_like(p))
                    u = trace.copy_(u + group["momentum"] * trace)
                p.add_(u)


KEY2OPT = {
    # torch-style SGD momentum == optax.sgd with trace accumulator
    "sgd": lambda params, lr=1e-2, momentum=0.0, weight_decay=0.0: torch.optim.SGD(
        params, lr=lr, momentum=momentum, weight_decay=weight_decay),
    "adam": lambda params, lr=1e-3, b1=0.9, b2=0.999, eps=1e-8: torch.optim.Adam(
        params, lr=lr, betas=(b1, b2), eps=eps),
    # tdnet_tpu/train/optim.py:31-72 is torch's ASGD written out for optax
    "asgd": lambda params, lr=1e-2, lambd=1e-4, alpha=0.75, t0=1e6, weight_decay=0.0:
        torch.optim.ASGD(params, lr=lr, lambd=lambd, alpha=alpha, t0=t0,
                         weight_decay=weight_decay),
    "adamax": lambda params, lr=2e-3, b1=0.9, b2=0.999, eps=1e-8: torch.optim.Adamax(
        params, lr=lr, betas=(b1, b2), eps=eps),
    "adadelta": lambda params, lr=1.0, rho=0.9, eps=1e-6, weight_decay=0.0:
        torch.optim.Adadelta(params, lr=lr, rho=rho, eps=eps, weight_decay=weight_decay),
    "adagrad": lambda params, lr=1e-2, initial_accumulator_value=0.1, eps=1e-7: _OptaxAdagrad(
        params, lr, initial_accumulator_value, eps),
    "rmsprop": lambda params, lr=1e-2, decay=0.9, eps=1e-8, initial_scale=0.0, momentum=None:
        _OptaxRMSprop(params, lr, decay, eps, initial_scale, momentum),
}


def get_optimizer(name: str, params, **kwargs) -> torch.optim.Optimizer:
    """Generic registry for non-Ada optimizers (the reference exposes 7
    torch optimizers alongside AdaOptimizer; the TDNet recipes only ever
    use adaoptimizer, and ``utils/config.py`` refuses the others)."""
    if name not in KEY2OPT:
        raise NotImplementedError(f"Optimizer {name} not implemented")
    return KEY2OPT[name](params, **kwargs)
