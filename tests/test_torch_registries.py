"""The port's scheduler and optimizer registries against the JAX package's
(``tdnet_tpu/train/schedulers.py``, ``tdnet_tpu/train/optim.py:KEY2OPT``).

Schedules: the learning rate at iterations 0, 1, 499, 500 and 39,999 to rtol
1e-6 (both evaluate in float32; ``pow`` may round one ulp apart). Optimizers:
the same seeded float32 parameters and gradients through 3 updates of each
of the 7 optimizers and of optax's transform from ``get_optimizer``, the
parameters after every update to rtol 1e-6.
"""

import numpy as np
import optax
import pytest
import torch

import jax.numpy as jnp

from tdnet_tpu.train import optim as jax_optim
from tdnet_tpu.train import schedulers as jax_schedulers
from tdnet_tpu_torch.train import optim, schedulers

ITERS = (0, 1, 499, 500, 39999)


def _schedules(m):
    return {
        "constant_lr": m.get_scheduler("constant_lr", lr=0.01),
        "poly_lr": m.get_scheduler("poly_lr", lr=0.01, max_iter=40000),
        "poly_lr_decay_3": m.polynomial_lr(0.01, 40000, decay_iter=3, power=0.8),
        "warmup_linear": m.warmup_lr(m.polynomial_lr(0.01, 40000), warmup_iters=500),
        "warmup_constant": m.warmup_lr(m.constant_lr(0.01), warmup_iters=500, mode="constant",
                                       gamma=0.1),
    }


@pytest.mark.parametrize("name", list(_schedules(schedulers)))
def test_scheduler_matches_jax(name):
    got, want = _schedules(schedulers)[name], _schedules(jax_schedulers)[name]
    for it in ITERS:
        np.testing.assert_allclose(got(it), float(want(it)), rtol=1e-6, err_msg=f"it {it}")
    assert schedulers.get_scheduler(None) is None
    with pytest.raises(KeyError, match="WarmUp type"):
        schedulers.warmup_lr(schedulers.constant_lr(0.1), mode="cosine")(0)


@pytest.mark.parametrize("name,kwargs", [
    ("sgd", {"momentum": 0.9, "weight_decay": 1e-4}), ("adam", {}), ("asgd", {}),
    ("adamax", {}), ("adadelta", {}), ("adagrad", {}), ("rmsprop", {})])
def test_optimizer_matches_optax(name, kwargs):
    rng = np.random.RandomState(0)
    init = {"w": rng.randn(8, 5).astype(np.float32), "b": rng.randn(5).astype(np.float32)}
    grads = [{k: rng.randn(*v.shape).astype(np.float32) for k, v in init.items()}
             for _ in range(3)]
    tx = jax_optim.get_optimizer(name, **kwargs)
    jp = {k: jnp.asarray(v) for k, v in init.items()}
    state = tx.init(jp)
    params = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in init.items()}
    opt = optim.get_optimizer(name, list(params.values()), **kwargs)
    for step, g in enumerate(grads):
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in params.items():
            p.grad = torch.from_numpy(g[k].copy())
        opt.step()
        for k, p in params.items():
            assert p.dtype == torch.float32
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]), rtol=1e-6,
                                       err_msg=f"{name} step {step} {k}")


def test_unknown_optimizer_and_the_config_rule():
    from tdnet_tpu_torch.utils.config import opt_kwargs_from_yaml
    with pytest.raises(NotImplementedError, match="Optimizer lamb not implemented"):
        optim.get_optimizer("lamb", [torch.nn.Parameter(torch.ones(1))])
    cfg = {"training": {"train_iters": 10, "optimizer": {"name": "sgd", "lr": 0.1}}}
    with pytest.raises(NotImplementedError, match="only adaoptimizer"):
        opt_kwargs_from_yaml(cfg)
