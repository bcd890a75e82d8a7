"""The port's bf16 mixed-precision TD2-FANet step against the JAX package's, on
the CPU, by ``tests/test_torch_train_bf16.py``'s rule.

A FATD at 128x256 (JAX's tree shapes with seeded numpy leaves, BatchNorms
drawn), OHEM, dropout off on both sides, no teacher, pos_id 1. The port's
``make_loss_of(compute_dtype=torch.bfloat16)`` against JAX's
``make_loss_of(compute_dtype=jnp.bfloat16)``: the port's loss within twice
JAX's |bf16 - f32| loss gap plus 1e-4 relative; every gradient f32.

Gradients: each tensor's share of that file's limit, err / (2 x JAX's max
|bf16 - f32| + 1e-3 x max|grad|), err the port's max distance from JAX's bf16
gradient. The port's bf16 noise is not JAX's: JAX rounds its resize's
matrices and products to bf16 and combines BatchNorm's dx in bf16, the port
rounds each once from f32 (``tests/test_torch_train_bf16_parts.py``), and
FANet runs four resizes and 84 BatchNorms a path. Two independent noises of
one size put a tensor at a share of 1 to 1.5 now and then (1.475 at most here,
on one of 264 tensors; 1.34 at most at 256x512, where BatchNorm sees four
times the values), while the median stays at 0.58 at both sizes. So the
median share must stay at most 0.75 (a rounding point off on the port's side
moves every tensor after it) and every share at most 2.

Mixed precision casts exactly ``_cast_wb``'s ``w``/``b`` leaves of the FATD
tree: every FANet conv, the encoding's convs and the hop's fc.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tdnet_tpu.models.fanet_td import FATDConfig as JaxConfig
from tdnet_tpu.models.fanet_td import init_fatd as jax_init_fatd
from tdnet_tpu.train import loss as jloss
from tdnet_tpu.train.trainer import _cast_wb
from tdnet_tpu.train.trainer import make_loss_of as jax_make_loss_of
from tdnet_tpu_torch.models import tdnet_config
from tdnet_tpu_torch.nn import step_generator
from tdnet_tpu_torch.train import loss as tloss
from tdnet_tpu_torch.train.trainer import cast_names, make_loss_of
from tdnet_tpu_torch.utils.from_jax import fatd_from_jax, fatd_state_from_jax
from tests.test_torch_fanet import randomized_bn
from tests.test_torch_train_bf16 import FAST_COMPILE, seeded_tree

IN_HW = (128, 256)
N_MIN = IN_HW[0] * IN_HW[1] // 16
POS_ID = 1


def _setup():
    jcfg = JaxConfig(in_size=IN_HW)
    tree = randomized_bn(seeded_tree(lambda k: jax_init_fatd(k, jcfg), 21), 22)
    rng = np.random.RandomState(23)
    frames = (rng.randn(2, 1, *IN_HW, 3) * 0.5).astype(np.float32)
    labels = rng.randint(0, 19, (1, *IN_HW))
    labels[:, :5] = 250
    return jcfg, tdnet_config("td2_fa", in_size=IN_HW, streaming=False), tree, frames, labels


@pytest.fixture(scope="module")
def runs():
    jcfg, cfg, tree, frames, labels = _setup()
    args = (tree, jnp.asarray(frames), jnp.asarray(labels.astype(np.int32)), jnp.int32(POS_ID),
            jax.random.PRNGKey(0), None)
    out = {}
    for name, dt in (("jax_bf16", jnp.bfloat16), ("jax_f32", None)):
        loss_of = jax_make_loss_of(jcfg, use_dropout=False, attn_impl="xla", compute_dtype=dt,
                                   loss_fn=lambda lg, lb: jloss.ohem_cross_entropy(
                                       lg, lb, n_min=N_MIN))
        vg = jax.jit(jax.value_and_grad(loss_of, has_aux=True)).lower(*args).compile(
            compiler_options=FAST_COMPILE)
        (loss, _), grads = vg(*args)
        out[name] = (float(loss), {k: g.float() for k, g in
                                   fatd_state_from_jax(grads, cfg).items()})
    model = fatd_from_jax(tree, cfg).train()
    loss_of = make_loss_of(use_dropout=False, compute_dtype=torch.bfloat16,
                           loss_fn=lambda lg, lb: tloss.ohem_cross_entropy(lg, lb, n_min=N_MIN))
    loss, _ = loss_of(model, torch.from_numpy(frames), torch.from_numpy(labels), POS_ID,
                      step_generator(0, 0))
    loss.backward()
    out["port_bf16"] = (loss.item(), {k: p.grad for k, p in model.named_parameters()
                                      if p.grad is not None})
    return out


def test_bf16_loss_tracks_jax(runs):
    (pl, _), (jl, _), (fl, _) = runs["port_bf16"], runs["jax_bf16"], runs["jax_f32"]
    assert np.isfinite(pl) and jl != fl
    assert abs(pl - jl) <= 2 * abs(jl - fl) + 1e-4 * abs(jl), (pl, jl, fl)


def test_bf16_gradients_track_jax(runs):
    got, want, f32 = runs["port_bf16"][1], runs["jax_bf16"][1], runs["jax_f32"][1]
    assert set(got) <= set(want) and len(got) > 200
    shares = {}
    for k, g in got.items():
        assert g.dtype == torch.float32, k
        gap = (want[k] - f32[k]).abs().max().item()
        err = (g - want[k]).abs().max().item()
        shares[k] = err / (2 * gap + 1e-3 * want[k].abs().max().item())
    worst = max(shares, key=shares.get)
    assert np.median(list(shares.values())) <= 0.75, np.median(list(shares.values()))
    assert shares[worst] <= 2.0, (worst, shares[worst])


def test_cast_set_is_cast_wbs():
    _, cfg, tree, _, _ = _setup()
    marked = fatd_state_from_jax(_cast_wb(tree, np.float64), cfg)
    want = {k for k, t in marked.items() if t.dtype == torch.float64}
    got = set(cast_names(fatd_from_jax(tree, cfg)))
    assert want and got == want
    assert "paths.0.ffm_32.w_qs.conv.weight" in got and "atn.1.0.b" in got
    assert "paths.0.ln.weight" not in got and "paths.0.head.conv.bn.weight" not in got
