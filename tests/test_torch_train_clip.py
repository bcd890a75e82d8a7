"""The port's ``clip_forward`` in train mode against the JAX package's, f32
on the CPU.

Same weights (JAX ``init_tdnet`` through ``utils/from_jax.py``) and the same
numpy frames go through both, dropout off (masks are impl-defined,
docs/PARITY.md), the JAX side jitted with its XLA attention. For TD4-PSP18
(P=4, pooled before the projections) and TD2-PSP50 (P=2, pooled after) at
65x129, batch 1: every output to atol 2e-3 / rtol 1e-3
(tests/test_clip_parity.py:152), and every BatchNorm running statistic to
atol 1e-4 / rtol 1e-4, among them the oldest frame's w_qs, which must not
move, and the current head's, updated twice.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tdnet_tpu.models.tdnet import clip_forward as jax_clip_forward
from tdnet_tpu.models.tdnet import init_tdnet as jax_init_tdnet
from tdnet_tpu.nn.module import Ctx as JaxCtx
from tdnet_tpu_torch.models import clip_forward
from tdnet_tpu_torch.nn import Ctx
from tdnet_tpu_torch.utils.from_jax import tdnet_from_jax, tdnet_state_from_jax
from tests.test_torch_train import _configs, _data


def nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).numpy()


def _running_stats(state: dict) -> dict:
    return {k: v for k, v in state.items() if "running_" in k}


@pytest.mark.parametrize("arch,pos_id", [("td4-psp18", 1), ("td4-psp18", 3), ("td2-psp50", 0)])
def test_clip_forward_train(arch, pos_id):
    jcfg, cfg = _configs(arch)
    params = jax_init_tdnet(jax.random.PRNGKey(pos_id), jcfg)
    frames, _ = _data(cfg.path_num, seed=pos_id)
    ctx = JaxCtx(train=True, rng=jax.random.PRNGKey(0), use_dropout=False, attn_impl="xla")
    want = jax.jit(lambda pr, fr: jax_clip_forward(pr, fr, pos_id, jcfg, ctx))(
        params, jnp.asarray(frames))

    model = tdnet_from_jax(params, cfg).train()
    before = {k: v.clone() for k, v in _running_stats(model.state_dict()).items()}
    got = clip_forward(model, torch.from_numpy(frames), pos_id, Ctx(train=True, use_dropout=False))
    for key in ("out", "out_sub", "auxout", "out_lowres", "out_sub_lowres"):
        np.testing.assert_allclose(nhwc(got[key]), np.asarray(want[key]), atol=2e-3, rtol=1e-3,
                                   err_msg=key)

    upd = _running_stats(tdnet_state_from_jax(want["updated_params"], cfg))
    mine = _running_stats(model.state_dict())
    assert set(upd) == set(mine) and len(mine) > 50
    for k in mine:
        np.testing.assert_allclose(mine[k].numpy(), upd[k].numpy(), atol=1e-4, rtol=1e-4,
                                   err_msg=k)
    oldest = (pos_id + 1) % cfg.path_num
    for k in mine:
        if k.startswith(f"paths.{oldest}.enc.w_qs."):
            assert torch.equal(mine[k], before[k]), k      # the oldest frame's w_qs: frozen
    moved = [k for k in mine if k.startswith(f"paths.{pos_id}.head.bn.")]
    assert moved and all(not torch.equal(mine[k], before[k]) for k in moved)
