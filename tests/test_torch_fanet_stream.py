"""The port's TD2-FANet (``tdnet_tpu_torch/models/fanet_td.py``) against the JAX
package's (``tdnet_tpu/models/fanet_td.py``), on the CPU, f32.

Same weights: JAX's tree shapes with seeded numpy leaves (He-normal convs and
fc, small biases, BatchNorm statistics and affines drawn so that no BN is the
identity), carried into a ``FATD`` by ``utils/from_jax.fatd_from_jax``; the
same seeded numpy frames. The port runs its plain attention (CPU tensors).

- the ``Streamer`` over 5 frames (cold, then warm: one hop a frame) against
  JAX's ``Streamer`` at 96x192, logits to atol / rtol 2e-5;
- ``fa_clip_forward`` in eval (f32) and in train mode (dropout off; float64,
  JAX with x64: at 64x128 layer4 and ffm_32 normalize over two values a
  channel, where f32 rounding of two near values is amplified without bound),
  both ``pos_id``: every output to atol / rtol 2e-5 and, in train mode, every
  BatchNorm running statistic to atol / rtol 2e-5 against JAX's
  ``updated_params``: the current head moved once (JAX drops its second
  pass's update), the other path's w_qs moved (no statistic frozen), the
  current path's w_ks did not.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tdnet_tpu.models.fanet_td import FATDConfig as JaxConfig
from tdnet_tpu.models.fanet_td import fa_clip_forward as jax_clip_forward
from tdnet_tpu.models.fanet_td import init_fatd as jax_init_fatd
from tdnet_tpu.nn.module import Ctx as JaxCtx
from tdnet_tpu.stream.runtime import Streamer as JaxStreamer
from tdnet_tpu_torch.models import FATDConfig, fa_clip_forward, tdnet_config
from tdnet_tpu_torch.nn import Ctx
from tdnet_tpu_torch.stream.runtime import Streamer
from tdnet_tpu_torch.utils.from_jax import fatd_from_jax, fatd_state_from_jax
from tests.test_torch_fanet import randomized_bn
from tests.test_torch_train_bf16 import seeded_tree

STREAM_HW = (96, 192)
CLIP_HW = (64, 128)


def fatd_tree(in_hw, seed: int):
    """A seeded FATD tree at ``in_hw`` (JAX config, port config, tree)."""
    jcfg = JaxConfig(in_size=in_hw)
    tree = randomized_bn(seeded_tree(lambda k: jax_init_fatd(k, jcfg), seed), seed + 1)
    return jcfg, tdnet_config("td2_fa", in_size=in_hw), tree


def test_config_matches_jax():
    jcfg, cfg, _ = fatd_tree((768, 1536), 0)
    assert isinstance(cfg, FATDConfig)
    for name in ("feat_hw", "kv_hw", "kv_tokens", "d_v", "window", "kv_stride",
                 "pool_before_proj", "aux", "path_num", "backbone"):
        assert getattr(cfg, name) == getattr(jcfg, name), name
    assert (cfg.feat_hw, cfg.kv_tokens, cfg.d_v) == ((96, 192), 32 * 64, 256)
    assert tdnet_config("td2-fa", in_size=(769, 1537), streaming=True, path_num=4).path_num == 2


def test_stream_matches_jax():
    jcfg, cfg, tree = fatd_tree(STREAM_HW, 3)
    rng = np.random.RandomState(4)
    frames = [(rng.randn(1, *STREAM_HW, 3) * 0.5).astype(np.float32) for _ in range(5)]
    ref = JaxStreamer(tree, jcfg)
    port = Streamer(fatd_from_jax(tree, cfg))
    assert not port.ctx.fused_trunk
    for i, f in enumerate(frames):
        want = np.asarray(ref.step(jnp.asarray(f), timed=False)[0])
        got = port.step(torch.from_numpy(f), timed=False)[0].numpy()
        assert got.shape == want.shape == (1, *STREAM_HW, 19)
        np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5, err_msg=f"frame {i}")
    assert port.cache.count == 5 and port.cache.v.shape == (1, 1, cfg.kv_tokens, 256)


def _stats(state: dict) -> dict:
    return {k: v for k, v in state.items() if "running_" in k}


@pytest.fixture(scope="module")
def clip_setup():
    jcfg, cfg, tree = fatd_tree(CLIP_HW, 5)
    frames = (np.random.RandomState(6).randn(2, 1, *CLIP_HW, 3) * 0.5).astype(np.float32)
    return jcfg, cfg, tree, frames


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("pos_id", [0, 1])
def test_clip_forward(clip_setup, pos_id, train):
    jcfg, cfg, tree, frames = clip_setup
    ctx = (JaxCtx(train=True, rng=jax.random.PRNGKey(0), use_dropout=False, attn_impl="xla")
           if train else JaxCtx(train=False))
    dt = np.float64 if train else np.float32
    frames = frames.astype(dt)
    with jax.enable_x64(train):
        want = jax.jit(lambda p, f: jax_clip_forward(p, f, pos_id, jcfg, ctx))(
            jax.tree.map(lambda a: jnp.asarray(a, dt), tree), jnp.asarray(frames))
        want = jax.tree.map(np.asarray, want)
    model = fatd_from_jax(tree, cfg).to(torch.from_numpy(frames).dtype).train(train)
    before = {k: v.clone() for k, v in _stats(model.state_dict()).items()}
    with torch.no_grad():
        got = fa_clip_forward(model, torch.from_numpy(frames), pos_id,
                              Ctx(train=train, use_dropout=False))
    assert "auxout" not in got
    for key in ("out", "out_sub", "out_lowres", "out_sub_lowres"):
        np.testing.assert_allclose(got[key].permute(0, 2, 3, 1).numpy(), np.asarray(want[key]),
                                   atol=2e-5, rtol=2e-5, err_msg=key)
    mine = _stats(model.state_dict())
    if not train:
        assert all(torch.equal(mine[k], before[k]) for k in mine)
        return
    upd = _stats(fatd_state_from_jax(want["updated_params"], cfg))
    assert set(upd) == set(mine) and len(mine) > 100
    for k in mine:
        np.testing.assert_allclose(mine[k].numpy(), upd[k].numpy(), atol=2e-5, rtol=2e-5,
                                   err_msg=k)
    moved = lambda prefix: [not torch.equal(mine[k], before[k]) for k in mine
                            if k.startswith(prefix)]
    other = 1 - pos_id
    assert all(moved(f"paths.{pos_id}.head.conv.bn."))
    assert all(moved(f"paths.{other}.enc.w_qs.")) and all(moved(f"paths.{pos_id}.enc.w_qs."))
    assert not any(moved(f"paths.{pos_id}.enc.w_ks.")) and all(moved(f"paths.{other}.enc.w_ks."))
    assert not any(moved(f"paths.{other}.head.")) and not any(moved("paths.0.head_aux."))
