"""The port's bf16 train step with the dilated convs through K5, against the JAX package's.

TD4-PSP18 and TD2-PSP50 at (65, 129), kv_stride 3, aux head, OHEM, dropout off
on both sides, JAX on its XLA attention. The port's ``make_loss_of(
compute_dtype=torch.bfloat16, conv_wgrad="kernel")`` (layer4's dilated convs
through ``conv2d_dil``, on the CPU its plain version) against JAX's
``make_loss_of(compute_dtype=jnp.bfloat16, conv_wgrad="pallas")`` with the
Pallas kernel in interpret mode. The JAX tree comes from
``tests/test_torch_train_bf16.py:seeded_tree``.

The rule of ``tests/test_torch_train_bf16.py``: bf16 rounds every conv's
output and the two sum the other convs in other orders, so JAX's own bf16 run
against its f32 run (also ``conv_wgrad="pallas"``) measures the noise: the
port's loss lies within twice JAX's |bf16 - f32| loss gap plus 1e-4
relative, and each gradient within twice JAX's per-tensor max |bf16 - f32|
distance plus 1e-3 x max|grad| of that tensor, plus the distance on that
tensor of the port's bf16 cuDNN step (``conv_wgrad="cudnn"``) from JAX's
default bf16 step. That last term is there because the rule alone does not
hold for bf16 steps that differ only in rounding: on a few gradients that are
mostly bf16 noise (a BN bias after the PSP, |bf16 - f32| near max|grad|) the
port's cuDNN step lies beyond it too (1.30 x the rule from JAX's Pallas step
at TD4, 1.06 x from JAX's default step at TD2), and JAX's own default and
Pallas steps lie 0.89 x (TD4) and 0.94 x (TD2) apart
(``tests/torch_bf16_rule_report.py`` prints these shares). K5 changes only
layer4's dilated convs, so a
faulty K5 moves its path away from JAX's Pallas step while the cuDNN term
stays at the noise. A spy shows that bf16 tensors reach ``conv2d_dil`` at
layer4's dilations, in every path.
"""

import collections

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tdnet_tpu.kernels import dilated_conv as jdc
from tdnet_tpu.models.tdnet import TDNetConfig as JaxConfig
from tdnet_tpu.models.tdnet import init_tdnet as jax_init_tdnet
from tdnet_tpu.train import loss as jloss
from tdnet_tpu.train.trainer import make_loss_of as jax_make_loss_of
from tdnet_tpu_torch.models import tdnet_config
from tdnet_tpu_torch.nn import resnet as tresnet
from tdnet_tpu_torch.nn import step_generator
from tdnet_tpu_torch.train import loss as tloss
from tdnet_tpu_torch.train.trainer import make_loss_of
from tdnet_tpu_torch.utils.from_jax import tdnet_from_jax, tdnet_state_from_jax
from tests.test_torch_train_bf16 import FAST_COMPILE, seeded_tree
from torch_threads import few_threads  # noqa: F401  (the file runs on two threads)

IN_HW = (65, 129)
N_MIN = IN_HW[0] * IN_HW[1] // 16
POS_ID = 1
# arch: (JAX config keywords, the dilations one path's layer4 sends to K5)
ARCHS = {"td4-psp18": (dict(backbone="resnet18", path_num=4, pool_before_proj=True),
                       [4, 4, 8, 4]),
         "td2-psp50": (dict(backbone="resnet50", path_num=2, pool_before_proj=False),
                       [4, 8, 16])}


def _data(p: int):
    rng = np.random.RandomState(20)
    frames = (rng.randn(p, 1, *IN_HW, 3) * 0.5).astype(np.float32)
    labels = rng.randint(0, 19, (1, *IN_HW))
    labels[:, :7] = 250
    return frames, labels


def bf16_runs(arch: str) -> dict:
    """Loss and gradients of JAX in bf16 and f32 (``conv_wgrad="pallas"``, the
    kernel in interpret mode) and in bf16 with its default convs, and of the
    port in bf16 with ``conv_wgrad="kernel"`` and ``"cudnn"``, from one state,
    dropout off; and the (dtype, dilation) of every call that reached
    ``conv2d_dil``."""
    kw, _ = ARCHS[arch]
    jcfg = JaxConfig(nclass=19, in_size=IN_HW, kv_stride=3, aux=True, **kw)
    cfg = tdnet_config(arch, in_size=IN_HW, streaming=False)
    params = seeded_tree(lambda k: jax_init_tdnet(k, jcfg), seed=11)
    frames, labels = _data(jcfg.path_num)
    out = {"arch": arch}
    args = (params, jnp.asarray(frames), jnp.asarray(labels.astype(np.int32)),
            jnp.int32(POS_ID), jax.random.PRNGKey(0), None)
    orig = jdc.pl.pallas_call
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jdc.pl, "pallas_call", lambda *a, **k: orig(*a, **{**k, "interpret": True}))
        for name, dt, conv_wgrad in (("jax_bf16", jnp.bfloat16, "pallas"),
                                     ("jax_f32", None, "pallas"),
                                     ("jax_bf16_default", jnp.bfloat16, None)):
            loss_of = jax_make_loss_of(jcfg, use_dropout=False, attn_impl="xla", compute_dtype=dt,
                                       conv_wgrad=conv_wgrad,
                                       loss_fn=lambda lg, lb: jloss.ohem_cross_entropy(
                                           lg, lb, n_min=N_MIN))
            vg = jax.jit(jax.value_and_grad(loss_of, has_aux=True)).lower(*args).compile(
                compiler_options=FAST_COMPILE)
            (loss, _), grads = vg(*args)
            out[name] = (float(loss), {k: g.float() for k, g in
                                       tdnet_state_from_jax(grads, cfg).items()})

    seen = []

    def spy(x, w, padding, dilation):
        seen.append((x.dtype, w.dtype, dilation))
        return conv2d_dil(x, w, padding, dilation)

    conv2d_dil = tresnet.conv2d_dil
    for name, conv_wgrad in (("port_bf16", "kernel"), ("port_bf16_cudnn", "cudnn")):
        model = tdnet_from_jax(params, cfg)
        loss_of = make_loss_of(use_dropout=False, compute_dtype=torch.bfloat16,
                               conv_wgrad=conv_wgrad, loss_fn=lambda lg, lb:
                               tloss.ohem_cross_entropy(lg, lb, n_min=N_MIN))
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(tresnet, "conv2d_dil", spy)
            loss, _ = loss_of(model, torch.from_numpy(frames), torch.from_numpy(labels), POS_ID,
                              step_generator(0, 0))
        loss.backward()
        out[name] = (loss.item(), {k: p.grad for k, p in model.named_parameters()
                                   if p.grad is not None})
    out["calls"] = seen   # the cuDNN step sends none
    return out


@pytest.fixture(scope="module", params=list(ARCHS))
def runs(request):
    return bf16_runs(request.param)


def rule_share(got: dict, want: dict, f32: dict) -> tuple[float, str]:
    """The largest share, over the gradients, of ``tests/test_torch_train_bf16.py``'s
    limit (twice ``want``'s distance from ``f32`` plus 1e-3 x max|want|) that
    ``got``'s distance from ``want`` takes, and its gradient."""
    shares = []
    for k, g in got.items():
        limit = 2 * (want[k] - f32[k]).abs().max().item() + 1e-3 * want[k].abs().max().item()
        shares.append(((g - want[k]).abs().max().item() / max(limit, 1e-30), k))
    return max(shares)


def test_bf16_k5_loss_tracks_jax(runs):
    (pl, _), (jl, _), (fl, _) = runs["port_bf16"], runs["jax_bf16"], runs["jax_f32"]
    assert np.isfinite(pl) and jl != fl
    assert abs(pl - jl) <= 2 * abs(jl - fl) + 1e-4 * abs(jl), (pl, jl, fl)


def test_bf16_k5_gradients_track_jax(runs):
    got, want, f32 = runs["port_bf16"][1], runs["jax_bf16"][1], runs["jax_f32"][1]
    cudnn, default = runs["port_bf16_cudnn"][1], runs["jax_bf16_default"][1]
    assert set(got) <= set(want) and len(got) > 100
    for k, g in got.items():
        assert g.dtype == torch.float32, k
        gap = (want[k] - f32[k]).abs().max().item()
        err = (g - want[k]).abs().max().item()
        beside = (cudnn[k] - default[k]).abs().max().item()
        assert err <= 2 * gap + 1e-3 * want[k].abs().max().item() + beside, \
            (f"{k}: {err} from JAX bf16, JAX's bf16 - f32 {gap}, max|grad| "
             f"{want[k].abs().max()}, the cuDNN step from JAX's default {beside}")


def test_bf16_tensors_reach_the_dilated_conv(runs):
    """Every path's layer4 sends its dilated convs to ``conv2d_dil`` in bf16."""
    kw, dilations = ARCHS[runs["arch"]]
    calls = runs["calls"]
    assert all(x == w == torch.bfloat16 for x, w, _ in calls), calls
    assert collections.Counter(d for _, _, d in calls) == collections.Counter(
        dilations * kw["path_num"])
