"""The training step (``tdnet_tpu/train/trainer.py:make_train_state`` and
``make_train_step``), f32 or bf16 mixed precision.

Loss recipe (reference td4_psp.py:367-374):
  loss = CE(out) + 0.5 CE(out_sub) + 0.1 CE(auxout) + KD
  KD   = KL(out_lowres || T_full) + 0.5 KL(out_sub_lowres || T_group[pos_id])
at the c4 grid, the frozen teacher run on the current frame. A TD2-FANet
(``FATD``) has no aux term (td2_fa.py:205-211); the forward is
``models.model_clip_forward(cfg)``, the clip forward of the model's type.
One backward and one AdaOptimizer update per step; every parameter takes part in the update
(a parameter the step did not reach gets a zero gradient, so that its weight
decay and momentum run as optax runs them). The step's dropout draws come
from a generator seeded by (seed, it).

Data-parallel (``group``, a ``DataGroup`` of ``parallel/mesh.py``): each rank
runs the step on its share of the global batch, with its BatchNorms' moments
taken over every rank's share (``ops.norm.sync_batch_norm``), the loss over
its local batch (OHEM as the reference's per-GPU criterion, ``loss_fn_from_yaml(
n_devices=world)``) and the teacher on its local batch; then the gradients,
the loss and the KD term are averaged over the ranks in one flat all-reduce,
the gradient of the global mean as the JAX mesh gives it, and every rank runs
the same update. ``make_train_state`` broadcasts rank 0's parameters and
buffers once. Rank r draws its dropout from ``step_generator(seed, it, r)``.
A world of 1 runs the one-process step.

``conv_wgrad`` picks the residual blocks' dilated convs: ``"cudnn"`` (the
default, ``F.conv2d`` and autograd) or ``"kernel"``, the JAX package's
``conv_wgrad="pallas"`` (``tdnet_tpu/train/trainer.py:124-132``): the stride-1
3x3 convs with dilation >= 4 through K5 (``kernels/dilated_conv.py``). The
teacher's stem stays plain, as the JAX trainer's ``teacher_stem = "xla"``.

``compute_dtype=torch.bfloat16`` is the JAX package's opt-in mixed precision
(``compute_dtype=jnp.bfloat16``, ``tdnet_tpu/train/trainer.py:147-177``;
the YAML key ``training.mixed_precision``, ``utils/config.py:
compute_dtype_from_yaml``): the forward and backward run on bf16 casts of the
conv and linear weights and biases (``Conv2d`` and the attention fc,
``_cast_wb``'s ``w``/``b`` leaves), made each step from the f32 masters by a
differentiable cast, so each master's gradient is the bf16 gradient cast up;
the frames and the teacher's conv weights are cast too (once a step). Norm
affines and BatchNorm running statistics stay f32: the statistics update in
place from f32 moments into the f32 buffers (``_graft_bn_stats``), and the
losses run in f32. K2 and K3 then run their bf16 kernels, and with
``conv_wgrad="kernel"`` so does K5 (the JAX package's bf16 Pallas conv). The
default, None, is the f32 recipe.

``make_eval_step`` is the validation forward: the clip in eval mode, the
argmax of its logits.

``full_recipe(yaml)`` builds a YAML's full recipe on seeded random weights and
data at its crop, batch 1; ``td4_full_recipe`` (TD4-PSP18), ``td2_full_recipe``
(TD2-PSP50) and ``td2_fa_full_recipe`` (TD2-FANet) are its three configs.

Every step, and every call of ``make_loss_of``'s function, runs without TF32
(``ops.dtype.no_tf32``): cuDNN's convs and the f32 matrix products keep f32's
precision whatever the caller set.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os

import torch
from torch import nn

from tdnet_tpu_torch.models import Teacher, apply_teacher, init_model, model_clip_forward
from tdnet_tpu_torch.nn import Ctx, step_generator
from tdnet_tpu_torch.nn.encoding import Attention
from tdnet_tpu_torch.ops import Conv2d
from tdnet_tpu_torch.ops.dtype import no_tf32
from tdnet_tpu_torch.ops.norm import sync_batch_norm
from tdnet_tpu_torch.train.loss import cross_entropy, kl_divergence
from tdnet_tpu_torch.train.optim import ada_optimizer

CONFIGS = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "configs")
RECIPE_YAML = os.path.join(CONFIGS, "td4_psp18_cityscapes.yml")
TD2_RECIPE_YAML = os.path.join(CONFIGS, "td2_psp50_cityscapes.yml")
TD2_FA_RECIPE_YAML = os.path.join(CONFIGS, "td2_fa_cityscapes.yml")


@dataclasses.dataclass
class TrainState:
    model: nn.Module     # a TDNet or a FATD
    optimizer: torch.optim.Optimizer
    schedule: object
    it: int = 0
    seed: int = 0


def make_train_state(model: nn.Module, *, seed: int = 0, opt_kwargs: dict | None = None,
                     group=None) -> TrainState:
    """The model in train mode with its AdaOptimizer (``opt_kwargs`` over
    ``ada_optimizer``'s defaults, the reference's recipe); ``seed`` seeds the
    dropout of every step. With a data ``group`` every rank starts from rank 0's
    parameters and buffers."""
    if group is not None and group.world > 1:
        with torch.no_grad():
            for t in list(model.parameters()) + list(model.buffers()):
                group.broadcast_(t.data)
    opt, schedule = ada_optimizer(model.train(), **(opt_kwargs or {}))
    return TrainState(model=model, optimizer=opt, schedule=schedule, seed=seed)


COMPUTE_DTYPES = (None, torch.bfloat16)


def cast_names(model: nn.Module) -> list[str]:
    """The parameters that mixed precision casts, ``_cast_wb``'s ``w``/``b``
    leaves: the weights and biases of every ``Conv2d`` and attention fc."""
    return [f"{name}.{p}" if name else p for name, mod in model.named_modules()
            if isinstance(mod, (Conv2d, Attention)) for p, _ in mod.named_parameters(recurse=False)]


class _Call(nn.Module):
    """``fn(model, *args)`` as a module, for ``torch.func.functional_call``."""

    def __init__(self, fn, model: nn.Module):
        super().__init__()
        self.fn, self.model = fn, model

    def forward(self, *args):
        return self.fn(self.model, *args)


def call_cast(fn, model: nn.Module, dtype: torch.dtype | None, *args):
    """``fn(model, *args)``, with ``dtype`` casts of the model's ``cast_names``
    parameters in their place (a differentiable cast of each f32 master);
    every other parameter and every buffer is the model's own, so BatchNorm's
    running statistics update in place in f32. ``dtype=None`` calls it as it is."""
    if dtype is None:
        return fn(model, *args)
    named = dict(model.named_parameters())
    casts = {f"model.{name}": named[name].to(dtype) for name in cast_names(model)}
    return torch.func.functional_call(_Call(fn, model), casts, args)


def make_loss_of(*, loss_fn=None, use_dropout: bool = True, conv_wgrad: str = "cudnn",
                 compute_dtype: torch.dtype | None = None):
    """``loss_of(model, frames, labels, pos_id, generator, teacher=None)
    -> (loss, kd)``; frames NHWC [P, n, H, W, 3] (oldest .. current), labels
    [n, H, W]. ``use_dropout=False``: train-mode BN without dropout.
    ``compute_dtype``: None (f32) or ``torch.bfloat16`` (mixed precision)."""
    if compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype {compute_dtype} not in {COMPUTE_DTYPES}")
    if loss_fn is None:
        loss_fn = lambda lg, lb: cross_entropy(lg, lb, 250)

    def loss_of(model: nn.Module, frames, labels, pos_id: int, generator, teacher=None):
        with no_tf32():
            ctx = Ctx(train=True, use_dropout=use_dropout, generator=generator,
                      conv_wgrad=conv_wgrad)
            if compute_dtype is not None:
                frames = frames.to(compute_dtype)
            res = call_cast(model_clip_forward(model.cfg), model, compute_dtype, frames, pos_id,
                            ctx)
            loss = loss_fn(res["out"], labels) + 0.5 * loss_fn(res["out_sub"], labels)
            if model.cfg.aux:
                loss = loss + 0.1 * loss_fn(res["auxout"], labels)
            kd = torch.zeros((), device=loss.device)
            if teacher is not None:
                t_full, t_grp = call_cast(apply_teacher, teacher, compute_dtype, frames[-1],
                                          pos_id)
                kd = (kl_divergence(res["out_lowres"], t_full)
                      + 0.5 * kl_divergence(res["out_sub_lowres"], t_grp))
                loss = loss + kd
        return loss, kd

    return loss_of


def average_gradients(model: nn.Module, group, *extra: torch.Tensor) -> list[torch.Tensor]:
    """Every parameter's ``.grad`` and the scalars ``extra`` averaged over the
    ranks of ``group`` in one flat all-reduce; returns the averaged ``extra``."""
    params = list(model.parameters())
    flat = torch.cat([p.grad.reshape(-1) for p in params]
                     + [e.detach().to(params[0].grad.dtype).reshape(1) for e in extra])
    group.all_reduce_(flat).div_(group.world)
    at = 0
    for p in params:
        p.grad.copy_(flat[at:at + p.numel()].view_as(p.grad))
        at += p.numel()
    return [flat[at + i] for i in range(len(extra))]


def make_train_step(*, loss_fn=None, use_dropout: bool = True, conv_wgrad: str = "cudnn",
                    compute_dtype: torch.dtype | None = None, group=None):
    """``step(state, frames, labels, pos_id, teacher=None) -> {loss, kd, lr}``.
    After the step each parameter's ``.grad`` holds this step's gradient, in
    f32 with any ``compute_dtype``. With a data ``group`` of more than one rank,
    frames and labels are this rank's share, and the gradient, ``loss`` and
    ``kd`` are the means over the ranks."""
    loss_of = make_loss_of(loss_fn=loss_fn, use_dropout=use_dropout, conv_wgrad=conv_wgrad,
                           compute_dtype=compute_dtype)
    if group is not None and group.world <= 1:
        group = None

    def step(state: TrainState, frames, labels, pos_id: int, teacher: Teacher | None = None):
        model, opt = state.model, state.optimizer
        rank, synced = ((0, contextlib.nullcontext()) if group is None
                        else (group.rank, sync_batch_norm(model, group)))
        with no_tf32(), synced:
            opt.zero_grad(set_to_none=False)
            loss, kd = loss_of(model, frames, labels, pos_id,
                               step_generator(state.seed, state.it, rank), teacher)
            loss.backward()
            for p in model.parameters():
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            if group is not None:
                loss, kd = average_gradients(model, group, loss, kd)
            lr = state.schedule(state.it)
            for param_group in opt.param_groups:
                param_group["lr"] = lr
            opt.step()
        state.it += 1
        return {"loss": loss.detach(), "kd": kd.detach(), "lr": lr}

    return step


def make_eval_step():
    """``eval_step(model, frames, pos_id) -> pred [n, H, W]`` (int64): the
    validation forward (``tdnet_tpu/train/trainer.py:218-235``), the clip
    forward in eval mode (the attention hops through K1, the BatchNorms on
    their running statistics, which it leaves unmoved) and the argmax of
    ``out`` over classes. It restores the model's mode after."""

    def eval_step(model: nn.Module, frames: torch.Tensor, pos_id: int) -> torch.Tensor:
        was_training = model.training
        model.eval()
        try:
            with torch.no_grad(), no_tf32():
                res = model_clip_forward(model.cfg)(model, frames, pos_id, Ctx(train=False))
                return res["out"].argmax(dim=1)
        finally:
            model.train(was_training)

    return eval_step


def full_recipe(yaml_path: str, *, seed: int = 0, conv_wgrad: str = "cudnn",
                compute_dtype: torch.dtype | None = None, device: str = "cuda",
                batch: int = 1, n_devices: int = 1):
    """The full training recipe of a YAML config (model, teacher, loss and
    optimizer sections: kv_stride 3, the aux head where the model has one,
    OHEM, KD from its grouped ResNet-101 teacher, AdaOptimizer) at its crop on one card at batch 1, as
    ``bench_train.py:49-64`` runs it on the TPU, on seeded random weights,
    frames and labels (a corner band at the ignore label 250).
    ``compute_dtype``: None, the f32 recipe, or ``torch.bfloat16``, mixed
    precision (for a YAML, ``utils.config.compute_dtype_from_yaml``).
    ``batch`` and ``n_devices``: the batch and the loss's device count (OHEM's
    n_min is a device's), so that one process can take a data group's global
    batch with its loss.

    Returns (state, step, teacher, frames [P, n, H, W, 3], labels [n, H, W],
    loss_fn), all on ``device``."""
    from tdnet_tpu_torch.models import init_teacher
    from tdnet_tpu_torch.utils.config import (load_config, loss_fn_from_yaml,
                                              model_config_from_yaml, opt_kwargs_from_yaml,
                                              teacher_config_from_yaml)
    yml = load_config(yaml_path)
    yml["training"]["batch_size"] = batch
    cfg = model_config_from_yaml(yml)
    model = init_model(cfg, torch.Generator().manual_seed(seed)).to(device)
    teacher = init_teacher(teacher_config_from_yaml(yml),
                           torch.Generator().manual_seed(seed + 1)).to(device)
    loss_fn = loss_fn_from_yaml(yml, n_devices=n_devices)
    state = make_train_state(model, seed=seed, opt_kwargs=opt_kwargs_from_yaml(yml))
    gen = torch.Generator().manual_seed(seed + 2)
    frames = torch.randn(cfg.path_num, batch, *cfg.in_size, 3, generator=gen).to(device)
    labels = torch.randint(0, cfg.nclass, (batch, *cfg.in_size), generator=gen)
    labels[:, :64] = 250
    labels[:, :, :32] = 250
    step = make_train_step(loss_fn=loss_fn, conv_wgrad=conv_wgrad, compute_dtype=compute_dtype)
    return state, step, teacher, frames, labels.to(device), loss_fn


def td4_full_recipe(**kw):
    """The TD4-PSP18 full recipe of ``configs/td4_psp18_cityscapes.yml`` at
    769x1537 (``full_recipe``'s keywords): 4 ResNet-18 paths, pooled before
    the projections, a 4-path teacher."""
    return full_recipe(RECIPE_YAML, **kw)


def td2_full_recipe(**kw):
    """The TD2-PSP50 full recipe of ``configs/td2_psp50_cityscapes.yml`` at
    769x1537 (``full_recipe``'s keywords): 2 ResNet-50 paths, projected before
    they pool, a ``pspnet_2p`` teacher."""
    return full_recipe(TD2_RECIPE_YAML, **kw)


def td2_fa_full_recipe(**kw):
    """The TD2-FANet full recipe of ``configs/td2_fa_cityscapes.yml`` at 768x1536
    (``full_recipe``'s keywords): 2 FANet-18 paths, projected before they pool,
    d_v 256, no aux loss, a ``pspnet_2p`` ResNet-101 teacher."""
    return full_recipe(TD2_FA_RECIPE_YAML, **kw)
