"""The parts of the port's training step against the JAX package's, f32 on
the CPU: train-mode BatchNorm, the losses, AdaOptimizer and the teacher.

Same numpy inputs and the same weights (JAX initializers through
``utils/from_jax.py``) go through both; gradients come from ``jax.vjp`` and
torch autograd on the same cotangents. Tolerances are stated per test.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tdnet_tpu.models.teacher import TeacherConfig as JaxTeacherConfig
from tdnet_tpu.models.teacher import apply_teacher as jax_apply_teacher
from tdnet_tpu.models.teacher import init_teacher as jax_init_teacher
from tdnet_tpu.nn import heads as jheads
from tdnet_tpu.ops.norm import batch_norm as jax_batch_norm
from tdnet_tpu.train import loss as jloss
from tdnet_tpu.train.optim import ada_optimizer as jax_ada_optimizer
from tdnet_tpu_torch.models import TeacherConfig, apply_teacher
from tdnet_tpu_torch.nn import FCNHead
from tdnet_tpu_torch.ops import BatchNorm
from tdnet_tpu_torch.train import loss as tloss
from tdnet_tpu_torch.train.optim import ada_optimizer
from tdnet_tpu_torch.utils.from_jax import convert_tree, teacher_from_jax


def nchw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).numpy()


# ---- train-mode BatchNorm: output, running stats, gradients ------------------
# f32 with the statistics taken in another float order (E[x^2] - E[x]^2 in JAX,
# torch's own batch_norm here): atol/rtol 1e-5 on outputs and stats, 1e-4 on
# gradients (sums over n*h*w elements).

@pytest.mark.parametrize("shape,activation,residual", [
    ((2, 9, 11, 16), "relu", False),
    ((1, 13, 7, 32), "leaky_relu", False),
    ((2, 6, 5, 16), "relu", True),
    ((1, 1, 1, 24), "relu", False),      # one value a channel: the PSP pool-1 branch
])
def test_batch_norm_train(shape, activation, residual):
    rng = np.random.RandomState(sum(shape))
    c = shape[-1]
    x = (rng.randn(*shape) * 2 + 0.5).astype(np.float32)
    res = rng.randn(*shape).astype(np.float32) if residual else None
    p = dict(scale=rng.rand(c).astype(np.float32) + 0.5, bias=rng.randn(c).astype(np.float32),
             mean=rng.randn(c).astype(np.float32) * 0.1,
             var=rng.rand(c).astype(np.float32) + 0.5)
    dy = rng.randn(*shape).astype(np.float32)

    def jfn(x, scale, bias, r):
        y, new = jax_batch_norm(x, {**p, "scale": scale, "bias": bias}, train=True,
                                activation=activation, residual=r)
        return y, new
    args = [jnp.asarray(x), jnp.asarray(p["scale"]), jnp.asarray(p["bias"]),
            None if res is None else jnp.asarray(res)]
    (y, new), vjp = jax.vjp(jfn, *args)
    grads = vjp((jnp.asarray(dy), jax.tree.map(jnp.zeros_like, new)))

    bn = BatchNorm(c)
    bn.load_state_dict(convert_tree(p))
    bn.train()
    tx = nchw(x).requires_grad_(True)
    tr = nchw(res).requires_grad_(True) if residual else None
    ty = bn(tx, activation, residual=tr)
    ty.backward(nchw(dy))
    np.testing.assert_allclose(nhwc(ty), np.asarray(y), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(new["mean"]), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(new["var"]), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(nhwc(tx.grad), np.asarray(grads[0]), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(bn.weight.grad.numpy(), np.asarray(grads[1]), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(bn.bias.grad.numpy(), np.asarray(grads[2]), atol=1e-4, rtol=1e-4)
    if residual:
        np.testing.assert_allclose(nhwc(tr.grad), np.asarray(grads[3]), atol=1e-5, rtol=1e-5)


def test_batch_norm_mode_switch_drops_the_fold():
    bn = BatchNorm(8)
    bn.eval()
    bn.fold()
    assert bn.folded is not None
    bn.train()
    assert bn.folded is None
    x = torch.randn(2, 8, 3, 3)
    y = bn(x)   # batch statistics, never the fold
    torch.testing.assert_close(y.mean(dim=(0, 2, 3)), torch.zeros(8), atol=1e-5, rtol=0)


# ---- losses: value and gradient ----------------------------------------------
# f32 log-softmax in another float order: rtol 1e-5 on the value, atol 1e-6 on
# the gradient (entries of order 1 / number of pixels).

def _loss_case(kind):
    rng = np.random.RandomState({"rand": 0, "confident": 1, "ties": 2}[kind])
    n, c, h, w = 2, 19, 12, 20
    labels = rng.randint(0, c, (n, h, w))
    labels[:, :2] = 250
    labels[0, 5, :3] = 19          # out of range: ignored like 250
    logits = rng.randn(n, c, h, w).astype(np.float32)
    if kind != "rand":
        # confident: most losses fall under -log(0.7), so OHEM keeps the top n_min
        onehot = np.eye(c, dtype=np.float32)[np.clip(labels, 0, c - 1)].transpose(0, 3, 1, 2)
        logits = logits * 0.3 + 6.0 * onehot
    if kind == "ties":
        # whole rows of identical pixels: their losses tie at the n_min-th largest
        logits[:, :, 6:9] = logits[:, :, 6:7]
        labels[:, 6:9] = labels[:, 6:7]
        logits[:, :, 6, :] = logits[:, :, 6, :1]
        labels[:, 6, :] = labels[:, 6, :1]
    return logits, labels


def _check_loss(jfn, tfn, logits, labels):
    lg = jnp.asarray(logits.transpose(0, 2, 3, 1))
    want, vjp = jax.vjp(lambda l: jfn(l, jnp.asarray(labels.astype(np.int32))), lg)
    (g_want,) = vjp(jnp.ones((), jnp.float32))
    t = torch.from_numpy(logits).requires_grad_(True)
    got = tfn(t, torch.from_numpy(labels))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    np.testing.assert_allclose(nhwc(t.grad), np.asarray(g_want), atol=1e-6, rtol=1e-4)
    return float(want)


@pytest.mark.parametrize("kind", ["rand", "confident"])
def test_cross_entropy(kind):
    logits, labels = _loss_case(kind)
    _check_loss(lambda l, y: jloss.cross_entropy(l, y, 250),
                lambda l, y: tloss.cross_entropy(l, y, 250), logits, labels)


@pytest.mark.parametrize("kind,branch", [("rand", "thresh"), ("confident", "topk"),
                                         ("ties", "topk")])
def test_ohem_cross_entropy(kind, branch):
    logits, labels = _loss_case(kind)
    n_min = 2 * 12 * 20 // 16
    per = jloss._per_pixel_ce(jnp.asarray(logits.transpose(0, 2, 3, 1)),
                              jnp.asarray(labels.astype(np.int32)), 250)[0]
    above = int(jnp.sum(per > np.float32(-np.log(0.7))))
    assert (above > n_min) == (branch == "thresh")
    if kind == "ties":
        tau = float(jnp.sort(per.ravel())[::-1][n_min - 1])
        assert int(jnp.sum(per == tau)) > 1 and int(jnp.sum(per > tau)) < n_min
    _check_loss(lambda l, y: jloss.ohem_cross_entropy(l, y, n_min=n_min),
                lambda l, y: tloss.ohem_cross_entropy(l, y, n_min=n_min), logits, labels)


def test_per_image_ohem_of_the_recipe():
    logits, labels = _loss_case("confident")
    cfg = {"batch_size": 2, "n_devices": 2, "crop_size": [12, 20],
           "loss": {"name": "OhemCELoss2D", "thresh": 0.7, "ignore_index": 250}}
    _check_loss(jloss.make_loss_fn("OhemCELoss2D", cfg),
                tloss.make_loss_fn("OhemCELoss2D", cfg), logits, labels)


def test_kl_divergence():
    rng = np.random.RandomState(3)
    s = rng.randn(2, 19, 7, 9).astype(np.float32)
    t = rng.randn(2, 19, 7, 9).astype(np.float32) * 2
    tt = torch.from_numpy(t)
    _check_loss(lambda l, _: jloss.kl_divergence(l, jnp.asarray(t.transpose(0, 2, 3, 1))),
                lambda l, _: tloss.kl_divergence(l, tt), s, np.zeros((2, 7, 9), np.int64))


# ---- AdaOptimizer against optax, across the warm-up / poly boundary ----------
# f32 updates in another order of operations: atol 1e-6 / rtol 1e-5 per step.

def test_ada_optimizer_matches_optax():
    rng = np.random.RandomState(5)
    jparams = jheads.init_fcn_head(jax.random.PRNGKey(5), 32, 19, chn_down=4)
    jparams["bn"] = {**jparams["bn"], "scale": jnp.asarray(rng.rand(8) + 0.5, jnp.float32),
                     "bias": jnp.asarray(rng.randn(8), jnp.float32)}
    jparams["out"]["b"] = jnp.asarray(rng.randn(19), jnp.float32)
    kw = dict(lr0=0.05, momentum=0.9, wd=0.1, warmup_steps=2, warmup_start_lr=1e-3,
              max_iter=6, power=0.9)
    tx, jschedule = jax_ada_optimizer(jparams, **kw)
    jstate = tx.init(jparams)

    head = FCNHead(32, 19, chn_down=4)
    head.load_state_dict(convert_tree(jparams))
    opt, schedule = ada_optimizer(head, **kw)
    for it in range(4):
        grads = jax.tree.map(lambda a: jnp.asarray(rng.randn(*a.shape), jnp.float32), jparams)
        updates, jstate = tx.update(grads, jstate, jparams)
        jparams = jax.tree.map(lambda p, u: p + u, jparams, updates)
        tgrads = convert_tree(grads)
        for name, p in head.named_parameters():
            p.grad = tgrads[name].clone()
        assert schedule(it) == pytest.approx(float(jschedule(it)), rel=1e-6)
        for group in opt.param_groups:
            group["lr"] = schedule(it)
        opt.step()
        want = convert_tree(jparams)
        for name, p in head.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), atol=1e-6,
                                       rtol=1e-5, err_msg=f"{name} after update {it}")


# ---- the teacher -------------------------------------------------------------
# eval-mode ResNet-50 trunk in f32, other conv algorithms: atol 2e-4 / rtol 1e-4
# on logits of order 1-10.

@pytest.fixture(scope="module")
def teachers():
    out = {}
    for p in (4, 2):
        jcfg = JaxTeacherConfig(nclass=19, backbone="resnet50", path_num=p)
        params = jax_init_teacher(jax.random.PRNGKey(p), jcfg)
        rng = np.random.RandomState(p)
        x = rng.randn(1, 49, 65, 3).astype(np.float32)
        want = [np.asarray(t) for t in jax.jit(lambda pr, x: jax_apply_teacher(pr, x, jcfg))(
            params, jnp.asarray(x))]
        port = teacher_from_jax(params, TeacherConfig(nclass=19, backbone="resnet50",
                                                      path_num=p))
        out[p] = (x, want, port)
    return out


@pytest.mark.parametrize("p,group_id", [(4, 0), (4, 1), (4, 2), (4, 3), (2, 0), (2, 1)])
def test_teacher_matches_apply_teacher(teachers, p, group_id):
    """(T_full, T_group) for the student at pos_id ``group_id``: JAX's full
    tuple (T_full, T_1..T_P), crossing included, indexed by group_id."""
    x, want, port = teachers[p]
    full, grp = apply_teacher(port, torch.from_numpy(x), group_id=group_id)
    np.testing.assert_allclose(nhwc(full), want[0], atol=2e-4, rtol=1e-4)
    np.testing.assert_allclose(nhwc(grp), want[1 + group_id], atol=2e-4, rtol=1e-4)


# ---- the YAML config ---------------------------------------------------------

def test_config_from_yaml_matches_jax():
    """configs/td4_psp18_cityscapes.yml builds the same model, teacher,
    optimizer and loss on both sides (the loss value to rtol 1e-5)."""
    import copy
    import os
    from tdnet_tpu.utils import config as jconf
    from tdnet_tpu_torch.utils import config as tconf
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "configs", "td4_psp18_cityscapes.yml")
    cfg = tconf.load_config(path)
    assert cfg == jconf.load_config(path)
    jm, tm = jconf.model_config_from_yaml(cfg), tconf.model_config_from_yaml(cfg)
    for f in ("nclass", "backbone", "path_num", "in_size", "d_k", "kv_stride",
              "pool_before_proj", "aux"):
        assert getattr(tm, f) == getattr(jm, f), f
    jt, tt = jconf.teacher_config_from_yaml(cfg), tconf.teacher_config_from_yaml(cfg)
    assert (tt.nclass, tt.backbone, tt.path_num, tt.compat_swap) == (
        jt.nclass, jt.backbone, jt.path_num, jt.compat_swap)
    assert tconf.opt_kwargs_from_yaml(cfg) == jconf.opt_kwargs_from_yaml(cfg)
    small = copy.deepcopy(cfg)
    small["training"]["train_augmentations"]["rcrop"] = [12, 20]
    logits, labels = _loss_case("rand")
    for n_devices in (8, 1):   # per-image OHEM, then OHEM over the batch
        _check_loss(jconf.loss_fn_from_yaml(small, n_devices),
                    tconf.loss_fn_from_yaml(small, n_devices), logits, labels)
