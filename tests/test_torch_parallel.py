"""Data-parallel training on the CPU: two ranks over gloo on loopback
(``tests/torch_parallel_workers.py``, spawned once for the file), against the
port's one-process code on the whole batch and against the JAX package.

- The loss at ``n_devices=2`` (OHEM, one image a device) against JAX's: 1e-6.
- The synchronised train-mode BatchNorm (``ops/norm.py``), forward and
  backward, against the one-process op on the concatenated batch and against
  JAX's train BN (``tdnet_tpu/ops/norm.py``) there: atol and rtol 2e-5 (f32;
  the ranks combine their own two-pass moments, JAX forms E[x^2] - E[x]^2),
  the running buffers too, the PSP's 1x1 pool at one image a rank included;
  bf16 within one bf16 ulp of the output's scale.
- Two steps of a tiny TD4 (ResNet-10 paths, 33x65, no teacher), dropout off,
  in float64, over two ranks at one image each against the one-process step at
  batch 2 (itself held against JAX by ``test_torch_train.py``): the losses to
  rtol 1e-12, each gradient and each parameter and buffer after step 2 within
  1e-9 of its tensor's largest entry, plus 1e-12; the two ranks' gradients
  and parameters bitwise equal.
- A rank's dropout stream differs from another's; rank 0's is the one-process
  stream, and a world of 1 runs today's step bit for bit.
- The confusion matrix summed over the ranks; ``ClipBatcher``'s shares.
- ``cli.train.train`` over the two ranks (batch 2, dropout on, a 33x65 crop):
  rank 0 wrote the checkpoints, both ranks end with the same parameters and
  validation confusion matrix.
"""

import copy
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_parallel_workers as W
from torch_threads import few_threads  # noqa: F401  (the file runs on two threads)
from tdnet_tpu.ops.norm import batch_norm as jax_batch_norm
from tdnet_tpu_torch.data.cityscapes import ClipBatcher, share
from tdnet_tpu_torch.nn import step_generator
from tdnet_tpu_torch.parallel.mesh import DataGroup, init_distributed
from tdnet_tpu_torch.train import loss as tloss
from tdnet_tpu_torch.train.trainer import make_train_state, make_train_step
from tdnet_tpu_torch.utils.config import loss_fn_from_yaml

BN_TOL = 2e-5


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    from tests.test_torch_data import write_cityscapes_tree
    return write_cityscapes_tree(tmp_path_factory.mktemp("cityscapes"))


@pytest.fixture(scope="module")
def ranks(tree, tmp_path_factory):
    """The two ranks' results, and what they were given."""
    from tests.test_torch_train_cli import tiny_cfg
    rng = np.random.RandomState(3)
    cli_cfg = tiny_cfg(tree, batch_size=2, train_iters=2, val_interval=2, ckpt_interval=2)
    cli_cfg["training"]["train_augmentations"].update(scale=[33, 65], rcrop=[33, 65])
    cli_cfg["validating"]["val_augmentations"]["scale"] = [33, 65]
    payload = dict(score=(rng.randint(0, 6, 500), rng.randint(0, 5, 500)),
                   logdir=str(tmp_path_factory.mktemp("run")), cli_cfg=cli_cfg)
    return W.spawn(str(tmp_path_factory.mktemp("ranks")), payload), payload


# --- the loss ----------------------------------------------------------------------

def test_loss_at_two_devices_matches_jax():
    """``loss_fn_from_yaml(n_devices=2)`` on a batch of 2: OHEM on each image,
    the mean of the two, as JAX's vmapped OHEM."""
    cfg = {"training": {"batch_size": 2, "loss": {"name": "OhemCELoss2D", "thresh": 0.7},
                        "train_augmentations": {"rcrop": [24, 40]}}}
    rng = np.random.RandomState(5)
    logits = (rng.randn(2, 19, 24, 40) * 3).astype(np.float32)
    labels = rng.randint(0, 19, (2, 24, 40))
    labels[0, :5] = 250
    from tdnet_tpu.utils.config import loss_fn_from_yaml as jax_loss_fn_from_yaml
    got = loss_fn_from_yaml(cfg, n_devices=2)(torch.from_numpy(logits), torch.from_numpy(labels))
    want = jax_loss_fn_from_yaml(cfg, n_devices=2)(
        jnp.asarray(logits.transpose(0, 2, 3, 1)), jnp.asarray(labels))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6, atol=1e-6)
    per = [tloss.ohem_cross_entropy(torch.from_numpy(logits[i:i + 1]),
                                    torch.from_numpy(labels[i:i + 1]), n_min=24 * 40 // 16)
           for i in range(2)]
    assert float(got) == float((per[0] + per[1]) / 2)


# --- synchronised BatchNorm -----------------------------------------------------------

def _joined(ranks, name, key):
    return torch.cat([r["bn"][name][key] for r in ranks]).float()


@pytest.mark.parametrize("name", [n for n in W.BN_CASES if W.BN_CASES[n][3] == torch.float32])
def test_sync_batch_norm_is_the_whole_batchs(ranks, name):
    ranks, _ = ranks
    ref = W.run_bn(name, slice(None))
    for key in ("y", "dx") + (("dres",) if "dres" in ref else ()):
        np.testing.assert_allclose(_joined(ranks, name, key), ref[key], atol=BN_TOL, rtol=BN_TOL,
                                   err_msg=key)
    for key in ("dw", "db"):   # each rank holds its part of the sums
        np.testing.assert_allclose(sum(r["bn"][name][key] for r in ranks), ref[key],
                                   atol=BN_TOL, rtol=BN_TOL, err_msg=key)
    for key in ("mean", "var"):   # the same on every rank
        assert torch.equal(ranks[0]["bn"][name][key], ranks[1]["bn"][name][key])
        np.testing.assert_allclose(ranks[0]["bn"][name][key], ref[key], atol=BN_TOL,
                                   rtol=BN_TOL, err_msg=key)


@pytest.mark.parametrize("name", [n for n in W.BN_CASES if W.BN_CASES[n][3] == torch.float32])
def test_sync_batch_norm_matches_jax(ranks, name):
    """JAX's train BN on the whole batch (NHWC), its VJP and new statistics."""
    ranks, _ = ranks
    _, activation, residual, _ = W.BN_CASES[name]
    a = W.bn_inputs(name)
    nhwc = lambda t: jnp.asarray(t.transpose(0, 2, 3, 1))
    p = dict(scale=a["weight"], bias=a["bias"], mean=a["mean"], var=a["var"])

    def jfn(x, scale, bias, r):
        return jax_batch_norm(x, {**p, "scale": scale, "bias": bias}, train=True,
                              activation=activation, residual=r)
    args = [nhwc(a["x"]), jnp.asarray(a["weight"]), jnp.asarray(a["bias"]),
            nhwc(a["res"]) if residual else None]
    (y, new), vjp = jax.vjp(jfn, *args)
    grads = vjp((nhwc(a["dy"]), jax.tree.map(jnp.zeros_like, new)))
    back = lambda t: np.asarray(t).transpose(0, 3, 1, 2)
    np.testing.assert_allclose(_joined(ranks, name, "y"), back(y), atol=BN_TOL, rtol=BN_TOL)
    np.testing.assert_allclose(_joined(ranks, name, "dx"), back(grads[0]), atol=BN_TOL,
                               rtol=BN_TOL)
    np.testing.assert_allclose(sum(r["bn"][name]["dw"] for r in ranks), grads[1], atol=BN_TOL,
                               rtol=BN_TOL)
    np.testing.assert_allclose(sum(r["bn"][name]["db"] for r in ranks), grads[2], atol=BN_TOL,
                               rtol=BN_TOL)
    np.testing.assert_allclose(ranks[0]["bn"][name]["mean"], new["mean"], atol=BN_TOL,
                               rtol=BN_TOL)
    np.testing.assert_allclose(ranks[0]["bn"][name]["var"], new["var"], atol=BN_TOL, rtol=BN_TOL)


def test_sync_batch_norm_bf16_rounds_once(ranks):
    """bf16 with a residual: moments and affine in f32, the residual inside,
    one rounding; within one bf16 ulp of the output's scale of the one-process
    op (whose moments come in another order)."""
    ranks, _ = ranks
    ref = W.run_bn("bf16_residual", slice(None))
    got = _joined(ranks, "bf16_residual", "y")
    assert ranks[0]["bn"]["bf16_residual"]["y"].dtype == torch.bfloat16
    scale = float(ref["y"].float().abs().max())
    assert float((got - ref["y"].float()).abs().max()) <= scale * 2.0 ** -8


# --- the data-parallel step --------------------------------------------------------

def test_ranks_made_a_gloo_group_from_the_environment(ranks):
    ranks, _ = ranks
    assert [(r["rank"], r["world"], r["backend"]) for r in ranks] == [(0, 2, "gloo"),
                                                                      (1, 2, "gloo")]


def test_two_rank_step_is_the_batch_2_step(ranks):
    ranks, _ = ranks
    r0 = ranks[0]
    np.testing.assert_allclose(r0["step_loss"], r0["step_ref_loss"], rtol=1e-12)
    for diffs in r0["step_grad_diffs"] + [r0["step_state_diffs"]]:
        for name, (diff, scale) in diffs.items():
            assert diff <= 1e-9 * scale + 1e-12, (name, diff, scale)


def test_two_rank_step_keeps_the_ranks_bitwise_equal(ranks):
    """The gradients of both steps, and the parameters and buffers (the running
    statistics) after them."""
    ranks, _ = ranks
    assert ranks[0]["step_sums"] == ranks[1]["step_sums"]
    assert ranks[0]["step_loss"] == ranks[1]["step_loss"]


def test_each_rank_draws_its_own_dropout(ranks):
    ranks, _ = ranks
    from torch_parallel_workers import _dropout_mask
    assert not torch.equal(ranks[0]["mask"], ranks[1]["mask"])
    assert torch.equal(ranks[0]["mask"], _dropout_mask(0))
    seed, it = W.SEED, 7
    old = torch.Generator().manual_seed(((seed & 0xFFFFFFFF) << 32) | it)
    assert torch.equal(torch.rand(16, generator=step_generator(seed, it)),
                       torch.rand(16, generator=old))


def test_world_of_one_is_todays_step():
    """``group=DataGroup()`` (a world of 1) and no group: the same losses,
    gradients and parameters, bit for bit (dropout off: the streams are held
    by ``test_each_rank_draws_its_own_dropout``)."""
    from tdnet_tpu_torch.models import init_tdnet, tdnet_config
    cfg = tdnet_config("td4-psp18", in_size=(33, 65), streaming=False, backbone="resnet10")
    frames, labels = W.step_data()
    frames, labels = frames[:, :1, :33, :65].float(), labels[:1, :33, :65]
    runs = []
    for group in (None, DataGroup()):
        model = init_tdnet(cfg, torch.Generator().manual_seed(0))
        state = make_train_state(model, seed=W.SEED, opt_kwargs=W.STEP_OPT, group=group)
        step = make_train_step(loss_fn=W.step_loss(), use_dropout=False, group=group)
        loss = step(state, frames, labels, 2)["loss"]
        runs.append((loss, W.checksum({k: p.grad for k, p in model.named_parameters()}),
                     W.checksum(model.state_dict())))
    assert torch.equal(runs[0][0], runs[1][0]) and runs[0][1:] == runs[1][1:]


def test_init_distributed_without_torchrun_is_a_world_of_one(monkeypatch):
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(key, raising=False)
    g = init_distributed(device="cpu")
    assert (g.rank, g.world, g.group, g.device) == (0, 1, None, torch.device("cpu"))
    t = torch.arange(3.0)
    assert g.all_reduce_(t) is t and torch.equal(t, torch.arange(3.0))
    g.close()


# --- validation: the confusion matrix, the batcher ---------------------------------------

def test_confusion_matrix_sums_over_ranks(ranks):
    ranks, payload = ranks
    from tdnet_tpu_torch.train.metrics import RunningScore
    labels, preds = payload["score"]
    one = RunningScore(5)
    one.update(torch.from_numpy(labels), torch.from_numpy(preds))
    for r in ranks:
        assert r["confusion"].dtype == np.int64
        np.testing.assert_array_equal(r["confusion"], one.confusion_matrix())


class _Items:
    """A dataset whose clip i is (frames of value i, labels of value i)."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return [np.full((2, 3, 3), i, np.float32)] * 2, np.full((2, 3), i % 7, np.int64)


@pytest.mark.parametrize("n,batch,world,drop_last", [(11, 4, 2, True), (11, 4, 2, False),
                                                     (9, 6, 4, False), (5, 3, 4, False)])
def test_batcher_shares_are_the_one_process_batches(n, batch, world, drop_last):
    """Each global batch is the ranks' batches joined in rank order, clip for
    clip, with no clip twice; a rank whose share of a short batch is empty
    gets a stand-in that every label marks ignored."""
    kw = dict(batch_size=batch, shuffle=True, drop_last=drop_last, num_workers=1, seed=4)
    one = list(ClipBatcher(_Items(n), **kw))
    parts = [list(ClipBatcher(_Items(n), rank=r, world=world, **kw)) for r in range(world)]
    assert all(len(p) == len(one) for p in parts)
    for b, (frames, labels) in enumerate(one):
        ids, labs = [], []
        for r in range(world):
            f, lab = parts[r][b]
            assert f.shape[1] >= 1
            if f.shape[1] == share(frames.shape[1], r, world).stop - share(
                    frames.shape[1], r, world).start:
                ids += list(f[0, :, 0, 0, 0])
                labs.append(lab)
            else:   # the stand-in
                assert (lab == 250).all() and f.shape[1] == 1
        np.testing.assert_array_equal(ids, frames[0, :, 0, 0, 0])
        np.testing.assert_array_equal(np.concatenate(labs), labels)


def test_share_splits_evenly():
    assert [share(8, r, 4) for r in range(4)] == [slice(0, 2), slice(2, 4), slice(4, 6),
                                                  slice(6, 8)]
    assert [share(3, r, 2) for r in range(2)] == [slice(0, 2), slice(2, 3)]
    assert [share(1, r, 2) for r in range(2)] == [slice(0, 1), slice(1, 1)]


# --- the training CLI over two ranks ------------------------------------------------------

def test_train_cli_over_two_ranks(ranks):
    ranks, payload = ranks
    files = os.listdir(payload["logdir"])
    assert "state_latest.pkl" in files and any(f.endswith("_best_model.pkl") for f in files)
    assert ranks[0]["cli"]["sum"] == ranks[1]["cli"]["sum"]
    assert ranks[0]["cli"]["it"] == ranks[1]["cli"]["it"] == 2
    assert ranks[0]["cli"]["losses"] == ranks[1]["cli"]["losses"]
    assert np.isfinite(ranks[0]["cli"]["losses"]).all()
    np.testing.assert_array_equal(ranks[0]["cli"]["confusion"], ranks[1]["cli"]["confusion"])
    assert ranks[0]["cli"]["confusion"].sum() > 0


def test_train_cli_refuses_a_batch_that_does_not_split(tree):
    from tdnet_tpu_torch.cli import train as cli_train
    from tests.test_torch_train_cli import tiny_cfg
    cfg = copy.deepcopy(tiny_cfg(tree, batch_size=3))
    with pytest.raises(ValueError, match=r"gcd\(batch_size, devices\)"):
        cli_train._train(cfg, None, "", max_steps=1, resume_state=None, stats=None,
                         group=DataGroup(world=2))
