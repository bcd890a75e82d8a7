"""Rank processes of the data-parallel tests (``test_torch_parallel.py``): gloo
on loopback, CPU tensors, one thread a rank.

``spawn(world, outdir, payload)`` starts ``world`` processes once; each makes
its data group from torchrun's environment variables
(``parallel.mesh.init_distributed``), runs every multi-rank check of the file
and saves what the tests read to ``outdir/rank<r>.pt``. The seeded inputs are
built here, by the functions the tests use for their one-process references.
"""

from __future__ import annotations

import hashlib
import logging
import os
import socket

import numpy as np
import torch

WORLD = 2
SEED = 11733

# train-mode BatchNorm cases: (global shape NCHW, activation, residual, dtype)
BN_CASES = {
    "plain": ((4, 6, 5, 7), None, False, torch.float32),
    "relu_residual": ((4, 6, 5, 7), "relu", True, torch.float32),
    "pool1x1": ((2, 6, 1, 1), "relu", False, torch.float32),   # the PSP's 1x1 pool, 1 a rank
    "bf16_residual": ((4, 6, 5, 7), "relu", True, torch.bfloat16),
}

STEP_HW = (33, 65)
STEP_OPT = dict(lr0=1e-2, momentum=0.9, wd=1e-4, warmup_steps=1, warmup_start_lr=1e-3,
                max_iter=4, power=0.9)
STEP_POS = (2, 0)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def share(n: int, rank: int, world: int = WORLD) -> slice:
    return slice(rank * n // world, (rank + 1) * n // world)


def bn_inputs(name: str) -> dict:
    """The seeded global inputs of a BatchNorm case (NCHW numpy, f32)."""
    shape, _, residual, _ = BN_CASES[name]
    rng = np.random.RandomState(sum(shape) + len(name))
    c = shape[1]
    return dict(x=(rng.randn(*shape) * 2 + 0.5).astype(np.float32),
                res=rng.randn(*shape).astype(np.float32) if residual else None,
                weight=(rng.rand(c) + 0.5).astype(np.float32),
                bias=rng.randn(c).astype(np.float32),
                mean=(rng.randn(c) * 0.1).astype(np.float32),
                var=(rng.rand(c) + 0.5).astype(np.float32),
                dy=rng.randn(*shape).astype(np.float32))


def run_bn(name: str, rows: slice, group=None) -> dict:
    """``batch_norm_train`` on ``rows`` of a case's batch, over ``group``: the
    output, the gradients of sum(y * dy) and the running buffers."""
    from tdnet_tpu_torch.ops.norm import batch_norm_train
    _, activation, _, dtype = BN_CASES[name]
    a = bn_inputs(name)
    t = lambda k: torch.from_numpy(a[k][rows]).to(dtype).requires_grad_(True)
    x, res = t("x"), (t("res") if a["res"] is not None else None)
    w, b = (torch.from_numpy(a[k]).requires_grad_(True) for k in ("weight", "bias"))
    rm, rv = torch.from_numpy(a["mean"].copy()), torch.from_numpy(a["var"].copy())
    y = batch_norm_train(x, w, b, rm, rv, activation=activation, residual=res, group=group)
    (y.float() * torch.from_numpy(a["dy"][rows])).sum().backward()
    out = dict(y=y.detach(), dx=x.grad, dw=w.grad, db=b.grad, mean=rm, var=rv)
    if res is not None:
        out["dres"] = res.grad
    return out


def step_config():
    from tdnet_tpu_torch.models import tdnet_config
    return tdnet_config("td4-psp18", in_size=STEP_HW, streaming=False, backbone="resnet10")


def step_data():
    """Frames [P, 2, H, W, 3] and labels [2, H, W] (float64, some at 250)."""
    rng = np.random.RandomState(20)
    frames = torch.from_numpy(rng.randn(4, WORLD, *STEP_HW, 3) * 0.5)
    labels = rng.randint(0, 19, (WORLD, *STEP_HW))
    labels[:, :7] = 250
    return frames, torch.from_numpy(labels)


def step_loss():
    from tdnet_tpu_torch.train.loss import make_loss_fn
    return make_loss_fn("OhemCELoss2D", {"batch_size": WORLD, "n_devices": WORLD,
                                         "crop_size": list(STEP_HW), "loss": {"thresh": 0.7}})


def run_steps(rows: slice, group=None, *, dtype=torch.float64, use_dropout=False) -> dict:
    """Two steps of the tiny TD4 (ResNet-10, no teacher) on ``rows`` of the batch
    over ``group``: losses, the step-1 and step-2 gradients, and the parameters
    and buffers after step 2."""
    from tdnet_tpu_torch.models import init_tdnet
    from tdnet_tpu_torch.train.trainer import make_train_state, make_train_step
    model = init_tdnet(step_config(), torch.Generator().manual_seed(0)).to(dtype)
    state = make_train_state(model, seed=SEED, opt_kwargs=STEP_OPT, group=group)
    step = make_train_step(loss_fn=step_loss(), use_dropout=use_dropout, group=group)
    frames, labels = step_data()
    out = {"loss": [], "grads": []}
    for pos in STEP_POS:
        m = step(state, frames[:, rows].to(dtype), labels[rows], pos)
        out["loss"].append(float(m["loss"]))
        out["grads"].append({k: p.grad.clone() for k, p in model.named_parameters()})
    out["state"] = {k: v.clone() for k, v in model.state_dict().items()}
    return out


def checksum(tensors: dict) -> str:
    h = hashlib.sha256()
    for k in sorted(tensors):
        h.update(k.encode())
        h.update(tensors[k].detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def _diffs(got: dict, ref: dict) -> dict:
    """Per tensor (max |got - ref|, max |ref|)."""
    return {k: (float((got[k].double() - ref[k].double()).abs().max()),
                float(ref[k].double().abs().max())) for k in ref}


def _dropout_mask(rank: int) -> torch.Tensor:
    from tdnet_tpu_torch.nn import Ctx, step_generator
    ctx = Ctx(train=True, generator=step_generator(SEED, 0, rank))
    return ctx.dropout(torch.ones(64, 64), 0.5) > 0


def ranks(rank: int, world: int, port: int, outdir: str, payload: dict) -> None:
    """One rank: every check of the file, its results to ``outdir``."""
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    torch.set_num_threads(1)
    from tdnet_tpu_torch.parallel.mesh import init_distributed
    from tdnet_tpu_torch.train.metrics import RunningScore
    group = init_distributed(device="cpu")
    out = {"rank": group.rank, "world": group.world, "backend": group.backend}

    out["bn"] = {name: run_bn(name, share(BN_CASES[name][0][0], rank, world), group)
                 for name in BN_CASES}

    steps = run_steps(share(WORLD, rank, world), group)
    out["step_loss"] = steps["loss"]
    out["step_sums"] = [checksum(g) for g in steps["grads"]] + [checksum(steps["state"])]
    if rank == 0:
        ref = run_steps(slice(0, WORLD))   # the one-process step at batch 2
        out["step_ref_loss"] = ref["loss"]
        out["step_grad_diffs"] = [_diffs(g, r) for g, r in zip(steps["grads"], ref["grads"])]
        out["step_state_diffs"] = _diffs(steps["state"], ref["state"])

    out["mask"] = _dropout_mask(rank)

    score = RunningScore(5)
    labels, preds = payload["score"]
    if rank == 0:   # rank 1 counted nothing: its zeros join the sum
        score.update(torch.from_numpy(labels), torch.from_numpy(preds))
    score.reduce(group)
    out["confusion"] = score.confusion_matrix()

    from tdnet_tpu_torch.cli import train as cli_train
    logdir = payload["logdir"] if rank == 0 else ""
    stats = {}
    state, best = cli_train.train(payload["cli_cfg"], logging.getLogger(f"rank{rank}"), logdir,
                                  device="cpu", stats=stats, group=group)
    out["cli"] = dict(losses=stats["losses"], confusion=stats.get("best_confusion"),
                      sum=checksum(state.model.state_dict()), it=state.it)
    group.close()
    torch.save(out, os.path.join(outdir, f"rank{rank}.pt"))


def spawn(outdir: str, payload: dict, world: int = WORLD) -> list[dict]:
    """Run ``ranks`` in ``world`` processes; their results, by rank."""
    import torch.multiprocessing as mp
    mp.start_processes(ranks, args=(world, free_port(), outdir, payload), nprocs=world,
                       start_method="spawn")
    return [torch.load(os.path.join(outdir, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]
