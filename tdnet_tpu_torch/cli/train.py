"""Training CLI, reference-compatible (``tdnet_tpu/cli/train.py``).

    python -m tdnet_tpu_torch.cli.train --config configs/td4_psp18_cityscapes.yml

mirrors Training/train.py: a seeded loop driven by iterations over shuffled,
augmented clip batches; the loss recipe of the YAML (``train/trainer.py:
make_train_step``: cuDNN's convs, the training attention K2 and dropout K3;
bf16 mixed precision where ``training.mixed_precision`` is set); validation
every ``val_interval`` iterations with the best checkpoint saved on mean IoU;
the whole train state saved every ``ckpt_interval`` iterations and at the end
(``--resume_state`` continues from it); a run directory ``runs/<config>/<id>``
with a copy of the config and a file logger. Runs on one card (``--device
cuda``, the default) or on the CPU (``--device cpu``).

The weights start as the reference's do (``tdnet_tpu/cli/train.py:86-121``):
- ``training.resume``, a single-path PSPNet checkpoint of the reference,
  bootstraps every sub-network (``utils/surgery.py:
  student_bootstrap_from_psp_checkpoint``); the port's own file of the
  bootstrapped TDNet (``cli.convert --bootstrap``) loads as it is;
- for a TD2-FANet (``arch: td2_fa``), ``training.resume`` is a single-path
  FANet checkpoint copied into both paths (``utils/torch_import.py:
  fanet_bootstrap_from_checkpoint``), or the port's own FATD file;
- without it, each path's backbone is the ImageNet one of the backbone store
  (``utils/model_store.py``: ``~/.encoding/models``,
  ``$TORCH_HOME/hub/checkpoints``, a download on a miss), where it has one: a
  deep-stem ResNet (50, 101, 152) is the encoding zoo's ``resnet50s`` ..., as
  the reference's students load it, never torchvision's 7x7-stem file of the
  plain name; a TD2-FANet asks the store for nothing and keeps its seeded
  init, as ``tdnet_tpu/cli/train.py:98`` skips it;
- ``teacher.teacher_model``, a PSPNet checkpoint, becomes the grouped teacher
  (``teacher_from_psp_checkpoint``); the port's own teacher file (``cli.convert
  --arch pspnet_4p``) loads as it is; without either the teacher is random.

Data-parallel over N cards (or N ranks on the CPU, ``--device cpu``):

    torchrun --nproc_per_node=N -m tdnet_tpu_torch.cli.train --config ...

Each rank takes its share of every global batch (``training.batch_size``
must divide by N: the JAX package's data axis is ``gcd(batch_size,
devices)`` and leaves devices idle, which the port does not); the BatchNorm
moments, the gradients and the validation's confusion matrix are reduced over
the ranks (``parallel/mesh.py``). Rank 0 logs and writes every checkpoint,
the others wait for it; every rank resumes from the same file. Without
torchrun the run is a world of 1, the one-process code. Not ported:
``--path_parallel`` (path-parallel training, ROADMAP Queue 1 item 9).
"""

from __future__ import annotations

import argparse
import contextlib
import logging
import math
import os
import random
import time

import numpy as np
import torch

SEED = 11733  # reference train.py:35
PATH_PARALLEL = ("--path_parallel: path-parallel multi-GPU not ported yet (the sub-network axis "
                 "sharded over devices; data-parallel training runs under torchrun): "
                 "ROADMAP Queue 1 item 9")


def _torch_state(path: str, what: str):
    """(the model state in ``path``, 'port' or 'reference'); the JAX package's
    pickle is refused, naming the file."""
    from tdnet_tpu_torch.utils.torch_import import checkpoint_kind
    state, kind = checkpoint_kind(path)
    if kind == "jax":
        raise ValueError(f"{path}: {what} is read from a torch checkpoint only")
    return state, kind


def load_student(model, path: str):
    """``training.resume`` into ``model`` (a fresh TDNet or FATD): the reference's
    single-path PSPNet through the bootstrap surgery (a single-path FANet copied
    into every path), or the port's file of the model."""
    from tdnet_tpu_torch.models import FATD
    from tdnet_tpu_torch.utils.surgery import student_bootstrap_from_psp_checkpoint
    from tdnet_tpu_torch.utils.torch_import import (fanet_bootstrap_from_checkpoint,
                                                    load_state_into)
    state, kind = _torch_state(path, "training.resume")
    if kind == "reference":
        bootstrap = (fanet_bootstrap_from_checkpoint if isinstance(model, FATD)
                     else student_bootstrap_from_psp_checkpoint)
        state = bootstrap(state, model.cfg, model.state_dict())
    return load_state_into(model, state, path)


def imagenet_backbones(model, name: str) -> bool:
    """Every path's backbone from the store's ImageNet ``name`` where it holds
    one (the zoo's ``{name}s`` for a deep stem); whether it did."""
    from tdnet_tpu_torch.nn import BACKBONES
    from tdnet_tpu_torch.utils.model_store import load_imagenet_backbone
    bcfg = BACKBONES[name]()
    backbone = load_imagenet_backbone(name + "s" if bcfg.deep_base else name, bcfg)
    if backbone is None:
        return False
    for sub in model.paths:
        sub.backbone.load_state_dict(backbone)
    return True


def load_teacher(tcfg, path: str):
    """``teacher.teacher_model`` as a ``Teacher``: the reference's PSPNet through
    the teacher surgery, or the port's teacher file."""
    from tdnet_tpu_torch.models import Teacher
    from tdnet_tpu_torch.utils.surgery import teacher_from_psp_checkpoint
    state, kind = _torch_state(path, "teacher.teacher_model")
    if kind == "reference":
        state = teacher_from_psp_checkpoint(state, tcfg)
    teacher = Teacher(tcfg)
    teacher.load_state_dict(state)
    return teacher


def check_batch(batch_size: int, world: int) -> None:
    """A global batch that splits evenly over the ranks, or a ValueError."""
    if batch_size % world:
        raise ValueError(
            f"training.batch_size {batch_size} does not split over {world} ranks: the port "
            f"gives every rank an equal share (the JAX package trains on a data axis of "
            f"gcd(batch_size, devices) = {math.gcd(batch_size, world)} devices and leaves "
            f"the rest idle)")


def train(cfg: dict, logger, logdir: str, *, max_steps: int | None = None,
          path_parallel: int | None = None, resume_state: str | None = None,
          device: str = "cuda", stats: dict | None = None, group=None):
    """Train by ``cfg`` (a loaded YAML); returns (state, best_iou).

    ``stats``, when given, collects per step the seconds spent waiting on the
    data (``data_s``) and in the step (``step_s``, synchronized) and the
    losses; the number of validation passes (``val_passes``), and the index and
    confusion matrix of the pass that saved the best checkpoint (``best_pass``,
    ``best_confusion``).

    ``group``: the data group (``parallel.mesh.init_distributed``); None makes
    it from torchrun's environment (a world of 1 without torchrun) and ends it
    on return. Only rank 0 writes to ``logdir``."""
    from tdnet_tpu_torch.parallel.mesh import init_distributed

    if path_parallel:
        raise NotImplementedError(PATH_PARALLEL)
    owns = group is None
    if owns:
        group = init_distributed(device=device)
    try:
        return _train(cfg, logger, logdir, max_steps=max_steps, resume_state=resume_state,
                      stats=stats, group=group)
    finally:
        if owns:
            group.close()


def _train(cfg, logger, logdir, *, max_steps, resume_state, stats, group):
    from tdnet_tpu_torch.data import get_loader
    from tdnet_tpu_torch.data.augment import get_composed_augmentations
    from tdnet_tpu_torch.data.cityscapes import ClipBatcher
    from tdnet_tpu_torch.kernels.fault import check_fault
    from tdnet_tpu_torch.models import FATDConfig, freeze, init_model, init_teacher
    from tdnet_tpu_torch.train.metrics import AverageMeter, RunningScore
    from tdnet_tpu_torch.train.trainer import make_eval_step, make_train_state, make_train_step
    from tdnet_tpu_torch.utils import checkpoint as ckpt
    from tdnet_tpu_torch.utils.config import (compute_dtype_from_yaml, loss_fn_from_yaml,
                                              model_config_from_yaml, opt_kwargs_from_yaml,
                                              teacher_config_from_yaml)

    stats = {} if stats is None else stats
    for key in ("data_s", "step_s", "losses"):
        stats.setdefault(key, [])
    stats.setdefault("val_passes", 0)
    device, rank, world = group.device, group.rank, group.world
    lead = rank == 0
    check_batch(int(cfg["training"]["batch_size"]), world)
    seed = SEED
    np.random.seed(seed)
    random.seed(seed)

    path_n = cfg["model"]["path_num"]
    t_aug = get_composed_augmentations(cfg["training"].get("train_augmentations"), seed=seed)
    v_aug = get_composed_augmentations(cfg["validating"].get("val_augmentations"), seed=seed)
    loader_cls = get_loader(cfg["data"]["dataset"])
    data_path = cfg["data"]["path"]
    t_ds = loader_cls(data_path, split=cfg["data"]["train_split"], augmentations=t_aug,
                      path_num=path_n, seed=seed)
    v_ds = loader_cls(data_path, split=cfg["data"]["val_split"], augmentations=v_aug,
                      path_num=path_n, seed=seed)
    batcher = ClipBatcher(t_ds, cfg["training"]["batch_size"], shuffle=True, drop_last=True,
                          num_workers=cfg["training"]["n_workers"], seed=seed, infinite=True,
                          rank=rank, world=world)
    v_batcher = ClipBatcher(v_ds, cfg["validating"]["batch_size"], shuffle=False,
                            drop_last=False, num_workers=cfg["validating"]["n_workers"],
                            rank=rank, world=world)
    logger.info(f"device: {device}")
    if world > 1:
        logger.info(f"data-parallel: {world} ranks over {group.backend}")

    mcfg = model_config_from_yaml(cfg, nclass=t_ds.n_classes, streaming=False)
    tcfg = teacher_config_from_yaml(cfg, nclass=t_ds.n_classes)
    loss_fn = loss_fn_from_yaml(cfg, n_devices=world)
    opt_kwargs = opt_kwargs_from_yaml(cfg)
    max_iter = int(cfg["training"]["train_iters"])

    model = init_model(mcfg, torch.Generator().manual_seed(seed))
    resume = cfg["training"].get("resume")
    if resume and os.path.isfile(resume):
        logger.info(f"Initializing sub networks with pretrained '{resume}'")
        load_student(model, resume)
    else:
        logger.info(f"No pretrained found at '{resume}'")
        # reference students build their backbones with pretrained=True
        # (ImageNet); use a cached checkpoint when available
        if isinstance(mcfg, FATDConfig):
            logger.info("td2_fa: no ImageNet backbone is loaded; backbones at random init")
        elif imagenet_backbones(model, cfg["model"]["backbone"]):
            logger.info("initialized backbones from cached ImageNet checkpoint")
        else:
            logger.info(f"no ImageNet {cfg['model']['backbone']} in the backbone store: "
                        f"backbones at random init")
    model = model.to(device)

    teacher = None
    if tcfg is not None:
        tpath = cfg["teacher"].get("teacher_model")
        if tpath and os.path.isfile(tpath):
            logger.info(f"Initializing Teacher with pretrained '{tpath}'")
            teacher = freeze(load_teacher(tcfg, tpath)).to(device)
        else:
            logger.info(f"No teacher pretrained found at '{tpath}' — using random frozen teacher")
            teacher = init_teacher(tcfg, torch.Generator().manual_seed(seed + 1)).to(device)

    state = make_train_state(model, seed=seed, opt_kwargs=opt_kwargs, group=group)
    if cfg["training"].get("ckpt_backend") == "orbax":
        logger.info("ckpt_backend orbax: the port writes its one torch checkpoint format "
                    "(synchronously)")
    latest = os.path.join(logdir, "state_latest.pkl")

    start_iter = 0
    if resume_state and os.path.isfile(resume_state):
        ckpt.load_train_state(resume_state, state)
        start_iter = state.it
        logger.info(f"resumed training state from '{resume_state}' at iter {start_iter}")
    compute_dtype = compute_dtype_from_yaml(cfg)
    if compute_dtype is not None:
        logger.info("mixed-precision training: bf16 compute, f32 masters")
    step = make_train_step(loss_fn=loss_fn, compute_dtype=compute_dtype, group=group)
    eval_step = make_eval_step()

    running = RunningScore(t_ds.n_classes)
    time_meter = AverageMeter()
    best_iou = 0.0
    cnt_iter = start_iter
    stop_at = min(max_iter, (start_iter + max_steps) if max_steps else max_iter)
    ckpt_interval = int(cfg["training"].get("ckpt_interval", 0) or 0)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)

    def save(write, *args, **kw):
        """``write`` on rank 0, the other ranks waiting for the file."""
        out = write(*args, **kw) if lead else None
        group.barrier()
        return out

    batches = iter(batcher)
    try:
        while True:
            t_data = time.perf_counter()
            frames, labels = next(batches)
            frames = torch.from_numpy(frames).to(device)
            labels = torch.from_numpy(labels).to(device, torch.long)
            cnt_iter += 1
            sync()
            t0 = time.perf_counter()
            metrics = step(state, frames, labels, cnt_iter % path_n, teacher)
            loss_val = metrics["loss"].item()
            check_fault(device)
            dt = time.perf_counter() - t0
            stats["data_s"].append(t0 - t_data)
            stats["step_s"].append(dt)
            stats["losses"].append(loss_val)
            time_meter.update(dt)

            if (cnt_iter + 1) % cfg["training"]["print_interval"] == 0:
                if not np.isfinite(loss_val):
                    # halt on divergence with the state dumped, inspectable and resumable
                    # (the loss is the ranks' mean, so every rank stops here)
                    dump = os.path.join(logdir, "state_nan_abort.pkl")
                    save(ckpt.save_train_state, dump, state)
                    logger.error(f"non-finite loss at iter {cnt_iter} (loss={loss_val}); "
                                 f"state dumped to {dump}")
                    raise FloatingPointError(f"non-finite training loss at iter {cnt_iter} "
                                             f"(state dumped to {dump})")
                msg = "Iter [{:d}/{:d}]  Loss: {:.4f}  Time/Image: {:.4f}".format(
                    cnt_iter + 1, max_iter, loss_val,
                    time_meter.avg / cfg["training"]["batch_size"])
                if lead:
                    print(msg)
                logger.info(msg)
                time_meter.reset()

            if ((cnt_iter + 1) % cfg["training"]["val_interval"] == 0
                    or (cnt_iter + 1) == max_iter or cnt_iter >= stop_at):
                for i_val, (vf, vl) in enumerate(v_batcher):
                    vf = torch.from_numpy(vf).to(device)
                    pred = eval_step(state.model, vf, i_val % path_n)
                    running.update(torch.from_numpy(vl), pred)
                check_fault(device)
                running.reduce(group)
                score, class_iou = running.get_scores()
                for k, v in score.items():
                    if lead:
                        print(k, v)
                    logger.info(f"{k}: {v}")
                for k, v in class_iou.items():
                    logger.info(f"{k}: {v}")
                if score["Mean IoU : \t"] >= best_iou:
                    best_iou = score["Mean IoU : \t"]
                    path = save(ckpt.save_best, logdir, cfg["model"]["arch"],
                                cfg["data"]["dataset"], step=cnt_iter, model=state.model,
                                best_iou=best_iou)
                    stats["best_confusion"] = running.confusion_matrix()
                    stats["best_pass"] = stats["val_passes"]
                    logger.info(f"saved best checkpoint to {path}")
                running.reset()
                stats["val_passes"] += 1

            if ckpt_interval and cnt_iter % ckpt_interval == 0:
                save(ckpt.save_train_state, latest, state)
                logger.info(f"periodic train-state checkpoint at iter {cnt_iter}")

            if cnt_iter >= stop_at:
                save(ckpt.save_train_state, latest, state)
                break
    finally:
        batches.close()   # joins the reading threads
    return state, best_iou


def main(argv=None):
    from tdnet_tpu_torch.parallel.mesh import init_distributed
    from tdnet_tpu_torch.utils.checkpoint import get_logger, make_run_dir
    from tdnet_tpu_torch.utils.config import load_config

    parser = argparse.ArgumentParser(description="config")
    parser.add_argument("--config", nargs="?", type=str, help="Configuration file to use")
    parser.add_argument("--max_steps", type=int, default=None,
                        help="stop early after N steps (smoke runs)")
    parser.add_argument("--path_parallel", type=int, default=None,
                        help="shard the subnet axis over this many devices (not ported: "
                             "ROADMAP Queue 1 item 9)")
    parser.add_argument("--resume_state", type=str, default=None,
                        help="resume the whole train state (model, optimizer, iteration) "
                             "from a state_latest.pkl")
    parser.add_argument("--debug_nans", action="store_true",
                        help="torch.autograd.detect_anomaly: fail at the op that made a NaN")
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)
    if args.path_parallel:
        raise NotImplementedError(PATH_PARALLEL)

    cfg = load_config(args.config)
    group = init_distributed(device=args.device)
    try:
        check_batch(int(cfg["training"]["batch_size"]), group.world)
        if group.rank == 0:
            logdir = make_run_dir(args.config)
            print(f"RUNDIR: {logdir}")
            logger = get_logger(logdir)
            logger.info("Let the games begin")
        else:
            logdir, logger = "", logging.getLogger(f"tdnet_tpu_torch.rank{group.rank}")
            logger.addHandler(logging.NullHandler())
            logger.propagate = False
        anomaly = (torch.autograd.detect_anomaly() if args.debug_nans
                   else contextlib.nullcontext())
        with anomaly:
            train(cfg, logger, logdir, max_steps=args.max_steps,
                  resume_state=args.resume_state, device=args.device, group=group)
    finally:
        group.close()


if __name__ == "__main__":
    main()
