"""Validation CLI, reference-compatible (``tdnet_tpu/cli/validate.py``).

    python -m tdnet_tpu_torch.cli.validate --config configs/td4_psp18_cityscapes.yml

mirrors Training/validate.py: mean IoU, per-class IoU and frames/s over the
val split with the training-side model in eval mode (``train/trainer.py:
make_eval_step``: the hops through K1), round-robin ``pos_id = i % path_n``
(validate.py:66). The model is the YAML's: a TDNet, or a TD2-FANet for
``arch: td2_fa``. ``validating.resume`` names the weights
(``utils/torch_import.py:load_tdnet``, ``load_fatd``):
- the port's own checkpoint (``cli/train.py``'s best model or ``cli/convert.py``'s
  output: torch's zip format, ``torch.load(weights_only=True)``);
- the JAX package's (its ``save_best`` pickle of numpy arrays), carried over
  by ``utils/from_jax.tdnet_state_from_jax``;
- the reference's ``*_best_model.pkl`` (torch's legacy or zip format), read by
  ``utils/torch_import.tdnet_from_torch`` (``fatd_from_torch``) with the
  training twin's config.
With no file the weights are random (seed 0).
"""

from __future__ import annotations

import argparse
import os
import time

import torch


def load_weights(path: str, mcfg, device):
    """The TDNet or TD2-FANet in ``path`` (the port's, the JAX package's or the
    reference's checkpoint) on ``device``; parts the file lacks (aux heads)
    keep the seed-0 init."""
    from tdnet_tpu_torch.models import FATDConfig, init_model
    from tdnet_tpu_torch.utils.torch_import import load_fatd, load_tdnet
    load = load_fatd if isinstance(mcfg, FATDConfig) else load_tdnet
    return load(init_model(mcfg, torch.Generator().manual_seed(0)), path).to(device)


def validate(cfg: dict, args, stats: dict | None = None):
    """Scores of the weights ``cfg['validating']['resume']`` on the val split;
    returns (score, class_iou). ``stats``, when given, gets the confusion
    matrix (``confusion``) and each batch's synchronized seconds
    (``batch_s``)."""
    from tdnet_tpu_torch.data import get_loader
    from tdnet_tpu_torch.data.augment import get_composed_augmentations
    from tdnet_tpu_torch.data.cityscapes import ClipBatcher
    from tdnet_tpu_torch.kernels.fault import check_fault
    from tdnet_tpu_torch.models import init_model
    from tdnet_tpu_torch.train.metrics import RunningScore
    from tdnet_tpu_torch.train.trainer import make_eval_step
    from tdnet_tpu_torch.utils.config import model_config_from_yaml

    stats = {} if stats is None else stats
    device = torch.device(getattr(args, "device", "cuda"))
    path_n = cfg["model"]["path_num"]
    v_aug = get_composed_augmentations(cfg["validating"].get("val_augmentations"))
    loader_cls = get_loader(cfg["data"]["dataset"])
    v_ds = loader_cls(cfg["data"]["path"], split=cfg["data"]["val_split"], augmentations=v_aug,
                      path_num=path_n)
    scale = cfg["validating"].get("val_augmentations", {}).get("scale")
    in_size = tuple(scale) if scale else (769, 1537)
    mcfg = model_config_from_yaml(cfg, nclass=v_ds.n_classes, in_size=in_size, streaming=False)

    resume = cfg["validating"].get("resume")
    if resume and os.path.isfile(resume):
        print(f"Loading '{resume}'")
        model = load_weights(resume, mcfg, device)
    else:
        print(f"No checkpoint at '{resume}' — random weights")
        model = init_model(mcfg, torch.Generator().manual_seed(0)).to(device)

    batcher = ClipBatcher(v_ds, cfg["validating"]["batch_size"], shuffle=False,
                          drop_last=False, num_workers=cfg["validating"]["n_workers"])
    eval_step = make_eval_step()
    running = RunningScore(v_ds.n_classes)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    stats["batch_s"] = []

    for i, (frames, labels) in enumerate(batcher):
        frames = torch.from_numpy(frames).to(device)
        sync()
        t0 = time.perf_counter()
        pred = eval_step(model, frames, i % path_n)
        sync()
        dt = time.perf_counter() - t0
        check_fault(device)
        stats["batch_s"].append(dt)
        running.update(torch.from_numpy(labels), pred)
        if args.measure_time:
            print("Inference time (iter {0:5d}): {1:3.5f} fps".format(i + 1, labels.shape[0] / dt))
        if args.max_batches and i + 1 >= args.max_batches:
            break

    stats["confusion"] = running.confusion_matrix()
    score, class_iou = running.get_scores()
    for k, v in score.items():
        print(k, v)
    for i in range(v_ds.n_classes):
        print(i, class_iou[i])
    return score, class_iou


def main(argv=None):
    from tdnet_tpu_torch.utils.config import load_config
    parser = argparse.ArgumentParser(description="Hyperparams")
    parser.add_argument("--config", nargs="?", type=str, default="configs/fcn8s_pascal.yml")
    parser.add_argument("--measure_time", dest="measure_time", action="store_true")
    parser.add_argument("--no-measure_time", dest="measure_time", action="store_false")
    parser.add_argument("--max_batches", type=int, default=None)
    parser.add_argument("--device", type=str, default="cuda")
    parser.set_defaults(measure_time=True)
    args = parser.parse_args(argv)
    validate(load_config(args.config), args)


if __name__ == "__main__":
    main()
