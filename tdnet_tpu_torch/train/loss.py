"""Segmentation losses with the reference's semantics (``tdnet_tpu/train/loss.py``).

Logits are NCHW [n, C, H, W], labels [n, H, W] integers.
- ``cross_entropy``: ``nn.CrossEntropyLoss(ignore_index)``, the mean over the
  pixels whose label is a class (not ``ignore_index``, not out of range).
- ``ohem_cross_entropy``: OhemCELoss2D (Training/ptsemseg/loss/loss.py:21-44):
  every loss above -log(thresh) if more than n_min of them are, else the top
  n_min; the mean over the kept. The top n_min are summed as the JAX package
  sums them: the losses above the n_min-th largest t plus t for each tie
  that fills to n_min, t taken without a gradient.
- ``kl_divergence``: the reference's KD (td4_psp.py:396-405): softmax both
  sides, add 1e-8, sum_c P log(P / Q), the mean over pixels.
"""

from __future__ import annotations

import math

import torch

from tdnet_tpu_torch.ops.dtype import at_least_f32


def _per_pixel_ce(logits: torch.Tensor, labels: torch.Tensor,
                  ignore_index: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(per-pixel loss [n, H, W] with 0 where ignored, valid mask)."""
    nclass = logits.shape[1]
    valid = (labels != ignore_index) & (labels >= 0) & (labels < nclass)
    safe = torch.where(valid, labels, torch.zeros_like(labels))
    logp = torch.log_softmax(at_least_f32(logits), dim=1)
    picked = torch.gather(logp, 1, safe[:, None].long())[:, 0]
    return torch.where(valid, -picked, torch.zeros((), dtype=picked.dtype)), valid


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  ignore_index: int = 250) -> torch.Tensor:
    loss, valid = _per_pixel_ce(logits, labels, ignore_index)
    return loss.sum() / valid.sum().clamp(min=1)


def ohem_cross_entropy(logits: torch.Tensor, labels: torch.Tensor, *, n_min: int,
                       thresh: float = 0.7, ignore_index: int = 250) -> torch.Tensor:
    loss, _ = _per_pixel_ce(logits, labels, ignore_index)
    loss = loss.flatten()
    log_thresh = -math.log(thresh)
    above = loss > log_thresh
    count_th = int(above.sum())
    if count_th > n_min:
        return loss[above].sum() / count_th
    tau = torch.topk(loss.detach(), n_min).values[-1]
    gt = loss > tau
    return (loss[gt].sum() + tau * (n_min - int(gt.sum()))) / n_min


def kl_divergence(q_logits: torch.Tensor, p_logits: torch.Tensor,
                  temperature: float = 1.0) -> torch.Tensor:
    """KL(P || Q) with P the teacher and Q the student; channel axis 1."""
    p = torch.softmax(at_least_f32(p_logits) / temperature, dim=1) + 1e-8
    q = torch.softmax(at_least_f32(q_logits) / temperature, dim=1) + 1e-8
    return ((p * torch.log(p / q)).sum(dim=1) * temperature ** 2).mean()


def make_loss_fn(name: str, cfg_training: dict):
    """The reference's loss registry (Training/ptsemseg/loss/__init__.py:19-34).
    OHEM's n_min is images-per-device x crop_h x crop_w / 16; with one image per
    device OHEM runs on each image and the per-image losses are averaged."""
    params = {k: v for k, v in cfg_training.get("loss", {}).items() if k != "name"}
    ignore_index = params.get("ignore_index", 250)
    if name == "SegmentationLosses":
        return lambda lg, lb: cross_entropy(lg, lb, ignore_index)
    if name == "OhemCELoss2D":
        thresh = params.get("thresh", 0.7)
        n_imgs = max(1, int(cfg_training["batch_size"])
                     // max(1, int(cfg_training.get("n_devices", 1))))
        crop = cfg_training["crop_size"]
        n_min = n_imgs * crop[0] * crop[1] // 16
        if n_imgs == 1:
            return lambda lg, lb: torch.stack([
                ohem_cross_entropy(lg[i:i + 1], lb[i:i + 1], n_min=n_min, thresh=thresh,
                                   ignore_index=ignore_index)
                for i in range(lg.shape[0])]).mean()
        return lambda lg, lb: ohem_cross_entropy(lg, lb, n_min=n_min, thresh=thresh,
                                                 ignore_index=ignore_index)
    raise NotImplementedError(f"Loss {name} not implemented")
