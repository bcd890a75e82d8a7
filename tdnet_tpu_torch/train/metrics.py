"""Streaming segmentation metrics (``tdnet_tpu/train/metrics.py``; reference
Training/ptsemseg/metrics.py:7-70).

The same scores and keys as the reference: overall accuracy, mean class
accuracy, frequency-weighted accuracy, mean IoU and the per-class IoU. The
confusion matrix is counted on the labels' device, in int64, by one
``torch.bincount`` a batch, so only the n x n matrix crosses to the host. The
JAX package counts in float32, which stops counting exactly past 2^24 in a
cell; below that the two agree. ``reduce(group)`` sums the ranks' matrices
(int64) after a validation pass over sharded batches.
"""

from __future__ import annotations

import numpy as np
import torch


class RunningScore:
    def __init__(self, n_classes: int):
        self.n_classes = n_classes
        self.reset()

    def reset(self):
        self.confusion = None

    def update(self, labels: torch.Tensor, preds: torch.Tensor):
        """``labels`` and ``preds``: integer tensors of one shape; labels
        outside [0, n_classes) (the ignore index) are not counted."""
        n = self.n_classes
        labels = torch.as_tensor(labels).to(preds.device).reshape(-1).long()
        preds = preds.reshape(-1).long()
        valid = (labels >= 0) & (labels < n)
        hist = torch.bincount(labels[valid] * n + preds[valid], minlength=n * n)
        hist = hist[:n * n].reshape(n, n)
        self.confusion = hist if self.confusion is None else self.confusion + hist

    def reduce(self, group, device=None) -> None:
        """Every rank's counts summed into each rank's (``group``, a ``DataGroup``;
        every rank calls it, a rank that counted nothing with its zeros on
        ``device``)."""
        if group is None or group.world <= 1:
            return
        if self.confusion is None:
            n = self.n_classes
            self.confusion = torch.zeros((n, n), dtype=torch.int64,
                                         device=device or group.device)
        group.all_reduce_(self.confusion)

    def confusion_matrix(self) -> np.ndarray:
        """The counts so far, int64 [n, n] on the host (rows: labels)."""
        if self.confusion is None:
            return np.zeros((self.n_classes, self.n_classes), np.int64)
        return self.confusion.cpu().numpy()

    def get_scores(self):
        hist = self.confusion_matrix()
        with np.errstate(divide="ignore", invalid="ignore"):
            acc = np.diag(hist).sum() / hist.sum()
            acc_cls = np.nanmean(np.diag(hist) / hist.sum(axis=1))
            iu = np.diag(hist) / (hist.sum(axis=1) + hist.sum(axis=0) - np.diag(hist))
            mean_iu = np.nanmean(iu)
            freq = hist.sum(axis=1) / hist.sum()
            fwavacc = (freq[freq > 0] * iu[freq > 0]).sum()
        cls_iu = dict(zip(range(self.n_classes), iu))
        return (
            {
                "Overall Acc: \t": acc,
                "Mean Acc : \t": acc_cls,
                "FreqW Acc : \t": fwavacc,
                "Mean IoU : \t": mean_iu,
            },
            cls_iu,
        )


class AverageMeter:
    """Reference averageMeter (metrics.py:54-70)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n=1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / self.count
