"""Generic video-clip dataset machinery shared by CamVid / NYUDv2
(``tdnet_tpu/data/generic_clips.py``), reading through ``data/png.py``.

The reference README points at CamVid and NYUDv2 results
(Training/TRAIN_README.md:6-8) but ships only a Cityscapes loader
(loader/__init__.py:11-13) — these fill that capability gap. The layout
is configurable; predecessor frames are sampled backwards by id from a
sequence directory when available, else the annotated frame is repeated
(static-clip fallback), so the loaders work on both the video and the
stills-only distributions of these datasets.
"""

from __future__ import annotations

import os
import random as _random
import re

import numpy as np

from tdnet_tpu_torch.data.png import read_png

_NUM_RE = re.compile(r"(\d+)(?=\D*$)")


def split_frame_id(name: str) -> tuple[str, int, str] | None:
    """'0001TP_006690.png' -> ('0001TP_', 6690, '.png') using the last
    integer group in the stem."""
    stem, ext = os.path.splitext(name)
    m = _NUM_RE.search(stem)
    if not m:
        return None
    return stem[:m.start(1)], int(m.group(1)), stem[m.end(1):] + ext


class GenericClipDataset:
    n_classes: int = 0
    ignore_index: int = 250

    def __init__(self, root: str, split: str = "train", augmentations=None,
                 interval: int = 2, path_num: int = 2, seed=None,
                 frame_step: int = 1):
        self.root = root
        self.split = split
        self.augmentations = augmentations
        self.interval = interval
        self.path_num = path_num
        self.frame_step = frame_step
        self._rng = _random.Random(seed)
        self.files = self._list_images()
        if not self.files:
            raise FileNotFoundError(
                f"No files for split=[{split}] under {root}")

    # -- layout hooks -------------------------------------------------
    def _list_images(self) -> list[str]:
        raise NotImplementedError

    def _label_path(self, img_path: str) -> str:
        raise NotImplementedError

    def _sequence_dir(self, img_path: str) -> str | None:
        return None

    def _encode_label(self, lbl: np.ndarray) -> np.ndarray:
        return lbl.astype(np.int64)

    # -----------------------------------------------------------------
    def __len__(self):
        return len(self.files)

    def _read(self, path):
        img = np.asarray(read_png(path))
        if img.ndim == 2:
            return img
        return img[..., :3]

    def _predecessors(self, img_path: str, count: int) -> list[str]:
        seq_dir = self._sequence_dir(img_path)
        name = os.path.basename(img_path)
        parsed = split_frame_id(name)
        out = []
        cur = parsed[1] if parsed else None
        for _ in range(count):
            cand = None
            if seq_dir is not None and parsed is not None:
                gap = self._rng.randint(1, self.interval) * self.frame_step
                cur = cur - gap
                prefix, _, suffix = parsed
                # frame ids keep the original zero-padding width
                width = len(_NUM_RE.search(os.path.splitext(name)[0]).group(1))
                cand = os.path.join(seq_dir, f"{prefix}{cur:0{width}d}{suffix}")
            if cand is None or not os.path.isfile(cand):
                cand = out[-1] if out else img_path  # static-clip fallback
            out.append(cand)
        return out

    def __getitem__(self, index: int):
        img_path = self.files[index]
        lbl = self._encode_label(self._read(self._label_path(img_path)))
        preds = self._predecessors(img_path, 3)  # f3, f2, f1 (newest first)
        imgs = [self._read(img_path)] + [self._read(p) for p in preds]
        imgs = [im.astype(np.uint8) for im in imgs]
        if self.augmentations is not None:
            imgs, lbl = self.augmentations(imgs, lbl.astype(np.uint8))
        else:
            imgs = [im.astype(np.float32) for im in imgs]
            lbl = lbl.astype(np.int64)
        f4, f3, f2, f1 = imgs
        clip = [f1, f2, f3, f4]
        return clip[-self.path_num:], lbl
