"""NYUDv2 clip loader (40-class convention; ``tdnet_tpu/data/nyudv2.py``).

Layout: <root>/images/<split>/*.png, <root>/labels/<split>/*.png (label
indices 1..40, 0 = unlabeled -> ignore 250; stored 0-based after -1).
Predecessors from <root>/sequence/<split>/ when the Kinect video dumps
are present; otherwise static-clip fallback (NYUDv2 is commonly
distributed as stills). ``.jpg`` images are listed, as the JAX loader lists
them, and reading one raises: JPEG decoding is not ported.
"""

from __future__ import annotations

import os

import numpy as np

from tdnet_tpu_torch.data.generic_clips import GenericClipDataset


class NYUDv2Clips(GenericClipDataset):
    n_classes = 40
    ignore_index = 250

    def _list_images(self):
        base = os.path.join(self.root, "images", self.split)
        return sorted(os.path.join(base, f) for f in os.listdir(base)
                      if f.endswith((".png", ".jpg"))) if os.path.isdir(base) else []

    def _label_path(self, img_path):
        stem = os.path.splitext(os.path.basename(img_path))[0]
        return os.path.join(self.root, "labels", self.split, stem + ".png")

    def _sequence_dir(self, img_path):
        d = os.path.join(self.root, "sequence", self.split)
        return d if os.path.isdir(d) else None

    def _encode_label(self, lbl: np.ndarray) -> np.ndarray:
        lbl = lbl.astype(np.int64) - 1  # 0 = unlabeled
        return np.where((lbl < 0) | (lbl >= self.n_classes),
                        self.ignore_index, lbl)
