"""CamVid video-clip loader (11-class SegNet convention;
``tdnet_tpu/data/camvid.py``).

Layout (SegNet distribution): <root>/{train,val,test}/ images,
<root>/{split}annot/ index labels (0..10, 11 = void -> ignore 250).
Video predecessors from <root>/{split}_sequence/ when present (CamVid
raw sequences are 30 fps with annotations every 30th frame, so
``frame_step`` defaults to 1 on extracted-sequence dirs; pass 30 when
pointing at annotation-rate ids).
"""

from __future__ import annotations

import os

import numpy as np

from tdnet_tpu_torch.data.generic_clips import GenericClipDataset


class CamVidClips(GenericClipDataset):
    n_classes = 11
    ignore_index = 250
    class_names = ["sky", "building", "pole", "road", "pavement", "tree",
                   "sign_symbol", "fence", "car", "pedestrian", "bicyclist"]

    def _list_images(self):
        base = os.path.join(self.root, self.split)
        return sorted(os.path.join(base, f) for f in os.listdir(base)
                      if f.endswith(".png")) if os.path.isdir(base) else []

    def _label_path(self, img_path):
        return os.path.join(self.root, self.split + "annot",
                            os.path.basename(img_path))

    def _sequence_dir(self, img_path):
        d = os.path.join(self.root, self.split + "_sequence")
        return d if os.path.isdir(d) else None

    def _encode_label(self, lbl: np.ndarray) -> np.ndarray:
        lbl = lbl.astype(np.int64)
        return np.where(lbl >= self.n_classes, self.ignore_index, lbl)
