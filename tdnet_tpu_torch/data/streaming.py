"""Streaming frame source and the segmentation palettes (inference side).

The port's own copy of what the streaming CLI needs from the JAX package's
``tdnet_tpu/data/streaming.py`` (the port imports nothing of that package).
Mirrors Testing/dataloader.py: a recursive, name-sorted png glob, a resize to
the network input and the ImageNet normalization; and the 19-class trainId
colour palette for the outputs (dataloader.py:19-41,75-88). No image
library: frames are read by ``data/png.py`` and resized by torch.
"""

from __future__ import annotations

import colorsys
import os

import numpy as np
import torch
import torch.nn.functional as F

from tdnet_tpu_torch.data.png import read_png

CITYSCAPES_COLORS = np.array([
    [128, 64, 128], [244, 35, 232], [70, 70, 70], [102, 102, 156],
    [190, 153, 153], [153, 153, 153], [250, 170, 30], [220, 220, 0],
    [107, 142, 35], [152, 251, 152], [0, 130, 180], [220, 20, 60],
    [255, 0, 0], [0, 0, 142], [0, 0, 70], [0, 60, 100], [0, 80, 100],
    [0, 0, 230], [119, 11, 32]], dtype=np.uint8)

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)

# CamVid 11-class palette (SegNet convention)
CAMVID_COLORS = np.array([
    [128, 128, 128], [128, 0, 0], [192, 192, 128], [128, 64, 128],
    [0, 0, 192], [128, 128, 0], [192, 128, 128], [64, 64, 128],
    [64, 0, 128], [64, 64, 0], [0, 128, 192]], dtype=np.uint8)


def _spaced_colors(n: int) -> np.ndarray:
    """A deterministic palette of ``n`` hue-spaced colours (NYUDv2-40 has no
    canonical colouring)."""
    cols = [colorsys.hsv_to_rgb((i * 7 % n) / n, 0.95 if i % 2 else 0.6,
                                0.9 if i % 3 else 0.55) for i in range(n)]
    return (np.asarray(cols) * 255).astype(np.uint8)


NYUD40_COLORS = _spaced_colors(40)

# dataset name -> (number of classes, palette)
DATASET_META = {
    "cityscapes": (19, CITYSCAPES_COLORS),
    "camvid": (11, CAMVID_COLORS),
    "nyud2": (40, NYUD40_COLORS),
    "nyudv2": (40, NYUD40_COLORS),
}


def recursive_glob(rootdir: str, suffix: str = ".png") -> list[str]:
    return sorted(os.path.join(root, fn) for root, _, fns in os.walk(rootdir)
                  for fn in fns if fn.endswith(suffix))


def decode_segmap(pred: np.ndarray, colors: np.ndarray = CITYSCAPES_COLORS) -> np.ndarray:
    """Label map [H, W] int -> RGB uint8 [H, W, 3]."""
    return colors[np.clip(pred, 0, len(colors) - 1)]


def normalize_frame(img: np.ndarray) -> np.ndarray:
    """uint8 HWC RGB -> normalized float32 HWC."""
    return (img.astype(np.float32) / 255.0 - IMAGENET_MEAN) / IMAGENET_STD


def resize_linear(img: np.ndarray, in_size: tuple[int, int]) -> np.ndarray:
    """uint8 HWC -> uint8 [H, W, C] at ``in_size`` (H, W): bilinear with
    half-pixel centres and no antialias (cv2's ``INTER_LINEAR``, which the
    reference's loader calls), in f32, rounded."""
    if img.shape[:2] == tuple(in_size):
        return img
    t = torch.from_numpy(np.ascontiguousarray(img)).permute(2, 0, 1)[None].float()
    out = F.interpolate(t, size=tuple(in_size), mode="bilinear", align_corners=False)
    return out[0].permute(1, 2, 0).round().clamp(0, 255).to(torch.uint8).numpy()


class FrameSource:
    """Eager frame-directory loader (reference: Testing/dataloader.py).

    Yields (normalized NHWC float32 [1, H, W, 3], frame name, parent folder,
    original (H, W)). Reads through ``data/png.py`` and resizes with
    ``resize_linear``: no image library.
    """

    def __init__(self, img_path: str, in_size: tuple[int, int]):
        self.files = recursive_glob(img_path, ".png")
        if not self.files:
            raise FileNotFoundError(f"no .png frames under {img_path}")
        self.in_size = in_size  # (H, W)

    def __len__(self):
        return len(self.files)

    def __iter__(self):
        for path in self.files:
            img = read_png(path)
            if img.ndim == 2:
                img = np.stack([img] * 3, axis=-1)
            ori = img.shape[:2]
            img = resize_linear(img, self.in_size)
            yield (normalize_frame(img)[None], os.path.basename(path),
                   os.path.basename(os.path.dirname(path)), ori)
