"""Clip-consistent augmentations on the host, in numpy and torch, without an
image library (``tdnet_tpu/data/augment.py``; reference
Training/ptsemseg/augmentations/augmentations.py).

Each op draws its random parameters once per clip, from the ``Compose``'s
``random.Random``, in the JAX module's order and with its calls, so that one
seed gives the same scales, crops, angles and flips; the draws apply alike to
every frame and to the mask. The pipeline follows the config dict's order.

Images are uint8 RGB arrays [H, W, 3] and the mask a uint8 array [H, W], as
PIL's "RGB" and "L" images of the JAX module; each op computes what its PIL
call computes:
- bilinear resize: PIL's ``BILINEAR``, which antialiases when it shrinks:
  Pillow's own taps and 2^22 fixed point, in torch int32 ops (torch's
  antialiased uint8 ``F.interpolate`` rounds 0.02-0.35% of pixels a level
  the other way, and colour jitter then makes some of them two);
- nearest resize: PIL's ``NEAREST`` takes source pixel floor((x + 0.5) *
  in / out) (``nearest-exact``, not ``nearest``), its positions summed one
  step at a time in double precision as Pillow sums them;
- rotation (``tv_affine``): an inverse-mapped affine about (w/2 + 0.5,
  h/2 + 0.5); images bilinear in double precision, truncated to uint8, fill 0
  (Pillow's generic transform); the mask nearest in 16.16 fixed point, fill
  250 (Pillow's ``affine_fixed``);
- colour jitter: ``ImageEnhance`` is ``Image.blend(degenerate, image, f)``
  in float32, truncated (clipped when f > 1); its "L" image is Pillow's
  fixed-point luma (19595 R + 38470 G + 7471 B + 2^15) >> 16, and contrast's
  degenerate the mean of that image rounded to an int.
"""

from __future__ import annotations

import functools
import math
import numbers
import random as _random

import numpy as np
import torch

from tdnet_tpu_torch.data.streaming import IMAGENET_MEAN, IMAGENET_STD

IGNORE_FILL = 250
PRECISION_BITS = 22   # Pillow's fixed point for 8-bit resampling (32 - 8 - 2)


def _size(img: np.ndarray) -> tuple[int, int]:
    """(w, h), PIL's ``Image.size``."""
    return img.shape[1], img.shape[0]


@functools.cache
def _bilinear_taps(in_size: int, out_size: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Pillow's ``precompute_coeffs`` for its triangle filter, then
    ``normalize_coeffs_8bpc``: per output index the source indices [out, k]
    and their int32 weights (2^22 fixed point; 0 past each row's taps), in
    Pillow's order of operations."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    ss = 1.0 / filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    idx = np.zeros((out_size, ksize), np.int64)
    kk = np.zeros((out_size, ksize), np.float64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        ww = 0.0
        for x in range(xmax):
            kk[xx, x] = max(1.0 - abs((x + xmin - center + 0.5) * ss), 0.0)
            ww += kk[xx, x]
        if ww != 0.0:
            kk[xx, :xmax] /= ww
        idx[xx] = xmin + np.minimum(np.arange(ksize), max(xmax - 1, 0))
    fixed = np.trunc(0.5 + kk * (1 << PRECISION_BITS)).astype(np.int32)
    return torch.from_numpy(idx), torch.from_numpy(fixed)


def _resample_axis(x: torch.Tensor, dim: int, out_size: int) -> torch.Tensor:
    """One of Pillow's two passes on int32 ``x``: the taps summed from a
    rounding half, shifted back and clipped to uint8 values."""
    idx, w = _bilinear_taps(x.shape[dim], out_size)
    shape = [out_size if d == dim else 1 for d in range(x.ndim)]
    out_shape = [out_size if d == dim else n for d, n in enumerate(x.shape)]
    acc = torch.full(out_shape, 1 << (PRECISION_BITS - 1), dtype=torch.int32)
    for k in range(idx.shape[1]):
        acc += torch.index_select(x, dim, idx[:, k]) * w[:, k].reshape(shape)
    return (acc >> PRECISION_BITS).clamp_(0, 255)


def resize_bilinear(img: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """PIL ``img.resize((w, h), BILINEAR)`` of a uint8 RGB image; ``size`` is
    (w, h). Pillow's separable filter (a triangle stretched by the scale when
    it shrinks, so that it antialiases) in its fixed point: the horizontal
    pass, rounded to uint8 values, then the vertical one."""
    w, h = size
    if (w, h) == _size(img):
        return img.copy()
    x = torch.from_numpy(np.ascontiguousarray(img)).to(torch.int32)
    if w != img.shape[1]:
        x = _resample_axis(x, 1, w)
    if h != img.shape[0]:
        x = _resample_axis(x, 0, h)
    return x.to(torch.uint8).numpy()


def _nearest_index(in_size: int, out_size: int) -> np.ndarray:
    """Pillow's ``ImagingScaleAffine``: the source of output i is the floor of
    step / 2 + i x step, step = in / out, summed one step at a time in double
    precision as Pillow sums it."""
    step = in_size / out_size
    pos = np.add.accumulate(np.concatenate([[step * 0.5], np.full(out_size - 1, step)]))
    return np.minimum(pos.astype(np.int64), in_size - 1)


def resize_nearest(img: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """PIL ``img.resize((w, h), NEAREST)``."""
    w, h = size
    if (w, h) == _size(img):
        return img.copy()
    ys, xs = _nearest_index(img.shape[0], h), _nearest_index(img.shape[1], w)
    return img[ys[:, None], xs[None, :]]


def crop(img: np.ndarray, box: tuple[int, int, int, int]) -> np.ndarray:
    """PIL ``img.crop((x1, y1, x2, y2))``: out-of-image pixels are 0."""
    x1, y1, x2, y2 = box
    h, w = img.shape[:2]
    if x1 >= 0 and y1 >= 0 and x2 <= w and y2 <= h:
        return img[y1:y2, x1:x2].copy()
    out = np.zeros((y2 - y1, x2 - x1) + img.shape[2:], img.dtype)
    sx, sy = max(x1, 0), max(y1, 0)
    ex, ey = min(x2, w), min(y2, h)
    if ex > sx and ey > sy:
        out[sy - y1:ey - y1, sx - x1:ex - x1] = img[sy:ey, sx:ex]
    return out


@functools.lru_cache(maxsize=4)
def _bilinear_map(h: int, w: int, m: tuple) -> tuple:
    """The sampling plan of Pillow's generic affine transform with its
    bilinear filter, built once for the frames of a clip: output pixel (x, y)
    samples (m0 (x + .5) + m1 (y + .5) + m2, m3 (x + .5) + m4 (y + .5) + m5);
    returns the flat indices of the four taps, the double-precision weights
    dx, dy, whether the row below exists, and the pixels inside the image."""
    xs = np.arange(w, dtype=np.float64)[None, :] + 0.5
    ys = np.arange(h, dtype=np.float64)[:, None] + 0.5
    xin = m[0] * xs + m[1] * ys + m[2]
    yin = m[3] * xs + m[4] * ys + m[5]
    inside = (xin >= 0.0) & (xin < w) & (yin >= 0.0) & (yin < h)
    xin, yin = xin - 0.5, yin - 0.5
    x, y = np.floor(xin), np.floor(yin)
    dx, dy = xin - x, yin - y
    x, y = x.astype(np.int64), y.astype(np.int64)
    x0, x1 = np.clip(x, 0, w - 1), np.clip(x + 1, 0, w - 1)
    y0 = np.clip(y, 0, h - 1)
    has_next = (y + 1 >= 0) & (y + 1 < h)
    y1 = np.where(has_next, np.clip(y + 1, 0, h - 1), y0)
    taps = [torch.from_numpy((yy * w + xx).ravel()) for yy in (y0, y1) for xx in (x0, x1)]
    col = lambda a: torch.from_numpy(np.ascontiguousarray(a.reshape(-1, 1)))
    return taps, col(dx), col(dy), col(has_next), torch.from_numpy(inside)


def _affine_bilinear(img: np.ndarray, m, fill) -> np.ndarray:
    """Pillow's generic affine transform with its bilinear filter
    (``_bilinear_map``): a sample outside the image takes ``fill``; the lerps
    run in double precision (torch's threads, one op at a time, as numpy
    would round) and the result is truncated."""
    h, w, c = img.shape
    taps, dx, dy, has_next, inside = _bilinear_map(h, w, tuple(m))
    flat = torch.from_numpy(np.ascontiguousarray(img)).reshape(-1, c)
    a, b, a2, b2 = (flat.index_select(0, t).double() for t in taps)
    v1 = a + (b - a) * dx
    v2 = torch.where(has_next, a2 + (b2 - a2) * dx, v1)
    v = (v1 + (v2 - v1) * dy).to(torch.uint8).reshape(h, w, c)
    return torch.where(inside[..., None], v, torch.tensor(fill, dtype=torch.uint8)).numpy()


def _affine_nearest(img: np.ndarray, m, fill) -> np.ndarray:
    """Pillow's ``affine_fixed``: the nearest sample of the same map in 16.16
    fixed point (coefficients rounded, shifts that floor), ``fill`` outside."""
    h, w = img.shape[:2]
    fix = lambda v: int(math.floor(v * 65536.0 + 0.5))
    a0, a1, a3, a4 = fix(m[0]), fix(m[1]), fix(m[3]), fix(m[4])
    a2 = fix(m[2] + m[0] * 0.5 + m[1] * 0.5)
    a5 = fix(m[5] + m[3] * 0.5 + m[4] * 0.5)
    xs = np.arange(w, dtype=np.int64)[None, :]
    ys = np.arange(h, dtype=np.int64)[:, None]
    xin = (a2 + ys * a1 + xs * a0) >> 16
    yin = (a5 + ys * a4 + xs * a3) >> 16
    inside = (xin >= 0) & (xin < w) & (yin >= 0) & (yin < h)
    out = img[np.clip(yin, 0, h - 1), np.clip(xin, 0, w - 1)]
    return np.where(inside, out, np.asarray(fill, img.dtype))


def tv_affine(img: np.ndarray, angle: float, translate, resample: str, fillcolor):
    """``torchvision.transforms.functional.affine`` (PIL backend) with
    scale 1 and no shear, as the reference uses it: the inverse matrix about
    (w/2 + 0.5, h/2 + 0.5), a positive ``angle`` turning the image clockwise.
    ``resample``: "bilinear" (images) or "nearest" (masks)."""
    h, w = img.shape[:2]
    cx, cy = w * 0.5 + 0.5, h * 0.5 + 0.5
    rot = math.radians(angle)
    a, b = math.cos(rot), math.sin(rot)
    m = [a, b, 0.0, -b, a, 0.0]
    tx, ty = translate
    m[2] = m[0] * (-cx - tx) + m[1] * (-cy - ty) + cx
    m[5] = m[3] * (-cx - tx) + m[4] * (-cy - ty) + cy
    if resample == "bilinear":
        return _affine_bilinear(img, m, fillcolor)
    return _affine_nearest(img, m, fillcolor)


def blend(im1: np.ndarray, im2: np.ndarray, alpha: float) -> np.ndarray:
    """Pillow's ``Image.blend``: im1 + alpha (im2 - im1) in float32,
    truncated to uint8 (clipped to [0, 255] outside 0 <= alpha <= 1)."""
    alpha = np.float32(alpha)
    if alpha == 0.0:
        return im1.copy()
    if alpha == 1.0:
        return im2.copy()
    a = torch.from_numpy(np.ascontiguousarray(im1)).float()
    v = a + float(alpha) * (torch.from_numpy(np.ascontiguousarray(im2)).float() - a)
    if not 0.0 <= alpha <= 1.0:
        v = v.clamp_(0.0, 255.0)
    return v.to(torch.uint8).numpy()


def luma(img: np.ndarray) -> np.ndarray:
    """Pillow's RGB -> "L" conversion, in fixed point."""
    rgb = img.astype(np.int64)
    return ((rgb[..., 0] * 19595 + rgb[..., 1] * 38470 + rgb[..., 2] * 7471 + 0x8000)
            >> 16).astype(np.uint8)


def enhance_brightness(img: np.ndarray, f: float) -> np.ndarray:
    return blend(np.zeros_like(img), img, f)


def enhance_contrast(img: np.ndarray, f: float) -> np.ndarray:
    hist = np.bincount(luma(img).ravel(), minlength=256)
    mean = int(float((np.arange(256) * hist).sum()) / float(hist.sum()) + 0.5)
    return blend(np.full_like(img, mean), img, f)


def enhance_color(img: np.ndarray, f: float) -> np.ndarray:
    gray = luma(img)[..., None]
    return blend(np.broadcast_to(gray, img.shape), img, f)


class Compose:
    def __init__(self, augmentations, seed=None):
        self.augmentations = augmentations
        self.rng = _random.Random(seed) if seed is not None else _random

    def __call__(self, imgs, mask):
        assert isinstance(imgs, list)
        imgs = [np.asarray(im, np.uint8) for im in imgs]
        if mask is not None:
            mask = np.asarray(mask).astype(np.uint8)
        for a in self.augmentations:
            imgs, mask = a(imgs, mask, self.rng)
        return imgs, mask


class Scale:
    def __init__(self, size):
        self.size = size  # (h, w)

    def __call__(self, imgs, mask, rng):
        size = (self.size[1], self.size[0])
        out = [resize_bilinear(im, size) for im in imgs]
        if mask is not None:
            mask = resize_nearest(mask, size)
        return out, mask


class RandomScale:
    def __init__(self, scales=(1,)):
        self.scales = scales

    def __call__(self, imgs, mask, rng):
        scale = rng.choice(self.scales)
        W, H = _size(imgs[0])
        size = (int(W * scale), int(H * scale))
        return [resize_bilinear(im, size) for im in imgs], resize_nearest(mask, size)


class RandomCrop:
    def __init__(self, size):
        if isinstance(size, numbers.Number):
            size = (int(size), int(size))
        self.size = size  # (th, tw)

    def __call__(self, imgs, mask, rng):
        w, h = _size(imgs[0])
        th, tw = self.size
        if w == tw and h == th:
            return imgs, mask
        if w < tw or h < th:
            return ([resize_bilinear(im, (tw, th)) for im in imgs],
                    resize_nearest(mask, (tw, th)))
        x1 = rng.randint(0, w - tw)
        y1 = rng.randint(0, h - th)
        box = (x1, y1, x1 + tw, y1 + th)
        return [crop(im, box) for im in imgs], crop(mask, box)


class CenterCrop:
    def __init__(self, size):
        if isinstance(size, numbers.Number):
            size = (int(size), int(size))
        self.size = size

    def __call__(self, imgs, mask, rng):
        w, h = _size(imgs[0])
        th, tw = self.size
        x1 = int(round((w - tw) / 2.0))
        y1 = int(round((h - th) / 2.0))
        box = (x1, y1, x1 + tw, y1 + th)
        return [crop(im, box) for im in imgs], crop(mask, box)


class RandomHorizontallyFlip:
    def __init__(self, p):
        self.p = p

    def __call__(self, imgs, mask, rng):
        if rng.random() < self.p:
            return ([np.ascontiguousarray(im[:, ::-1]) for im in imgs],
                    np.ascontiguousarray(mask[:, ::-1]))
        return imgs, mask


class RandomVerticallyFlip:
    def __init__(self, p):
        self.p = p

    def __call__(self, imgs, mask, rng):
        if rng.random() < self.p:
            return ([np.ascontiguousarray(im[::-1]) for im in imgs],
                    np.ascontiguousarray(mask[::-1]))
        return imgs, mask


class RandomRotate:
    def __init__(self, degree):
        self.degree = degree

    def __call__(self, imgs, mask, rng):
        angle = rng.random() * 2 * self.degree - self.degree
        out = [tv_affine(im, angle, (0, 0), "bilinear", (0, 0, 0)) for im in imgs]
        return out, tv_affine(mask, angle, (0, 0), "nearest", IGNORE_FILL)


class RandomTranslate:
    """Shift the content by (-dx, -dy) with reflect-padded borders; the mask
    shifts alike, vacated pixels at the ignore index (reference
    augmentations.py:175-227)."""

    def __init__(self, offset):
        self.offset = offset  # (max_dx, max_dy)

    def __call__(self, imgs, mask, rng):
        dx = int(2 * (rng.random() - 0.5) * self.offset[0])
        dy = int(2 * (rng.random() - 0.5) * self.offset[1])

        def crop_box(h, w):
            return max(dy, 0), max(dx, 0), h - abs(dy), w - abs(dx)

        out = []
        for a in imgs:
            h, w = a.shape[:2]
            top, left, ch, cw = crop_box(h, w)
            cropped = a[top:top + ch, left:left + cw]
            pad = ((abs(dy) if dy < 0 else 0, dy if dy > 0 else 0),
                   (abs(dx) if dx < 0 else 0, dx if dx > 0 else 0))
            if a.ndim == 3:
                pad = pad + ((0, 0),)
            out.append(np.pad(cropped, pad, mode="reflect"))
        h, w = mask.shape
        top, left, ch, cw = crop_box(h, w)
        shifted = np.full_like(mask, IGNORE_FILL)
        dst_top = abs(dy) if dy < 0 else 0
        dst_left = abs(dx) if dx < 0 else 0
        shifted[dst_top:dst_top + ch, dst_left:dst_left + cw] = mask[top:top + ch, left:left + cw]
        return out, shifted


class ColorJitter:
    def __init__(self, p):
        b, c, s = p[0], p[1], p[2]
        self.brightness = [max(1 - b, 0), 1 + b]
        self.contrast = [max(1 - c, 0), 1 + c]
        self.saturation = [max(1 - s, 0), 1 + s]

    def __call__(self, imgs, mask, rng):
        rb = rng.uniform(*self.brightness)
        rc = rng.uniform(*self.contrast)
        rs = rng.uniform(*self.saturation)
        return [enhance_color(enhance_contrast(enhance_brightness(im, rb), rc), rs)
                for im in imgs], mask


class ColorNorm:
    """ToTensor + Normalize, the last op: float32 HWC images and an int64
    mask (reference augmentations.py:299-313)."""

    def __init__(self, mean_std):
        self.mean = np.asarray(mean_std[0], np.float32) if mean_std else IMAGENET_MEAN
        self.std = np.asarray(mean_std[1], np.float32) if mean_std else IMAGENET_STD

    def __call__(self, imgs, mask, rng):
        out = [(np.asarray(im, np.float32) / 255.0 - self.mean) / self.std for im in imgs]
        return out, np.asarray(mask).astype(np.int64)


KEY2AUG = {
    "rcrop": RandomCrop,
    "hflip": RandomHorizontallyFlip,
    "vflip": RandomVerticallyFlip,
    "scale": Scale,
    "rscale": RandomScale,
    "rotate": RandomRotate,
    "translate": RandomTranslate,
    "ccrop": CenterCrop,
    "colorjtr": ColorJitter,
    "colornorm": ColorNorm,
}


def get_composed_augmentations(aug_dict, seed=None):
    if aug_dict is None:
        return None
    return Compose([KEY2AUG[k](v) for k, v in aug_dict.items()], seed=seed)
