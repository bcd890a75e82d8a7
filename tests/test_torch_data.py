"""The port's data pipeline against the JAX package's, on the CPU: PNG files
(``data/png.py`` against imageio), the augmentations (against PIL through
``tdnet_tpu/data/augment.py``), the clip datasets and ``ClipBatcher``, and the
streaming ``FrameSource`` (against cv2's resize).

Tolerances: the augmentations, the composed recipes and the datasets are
exact (masks, labels and uint8 images; after ColorNorm the same float32
values), since each op computes Pillow's arithmetic; the streaming resize
within one uint8 level, with the share of values that differ printed and
bounded (11-13% of values at these sizes), since it computes in f32 where
cv2 rounds its weights to 11-bit fixed point.
"""

import ast
import glob
import os

import imageio.v2 as imageio
import numpy as np
import pytest
from PIL import Image, ImageEnhance

from tdnet_tpu.data import augment as J
from tdnet_tpu.data.camvid import CamVidClips as JaxCamVid
from tdnet_tpu.data.cityscapes import CityscapesClips as JaxCityscapes
from tdnet_tpu.data.cityscapes import ClipBatcher as JaxBatcher
from tdnet_tpu.data.nyudv2 import NYUDv2Clips as JaxNYUD
from tdnet_tpu.data.streaming import FrameSource as JaxFrameSource
from tdnet_tpu_torch.data import augment as T
from tdnet_tpu_torch.data import get_loader
from tdnet_tpu_torch.data.cityscapes import ClipBatcher, encode_segmap
from tdnet_tpu_torch.data.png import PNGError, read_png, write_png
from tdnet_tpu_torch.data.streaming import FrameSource

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MEAN_STD = [[0.485, 0.456, 0.406], [0.229, 0.224, 0.225]]
TRAIN_AUG = {"rotate": 5, "colorjtr": [0.5, 0.5, 0.5], "scale": [65, 129], "hflip": 0.5,
             "rscale": [0.75, 1.0, 1.25, 1.5], "rcrop": [65, 129], "colornorm": MEAN_STD}
VAL_AUG = {"scale": [65, 129], "colornorm": MEAN_STD}
IMAGE_LIBS = {"PIL", "imageio", "cv2"}


def scene(rng, h, w):
    """A seeded uint8 RGB scene: 8x8 blocks of colour with noise on them."""
    base = rng.randint(0, 256, (h // 8 + 1, w // 8 + 1, 3)).astype(np.float64)
    up = np.kron(base, np.ones((8, 8, 1)))[:h, :w]
    return np.clip(up + rng.randn(h, w, 3) * 20, 0, 255).astype(np.uint8)


def label_ids(rng, h, w):
    """labelIds in 16x16 blocks, void ids and 255 among them."""
    ids = np.array([0, 1, 7, 8, 11, 12, 13, 17, 19, 20, 21, 22, 23, 24, 26, 33, 255])
    base = rng.choice(ids, (h // 16 + 1, w // 16 + 1))
    return np.kron(base, np.ones((16, 16), np.int64))[:h, :w].astype(np.uint8)


def write_cityscapes_tree(root, counts=(("train", 3), ("val", 2)), size=(64, 128), seed=0,
                          static=("val",), preds=6):
    """A seeded Cityscapes-layout tree: per annotated frame its image, labelIds
    and ``preds`` predecessors in leftImg8bit_sequence. A split in ``static``
    repeats the annotated frame as its predecessors, so that the random gaps
    the loaders draw do not change its clips; the others pan a scene a pixel a
    frame."""
    rng = np.random.RandomState(seed)
    h, w = size
    for split, n in counts:
        for i in range(n):
            city = ("aachen", "bochum")[i % 2] if split == "train" else "frankfurt"
            seq, cur = f"{i:06d}", 19 + 10 * i
            wide = scene(rng, h, w + preds)
            for k in range(preds + 1):
                off = 0 if split in static else preds - k
                d = os.path.join(root, "leftImg8bit_sequence", split, city)
                os.makedirs(d, exist_ok=True)
                write_png(os.path.join(d, f"{city}_{seq}_{cur - k:06d}_leftImg8bit.png"),
                          wide[:, off:off + w], level=1)
            for base, suffix, img in (("leftImg8bit", "leftImg8bit", wide[:, preds:]),
                                      ("gtFine", "gtFine_labelIds", label_ids(rng, h, w))):
                d = os.path.join(root, base, split, city)
                os.makedirs(d, exist_ok=True)
                write_png(os.path.join(d, f"{city}_{seq}_{cur:06d}_{suffix}.png"), img, level=1)
    return str(root)


# --- data/png.py ---------------------------------------------------------------

def _filtered_png(path, img, filters):
    """A PNG whose row y uses filter ``filters[y % len(filters)]`` (written
    here, with the forward filters of the PNG spec)."""
    import struct
    import zlib
    h = img.shape[0]
    rows = img.reshape(h, -1).astype(np.int64)
    bpp = img.shape[2] if img.ndim == 3 else 1
    out = []
    prior = np.zeros_like(rows[0])
    for y in range(h):
        f, cur = filters[y % len(filters)], rows[y]
        left = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int64), prior[:-bpp]])
        if f == 0:
            pred = np.zeros_like(cur)
        elif f == 1:
            pred = left
        elif f == 2:
            pred = prior
        elif f == 3:
            pred = (left + prior) // 2
        else:
            pa, pb = np.abs(prior - upleft), np.abs(left - upleft)
            pc = np.abs(left + prior - 2 * upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prior, upleft))
        out.append(np.concatenate([[f], (cur - pred) % 256]).astype(np.uint8))
        prior = cur
    chunk = lambda k, b: (struct.pack(">I", len(b)) + k + b
                          + struct.pack(">I", zlib.crc32(k + b)))
    ctype = 2 if img.ndim == 3 else 0
    ihdr = struct.pack(">IIBBBBB", img.shape[1], h, 8, ctype, 0, 0, 0)
    data = zlib.compress(np.stack(out).tobytes())
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr) + chunk(b"IDAT", data)
                + chunk(b"IEND", b""))


@pytest.mark.parametrize("shape", [(40, 61, 3), (33, 47), (20, 30, 4)], ids=["rgb", "gray", "rgba"])
def test_png_reads_imageio_files_bitwise(tmp_path, shape):
    rng = np.random.RandomState(0)
    img = scene(rng, *shape[:2])
    img = img if len(shape) == 3 and shape[2] == 3 else (
        img[..., 0] if len(shape) == 2 else np.concatenate([img, img[..., :1]], axis=-1))
    path = str(tmp_path / "x.png")
    imageio.imwrite(path, img)
    want = imageio.imread(path)
    np.testing.assert_array_equal(read_png(path), want[..., :3] if want.ndim == 3 else want)


def test_png_reads_16_bit_gray_and_palettes(tmp_path):
    rng = np.random.RandomState(1)
    g16 = (rng.rand(9, 13) * 65535).astype(np.uint16)
    imageio.imwrite(tmp_path / "g16.png", g16)
    got = read_png(str(tmp_path / "g16.png"))
    assert got.dtype == np.uint16
    np.testing.assert_array_equal(got, g16)
    for bits, colors in ((8, 200), (4, 16), (2, 4), (1, 2)):
        pal = Image.fromarray(scene(rng, 9, 13)).convert("P", palette=Image.ADAPTIVE,
                                                           colors=colors)
        path = str(tmp_path / f"p{bits}.png")
        pal.save(path, bits=bits)
        np.testing.assert_array_equal(read_png(path), imageio.imread(path))


@pytest.mark.parametrize("filters", [(0,), (1,), (2,), (3,), (4,), (0, 1, 2, 3, 4)],
                         ids=["none", "sub", "up", "average", "paeth", "mixed"])
def test_png_undoes_each_row_filter(tmp_path, filters):
    rng = np.random.RandomState(2)
    for img in (scene(rng, 11, 17), scene(rng, 11, 17)[..., 1]):
        path = str(tmp_path / "f.png")
        _filtered_png(path, img, filters)
        np.testing.assert_array_equal(imageio.imread(path), img)
        np.testing.assert_array_equal(read_png(path), img)


@pytest.mark.parametrize("dtype,shape", [(np.uint8, (7, 9, 3)), (np.uint8, (7, 9)),
                                         (np.uint16, (7, 9)), (np.uint8, (7, 9, 4))])
def test_png_round_trips_its_own_files(tmp_path, dtype, shape):
    img = (np.random.RandomState(3).rand(*shape) * np.iinfo(dtype).max).astype(dtype)
    path = str(tmp_path / "w.png")
    write_png(path, img)
    np.testing.assert_array_equal(read_png(path), img[..., :3] if img.ndim == 3 else img)
    np.testing.assert_array_equal(imageio.imread(path), img)


@pytest.mark.parametrize("filters", [(1,), (2,), (3,), (4,), (0, 1, 2, 3, 4), (4, 3)],
                         ids=["sub", "up", "average", "paeth", "mixed", "paeth-average"])
@pytest.mark.parametrize("dtype,shape", [(np.uint8, (13, 21, 3)), (np.uint16, (13, 21)),
                                         (np.uint8, (13, 21, 4))], ids=["rgb", "gray16", "rgba"])
def test_png_writes_each_row_filter(tmp_path, filters, dtype, shape):
    """``write_png(filters=...)``: imageio reads the file as the array, and so
    does ``read_png`` (whose Average and Paeth rows run a diagonal at a
    time)."""
    img = (np.random.RandomState(4).rand(*shape) * np.iinfo(dtype).max).astype(dtype)
    path = str(tmp_path / "wf.png")
    write_png(path, img, filters=filters)
    np.testing.assert_array_equal(imageio.imread(path), img)
    np.testing.assert_array_equal(read_png(path), img[..., :3] if img.ndim == 3 else img)


def test_png_refuses_what_it_does_not_read(tmp_path):
    jpg = tmp_path / "frame.jpg"
    jpg.write_bytes(b"\xff\xd8\xff\xe0 not decoded")
    with pytest.raises(NotImplementedError, match="JPEG decoding is not ported"):
        read_png(str(jpg))
    la = str(tmp_path / "la.png")
    Image.fromarray(np.zeros((3, 4, 2), np.uint8), mode="LA").save(la)
    with pytest.raises(PNGError, match="la.png"):
        read_png(la)
    bad = tmp_path / "bad.png"
    data = bytearray(open(la, "rb").read())
    data[20] ^= 1   # inside IHDR: its CRC fails
    bad.write_bytes(bytes(data))
    with pytest.raises(PNGError, match="CRC"):
        read_png(str(bad))


# --- data/augment.py against PIL ----------------------------------------------

def _levels(got, want, name, max_share):
    got, want = np.asarray(got).astype(np.int64), np.asarray(want).astype(np.int64)
    assert got.shape == want.shape, name
    diff = np.abs(got - want)
    share = float(np.mean(diff > 0))
    print(f"{name}: max {diff.max()} level(s), {share:.4%} of values differ")
    assert diff.max() <= 1 and share <= max_share, (name, diff.max(), share)


@pytest.mark.parametrize("size", [(150, 75), (300, 160), (129, 65), (77, 41), (193, 97)])
def test_resizes_match_pil(size):
    rng = np.random.RandomState(4)
    img, mask = scene(rng, 97, 193), rng.randint(0, 20, (97, 193)).astype(np.uint8)
    np.testing.assert_array_equal(T.resize_bilinear(img, size),
                                  Image.fromarray(img).resize(size, Image.BILINEAR))
    np.testing.assert_array_equal(T.resize_nearest(mask, size),
                                  Image.fromarray(mask).resize(size, Image.NEAREST))


@pytest.mark.parametrize("angle", [4.3, -3.7, 0.9, -5.0, 0.0])
def test_rotation_matches_pil(angle):
    rng = np.random.RandomState(5)
    img, mask = scene(rng, 65, 129), rng.randint(0, 20, (65, 129)).astype(np.uint8)
    np.testing.assert_array_equal(
        T.tv_affine(img, angle, (0, 0), "bilinear", (0, 0, 0)),
        J.tv_affine(Image.fromarray(img), angle, (0, 0), Image.BILINEAR, (0, 0, 0)))
    np.testing.assert_array_equal(
        T.tv_affine(mask, angle, (0, 0), "nearest", 250),
        J.tv_affine(Image.fromarray(mask), angle, (0, 0), Image.NEAREST, 250))


@pytest.mark.parametrize("f", [0.5, 0.73, 1.0, 1.3, 1.49])
def test_colour_jitter_matches_image_enhance(f):
    img = scene(np.random.RandomState(6), 33, 57)
    pil = Image.fromarray(img)
    np.testing.assert_array_equal(T.luma(img), pil.convert("L"))
    for ours, theirs in ((T.enhance_brightness, ImageEnhance.Brightness),
                         (T.enhance_contrast, ImageEnhance.Contrast),
                         (T.enhance_color, ImageEnhance.Color)):
        np.testing.assert_array_equal(ours(img, f), theirs(pil).enhance(f))


def test_crops_and_flips_match_pil():
    rng = np.random.RandomState(7)
    img = scene(rng, 30, 41)
    for box in ((3, 5, 20, 25), (-3, 5, 50, 35)):
        np.testing.assert_array_equal(T.crop(img, box), Image.fromarray(img).crop(box))
    aug = {"ccrop": [20, 28], "vflip": 1.0, "translate": [5, 3], "colornorm": MEAN_STD}
    _compare_recipes(aug, seed=1, n=3)


def _compare_recipes(aug, seed, n, size=(80, 160)):
    """The port's and JAX's composed recipes on the same clips and seed: the
    same draws, masks and images."""
    ours, theirs = T.get_composed_augmentations(aug, seed=seed), J.get_composed_augmentations(
        aug, seed=seed)
    rng = np.random.RandomState(seed)
    for _ in range(n):
        clip = [scene(rng, *size) for _ in range(4)]
        lbl = encode_segmap(label_ids(rng, *size))
        got_imgs, got_mask = ours([c.copy() for c in clip], lbl.copy())
        want_imgs, want_mask = theirs([c.copy() for c in clip], lbl.copy())
        assert ours.rng.getstate() == theirs.rng.getstate()
        np.testing.assert_array_equal(got_mask, want_mask)
        assert got_mask.dtype == want_mask.dtype == np.int64
        for g, w in zip(got_imgs, want_imgs):
            assert g.dtype == w.dtype == np.float32
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_train_recipe_matches_jax(seed):
    _compare_recipes(TRAIN_AUG, seed, n=2)


def test_val_recipe_matches_jax():
    _compare_recipes(VAL_AUG, seed=0, n=2)


# --- datasets and ClipBatcher -------------------------------------------------

def _same_items(port_ds, jax_ds):
    assert len(port_ds) == len(jax_ds)
    for i in range(len(port_ds)):
        (pf, pl), (jf, jl) = port_ds[i], jax_ds[i]
        assert len(pf) == len(jf)
        np.testing.assert_array_equal(pl, jl)
        for a, b in zip(pf, jf):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("aug", [None, TRAIN_AUG], ids=["raw", "train_recipe"])
def test_cityscapes_clips_match_jax(tmp_path, aug):
    root = write_cityscapes_tree(tmp_path, static=())
    for split, path_num in (("train", 4), ("val", 2)):
        port = get_loader("cityscapes")(root, split, T.get_composed_augmentations(aug, seed=3),
                                        path_num=path_num, seed=5)
        ref = JaxCityscapes(root, split, J.get_composed_augmentations(aug, seed=3),
                            path_num=path_num, seed=5)
        _same_items(port, ref)


def test_clip_batcher_matches_jax(tmp_path):
    """One worker: the shared generator of gaps meets the clips in index order."""
    root = write_cityscapes_tree(tmp_path, counts=(("train", 5),), static=())
    port = ClipBatcher(get_loader("cityscapes")(root, "train", T.get_composed_augmentations(
        TRAIN_AUG, seed=1), path_num=4, seed=2), 2, num_workers=1, seed=7, infinite=True)
    ref = JaxBatcher(JaxCityscapes(root, "train", J.get_composed_augmentations(TRAIN_AUG, seed=1),
                                   path_num=4, seed=2), 2, num_workers=1, seed=7, infinite=True)
    for n, ((pf, pl), (jf, jl)) in enumerate(zip(port, ref)):
        assert pf.shape == jf.shape == (4, 2, 65, 129, 3) and pf.dtype == np.float32
        assert pl.shape == (2, 65, 129) and pl.dtype == jl.dtype == np.int32
        np.testing.assert_array_equal(pl, jl)
        np.testing.assert_array_equal(pf, jf)
        if n == 4:   # two epochs and a half
            break


def test_clip_batcher_yields_the_last_short_batch(tmp_path):
    """``drop_last=False`` keeps an epoch's remainder, as the reference's torch
    ``DataLoader`` does; JAX's ``ClipBatcher`` drops it (its fault, left as it
    is): a val split of 2 clips at batch 4 gives the port one batch and JAX's
    none."""
    root = write_cityscapes_tree(tmp_path, counts=(("val", 5),))
    port = get_loader("cityscapes")(root, "val", T.get_composed_augmentations(VAL_AUG),
                                    path_num=2)
    ref = JaxCityscapes(root, "val", J.get_composed_augmentations(VAL_AUG), path_num=2)
    got = list(ClipBatcher(port, 2, shuffle=False, drop_last=False, num_workers=2))
    want = list(JaxBatcher(ref, 2, shuffle=False, drop_last=False, num_workers=2))
    assert [g[1].shape[0] for g in got] == [2, 2, 1]
    assert [w[1].shape[0] for w in want] == [2, 2]
    for (gf, gl), (wf, wl) in zip(got, want):
        np.testing.assert_array_equal(gf, wf)
        np.testing.assert_array_equal(gl, wl)
    assert got[2][0].shape == (2, 1, 65, 129, 3)
    assert len(list(ClipBatcher(port, 8, shuffle=False, drop_last=False))) == 1
    assert len(list(ClipBatcher(port, 2, shuffle=False, drop_last=True))) == 2


def test_camvid_and_nyudv2_clips_match_jax(tmp_path):
    rng = np.random.RandomState(8)
    cam = tmp_path / "camvid"
    for d in ("train", "trainannot", "train_sequence"):
        (cam / d).mkdir(parents=True)
    for i in (30, 60):
        write_png(str(cam / "train" / f"0001TP_{i:06d}.png"), scene(rng, 24, 32))
        write_png(str(cam / "trainannot" / f"0001TP_{i:06d}.png"),
                  rng.randint(0, 13, (24, 32)).astype(np.uint8))
        for k in range(1, 7):
            write_png(str(cam / "train_sequence" / f"0001TP_{i - k:06d}.png"), scene(rng, 24, 32))
    nyu = tmp_path / "nyud"
    for d in ("images/train", "labels/train"):
        (nyu / d).mkdir(parents=True)
    for i in range(2):
        write_png(str(nyu / "images/train" / f"{i:04d}.png"), scene(rng, 24, 32))
        write_png(str(nyu / "labels/train" / f"{i:04d}.png"),
                  rng.randint(0, 42, (24, 32)).astype(np.uint8))
    for name, root, ref_cls in (("camvid", cam, JaxCamVid), ("nyudv2", nyu, JaxNYUD)):
        port = get_loader(name)(str(root), "train", path_num=4, seed=4)
        _same_items(port, ref_cls(str(root), "train", path_num=4, seed=4))
    (nyu / "images/train" / "0002.jpg").write_bytes(b"\xff\xd8")
    (nyu / "labels/train" / "0002.png").write_bytes(
        open(nyu / "labels/train" / "0000.png", "rb").read())
    with pytest.raises(NotImplementedError, match="JPEG"):
        get_loader("nyud2")(str(nyu), "train", path_num=4)[2]


# --- the streaming FrameSource -----------------------------------------------

def test_frame_source_matches_jax(tmp_path):
    rng = np.random.RandomState(9)
    d = tmp_path / "vid" / "clip"
    d.mkdir(parents=True)
    imageio.imwrite(d / "a.png", scene(rng, 50, 90))
    imageio.imwrite(d / "b.png", scene(rng, 50, 90)[..., 0])
    imageio.imwrite(d / "c.png", scene(rng, 65, 129))
    for size in ((33, 65), (65, 129), (100, 200)):
        got, want = list(FrameSource(str(tmp_path), size)), list(JaxFrameSource(str(tmp_path),
                                                                                 size))
        assert [g[1:] for g in got] == [w[1:] for w in want]
        mean, std = np.asarray(MEAN_STD[0]), np.asarray(MEAN_STD[1])
        for g, w in zip(got, want):
            assert g[0].shape == w[0].shape == (1, *size, 3) and g[0].dtype == np.float32
            back = lambda x: np.round((x * std + mean) * 255.0)
            _levels(back(g[0]), back(w[0]), f"frame {g[1]} at {size}", 0.25)


# --- no image library on the port's data path ---------------------------------

def test_no_image_library_on_the_port_path():
    files = sorted(glob.glob(os.path.join(REPO, "tdnet_tpu_torch", "**", "*.py"), recursive=True))
    assert any(f.endswith(os.path.join("data", "png.py")) for f in files)
    for path in files + [os.path.join(REPO, "chip_smoke.py")]:
        roots = set()
        for node in ast.walk(ast.parse(open(path).read())):
            if isinstance(node, ast.Import):
                roots |= {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                roots.add(node.module.split(".")[0])
        assert not roots & IMAGE_LIBS, f"{path} imports {sorted(roots & IMAGE_LIBS)}"
