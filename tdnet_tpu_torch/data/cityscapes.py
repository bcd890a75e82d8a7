"""Cityscapes video-clip dataset, the training side
(``tdnet_tpu/data/cityscapes.py``; reference
Training/ptsemseg/loader/cityscapes_loader.py).

For each annotated frame t (leftImg8bit/<split>), predecessors t-d1,
t-d1-d2, ... with random gaps d in [1, interval] are read backwards from
leftImg8bit_sequence; labelIds become trainIds (19 classes, ignore 250); the
clip is augmented as one; the last ``path_num`` frames of [f1..f4] come back
with the label (loader:141-191). Files are read by ``data/png.py``.

``ClipBatcher`` shuffles and batches on a pool of reading threads (no torch
``DataLoader``). The dataset's generator of gaps is shared by the threads, so
with more than one worker the draws reach the clips in the order the threads
take them.
"""

from __future__ import annotations

import os
import random as _random

import numpy as np

from tdnet_tpu_torch.data.png import read_png

VOID_CLASSES = [0, 1, 2, 3, 4, 5, 6, 9, 10, 14, 15, 16, 18, 29, 30, -1]
VALID_CLASSES = [7, 8, 11, 12, 13, 17, 19, 20, 21, 22, 23, 24, 25, 26, 27,
                 28, 31, 32, 33]
CLASS_NAMES = [
    "road", "sidewalk", "building", "wall", "fence", "pole",
    "traffic_light", "traffic_sign", "vegetation", "terrain", "sky",
    "person", "rider", "car", "truck", "bus", "train", "motorcycle",
    "bicycle"]
IGNORE_INDEX = 250

_ENCODE_LUT = np.full((256,), IGNORE_INDEX, dtype=np.uint8)
for _i, _c in enumerate(VALID_CLASSES):
    _ENCODE_LUT[_c] = _i


def encode_segmap(mask: np.ndarray) -> np.ndarray:
    """labelIds -> trainIds via LUT (reference loader:209-215)."""
    return _ENCODE_LUT[mask.astype(np.uint8)]


def recursive_glob(rootdir: str, suffix: str = ".png") -> list[str]:
    return sorted(
        os.path.join(root, fn)
        for root, _, fns in os.walk(rootdir)
        for fn in fns if fn.endswith(suffix))


class CityscapesClips:
    n_classes = 19
    ignore_index = IGNORE_INDEX

    def __init__(self, root: str, split: str = "train", augmentations=None,
                 interval: int = 2, path_num: int = 2, seed: int | None = None):
        self.root = root
        self.split = split
        self.augmentations = augmentations
        self.interval = interval
        self.path_num = path_num
        self.images_base = os.path.join(root, "leftImg8bit", split)
        self.videos_base = os.path.join(root, "leftImg8bit_sequence", split)
        self.annotations_base = os.path.join(root, "gtFine", split)
        self.files = recursive_glob(self.images_base, ".png")
        if not self.files:
            raise FileNotFoundError(
                f"No files for split=[{split}] found in {self.images_base}")
        self._rng = _random.Random(seed)

    def __len__(self):
        return len(self.files)

    def _read(self, path):
        return np.asarray(read_png(path), dtype=np.uint8)

    def __getitem__(self, index: int):
        img_path = self.files[index].rstrip()
        city = img_path.split(os.sep)[-2]
        lbl_path = os.path.join(
            self.annotations_base, city,
            os.path.basename(img_path)[:-15] + "gtFine_labelIds.png")
        lbl = encode_segmap(self._read(lbl_path))

        name = os.path.basename(img_path).split("_")
        city_n, seq, cur = name[0], name[1], name[2]
        f4 = int(cur)
        ids = [f4]
        for _ in range(3):
            ids.append(ids[-1] - self._rng.randint(1, self.interval))
        f4_id, f3_id, f2_id, f1_id = ids

        def frame(idx):
            p = os.path.join(self.videos_base, city_n,
                             f"{city_n}_{seq}_{idx:06d}_leftImg8bit.png")
            return self._read(p)

        imgs = [frame(f4_id), frame(f3_id), frame(f2_id), frame(f1_id)]
        if self.augmentations is not None:
            imgs, lbl = self.augmentations(imgs, lbl)
        else:
            imgs = [im.astype(np.float32) for im in imgs]
            lbl = lbl.astype(np.int64)
        f4_img, f3_img, f2_img, f1_img = imgs
        clip = [f1_img, f2_img, f3_img, f4_img]
        return clip[-self.path_num:], lbl


def _collate(items):
    frames = np.stack([np.stack([it[0][p] for it in items]) for p in range(len(items[0][0]))])
    return frames.astype(np.float32), np.stack([it[1] for it in items]).astype(np.int32)


def share(n: int, rank: int, world: int) -> slice:
    """Rank ``rank``'s contiguous part of ``n`` items split over ``world`` ranks,
    the first ``n % world`` ranks one item more (an even split where world
    divides n)."""
    base, extra = divmod(n, world)
    start = rank * base + min(rank, extra)
    return slice(start, start + base + (rank < extra))


class ClipBatcher:
    """Shuffled, threaded batch iterator -> (frames [P,N,H,W,3] f32,
    labels [N,H,W] int32).

    With ``drop_last=False`` an epoch's last, short batch is yielded, as the
    reference's torch ``DataLoader`` yields it; the JAX package's
    ``ClipBatcher`` leaves it out, so a val split smaller than a batch gives
    it no batch at all.

    ``rank``/``world``: a data-parallel rank's batches. Every rank walks the
    same seeded epoch order and reads only its contiguous ``share`` of each
    global batch, so the ranks' batches together are the one-process batch,
    clip for clip. A batch of fewer clips than ranks (a short last batch) gives
    a rank without a clip of its own a copy of the batch's last clip with every
    label at ``IGNORE_INDEX``, which no score counts, so that no rank's batch
    is empty and no clip is counted twice."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 drop_last: bool = True, num_workers: int = 8,
                 seed: int = 0, infinite: bool = False, rank: int = 0, world: int = 1):
        if not 0 <= rank < world:
            raise ValueError(f"rank {rank} of a world of {world}")
        self.ds = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = num_workers
        self.seed = seed
        self.infinite = infinite
        self.rank, self.world = rank, world

    def _read(self, idx):
        """This rank's indices of a global batch's ``idx``, and whether they are
        a stand-in that no score may count."""
        mine = idx[share(len(idx), self.rank, self.world)]
        return (mine, False) if len(mine) else (idx[-1:], True)

    def _epoch_indices(self, epoch):
        idx = np.arange(len(self.ds))
        if self.shuffle:
            np.random.RandomState(self.seed + epoch).shuffle(idx)
        return idx

    def __iter__(self):
        from collections import deque
        from concurrent.futures import ThreadPoolExecutor
        epoch = 0
        readahead = max(2 * self.batch_size, 2 * self.num_workers)
        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            while True:
                idx = self._epoch_indices(epoch)
                n = len(idx)
                stop = n - (n % self.batch_size) if self.drop_last else n
                # (indices this rank reads, stand-in) of each global batch, in order
                batches = [self._read(idx[b:min(b + self.batch_size, stop)])
                           for b in range(0, stop, self.batch_size)]
                order = [(i, int(j)) for i, (mine, _) in enumerate(batches) for j in mine]
                pending: deque = deque()
                pos = 0
                done = []
                for i, _ in order:
                    while pos < len(order) and len(pending) < readahead:
                        pending.append(pool.submit(self.ds.__getitem__, order[pos][1]))
                        pos += 1
                    done.append(pending.popleft().result())
                    if len(done) == len(batches[i][0]):
                        frames, labels = _collate(done)
                        if batches[i][1]:
                            labels[:] = IGNORE_INDEX
                        yield frames, labels
                        done = []
                if not self.infinite:
                    return
                epoch += 1
