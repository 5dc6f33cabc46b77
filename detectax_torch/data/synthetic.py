"""Synthetic detection dataset — colored rectangles on noise.

Copy of `detectax/data/synthetic.py` (numpy only): a deterministic tiny
dataset for integration tests, smoke runs and benchmarks without VOC/COCO
on disk. Samples follow the index-record schema of
`detectax_torch.data.index`, so the full pipeline runs unchanged, and the
same seed gives the same samples as the JAX package's copy.
"""
from __future__ import annotations

import numpy as np

CLASS_NAMES = ("square", "wide", "tall")


_NOISE_CACHE: dict = {}


def _base_noise(img_size: int, seed: int) -> np.ndarray:
    """Cached background noise — generating fresh noise per sample made the
    synthetic set slower than real JPEG decode and skewed benchmarks."""
    key = (img_size, seed)
    if key not in _NOISE_CACHE:
        r = np.random.default_rng(seed)
        _NOISE_CACHE[key] = r.integers(
            0, 40, size=(img_size, img_size, 3), dtype=np.uint8
        )
    return _NOISE_CACHE[key]


def make_sample(rng: np.random.Generator, img_size: int = 256, max_objects: int = 5):
    """One image [H,W,3] uint8 + normalized corner boxes (x1,y1,x2,y2) + labels."""
    roll = int(rng.integers(0, img_size))
    img = np.roll(_base_noise(img_size, 1234), roll, axis=(0, 1)).copy()
    n = int(rng.integers(1, max_objects + 1))
    boxes, labels = [], []
    for _ in range(n):
        cls = int(rng.integers(0, len(CLASS_NAMES)))
        if cls == 0:
            w = h = rng.uniform(0.1, 0.4)
        elif cls == 1:
            w, h = rng.uniform(0.25, 0.5), rng.uniform(0.08, 0.2)
        else:
            w, h = rng.uniform(0.08, 0.2), rng.uniform(0.25, 0.5)
        cx = rng.uniform(w / 2, 1 - w / 2)
        cy = rng.uniform(h / 2, 1 - h / 2)
        x1, y1 = cx - w / 2, cy - h / 2
        x2, y2 = cx + w / 2, cy + h / 2
        px = [int(v * img_size) for v in (x1, y1, x2, y2)]
        color = np.zeros(3, np.uint8)
        color[cls] = 200 + int(rng.integers(0, 56))
        img[px[1]:px[3], px[0]:px[2]] = color
        boxes.append([x1, y1, x2, y2])
        labels.append(cls)
    return img, np.asarray(boxes, np.float32), np.asarray(labels, np.int32)


class SyntheticDataset:
    """Map-style dataset compatible with `detectax_torch.data.pipeline.Loader`."""

    def __init__(self, n: int = 64, img_size: int = 256, seed: int = 0,
                 max_objects: int = 5):
        self.n = n
        self.img_size = img_size
        self.seed = seed
        self.max_objects = max_objects
        self.id_to_label = {i: c for i, c in enumerate(CLASS_NAMES)}

    @property
    def num_classes(self) -> int:
        return len(CLASS_NAMES)

    def __len__(self):
        return self.n

    def __getitem__(self, idx: int):
        rng = np.random.default_rng(self.seed * 100003 + idx)
        img, boxes, labels = make_sample(
            rng, self.img_size, self.max_objects
        )
        return {
            "image": img,  # uint8; pipeline preserves dtype
            "boxes_xyxy": boxes,  # normalized corners (x1,y1,x2,y2)
            "labels": labels,
        }
