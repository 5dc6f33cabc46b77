"""DetBench — the standardized synthetic detection benchmark.

Copy of `detectax/data/detbench.py` (numpy only): the same specs, the same
generator and the same memmap cache layout, so every (split, index) pair
gives the JAX package's image, boxes and labels bit for bit. It is harder
than `detectax_torch.data.synthetic` (the smoke dataset):

* **8 classes discriminated by shape, not color** (color is random per
  object): box, frame, disc, ring, triangle, cross, hbars, xdiag.
* **Crowding**: 2-10 objects per image, sizes 6%-45% of the canvas.
* **Occlusion**: objects may overlap (pairwise IoU up to 0.45); later
  objects occlude earlier ones, all remain labeled.
* **Textured background**: cached multi-octave noise, random roll +
  brightness, so "any bright blob" is not a detector.

The benchmark is *specified* by `benchmarks/detbench_v1.json` (split
seeds + sizes), and by the built-in `SPECS` where that directory is
absent (they hold the same values). Protocol: train on `split="train"`,
report mAP@0.5 (and AP@[.5:.95]) on `split="eval"` via
`detectax_torch.cli.evaluate`.

One change from the copy: the cache is filled by up to ``workers``
processes, each generating a contiguous range of indices. A sample is a
pure function of (split seed, index), so the cache holds the same bytes
whatever the number of workers.
"""
from __future__ import annotations

import json
import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor

import numpy as np

CLASS_NAMES = (
    "box", "frame", "disc", "ring", "triangle", "cross", "hbars", "xdiag"
)

V1_SPEC = {
    "version": "detbench_v1",
    "img_size": 512,
    "n_train": 4096,
    "n_eval": 256,
    "train_seed": 20260816,
    "eval_seed": 977717,
    "min_objects": 2,
    "max_objects": 10,
    "max_overlap_iou": 0.45,
}

# DetBench v2 (r2 VERDICT "next" #9): scale jitter via log-uniform size
# sampling (v1 was uniform 6-45%, biasing area toward large objects) with
# a smaller floor — small-object emphasis — and more crowding.
V2_SPEC = {
    "version": "detbench_v2",
    "img_size": 512,
    "n_train": 4096,
    "n_eval": 256,
    "train_seed": 20260817,
    "eval_seed": 331177,
    "min_objects": 4,
    "max_objects": 24,
    "max_overlap_iou": 0.50,
    "size_lo": 0.025,
    "size_hi": 0.40,
    "size_log": True,
    "place_attempts": 20,
}

# Dense-crowd split: the learning benchmark for the CrowdHuman stretch
# config (content scale + K=2048 NMS, reference
# `CenterNet/train_centernet_crowdhuman.py:52-62`) — up to 128 small
# GTs per image at high mutual overlap.
V2_CROWD_SPEC = {
    "version": "detbench_v2crowd",
    "img_size": 640,
    "n_train": 2048,
    "n_eval": 128,
    "train_seed": 20260818,
    "eval_seed": 550044,
    "min_objects": 48,
    "max_objects": 128,
    "max_overlap_iou": 0.55,
    "size_lo": 0.02,
    "size_hi": 0.12,
    "size_log": True,
    "place_attempts": 24,
}

SPECS = {
    "detbench": V1_SPEC,
    "detbench_v2": V2_SPEC,
    "detbench_v2_crowd": V2_CROWD_SPEC,
}

_NOISE_CACHE: dict = {}


def _background(img_size: int, rng: np.random.Generator) -> np.ndarray:
    """Multi-octave noise background, cached base + per-image roll/gain."""
    key = img_size
    if key not in _NOISE_CACHE:
        r = np.random.default_rng(4242)
        acc = np.zeros((img_size, img_size), np.float32)
        for octave in (8, 32, 128):
            coarse = r.uniform(0, 1, size=(octave, octave)).astype(np.float32)
            reps = img_size // octave
            acc += np.kron(coarse, np.ones((reps, reps), np.float32))
        acc = acc / acc.max()
        _NOISE_CACHE[key] = (acc * 255).astype(np.uint8)
    base = _NOISE_CACHE[key]
    ry, rx = int(rng.integers(img_size)), int(rng.integers(img_size))
    rolled = np.roll(base, (ry, rx), axis=(0, 1)).astype(np.float32)
    gain = rng.uniform(0.10, 0.28)  # keep background dark-ish
    img = np.empty((img_size, img_size, 3), np.float32)
    for c in range(3):
        img[..., c] = rolled * gain * rng.uniform(0.6, 1.0)
    return img


def _shape_mask(cls: int, hp: int, wp: int, rng: np.random.Generator):
    """Binary mask [hp, wp] for class `cls` filling its bounding box."""
    yy = np.linspace(-1.0, 1.0, hp, dtype=np.float32)[:, None]
    xx = np.linspace(-1.0, 1.0, wp, dtype=np.float32)[None, :]

    def full(m):  # single-axis masks (e.g. hbars) broadcast to (hp, wp)
        return np.broadcast_to(m, (hp, wp))

    if cls == 0:  # box
        return np.ones((hp, wp), bool)
    if cls == 1:  # frame
        t = rng.uniform(0.18, 0.32)
        return (np.abs(yy) > 1 - t) | (np.abs(xx) > 1 - t)
    if cls == 2:  # disc
        return (yy ** 2 + xx ** 2) <= 1.0
    if cls == 3:  # ring
        r2 = yy ** 2 + xx ** 2
        inner = rng.uniform(0.45, 0.65)
        return (r2 <= 1.0) & (r2 >= inner ** 2)
    if cls == 4:  # triangle (apex up)
        # inside when below the two slanted edges and above the base
        return (np.abs(xx) * 1.0 <= (yy + 1.0) / 2.0 + 1e-6)
    if cls == 5:  # cross / plus
        t = rng.uniform(0.25, 0.40)
        return (np.abs(yy) < t) | (np.abs(xx) < t)
    if cls == 6:  # horizontal bars
        period = rng.uniform(0.45, 0.7)
        return full(((yy / period) % 2.0) < 1.0)
    # 7: x-diagonal stripes
    t = rng.uniform(0.2, 0.35)
    return (np.abs(yy - xx) < t) | (np.abs(yy + xx) < t)


def _iou_xyxy(a, b) -> float:
    ih = max(0.0, min(a[3], b[3]) - max(a[1], b[1]))
    iw = max(0.0, min(a[2], b[2]) - max(a[0], b[0]))
    inter = ih * iw
    ar = (a[2] - a[0]) * (a[3] - a[1])
    br = (b[2] - b[0]) * (b[3] - b[1])
    return inter / max(ar + br - inter, 1e-9)


def make_sample(
    rng: np.random.Generator,
    img_size: int,
    *,
    min_objects: int = 2,
    max_objects: int = 10,
    max_overlap_iou: float = 0.45,
    size_lo: float = 0.06,
    size_hi: float = 0.45,
    size_log: bool = False,
    place_attempts: int = 12,
):
    img = _background(img_size, rng)
    n = int(rng.integers(min_objects, max_objects + 1))
    boxes: list = []
    labels: list = []
    for _ in range(n):
        for _attempt in range(place_attempts):
            cls = int(rng.integers(len(CLASS_NAMES)))
            if size_log:
                # log-uniform: small-object emphasis (DetBench v2)
                s = float(np.exp(rng.uniform(
                    np.log(size_lo), np.log(size_hi)
                )))
            else:
                s = float(rng.uniform(size_lo, size_hi))
            aspect = float(rng.uniform(0.7, 1.4))
            h = min(s * aspect, 0.9)
            w = min(s / aspect, 0.9)
            cy = rng.uniform(h / 2, 1 - h / 2)
            cx = rng.uniform(w / 2, 1 - w / 2)
            cand = [cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2]
            if all(_iou_xyxy(cand, b) <= max_overlap_iou for b in boxes):
                break
        else:
            continue
        y1p, y2p = int(cand[1] * img_size), int(cand[3] * img_size)
        x1p, x2p = int(cand[0] * img_size), int(cand[2] * img_size)
        hp, wp = max(y2p - y1p, 2), max(x2p - x1p, 2)
        mask = _shape_mask(cls, hp, wp, rng)
        color = rng.uniform(110, 255, size=(3,)).astype(np.float32)
        color *= rng.uniform(0.35, 1.0, size=(3,)) ** 0.5  # hue variety
        color = np.clip(color, 60, 255)
        region = img[y1p:y1p + hp, x1p:x1p + wp]
        region[mask] = color
        boxes.append(cand)
        labels.append(cls)
    return (
        np.clip(img, 0, 255).astype(np.uint8),
        np.asarray(boxes, np.float32).reshape(-1, 4),
        np.asarray(labels, np.int32),
    )


def load_spec(path: str | None = None, name: str = "detbench") -> dict:
    """Resolve a benchmark spec: explicit ``path`` wins; otherwise the
    committed ``benchmarks/<file>.json`` for ``name`` (a `SPECS` key),
    falling back to the built-in dict."""
    files = {
        "detbench": "detbench_v1.json",
        "detbench_v2": "detbench_v2.json",
        "detbench_v2_crowd": "detbench_v2_crowd.json",
    }
    if path is None:
        path = os.path.join(
            os.path.dirname(__file__), "..", "..", "benchmarks",
            files[name],
        )
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    return dict(SPECS[name])


def _generate(spec: dict, seed: int, idx: int) -> dict:
    """Sample ``idx`` of the split seeded ``seed``: a pure function of
    them and the spec."""
    rng = np.random.default_rng((seed, int(idx)))
    img, boxes, labels = make_sample(
        rng, spec["img_size"],
        min_objects=spec["min_objects"],
        max_objects=spec["max_objects"],
        max_overlap_iou=spec["max_overlap_iou"],
        size_lo=spec.get("size_lo", 0.06),
        size_hi=spec.get("size_hi", 0.45),
        size_log=spec.get("size_log", False),
        place_attempts=spec.get("place_attempts", 12),
    )
    return {"image": img, "boxes_xyxy": boxes, "labels": labels}


def _fill(images_path: str, spec: dict, seed: int, lo: int, hi: int):
    """Generate samples [lo, hi) into the images memmap; return their
    boxes, labels and object counts for the caller to store."""
    max_obj = int(spec["max_objects"])
    imgs = np.load(images_path, mmap_mode="r+")
    boxes = np.zeros((hi - lo, max_obj, 4), np.float32)
    labels = np.zeros((hi - lo, max_obj), np.int32)
    counts = np.zeros((hi - lo,), np.int32)
    for i in range(lo, hi):
        s = _generate(spec, seed, i)
        imgs[i] = s["image"]
        k = min(len(s["labels"]), max_obj)
        boxes[i - lo, :k] = s["boxes_xyxy"][:k]
        labels[i - lo, :k] = s["labels"][:k]
        counts[i - lo] = k
    imgs.flush()
    return lo, boxes, labels, counts


class DetBenchDataset:
    """Map-style dataset over a DetBench split — deterministic from the
    committed spec: sample i of a split is a pure function of
    (split_seed, i).

    With ``cache=True`` (default) the split is materialized ONCE to a
    uint8 memmap under ``$DETECTAX_DETBENCH_CACHE`` (or
    ~/.cache/detbench); subsequent epochs read from the page cache
    instead of re-running the numpy generator per sample (~25 img/s a
    core). ``workers`` processes fill it (default: one per 64 samples, at
    most 8 and at most the host's cores)."""

    def __init__(self, split: str = "train", spec: dict | None = None,
                 n: int | None = None, cache: bool = True,
                 workers: int | None = None):
        self.spec = spec or load_spec()
        if split not in ("train", "eval"):
            raise ValueError(f"unknown split {split!r}")
        self.split = split
        self.seed = self.spec[f"{split}_seed"]
        self.n = n or self.spec[f"n_{split}"]
        self.img_size = self.spec["img_size"]
        self.id_to_label = {i: c for i, c in enumerate(CLASS_NAMES)}
        if workers is None:
            workers = min(8, os.cpu_count() or 1, -(-self.n // 64))
        self.workers = max(1, int(workers))
        self._mm = self._materialize() if cache else None

    def _cache_paths(self):
        root = os.environ.get(
            "DETECTAX_DETBENCH_CACHE",
            os.path.expanduser("~/.cache/detbench"),
        )
        key = (f"{self.spec['version']}_{self.split}_{self.seed}"
               f"_{self.n}x{self.img_size}")
        base = os.path.join(root, key)
        return {
            "dir": root,
            "images": base + "_images.npy",
            "boxes": base + "_boxes.npy",
            "labels": base + "_labels.npy",
            "counts": base + "_counts.npy",
            "done": base + ".done",
        }

    def _materialize(self):
        p = self._cache_paths()
        max_obj = int(self.spec["max_objects"])
        if not os.path.exists(p["done"]):
            os.makedirs(p["dir"], exist_ok=True)
            imgs = np.lib.format.open_memmap(
                p["images"], mode="w+", dtype=np.uint8,
                shape=(self.n, self.img_size, self.img_size, 3),
            )
            del imgs  # the workers write through their own maps
            boxes = np.zeros((self.n, max_obj, 4), np.float32)
            labels = np.zeros((self.n, max_obj), np.int32)
            counts = np.zeros((self.n,), np.int32)
            step = -(-self.n // self.workers)
            jobs = [(p["images"], self.spec, self.seed, lo,
                     min(lo + step, self.n))
                    for lo in range(0, self.n, step)]
            if len(jobs) == 1:
                parts = [_fill(*jobs[0])]
            else:
                # forked workers run numpy alone; a worker that dies
                # raises here instead of being replaced
                ctx = multiprocessing.get_context("fork")
                with ProcessPoolExecutor(len(jobs), mp_context=ctx) as pool:
                    parts = list(pool.map(_fill, *zip(*jobs)))
            for lo, b, lab, c in parts:
                boxes[lo:lo + len(c)] = b
                labels[lo:lo + len(c)] = lab
                counts[lo:lo + len(c)] = c
            np.save(p["boxes"], boxes)
            np.save(p["labels"], labels)
            np.save(p["counts"], counts)
            with open(p["done"], "w") as f:
                f.write("ok")
        return {
            "images": np.load(p["images"], mmap_mode="r"),
            "boxes": np.load(p["boxes"]),
            "labels": np.load(p["labels"]),
            "counts": np.load(p["counts"]),
        }

    @property
    def num_classes(self) -> int:
        return len(CLASS_NAMES)

    def __len__(self):
        return self.n

    def _generate(self, idx: int):
        return _generate(self.spec, self.seed, idx)

    def __getitem__(self, idx: int):
        if self._mm is None:
            return self._generate(idx)
        k = int(self._mm["counts"][idx])
        return {
            "image": np.asarray(self._mm["images"][idx]),
            "boxes_xyxy": self._mm["boxes"][idx, :k].copy(),
            "labels": self._mm["labels"][idx, :k].copy(),
        }
