"""Host input pipeline: decode → augment → resize/pad-to-canvas → batch.

Copy of `detectax/data/pipeline.py` (numpy and PIL only; the port imports
nothing of the JAX package): both resize paths — the aspect-preserving
resize-and-pad and the fixed square stretch — the three pixel
normalizations (`tf`: /127.5-1, `unit`: /255, `none`), random horizontal
flip and the joint photometric / geometric augmentation with their box
remaps, GT padding to ``max_boxes`` with a validity mask, and the batched,
host-sharded, prefetching `Loader`. Boxes come out canvas-normalized
``(y_cen, x_cen, h, w)``, so on-device assignment runs with
``img_dim == img_pad == canvas``. The same seed gives the same batches as
the JAX package's loader, on its PIL path and on its native path: JPEG
records decoded and resized by `data.native_loader` (libjpeg + OpenMP,
built at first use), straight to the content size. ``native=None`` takes
the native path whenever the library loads (it is built at the first
JPEG record, not when the loader is made), ``native=False`` never, and
``native=True`` raises, with the build's reason, where the library does
not load. A record the library fails to decode (CMYK, a corrupt file)
falls back to PIL with a printed line, as in the JAX package. PIL is
imported where a file is decoded or an image resized, so the module
imports on a machine without it.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np


def _pil_image():
    try:
        from PIL import Image
    except ImportError as e:
        raise RuntimeError(
            "PIL is required to decode image files and to resize images"
        ) from e
    return Image


def decode_image(record: dict) -> np.ndarray:
    """Return an HWC image (uint8 or float32, 0..255) from an index record.

    dtype is preserved so the uint8 fast path avoids float round trips."""
    if "image" in record and record["image"] is not None:
        return np.asarray(record["image"])
    path = record["image_path"]
    Image = _pil_image()
    with Image.open(path) as im:
        im = im.convert("RGB")
        return np.asarray(im)


def _resize(img: np.ndarray, out_hw: tuple[int, int]) -> np.ndarray:
    Image = _pil_image()
    pil = Image.fromarray(np.clip(img, 0, 255).astype(np.uint8))
    pil = pil.resize((out_hw[1], out_hw[0]), Image.BILINEAR)
    return np.asarray(pil, dtype=np.float32)


def flip_horizontal(img: np.ndarray, boxes_xyxy: np.ndarray):
    """Mirror the image and remap normalized corner boxes."""
    img = img[:, ::-1, :]
    if len(boxes_xyxy):
        boxes_xyxy = np.stack(
            [
                1.0 - boxes_xyxy[:, 2],
                boxes_xyxy[:, 1],
                1.0 - boxes_xyxy[:, 0],
                boxes_xyxy[:, 3],
            ],
            axis=-1,
        )
    return img, boxes_xyxy


def augment_photometric_geometric(
    img: np.ndarray,
    boxes_xyxy: np.ndarray,
    rng: np.random.Generator,
    p_augment: float = 0.5,
    brightness: float = 0.25,
    contrast: tuple[float, float] = (0.75, 1.25),
):
    """Joint image+box augmentation.

    With probability `p_augment`, apply ONE of
    (a) photometric — random brightness delta or contrast rescale,
    (b) horizontal flip, (c) 90/270-degree rotation — with the box remap
    done on normalized corners (the reference rotated its pre-rendered
    label maps instead; ours are assigned after augmentation).
    Pixel values are 0..255 floats here; brightness delta is scaled
    accordingly (the reference's images were 0..1 at this point).
    """
    if rng.uniform() >= p_augment:
        return img, boxes_xyxy
    choice = rng.uniform()
    if choice <= 1.0 / 3.0:
        if rng.uniform() <= 0.5:
            delta = rng.uniform(-brightness, brightness) * 255.0
            img = np.clip(img + delta, 0.0, 255.0)
        else:
            c = rng.uniform(contrast[0], contrast[1])
            mean = img.mean(axis=(0, 1), keepdims=True)
            img = np.clip((img - mean) * c + mean, 0.0, 255.0)
        return img, boxes_xyxy
    if choice <= 2.0 / 3.0:
        return flip_horizontal(img, boxes_xyxy)
    # transpose = rot90 with x/y swap; optional up-down flip = rot270
    img = np.ascontiguousarray(np.transpose(img, (1, 0, 2)))
    if len(boxes_xyxy):
        boxes_xyxy = boxes_xyxy[:, [1, 0, 3, 2]]
    if rng.uniform() >= 0.5:
        img = img[::-1, :, :]
        if len(boxes_xyxy):
            boxes_xyxy = np.stack(
                [
                    boxes_xyxy[:, 0],
                    1.0 - boxes_xyxy[:, 3],
                    boxes_xyxy[:, 2],
                    1.0 - boxes_xyxy[:, 1],
                ],
                axis=-1,
            )
    return img, boxes_xyxy


def normalize_pixels(img: np.ndarray, mode: str) -> np.ndarray:
    if mode == "tf":
        return img / 127.5 - 1.0
    if mode == "unit":
        return img / 255.0
    if mode == "none":
        return img
    raise ValueError(f"unknown normalize mode {mode!r}")


def content_target_size(
    h: int,
    w: int,
    canvas: tuple[int, int],
    *,
    mode: str = "resize_pad",
    jitter: tuple[float, float] | None = None,
    rng: np.random.Generator | None = None,
) -> tuple[int, int]:
    """Resized content (h, w) for an image of (h, w) on the given canvas —
    the geometry half of `place_on_canvas`."""
    ch, cw = canvas
    if mode == "stretch":
        if jitter is not None and rng is not None:
            # jittered square content, stretched (non-aspect-preserving) and
            # later padded to the canvas — the reference CrowdHuman
            # per-step random content scale
            # (`train_centernet_crowdhuman.py:53-62`: raw_dims =
            # rnd_scale * base_dims, parsed square, center-padded).
            side = int(round(float(rng.uniform(jitter[0], jitter[1]))))
            side = max(1, min(side, min(ch, cw)))
            return side, side
        return ch, cw
    min_side = float(min(ch, cw))
    if jitter is not None and rng is not None:
        min_side = float(rng.uniform(jitter[0], jitter[1]))
    ratio = min_side / min(h, w)
    if ratio * max(h, w) > max(ch, cw):
        ratio = max(ch, cw) / max(h, w)
    return (
        min(int(round(h * ratio)), ch),
        min(int(round(w * ratio)), cw),
    )


def place_content_on_canvas(
    content: np.ndarray,
    boxes_xyxy: np.ndarray,
    canvas: tuple[int, int],
    pad_position: str = "topleft",
):
    """Place an already-resized content image on the canvas and convert
    normalized corner boxes to canvas-normalized (y, x, h, w)."""
    ch, cw = canvas
    new_h, new_w = content.shape[:2]
    dtype = content.dtype if content.dtype == np.uint8 else np.float32
    if (new_h, new_w) == (ch, cw):
        out = content.astype(dtype, copy=False)
        off_y = off_x = 0
    else:
        out = np.zeros((ch, cw, content.shape[2]), dtype=dtype)
        if pad_position == "center":
            off_y = (ch - new_h) // 2
            off_x = (cw - new_w) // 2
        else:
            off_y = off_x = 0
        out[off_y:off_y + new_h, off_x:off_x + new_w] = content
    if len(boxes_xyxy):
        x1 = boxes_xyxy[:, 0] * new_w + off_x
        y1 = boxes_xyxy[:, 1] * new_h + off_y
        x2 = boxes_xyxy[:, 2] * new_w + off_x
        y2 = boxes_xyxy[:, 3] * new_h + off_y
        boxes_yxhw = np.stack(
            [
                (y1 + y2) / 2.0 / ch,
                (x1 + x2) / 2.0 / cw,
                (y2 - y1) / ch,
                (x2 - x1) / cw,
            ],
            axis=-1,
        ).astype(np.float32)
    else:
        boxes_yxhw = np.zeros((0, 4), dtype=np.float32)
    return out, boxes_yxhw, (new_h, new_w)


def place_on_canvas(
    img: np.ndarray,
    boxes_xyxy: np.ndarray,
    canvas: tuple[int, int],
    *,
    mode: str = "resize_pad",
    pad_position: str = "topleft",
    jitter: tuple[float, float] | None = None,
    rng: np.random.Generator | None = None,
):
    """Resize an image (+normalized corner boxes) onto a fixed canvas.

    mode="resize_pad": aspect-preserving, short side = canvas min (or a
      jittered value), long side capped at canvas, zero pad (reference
      resize_and_pad_image). mode="stretch": non-aspect square resize
      (reference pad_flag=False path).

    Returns (canvas_img, boxes_yxhw canvas-normalized, content_hw).
    """
    new_h, new_w = content_target_size(
        img.shape[0], img.shape[1], canvas, mode=mode, jitter=jitter, rng=rng
    )
    content = (
        img.astype(np.float32)
        if (new_h, new_w) == img.shape[:2]
        else _resize(img, (new_h, new_w))
    )
    return place_content_on_canvas(
        content, boxes_xyxy, canvas, pad_position=pad_position
    )


def pad_gt(boxes_yxhw: np.ndarray, labels: np.ndarray, max_boxes: int):
    n = min(len(boxes_yxhw), max_boxes)
    b = np.zeros((max_boxes, 4), np.float32)
    l = np.zeros((max_boxes,), np.int32)
    v = np.zeros((max_boxes,), bool)
    if n:
        b[:n] = boxes_yxhw[:n]
        l[:n] = labels[:n]
        v[:n] = True
    return b, l, v


class Loader:
    """Batched, host-sharded, prefetching loader over a map-style dataset.

    Dataset items are dicts with either ``image`` (HWC array) or
    ``image_path``, plus ``boxes_xyxy`` (normalized corners, x1y1x2y2) and
    ``labels``.
    """

    def __init__(
        self,
        dataset,
        batch_size: int,
        canvas: int | tuple[int, int] = 512,
        max_boxes: int = 64,
        *,
        mode: str = "resize_pad",
        pad_position: str = "topleft",
        jitter: tuple[float, float] | None = None,
        jitter_per_batch: bool = False,
        flip: bool = True,
        augment: str = "none",  # "none" | "hourglass" (photometric/rot90)
        normalize: str = "tf",
        shuffle: bool = True,
        seed: int = 0,
        num_hosts: int = 1,
        host_id: int = 0,
        prefetch: int = 2,
        steps: int | None = None,
        native: bool | None = None,
        emit_uint8: bool = False,
        workers: int = 4,
        drop_remainder: bool = True,
    ):
        if native:
            from detectax_torch.data import native_loader as nl

            if not nl.available():
                raise RuntimeError(
                    f"Loader(native=True): {nl.unavailable_reason()}")
        self.ds = dataset
        self.batch_size = batch_size
        # canvas: int -> fixed square; tuple -> fixed (h, w); list -> one
        # square bucket chosen per batch (multi-scale training, reference
        # train_hourglass_voc_v0.py:73 random train dims)
        if isinstance(canvas, int):
            self.canvas_buckets = [(canvas, canvas)]
        elif isinstance(canvas, tuple):
            self.canvas_buckets = [canvas]
        else:
            self.canvas_buckets = [
                (c, c) if isinstance(c, int) else tuple(c) for c in canvas
            ]
        self.canvas = self.canvas_buckets[0]
        self.max_boxes = max_boxes
        self.mode = mode
        self.pad_position = pad_position
        # jitter is in PIXEL units in both modes: the content's short side
        # (resize_pad) or square side (stretch). Reject fractional-looking
        # values early — jitter=(0.8, 1.0) would silently yield 1-px
        # content.
        if jitter is not None:
            lo, hi = float(jitter[0]), float(jitter[1])
            if lo > hi:
                raise ValueError(f"jitter range is reversed: {jitter!r}")
            if lo < 2.0:
                raise ValueError(
                    f"jitter={jitter!r} looks like fractional scale "
                    "factors; jitter takes absolute pixel side lengths "
                    "(e.g. (307, 512) for 0.6-1.0x of a 512 canvas)"
                )
        self.jitter = jitter
        # one shared jitter draw per batch (reference CrowdHuman "use only
        # one image resolution to train", train_centernet_crowdhuman.py:52)
        # vs. independent per-example draws
        self.jitter_per_batch = jitter_per_batch
        self.flip = flip
        self.augment = augment
        self.normalize = normalize
        self.shuffle = shuffle
        self.seed = seed
        self.num_hosts = num_hosts
        self.host_id = host_id
        self.prefetch = prefetch
        self.steps = steps
        # None: decided at the first JPEG record (on when the library loads)
        self.native = native
        self.emit_uint8 = emit_uint8
        self.workers = workers
        # drop_remainder=False pads the final partial batch (repeating its
        # last example) and marks padding via the "example_valid" mask so
        # single-pass eval covers every image (no silent mAP truncation).
        self.drop_remainder = drop_remainder

    def _indices(self, rng: np.random.Generator) -> np.ndarray:
        idx = np.arange(len(self.ds))
        if self.shuffle:
            rng.shuffle(idx)
        return idx[self.host_id:: self.num_hosts]

    def _use_native(self, record: dict) -> bool:
        if self.native is False or "image_path" not in record:
            return False
        if record.get("image") is not None:
            return False
        path = record["image_path"].lower()
        if not (path.endswith(".jpg") or path.endswith(".jpeg")):
            return False
        if self.native is None:
            from detectax_torch.data import native_loader as nl

            self.native = nl.available()
        return self.native

    def _make_example(self, record: dict, rng: np.random.Generator,
                      canvas=None, jitter=None):
        canvas = canvas or self.canvas
        jitter = jitter if jitter is not None else self.jitter
        boxes = np.asarray(record["boxes_xyxy"], np.float32)
        labels = np.asarray(record["labels"], np.int32)
        do_flip = self.flip and rng.uniform() <= 0.5
        if self.augment == "hourglass":
            do_flip = False  # flip is one arm of the joint augment

        native_ok = False
        if self._use_native(record):
            # native path: header-only size read, then decode straight to
            # the target content size (skips the full-resolution decode).
            # Failures (CMYK JPEGs libjpeg won't convert, corrupt files)
            # fall back to the PIL path instead of killing the run.
            from detectax_torch.data import native_loader as nl

            try:
                h, w = nl.image_info(record["image_path"])
                new_hw = content_target_size(
                    h, w, canvas, mode=self.mode,
                    jitter=jitter, rng=rng,
                )
                content = nl.decode_resize(record["image_path"], *new_hw)
                native_ok = True
            except Exception as e:
                print(
                    f"native decode failed for {record['image_path']!r} "
                    f"({e}); falling back to PIL"
                )
        if native_ok:
            if self.augment == "hourglass":
                content, boxes = augment_photometric_geometric(
                    content, boxes, rng
                )
            if do_flip:
                content, boxes = flip_horizontal(content, boxes)
            img, boxes_yxhw, _ = place_content_on_canvas(
                content, boxes, canvas, pad_position=self.pad_position
            )
        else:
            img = decode_image(record)
            if self.augment == "hourglass":
                img, boxes = augment_photometric_geometric(img, boxes, rng)
            if do_flip:
                img, boxes = flip_horizontal(img, boxes)
            img, boxes_yxhw, _ = place_on_canvas(
                img, boxes, canvas,
                mode=self.mode, pad_position=self.pad_position,
                jitter=jitter, rng=rng,
            )
        if self.emit_uint8:
            # ship uint8 to the device (4x less host->device traffic);
            # normalization happens inside the train step
            if img.dtype != np.uint8:
                img = np.clip(img, 0, 255).astype(np.uint8)
        else:
            img = normalize_pixels(img.astype(np.float32), self.normalize)
        b, l, v = pad_gt(boxes_yxhw, labels, self.max_boxes)
        return img, b, l, v

    def _batches(self) -> Iterator[dict]:
        from concurrent.futures import ThreadPoolExecutor

        pool = (
            ThreadPoolExecutor(max_workers=self.workers)
            if self.workers > 0 else None
        )
        step = 0
        epoch = 0
        while True:
            idx = self._indices(np.random.default_rng((self.seed, epoch)))
            starts = list(range(0, len(idx) - self.batch_size + 1,
                                self.batch_size))
            tail = len(starts) * self.batch_size
            has_tail = (not self.drop_remainder) and tail < len(idx)
            if has_tail:
                starts.append(tail)
            for s in starts:
                chunk = idx[s:s + self.batch_size]
                n_real = len(chunk)
                if n_real < self.batch_size:  # padded final batch
                    chunk = np.concatenate(
                        [chunk,
                         np.repeat(chunk[-1:], self.batch_size - n_real)]
                    )
                imgs, bs, ls, vs = [], [], [], []
                ex_rng = np.random.default_rng(
                    (self.seed, step, self.host_id)
                )
                # multi-scale: one canvas bucket per batch (all hosts pick
                # the same bucket for a given step via the shared seed)
                bucket_rng = np.random.default_rng((self.seed, step, 7))
                canvas = self.canvas_buckets[
                    int(bucket_rng.integers(len(self.canvas_buckets)))
                ]
                # per-batch shared jitter: one content-scale draw for the
                # whole batch (all hosts agree via the shared seed)
                jitter = self.jitter
                if self.jitter is not None and self.jitter_per_batch:
                    side = float(bucket_rng.uniform(*self.jitter))
                    jitter = (side, side)
                # per-example RNG streams keep parallel builds
                # deterministic regardless of completion order
                rngs = [
                    np.random.default_rng((self.seed, step, self.host_id, j))
                    for j in range(len(chunk))
                ]
                del ex_rng

                def build(args):
                    j, i = args
                    return self._make_example(
                        self.ds[int(i)], rngs[j], canvas=canvas,
                        jitter=jitter,
                    )

                if pool is not None:
                    results = list(pool.map(build, enumerate(chunk)))
                else:
                    results = [build(a) for a in enumerate(chunk)]
                for img, b, l, v in results:
                    imgs.append(img)
                    bs.append(b)
                    ls.append(l)
                    vs.append(v)
                batch = {
                    "images": np.stack(imgs),
                    "boxes": np.stack(bs),
                    "labels": np.stack(ls),
                    "valid": np.stack(vs),
                }
                if not self.drop_remainder:
                    ev = np.zeros((self.batch_size,), bool)
                    ev[:n_real] = True
                    batch["example_valid"] = ev
                yield batch
                step += 1
                if self.steps is not None and step >= self.steps:
                    return
            epoch += 1
            if self.steps is None:
                return  # single pass when no step budget is given

    def __iter__(self):
        if self.prefetch <= 0:
            yield from self._batches()
            return
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        sentinel = object()

        def worker():
            try:
                for b in self._batches():
                    q.put(b)
            finally:
                q.put(sentinel)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is sentinel:
                break
            yield item
