"""Host-side image preparation for serving: decode → resize/pad onto the
canvas → normalize.

The part of `detectax/data/pipeline.py` that serving needs, as a copy (the
port imports nothing of the JAX package): both resize paths — the
aspect-preserving resize-and-pad and the fixed square stretch — and the
three pixel normalizations (`tf`: /127.5-1, `unit`: /255, `none`). The
training-side loader, augmentation and GT padding wait for the training
path. PIL is imported where a file is decoded or an image resized, so the
module imports on a machine without it.
"""
from __future__ import annotations

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
