"""Detection overlays and heatmap images (matplotlib, headless).

Copy of `detectax/infer/visualize.py`: box overlays, prediction heatmaps
and GT box renders. matplotlib is imported where a figure is drawn, so the
module imports on a machine without it.
"""
from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np


def _pyplot():
    try:
        import matplotlib
    except ImportError as e:
        raise RuntimeError("matplotlib is required to draw images") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _denormalize_image(img: np.ndarray) -> np.ndarray:
    img = np.asarray(img, dtype=np.float32)
    if img.min() < -0.01:  # "/127.5 - 1" normalized
        img = (img + 1.0) * 127.5
    elif img.max() <= 1.01:  # "/255"
        img = img * 255.0
    return np.clip(img, 0, 255).astype(np.uint8)


def visualize_detections(
    image: np.ndarray,
    boxes_yxyx: np.ndarray,
    classes: Sequence[int],
    scores: Sequence[float],
    id_to_label: Mapping[int, str] | None = None,
    out_file: str = "detect.jpg",
    show_text: bool = True,
    color: str = "red",
    figsize=(7, 7),
):
    """Draw pixel-coordinate (y1,x1,y2,x2) boxes over the image and save."""
    plt = _pyplot()
    img = _denormalize_image(image)
    fig, ax = plt.subplots(1, 1, figsize=figsize)
    ax.imshow(img)
    ax.axis("off")
    for box, cls, score in zip(boxes_yxyx, classes, scores):
        y1, x1, y2, x2 = [float(v) for v in box]
        ax.add_patch(
            plt.Rectangle(
                (x1, y1), x2 - x1, y2 - y1,
                fill=False, edgecolor=color, linewidth=1.5,
            )
        )
        if show_text:
            name = (
                id_to_label.get(int(cls), str(int(cls)))
                if id_to_label else str(int(cls))
            )
            ax.text(
                x1, y1, f"{name}: {float(score):.2f}",
                bbox={"facecolor": color, "alpha": 0.4},
                clip_box=ax.clipbox, clip_on=True, fontsize=8,
            )
    fig.savefig(out_file, bbox_inches="tight", dpi=120)
    plt.close(fig)
    return out_file


def save_heatmap(
    heatmap: np.ndarray,
    out_file: str = "heatmap.jpg",
    image: np.ndarray | None = None,
    title: str | None = None,
):
    """Save a [h, w] probability map (optionally beside the image)."""
    plt = _pyplot()
    if image is not None:
        fig, (ax0, ax1) = plt.subplots(1, 2, figsize=(12, 6))
        ax0.imshow(_denormalize_image(image))
        ax0.axis("off")
    else:
        fig, ax1 = plt.subplots(1, 1, figsize=(6, 6))
    im = ax1.imshow(np.asarray(heatmap), cmap="jet", vmin=0.0, vmax=1.0)
    ax1.axis("off")
    if title:
        ax1.set_title(title)
    fig.colorbar(im, ax=ax1, fraction=0.046)
    fig.savefig(out_file, bbox_inches="tight", dpi=120)
    plt.close(fig)
    return out_file
