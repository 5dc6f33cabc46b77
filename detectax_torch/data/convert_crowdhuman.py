"""CrowdHuman .odgt -> detectax index.

The reference trains CrowdHuman through the same pkl sample format with a
single "person" class (`train_centernet_crowdhuman.py:205`). CrowdHuman
ships one JSON object per line ("odgt") with full-body boxes in `gtboxes[]
.fbox = [x, y, w, h]` pixels; entries tagged "mask" or flagged ignore are
skipped.

Copy of `detectax/data/convert_crowdhuman.py`; PIL, which reads each
image's size from its header, is imported inside `convert`.
"""
from __future__ import annotations

import argparse
import json
import os

from detectax_torch.data.index import save_index


def convert(
    odgt_path: str,
    images_dir: str,
    output: str,
    min_side: int = 512,
    max_side: int = 512,
    l_jitter: int = 320,
    u_jitter: int = 512,
    image_ext: str = ".jpg",
):
    try:
        from PIL import Image
    except ImportError:  # pragma: no cover
        Image = None
    samples = []
    n_boxes = 0
    with open(odgt_path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            image_path = os.path.join(images_dir, rec["ID"] + image_ext)
            # odgt has no image dims; read them from the file header
            if Image is None or not os.path.exists(image_path):
                continue
            with Image.open(image_path) as im:
                w, h = im.size
            boxes, labels = [], []
            for gt in rec.get("gtboxes", []):
                if gt.get("tag") != "person":
                    continue
                extra = gt.get("extra", {})
                if extra.get("ignore", 0):
                    continue
                x, y, bw, bh = gt["fbox"]
                if bw <= 0 or bh <= 0:
                    continue
                boxes.append(
                    [
                        max(0.0, x / w),
                        max(0.0, y / h),
                        min(1.0, (x + bw) / w),
                        min(1.0, (y + bh) / h),
                    ]
                )
                labels.append(0)
            if not boxes:
                continue
            samples.append({
                "image_path": image_path,
                "boxes_xyxy": boxes,
                "labels": labels,
                "min_side": min_side,
                "max_side": max_side,
                "l_jitter": l_jitter,
                "u_jitter": u_jitter,
            })
            n_boxes += len(boxes)
    save_index(output, ["person"], samples)
    return len(samples), n_boxes


def main(argv=None):
    p = argparse.ArgumentParser(description="Convert CrowdHuman odgt to index")
    p.add_argument("--odgt", required=True)
    p.add_argument("--images_dir", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--min_side", type=int, default=512)
    p.add_argument("--max_side", type=int, default=512)
    a = p.parse_args(argv)
    n, nb = convert(a.odgt, a.images_dir, a.output,
                    min_side=a.min_side, max_side=a.max_side)
    print(f"wrote {n} samples / {nb} boxes to {a.output}")


if __name__ == "__main__":
    main()
