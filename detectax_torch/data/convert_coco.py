"""COCO instances JSON -> detectax index.

Capability parity with the reference's COCO ETL
(`process_COCO_annotations_fcos.py`: flatten instances json;
`format_COCO_annotations_fcos.py`: per-image samples). Notes:

* Category ids are remapped to contiguous [0, C) like the reference's
  label map build.
* ``--prepend_objectness`` reproduces the reference's quirk of inserting
  an "objectness" class at index 0, shifting all real labels by +1
  (`format_COCO_annotations_fcos.py:24`) — the RetinaNet COCO config
  trains with that layout.

Copy of `detectax/data/convert_coco.py`: the same index JSON, byte for byte.
"""
from __future__ import annotations

import argparse
import json
import os

from detectax_torch.data.index import save_index


def convert(
    instances_json: str,
    images_dir: str,
    output: str,
    prepend_objectness: bool = False,
    min_side: int = 512,
    max_side: int = 512,
    l_jitter: int = 320,
    u_jitter: int = 512,
):
    with open(instances_json) as f:
        coco = json.load(f)
    cats = sorted(coco["categories"], key=lambda c: c["id"])
    classes = [c["name"] for c in cats]
    cat_to_id = {c["id"]: i for i, c in enumerate(cats)}
    offset = 0
    if prepend_objectness:
        classes = ["objectness"] + classes
        offset = 1

    images = {im["id"]: im for im in coco["images"]}
    per_image: dict[int, dict] = {}
    n_boxes = 0
    for ann in coco["annotations"]:
        if ann.get("iscrowd", 0):
            continue
        im = images.get(ann["image_id"])
        if im is None:
            continue
        w, h = float(im["width"]), float(im["height"])
        x, y, bw, bh = ann["bbox"]  # pixel x,y,w,h (top-left corner)
        if bw <= 0 or bh <= 0:
            continue
        box = [x / w, y / h, (x + bw) / w, (y + bh) / h]
        rec = per_image.setdefault(
            ann["image_id"],
            {
                "image_path": os.path.join(images_dir, im["file_name"]),
                "boxes_xyxy": [],
                "labels": [],
                "min_side": min_side,
                "max_side": max_side,
                "l_jitter": l_jitter,
                "u_jitter": u_jitter,
            },
        )
        rec["boxes_xyxy"].append(box)
        rec["labels"].append(cat_to_id[ann["category_id"]] + offset)
        n_boxes += 1

    samples = list(per_image.values())
    save_index(output, classes, samples)
    return len(samples), n_boxes


def main(argv=None):
    p = argparse.ArgumentParser(description="Convert COCO instances to index")
    p.add_argument("--instances_json", required=True)
    p.add_argument("--images_dir", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--prepend_objectness", action="store_true")
    p.add_argument("--min_side", type=int, default=512)
    p.add_argument("--max_side", type=int, default=512)
    p.add_argument("--l_jitter", type=int, default=320)
    p.add_argument("--u_jitter", type=int, default=512)
    a = p.parse_args(argv)
    n, nb = convert(
        a.instances_json, a.images_dir, a.output,
        prepend_objectness=a.prepend_objectness,
        min_side=a.min_side, max_side=a.max_side,
        l_jitter=a.l_jitter, u_jitter=a.u_jitter,
    )
    print(f"wrote {n} samples / {nb} boxes to {a.output}")


if __name__ == "__main__":
    main()
