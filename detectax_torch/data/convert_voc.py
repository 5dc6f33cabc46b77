"""Pascal VOC XML -> detectax index.

Capability parity with the reference's two-stage VOC ETL
(`FCOS/process_VOC_annotations.py` + `format_VOC_annotations.py`), as one
pass over the XML annotations using the stdlib parser. Fixes (documented):
the reference scraper reads only the *first* object per file
(`process_VOC_annotations.py:17` uses find, not find_all); we read all
objects. Output boxes are normalized corner (x1,y1,x2,y2) like the
reference pkl (`format_VOC_annotations.py:56-67`).

Copy of `detectax/data/convert_voc.py`: the same index JSON, byte for byte.
"""
from __future__ import annotations

import argparse
import os
import xml.etree.ElementTree as ET

from detectax_torch.data.index import DEFAULT_SIZES, save_index

VOC_CLASSES = (
    "aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car", "cat",
    "chair", "cow", "diningtable", "dog", "horse", "motorbike", "person",
    "pottedplant", "sheep", "sofa", "train", "tvmonitor",
)


def parse_voc_xml(xml_path: str):
    root = ET.parse(xml_path).getroot()
    filename = root.findtext("filename")
    size = root.find("size")
    width = float(size.findtext("width"))
    height = float(size.findtext("height"))
    objects = []
    for obj in root.findall("object"):
        name = obj.findtext("name")
        box = obj.find("bndbox")
        x1 = float(box.findtext("xmin")) / width
        y1 = float(box.findtext("ymin")) / height
        x2 = float(box.findtext("xmax")) / width
        y2 = float(box.findtext("ymax")) / height
        objects.append((name, [x1, y1, x2, y2]))
    return filename, (width, height), objects


def convert(
    annotations_dir: str,
    images_dir: str,
    output: str,
    classes=VOC_CLASSES,
    **size_overrides,
):
    sizes = dict(DEFAULT_SIZES)
    sizes.update(size_overrides)
    class_to_id = {c: i for i, c in enumerate(classes)}
    samples = []
    skipped = 0
    for fn in sorted(os.listdir(annotations_dir)):
        if not fn.endswith(".xml"):
            continue
        filename, _, objects = parse_voc_xml(
            os.path.join(annotations_dir, fn)
        )
        boxes, labels = [], []
        for name, box in objects:
            if name not in class_to_id:
                skipped += 1
                continue
            boxes.append(box)
            labels.append(class_to_id[name])
        if not boxes:
            continue
        samples.append({
            "image_path": os.path.join(images_dir, filename),
            "boxes_xyxy": boxes,
            "labels": labels,
            **sizes,
        })
    save_index(output, classes, samples)
    return len(samples), skipped


def main(argv=None):
    p = argparse.ArgumentParser(description="Convert Pascal VOC to index")
    p.add_argument("--annotations_dir", required=True)
    p.add_argument("--images_dir", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--min_side", type=int, default=DEFAULT_SIZES["min_side"])
    p.add_argument("--max_side", type=int, default=DEFAULT_SIZES["max_side"])
    p.add_argument("--l_jitter", type=int, default=DEFAULT_SIZES["l_jitter"])
    p.add_argument("--u_jitter", type=int, default=DEFAULT_SIZES["u_jitter"])
    a = p.parse_args(argv)
    n, skipped = convert(
        a.annotations_dir, a.images_dir, a.output,
        min_side=a.min_side, max_side=a.max_side,
        l_jitter=a.l_jitter, u_jitter=a.u_jitter,
    )
    print(f"wrote {n} samples to {a.output} ({skipped} unknown-class boxes skipped)")


if __name__ == "__main__":
    main()
