"""Dataset index format: one JSON file listing samples + the class map.

Copy of `detectax/data/index.py`: per-sample image path, normalized
corner boxes, labels and the resize/jitter sizes the converters bake into
each sample (`DEFAULT_SIZES`), written by `save_index` and read by
`load_index`; `SubsetDataset`, the filtered view the RetinaNet trainer
takes of any dataset; and `IndexDataset`, the map-style view the `Loader`
reads.
"""
from __future__ import annotations

import json
import os
from typing import Sequence

DEFAULT_SIZES = {
    # reference defaults (format_VOC_annotations.py:7-11)
    "min_side": 384,
    "max_side": 384,
    "l_jitter": 240,
    "u_jitter": 384,
}


def save_index(path: str, classes: Sequence[str], samples: list[dict]):
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump({"classes": list(classes), "samples": samples}, f)


def load_index(path: str):
    with open(path) as f:
        data = json.load(f)
    return data["classes"], data["samples"]


class SubsetDataset:
    """A filtered view over any map-style dataset (keeps its class
    metadata): item ``i`` is the dataset's item ``keep_indices[i]``."""

    def __init__(self, dataset, keep_indices):
        self.ds = dataset
        self.keep = list(keep_indices)
        self.id_to_label = getattr(dataset, "id_to_label", None)

    @property
    def num_classes(self) -> int:
        return self.ds.num_classes

    def __len__(self):
        return len(self.keep)

    def __getitem__(self, idx: int):
        return self.ds[self.keep[idx]]


class IndexDataset:
    """Map-style dataset over an index JSON, for `data.pipeline.Loader`."""

    def __init__(self, index_path: str):
        self.classes, self.samples = load_index(index_path)
        self.id_to_label = {i: c for i, c in enumerate(self.classes)}

    @property
    def num_classes(self) -> int:
        return len(self.classes)

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, idx: int):
        s = self.samples[idx]
        return {
            "image_path": s["image_path"],
            "boxes_xyxy": s["boxes_xyxy"],
            "labels": s["labels"],
        }
