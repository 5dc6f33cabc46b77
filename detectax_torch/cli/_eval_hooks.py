"""Periodic visual-eval hooks for the training driver.

Port of `detectax/cli/_eval_hooks.py`: on display steps, run the eval
forward on the batch's first image and draw a detection overlay (FCOS: and
its P3 max-class-probability heatmap) through `infer.visualize`. Drawing
needs matplotlib: a hook factory checks for it when it is called, so a
trainer asked for ``--dump_visuals`` without it raises at start-up, before
step 1.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from detectax_torch.infer import predict as P
from detectax_torch.infer import visualize


def _draw_detections(img, dets, id_to_label, out_file):
    dets = {k: v.cpu().numpy() for k, v in dets.items()}
    n = int(dets["num_valid"][0])
    visualize.visualize_detections(
        np.asarray(img[0]), dets["boxes"][0][:n], dets["classes"][0][:n],
        dets["scores"][0][:n], id_to_label, out_file=out_file,
    )


def fcos_eval_hook(num_classes: int, id_to_label=None, use_centerness=True):
    visualize.require_matplotlib()

    def hook(step, state, forward, batch, out_dir):
        img = batch["images"][:1]
        outs = forward(img)
        with torch.no_grad():
            boxes, probs = P.fcos_decode(outs, use_centerness=use_centerness)
            dets = P.detections_from_dense(
                boxes, probs, iou_thresh=0.5, score_thresh=0.3,
                max_outputs=50)
        _draw_detections(img, dets, id_to_label,
                         os.path.join(out_dir, f"detect_{step}.jpg"))
        # P3 max-class heatmap
        hm = torch.sigmoid(outs[0][0][..., 5:]).amax(dim=-1).cpu().numpy()
        visualize.save_heatmap(
            hm, out_file=os.path.join(out_dir, f"heatmap_{step}.jpg"),
            image=np.asarray(img[0]), title=f"step {step} P3 max prob",
        )

    return hook


def centernet_s8_eval_hook(box_scales, id_to_label=None):
    visualize.require_matplotlib()

    def hook(step, state, forward, batch, out_dir):
        img = batch["images"][:1]
        out = forward(img)
        with torch.no_grad():
            boxes, probs = P.centernet_s8_decode(out, box_scales=box_scales)
            dets = P.detections_from_dense(
                boxes, probs, iou_thresh=0.213, score_thresh=0.3,
                max_outputs=100, class_aware=True)
        _draw_detections(img, dets, id_to_label,
                         os.path.join(out_dir, f"detect_{step}.jpg"))

    return hook


def retinanet_eval_hook(anchors_per_level, id_to_label=None):
    """Class-agnostic NMS at score 0.3, as the reference's RetinaNet
    inference draws."""
    visualize.require_matplotlib()

    def hook(step, state, forward, batch, out_dir):
        img = batch["images"][:1]
        outs = forward(img)
        with torch.no_grad():
            boxes, probs = P.retinanet_decode(
                outs, anchors_per_level=anchors_per_level)
            dets = P.detections_from_dense(
                boxes, probs, iou_thresh=0.5, score_thresh=0.3,
                max_outputs=100, class_aware=False)
        _draw_detections(img, dets, id_to_label,
                         os.path.join(out_dir, f"detect_{step}.jpg"))

    return hook
