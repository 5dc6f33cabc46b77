"""Detection mAP evaluation (VOC-style AP@0.5 and COCO-style AP@[.5:.95]),
plus COCO-style area-binned AP (small/medium/large) and AR@100.

Copy of `detectax/eval/detection_metrics.py` (numpy only), so that the
port's summaries equal the JAX package's on the same detections. In the
JAX package it was a new first-class subsystem: the reference has no quantitative eval at all —
its only verification is visual overlays (SURVEY.md §4). BASELINE.json's
acceptance criteria are stated in mAP, so this evaluator is the measuring
stick. Pure numpy, no pycocotools dependency (not available in this image).

Conventions: boxes are pixel corner (y1, x1, y2, x2); greedy matching of
score-descending detections to the best unmatched GT with IoU >= thresh
(the standard VOC/COCO protocol, each GT matched at most once).

Area-binned metrics follow the COCO ignore protocol: GT outside the bin is
*ignored* (not counted in n_gt); a detection whose best available match is
an ignored GT is ignored too (neither TP nor FP); an unmatched detection
whose own area falls outside the bin is also ignored. AR@100 is the recall
of the top-100-scoring detections per image (across classes), averaged
over IoU thresholds and classes.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Mapping, Sequence

import numpy as np

COCO_IOU_THRESHOLDS = tuple(np.arange(0.5, 1.0, 0.05))

# COCO area-bin edges (pixels^2). DetBench eval canvases are 384-640px —
# the same ballpark as COCO's 640ish images — so the standard 32^2 / 96^2
# edges are kept (override via MeanAPEvaluator(area_bins=...)).
COCO_AREA_BINS: dict[str, tuple[float, float]] = {
    "small": (0.0, 32.0**2),
    "medium": (32.0**2, 96.0**2),
    "large": (96.0**2, float("inf")),
}
AR_MAX_DETS = 100


def _iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)), np.float32)
    lo = np.maximum(a[:, None, :2], b[None, :, :2])
    hi = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.maximum(hi - lo, 0.0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = np.prod(np.maximum(a[:, 2:] - a[:, :2], 0), axis=-1)
    area_b = np.prod(np.maximum(b[:, 2:] - b[:, :2], 0), axis=-1)
    return inter / (area_a[:, None] + area_b[None, :] - inter + 1e-9)


def average_precision(
    recall: np.ndarray, precision: np.ndarray, mode: str = "area"
) -> float:
    """AP from a PR curve. mode="area": all-points interpolated (VOC2010+/
    COCO); mode="voc07": 11-point."""
    if len(recall) == 0:
        return 0.0
    if mode == "voc07":
        ap = 0.0
        for t in np.linspace(0, 1, 11):
            mask = recall >= t
            ap += (precision[mask].max() if mask.any() else 0.0) / 11.0
        return float(ap)
    mrec = np.concatenate([[0.0], recall, [1.0]])
    mpre = np.concatenate([[0.0], precision, [0.0]])
    mpre = np.maximum.accumulate(mpre[::-1])[::-1]
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


class MeanAPEvaluator:
    """Accumulates per-image detections + ground truth, computes mAP."""

    def __init__(self, num_classes: int,
                 iou_thresholds: Sequence[float] = (0.5,),
                 area_bins: Mapping[str, tuple[float, float]] | None = None):
        self.num_classes = num_classes
        self.iou_thresholds = tuple(iou_thresholds)
        self.area_bins = dict(
            COCO_AREA_BINS if area_bins is None else area_bins
        )
        # "all" drives AR@100 (full-range bin over the capped det list)
        self._bins = {"all": (0.0, float("inf")), **self.area_bins}
        # per class: list of (score, [n_thresh] tp flags)
        self._dets: dict[int, list] = defaultdict(list)
        self._n_gt = np.zeros(num_classes, np.int64)
        # area-binned accumulators (COCO ignore protocol, top-100 dets):
        # per bin per class: list of (score, tp[n_t], ignore[n_t])
        self._bin_dets: dict[str, dict[int, list]] = {
            b: defaultdict(list) for b in self._bins
        }
        self._bin_ngt = {
            b: np.zeros(num_classes, np.int64) for b in self._bins
        }
        self._img_id = 0

    def add_image(
        self,
        pred_boxes: np.ndarray,
        pred_scores: np.ndarray,
        pred_classes: np.ndarray,
        gt_boxes: np.ndarray,
        gt_classes: np.ndarray,
    ):
        pred_boxes = np.asarray(pred_boxes, np.float32).reshape(-1, 4)
        pred_scores = np.asarray(pred_scores, np.float32).reshape(-1)
        pred_classes = np.asarray(pred_classes, np.int64).reshape(-1)
        gt_boxes = np.asarray(gt_boxes, np.float32).reshape(-1, 4)
        gt_classes = np.asarray(gt_classes, np.int64).reshape(-1)

        for c in np.unique(gt_classes):
            self._n_gt[c] += int((gt_classes == c).sum())

        order = np.argsort(-pred_scores)
        for c in np.unique(pred_classes):
            det_idx = order[pred_classes[order] == c]
            gt_idx = np.where(gt_classes == c)[0]
            iou = _iou_matrix(pred_boxes[det_idx], gt_boxes[gt_idx])
            n_t = len(self.iou_thresholds)
            matched = np.zeros((n_t, len(gt_idx)), bool)
            for rank, di in enumerate(det_idx):
                tp = np.zeros(n_t, bool)
                for ti, t in enumerate(self.iou_thresholds):
                    cand = np.where(
                        (iou[rank] >= t) & ~matched[ti]
                    )[0]
                    if len(cand):
                        best = cand[np.argmax(iou[rank][cand])]
                        matched[ti, best] = True
                        tp[ti] = True
                self._dets[int(c)].append(
                    (float(pred_scores[di]), tp.copy())
                )
        self._add_area_binned(
            pred_boxes, pred_scores, pred_classes, gt_boxes, gt_classes
        )
        self._img_id += 1

    @staticmethod
    def _areas(boxes: np.ndarray) -> np.ndarray:
        wh = np.maximum(boxes[:, 2:] - boxes[:, :2], 0.0)
        return wh[:, 0] * wh[:, 1]

    def _add_area_binned(self, pred_boxes, pred_scores, pred_classes,
                         gt_boxes, gt_classes):
        """COCO ignore-protocol matching per area bin over the top-100
        detections of the image (across classes) — feeds AP_S/M/L + AR."""
        n_t = len(self.iou_thresholds)
        keep = np.argsort(-pred_scores)[:AR_MAX_DETS]
        pred_boxes, pred_scores, pred_classes = (
            pred_boxes[keep], pred_scores[keep], pred_classes[keep]
        )
        det_areas = self._areas(pred_boxes)
        gt_areas = self._areas(gt_boxes)

        for bin_name, (lo, hi) in self._bins.items():
            gt_ign = (gt_areas < lo) | (gt_areas >= hi)
            for c in np.unique(np.concatenate([pred_classes, gt_classes])):
                gt_idx = np.where(gt_classes == c)[0]
                self._bin_ngt[bin_name][int(c)] += int(
                    (~gt_ign[gt_idx]).sum()
                )
                order = np.argsort(-pred_scores)
                det_idx = order[pred_classes[order] == c]
                if len(det_idx) == 0:
                    continue
                iou = _iou_matrix(pred_boxes[det_idx], gt_boxes[gt_idx])
                ign_g = gt_ign[gt_idx]
                matched = np.zeros((n_t, len(gt_idx)), bool)
                for rank, di in enumerate(det_idx):
                    tp = np.zeros(n_t, bool)
                    ign_d = np.zeros(n_t, bool)
                    for ti, t in enumerate(self.iou_thresholds):
                        cand = np.where(
                            (iou[rank] >= t) & ~matched[ti]
                        )[0]
                        real = cand[~ign_g[cand]]
                        if len(real):
                            best = real[np.argmax(iou[rank][real])]
                            matched[ti, best] = True
                            tp[ti] = True
                        elif len(cand):
                            # only ignored GT available: det is ignored
                            best = cand[np.argmax(iou[rank][cand])]
                            matched[ti, best] = True
                            ign_d[ti] = True
                        else:
                            # unmatched: FP only if the det's own area
                            # belongs to this bin
                            a = det_areas[di]
                            ign_d[ti] = (a < lo) or (a >= hi)
                    self._bin_dets[bin_name][int(c)].append(
                        (float(pred_scores[di]), tp, ign_d)
                    )

    def per_class_ap(self) -> np.ndarray:
        """[num_classes, n_thresholds] AP table (nan for absent classes)."""
        n_t = len(self.iou_thresholds)
        aps = np.full((self.num_classes, n_t), np.nan)
        for c in range(self.num_classes):
            n_gt = self._n_gt[c]
            if n_gt == 0:
                continue
            dets = self._dets.get(c, [])
            if not dets:
                aps[c, :] = 0.0
                continue
            dets.sort(key=lambda d: -d[0])
            tp = np.stack([d[1] for d in dets])  # [n_det, n_t]
            for ti in range(n_t):
                cum_tp = np.cumsum(tp[:, ti])
                cum_fp = np.cumsum(~tp[:, ti])
                recall = cum_tp / n_gt
                precision = cum_tp / np.maximum(cum_tp + cum_fp, 1)
                aps[c, ti] = average_precision(recall, precision)
        return aps

    def _bin_ap_recall(self, bin_name: str) -> tuple[float, float]:
        """(mean AP, mean recall) over classes x IoU thresholds for one
        area bin (nan-mean over classes that have GT in the bin)."""
        n_t = len(self.iou_thresholds)
        aps = np.full((self.num_classes, n_t), np.nan)
        recs = np.full((self.num_classes, n_t), np.nan)
        for c in range(self.num_classes):
            n_gt = self._bin_ngt[bin_name][c]
            if n_gt == 0:
                continue
            dets = self._bin_dets[bin_name].get(c, [])
            if not dets:
                aps[c, :] = 0.0
                recs[c, :] = 0.0
                continue
            dets = sorted(dets, key=lambda d: -d[0])
            tp = np.stack([d[1] for d in dets])   # [n_det, n_t]
            ign = np.stack([d[2] for d in dets])  # [n_det, n_t]
            for ti in range(n_t):
                use = ~ign[:, ti]
                cum_tp = np.cumsum(tp[use, ti])
                cum_fp = np.cumsum(~tp[use, ti])
                if len(cum_tp) == 0:
                    aps[c, ti] = 0.0
                    recs[c, ti] = 0.0
                    continue
                recall = cum_tp / n_gt
                precision = cum_tp / np.maximum(cum_tp + cum_fp, 1)
                aps[c, ti] = average_precision(recall, precision)
                recs[c, ti] = recall[-1]
        any_gt = self._bin_ngt[bin_name].sum() > 0
        return (
            float(np.nanmean(aps)) if any_gt else float("nan"),
            float(np.nanmean(recs)) if any_gt else float("nan"),
        )

    def summarize(self) -> dict:
        aps = self.per_class_ap()
        valid = ~np.isnan(aps[:, 0])
        out = {
            "mAP@0.5": float(np.nanmean(aps[:, 0])) if valid.any() else 0.0,
            "per_class_ap50": {
                int(c): float(aps[c, 0])
                for c in range(self.num_classes) if valid[c]
            },
            "num_images": self._img_id,
        }
        if len(self.iou_thresholds) > 1:
            out["mAP@[.5:.95]"] = (
                float(np.nanmean(aps)) if valid.any() else 0.0
            )
        # Area-binned AP + AR@100 (averaged over the evaluator's IoU
        # thresholds: .5:.95 in coco mode, .5 alone in VOC mode).
        for bin_name in self.area_bins:
            ap, _ = self._bin_ap_recall(bin_name)
            key = f"AP_{bin_name}"
            out[key] = None if np.isnan(ap) else round(ap, 6)
        _, ar = self._bin_ap_recall("all")
        out[f"AR@{AR_MAX_DETS}"] = None if np.isnan(ar) else round(ar, 6)
        return out


def coco_evaluator(num_classes: int) -> MeanAPEvaluator:
    return MeanAPEvaluator(num_classes, iou_thresholds=COCO_IOU_THRESHOLDS)
