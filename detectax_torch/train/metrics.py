"""Observability: console prints, CSV/JSONL metrics, throughput meter.

Copy of `detectax/train/metrics.py` (no framework code in it): formatted
console prints every `display_step`, an appended loss CSV persisted with
each checkpoint that reloads on resume so history continues, plus
throughput (images per second).
"""
from __future__ import annotations

import csv
import json
import os
import time
from typing import Mapping


class MetricsLogger:
    def __init__(self, csv_path: str | None = None,
                 jsonl_path: str | None = None):
        self.csv_path = csv_path
        self.jsonl_path = jsonl_path
        self.history: list[dict] = []
        if csv_path and os.path.exists(csv_path):
            with open(csv_path) as f:
                self.history = [
                    {k: _maybe_float(v) for k, v in row.items()}
                    for row in csv.DictReader(f)
                ]

    def log(self, step: int, values: Mapping[str, float]):
        row = {"step": int(step)}
        row.update({k: float(v) for k, v in values.items()})
        self.history.append(row)
        if self.jsonl_path:
            with open(self.jsonl_path, "a") as f:
                f.write(json.dumps(row) + "\n")

    def flush_csv(self):
        if not (self.csv_path and self.history):
            return
        keys: list[str] = []
        for row in self.history:
            for k in row:
                if k not in keys:
                    keys.append(k)
        with open(self.csv_path, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=keys)
            w.writeheader()
            w.writerows(self.history)

    def last_step(self) -> int:
        return int(self.history[-1]["step"]) if self.history else 0


def _maybe_float(v):
    try:
        return float(v)
    except (TypeError, ValueError):
        return v


class ThroughputMeter:
    """images/sec over a sliding window of steps."""

    def __init__(self):
        self._t0 = None
        self._images = 0

    def start(self):
        self._t0 = time.perf_counter()
        self._images = 0

    def update(self, n_images: int):
        self._images += n_images

    def rate(self) -> float:
        if self._t0 is None:
            return 0.0
        dt = time.perf_counter() - self._t0
        return self._images / dt if dt > 0 else 0.0

    def reset(self) -> float:
        r = self.rate()
        self.start()
        return r


def format_console(step: int, lr: float, metrics: Mapping[str, float]) -> str:
    parts = [f"step {step}", f"lr {lr:.6f}"]
    parts += [f"{k} {float(v):.4f}" for k, v in metrics.items()]
    return " | ".join(parts)
