"""`trunk_bn_stats.py` on the CPU: its per-layer numbers on made-up
statistics, and one run over the crop-pretrained ResNet-50 trunk at 64 px
on a cut DetBench v1 (the running statistics it reports are the trunk's,
and the batch statistics those of the images the layer sees)."""
from __future__ import annotations

import json
import math
import os

import numpy as np
import pytest

import trunk_bn_stats as script

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRUNK = os.path.join(ROOT, "benchmarks", "runs", "pretrain_r50",
                     "backbone.msgpack")


def test_compare_and_summarize():
    c = 4
    same = (np.zeros(c), np.ones(c), np.zeros(c), np.ones(c))
    off = (np.full(c, 2.0), np.full(c, math.e ** 2 * (1 + script.EPS)
                                     - script.EPS),
           np.zeros(c), np.ones(c))
    per = script.compare({"a": same, "b": off})
    assert per["a"] == {"shift": 0.0, "log_var": 0.0, "running_var": 1.0,
                        "batch_var": 1.0}
    assert per["b"]["shift"] == pytest.approx(2.0 / math.sqrt(1 + script.EPS))
    assert per["b"]["log_var"] == pytest.approx(2.0)
    s = script.summarize({"t": per}, worst=1)["t"]
    assert s["layers"] == 2
    assert s["mean_shift"] == pytest.approx(per["b"]["shift"] / 2)
    assert s["worst_shift"] == ["b"] and s["worst_log_var"] == ["b"]


def test_main_on_the_r50_trunk(monkeypatch, tmp_path):
    from detectax_torch.data import detbench

    spec = detbench.load_spec

    def cut(*a, **k):
        s = dict(spec(*a, **k))
        s["n_train"], s["n_eval"] = 4, 2
        return s

    monkeypatch.setattr(detbench, "load_spec", cut)
    monkeypatch.setenv("DETECTAX_DETBENCH_CACHE", str(tmp_path / "cache"))
    out = tmp_path / "stats.jsonl"
    r = script.main(["--trunks", TRUNK, "--images", "2", "--canvas", "64",
                     "--out", str(out)], device="cpu")
    layers = r["layers"][TRUNK]
    assert len(layers) == 53              # ResNet-50's BatchNorm layers
    lines = [json.loads(x) for x in out.read_text().splitlines()]
    assert len(lines) == 1 + 53 + 1 and "summary" in lines[-1]

    from detectax_torch.tools.from_flax import load_weights

    _, stats = load_weights(TRUNK)
    rv = np.asarray(stats["stem"]["BatchNorm_0"]["var"])
    assert layers["stem.BatchNorm_0"]["running_var"] == pytest.approx(
        float(rv.mean()), rel=1e-6)
    assert all(v["batch_var"] > 0 for v in layers.values())
