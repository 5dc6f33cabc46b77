"""Decode + NMS latency under three timing protocols, one metric of record.

``python -m detectax_torch.bench.latency_reconcile``

The counterpart of `benchmarks/latency_reconcile.py`, on the inputs of
`bench.decode` (`bench.py`'s: ``default_rng(1)``, normal with scale 2,
five FCOS levels at 512 px, 20 classes) and its work: `fcos_decode`, then
`detections_from_dense` with top-k 1,024, 100 outputs and a 0.05 score
threshold, which on the card is one launch of the `dense_nms` kernel:

1. dispatch only: the host's time a call over 50 calls with no
   synchronise (PyTorch returns before the card finishes, so this is the
   cost of issuing the work);
2. amortized + fetch: 50 calls, then one value fetch, best of 3 (the
   protocol of `bench_torch.py`'s decode line, the metric of record: what
   a caller sees a call);
3. device-chained: 50 chained applications, each on the level outputs
   perturbed by the running sum of the last one's scores (``o + acc *
   1e-12``, so that no application can be skipped), captured once in a
   CUDA graph and replayed, best of 3, a value fetch closing each replay:
   the card's own time a call, the counterpart of the JAX program's one
   `fori_loop` dispatch. The capture raises if the path synchronises with
   the host; the `dense_nms` launches the graph holds are counted at
   capture (`kernels._common.count_launch` runs once a captured launch; a
   replay counts none).

One JSON line under the JAX keys, ``device`` the card's label, and the
card's name and power limit (``nvidia-smi``). It needs a CUDA device and
has no CPU branch.
"""
from __future__ import annotations

import json
import time

import torch

from detectax_torch import runtime
from detectax_torch.bench import decode as bench_decode
from detectax_torch.bench._common import (
    device_label,
    require_cuda,
    synchronize,
)
from detectax_torch.kernels import _common as kcommon

ITERS = 50     # calls a window (protocols 1, 2)
INNER = 50     # chained applications in the graph (protocol 3)
REPEATS = 3    # best of


def fetch(dets: dict) -> float:
    """A value fetch: waits for the card."""
    return float(dets["scores"].reshape(-1)[0])


def chain(outs: list, acc: torch.Tensor, inner: int) -> torch.Tensor:
    """``inner`` applications of decode + NMS, each on ``outs`` perturbed
    by the carried sum of the previous one's scores; returns the sum."""
    for _ in range(inner):
        dets = bench_decode.decode_and_nms([o + acc * 1e-12 for o in outs])
        acc = acc + dets["scores"].sum()
    return acc


def protocols(device, *, iters: int = ITERS, inner: int = INNER,
              repeats: int = REPEATS) -> dict:
    """The three protocols' ms a call on the CUDA ``device``, with the
    `dense_nms` launches captured in the graph and the detections of one
    application (for the caller to check)."""
    outs = [torch.from_numpy(o).to(device)
            for o in bench_decode.decode_inputs()]
    with torch.no_grad():
        dets = bench_decode.decode_and_nms(outs)   # builds the kernels
        fetch(dets)

        # 1. dispatch only
        t0 = time.perf_counter()
        for _ in range(iters):
            dets = bench_decode.decode_and_nms(outs)
        t_dispatch = (time.perf_counter() - t0) / iters * 1e3
        fetch(dets)

        # 2. amortized + fetch
        best = float("inf")
        for _ in range(repeats):
            t0 = time.perf_counter()
            for _ in range(iters):
                dets = bench_decode.decode_and_nms(outs)
            fetch(dets)
            best = min(best, (time.perf_counter() - t0) / iters * 1e3)
        t_amortized = best

        # 3. device-chained, one graph of `inner` applications
        acc0 = torch.zeros((), device=device)
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):   # warm-up on the capture's stream
            chain(outs, acc0, 1)
        torch.cuda.current_stream(device).wait_stream(side)
        synchronize(device)
        graph = torch.cuda.CUDAGraph()
        before = kcommon.launch_counts().get("dense_nms", 0)
        with torch.cuda.graph(graph):
            acc = chain(outs, acc0, inner)
        captured = kcommon.launch_counts().get("dense_nms", 0) - before
        best = float("inf")
        for _ in range(repeats):
            t0 = time.perf_counter()
            graph.replay()
            float(acc)
            best = min(best, (time.perf_counter() - t0) / inner * 1e3)
        t_device = best
        replayed_sum = float(acc)
        del graph
    return {
        "dispatch_only_ms": t_dispatch,
        "amortized_fetch_ms": t_amortized,
        "device_chained_ms": t_device,
        "graph_dense_nms_launches_at_capture": captured,
        "graph_scores_sum": replayed_sum,
        "detections": dets,
    }


def reconcile_line(p: dict, device) -> dict:
    """The program's line from `protocols`' result ``p``."""
    return {
        "metric": "decode_nms_latency_protocols",
        "dispatch_only_ms": round(p["dispatch_only_ms"], 3),
        "amortized_fetch_ms": round(p["amortized_fetch_ms"], 3),
        "device_chained_ms": round(p["device_chained_ms"], 3),
        "record": "amortized_fetch_ms (bench_torch.py's decode line)",
        "device": device_label(device),
        "card": runtime.card_name_and_power(),
        "chained_in": f"one CUDA graph of {INNER} applications, replayed",
        "graph_dense_nms_launches_at_capture":
            p["graph_dense_nms_launches_at_capture"],
    }


def main() -> dict:
    dev = require_cuda("detectax_torch.bench.latency_reconcile")
    runtime.set_tf32(False)
    line = reconcile_line(protocols(dev), dev)
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
