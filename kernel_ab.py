#!/usr/bin/env python3
"""Time the kernels of two trees on one card, in turns.

    python3 kernel_ab.py PARENT_DIR [--out FILE]

PARENT_DIR is another checkout of the repository (for instance the parent
commit unpacked with ``git archive``). The script runs a child process in
the parent tree, then two in this tree, then one more in the parent tree
(parent, change, change, parent). Each child builds its own tree's kernels
and times, on the same seeded inputs:

* `nms_sweep` and `dense_nms` at the shapes of ``chip_smoke.py``'s kernel
  phase (inputs from that tree's ``chip_smoke.make_candidates``);
* the FCOS class term of a training step over the five level shapes at
  384 px, batch 16 (the class channels ``y[..., 5:]`` of ``[16, h, h, 25]``
  maps, read in place), forward and forward + backward: one
  `focal_loss_group` call where the tree has that entry, else five
  `focal_loss` calls; and the scale-slot model's class term, channels 4:
  of a ``[16, 64, 64, 5, 24]`` map read in place, forward (one
  `focal_loss` call);
* `peak_mask_scores` and `peak_scores` at ``[8, 48, 48, 20]`` and
  ``[8, 64, 64, 20]``.

A time is the device milliseconds of one
call: CUDA events around 50 calls queued behind a blocker of large matrix
products, so that the host's enqueue does not show. Prints one JSON line a
run, then the card (``nvidia-smi`` name and power limit) and a JSON summary
of the best of each tree's runs; writes the whole to FILE when given.
Needs one CUDA card and ``nvcc``.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

SWEEP_SHAPES = ((8, 1024, True, False), (8, 1024, False, True),
                (8, 2048, True, False))
DENSE_SHAPES = ((8, 3069, 100), (8, 8525, 200), (8, 2304, 100),
                (1, 2304, 100), (8, 11520, 100), (8, 20480, 100))
FOCAL_LEVELS = (48, 24, 12, 6, 3)    # h = w of the FCOS levels at 384 px
PEAK_SHAPES = ((8, 48, 48, 20), (8, 64, 64, 20))

CHILD = r"""
import json, sys, time
import numpy as np, torch
import chip_smoke as cs
from detectax_torch.kernels import _common, focal as KF, nms as K, peak as KP

sweep_shapes, dense_shapes, focal_levels, peak_shapes = json.loads(sys.argv[1])
dev = torch.device("cuda", 0)
_common.load_library()
K.load_kernels()

# one clock for both trees, whatever their chip_smoke.py times with
def queued_ms(fn, reps=50):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3
    a = torch.ones((8192, 8192), device=dev)
    a @ a
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    a @ a
    torch.cuda.synchronize()
    one_ms = (time.perf_counter() - t1) * 1e3
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for _ in range(int(2.0 * host_ms / one_ms) + 2):
        a @ a
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps

rng = np.random.default_rng(0)
out = {"sweep": [], "dense": []}
for batch, k, class_aware, with_valid in sweep_shapes:
    boxes, scores, classes = cs.make_candidates(
        rng, batch, k, pad_tail=k // 16 if with_valid else 0)
    order = np.argsort(-scores, axis=1, kind="stable")
    take = lambda a: np.take_along_axis(
        a, order if a.ndim == 2 else order[..., None], axis=1)
    b = torch.from_numpy(take(boxes)).to(dev)
    c = torch.from_numpy(take(classes)).to(dev) if class_aware else None
    v = torch.from_numpy(take(scores) >= 0).to(dev) if with_valid else None
    out["sweep"].append({"B": batch, "K": k, "class_aware": class_aware,
                         "valid_mask": with_valid,
                         "ms": queued_ms(lambda: K.nms_sweep(b, 0.5, v, c))})
for batch, m, max_outputs in dense_shapes:
    boxes, scores, classes = cs.make_candidates(rng, batch, m)
    b, s, c = (torch.from_numpy(x).to(dev) for x in (boxes, scores, classes))
    kw = dict(iou_thresh=0.5, score_thresh=0.05, max_outputs=max_outputs,
              class_aware=True)
    out["dense"].append({"B": batch, "M": m, "max_outputs": max_outputs,
                         "ms": queued_ms(lambda: K.dense_nms(b, s, c, **kw))})

# the FCOS class term: one grouped call where the tree has it
frng = np.random.default_rng(1)
segs = []
for hw in focal_levels:
    shape = (16, hw, hw, 25)
    z = torch.from_numpy((frng.uniform(size=shape) < 0.01)
                         .astype(np.float32)).to(dev)
    x = torch.from_numpy((4.0 * frng.standard_normal(size=shape))
                         .astype(np.float32)).to(dev)
    segs.append((z[..., 5:], x[..., 5:].detach().requires_grad_(True)))
xs = [x for _, x in segs]
grouped = hasattr(KF, "focal_loss_group")
if grouped:
    ones = torch.ones(len(segs), device=dev)
    def fwd():
        return KF.focal_loss_group(segs)
    def fwd_bwd():
        torch.autograd.grad(KF.focal_loss_group(segs), xs, ones)
else:
    one = torch.ones((), device=dev)
    def fwd():
        return [KF.focal_loss(z, x) for z, x in segs]
    def fwd_bwd():
        torch.autograd.grad(fwd(), xs, [one] * len(segs))
with torch.no_grad():
    fwd_ms = queued_ms(fwd)
out["focal"] = [
    {"case": "five_levels_fwd", "grouped": grouped, "ms": fwd_ms},
    {"case": "five_levels_fwd_bwd", "grouped": grouped,
     "ms": queued_ms(fwd_bwd)}]
shape = (16, 64, 64, 5, 24)
zs = torch.from_numpy((frng.uniform(size=shape) < 0.01)
                      .astype(np.float32)).to(dev)[..., 4:]
xs5 = torch.from_numpy((4.0 * frng.standard_normal(size=shape))
                       .astype(np.float32)).to(dev)[..., 4:]
with torch.no_grad():
    out["focal"].append({"case": "slots_fwd", "grouped": False,
                         "ms": queued_ms(lambda: KF.focal_loss(zs, xs5))})
out["peak"] = []
prng = np.random.default_rng(2)
for shape in peak_shapes:
    t = torch.from_numpy(prng.uniform(0, 1, size=shape)
                         .astype(np.float32)).to(dev)
    for sigmoid, fn in ((False, KP.peak_mask_scores), (True, KP.peak_scores)):
        with torch.no_grad():
            out["peak"].append({"dims": shape, "sigmoid": sigmoid,
                                "ms": queued_ms(lambda: fn(t))})
print("RESULT " + json.dumps(out), flush=True)
"""


def run_child(tree: str) -> dict:
    shapes = json.dumps([SWEEP_SHAPES, DENSE_SHAPES, FOCAL_LEVELS,
                         PEAK_SHAPES])
    res = subprocess.run([sys.executable, "-c", CHILD, shapes], cwd=tree,
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True, timeout=600)
    lines = [ln for ln in res.stdout.splitlines() if ln.startswith("RESULT ")]
    if res.returncode != 0 or not lines:
        raise SystemExit(f"kernel_ab: the run in {tree} failed "
                         f"(exit {res.returncode}):\n{res.stdout[-4000:]}")
    return json.loads(lines[-1][len("RESULT "):])


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("parent", help="checkout of the tree to compare with")
    ap.add_argument("--out", help="also write the runs and summary here")
    args = ap.parse_args()
    here = os.path.dirname(os.path.abspath(__file__))
    parent = os.path.abspath(args.parent)
    runs = []
    for name, tree in (("parent", parent), ("change", here),
                       ("change", here), ("parent", parent)):
        r = run_child(tree)
        runs.append({"tree": name, **r})
        print(json.dumps(runs[-1]), flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], stdout=subprocess.PIPE, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    summary = {"card": card}
    for kernel in ("sweep", "dense", "focal", "peak"):
        rows = []
        for i, shape in enumerate(runs[0][kernel]):
            best = {t: min(r[kernel][i]["ms"] for r in runs if r["tree"] == t)
                    for t in ("parent", "change")}
            rows.append({**{k: v for k, v in shape.items()
                            if k not in ("ms", "grouped")},
                         "parent_ms": best["parent"],
                         "change_ms": best["change"],
                         "speedup": best["parent"] / best["change"]})
        summary[kernel] = rows
    print(card)
    print(json.dumps(summary), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"runs": runs, "summary": summary}, f, indent=1)


if __name__ == "__main__":
    main()
