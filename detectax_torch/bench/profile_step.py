"""Per-kernel device profile of the flagship train step.

``python -m detectax_torch.bench.profile_step [--img 384] [--batch 16]
[--top 15]``

The counterpart of `benchmarks/profile_step.py`. It builds the flagship
step of `bench.train` (FCOS-R50, bf16), warms it up, then traces one step
under `torch.profiler` (CPU and CUDA activities, ``with_flops=True``) and
sums the device kernels three ways:

- by category: convolution / GEMM (cuDNN's and cuBLAS's kernels),
  BatchNorm (the kernels its forward launched and those of their backward
  nodes), copy / memset / fill, reduction and pooling, elementwise, each
  of the port's own kernels by name, other;
  ms, share, count and TFLOP/s (the profiler's own count, which covers
  forward convolutions and matmuls and elementwise multiplies and adds,
  not a convolution's backward: the step's full count, `bench.train.
  step_flops`, is beside it over the GEMM time);
- by phase: the forward by top-level child of the model (ranges pushed by
  forward hooks this script installs), assign and loss (ranges around the
  functions handed to `make_train_step`), backward (autograd's own
  ranges), update (the optimizer's own range), other;
- the top kernels by name.

It reports the device's busy time and its idle share over the traced
step (which the profiler's host work lengthens) and over the same step
timed without the profiler (the best of the warm-up steps), prints the
tables, then a last line ``{"profile_step_summary": {...}}``.
It needs a CUDA device, and fails when the profiler saw no device time.

`summarize` is a pure function over plain event records, so that the sums
can be checked without a card.
"""
from __future__ import annotations

import argparse
import collections
import functools
import json
import re
import time

import torch

from detectax_torch import runtime
from detectax_torch.bench import train as bench_train
from detectax_torch.bench._common import (
    device_label,
    require_cuda,
    synchronize,
)
from detectax_torch.models.layers import BatchNorm
from detectax_torch.train.losses import fcos_loss

STEP = "detectax::step"
ASSIGN = "detectax::assign"
LOSS = "detectax::loss"
FORWARD = "detectax::forward"
BATCHNORM = "detectax::batchnorm"
BACKWARD_PREFIX = "autograd::engine::evaluate_function"
UPDATE_PREFIX = "Optimizer.step"

PORT_KERNEL = re.compile(
    r"(focal_fwd|focal_bwd|dense_nms_mem|dense_nms|nms_mask|nms_sweep_wide|"
    r"nms_sweep|peak)_kernel")
CATEGORIES = (
    ("batchnorm", re.compile(r"batch_norm|batchnorm|bn_fw|bn_bw", re.I)),
    ("copy/memset/fill", re.compile(
        r"^Memcpy|^Memset|copy_kernel|CatArrayBatchedCopy|nchwToNhwc|"
        r"nhwcToNchw|transpose|FillFunctor|fill_kernel", re.I)),
    ("conv/gemm", re.compile(
        r"gemm|conv|xmma|cutlass|cudnn|cublas|nvjet|wgrad|dgrad|fprop",
        re.I)),
    ("reduction/pooling", re.compile(r"reduce|softmax|scan|pool", re.I)),
    ("elementwise", re.compile(r"elementwise|multi_tensor_apply", re.I)),
)


# --------------------------------------------------------------------------
# the sums: a pure function over plain records
# --------------------------------------------------------------------------

def _parents(ops: list) -> dict:
    """Each host event's enclosing event on its thread (id -> id or None),
    from the nesting of their time ranges."""
    parent = {}
    by_thread = collections.defaultdict(list)
    for op in ops:
        by_thread[op["thread"]].append(op)
    for thread_ops in by_thread.values():
        stack = []
        for op in sorted(thread_ops, key=lambda o: (o["start"], -o["end"])):
            while stack and stack[-1]["end"] < op["end"]:
                stack.pop()
            parent[op["id"]] = stack[-1]["id"] if stack else None
            stack.append(op)
    return parent


def _phase(name: str) -> str | None:
    if name == ASSIGN:
        return "assign"
    if name == LOSS:
        return "loss"
    if name == FORWARD:
        return "forward"
    if name.startswith(FORWARD + "/"):
        return "forward:" + name[len(FORWARD) + 1:]
    if name.startswith(BACKWARD_PREFIX):
        return "backward"
    if name.startswith(UPDATE_PREFIX):
        return "update"
    return None


def _category(name: str, in_batchnorm: bool) -> str:
    m = PORT_KERNEL.search(name)
    if m:
        return "port:" + m.group(0)
    if in_batchnorm:
        return "batchnorm"
    for cat, pattern in CATEGORIES:
        if pattern.search(name):
            return cat
    return "other"


def _union_us(intervals: list) -> float:
    busy, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        busy += e - max(s, end)
        end = e
    return busy


def summarize(events: list, top: int = 15) -> dict:
    """Device time of one traced step by category, by phase and by kernel.

    ``events`` are plain records, times in microseconds:

    - ``{"kind": "kernel", "name", "start", "end", "op"}``: a device
      kernel (or copy, or memset); ``op`` is the id of the host event that
      launched it (the profiler's linked correlation id);
    - ``{"kind": "op", "name", "id", "thread", "start", "end", "flops",
      "seq", "fwd_thread"}``: a host event (an operator or a named range);
      ``seq`` is its autograd sequence number (-1 when none) and, on a
      backward range, ``fwd_thread`` the thread of the forward operator of
      that number.

    A kernel's phase is that of the innermost phase range around its
    launching operator (`_phase`), "other" outside them, "unattributed"
    when its launching operator is not in the trace. Its category is the
    port's kernel by name, else "batchnorm" when it was launched inside a
    ``detectax::batchnorm`` range or by the backward node of an operator
    that was, else by name (`CATEGORIES`). The profiler's operation count
    of an operator goes to the longest kernel it (or an operator inside
    it) launched. The window runs from the start of the ``detectax::step``
    range (or of the first event) to the end of the last kernel or of that
    range; the busy time is the union of the kernels' intervals.
    """
    kernels = [e for e in events if e["kind"] == "kernel"]
    if not kernels:
        raise ValueError("the trace holds no device kernel")
    ops = {e["id"]: e for e in events if e["kind"] == "op"}
    parent = _parents(list(ops.values()))

    def ancestors(op_id):
        while op_id is not None:
            yield ops[op_id]
            op_id = parent[op_id]

    def in_batchnorm(op_id):
        return any(o["name"] == BATCHNORM for o in ancestors(op_id))

    forward_of = {}   # (thread, seq) -> a forward operator of that number
    for op in ops.values():
        if op["seq"] >= 0 and not op["name"].startswith(BACKWARD_PREFIX):
            forward_of.setdefault((op["thread"], op["seq"]), op["id"])

    flops_owner = {}  # operator id -> index of the kernel holding its count
    rows = []
    for i, k in enumerate(kernels):
        dur = k["end"] - k["start"]
        phase, bn = "unattributed", False
        if k["op"] in ops:
            phase = "other"
            for o in ancestors(k["op"]):
                p = _phase(o["name"])
                if p is None:
                    continue
                phase = p
                if p == "backward":
                    fwd = forward_of.get((o["fwd_thread"], o["seq"]))
                    bn = fwd is not None and in_batchnorm(fwd)
                break
            bn = bn or in_batchnorm(k["op"])
            owner = next((o["id"] for o in ancestors(k["op"])
                          if o["flops"] > 0), None)
            if owner is not None:
                j = flops_owner.get(owner)
                if j is None or dur > rows[j]["dur"]:
                    flops_owner[owner] = i
        rows.append({"name": k["name"], "dur": dur, "phase": phase,
                     "category": _category(k["name"], bn)})
    flops = [0] * len(rows)
    for owner, i in flops_owner.items():
        flops[i] += ops[owner]["flops"]

    device_us = sum(r["dur"] for r in rows)

    def table(key):
        acc = collections.defaultdict(lambda: [0.0, 0, 0])
        for r, f in zip(rows, flops):
            a = acc[r[key]]
            a[0] += r["dur"]
            a[1] += 1
            a[2] += f
        return {
            name: {"ms": us / 1e3, "pct": 100.0 * us / device_us, "n": n,
                   "tflops_per_s": f / us / 1e6 if us > 0 else 0.0}
            for name, (us, n, f) in sorted(acc.items(),
                                           key=lambda kv: -kv[1][0])}

    by_name = collections.defaultdict(lambda: [0.0, 0, ""])
    for r in rows:
        a = by_name[r["name"]]
        a[0] += r["dur"]
        a[1] += 1
        a[2] = r["category"]
    top_rows = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]

    step = next((o for o in ops.values() if o["name"] == STEP), None)
    first = min(k["start"] for k in kernels)
    last = max(k["end"] for k in kernels)
    if step is not None:
        start, end = min(step["start"], first), max(step["end"], last)
    else:
        start = min([first] + [o["start"] for o in ops.values()])
        end = max([last] + [o["end"] for o in ops.values()])
    busy = _union_us([(k["start"], k["end"]) for k in kernels])
    other = collections.Counter()
    for r in rows:
        if r["category"] == "other":
            other[r["name"]] += r["dur"]
    return {
        "device_ms": device_us / 1e3,
        "busy_ms": busy / 1e3,
        "window_ms": (end - start) / 1e3,
        "idle_share": 1.0 - busy / (end - start),
        "kernels": len(rows),
        "by_category": table("category"),
        "by_phase": table("phase"),
        "top_kernels": [
            {"name": name, "ms": us / 1e3, "n": n, "category": cat}
            for name, (us, n, cat) in top_rows],
        # the kernels no category's pattern names, longest first
        "uncategorized_ms": {name: us / 1e3
                             for name, us in other.most_common(top)},
    }


# --------------------------------------------------------------------------
# the trace
# --------------------------------------------------------------------------

def events_from_profiler(prof) -> tuple[list, set]:
    """`summarize`'s records of a finished `torch.profiler.profile`, read
    from the profiler's own (Kineto) events: the device activities
    (kernels, copies, memsets; not the ranges' mirrors on the device's
    timeline), and the host operators and ranges (named ``ns::op``, or a
    range; the runtime's calls, linked to an operator, and the profiler's
    own activities, which share their operator's id, are left out), times in
    microseconds from the first event. Also returns the names of the
    ranges."""
    from torch.autograd import DeviceType

    raw = [e for e in prof.profiler.kineto_results.events()
           if not e.is_async()]
    base = min(e.start_ns() for e in raw)
    ranges = {e.name() for e in raw
              if e.device_type() == DeviceType.CPU and e.is_user_annotation()}
    out = []
    for e in raw:
        start = (e.start_ns() - base) / 1e3
        rec = {"name": e.name(), "start": start,
               "end": start + e.duration_ns() / 1e3}
        if e.device_type() == DeviceType.CUDA:
            if e.is_user_annotation() or e.name() in ranges:
                continue
            if e.name().startswith("detectax::"):
                raise RuntimeError(f"a range's mirror on the device's "
                                   f"timeline was taken for a kernel: "
                                   f"{e.name()}")
            out.append({"kind": "kernel", "op": e.linked_correlation_id(),
                        **rec})
        elif (e.device_type() == DeviceType.CPU
              and e.linked_correlation_id() == 0
              and ("::" in e.name() or e.is_user_annotation())):
            out.append({"kind": "op", "id": e.correlation_id(),
                        "thread": e.start_thread_id(),
                        "flops": int(e.flops()), "seq": e.sequence_nr(),
                        "fwd_thread": e.fwd_thread_id(), **rec})
    return out, ranges


class _Ranges:
    """Named `record_function` ranges around module forwards, pushed by
    forward pre-hooks and popped by forward hooks."""

    def __init__(self):
        self.handles, self.open = [], []

    def add(self, module: torch.nn.Module, name: str) -> None:
        def enter(mod, args):
            rf = torch.autograd.profiler.record_function(name)
            rf.__enter__()
            self.open.append(rf)

        def leave(mod, args, out):
            self.open.pop().__exit__(None, None, None)

        self.handles += [module.register_forward_pre_hook(enter),
                         module.register_forward_hook(leave)]

    def remove(self) -> None:
        for h in self.handles:
            h.remove()


def ranged(name: str, fn):
    """``fn`` inside a `record_function` range named ``name``."""
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with torch.autograd.profiler.record_function(name):
            return fn(*args, **kwargs)
    return wrapped


def trace_step(img: int, batch: int, device, top: int = 15) -> dict:
    """`summarize` of one traced flagship step (FCOS-R50, bf16) after the
    one `step_flops` counts and `bench.train.WARMUP_STEPS` untraced ones,
    with the model's forward and BatchNorm ranges."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    setup = bench_train.make_train_setup(
        img, batch, "resnet50", device=device,
        assign_fn=ranged(ASSIGN, bench_train.flagship_assign(img)),
        loss_fn=ranged(LOSS, fcos_loss))
    model = setup.state.model
    hooks = _Ranges()
    hooks.add(model, FORWARD)
    for name, child in model.named_children():
        hooks.add(child, f"{FORWARD}/{name}")
    for m in model.modules():
        if isinstance(m, BatchNorm):
            hooks.add(m, BATCHNORM)
    dev = setup.batch["images"].device
    try:
        flops = bench_train.step_flops(setup)
        step_s = []
        for _ in range(bench_train.WARMUP_STEPS):
            t0 = time.perf_counter()
            setup.step(setup.state, setup.batch)
            synchronize(dev)
            step_s.append(time.perf_counter() - t0)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     with_flops=True) as prof:
            with torch.autograd.profiler.record_function(STEP):
                setup.step(setup.state, setup.batch)
                synchronize(dev)
    finally:
        hooks.remove()
    events, ranges = events_from_profiler(prof)
    # the profiler's own sum of device time, its ranges' mirrors left out
    device_us = sum(e.self_device_time_total for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA
                    and e.key not in ranges)
    if device_us <= 0:
        raise RuntimeError("torch.profiler saw no device time in the "
                           "traced step; no device profile to report")
    summary = summarize(events, top)
    summary["key_averages_device_ms"] = device_us / 1e3
    # the same step without the profiler: the best of the warm-up steps
    step_ms = min(step_s) * 1e3
    summary["step_ms_unprofiled"] = step_ms
    summary["idle_share_unprofiled"] = 1.0 - summary["busy_ms"] / step_ms
    gemm = summary["by_category"].get("conv/gemm", {}).get("ms", 0.0)
    summary["step_flops"] = flops
    summary["gemm_tflops_per_s_from_step_count"] = (
        flops / (gemm * 1e-3) / 1e12 if gemm > 0 else None)
    return summary


def print_tables(summary: dict) -> None:
    print(f"\n== by category (device total {summary['device_ms']:.3f} ms, "
          f"busy {summary['busy_ms']:.3f} of {summary['window_ms']:.3f} ms "
          f"traced, idle share {summary['idle_share']:.3f}; of the "
          f"{summary['step_ms_unprofiled']:.3f} ms step unprofiled "
          f"{summary['idle_share_unprofiled']:.3f}) ==")
    print(f"{'ms':>9} {'%':>5} {'n':>6} {'TFLOP/s':>8}  category")
    for cat, r in summary["by_category"].items():
        print(f"{r['ms']:9.3f} {r['pct']:5.1f} {r['n']:6d} "
              f"{r['tflops_per_s']:8.1f}  {cat}")
    print("\n== by phase ==")
    for phase, r in summary["by_phase"].items():
        print(f"{r['ms']:9.3f} {r['pct']:5.1f} {r['n']:6d}  {phase}")
    print(f"\n== top {len(summary['top_kernels'])} kernels ==")
    for r in summary["top_kernels"]:
        print(f"{r['ms']:9.3f} ms {r['n']:5d}  {r['category']:<18} "
              f"{r['name'][:90]}")


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--img", type=int, default=384)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--top", type=int, default=15)
    args = p.parse_args(argv)
    dev = require_cuda("detectax_torch.bench.profile_step")
    runtime.set_tf32(False)
    summary = trace_step(args.img, args.batch, dev, args.top)
    summary.update({
        "model": "FCOS resnet50 FPN", "img": args.img,
        "batch": args.batch, "dtype": "bfloat16",
        "device": device_label(dev),
        "card": runtime.card_name_and_power()})
    print_tables(summary)
    print(json.dumps({"profile_step_summary": summary}), flush=True)
    return summary


if __name__ == "__main__":
    main()
