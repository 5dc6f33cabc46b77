"""The port's measurement programs against the JAX package's, on the CPU.

`bench_torch.py` and `detectax_torch.bench` are held against `bench.py`
and `benchmarks/serving_bench.py` on the same inputs:

- the synthetic training batch and the decode line's level outputs equal
  `bench.py`'s exactly;
- step 1 of the flagship setup (tiny backbone, 64 px, batch 8, bf16, the
  JAX weights and optimizer state carried over by `tools.from_flax`)
  matches one step of `bench._make_train_setup`, in the default
  configuration, under ``DETECTAX_BN_STAT_SUBSET=4`` and under
  ``BENCH_FREEZE_BN=1`` (``total`` and the gradient norm within
  `STEP_RTOL`, `tests/test_torch_bf16.py`'s bf16 step tolerance);
- the step's operation count equals, as an integer, a count from
  convolution forward hooks, in float32 and bf16, and is linear in the
  batch (which `chip_smoke.py` uses to count the full step on the CPU);
- a training line's keys and arithmetic are `bench.py`'s;
- the decode line's path (fused NMS, its plain version on the CPU) gives
  the detections of the JAX function on its fused path; the serving bench's
  serving function those of JAX's `make_serving_fn` on the same weights
  (classes, valid, num_valid exact; boxes and scores to 1e-5);
- the profile's sums over a hand-made list of events are exact;
- the three entry points, and the six programs of
  `tests/test_torch_lever_programs.py`, without a CUDA device, exit
  non-zero and print no metric line.
"""
import json
import os
import subprocess
import sys
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detectax.cli import evaluate as JEval
from detectax.infer import export as JE
from detectax.infer import predict as JP
from detectax_torch.bench import decode as TD
from detectax_torch.bench import profile_step as TPS
from detectax_torch.bench import serving as TSv
from detectax_torch.bench import train as TB
from detectax_torch.infer import predict as TP
from detectax_torch.tools import from_flax as FF

with mock.patch.dict(os.environ):   # bench.py sets a compile cache path
    import bench

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEP_RTOL = 2e-2          # tests/test_torch_bf16.py's bf16 step tolerance
DET_ATOL = 1e-5
DET_KEYS = ("boxes", "scores", "classes", "valid", "num_valid")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """torch on one thread: the steps are tiny, and beside the suite's
    other workers a pool of threads waits on busy cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def assert_dets_equal(got, want):
    for key in DET_KEYS:
        g = got[key].numpy() if isinstance(got[key], torch.Tensor) \
            else np.asarray(got[key])
        w = np.asarray(want[key])
        assert g.shape == w.shape, (key, g.shape, w.shape)
        if key in ("boxes", "scores"):
            np.testing.assert_allclose(g, w, rtol=0, atol=DET_ATOL,
                                       err_msg=key)
        else:
            np.testing.assert_array_equal(g, w, err_msg=key)


# --------------------------------------------------------------------------
# the inputs
# --------------------------------------------------------------------------

@pytest.mark.parametrize("img,batch", [(64, 2), (384, 16)])
def test_train_batch_is_bench_py_batch(img, batch):
    got = TB.train_batch(img, batch)
    want = bench._train_batch(img, batch)
    assert set(got) == set(want)
    for k in want:
        w = np.asarray(want[k])
        assert got[k].dtype == w.dtype, k
        np.testing.assert_array_equal(got[k], w, err_msg=k)


class _Captured(Exception):
    pass


def test_decode_inputs_are_bench_py_inputs(monkeypatch):
    """`bench.py::bench_decode_nms` run until its first decode, un-jitted,
    so that the level outputs it draws are caught as arrays."""
    caught = []

    def catch(outs, **kw):
        caught.append([np.asarray(o) for o in outs])
        raise _Captured

    monkeypatch.setattr(jax, "jit", lambda fn, **kw: fn)
    monkeypatch.setattr(JP, "fcos_decode", catch)
    with pytest.raises(_Captured):
        bench.bench_decode_nms()
    got = TD.decode_inputs()
    assert len(got) == len(caught[0]) == 5
    for g, w in zip(got, caught[0]):
        assert g.dtype == w.dtype == np.float32
        np.testing.assert_array_equal(g, w)
    assert sum(g.shape[1] * g.shape[2] for g in got) == 5456


# --------------------------------------------------------------------------
# the training step
# --------------------------------------------------------------------------

STEP_IMG, STEP_BATCH = 64, 8   # batch 8: the subset of 4 takes 2 images
CONFIGS = {"default": {}, "bnsubset4": {"DETECTAX_BN_STAT_SUBSET": "4"},
           "freeze_bn": {"BENCH_FREEZE_BN": "1"}}


@pytest.mark.parametrize("config", list(CONFIGS))
def test_first_step_matches_bench_py_step(monkeypatch, config):
    for k, v in CONFIGS[config].items():
        monkeypatch.setenv(k, v)
    jstep, jstate = bench._make_train_setup(STEP_IMG, STEP_BATCH, "tiny")
    freeze = os.environ.get("BENCH_FREEZE_BN") == "1"
    setup = TB.make_train_setup(STEP_IMG, STEP_BATCH, "tiny",
                                freeze_bn=freeze, device="cpu")
    assert setup.state.model.freeze_bn == freeze
    FF.load_train_state(setup.state, _np(jstate.params),
                        _np(jstate.batch_stats),
                        opt_state=_np(jstate.opt_state), step=0)
    jbatch = bench._train_batch(STEP_IMG, STEP_BATCH)
    _, jm = jstep(jstate, jbatch)
    _, tm = setup.step(setup.state, setup.batch)
    assert all(p.dtype == torch.float32
               for p in setup.state.model.parameters())
    assert float(tm["num_pos"]) == float(jm["num_pos"]) > 0
    for k in ("total", "grad_norm"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                   rtol=STEP_RTOL, err_msg=k)


def _conv_hook_count(setup) -> tuple[int, int]:
    """(operations of one step counted from every convolution call's
    shapes, calls whose input needs no gradient). A call computes
    2·N·C_out·H_out·W_out·(C_in/groups)·k_h·k_w forward; its backward the
    weight gradient (as much again) and, where its input needs one, the
    input gradient (as much again)."""
    total, no_input_grad = 0, 0

    def hook(mod, args, out):
        nonlocal total, no_input_grad
        n, c_out, h, w = out.shape
        c_in_group, kh, kw = mod.weight.shape[1:]
        fwd = 2 * n * c_out * h * w * c_in_group * kh * kw
        assert c_in_group == mod.in_channels // mod.groups
        if args[0].requires_grad:
            total += 3 * fwd
        else:
            total += 2 * fwd
            no_input_grad += 1

    handles = [m.register_forward_hook(hook)
               for m in setup.state.model.modules()
               if isinstance(m, torch.nn.Conv2d)]
    try:
        setup.step(setup.state, setup.batch)
    finally:
        for h in handles:
            h.remove()
    return total, no_input_grad


def test_step_flops_is_the_convolutions_count():
    counts = {}
    for dtype in (torch.float32, torch.bfloat16):
        for batch in (1, 2):
            def setup():
                return TB.make_train_setup(64, batch, "tiny", device="cpu",
                                           dtype=dtype)
            flops = TB.step_flops(setup())
            want, stems = _conv_hook_count(setup())
            assert stems == 1   # the stem: its input is the image
            assert isinstance(flops, int) and flops == want, (dtype, batch)
            counts[dtype, batch] = flops
    assert counts[torch.float32, 1] == counts[torch.bfloat16, 1]
    assert counts[torch.float32, 2] == counts[torch.bfloat16, 2]
    assert counts[torch.float32, 2] == 2 * counts[torch.float32, 1]


def test_train_line_keeps_bench_py_keys_and_formulas(monkeypatch, capsys):
    """Both lines from the same step count, step time and loss: bench.py's
    printed line with the peak set to the port's, against `train_line`."""
    flops, sec, total, per, windows = 2_788_000_000_000, 0.1234, 4.56789, 5, 3
    monkeypatch.setattr(bench, "PEAK_BF16_FLOPS", TB.PEAK_BF16_FLOPS)
    monkeypatch.setattr(bench, "_make_train_setup", lambda *a: (None, None))
    monkeypatch.setattr(bench, "_train_batch", lambda *a: None)
    monkeypatch.setattr(bench, "_step_flops", lambda *a: float(flops))
    monkeypatch.setattr(bench, "_timed_sec_per_step",
                        lambda *a: (sec, total, per))
    bench._print_train_line("m", 384, 16, 15, windows, "resnet50", note="n")
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])

    class Setup:
        batch = {"images": torch.zeros(1)}
    monkeypatch.setattr(TB, "make_train_setup", lambda *a, **k: Setup)
    monkeypatch.setattr(TB, "step_flops", lambda s: flops)
    monkeypatch.setattr(TB, "timed_sec_per_step",
                        lambda s, steps, w: (sec, total, per, [sec] * w))
    got = TB.train_line("m", 384, 16, 15, windows, "resnet50", note="n",
                        device="cpu")
    assert set(want) <= set(got)
    assert set(want["detail"]) <= set(got["detail"])
    for k in ("metric", "value", "unit", "vs_baseline", "mfu_pct"):
        assert got[k] == want[k], k
    for k, v in want["detail"].items():
        if k != "device":
            assert got["detail"][k] == v, k
    assert got["detail"]["step_flops"] == flops
    assert got["detail"]["window_sec_per_step"] == [sec] * windows
    assert "not a TPU figure" in got["detail"]["baseline"]
    assert got["mfu_pct"] == round(100 * flops / sec / 989e12, 1)


def test_timed_windows_protocol():
    """3 warm-up steps, then windows of steps // windows steps, each
    window's time kept; the state advances by every step taken."""
    setup = TB.make_train_setup(64, 2, "tiny", device="cpu")
    sec, total, per, times = TB.timed_sec_per_step(setup, 5, 2)
    assert per == 2 and len(times) == 2 and sec == min(times) > 0
    assert setup.state.step == TB.WARMUP_STEPS + 4
    assert np.isfinite(total)


# --------------------------------------------------------------------------
# decode + NMS, and the serving function
# --------------------------------------------------------------------------

def test_decode_line_path_matches_jax_fused_path():
    outs = TD.decode_inputs()
    assert TP.resolve_fused(None, torch.device("cpu"), kernels="plain")
    with torch.no_grad():
        got = TD.decode_and_nms([torch.from_numpy(o) for o in outs],
                                kernels="plain")
    boxes, probs = JP.fcos_decode([jnp.asarray(o) for o in outs])
    want = JP.detections_from_dense(
        boxes, probs, top_k=1024, max_outputs=100, score_thresh=0.05,
        fused=True)
    assert int(want["num_valid"][0]) > 10
    assert_dets_equal(got, want)


def test_serving_fn_matches_jax_serving_fn():
    args = TSv.parse_args(["--backbone", "tiny", "--canvas", "64",
                           "--no-bf16", "--buckets", "1", "2"])
    assert (args.family, args.num_classes, args.top_k) == ("fcos", 8, 1024)
    jmodel, jdecode = JEval.build_family(args.family, args.num_classes,
                                         args.backbone, args.canvas, args)
    variables = jmodel.init(jax.random.key(0),
                            jnp.zeros((1, args.canvas, args.canvas, 3)),
                            train=False)
    params = _np(variables["params"])
    stats = _np(variables["batch_stats"])
    # class logits near 0 so that detections pass the 0.05 threshold
    for name, sub in params.items():
        if name.startswith("cls_head"):
            sub["Conv_0"]["bias"] = np.full_like(sub["Conv_0"]["bias"], -1.0)
    jfn = jax.jit(JE.make_serving_fn(jmodel, jdecode, top_k=args.top_k))
    model, fn = TSv.build_serving(args, "cpu")
    FF.load_flax(model, params, stats)
    rng = np.random.default_rng(0)
    for b in args.buckets:
        images = rng.uniform(-1, 1, (b, args.canvas, args.canvas, 3)) \
            .astype(np.float32)
        with torch.no_grad():
            got = fn(torch.from_numpy(images))
        want = jfn(params, stats, jnp.asarray(images))
        assert (np.asarray(want["num_valid"]) > 0).all()
        assert_dets_equal(got, want)


# --------------------------------------------------------------------------
# the profile's sums
# --------------------------------------------------------------------------

def _op(id, name, thread, start, end, flops=0, seq=-1, fwd_thread=0):
    return {"kind": "op", "id": id, "name": name, "thread": thread,
            "start": start, "end": end, "flops": flops, "seq": seq,
            "fwd_thread": fwd_thread}


def _kernel(name, start, end, op):
    return {"kind": "kernel", "name": name, "start": start, "end": end,
            "op": op}


def test_profile_summarize_hand_made_events():
    """One step on two host threads (1: main, 2: autograd's): each kernel's
    category and phase are known, so every sum is exact."""
    events = [
        _op(1, TPS.STEP, 1, 0, 1000),
        _op(2, TPS.ASSIGN, 1, 10, 100),
        _op(3, "aten::gt", 1, 20, 30),
        _op(4, TPS.FORWARD, 1, 100, 400),
        _op(5, TPS.FORWARD + "/backbone", 1, 110, 300),
        _op(6, "aten::conv2d", 1, 120, 180, flops=4_000_000_000),
        _op(7, "aten::cudnn_convolution", 1, 130, 170),
        _op(8, TPS.BATCHNORM, 1, 200, 250),
        _op(9, "aten::sub", 1, 210, 220, seq=7),
        _op(10, "aten::cat", 1, 380, 390),
        _op(11, TPS.LOSS, 1, 400, 450),
        _op(12, "detectax_torch::focal_group", 1, 410, 420),
        _op(13, "autograd::engine::evaluate_function: SubBackward0", 2,
            460, 470, seq=7, fwd_thread=1),
        _op(14, "aten::neg", 2, 461, 462),
        _op(15, "autograd::engine::evaluate_function: "
                "ConvolutionBackward0", 2, 470, 490, seq=8, fwd_thread=1),
        _op(16, "aten::convolution_backward", 2, 471, 489),
        _op(17, "aten::linalg_vector_norm", 1, 500, 510),
        _op(18, "Optimizer.step#SGD.step", 1, 520, 600),
        _op(19, "aten::_foreach_add_", 1, 530, 540),
        # device kernels (microseconds; two overlap in time)
        _kernel("vectorized_elementwise_kernel<4, gt>", 40, 50, 3),
        _kernel("sm90_xmma_fprop_implicit_gemm_bf16", 140, 200, 7),
        _kernel("nchwToNhwcKernel", 200, 205, 7),
        _kernel("vectorized_elementwise_kernel<4, sub>", 230, 240, 9),
        _kernel("CatArrayBatchedCopy", 395, 397, 10),
        _kernel("_Z16focal_fwd_kernel5Tableff", 430, 436, 12),
        _kernel("vectorized_elementwise_kernel<4, neg>", 465, 469, 14),
        _kernel("sm90_xmma_dgrad_implicit_gemm", 480, 510, 16),
        _kernel("sm90_xmma_wgrad_implicit_gemm", 500, 540, 16),
        _kernel("reduce_kernel<512, 1>", 545, 555, 17),
        _kernel("multi_tensor_apply_kernel", 560, 580, 19),
        _kernel("Memset (Device)", 990, 1010, 999),   # no launching op
    ]
    s = TPS.summarize(events, top=3)
    cat = {k: (v["ms"], v["n"]) for k, v in s["by_category"].items()}
    assert cat == {
        "conv/gemm": (0.130, 3),
        "elementwise": (0.030, 2),
        "batchnorm": (0.014, 2),
        "copy/memset/fill": (0.027, 3),
        "reduction/pooling": (0.010, 1),
        "port:focal_fwd_kernel": (0.006, 1),
    }
    phase = {k: (v["ms"], v["n"]) for k, v in s["by_phase"].items()}
    assert phase == {
        "backward": (0.074, 3),
        "forward:backbone": (0.075, 3),
        "update": (0.020, 1),
        "unattributed": (0.020, 1),
        "assign": (0.010, 1),
        "other": (0.010, 1),
        "loss": (0.006, 1),
        "forward": (0.002, 1),
    }
    assert list(s["by_phase"])[0] in ("backward", "forward:backbone")
    assert s["device_ms"] == pytest.approx(0.217, abs=1e-12)
    assert sum(v["ms"] for v in s["by_category"].values()) == \
        pytest.approx(s["device_ms"], abs=1e-12)
    assert sum(v["pct"] for v in s["by_phase"].values()) == \
        pytest.approx(100.0)
    # the conv2d's 4e9 operations go to its longest kernel (60 us)
    assert s["by_category"]["conv/gemm"]["tflops_per_s"] == \
        pytest.approx(4e9 / 130e-6 / 1e12)
    # busy: the union; [480, 540] merges the dgrad and wgrad kernels
    assert s["busy_ms"] == pytest.approx(0.207, abs=1e-12)
    assert s["window_ms"] == pytest.approx(1.010, abs=1e-12)
    assert s["idle_share"] == pytest.approx(1 - 207 / 1010)
    assert s["kernels"] == 12
    assert [k["name"] for k in s["top_kernels"]] == [
        "sm90_xmma_fprop_implicit_gemm_bf16",
        "sm90_xmma_wgrad_implicit_gemm", "sm90_xmma_dgrad_implicit_gemm"]


def test_profile_records_of_a_real_trace():
    """`events_from_profiler` on a CPU trace of a forward under the
    script's ranges and its backward: the ranges nest the operators, the
    backward node of the BatchNorm range's subtraction finds it by its
    sequence number, and the profiler's multiply count is kept. Device
    kernels are added by hand, each linked to a traced operator."""
    from torch.profiler import ProfilerActivity, profile

    x = torch.randn(4, 8, requires_grad=True)
    with profile(activities=[ProfilerActivity.CPU], with_flops=True) as prof:
        with torch.autograd.profiler.record_function(TPS.FORWARD + "/a"):
            y = x * 3.0
            with torch.autograd.profiler.record_function(TPS.BATCHNORM):
                z = y - 1.0
        z.sum().backward()
    events, ranges = TPS.events_from_profiler(prof)
    assert {TPS.FORWARD + "/a", TPS.BATCHNORM} <= ranges
    ops = [e for e in events if e["kind"] == "op"]
    assert not [e for e in events if e["kind"] == "kernel"]
    mul = next(o for o in ops if o["name"] == "aten::mul")
    sub = next(o for o in ops if o["name"] == "aten::sub")
    bwd = next(o for o in ops if o["name"].startswith(TPS.BACKWARD_PREFIX)
               and "SubBackward0" in o["name"])
    assert mul["flops"] == 32 and sub["seq"] >= 0
    assert (bwd["seq"], bwd["fwd_thread"]) == (sub["seq"], sub["thread"])
    events += [
        _kernel("vectorized_elementwise_kernel<mul>", 1e9, 1e9 + 5,
                mul["id"]),
        _kernel("vectorized_elementwise_kernel<sub>", 1e9 + 5, 1e9 + 7,
                sub["id"]),
        _kernel("vectorized_elementwise_kernel<neg>", 1e9 + 7, 1e9 + 10,
                bwd["id"])]
    s = TPS.summarize(events)
    assert {k: v["n"] for k, v in s["by_phase"].items()} == \
        {"forward:a": 2, "backward": 1}
    assert {k: v["n"] for k, v in s["by_category"].items()} == \
        {"elementwise": 1, "batchnorm": 2}
    assert s["by_category"]["elementwise"]["tflops_per_s"] == \
        pytest.approx(32 / 5e-6 / 1e12)


def test_profile_summarize_refuses_a_trace_without_kernels():
    with pytest.raises(ValueError, match="no device kernel"):
        TPS.summarize([_op(1, TPS.STEP, 1, 0, 10)])


# --------------------------------------------------------------------------
# the entry points without a card
# --------------------------------------------------------------------------

LEVER_PROGRAMS = ("mfu_breakdown", "config_frontier", "s2d_ab", "pool_ab",
                  "latency_reconcile", "diag_export")


@pytest.mark.parametrize("cmd", [
    ["bench_torch.py"], ["-m", "detectax_torch.bench.serving"],
    ["-m", "detectax_torch.bench.profile_step"],
    *(["-m", f"detectax_torch.bench.{m}"] for m in LEVER_PROGRAMS)],
    ids=["bench_torch", "serving", "profile_step", *LEVER_PROGRAMS])
def test_entry_points_need_a_cuda_device(cmd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run([sys.executable, *cmd], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode != 0, res.stdout + res.stderr
    lines = [json.loads(ln) for ln in res.stdout.splitlines()
             if ln.startswith("{")]
    assert all(ln.get("metric") == "bench_backend_unreachable"
               for ln in lines), res.stdout
    assert "profile_step_summary" not in res.stdout
    if cmd == ["bench_torch.py"]:
        assert len(lines) == 1, res.stdout
        assert "CUDA" in lines[0]["detail"]["reason"]
    else:
        assert not lines and "needs a CUDA device" in res.stderr
