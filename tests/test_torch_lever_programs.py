"""The port's last measurement programs against the JAX programs, on the CPU.

`detectax_torch.bench.mfu_breakdown`, `config_frontier`, `s2d_ab`,
`pool_ab`, `latency_reconcile` and `diag_export` are held against
`benchmarks/*.py` of the same names:

- `bench.train.build`'s batch equals `benchmarks/mfu_breakdown.py::
  build`'s arrays exactly; on the same weights (a float32 tiny FCOS: the
  JAX program's model is bf16, whose rounding two frameworks do not
  share) the port's ``forward+loss`` graph gives the JAX program's
  ``fwd_loss`` to `LOSS_RTOL` and its ``assign`` graph the JAX one's
  (owners and one-hots exactly, the regression targets to
  `tests/test_torch_assign.py`'s 1e-6);
- every arm's rebuild of the flagship FCOS-R50, under ``freeze_bn``, float32
  or the environment's switches, starts from the same weights;
- the rows' arithmetic (the phases and the two derived rows, a canvas
  row, a configuration row) is the JAX programs', on the same seconds and
  operation counts;
- `CONFIGS`, the arms of `s2d_ab` and `pool_ab` and every program's JSON
  keys are the JAX programs' (importing the modules runs nothing); the
  deviations are named: the ``levers`` arms, ``arm_step_tflops``, and
  ``replay_vs_eager`` without the JAX program's ``jit`` arm;
- `latency_reconcile`'s inputs are the JAX draws, and one application's
  detections on the CPU (the fused path on its plain version) equal JAX's
  fused path;
- `diag_export`'s report for a tiny FCOS (exported on the CPU with
  ``fused=True``: the two-stage NMS would be unrolled) has its keys, the
  replay equal to the live graph, and its weights-file loading.

Without a card the entry points exit 1: `tests/test_torch_bench.py::
test_entry_points_need_a_cuda_device`.
"""
import argparse
import json
import os
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detectax.infer import predict as JP
from detectax.models import FCOS as JFCOS
from detectax_torch.bench import _levers
from detectax_torch.bench import config_frontier as TCF
from detectax_torch.bench import decode as TD
from detectax_torch.bench import diag_export as TDE
from detectax_torch.bench import latency_reconcile as TLR
from detectax_torch.bench import mfu_breakdown as TMB
from detectax_torch.bench import pool_ab as TPA
from detectax_torch.bench import s2d_ab as TSA
from detectax_torch.bench import train as TB
from detectax_torch.models import FCOS
from detectax_torch.tools import from_flax as FF

with mock.patch.dict(os.environ):   # the JAX programs set a cache path
    import benchmarks.config_frontier as JCF
    import benchmarks.latency_reconcile as JLR
    import benchmarks.mfu_breakdown as JMB
    import benchmarks.pool_ab as JPA
    import benchmarks.s2d_ab as JSA

LOSS_RTOL = 1e-5
ASSIGN_ATOL = 1e-6   # tests/test_torch_assign.py's
IMG, BATCH = 64, 2


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


def _last_json(capsys) -> dict:
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


# --------------------------------------------------------------------------
# build, and the graphs on the same weights
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_build():
    return JMB.build(IMG, BATCH, "tiny")


def test_build_batch_is_the_jax_build_batch(jax_build):
    _, _, want = jax_build
    parts, state, got = TB.build(IMG, BATCH, "tiny", device="cpu")
    assert set(got) == set(want)
    for k in want:
        w = np.asarray(want[k])
        assert got[k].numpy().dtype == w.dtype, k
        np.testing.assert_array_equal(got[k].numpy(), w, err_msg=k)
    assert parts.model.compute_dtype == torch.bfloat16
    assert parts.raw_step is not None and state.step == 0


@pytest.fixture(scope="module")
def flagship_weights():
    parts, _, _ = TB.build(IMG, BATCH, device="cpu")
    return parts.model.state_dict()


@pytest.mark.parametrize("kw,env", [
    ({"freeze_bn": True, "dtype": torch.float32}, {}),
    ({}, {"DETECTAX_BN_BF16_STATS": "1", "DETECTAX_BN_STAT_SUBSET": "4"}),
    ({}, {"DETECTAX_S2D_STEM": "1", "DETECTAX_POOL_VJP": "1"})],
    ids=["freeze_bn_fp32", "bn_switches", "stem_switches"])
def test_every_arm_builds_the_same_weights(flagship_weights, monkeypatch,
                                           kw, env):
    """The lever programs rebuild the flagship FCOS-R50 an arm under the
    arm's switches: each build starts from the same parameters and
    statistics, as the JAX programs' arms share one state."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    parts, _, _ = TB.build(IMG, BATCH, device="cpu", **kw)
    got = parts.model.state_dict()
    assert list(got) == list(flagship_weights)
    for k, w in flagship_weights.items():
        assert torch.equal(got[k], w), k


def test_graphs_match_the_jax_graphs(jax_build):
    """`phase_breakdown`'s ``assign`` and ``forward+loss`` as the JAX
    program writes them (its closures), on the JAX state's weights."""
    jparts, jstate, jbatch = jax_build
    jmodel = JFCOS(num_classes=TB.NUM_CLASSES, backbone="tiny",
                   dtype=jnp.float32)
    assign_fn, loss_fn = jparts["assign_fn"], jparts["loss"]

    def assign_only(bd):
        return jax.vmap(assign_fn)(bd["boxes"], bd["labels"], bd["valid"])

    def fwd_loss(params, stats, bd):
        y_true = jax.vmap(assign_fn)(bd["boxes"], bd["labels"], bd["valid"])
        y_pred, _ = jmodel.apply({"params": params, "batch_stats": stats},
                                 bd["images"], train=True,
                                 mutable=["batch_stats"])
        return loss_fn(y_true, y_pred)["total"] / len(bd["images"])

    want_loss = float(jax.jit(fwd_loss)(jstate.params, jstate.batch_stats,
                                        jbatch))
    want_targets = jax.jit(assign_only)(jbatch)

    parts, state, data = TB.build(IMG, BATCH, "tiny", device="cpu",
                                  dtype=torch.float32)
    FF.load_flax(parts.model, _np(jstate.params), _np(jstate.batch_stats))
    graphs = TMB.phase_graphs(parts)
    assert list(graphs) == ["assign", "forward", "forward+loss",
                            "grad(fwd+bwd)", "full step"]
    got_targets = graphs["assign"][0](state, data)
    assert len(got_targets) == len(want_targets) == 5
    for g, w in zip(got_targets, want_targets):
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype
        # `tests/test_torch_assign.py`'s rule: owners and class one-hots
        # exactly, the float regression targets to an ulp or so (XLA may
        # contract a multiply and an add)
        np.testing.assert_array_equal(g[..., 5:], w[..., 5:])
        np.testing.assert_array_equal(g[..., 4] == 1.0, w[..., 4] == 1.0)
        np.testing.assert_allclose(g[..., :5], w[..., :5], rtol=0,
                                   atol=ASSIGN_ATOL)
    got_loss = float(graphs["forward+loss"][0](state, data))
    assert np.isfinite(want_loss) and want_loss > 0
    np.testing.assert_allclose(got_loss, want_loss, rtol=LOSS_RTOL)
    # the gradient graph differentiates the same loss: one tensor a
    # parameter; the full step is the built train step
    grads = graphs["grad(fwd+bwd)"][0](state, data)
    assert len(grads) == len(list(parts.model.parameters()))
    assert graphs["full step"] == (parts.raw_step, True)


# --------------------------------------------------------------------------
# the rows' arithmetic and the JSON keys
# --------------------------------------------------------------------------

SECS = {"assign": 0.0031, "forward": 0.0412, "forward+loss": 0.0437,
        "grad(fwd+bwd)": 0.1093, "full step": 0.1246}
FLOPS = {"assign": 0, "forward": 930_000_000_000,
         "forward+loss": 930_000_000_000, "grad(fwd+bwd)": 2_788_000_000_000,
         "full step": 2_788_000_000_000}


class _FakeJit:
    """`jax.jit(fn)` as the JAX programs use it: ``.lower().compile()``
    gives the graph's name to the patched `_flops_of`."""

    def __init__(self, fn, names, **kw):
        self.name = next(names)

    def lower(self, *a):
        return self

    def compile(self):
        return self.name


def _jax_patched(monkeypatch, module, names, secs, flops):
    """``module``'s build, jit, timing and count replaced: each graph
    takes the next name of ``names`` and the seconds and count kept for
    it."""
    fake_jax = mock.MagicMock()
    fake_jax.jit = lambda fn, **kw: _FakeJit(fn, names, **kw)
    monkeypatch.setattr(module, "jax", fake_jax)
    monkeypatch.setattr(module, "build", lambda *a, **k: (
        {"model": None, "assign_fn": None, "loss": None, "raw_step": None},
        None, None))
    monkeypatch.setattr(module, "_time_fn",
                        lambda jfn, *a: secs[jfn.name])
    monkeypatch.setattr(module, "_flops_of", lambda name: flops[name])
    monkeypatch.setattr(module, "PEAK_BF16_FLOPS", _levers.PEAK_BF16_FLOPS)


def test_phase_rows_follow_the_jax_formulas(monkeypatch, capsys):
    _jax_patched(monkeypatch, JMB, iter(SECS), SECS, FLOPS)
    JMB.phase_breakdown(argparse.Namespace(steps=30, windows=3))
    want = _last_json(capsys)["phase_breakdown_384px_b16"]
    got = TMB.phase_rows({k: (SECS[k], FLOPS[k]) for k in SECS})
    assert got == want
    assert list(got)[-2:] == ["backward (grad - fwd+loss)",
                              "update (full - grad)"]
    assert got["assign"]["mfu_pct"] == 0.0   # no convolution, no matmul


def test_time_rounds_interleaves_the_graphs_windows(monkeypatch):
    """Every graph's two warm-up calls, then one window of each graph a
    round; each graph gets its least seconds a call and every window's,
    and a train step's window closes on the state's parameters."""
    calls, fetched = [], []
    ticks = iter(range(100))
    monkeypatch.setattr(_levers.time, "perf_counter",
                        lambda: float(next(ticks)))

    def graph(name):
        def fn(state, data):
            calls.append(name)
            return torch.full((1,), float(len(name)))
        return fn

    real_force = _levers.force
    monkeypatch.setattr(_levers, "force", lambda out, st=None: fetched.append(
        st is not None) or real_force(out, st))
    state = mock.Mock(model=torch.nn.Linear(1, 1))
    got = _levers.time_rounds({"a": (graph("a"), False),
                               "bb": (graph("bb"), True)},
                              state, {}, steps=4, windows=2)
    assert calls == ["a", "a", "bb", "bb"] + ["a", "a", "bb", "bb"] * 2
    assert fetched == [False, False, True, True] + [False, True] * 2
    # the clock ticks once at a window's start and once at its end
    assert got == {"a": (0.5, [0.5, 0.5]), "bb": (0.5, [0.5, 0.5])}
    assert _levers.time_fn(graph("c"), state, {}, 3, 3, False) == (
        1.0, [1.0, 1.0, 1.0])


def test_step_rows_follow_the_jax_formulas(monkeypatch, capsys):
    """A canvas row (`canvas_sweep`) and a configuration row
    (`config_frontier.measure`) from the same seconds and count."""
    sec, flops = {"c": 0.1234}, {"c": 2_788_000_000_000}
    _jax_patched(monkeypatch, JMB, iter(lambda: "c", None), sec, flops)
    JMB.canvas_sweep(argparse.Namespace(steps=30, windows=3))
    want = _last_json(capsys)["canvas_sweep_fcos_r50_b16"]
    arm = {"sec": sec["c"], "flops": flops["c"]}
    row = _levers.step_row(arm, 16)
    assert want["384px"] == {"ms_per_step": row["ms_per_step"],
                             "img_per_sec": row["img_per_sec"],
                             "step_tflops": round(flops["c"] / 1e12, 3),
                             "mfu_pct": row["mfu_pct"]}
    _jax_patched(monkeypatch, JCF, iter(lambda: "c", None), sec, flops)
    monkeypatch.setattr(JCF, "_time_fn", lambda jfn, *a: sec["c"])
    monkeypatch.setattr(JCF, "_flops_of", lambda name: flops["c"])
    with mock.patch.dict(os.environ):
        want = JCF.measure(argparse.Namespace(steps=30, windows=3),
                           "subset4_b32", {}, False, 32, {})
    capsys.readouterr()
    assert want == {"config": "subset4_b32", "batch": 32,
                    **_levers.step_row(arm, 32)}


def _fake_arm(steps, windows, device, **kw):
    return {"sec": 0.1, "window_sec": [0.1, 0.11], "flops": 10 ** 12,
            "count_env_flops": 9 * 10 ** 11}


@pytest.mark.parametrize("jmod,tmod,row_key,arm,summary", [
    (JSA, TSA, "s2d_stem", "s2d", "s2d_ab_fcos_r50_384_b16"),
    (JPA, TPA, "pool_vjp", "pool", "pool_ab_fcos_r50_384_b16")],
    ids=["s2d_ab", "pool_ab"])
def test_ab_programs_keep_the_jax_keys(monkeypatch, capsys, jmod, tmod,
                                       row_key, arm, summary):
    """The JAX program's arms and rows (its `measure` replaced by a row of
    its keys) against the port's (`_levers.step_arm` replaced); the
    switch is restored after."""
    def jmeasure(args, on, freeze_bn):
        return {row_key: on, "freeze_bn": freeze_bn, "ms_per_step": 1.0,
                "img_per_sec": 1.0, "mfu_pct": 1.0}

    monkeypatch.setattr(jmod, "measure", jmeasure)
    with mock.patch.dict(os.environ):
        jmod.main([])
    want = _last_json(capsys)[summary]
    monkeypatch.setattr(_levers, "step_arm", _fake_arm)
    monkeypatch.delenv(tmod.ENV_KEY, raising=False)
    line = tmod.run(argparse.Namespace(steps=2, windows=2), "cpu")
    assert tmod.ENV_KEY not in os.environ
    got = line[summary]
    assert list(got) == list(want) == [
        "base", arm, "base+freeze_bn", f"{arm}+freeze_bn"]
    extra = {"arm_step_tflops"} if tmod is TSA else set()
    for k in want:
        assert set(got[k]) == set(want[k]) | extra, k
        assert (got[k][row_key], got[k]["freeze_bn"]) == \
            (want[k][row_key], want[k]["freeze_bn"])
    if tmod is TSA:
        # mfu_pct over the plain stem's count; the arm's own beside it
        row = got["s2d"]
        assert row["mfu_pct"] == _levers.mfu_pct(9 * 10 ** 11, 0.1)
        assert row["arm_step_tflops"] == 1.0


def test_config_frontier_keeps_the_jax_configs(monkeypatch):
    assert TCF.CONFIGS == JCF.CONFIGS
    assert TCF.ENV_KEYS == JCF.ENV_KEYS
    seen = []

    def arm(steps, windows, device, *, batch, freeze_bn, **kw):
        seen.append((dict((k, os.environ[k]) for k in TCF.ENV_KEYS
                          if k in os.environ), freeze_bn, batch))
        return _fake_arm(steps, windows, device)

    monkeypatch.setattr(_levers, "step_arm", arm)
    monkeypatch.setenv("DETECTAX_BN_STAT_SUBSET", "2")
    line = TCF.run(argparse.Namespace(steps=2, windows=2,
                                      only=["base", "subset4_b32"]), "cpu")
    assert os.environ["DETECTAX_BN_STAT_SUBSET"] == "2"   # restored
    assert seen == [({}, False, 16),
                    ({"DETECTAX_BN_STAT_SUBSET": "4"}, False, 32)]
    rows = line["config_frontier_fcos_r50_384"]
    assert list(rows) == ["base", "subset4_b32"]
    assert set(rows["base"]) == {"config", "batch", "ms_per_step",
                                 "img_per_sec", "mfu_pct"}


def test_mfu_breakdown_prints_the_jax_keys(monkeypatch, capsys):
    """The three parts run for real at 64 px on a tiny FCOS (`build` sized
    down under the flagship's name), one step each: the JAX program's
    summary keys, rows and row keys; the levers' arms are the backend's
    switches (a deviation), each with its ``options``."""
    real_build = TB.build

    def tiny(img, batch, backbone="resnet50", **kw):
        return real_build(IMG, BATCH, "tiny", **kw)

    monkeypatch.setattr(TB, "build", tiny)
    before = torch.backends.cudnn.benchmark
    lines = TMB.run(TMB.parse_args(["--steps", "1", "--windows", "1"]),
                    "cpu")
    assert torch.backends.cudnn.benchmark == before
    assert TMB.failed_arms(lines) == []
    printed = [json.loads(ln) for ln in
               capsys.readouterr().out.strip().splitlines()]
    keys = [next(iter(ln)) for ln in printed]
    assert keys == ["phase_breakdown_384px_b16", "canvas_384", "canvas_512",
                    "canvas_640", "canvas_sweep_fcos_r50_b16",
                    "lever_baseline", "lever_cudnn_benchmark",
                    "compiler_levers_384px_b16"]
    for ln in (lines["phases"], lines["canvas"], lines["levers"]):
        assert {"window_ms", "device", "card", "flops_counted"} <= set(ln)
    phases = lines["phases"]["phase_breakdown_384px_b16"]
    assert list(phases) == list(SECS) + ["backward (grad - fwd+loss)",
                                         "update (full - grad)"]
    assert all(set(phases[k]) == {"ms", "tflops", "mfu_pct"} for k in SECS)
    assert phases["assign"]["tflops"] == 0.0
    assert phases["full step"]["tflops"] > phases["forward"]["tflops"] > 0
    canvas = lines["canvas"]["canvas_sweep_fcos_r50_b16"]
    assert list(canvas) == ["384px", "512px", "640px"]
    assert all(set(r) == {"ms_per_step", "img_per_sec", "step_tflops",
                          "mfu_pct"} for r in canvas.values())
    levers = lines["levers"]["compiler_levers_384px_b16"]
    assert list(levers) == list(TMB.LEVERS) == ["baseline",
                                                "cudnn_benchmark"]
    assert levers["cudnn_benchmark"]["options"] == {
        "torch.backends.cudnn.benchmark": True}
    assert all(set(r) == {"ms_per_step", "img_per_sec", "mfu_pct",
                          "options"} for r in levers.values())


def test_a_failed_lever_is_recorded_and_fails_the_program(monkeypatch):
    def boom(*a, **k):
        raise RuntimeError("refused")

    monkeypatch.setattr(_levers, "step_arm", boom)
    monkeypatch.setattr(TMB, "require_cuda", lambda name: "cpu")
    with pytest.raises(SystemExit) as e:
        TMB.main(["--only", "levers"])
    assert e.value.code == 1
    line = TMB.levers(argparse.Namespace(steps=1, windows=1), "cpu")
    rows = line["compiler_levers_384px_b16"]
    assert rows["baseline"] == {"error": "RuntimeError: refused",
                                "options": {}}


# --------------------------------------------------------------------------
# latency_reconcile and diag_export
# --------------------------------------------------------------------------

def test_latency_inputs_and_detections_are_the_jax_ones():
    _, want_outs = JLR.make_fn()
    got_outs = TD.decode_inputs()
    assert len(got_outs) == len(want_outs) == 5
    for g, w in zip(got_outs, want_outs):
        np.testing.assert_array_equal(g, np.asarray(w))
    boxes, probs = JP.fcos_decode(want_outs)
    want = JP.detections_from_dense(boxes, probs, top_k=1024,
                                    max_outputs=100, score_thresh=0.05,
                                    fused=True)
    outs = [torch.from_numpy(o) for o in got_outs]
    with torch.no_grad():
        got = TD.decode_and_nms(outs, kernels="plain")
    assert int(want["num_valid"][0]) > 10
    for k in ("classes", "valid", "num_valid"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    for k in ("boxes", "scores"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=1e-5)
    assert float(TLR.fetch(got)) == float(got["scores"][0, 0])
    line = TLR.reconcile_line(
        {"dispatch_only_ms": 0.01234, "amortized_fetch_ms": 1.23456,
         "device_chained_ms": 0.2, "graph_dense_nms_launches_at_capture":
         TLR.INNER}, torch.device("cpu"))
    jax_keys = {"metric", "dispatch_only_ms", "amortized_fetch_ms",
                "device_chained_ms", "record", "device"}
    assert jax_keys | {"card", "chained_in",
                       "graph_dense_nms_launches_at_capture"} == set(line)
    assert line["metric"] == "decode_nms_latency_protocols"
    assert line["amortized_fetch_ms"] == 1.235


# the keys of `benchmarks/diag_export.py`'s report that do not name its
# jit arm, which an eager program does not have
DIAG_JAX_KEYS = {"dense: replay_vs_eager", "serving: replay_vs_eager"}


def test_diag_export_report(tmp_path):
    model = FCOS(num_classes=3, backbone="tiny")
    with torch.no_grad():   # class logits that pass the score threshold
        for i in range(1, 6):
            getattr(model, f"cls_head_{i}").Conv_0.bias.fill_(-2.0)
    weights = str(tmp_path / "w.npz")
    FF.save_npz(weights, *FF.to_flax(model))
    args = TDE.parse_args(["--backbone", "tiny", "--num_classes", "3",
                           "--canvas", str(IMG), "--weights", weights])
    loaded, decode = TDE.load_model(args, "cpu")
    assert all(torch.equal(a, b) for a, b in zip(
        loaded.state_dict().values(), model.state_dict().values()))
    out = TDE.report(loaded, decode, TDE.images_for(IMG, "cpu"), fused=True)
    assert DIAG_JAX_KEYS <= set(out)
    assert set(out) == DIAG_JAX_KEYS | {
        "serving: num_valid (eager/replay)", "serving: top10 scores eager",
        "serving: score deltas eager-replay (first nv)", "device", "card"}
    assert set(out["dense: replay_vs_eager"]) == {"boxes", "probs"}
    assert set(out["serving: replay_vs_eager"]) == {
        "boxes", "scores", "classes", "valid", "num_valid"}
    nv = out["serving: num_valid (eager/replay)"]
    assert nv[0] == nv[1] > 0
    assert max(out["dense: replay_vs_eager"].values()) <= 1e-6
    assert out["serving: score deltas eager-replay (first nv)"] <= 1e-6
    assert len(out["serving: top10 scores eager"]) == 10
