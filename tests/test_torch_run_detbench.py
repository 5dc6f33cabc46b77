"""The port's DetBench driver and merge tool against the JAX programs, on
the CPU, with no trainer run.

- command parity: `benchmarks/run_detbench.py`'s `main`, its `run`
  replaced by a recorder that writes a fake eval.json, for all eight
  families x the three benchmarks x ``--bf16``/``--no-bf16``; its argvs
  equal the port's `family_commands` (and what the port's loop hands its
  runner) once ``detectax.cli.`` is read ``detectax_torch.cli.``, the JAX
  trunk path the port's ``--trunk`` and the JAX run directories the
  port's (``benchmarks/runs[_<suffix>]`` -> ``runs_torch/detbench[_<suffix>]``);
- every port argv parses under its CLI's own parser;
- a fake runner failing one family's training and another's evaluation
  gives the JAX driver's results JSON, resuming from an existing file;
- `merge_eval_into_results` equals the JAX script on the same files,
  the stale and new-family refusals included;
- without a CUDA device the driver exits 1 before any subprocess.
"""
import argparse
import importlib
import json
import os
import subprocess
import sys
import types
from unittest import mock

import pytest

from detectax_torch.bench import merge_eval_into_results as TM
from detectax_torch.bench import run_detbench as TR

with mock.patch.dict(os.environ):   # the JAX driver sets a cache path
    import benchmarks.merge_eval_into_results as JM
    import benchmarks.run_detbench as JR

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_TRUNK = "benchmarks/runs/pretrain_mbv2/backbone.msgpack"
BENCHES = ("detbench", "detbench_v2", "detbench_v2_crowd")
SUMMARY = {"mAP@0.5": 0.5, "mAP@[.5:.95]": 0.25, "num_images": 256}


def _fake_runner(calls, *, fail=()):
    """Records each argv; writes SUMMARY where an evaluation is asked for
    one; exits 3 for the (family, stage) pairs in ``fail``."""
    def runner(cmd, log_path):
        calls.append(list(cmd))
        module = cmd[cmd.index("-m") + 1]
        stage = "eval" if module.endswith(".evaluate") else "train"
        fam = (cmd[cmd.index("--family") + 1] if stage == "eval"
               else os.path.basename(os.path.dirname(
                   cmd[cmd.index("--ckpt_dir") + 1])))
        if (fam, stage) in fail:
            return 3
        if stage == "eval":
            with open(cmd[cmd.index("--out_json") + 1], "w") as f:
                json.dump(SUMMARY, f)
        return 0
    return runner


@pytest.fixture
def roots(tmp_path, monkeypatch):
    """The JAX driver's repository root and the port's runs directory,
    both under ``tmp_path``; a clock that stands still in both."""
    jroot, troot = tmp_path / "jax", tmp_path / "port"
    monkeypatch.setattr(JR, "REPO", str(jroot))
    monkeypatch.setattr(TR, "RUNS", str(troot / "runs_torch"))
    clock = types.SimpleNamespace(time=lambda: 1000.0)
    monkeypatch.setattr(JR, "time", clock)
    monkeypatch.setattr(TR, "time", clock)
    return jroot, troot


def _port_args(argv, trunk):
    return TR.parse_args(argv + ["--trunk", trunk])


def _jax_dirs(jroot, bench):
    suffix = "" if bench == "detbench" else "_" + bench.replace(
        "detbench_", "")
    return str(jroot / "benchmarks" / f"runs{suffix}")


def _to_port(cmd, jroot, troot, bench, trunk):
    suffix = "" if bench == "detbench" else "_" + bench.replace(
        "detbench_", "")
    jdir = _jax_dirs(jroot, bench)
    tdir = str(troot / "runs_torch" / f"detbench{suffix}")
    out = []
    for a in cmd:
        a = a.replace("detectax.cli.", "detectax_torch.cli.")
        if a == JAX_TRUNK:
            a = trunk
        elif a.startswith(jdir + os.sep):
            a = tdir + a[len(jdir):]
        out.append(a)
    return out


@pytest.mark.parametrize("bf16", ["--bf16", "--no-bf16"])
@pytest.mark.parametrize("bench", BENCHES)
def test_commands_equal_the_jax_drivers(roots, monkeypatch, bench, bf16):
    jroot, troot = roots
    trunk = str(troot / "trunk.npz")
    jcalls = []
    monkeypatch.setattr(JR, "run", _fake_runner(jcalls))
    argv = ["--bench", bench, bf16]
    JR.main(argv)
    assert len(jcalls) == 2 * len(JR.FAMILIES)
    want = [_to_port(c, jroot, troot, bench, trunk) for c in jcalls]

    args = _port_args(argv, trunk)
    assert list(TR.FAMILIES) == list(JR.FAMILIES)
    got = []
    for fam in args.families:
        got += TR.family_commands(fam, args)
    assert got == want
    tcalls = []
    results = TR.run_families(args, _fake_runner(tcalls))
    assert tcalls == want
    assert set(results) == set(JR.FAMILIES)
    # the port writes under its runs directory, never under benchmarks/
    assert args.out.startswith(str(troot / "runs_torch"))
    assert sum(JAX_TRUNK in c for c in jcalls) == 2
    assert sum(trunk in c for c in got) == 2


def test_every_argv_parses_under_its_cli(roots):
    """Each train and evaluate argv of every family and benchmark is
    accepted by the port CLI's own parser (the program stops right after
    parsing)."""
    _, troot = roots
    trunk = str(troot / "trunk.npz")

    class Parsed(Exception):
        pass

    original = argparse.ArgumentParser.parse_args

    def parse_then_stop(self, argv=None, namespace=None):
        raise Parsed(original(self, argv, namespace))

    cmds = [(bench, fam, cmd) for bench in BENCHES
            for fam in TR.FAMILIES
            for cmd in TR.family_commands(
                fam, _port_args(["--bench", bench], trunk))]
    assert len(cmds) == 3 * 2 * len(TR.FAMILIES)
    with mock.patch.object(argparse.ArgumentParser, "parse_args",
                           parse_then_stop):
        for bench, fam, cmd in cmds:
            module = importlib.import_module(cmd[3])
            with pytest.raises(Parsed) as parsed:
                module.main(cmd[4:])
            ns = parsed.value.args[0]
            assert ns.dataset == bench
            if cmd[3].endswith(".evaluate"):
                assert ns.family == fam
            else:
                assert ns.bf16 is True
                assert (getattr(ns, "init_backbone", None) == trunk) == (
                    fam in ("fcos_center", "centernet_s8"))


def test_results_equal_the_jax_drivers_under_a_failing_runner(roots,
                                                              monkeypatch):
    jroot, troot = roots
    trunk = str(troot / "trunk.npz")
    fail = {("retinanet", "train"), ("hourglass", "eval")}
    existing = {"stacked_hourglass": {"mAP@0.5": 0.8, "train_steps": 4000},
                "fcos": {"error": "train rc=1"}}
    jout = jroot / "benchmarks" / "RESULTS_detbench_v1.json"
    jout.parent.mkdir(parents=True)
    jout.write_text(json.dumps(existing))
    args = _port_args(["--families", "fcos", "retinanet", "hourglass",
                       "centernet_s8", "--steps", "7"], trunk)
    os.makedirs(os.path.dirname(args.out))
    with open(args.out, "w") as f:
        json.dump(existing, f)

    monkeypatch.setattr(JR, "run", _fake_runner([], fail=fail))
    JR.main(["--families", "fcos", "retinanet", "hourglass",
             "centernet_s8", "--steps", "7"])
    got = TR.run_families(args, _fake_runner([], fail=fail))
    want = json.loads(jout.read_text())
    assert got == want
    with open(args.out) as f:
        assert json.load(f) == want
    assert want["retinanet"] == {"error": "train rc=3"}
    assert want["hourglass"] == {"error": "eval rc=3", "train_min": 0.0}
    assert want["stacked_hourglass"] == existing["stacked_hourglass"]
    assert want["fcos"]["train_steps"] == 7


# --------------------------------------------------------------------------
# the merge tool
# --------------------------------------------------------------------------

def _merge_files(root, *, eval_newer=True):
    root.mkdir()
    results = {"centernet_s8": {"mAP@0.5": 0.7, "train_steps": 4000,
                                "train_min": 65.0, "backbone": "mobilenetv2",
                                "recipe": "pretrain-ft", "AP_small": 0.1}}
    rpath, epath = root / "RESULTS.json", root / "eval.json"
    rpath.write_text(json.dumps(results))
    epath.write_text(json.dumps({"mAP@0.5": 0.75, "AP_small": 0.2,
                                 "train_steps": 1}))
    t = 1_700_000_000
    os.utime(rpath, (t, t))
    os.utime(epath, (t + 10, t + 10) if eval_newer else (t - 10, t - 10))
    return str(rpath), str(epath)


@pytest.mark.parametrize("case", ["merge", "stale", "allow_stale", "new",
                                  "allow_new"])
def test_merge_equals_the_jax_script(tmp_path, capsys, case):
    fam = "retinanet" if case in ("new", "allow_new") else "centernet_s8"
    flags = {"allow_stale": ["--allow_stale"],
             "allow_new": ["--allow_new"]}.get(case, [])
    outcomes = []
    for name, mod in (("jax", JM), ("port", TM)):
        rpath, epath = _merge_files(tmp_path / name,
                                    eval_newer=case not in ("stale",
                                                            "allow_stale"))
        try:
            mod.main([rpath, fam, epath, *flags])
            error = None
        except SystemExit as e:
            error = str(e).replace(str(tmp_path / name), "<dir>")
        with open(rpath) as f:
            outcomes.append((error, json.load(f),
                             capsys.readouterr().out))
    assert outcomes[0] == outcomes[1]
    error, results, printed = outcomes[1]
    if case in ("stale", "new"):
        assert error and results["centernet_s8"]["mAP@0.5"] == 0.7
        assert ("STALE MERGE REFUSED" in error) == (case == "stale")
    else:
        assert error is None and results[fam]["mAP@0.5"] == 0.75
        assert printed.startswith(f"merged {fam}: mAP@0.5=0.75")
        if fam == "centernet_s8":
            assert results[fam]["train_steps"] == 4000
            assert results[fam]["recipe"] == "pretrain-ft"


def test_driver_needs_a_cuda_device_before_any_subprocess(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    out = tmp_path / "RESULTS.json"
    res = subprocess.run(
        [sys.executable, "-m", "detectax_torch.bench.run_detbench",
         "--families", "fcos", "--steps", "1", "--run_root",
         str(tmp_path / "runs"), "--out", str(out)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 1, res.stdout + res.stderr
    assert "needs a CUDA device" in res.stderr
    assert not out.exists() and not (tmp_path / "runs").exists()
    assert "training" not in res.stdout
