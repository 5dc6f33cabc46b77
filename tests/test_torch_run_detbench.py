"""The port's DetBench driver and merge tool against the JAX programs, on
the CPU, with no trainer run but one.

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
- without a CUDA device the driver exits 1 before any subprocess;
- ``--resume`` and ``--seed N`` add the trainers' own flags to every
  training argv and nothing to an evaluate argv; a row stopped by SIGTERM
  and resumed sums its minutes and says where it resumed and with which
  seed, the other rows kept;
- a row resumed at 2,000 (and at 3,000), stopped at 4,000 and evaluated
  in a call that trains no step keeps its last training restart as
  ``resumed_from``, lists every restart and counts the training calls'
  minutes alone; the tiny stacked hourglass trainer resumed at its last
  step takes no step and rewrites no checkpoint.
"""
import argparse
import importlib
import json
import os
import signal
import subprocess
import sys
import time
import types
from unittest import mock

import pytest
import torch

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


@pytest.mark.parametrize("flags,added", [
    (["--resume"], ["--resume"]),
    (["--seed", "1"], ["--seed", "1"]),
    (["--resume", "--seed", "1"], ["--resume", "--seed", "1"])])
@pytest.mark.parametrize("bench", BENCHES)
def test_resume_and_seed_reach_every_trainer_and_no_evaluation(
        roots, bench, flags, added):
    _, troot = roots
    trunk = str(troot / "trunk.npz")
    plain = _port_args(["--bench", bench], trunk)
    flagged = _port_args(["--bench", bench, *flags], trunk)

    class Parsed(Exception):
        pass

    original = argparse.ArgumentParser.parse_args

    def parse_then_stop(self, argv=None, namespace=None):
        raise Parsed(original(self, argv, namespace))

    for fam in TR.FAMILIES:
        train0, eval0 = TR.family_commands(fam, plain)
        train1, eval1 = TR.family_commands(fam, flagged)
        assert train1 == train0 + added
        assert eval1 == eval0
        module = importlib.import_module(train1[3])
        with mock.patch.object(argparse.ArgumentParser, "parse_args",
                               parse_then_stop):
            with pytest.raises(Parsed) as parsed:
                module.main(train1[4:])
        ns = parsed.value.args[0]
        assert ns.resume == ("--resume" in flags)
        assert ns.seed == (1 if "--seed" in flags else 0)
        assert ns.dataset == bench and ns.max_steps == 4000


def test_a_stopped_row_resumes_with_its_minutes_and_seed(roots,
                                                        monkeypatch):
    """A stop (the driver's SIGTERM handler raises `Stopped`) in the middle
    of ``hourglass`` writes its row as stopped, with its minutes and its
    newest checkpoint; ``--resume --seed 1`` then trains it on and writes
    a row whose ``train_min`` sums the two runs, with ``train_min_calls``,
    ``resumed_from`` and ``seed``. The other rows stay as they were."""
    _, troot = roots
    trunk = str(troot / "trunk.npz")
    clock = types.SimpleNamespace(now=1000.0)
    monkeypatch.setattr(TR, "time",
                        types.SimpleNamespace(time=lambda: clock.now))
    existing = {"fcos": {"mAP@0.5": 0.73, "train_steps": 4000,
                         "train_min": 12.2}}
    base = ["--families", "hourglass", "fcos_center_v1"]
    args = _port_args(base, trunk)
    os.makedirs(os.path.dirname(args.out))
    with open(args.out, "w") as f:
        json.dump(existing, f)
    ckpt = os.path.join(args.run_root, "hourglass", "ckpt")

    def stopping(cmd, log_path):
        clock.now += 45.04 * 60
        os.makedirs(ckpt, exist_ok=True)
        open(os.path.join(ckpt, "ckpt_2000.pt"), "w").close()
        raise TR.Stopped(15)

    with pytest.raises(TR.Stopped):
        TR.run_families(args, stopping)
    with open(args.out) as f:
        stopped = json.load(f)
    assert stopped == {**existing, "hourglass": {
        "error": "train stopped", "train_min": 45.0,
        "checkpoint_step": 2000}}

    calls = []
    recorder = _fake_runner(calls)

    def resumed(cmd, log_path):
        if "--family" not in cmd:
            clock.now += 40.96 * 60
        return recorder(cmd, log_path)

    args = _port_args(base + ["--resume", "--seed", "1"], trunk)
    got = TR.run_families(args, resumed)
    assert [c[-3:] for c in calls[::2]] == [["--resume", "--seed", "1"]] * 2
    row = got["hourglass"]
    assert row["mAP@0.5"] == SUMMARY["mAP@0.5"]
    assert row["train_min"] == 86.0
    assert row["train_min_calls"] == [45.0, 41.0]
    assert row["resumed_from"] == 2000 and row["seed"] == 1
    # a row with no earlier run: no split, no checkpoint to resume from
    assert got["fcos_center_v1"]["train_min"] == 41.0
    assert "train_min_calls" not in got["fcos_center_v1"]
    assert "resumed_from" not in got["fcos_center_v1"]
    assert got["fcos_center_v1"]["seed"] == 1
    assert got["fcos"] == existing["fcos"]
    with open(args.out) as f:
        assert json.load(f) == got


@pytest.mark.parametrize("stops, resumed_from", [
    ([(2000, 42.5, "train"), (4000, 47.04, "train")], 2000),
    ([(2000, 42.5, "train"), (4000, 47.04, "eval")], 2000),
    ([(2000, 42.5, "train"), (3000, 23.0, "train"),
      (4000, 24.04, "train")], 3000),
], ids=["stopped_in_train", "stopped_in_eval", "restarted_at_3000"])
def test_a_row_evaluated_in_a_call_of_its_own_keeps_its_split(
        roots, monkeypatch, stops, resumed_from):
    """A row stopped at step 2,000 and resumed (and stopped again at
    3,000 in one case) until ``ckpt_4000.pt`` exists, stopped before its
    evaluation or during it, then resumed at 4,000 in a call that trains
    no step and only evaluates: the row keeps its last training restart
    as ``resumed_from`` (its loader restarted from the seed there),
    lists every restart, and its ``train_min`` sums the training calls
    alone."""
    _, troot = roots
    clock = types.SimpleNamespace(now=1000.0)
    monkeypatch.setattr(TR, "time",
                        types.SimpleNamespace(time=lambda: clock.now))
    args = _port_args(["--families", "stacked_hourglass"],
                      str(troot / "trunk.npz"))
    resume = _port_args(["--families", "stacked_hourglass", "--resume"],
                        str(troot / "trunk.npz"))
    ckpt = os.path.join(args.run_root, "stacked_hourglass", "ckpt")

    def stopping_at(step, minutes, stage):
        """Trains to ``step`` in ``minutes``, leaving that checkpoint
        alone, and is stopped in ``stage``."""
        def runner(cmd, log_path):
            if "--family" in cmd:
                raise TR.Stopped(15)
            clock.now += minutes * 60
            os.makedirs(ckpt, exist_ok=True)
            for f in os.listdir(ckpt):
                os.remove(os.path.join(ckpt, f))
            open(os.path.join(ckpt, f"ckpt_{step}.pt"), "w").close()
            if stage == "train":
                raise TR.Stopped(15)
            return 0
        return runner

    for i, stop in enumerate(stops):
        with pytest.raises(TR.Stopped):
            TR.run_families(resume if i else args, stopping_at(*stop))
    with open(args.out) as f:
        row = json.load(f)["stacked_hourglass"]
    minutes = [round(m, 1) for _, m, _ in stops]
    restarts = [step for step, _, _ in stops]
    assert row == {"error": f"{stops[-1][2]} stopped", "train_min": 89.5,
                   "train_min_calls": minutes, "checkpoint_step": 4000,
                   "seed": 0, "resumed_from": resumed_from,
                   "restarts": restarts[:-1]}

    calls = []
    recorder = _fake_runner(calls)

    def evaluating(cmd, log_path):
        if "--family" not in cmd:
            clock.now += 0.61 * 60      # restores, takes no step
        return recorder(cmd, log_path)

    got = TR.run_families(resume, evaluating)["stacked_hourglass"]
    assert [c[c.index("-m") + 1] for c in calls] == [
        "detectax_torch.cli.train_hourglass_voc",
        "detectax_torch.cli.evaluate"]
    assert got["mAP@0.5"] == SUMMARY["mAP@0.5"]
    assert got["resumed_from"] == resumed_from
    assert got["restarts"] == restarts
    assert got["train_min"] == 89.5 and got["train_min_calls"] == minutes
    assert got["train_steps"] == 4000 and got["seed"] == 0


def test_a_trainer_resumed_at_its_last_step_trains_nothing(tmp_path,
                                                           capsys):
    """The tiny stacked hourglass trainer on the CPU, two steps with a
    checkpoint at step 2, then ``--resume`` at the same ``--max_steps``
    (how a DetBench row that is only evaluated resumes it): it says where
    it resumed, takes no step, and leaves the checkpoint as it was, bytes
    and time stamp, with no other file beside it."""
    from detectax_torch.cli import train_hourglass_voc

    ckpt = tmp_path / "ckpt"
    argv = ["--device", "cpu", "--variant", "stacked", "--n_filters", "4",
            "--n_stacks", "2", "--canvas", "64", "--batch_size", "4",
            "--synthetic_n", "8", "--max_steps", "2", "--display_step", "1",
            "--step_save", "2", "--ckpt_dir", str(ckpt),
            "--out_dir", str(tmp_path / "out")]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        assert train_hourglass_voc.main(argv)["final_step"] == 2
        saved = ckpt / "ckpt_2.pt"
        before = (os.listdir(ckpt), saved.read_bytes(),
                  saved.stat().st_mtime_ns)
        capsys.readouterr()
        again = train_hourglass_voc.main(argv + ["--resume"])
    finally:
        torch.set_num_threads(threads)
    printed = capsys.readouterr().out
    assert "resumed from checkpoint at step 2" in printed
    assert not [line for line in printed.splitlines()
                if line.startswith("step ")]
    assert again["final_step"] == 2 and again["images_per_sec"] == 0.0
    assert (os.listdir(ckpt), saved.read_bytes(),
            saved.stat().st_mtime_ns) == before


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


def test_sigterm_stops_the_trainer_and_writes_the_row(tmp_path):
    """`main` under SIGTERM (what ``timeout`` sends): the trainer's
    process is ended, the row is written as stopped, and the driver exits
    143. The card check and the family's commands are replaced, so that a
    ``sleep`` stands in for the trainer."""
    out, runs = tmp_path / "RESULTS.json", tmp_path / "runs"
    program = (
        "import sys\n"
        "from detectax_torch.bench import run_detbench as R\n"
        "R.require_cuda = lambda name: None\n"
        "R.family_commands = lambda fam, args: (\n"
        "    [sys.executable, '-c', 'import time; time.sleep(60)'],\n"
        "    ['true'])\n"
        f"R.main(['--families', 'hourglass', '--run_root', {str(runs)!r},\n"
        f"        '--out', {str(out)!r}])\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.Popen([sys.executable, "-c", program], cwd=REPO,
                            env=env, stdout=subprocess.PIPE, text=True)
    try:
        assert "training" in proc.stdout.readline()
        log = runs / "hourglass" / "log.txt"
        for _ in range(200):    # the trainer has started once it logs
            if log.exists() and log.read_text().strip():
                break
            time.sleep(0.05)
        proc.send_signal(signal.SIGTERM)
        rest = proc.communicate(timeout=60)[0]
    finally:
        proc.kill()
    assert proc.returncode == 143, rest
    assert "STOPPED" in rest
    row = json.loads(out.read_text())["hourglass"]
    assert row["error"] == "train stopped"
    assert row["checkpoint_step"] is None and row["train_min"] >= 0.0


def _display(step, num_pos, total):
    return (f"step {step} | lr 0.001000 | cls {total - 0.5:.4f} | reg 0.5000 "
            f"| total {total:.4f} | num_pos {num_pos:.4f} | grad_norm 1.0\n")


def test_detbench_logs_holds_a_resumed_row_against_the_tpu_log(tmp_path):
    """`detbench_logs.py`: the row's last line of a step counts (a resumed
    run repeats the steps after its checkpoint), the TPU log's first run
    counts, `num_pos` is compared exactly, and ``--shift`` pairs a resumed
    step with the step whose batch it sees again."""
    import detbench_logs

    train = "$ python -u -m detectax_torch.cli.train_hourglass_voc --x\n"
    row = tmp_path / "row.txt"
    row.write_text(
        train + _display(100, 5, 4.0) + _display(200, 6, 3.0)
        + _display(300, 9, 9.9)                  # stopped, then redone
        + train + "resumed from checkpoint at step 200\n"
        + _display(300, 5, 2.2) + _display(400, 6, 2.0)
        + "$ python -u -m detectax_torch.cli.evaluate --family x\n")
    tpu = tmp_path / "tpu.txt"
    run = (_display(100, 5, 4.0) + _display(200, 6, 2.0)
           + _display(300, 5, 2.0) + _display(400, 7, 2.0))
    tpu.write_text(train + run + "$ python -m detectax.cli.evaluate\n"
                   + train + _display(100, 1, 1.0))
    got = detbench_logs.main([str(row), str(tpu), "--shift", "200",
                              "--out", str(tmp_path / "c.json")])
    assert json.loads((tmp_path / "c.json").read_text()) == got
    assert got["steps"] == 4 and got["last_step"] == 400
    assert not got["num_pos_equal"] and got["first_num_pos_diff"] == 400
    assert got["num_pos_diffs"] == 1
    assert got["total_ratio_min"] == pytest.approx(1.0)
    assert got["total_ratio_max"] == pytest.approx(1.5)
    assert got["mean_total"] == pytest.approx((4.0 + 3.0 + 2.2 + 2.0) / 4)
    assert got["mean_total_tpu"] == pytest.approx(2.5)
    # steps 300 and 400 see the batches of steps 100 and 200 again
    assert got["shifted"] == {"shift": 200, "steps": 2, "first_step": 300,
                              "last_step": 400, "num_pos_equal": True,
                              "first_num_pos_diff": None,
                              "num_pos_diffs": 0}
    later = detbench_logs.main([str(row), str(tpu), "--from_step", "300"])
    assert later["steps"] == 2 and later["first_step"] == 300
    assert got["tpu_run"] == later["tpu_run"] == "first"


def test_detbench_logs_holds_a_row_against_the_tpu_logs_last_run(tmp_path):
    """``--tpu_run last``: a TPU log holding two runs of one recipe is
    read as the row's log is, the last line of a step counting, so the
    row is held against the second run; the default reads the first."""
    import detbench_logs

    train = "$ python -u -m detectax.cli.train_centernet_heatmap --x\n"
    evaluate = "$ python -u -m detectax.cli.evaluate --family x\n"
    tpu = tmp_path / "tpu.txt"
    tpu.write_text(train + _display(100, 5, 4.0) + _display(200, 6, 3.0)
                   + evaluate
                   + train + _display(100, 5, 2.0) + _display(200, 6, 1.5)
                   + evaluate)
    row = tmp_path / "row.txt"
    row.write_text(train + _display(100, 5, 2.0) + _display(200, 7, 3.0))
    last = detbench_logs.main([str(row), str(tpu), "--tpu_run", "last"])
    assert last["tpu_run"] == "last" and last["steps"] == 2
    assert last["mean_total_tpu"] == pytest.approx((2.0 + 1.5) / 2)
    assert last["total_ratio_min"] == pytest.approx(1.0)
    assert last["total_ratio_max"] == pytest.approx(2.0)
    assert last["first_num_pos_diff"] == 200
    first = detbench_logs.main([str(row), str(tpu)])
    assert first["mean_total_tpu"] == pytest.approx((4.0 + 3.0) / 2)
    tpu_path = "benchmarks/runs_v2/centernet_heatmap/log.txt"
    runs = [detbench_logs.display_steps(os.path.join(REPO, tpu_path),
                                        first_run=f) for f in (True, False)]
    assert sorted(runs[0]) == sorted(runs[1]) == list(range(100, 4001, 100))
    # the row's run (from line 83), then the run evaluated at 0.6448
    assert runs[1][4000]["total"] == 1.3647
    assert runs[0][4000]["total"] == 1.2954


_TPU_TRAIN = ("$ /usr/bin/python -u -m detectax.cli.train_hourglass_voc "
              "--dataset detbench_v2 --ckpt_dir /a/ckpt --out_dir /a/out "
              "--init_lr 1e-3 --lr_boundaries 3000 3500 --bf16\n")
_ROW_TRAIN = ("$ /usr/bin/python3 -u -m "
              "detectax_torch.cli.train_hourglass_voc --dataset detbench_v2 "
              "--ckpt_dir /tmp/b/ckpt --out_dir /tmp/b/out --init_lr {lr} "
              "--lr_boundaries 3000 3500 {bf16}{extra}\n")


@pytest.mark.parametrize("case", ["equal", "init_lr", "resumed", "no_bf16"])
def test_detbench_logs_holds_the_rows_recipe_against_the_tpu_logs(tmp_path,
                                                                  case):
    """`detbench_logs.py`'s recipe check: every training command line of
    the row's log against the TPU log's first, the port's module read as
    the JAX one's, paths and the run flags (``--resume``, ``--seed``) set
    aside; a changed or missing flag reads unequal and is named."""
    import detbench_logs

    evaluate = "$ python -u -m detectax.cli.evaluate --family x --init_lr 9\n"
    tpu = tmp_path / "tpu.txt"
    tpu.write_text(_TPU_TRAIN + _display(100, 5, 4.0) + evaluate
                   + _TPU_TRAIN.replace("1e-3", "0.5"))
    line = dict(lr="1e-3", bf16="--bf16", extra="")
    lines = [line]
    if case == "init_lr":
        lines = [dict(line, lr="0.01")]
    elif case == "resumed":
        lines = [dict(line, extra=" --seed 0"),
                 dict(line, extra=" --resume --seed 0")]
    elif case == "no_bf16":
        lines = [dict(line, bf16="")]
    row = tmp_path / "row.txt"
    row.write_text("".join(_ROW_TRAIN.format(**x) + _display(100, 5, 4.0)
                           for x in lines) + evaluate)
    got = detbench_logs.main([str(row), str(tpu)])
    want = {"equal": {}, "resumed": {},
            "init_lr": {"--init_lr": {"row": ["0.01"], "tpu": ["1e-3"]}},
            "no_bf16": {"--bf16": {"row": None, "tpu": []}}}[case]
    assert got["recipe_diff"] == want
    assert got["recipe_equal"] is (not want)
    assert len(detbench_logs.recipes(str(row))) == len(lines)
    assert detbench_logs.recipes(str(tpu))[0]["-m"] == [
        "detectax.cli.train_hourglass_voc"]
    # a log without a training command line holds no recipe
    bare = tmp_path / "bare.txt"
    bare.write_text(_display(100, 5, 4.0))
    assert detbench_logs.compare_recipes(
        detbench_logs.recipes(str(bare)), detbench_logs.recipes(str(tpu))
    ) == {"recipe_equal": None, "recipe_diff": None}
