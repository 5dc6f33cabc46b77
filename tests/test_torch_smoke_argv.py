"""`chip_smoke.py`'s DetBench hourglass phases run the rows' own recipes
(`run_detbench.family_commands("stacked_hourglass", ...)`), on the CPU
with no run: the crowd phase hands `cli.train_hourglass_voc` and
`cli.evaluate` the v2_crowd row's argv, apart from the steps, the paths
and ``--cls_thresh`` (the smoke keeps every score so that NMS has work);
the v2 phase's training argv parses to the v2 row's settings.
"""
import importlib

import pytest

import chip_smoke
from detectax_torch.bench import run_detbench

# flags whose values are the run's steps or paths
RUN_VALUES = ("--max_steps", "--display_step", "--step_save", "--ckpt_dir",
              "--out_dir", "--out_json")


def _normalized(argv):
    out, it = [], iter(argv)
    for a in it:
        if a == "--cls_thresh":
            next(it)
            continue
        out.append(a)
        if a in RUN_VALUES:
            next(it)
            out.append("<run>")
    return out


def _row(bench, tmp_path):
    args = run_detbench.parse_args(["--bench", bench, "--run_root",
                                    str(tmp_path), "--out",
                                    str(tmp_path / "r.json")])
    train, evaluate = run_detbench.family_commands("stacked_hourglass", args)
    assert train[3] == "detectax_torch.cli.train_hourglass_voc"
    assert evaluate[3] == "detectax_torch.cli.evaluate"
    return train[4:], evaluate[4:]


def test_crowd_phase_hands_the_clis_the_rows_argv(tmp_path):
    train, evaluate = chip_smoke.crowd_argvs(str(tmp_path / "ckpt"),
                                             str(tmp_path / "out"))
    want_train, want_eval = _row("detbench_v2_crowd", tmp_path)
    assert _normalized(train) == _normalized(want_train)
    assert _normalized(evaluate) == _normalized(want_eval)
    # what the smoke changes: 2 steps, its own paths, every score kept
    assert train[train.index("--max_steps") + 1] == str(
        chip_smoke.HG_CLI_STEPS)
    assert evaluate[-2:] == ["--cls_thresh", "0.0"]
    for flag, value in (("--max_boxes", "128"), ("--max_outputs", "200"),
                        ("--top_k", "2048"), ("--canvas", "320")):
        assert evaluate[evaluate.index(flag) + 1] == value
    assert chip_smoke.CROWD_MAX_OUTPUTS == 200
    assert -(-chip_smoke.CROWD_EVAL_IMAGES // 8) == 16
    assert chip_smoke.HG_CLI_STEPS * 16 // chip_smoke.HG_MICROBATCH == 16


def test_v2_phase_train_argv_parses_as_the_rows(tmp_path):
    """Parsed by the trainer's own parser, the v2 phase's training argv
    (in another order than the row's) and the row's give the same
    settings apart from steps and paths."""
    import argparse
    from unittest import mock

    train = chip_smoke.v2_argvs("c", "o")[0]
    want = _row("detbench_v2", tmp_path)[0]

    class Parsed(Exception):
        pass

    original = argparse.ArgumentParser.parse_args

    def parse_then_stop(self, argv=None, namespace=None):
        raise Parsed(original(self, argv, namespace))

    module = importlib.import_module("detectax_torch.cli.train_hourglass_voc")
    parsed = []
    with mock.patch.object(argparse.ArgumentParser, "parse_args",
                           parse_then_stop):
        for argv in (train, want):
            with pytest.raises(Parsed) as p:
                module.main(argv)
            parsed.append(vars(p.value.args[0]))
    for ns in parsed:
        for key in ("max_steps", "display_step", "step_save", "ckpt_dir",
                    "out_dir"):
            ns.pop(key)
    assert parsed[0] == parsed[1]
    assert parsed[0]["dataset"] == "detbench_v2" and parsed[0]["bf16"]
