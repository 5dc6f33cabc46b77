"""`chip_smoke.py`'s DetBench hourglass phases run the rows' own recipes
(`chip_smoke.row_argvs` over `run_detbench.family_commands`), on the CPU
with no run: each crowd phase (`stacked_hourglass`, `hourglass`) hands
`cli.train_hourglass_voc` and `cli.evaluate` its v2_crowd row's argv,
changed only in the steps, the paths and an added ``--cls_thresh`` (the
smoke keeps every score so that NMS has work); the v2 phase's training
argv parses to the v2 row's settings.
"""
import importlib

import pytest

import chip_smoke
from detectax_torch.bench import run_detbench

# the flags whose values the smoke sets: the run's steps and paths
TRAIN_RUN_VALUES = {"--max_steps", "--display_step", "--step_save",
                    "--ckpt_dir", "--out_dir"}
EVAL_RUN_VALUES = {"--ckpt_dir", "--out_json"}


def _differing_flags(got, want):
    """The flags whose values differ between two argvs of one layout."""
    assert len(got) == len(want)
    return {want[i - 1] for i, (a, b) in enumerate(zip(got, want))
            if a != b}


def _row(bench, tmp_path, family="stacked_hourglass"):
    args = run_detbench.parse_args(["--bench", bench, "--run_root",
                                    str(tmp_path), "--out",
                                    str(tmp_path / "r.json")])
    train, evaluate = run_detbench.family_commands(family, args)
    assert train[3] == "detectax_torch.cli.train_hourglass_voc"
    assert evaluate[3] == "detectax_torch.cli.evaluate"
    return train[4:], evaluate[4:]


@pytest.mark.parametrize("family, batch, focal", [
    ("stacked_hourglass", "16", 16),
    # `HourglassNet`'s recipe keeps the sigmoid class loss: no focal kernel
    ("hourglass", "32", 0),
])
def test_crowd_phase_hands_the_clis_the_rows_argv(tmp_path, family, batch,
                                                  focal):
    """`row_argvs` changes the row's argv in place: the steps' and the
    paths' values, and nothing else (every other flag and value as
    `family_commands` gives them), then adds ``--cls_thresh 0.0``."""
    ckpt, out = str(tmp_path / "ckpt"), str(tmp_path / "out")
    train, evaluate = chip_smoke.row_argvs("detbench_v2_crowd", family,
                                           ckpt, out)
    want_train, want_eval = _row("detbench_v2_crowd", tmp_path, family)
    assert _differing_flags(train, want_train) == TRAIN_RUN_VALUES
    assert _differing_flags(evaluate[:-2], want_eval) == EVAL_RUN_VALUES
    # what the smoke changes: 2 steps, its own paths, every score kept
    assert train[train.index("--max_steps") + 1] == str(
        chip_smoke.HG_CLI_STEPS)
    for argv in (train, evaluate):
        assert argv[argv.index("--ckpt_dir") + 1] == ckpt
    assert train[train.index("--out_dir") + 1] == out
    assert evaluate[-2:] == ["--cls_thresh", "0.0"]
    assert evaluate[evaluate.index("--family") + 1] == family
    assert train[train.index("--batch_size") + 1] == batch
    for flag, value in (("--max_boxes", "128"), ("--max_outputs", "200"),
                        ("--top_k", "2048"), ("--canvas", "320")):
        assert evaluate[evaluate.index(flag) + 1] == value
    assert "--loss_type" not in train
    assert chip_smoke.CROWD_MAX_OUTPUTS == 200
    assert -(-chip_smoke.CROWD_EVAL_IMAGES // 8) == 16
    assert chip_smoke.ROW_TRAIN_LAUNCHES[family] == (
        {"focal_fwd": focal, "focal_bwd": focal} if focal else {})


def test_v2_phase_train_argv_parses_as_the_rows(tmp_path):
    """Parsed by the trainer's own parser, the v2 phase's training argv
    and the row's give the same settings apart from steps and paths."""
    import argparse
    from unittest import mock

    train = chip_smoke.row_argvs("detbench_v2", "stacked_hourglass", "c",
                                 "o")[0]
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
