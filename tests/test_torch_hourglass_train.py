"""Training and evaluation of the hourglass models of the PyTorch port
against the JAX package, on the CPU.

* The loader with the trainer's hourglass augment and centre padding, on
  canvas buckets and with the content-scale jitter: batches equal.
* `cli.train_hourglass_voc` for two steps (`--variant stacked` on the
  buckets 64 and 128), then `cli.evaluate` from its checkpoint; and
  `cli.evaluate` against `detectax.cli.evaluate` with the same weights:
  detections image by image, the same ground truth, equal summaries.
* `cli.train_hourglass_voc` stopped after two steps and resumed to four
  with ``--resume``: the step count, Adam's moments and the epoch
  schedule's rate go on from the checkpoint.
"""
import types

import numpy as np
import pytest
import torch

from detectax.cli import evaluate as j_evaluate
from detectax.data import Loader as JLoader
from detectax.data import SyntheticDataset as JSynthetic
from detectax.eval import detection_metrics as JM
from detectax.models import HourglassNet as JHG
from detectax.models import StackedHourglass as JSH
from detectax_torch.cli import evaluate as t_evaluate
from detectax_torch.cli import train_hourglass_voc
from detectax_torch.data.pipeline import Loader as TLoader
from detectax_torch.data.synthetic import SyntheticDataset as TSynthetic
from detectax_torch.eval import detection_metrics as TM
from detectax_torch.tools import from_flax as FF
from detectax_torch.train.checkpoint import CheckpointManager
from test_torch_hourglass import flax_trees


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """torch on one thread: the steps are tiny, and beside the suite's
    other workers a pool of threads a process waits on busy cores at every
    operation (tens of times slower)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


IMG, NC = 64, 3
LR = 1e-3


@pytest.mark.parametrize("kw", [dict(canvas=[64, 128], jitter=None),
                                dict(canvas=64, jitter=(38.4, 64.0))],
                         ids=["buckets", "jitter"])
def test_loader_with_the_hourglass_augment_equals_the_jax_package(kw):
    common = dict(batch_size=3, max_boxes=8, steps=3, seed=4, prefetch=0,
                  emit_uint8=True, augment="hourglass",
                  pad_position="center", **kw)
    want = list(JLoader(JSynthetic(n=8, img_size=96, seed=1), native=False,
                        **common))
    got = list(TLoader(TSynthetic(n=8, img_size=96, seed=1), **common))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            assert g[k].dtype == w[k].dtype
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def _cut_detbench(monkeypatch, tmp_path, n_train=4, n_eval=4):
    """Both packages' DetBench v2 cut to a few images, cached under the
    test's directory."""
    from detectax.data import detbench as JD
    from detectax_torch.data import detbench as TD

    for mod in (JD, TD):
        full = mod.load_spec

        def small(*a, _full=full, **k):
            return dict(_full(*a, **k), n_train=n_train, n_eval=n_eval)

        monkeypatch.setattr(mod, "load_spec", small)
    monkeypatch.setenv("DETECTAX_DETBENCH_CACHE", str(tmp_path / "cache"))


def _recording(monkeypatch, module):
    seen = []
    add = module.MeanAPEvaluator.add_image

    def add_image(self, *args):
        seen.append([np.asarray(a) for a in args])
        return add(self, *args)

    monkeypatch.setattr(module.MeanAPEvaluator, "add_image", add_image)
    return seen


@pytest.mark.parametrize("family,train_args", [
    ("hourglass", ["--n_filters", "2"]),
    ("stacked_hourglass", ["--variant", "stacked", "--n_filters", "4",
                           "--n_stacks", "2", "--loss_norm", "pos",
                           "--multi_scale", "64", "128"])])
def test_train_cli_then_evaluate_equals_the_jax_cli(tmp_path, monkeypatch,
                                                    family, train_args):
    """Two steps of the trainer on the CPU (microbatches of 2), then
    `cli.evaluate` from the checkpoint it wrote. Then the port's
    `cli.evaluate --weights` against the JAX package's with the same
    weights on DetBench v2 cut to four eval images: weights made with
    numpy in the Flax trees, the head's kernel scaled by 5 and the focal
    bias 0. Two steps from the focal prior leave the class scores within
    1e-5 of each other (0.011), so near-equal candidates would swap ranks
    on float32 noise, where these weights spread the scores apart. No
    score threshold, so that every image keeps detections."""
    ckpt = str(tmp_path / "ckpt")
    summary = train_hourglass_voc.main([
        "--device", "cpu", "--canvas", str(IMG), "--batch_size", "4",
        "--synthetic_n", "8", "--max_steps", "2", "--display_step", "1",
        "--ckpt_dir", ckpt, "--out_dir", str(tmp_path / "out"),
        *train_args])
    assert summary["final_step"] == 2 and np.isfinite(summary["total"])
    assert CheckpointManager(ckpt).latest_step() == 2
    width = train_args[train_args.index("--n_filters"):][:2]
    if family == "stacked_hourglass":
        width += ["--n_stacks", "2"]
    args = ["--family", family, "--canvas", str(IMG), "--synthetic_n", "4",
            "--batch_size", "2", "--cls_thresh", "0.0", "--coco_metrics",
            *width]
    from_ckpt = t_evaluate.main(args + ["--device", "cpu",
                                        "--ckpt_dir", ckpt])
    assert from_ckpt["num_images"] == 4
    assert np.isfinite(from_ckpt["mAP@0.5"])

    _cut_detbench(monkeypatch, tmp_path)
    args = ["--family", family, "--canvas", str(IMG), "--dataset",
            "detbench_v2", "--batch_size", "2", "--cls_thresh", "0.0",
            "--coco_metrics", *width]
    jmodel = (JHG(num_classes=8, n_filters=2) if family == "hourglass"
              else JSH(num_classes=8, n_filters=4, n_stacks=2))
    params, stats = flax_trees(jmodel, 11)
    # logits spread over several units: the focal prior, on random
    # weights, leaves the scores within 1e-5 of each other
    head = "head_out" if family == "hourglass" else "cnn_out"
    params[head]["kernel"] = params[head]["kernel"] * 5.0
    params["b_focal"]["bias"] = np.zeros((), np.float32)
    FF.save_npz(str(tmp_path / "w.npz"), params, stats)
    monkeypatch.setattr(
        j_evaluate, "restore_for_inference",
        lambda *a, **k: types.SimpleNamespace(params=params,
                                              batch_stats=stats))
    j_seen = _recording(monkeypatch, JM)
    want = j_evaluate.main(args)
    t_seen = _recording(monkeypatch, TM)
    got = t_evaluate.main(args + ["--device", "cpu", "--weights",
                                  str(tmp_path / "w.npz")])
    assert got["num_images"] == want["num_images"] == 4
    assert len(t_seen) == len(j_seen) == 4
    for (tb, ts, tc, tg, tl), (jb, js, jc, jg, jl) in zip(t_seen, j_seen):
        assert tb.shape == jb.shape and len(tb) > 0
        # the kept scores lie well apart: no rank rests on a rounding
        assert np.diff(js).max() < 0 and -np.diff(js).min() > 1e-5
        np.testing.assert_array_equal(tc, jc)
        np.testing.assert_allclose(ts, js, rtol=0, atol=1e-6)
        np.testing.assert_allclose(tb, jb, rtol=0, atol=1e-4)
        np.testing.assert_array_equal(tg, jg)
        np.testing.assert_array_equal(tl, jl)
    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k] == pytest.approx(w, abs=1e-12), k


def test_evaluate_cli_still_refuses_data_parallel_for_the_hourglass(
        tmp_path, capsys):
    """`--data_parallel` is ported and refuses no family any more: outside
    torchrun the hourglass evaluation goes on in the process alone, on to
    its checkpoint (none here)."""
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        t_evaluate.main(["--family", "stacked_hourglass", "--device", "cpu",
                         "--ckpt_dir", str(tmp_path / "none"),
                         "--data_parallel"])
    assert "no process group" in capsys.readouterr().out


def test_train_cli_resumes_adam_and_the_epoch_schedule(tmp_path, capsys):
    """Two steps with a checkpoint at step 2, then ``--resume --max_steps
    4``: the run says where it resumed, ends at step 4, and its checkpoint
    holds Adam's count 4 for every parameter (a fresh Adam would hold 2)
    and the rate of update 4, lr 0.5^3 on an epoch of one step (a
    restarted schedule would give 0.5)."""
    ckpt = str(tmp_path / "ckpt")
    argv = ["--device", "cpu", "--canvas", str(IMG), "--batch_size", "4",
            "--synthetic_n", "8", "--n_filters", "2", "--display_step", "1",
            "--step_save", "2", "--steps_per_epoch", "1", "--lr_decay",
            "0.5", "--init_lr", str(LR), "--ckpt_dir", ckpt,
            "--out_dir", str(tmp_path / "out")]
    first = train_hourglass_voc.main(argv + ["--max_steps", "2"])
    assert first["final_step"] == 2
    before = CheckpointManager(ckpt)._load(2, "cpu")
    capsys.readouterr()
    second = train_hourglass_voc.main(argv + ["--max_steps", "4",
                                             "--resume"])
    printed = capsys.readouterr().out
    assert "resumed from checkpoint at step 2" in printed
    assert second["final_step"] == 4 and np.isfinite(second["total"])
    steps = [int(line.split()[1]) for line in printed.splitlines()
             if line.startswith("step ")]
    assert steps == [3, 4]
    assert CheckpointManager(ckpt).latest_step() == 4
    after = CheckpointManager(ckpt)._load(4, "cpu")
    assert before["step"] == 2 and after["step"] == 4
    counts = {float(v["step"]) for v in after["opt"]["state"].values()}
    assert counts == {4.0}
    assert {float(v["step"]) for v in before["opt"]["state"].values()} == {
        2.0}
    assert after["opt"]["param_groups"][0]["lr"] == pytest.approx(
        LR * 0.5 ** 3, rel=1e-12)
    # the moments went on from the checkpoint's, which they differ from
    moved = [not torch.equal(after["opt"]["state"][k]["exp_avg_sq"],
                             before["opt"]["state"][k]["exp_avg_sq"])
             for k in before["opt"]["state"]]
    assert all(moved)
