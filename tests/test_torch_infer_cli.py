"""`cli.infer_fcos` of the port from a checkpoint, on the CPU: the JAX
test's round trip (`tests/test_infer_cli.py`) — train a tiny FCOS through
`cli.train_fcos`, then infer from its checkpoint with ``--ckpt_dir`` — and
the detections equal those ``--weights`` gives for the same parameters
written with `save_npz`."""
import os

import numpy as np
import pytest
import torch
from PIL import Image

from detectax_torch.cli import infer_fcos, train_fcos
from detectax_torch.models import FCOS
from detectax_torch.tools.from_flax import save_npz, to_flax
from detectax_torch.train.driver import restore_for_inference


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """torch on one thread: the work is tiny, and beside the suite's other
    workers a pool of threads waits on busy cores at every operation."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    work = tmp_path_factory.mktemp("infer_cli")
    summary = train_fcos.main([
        "--device", "cpu", "--backbone", "tiny", "--canvas", "64",
        "--batch_size", "4", "--max_steps", "4", "--display_step", "2",
        "--step_save", "4", "--synthetic_n", "16", "--max_boxes", "8",
        "--ckpt_dir", str(work / "ckpt"), "--out_dir", str(work / "out"),
    ])
    assert summary["final_step"] == 4
    img_file = work / "input.jpg"
    rng = np.random.default_rng(0)
    Image.fromarray(
        rng.integers(0, 255, (100, 140, 3), dtype=np.uint8)).save(img_file)
    return work


def _infer(work, tag, *source):
    detect_out = work / f"detection_{tag}.jpg"
    heatmap_out = work / f"heatmap_{tag}.jpg"
    dets = infer_fcos.main([
        "--img_file", str(work / "input.jpg"), *source, "--device", "cpu",
        "--backbone", "tiny", "--num_classes", "3", "--img_dims", "64",
        "--cls_thresh", "0.0",
        "--detect_out", str(detect_out), "--heatmap_out", str(heatmap_out),
    ])
    assert os.path.getsize(detect_out) > 1000
    assert os.path.getsize(heatmap_out) > 1000
    return dets


def test_infer_fcos_from_ckpt_dir_equals_weights(trained, capsys):
    from_ckpt = _infer(trained, "ckpt", "--ckpt_dir", str(trained / "ckpt"))
    assert "restored checkpoint at step 4" in capsys.readouterr().out
    n = len(from_ckpt["scores"])
    assert n > 0 and from_ckpt["boxes"].shape == (n, 4)
    assert np.isfinite(from_ckpt["boxes"]).all()
    assert (from_ckpt["classes"] < 3).all()

    model = FCOS(num_classes=3, backbone="tiny")
    restore_for_inference(str(trained / "ckpt"), model)
    save_npz(str(trained / "w.npz"), *to_flax(model))
    from_weights = _infer(trained, "weights", "--weights",
                          str(trained / "w.npz"))
    assert set(from_ckpt) == set(from_weights)
    for k in from_ckpt:
        np.testing.assert_array_equal(from_ckpt[k], from_weights[k],
                                      err_msg=k)


def test_infer_fcos_default_ckpt_dir_is_ckpt(trained, monkeypatch):
    """With neither flag, the CLI restores from ``./ckpt`` (the JAX CLI's
    default) and says so when there is nothing there."""
    monkeypatch.chdir(trained / "out")
    with pytest.raises(FileNotFoundError, match="no checkpoint under ckpt"):
        infer_fcos.main(["--img_file", str(trained / "input.jpg"),
                         "--device", "cpu", "--backbone", "tiny",
                         "--num_classes", "3", "--img_dims", "64"])
    monkeypatch.chdir(trained)
    dets = infer_fcos.main([
        "--img_file", str(trained / "input.jpg"), "--device", "cpu",
        "--backbone", "tiny", "--num_classes", "3", "--img_dims", "64",
        "--cls_thresh", "0.0",
        "--detect_out", str(trained / "d.jpg"),
        "--heatmap_out", str(trained / "h.jpg")])
    assert len(dets["scores"]) > 0
