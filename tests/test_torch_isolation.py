"""The PyTorch port stands alone: it imports `torch` and numpy, never
`jax`, `flax`, `optax`, `orbax`, `msgpack` or anything of the `detectax`
package, and it runs on a CUDA device unless the caller names the CPU.
"""
import ast
import glob
import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "msgpack",
             "detectax", "benchmarks")

SERVE_ONE_REQUEST = r"""
import sys
import numpy as np
import torch
import detectax_torch
from detectax_torch.infer.export import fcos_decode_fn, make_serving_fn
from detectax_torch.infer.serving import Predictor
from detectax_torch.models import FCOS
import detectax_torch.cli.infer_fcos
import detectax_torch.cli.train_fcos
import detectax_torch.infer.visualize
import detectax_torch.kernels.focal
import detectax_torch.tools.from_flax

model = FCOS(num_classes=3, backbone="tiny")
fn = make_serving_fn(model, fcos_decode_fn("fcos", 64), top_k=32,
                     max_outputs=8, score_thresh=0.0)
pred = Predictor.for_model(fn, model, canvas=64, buckets=(2,), device="cpu")
out = pred.predict(np.zeros((3, 64, 64, 3), np.float32))
assert out["boxes"].shape == (3, 8, 4), out["boxes"].shape
assert (out["num_valid"] > 0).all()
summary = detectax_torch.cli.train_fcos.main([
    "--device", "cpu", "--backbone", "tiny", "--canvas", "64",
    "--batch_size", "2", "--synthetic_n", "4", "--max_steps", "1",
    "--display_step", "1", "--ckpt_dir", sys.argv[1] + "/ckpt",
    "--out_dir", sys.argv[1] + "/out"])
assert summary["final_step"] == 1
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in %r)
assert not bad, bad
assert "triton" not in sys.modules
import detectax_torch.kernels._common as kc
assert kc._lib is None and kc.build_seconds() is None  # nothing was built
print("served", int(out["num_valid"].sum()), "trained", summary["final_step"])
""" % (FORBIDDEN,)


def test_port_serves_without_importing_jax_or_detectax(tmp_path):
    """One request served and one step trained in a fresh interpreter:
    no forbidden module is imported, `triton` is not imported and no
    kernel is built along the way."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    res = subprocess.run(
        [sys.executable, "-c", SERVE_ONE_REQUEST, str(tmp_path)], cwd=REPO,
        env=env, capture_output=True, text=True, timeout=300,
    )
    assert res.returncode == 0, res.stdout + res.stderr
    assert "served" in res.stdout and "trained 1" in res.stdout


CENTERNET_SLICE = r"""
import sys
import numpy as np
import torch
from detectax_torch.cli import infer_centernet, train_centernet_crowdhuman
from detectax_torch.cli import train_centernet_heatmap
from detectax_torch.infer.export import centernet_decode_fn, make_serving_fn
from detectax_torch.infer.serving import Predictor
from detectax_torch.kernels import peak
from detectax_torch.models import CenterNetFPNSingle, CenterNetS8

served = 0
for model, scales in ((CenterNetFPNSingle(3, backbone="tiny"), None),
                      (CenterNetS8(3, n_scales=2, backbone="tiny"),
                       (32.0, 64.0))):
    fn = make_serving_fn(
        model, centernet_decode_fn(model.family, box_scales=scales),
        top_k=32, max_outputs=8, score_thresh=0.0)
    pred = Predictor.for_model(fn, model, canvas=64, buckets=(2,),
                               device="cpu")
    out = pred.predict(np.zeros((3, 64, 64, 3), np.float32))
    assert out["boxes"].shape == (3, 8, 4), out["boxes"].shape
    served += int(out["num_valid"].sum())
masked = peak.peak_scores(torch.zeros(4, 4, 2))
assert masked.shape == (4, 4, 2) and bool((masked == 0.5).all())
common = ["--device", "cpu", "--backbone", "tiny", "--canvas", "64",
          "--batch_size", "2", "--synthetic_n", "4", "--max_steps", "1",
          "--display_step", "1", "--out_dir", sys.argv[1] + "/out"]
trained = 0
for i, main in enumerate((train_centernet_heatmap.main,
                          train_centernet_crowdhuman.main)):
    summary = main(common + ["--ckpt_dir", sys.argv[1] + "/ckpt%%d" %% i])
    trained += summary["final_step"]
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in %r)
assert not bad, bad
assert "triton" not in sys.modules
import detectax_torch.kernels._common as kc
assert kc._lib is None and kc.build_seconds() is None  # nothing was built
assert kc.launch_counts() == {}
print("served", served, "trained", trained)
""" % (FORBIDDEN,)


def test_centernet_slice_runs_without_jax_or_a_build(tmp_path):
    """Both CenterNet families served and trained for a step in a fresh
    interpreter on the CPU: no forbidden module, no `triton`, no build and
    no kernel launch (the wrappers ran their plain versions)."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    res = subprocess.run(
        [sys.executable, "-c", CENTERNET_SLICE, str(tmp_path)], cwd=REPO,
        env=env, capture_output=True, text=True, timeout=300,
    )
    assert res.returncode == 0, res.stdout + res.stderr
    assert "served" in res.stdout and "trained 2" in res.stdout


REPLAY_EXPORTED_BUNDLE = r"""
import sys
import numpy as np
from detectax_torch.infer.export import load_bundle

pred = load_bundle(sys.argv[1], device="cpu")
out = pred.predict(np.zeros((3, 64, 64, 3), np.float32))
assert out["boxes"].shape == (3, 8, 4), out["boxes"].shape
assert (out["num_valid"] > 0).all()
models = sorted(m for m in sys.modules
                if m.startswith("detectax_torch.models"))
assert not models, models
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in %r)
assert not bad, bad
import detectax_torch.kernels._common as kc
assert kc._lib is None and kc.launch_counts() == {}
print("replayed", int(out["num_valid"].sum()))
""" % (FORBIDDEN + ("triton",),)


def test_exported_bundle_replays_without_model_code(tmp_path):
    """A v2 bundle (one `torch.export` program a bucket) is loaded and
    served in a fresh interpreter that imports no module of
    `detectax_torch.models`, nothing forbidden and no `triton`."""
    from detectax_torch.infer.export import save_bundle
    from detectax_torch.models import FCOS

    model = FCOS(num_classes=3, backbone="tiny")
    save_bundle(str(tmp_path / "b"), model, canvas=64, buckets=(2,),
                export_device="cpu", fused=True, top_k=32, max_outputs=8,
                score_thresh=0.0)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    res = subprocess.run(
        [sys.executable, "-c", REPLAY_EXPORTED_BUNDLE, str(tmp_path / "b")],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    assert res.returncode == 0, res.stdout + res.stderr
    assert "replayed" in res.stdout


def test_every_port_module_imports_without_a_build():
    """Importing any module of the port builds nothing and imports neither
    `triton` nor a forbidden package (the kernels are built at first use
    on a CUDA tensor)."""
    mods = sorted(
        os.path.relpath(p, REPO)[:-3].replace(os.sep, ".")
        .removesuffix(".__init__")
        for p in _port_sources() if "detectax_torch" in p)
    assert "detectax_torch.train.loop" in mods
    assert "detectax_torch.kernels.focal" in mods
    for new in ("kernels.peak", "models.centernet", "cli.infer_centernet",
                "cli.train_centernet_heatmap",
                "cli.train_centernet_crowdhuman", "data.detbench",
                "eval.detection_metrics", "cli.evaluate", "cli._eval_hooks",
                "cli.train_fcos_center_voc", "cli.train_fcos_center_v1_voc",
                "ops.anchors", "models.retinanet", "cli.train_retinanet_coco",
                "cli.infer_retinanet", "kernels.ops", "cli.export_model",
                "parallel", "parallel.mesh", "tools.two_process_cpu_test",
                "data.index", "data.convert_voc", "data.convert_coco",
                "data.convert_crowdhuman", "cli.convert_voc",
                "cli.convert_coco", "cli.convert_crowdhuman",
                "data.native_loader", "tools.port_tf_weights", "bench",
                "bench._common", "bench.train", "bench.decode",
                "bench.serving", "bench.profile_step",
                "bench.pretrain_backbone", "bench.run_detbench",
                "bench.merge_eval_into_results"):
        assert f"detectax_torch.{new}" in mods
    # TensorFlow and PIL are imported inside the functions that need them;
    # the native image library is built at first use, as the kernels are
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN + ('triton', 'tensorflow', 'keras', 'PIL')!r})\n"
        "assert not bad, bad\n"
        "import detectax_torch.kernels._common as kc\n"
        "assert kc._lib is None and kc.build_seconds() is None\n"
        "import detectax_torch.data.native_loader as nl\n"
        "assert nl._lib is None and nl.build_seconds() is None\n"
        "print('imported', len(sys.modules))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "imported" in res.stdout


def _imported_roots(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module:
                yield node.module.split(".")[0], node.lineno


def _port_sources():
    files = glob.glob(os.path.join(REPO, "detectax_torch", "**", "*.py"),
                      recursive=True)
    return sorted(files) + [os.path.join(REPO, "chip_smoke.py"),
                            os.path.join(REPO, "bench_torch.py")]


def test_static_scan_finds_no_forbidden_import():
    files = _port_sources()
    assert len(files) > 30, files
    for new in ("pretrain_backbone", "run_detbench",
                "merge_eval_into_results"):
        assert os.path.join(REPO, "detectax_torch", "bench",
                            f"{new}.py") in files
    hits = [
        f"{os.path.relpath(path, REPO)}:{line} imports {root}"
        for path in files
        for root, line in _imported_roots(path)
        if root in FORBIDDEN
    ]
    assert not hits, hits


def test_port_never_calls_torch_compile():
    hits = []
    for path in _port_sources():
        with open(path) as f:
            tree = ast.parse(f.read(), filename=path)
        for node in ast.walk(tree):
            if (isinstance(node, ast.Attribute) and node.attr == "compile"
                    and isinstance(node.value, ast.Name)
                    and node.value.id == "torch"):
                hits.append(f"{os.path.relpath(path, REPO)}:{node.lineno}")
    assert not hits, hits


def test_default_device_is_cuda_and_never_falls_back(tmp_path):
    from detectax_torch.cli import infer_fcos
    from detectax_torch.infer.export import (
        fcos_decode_fn,
        load_bundle,
        make_serving_fn,
        save_bundle,
    )
    from detectax_torch.infer.serving import Predictor
    from detectax_torch.models import FCOS
    from detectax_torch.runtime import resolve_device

    assert resolve_device("cpu").type == "cpu"
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
        return
    model = FCOS(num_classes=3, backbone="tiny")
    fn = make_serving_fn(model, fcos_decode_fn("fcos", 64))
    save_bundle(str(tmp_path / "b"), model, canvas=64)
    for call in (
        resolve_device,
        lambda: resolve_device("cuda:0"),
        lambda: Predictor.for_model(fn, model, canvas=64),
        lambda: load_bundle(str(tmp_path / "b")),
        lambda: infer_fcos.main(["--img_file", "x.jpg", "--weights", "w.npz"]),
    ):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


def test_kernel_build_reports_a_missing_compiler(monkeypatch):
    """The kernels are built at first use, never at import; without nvcc
    the build raises a clear error instead of falling back."""
    from detectax_torch.kernels import _common

    monkeypatch.setenv("PATH", "")
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(_common, "DEFAULT_NVCC", "/nonexistent/nvcc")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _common.build_library()


def test_launch_counters():
    from detectax_torch.kernels import _common

    before = _common.launch_counts()
    _common.reset_launch_counts()
    try:
        assert _common.launch_counts() == {}
        _common.count_launch("k")
        _common.count_launch("k")
        assert _common.launch_counts() == {"k": 2}
        assert _common.round_up(1025, 128) == 1152
        assert _common.round_up(1024, 128) == 1024
    finally:
        _common.reset_launch_counts()
        for name, n in before.items():
            for _ in range(n):
                _common.count_launch(name)
