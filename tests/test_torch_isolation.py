"""The PyTorch port stands alone: it imports `torch` and numpy, never
`jax`, `flax`, `optax`, `orbax` or anything of the `detectax` package, and
it runs on a CUDA device unless the caller names the CPU.
"""
import ast
import glob
import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "detectax")

SERVE_ONE_REQUEST = r"""
import sys
import numpy as np
import torch
import detectax_torch
from detectax_torch.infer.export import fcos_decode_fn, make_serving_fn
from detectax_torch.infer.serving import Predictor
from detectax_torch.models import FCOS
import detectax_torch.cli.infer_fcos
import detectax_torch.infer.visualize
import detectax_torch.tools.from_flax

model = FCOS(num_classes=3, backbone="tiny")
fn = make_serving_fn(model, fcos_decode_fn("fcos", 64), top_k=32,
                     max_outputs=8, score_thresh=0.0)
pred = Predictor.for_model(fn, model, canvas=64, buckets=(2,), device="cpu")
out = pred.predict(np.zeros((3, 64, 64, 3), np.float32))
assert out["boxes"].shape == (3, 8, 4), out["boxes"].shape
assert (out["num_valid"] > 0).all()
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in %r)
assert not bad, bad
print("served", int(out["num_valid"].sum()))
""" % (FORBIDDEN,)


def test_port_serves_without_importing_jax_or_detectax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    res = subprocess.run(
        [sys.executable, "-c", SERVE_ONE_REQUEST], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert res.returncode == 0, res.stdout + res.stderr
    assert "served" in res.stdout


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
    return sorted(files) + [os.path.join(REPO, "chip_smoke.py")]


def test_static_scan_finds_no_forbidden_import():
    files = _port_sources()
    assert len(files) > 15, files
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
