"""DetBench of the port against the JAX package's, on the CPU.

`detectax_torch.data.detbench` is a copy of `detectax.data.detbench`: the
same (split, index) gives the same image, boxes and labels bit for bit, for
each of the three committed benchmarks; the committed specs equal the
built-in ones (the port falls back to those where `benchmarks/` is absent);
the memmap cache, filled by one or several worker processes, holds the
generator's bytes.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

from detectax.data import detbench as JD
from detectax_torch.data import detbench as TD

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = ("detbench", "detbench_v2", "detbench_v2_crowd")


def _same(got, want, what):
    assert set(got) == set(want), what
    for k in want:
        assert got[k].dtype == want[k].dtype, (what, k)
        assert got[k].shape == want[k].shape, (what, k)
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"{what} {k}")


@pytest.mark.parametrize("name,split,index", [
    ("detbench", "train", 0), ("detbench", "train", 4095),
    ("detbench", "eval", 17), ("detbench_v2", "train", 3),
    ("detbench_v2", "eval", 200), ("detbench_v2_crowd", "eval", 5)])
def test_samples_equal_the_jax_package(name, split, index):
    tds = TD.DetBenchDataset(split, spec=TD.load_spec(name=name), cache=False)
    jds = JD.DetBenchDataset(split, spec=JD.load_spec(name=name), cache=False)
    assert len(tds) == len(jds) and tds.num_classes == jds.num_classes == 8
    assert tds.id_to_label == jds.id_to_label
    got, want = tds[index], jds[index]
    _same(got, want, f"{name} {split}[{index}]")
    assert got["image"].shape == (tds.img_size, tds.img_size, 3)
    assert len(got["labels"]) >= tds.spec["min_objects"]


@pytest.mark.parametrize("name", NAMES)
def test_committed_specs_equal_the_built_in_ones(name):
    committed = TD.load_spec(name=name)
    assert committed == TD.SPECS[name] == JD.SPECS[name]
    assert committed == JD.load_spec(name=name)
    # without the committed file the built-in spec is the same benchmark
    missing = os.path.join(REPO, "benchmarks", "no_such_spec.json")
    assert TD.load_spec(missing, name=name) == committed


CHILD = r"""
import os, sys
import numpy as np
from detectax_torch.data import detbench as TD

workers, out = int(sys.argv[1]), sys.argv[2]
ds = TD.DetBenchDataset("eval", n=6, workers=workers)
paths = ds._cache_paths()
assert all(os.path.exists(paths[k])
           for k in ("images", "boxes", "labels", "counts", "done"))
TD._fill = TD.make_sample = None   # a re-read must generate nothing
again = TD.DetBenchDataset("eval", n=6, workers=workers)
arrays = {}
for tag, d in (("first", ds), ("again", again)):
    for i in range(6):
        for k, v in d[i].items():
            arrays[f"{tag}_{i}_{k}"] = v
np.savez(out, **arrays)
print(paths["dir"])
"""


@pytest.mark.parametrize("workers", [1, 2])
def test_memmap_cache_holds_the_generator_bytes(tmp_path, workers):
    """The cache filled by one process, or by two forked ones, holds the
    generator's bytes, and a second dataset over the split reads it back
    without generating. Run in a fresh interpreter, as the port's entry
    points run (no JAX threads there when the workers are forked)."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=REPO, DETECTAX_DETBENCH_CACHE=str(tmp_path / "c"))
    out = tmp_path / "samples.npz"
    res = subprocess.run(
        [sys.executable, "-c", CHILD, str(workers), str(out)], cwd=REPO,
        env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.strip() == str(tmp_path / "c")
    jds = JD.DetBenchDataset("eval", n=6, cache=False)
    with np.load(out) as got:
        for tag in ("first", "again"):
            for i in range(6):
                _same({k: got[f"{tag}_{i}_{k}"] for k in jds[i]}, jds[i],
                      f"{tag} eval[{i}]")
