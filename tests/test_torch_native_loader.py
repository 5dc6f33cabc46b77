"""The port's native (C++/libjpeg) loader against the JAX package's binding
and against the PIL path, on the CPU.

Both packages compile the same `native/dx_image.cpp` with the same flags,
so the decoders' outputs are compared bit for bit, and so are the
`Loader(native=True)` batches of the two packages under one seed. The file
is skipped only where ``jpeglib.h`` is missing (the build's own reason);
any other build failure fails it."""
import os

import numpy as np
import pytest
import torch
from PIL import Image

from detectax.data import native_loader as JNL
from detectax.data.pipeline import Loader as JLoader
from detectax_torch.data import native_loader as TNL
from detectax_torch.data.pipeline import Loader as TLoader

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the mean |native - PIL| pixel bound of tests/test_native_loader.py (the
# decoders differ by PIL's antialiasing filter); pixels normalized to [-1, 1]
PIL_MEAN_DIFF = 0.2
SIZES = ((120, 160), (97, 61), (40, 300))


@pytest.fixture(scope="module", autouse=True)
def _native_library():
    """Built here, in a fixture, so that every worker collects the same
    tests; skipped only where the compiler finds no ``jpeglib.h``."""
    if not TNL.available() and "jpeglib.h" in (TNL.unavailable_reason()
                                               or ""):
        pytest.skip(f"no libjpeg headers: {TNL.unavailable_reason()}")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """torch on one thread: the work is tiny, and beside the suite's other
    workers a pool of threads waits on busy cores at every operation."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jpgs(tmp_path_factory):
    d = tmp_path_factory.mktemp("imgs")
    rng = np.random.default_rng(0)
    paths = []
    for i, (h, w) in enumerate(SIZES):
        img = rng.integers(0, 255, size=(h, w, 3), dtype=np.uint8)
        # smooth it a little, so that resizing has structure to keep
        img = ((img.astype(np.int32) + np.roll(img, 1, axis=1)) // 2)
        p = str(d / f"im{i}.jpg")
        Image.fromarray(img.astype(np.uint8)).save(p, quality=90)
        paths.append(p)
    return paths


def _dataset(paths, n=8):
    rng = np.random.default_rng(1)
    ds = []
    for i in range(n):
        x1, y1 = rng.uniform(0.0, 0.5, 2)
        x2, y2 = x1 + rng.uniform(0.1, 0.5), y1 + rng.uniform(0.1, 0.5)
        ds.append({"image_path": paths[i % len(paths)],
                   "boxes_xyxy": [[x1, y1, x2, y2], [0.2, 0.3, 0.6, 0.9]],
                   "labels": [i % 3, 1]})
    return ds


def _snapshot(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            st = os.stat(os.path.join(dirpath, f))
            out[os.path.join(dirpath, f)] = (st.st_size, st.st_mtime_ns)
    return out


def test_builds_into_the_port_build_dir_and_leaves_native_alone(
        tmp_path, monkeypatch):
    native = os.path.join(REPO, "native")
    before = _snapshot(native)
    # the checkout's own library, under detectax_torch/kernels/build
    assert TNL.available()
    assert TNL.library_path() == os.path.join(
        REPO, "detectax_torch", "kernels", "build", "libdx_image.so")
    assert TNL.SOURCE == os.path.join(native, "dx_image.cpp")
    # a fresh build, into an empty directory
    monkeypatch.setattr(TNL, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(TNL, "_lib", None)
    monkeypatch.setattr(TNL, "_reason", None)
    monkeypatch.setattr(TNL, "_build_seconds", None)
    assert TNL.available(), TNL.unavailable_reason()
    assert TNL.build_seconds() is not None
    assert TNL.unavailable_reason() is None
    assert sorted(os.listdir(tmp_path / "build")) == ["libdx_image.so"]
    assert _snapshot(native) == before


def test_decoders_equal_the_jax_binding(jpgs):
    assert JNL.available()
    for p, (h, w) in zip(jpgs, SIZES):
        assert TNL.image_info(p) == JNL.image_info(p) == (h, w)
        for out_hw in ((h, w), (64, 96), (h // 3 + 1, w * 2 - 1), (1, 1)):
            got = TNL.decode_resize(p, *out_hw)
            assert got.shape == (*out_hw, 3) and got.dtype == np.float32
            np.testing.assert_array_equal(got, JNL.decode_resize(p, *out_hw))
    out_hw = [(32, 32), (17, 90), (64, 48)]
    got = TNL.decode_resize_batch(jpgs, out_hw, num_threads=3)
    want = JNL.decode_resize_batch(jpgs, out_hw, num_threads=2)
    for g, w, p, hw in zip(got, want, jpgs, out_hw):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, TNL.decode_resize(p, *hw))


def test_decode_errors_match(tmp_path):
    bad = str(tmp_path / "bad.jpg")
    with open(bad, "wb") as f:
        f.write(b"\xff\xd8 not a jpeg")
    for fn in (lambda: TNL.image_info(bad),
               lambda: TNL.decode_resize(bad, 8, 8),
               lambda: TNL.decode_resize_batch([bad], [(8, 8)])):
        with pytest.raises(IOError):
            fn()


LOADER_CASES = {
    "resize_pad_jitter_flip": dict(jitter=(40.0, 64.0), flip=True),
    "stretch_center_jitter_per_batch": dict(
        mode="stretch", pad_position="center", jitter=(32.0, 64.0),
        jitter_per_batch=True, flip=True),
    "hourglass_augment_uint8": dict(augment="hourglass", emit_uint8=True),
}


@pytest.mark.parametrize("case", sorted(LOADER_CASES))
def test_native_loader_batches_equal_jax(jpgs, case):
    common = dict(batch_size=4, canvas=64, max_boxes=4, steps=2, seed=3,
                  prefetch=0, native=True, **LOADER_CASES[case])
    ds = _dataset(jpgs)
    got = list(TLoader(ds, **common))
    want = list(JLoader(ds, **common))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=f"{case} {k}")


def test_native_path_close_to_pil(jpgs):
    ds = _dataset(jpgs[:1], n=4)
    common = dict(batch_size=2, canvas=64, max_boxes=4, steps=1,
                  flip=False, shuffle=False, prefetch=0)
    b_native = next(iter(TLoader(ds, native=True, **common)))
    b_pil = next(iter(TLoader(ds, native=False, **common)))
    b_default = next(iter(TLoader(ds, **common)))
    np.testing.assert_array_equal(b_native["boxes"], b_pil["boxes"])
    diff = np.abs(b_native["images"] - b_pil["images"]).mean()
    assert diff < PIL_MEAN_DIFF, diff
    assert diff > 0  # the two decoders really ran
    # native=None takes the native path where the library loads
    np.testing.assert_array_equal(b_default["images"], b_native["images"])


def test_failed_decode_falls_back_to_pil(tmp_path, monkeypatch, capsys):
    """A CMYK JPEG (libjpeg will not convert it to RGB) and a simulated
    failure each fall back to PIL with the JAX package's printed line."""
    rng = np.random.default_rng(0)
    cmyk = str(tmp_path / "cmyk.jpg")
    Image.fromarray(rng.integers(0, 255, (40, 60, 3), dtype=np.uint8)) \
        .convert("CMYK").save(cmyk)
    ds = [{"image_path": cmyk,
           "boxes_xyxy": np.asarray([[0.1, 0.1, 0.5, 0.5]], np.float32),
           "labels": np.asarray([0], np.int32)}]
    common = dict(batch_size=1, canvas=32, max_boxes=4, flip=False,
                  shuffle=False, prefetch=0)
    got = next(iter(TLoader(ds, native=True, **common)))
    said = capsys.readouterr().out
    want = next(iter(JLoader(ds, native=True, **common)))
    assert said == capsys.readouterr().out
    assert said.startswith(f"native decode failed for {cmyk!r}")
    assert said.rstrip().endswith("falling back to PIL")
    pil = next(iter(TLoader(ds, native=False, **common)))
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        np.testing.assert_array_equal(got[k], pil[k], err_msg=k)

    def boom(*a, **k):
        raise IOError("simulated CMYK decode failure")

    rgb = str(tmp_path / "img.jpg")
    Image.fromarray(rng.integers(0, 255, (40, 60, 3), dtype=np.uint8)) \
        .save(rgb)
    ds[0]["image_path"] = rgb
    monkeypatch.setattr(TNL, "image_info", boom)
    monkeypatch.setattr(TNL, "decode_resize", boom)
    batch = next(iter(TLoader(ds, native=True, **common)))
    assert "simulated CMYK decode failure" in capsys.readouterr().out
    assert batch["images"].shape == (1, 32, 32, 3)
    assert batch["valid"][0, 0]


def test_native_true_without_the_library_raises(tmp_path, monkeypatch,
                                                jpgs):
    broken = tmp_path / "dx_image.cpp"
    broken.write_text("#include <no_such_header_here.h>\n")
    monkeypatch.setattr(TNL, "SOURCE", str(broken))
    monkeypatch.setattr(TNL, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(TNL, "_lib", None)
    monkeypatch.setattr(TNL, "_reason", None)
    assert not TNL.available()
    reason = TNL.unavailable_reason()
    assert "no_such_header_here.h" in reason  # the compiler's own words
    ds = _dataset(jpgs[:1], n=2)
    with pytest.raises(RuntimeError, match="no_such_header_here"):
        TLoader(ds, batch_size=2, canvas=32, native=True)
    with pytest.raises(RuntimeError, match="native loader unavailable"):
        TNL.image_info(jpgs[0])
    # asked for nothing, the loader takes the PIL path quietly
    common = dict(batch_size=2, canvas=32, max_boxes=4, steps=1,
                  shuffle=False, prefetch=0)
    np.testing.assert_array_equal(
        next(iter(TLoader(ds, **common)))["images"],
        next(iter(TLoader(ds, native=False, **common)))["images"])
