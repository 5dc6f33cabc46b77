"""The port's dataset converters and index against the JAX package's, on
the CPU: the same annotations (the fixtures of `tests/test_data_converters
.py`) give the same index JSON, byte for byte; the `cli.convert_*`
wrappers run; the port's `IndexDataset` feeds the port's `Loader`, which
gives the JAX loader's batches exactly."""
import json
import os

import numpy as np
import pytest
import torch

from detectax.data import convert_coco as JCOCO
from detectax.data import convert_crowdhuman as JCH
from detectax.data import convert_voc as JVOC
from detectax.data import index as JI
from detectax.data.pipeline import Loader as JLoader
from detectax_torch.cli import convert_coco as CLI_COCO
from detectax_torch.cli import convert_crowdhuman as CLI_CH
from detectax_torch.cli import convert_voc as CLI_VOC
from detectax_torch.data import convert_coco as TCOCO
from detectax_torch.data import convert_crowdhuman as TCH
from detectax_torch.data import convert_voc as TVOC
from detectax_torch.data import index as TI
from detectax_torch.data.pipeline import Loader as TLoader
from test_data_converters import VOC_XML, _write_jpg

# a second VOC file layout: several objects, a difficult flag, classes in
# another order, pixel corners that do not divide evenly
VOC_XML_MANY = """<annotation>
  <filename>{name}.jpg</filename>
  <size><width>333</width><height>187</height><depth>3</depth></size>
  <object><name>tvmonitor</name><difficult>1</difficult>
    <bndbox><xmin>3</xmin><ymin>7</ymin><xmax>211</xmax><ymax>99</ymax></bndbox>
  </object>
  <object><name>aeroplane</name>
    <bndbox><xmin>17</xmin><ymin>1</ymin><xmax>332</xmax><ymax>186</ymax></bndbox>
  </object>
  <object><name>cat</name>
    <bndbox><xmin>100</xmin><ymin>50</ymin><xmax>101</xmax><ymax>51</ymax></bndbox>
  </object>
</annotation>"""

COCO = {
    "images": [{"id": 7, "file_name": "a.jpg", "width": 100, "height": 100},
               {"id": 2, "file_name": "b.jpg", "width": 640, "height": 427}],
    "categories": [{"id": 9, "name": "dog"}, {"id": 3, "name": "cat"},
                   {"id": 44, "name": "bottle"}],
    "annotations": [
        {"image_id": 7, "category_id": 9, "bbox": [10, 20, 30, 40],
         "iscrowd": 0},
        {"image_id": 7, "category_id": 3, "bbox": [0, 0, 0, 10],
         "iscrowd": 0},
        {"image_id": 2, "category_id": 44, "bbox": [1.5, 2.25, 300.1, 17],
         "iscrowd": 0},
        {"image_id": 2, "category_id": 3, "bbox": [5, 5, 50, 50],
         "iscrowd": 1},
        {"image_id": 99, "category_id": 3, "bbox": [5, 5, 50, 50],
         "iscrowd": 0},
        {"image_id": 7, "category_id": 44, "bbox": [60, 61, 39, 38.5]},
    ],
}

ODGT = [
    {"ID": "x", "gtboxes": [
        {"tag": "person", "fbox": [40, 20, 80, 100], "extra": {}},
        {"tag": "person", "fbox": [0, 0, 50, 50], "extra": {"ignore": 1}},
        {"tag": "mask", "fbox": [0, 0, 10, 10], "extra": {}},
        {"tag": "person", "fbox": [-10, 150, 500, 90]},
    ]},
    {"ID": "missing", "gtboxes": [
        {"tag": "person", "fbox": [1, 1, 5, 5], "extra": {}}]},
    {"ID": "y", "gtboxes": [
        {"tag": "person", "fbox": [1, 1, 0, 5], "extra": {}}]},
]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """torch on one thread: the work is tiny, and beside the suite's other
    workers a pool of threads waits on busy cores at every operation."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _voc_tree(root, n=4):
    ann, img = root / "ann", root / "img"
    ann.mkdir()
    img.mkdir()
    for i in range(n):
        xml = VOC_XML if i % 2 == 0 else VOC_XML_MANY
        (ann / f"s{i}.xml").write_text(xml.format(name=f"s{i}"))
        _write_jpg(img / f"s{i}.jpg")
    (ann / "README.txt").write_text("not an annotation")
    return str(ann), str(img)


def _same_file(a, b):
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()


def test_index_defaults_and_save_index_match(tmp_path):
    assert TI.DEFAULT_SIZES == JI.DEFAULT_SIZES
    samples = [{"image_path": "a.jpg", "boxes_xyxy": [[0.1, 0.2, 0.3, 0.4]],
                "labels": [2], **TI.DEFAULT_SIZES}]
    TI.save_index(str(tmp_path / "t" / "i.json"), ("a", "b", "c"), samples)
    JI.save_index(str(tmp_path / "j" / "i.json"), ("a", "b", "c"), samples)
    _same_file(tmp_path / "t" / "i.json", tmp_path / "j" / "i.json")
    assert TI.load_index(str(tmp_path / "t" / "i.json")) == (
        ["a", "b", "c"], samples)


@pytest.mark.parametrize("sizes", [{}, {"min_side": 512, "u_jitter": 480}])
def test_voc_index_equals_jax(tmp_path, sizes):
    ann, img = _voc_tree(tmp_path)
    got = TVOC.convert(ann, img, str(tmp_path / "t.json"), **sizes)
    want = JVOC.convert(ann, img, str(tmp_path / "j.json"), **sizes)
    assert got == want == (4, 2)  # one unknown class in each VOC_XML file
    _same_file(tmp_path / "t.json", tmp_path / "j.json")
    assert TVOC.VOC_CLASSES == JVOC.VOC_CLASSES
    assert TVOC.parse_voc_xml(os.path.join(ann, "s1.xml")) == \
        JVOC.parse_voc_xml(os.path.join(ann, "s1.xml"))


@pytest.mark.parametrize("prepend_objectness", [False, True])
def test_coco_index_equals_jax(tmp_path, prepend_objectness):
    jf = tmp_path / "inst.json"
    jf.write_text(json.dumps(COCO))
    kw = dict(prepend_objectness=prepend_objectness, l_jitter=300)
    got = TCOCO.convert(str(jf), "imgs", str(tmp_path / "t.json"), **kw)
    want = JCOCO.convert(str(jf), "imgs", str(tmp_path / "j.json"), **kw)
    assert got == want == (2, 3)
    _same_file(tmp_path / "t.json", tmp_path / "j.json")


def test_crowdhuman_index_equals_jax(tmp_path):
    img_dir = tmp_path / "imgs"
    img_dir.mkdir()
    _write_jpg(img_dir / "x.jpg", 400, 200)
    _write_jpg(img_dir / "y.jpg", 64, 48)
    f = tmp_path / "ann.odgt"
    f.write_text("\n".join(json.dumps(r) for r in ODGT) + "\n\n")
    got = TCH.convert(str(f), str(img_dir), str(tmp_path / "t.json"),
                      min_side=640)
    want = JCH.convert(str(f), str(img_dir), str(tmp_path / "j.json"),
                       min_side=640)
    assert got == want == (1, 2)
    _same_file(tmp_path / "t.json", tmp_path / "j.json")


@pytest.mark.parametrize("which", ["voc", "coco", "crowdhuman"])
def test_convert_cli_wrappers_run(tmp_path, capsys, which):
    if which == "voc":
        ann, img = _voc_tree(tmp_path)
        args = ["--annotations_dir", ann, "--images_dir", img,
                "--max_side", "400"]
        cli, jax_main = CLI_VOC, JVOC.main
    elif which == "coco":
        jf = tmp_path / "inst.json"
        jf.write_text(json.dumps(COCO))
        args = ["--instances_json", str(jf), "--images_dir", "imgs",
                "--prepend_objectness"]
        cli, jax_main = CLI_COCO, JCOCO.main
    else:
        img_dir = tmp_path / "imgs"
        img_dir.mkdir()
        _write_jpg(img_dir / "x.jpg", 400, 200)
        f = tmp_path / "ann.odgt"
        f.write_text(json.dumps(ODGT[0]) + "\n")
        args = ["--odgt", str(f), "--images_dir", str(img_dir)]
        cli, jax_main = CLI_CH, JCH.main
    cli.main(args + ["--output", str(tmp_path / "t.json")])
    said = capsys.readouterr().out
    jax_main(args + ["--output", str(tmp_path / "j.json")])
    assert said.replace("t.json", "j.json") == capsys.readouterr().out
    _same_file(tmp_path / "t.json", tmp_path / "j.json")


def test_index_dataset_feeds_port_loader(tmp_path):
    ann, img = _voc_tree(tmp_path)
    out = str(tmp_path / "voc.json")
    TVOC.convert(ann, img, out)
    ds = TI.IndexDataset(out)
    assert ds.num_classes == 20 and len(ds) == 4
    assert ds.id_to_label == JI.IndexDataset(out).id_to_label
    common = dict(batch_size=2, canvas=128, max_boxes=8, steps=2,
                  prefetch=0, seed=5)
    got = list(TLoader(ds, **common))
    want = list(JLoader(JI.IndexDataset(out), **common))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g["images"].shape == (2, 128, 128, 3)
        assert g["valid"].sum() == w["valid"].sum() >= 4
        for k in ("images", "boxes", "labels", "valid"):
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
