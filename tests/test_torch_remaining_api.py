"""PyTorch port, the last public functions of the JAX package, on the CPU
against it: ``data/datasets.load_labels_cached`` (the label arrays
exact; its cache written, hit and invalidated by a changed file size; the
port's key holds ``nc`` too), ``utils/general.apply_classifier`` (crops
through the port's C++ resize equal to cv2's, the keep-mask equal, with
cv2 and PIL blocked), the six box helpers of ``ops/boxes.py`` (exact) and
model YAML paths without PyYAML: ``data/hyps.load_flat_yaml`` against
``yaml.safe_load`` on the reference grammar (equal where it reads,
ValueError naming the line where it does not), ``parse_model_config`` of
a path equal to JAX's ModelSpec, and one train CLI run from a YAML path,
all with ``yaml`` blocked."""

import dataclasses
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from multispectral_object_detection_tpu.data import datasets as jax_datasets
from multispectral_object_detection_tpu.models import parser as jax_parser
from multispectral_object_detection_tpu.ops import boxes as jax_boxes
from multispectral_object_detection_tpu.utils import general as jax_general
from multispectral_object_detection_tpu_torch.cli import train_cli
from multispectral_object_detection_tpu_torch.data import datasets
from multispectral_object_detection_tpu_torch.data.hyps import load_flat_yaml
from multispectral_object_detection_tpu_torch.data.synthetic import (
    make_paired_dataset)
from multispectral_object_detection_tpu_torch.models import configs, parser
from multispectral_object_detection_tpu_torch.ops import boxes
from multispectral_object_detection_tpu_torch.utils import general
from tests._torch_port import share_torch_threads  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
L_YAML = ROOT / "tests" / "data" / "yolov5l_fusion_transformerx3.yaml"


def _block(monkeypatch, *names):
    for name in names:
        monkeypatch.setitem(sys.modules, name, None)


# --------------------------------------------------------- label cache
def test_load_labels_cached_write_hit_and_invalidation(tmp_path,
                                                       monkeypatch):
    rgb, _ = make_paired_dataset(str(tmp_path / "data"), n_images=5,
                                 img_size=32, nc=2, seed=3)
    files = datasets.list_images(rgb)
    Path(datasets.image_to_label_path(files[1])).unlink()  # no label file
    port_dir, jax_dir = tmp_path / "port", tmp_path / "jax"

    def check():
        want = jax_datasets.load_labels_cached(files, str(jax_dir), nc=2)
        got = datasets.load_labels_cached(files, str(port_dir), nc=2)
        assert len(got) == len(want) == 5 and len(got[1]) == 0
        for a, b in zip(got, want):
            assert a.dtype == np.float32 and a.shape == (len(b), 5)
            np.testing.assert_array_equal(a, b)
        return got

    first = check()
    assert len(list(port_dir.glob("labels_*.npz"))) == 1
    with monkeypatch.context() as m:  # a hit reads no label file
        m.setattr(datasets, "read_label_file", lambda *a: pytest.fail("read"))
        for a, b in zip(datasets.load_labels_cached(files, str(port_dir),
                                                    nc=2), first):
            np.testing.assert_array_equal(a, b)
    lab = Path(datasets.image_to_label_path(files[0]))
    lab.write_text(lab.read_text() + "1 0.5 0.5 0.25 0.25\n")
    assert len(check()[0]) == len(first[0]) + 1  # the size changed the key
    assert len(list(port_dir.glob("labels_*.npz"))) == 2
    datasets.load_labels_cached(files, str(port_dir))  # nc is in the key
    assert len(list(port_dir.glob("labels_*.npz"))) == 3


# ------------------------------------------------ second-stage classifier
def _recorder(store: list, logits: bool):
    """A seeded stand-in classifier: a fixed projection of each crop's
    mean colour; records the batch it was given."""
    proj = np.random.default_rng(5).standard_normal((3, 4)).astype(np.float32)

    def classify(ims):
        store.append(ims.copy())
        scores = ims.mean(axis=(1, 2)) @ proj
        return torch.from_numpy(scores) if logits else scores.argmax(1)
    return classify


@pytest.mark.parametrize("logits", [True, False], ids=["logits", "ids"])
def test_apply_classifier_matches_jax(logits, monkeypatch):
    rng = np.random.default_rng(0)
    im0 = rng.integers(0, 256, (120, 160, 3), dtype=np.uint8)
    xy = rng.uniform(0, 140, (6, 2))
    wh = rng.uniform(4, 60, (6, 2))
    edge = np.array([[0, 0, 12, 9], [150, 110, 160, 120], [-8, 40, 30, 90],
                     [100, 0, 165, 4], [60, 60, 60, 60]], np.float32)
    b = np.concatenate([np.concatenate([xy, xy + wh], 1), edge]).astype(
        np.float32)
    classes = rng.integers(0, 4, len(b))
    jax_ims, port_ims = [], []
    want = jax_general.apply_classifier(b, classes, im0,
                                        _recorder(jax_ims, logits), size=64)
    _block(monkeypatch, "cv2", "PIL")
    got = general.apply_classifier(b, classes, im0,
                                   _recorder(port_ims, logits), size=64)
    np.testing.assert_array_equal(port_ims[0], jax_ims[0])
    np.testing.assert_array_equal(got, want)
    assert got.dtype == bool and 0 < got.sum() < len(b)
    assert general.apply_classifier(np.zeros((0, 4)), [], im0,
                                    pytest.fail).shape == (0,)


# ----------------------------------------------------------- box helpers
_BOX_FNS = {
    "xyxy_to_xywh": lambda B, b: B.xyxy_to_xywh(b),
    "xywhn_to_xyxy": lambda B, b: B.xywhn_to_xyxy(b, 640, 480, 10, 20),
    "xyxy_to_xywhn": lambda B, b: B.xyxy_to_xywhn(b * 640, 640, 480),
    "clip_xyxy": lambda B, b: B.clip_xyxy(b * 800 - 80, 480, 640),
    "rescale_coords": lambda B, b: B.rescale_coords(b * 640, (640, 640),
                                                    (480, 600)),
    "rescale_coords_ratio_pad": lambda B, b: B.rescale_coords(
        b * 640, (384, 640), (480, 800), ((0.8, 0.8), (0.0, 0.0))),
    "pairwise_wh_iou": lambda B, b: B.pairwise_wh_iou(b[..., 2:] * 50 + 1,
                                                      b[..., :3, :2] * 50 + 1),
}


@pytest.mark.parametrize("name", list(_BOX_FNS))
def test_box_helpers_equal_jax(name):
    """Exact: the same float32 operations in the same order."""
    b = np.random.default_rng(1).random((2, 7, 4), dtype=np.float32)
    want = np.asarray(_BOX_FNS[name](jax_boxes, jnp.asarray(b)))
    got = _BOX_FNS[name](boxes, torch.from_numpy(b))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


# --------------------------------------------------- model YAML paths
# tests/test_model.py's reference-format text
_REFERENCE_TEXT = """
nc: 80
depth_multiple: 0.33
width_multiple: 0.50
anchors:
  - [10,13, 16,30, 33,23]
  - [30,61, 62,45, 59,119]
  - [116,90, 156,198, 373,326]
backbone:
  [[-1, 1, Focus, [64, 3]],
   [-1, 1, Conv, [128, 3, 2]],
   [-1, 3, C3, [128]],
   [-1, 1, Conv, [256, 3, 2]],
   [-1, 9, C3, [256]]]
head:
  [[[2, 4], 1, Concat, [1]],
   [[4], 1, Detect, [nc, anchors]]]
"""
_READ = [
    _REFERENCE_TEXT,
    L_YAML.read_text(),
    "a: [1, 2, ]\nb: [ ]\nc: [\n]\n",
    "a: [foo bar, a#b, nn.Upsample, None, ~, null, yes, On, -x, +2, -1]",
    "a: ['it''s', \"x\\\"y\", 'a, b', \"c]\"]  # comment",
    "a:\n  # [from, number, module, args]\n  [[1, 2],  # one\n\n   [3]]  # two\n"
    "b: 1",
    "---\na: [1,\n2]\nb: 3\n...\n",
    "a:\n- [1,\n2]\n- [3, [4, [5]]]\n- x\n",
    "a: .5\nb: 1.0e+5\nc: -.inf\nd: ../data/x\ne: C:\\data\nf:\n",
    "",
    "# only a comment\n",
]
_REFUSED = [
    "a: [1, , 2]", "a: [x: 1]", "a: [b\n c]", "a:\n[1, 2]", "a: [1]]",
    "a: [1] x", "- 1", "a: [1.0e5, 012]", "a: 0x1f", "a: 1:30",
    "a: 2001-12-14", "a: b: c", "a: {b: 1}", "a: [{b: 1}]", "a: &x 1",
    "a:\n  b: 1\n", "a: ['x\n']", "a: [1, 2", "a: [<<]", "a: 1\n---\n",
    "a: 1\n...\nb: 2", "--- a: 1",
]


@pytest.mark.parametrize("text", _READ, ids=range(len(_READ)))
def test_yaml_reader_equals_pyyaml(text):
    assert load_flat_yaml(text) == yaml.safe_load(text)


@pytest.mark.parametrize("text", _REFUSED, ids=range(len(_REFUSED)))
def test_yaml_reader_refuses_what_it_does_not_read(text):
    with pytest.raises(ValueError, match=r"line \d+"):
        load_flat_yaml(text)


def test_reference_yaml_is_the_ports_config():
    assert load_flat_yaml(L_YAML.read_text()) == configs.get_config(
        "yolov5l_fusion_transformerx3", nc=1)


@pytest.mark.parametrize("text", [_REFERENCE_TEXT, L_YAML.read_text()],
                         ids=["test_model", "l_transformerx3"])
def test_parse_model_config_of_a_path_without_pyyaml(text, tmp_path,
                                                     monkeypatch):
    path = tmp_path / "model.yaml"
    path.write_text(text)
    want = dataclasses.asdict(jax_parser.parse_model_config(str(path)))
    _block(monkeypatch, "yaml")
    got = dataclasses.asdict(parser.parse_model_config(str(path)))
    assert got == want


def test_train_cli_from_a_model_yaml_without_pyyaml(tmp_path, monkeypatch):
    """The n-scale two-stream CFT model from the reference-grammar YAML
    (the l file with the n scale's multiples), one epoch."""
    rgb, ir = make_paired_dataset(str(tmp_path / "data"), n_images=4,
                                  img_size=64, nc=1, seed=2)
    cfg = tmp_path / "n.yaml"
    cfg.write_text(L_YAML.read_text().replace(
        "depth_multiple: 1.0", "depth_multiple: 0.33").replace(
        "width_multiple: 1.0", "width_multiple: 0.25"))
    _block(monkeypatch, "yaml")
    args = train_cli.parse_args(
        ["--data", "unused", "--cfg", str(cfg), "--epochs", "1",
         "--batch-size", "4", "--img-size", "64", "--fp32", "--device",
         "cpu", "--nosave", "--project", str(tmp_path / "runs")])
    args.data = {"train_rgb": rgb, "train_ir": ir, "val_rgb": rgb,
                 "val_ir": ir, "nc": 1, "names": ["a"]}
    out = train_cli.run(args)
    assert out["eval_forwards"] > 0
    assert all(np.isfinite(out[k]) for k in ("mp", "mr", "map50", "map"))
