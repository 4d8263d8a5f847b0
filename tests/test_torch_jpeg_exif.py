"""PyTorch port, JPEG input without PIL or cv2 (the card has neither),
against the JAX package (which reads files through cv2 and checks them
with PIL) on the committed fixtures of ``tests/data/jpeg/variants``
(``tools/make_jpeg_fixtures.py``): the dataset scan of a JPEG pair set
(EXIF-rotated, progressive, gray, CMYK, garbage and truncated files) equal
to JAX's in ``keep``, ``shapes``, labels and counters, and evaluated by
the test CLI (``--save-hybrid``) without PIL, cv2 or yaml; ``jpeg_info``
against PIL's size and EXIF tag; ``imread`` of EXIF orientations 1-8 (a
little- and a big-endian block) equal to ``cv2.imread``, and ``imdecode``
(the REST service's decode) not turned, as PIL's is not; ``load_scaled``
and ``Detector.__call__`` on an orientation-6 pair equal to JAX's; CMYK
and YCCK files decoded to cv2's pixels; a BMP entry without Pillow stops
the scan with an error naming BMP. Pixels and labels exact, boxes within
the serving tests' tolerance (fp32 summation order)."""

import io
import shutil
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

from multispectral_object_detection_tpu import hub as jhub
from multispectral_object_detection_tpu.data import augment as jax_augment
from multispectral_object_detection_tpu.data import datasets as jax_datasets
from multispectral_object_detection_tpu_torch import hub
from multispectral_object_detection_tpu_torch.cli import test_cli
from multispectral_object_detection_tpu_torch.data import (augment, datasets,
                                                           imageio, native)
from tests._torch_port import (  # noqa: F401
    mini_weights, share_torch_threads, write_jax_checkpoint)
from tests.test_torch_serve import _assert_results_match

ROOT = Path(__file__).resolve().parents[1]
VARIANTS = ROOT / "tests" / "data" / "jpeg" / "variants"
ORIENTS = [f"orient_{o}" for o in range(1, 9)] + ["orient_6_mm"]


def _block(monkeypatch, *names):
    for name in names:
        monkeypatch.setitem(sys.modules, name, None)


def _cv2_rgb(path, flags=cv2.IMREAD_COLOR):
    return cv2.imread(str(path), flags)[:, :, ::-1]


@pytest.fixture(scope="module")
def pair_set(tmp_path_factory):
    """rgb/images + ir/images + rgb/labels: the variant fixtures, a
    garbage .jpg, a JPEG cut inside its scan and one cut inside its
    headers; every RGB file with a label file of two rows."""
    root = tmp_path_factory.mktemp("jpegset")
    small = (ROOT / "tests" / "data" / "jpeg" / "small_rgb.jpg").read_bytes()
    sos = small.index(b"\xff\xda")
    files = {p.stem: p.read_bytes() for p in sorted(VARIANTS.glob("*.jpg"))}
    files.update(small=small, garbage=b"not an image " * 8,
                 cut_in_scan=small[:sos + 40], cut_in_header=small[:sos - 9])
    rgb, ir = [], []
    for k, (stem, data) in enumerate(files.items()):
        for side, out in (("rgb", rgb), ("ir", ir)):
            p = root / side / "images" / f"{k:02d}_{stem}.jpg"
            p.parent.mkdir(parents=True, exist_ok=True)
            p.write_bytes(data)
            out.append(str(p))
        lab = root / "rgb" / "labels" / f"{k:02d}_{stem}.txt"
        lab.parent.mkdir(parents=True, exist_ok=True)
        lab.write_text(f"0 0.5 0.5 0.2 0.3\n{k % 2} 0.25 0.4 0.1 0.1\n")
    return rgb, ir


def test_scan_of_a_jpeg_pair_set_without_pil_equals_jax(pair_set,
                                                        monkeypatch):
    """F8: the port's scan read no JPEG without Pillow. The verdicts pinned
    here are JAX's (PIL's open): a file cut inside its scan data is kept,
    one cut inside its headers and the garbage file are corrupt."""
    rgb, ir = pair_set
    want = jax_datasets.scan_pair_cached(rgb, ir, nc=2)
    _block(monkeypatch, "PIL", "cv2")
    got = datasets.scan_pair_cached(rgb, ir, nc=2)
    assert got["counters"] == want["counters"]
    assert got["counters"]["corrupt"] == 4  # 2 files x RGB and IR
    np.testing.assert_array_equal(got["keep"], want["keep"])
    kept = {Path(p).stem.split("_", 1)[1] for p, k in zip(rgb, got["keep"])
            if k}
    assert "cut_in_scan" in kept and not kept & {"garbage", "cut_in_header"}
    np.testing.assert_array_equal(got["shapes"], want["shapes"])
    for a, b in zip(got["labels"], want["labels"]):
        np.testing.assert_array_equal(a, b)
    # orientations 6 and 8 swap the size, 5 and 7 keep it (JAX's quirk)
    shapes = dict(zip((Path(p).stem.split("_", 1)[1] for p in rgb),
                      got["shapes"].tolist()))
    assert shapes["orient_6"] == shapes["orient_8"] == [48.0, 32.0]
    assert shapes["orient_5"] == shapes["orient_7"] == [32.0, 48.0]


def test_test_cli_evaluates_the_jpeg_pair_set_without_pil_or_cv2(
        pair_set, tmp_path, monkeypatch):
    """The scan's 14 kept pairs (the garbage file and the one cut in its
    headers dropped) evaluated with the ground truth injected
    (``--save-hybrid``): every labelled box is found."""
    w = mini_weights(0)
    ckpt = write_jax_checkpoint(tmp_path / "cft", w["params"], w["stats"])
    rgb, ir = pair_set
    _block(monkeypatch, "PIL", "cv2", "yaml")
    args = test_cli.parse_args(
        ["--device", "cpu", "--data", "unused", "--cfg",
         "yolov5n_fusion_transformerx3", "--weights", ckpt, "--img-size",
         "64", "--batch-size", "4", "--fp32", "--save-hybrid", "--project",
         str(tmp_path / "runs")])
    args.data = {"val_rgb": str(Path(rgb[0]).parent),
                 "val_ir": str(Path(ir[0]).parent), "nc": 2}
    res = test_cli.run(args)
    assert res["seen"] == 14
    assert res["map50"] > 0.95 and res["map"] > 0.95


@pytest.mark.parametrize("stem", ["progressive", "orient_6_mm", "cmyk",
                                  "gray"])
def test_jpeg_info_against_pil(stem):
    path = VARIANTS / f"{stem}.jpg"
    info = imageio.jpeg_info(path)
    with Image.open(path) as im:
        assert (info.width, info.height) == im.size
        assert info.orientation == (im.getexif().get(274) or 1)
        assert info.components == len(im.getbands())


def test_jpeg_header_errors_are_value_errors():
    small = (ROOT / "tests" / "data" / "jpeg" / "small_rgb.jpg").read_bytes()
    for data in (b"GIF89a", small[:2], small[:30], b"\xff\xd8\xff\x01"):
        with pytest.raises(ValueError):
            imageio.read_jpeg_header(io.BytesIO(data))


def test_a_bmp_without_pillow_stops_the_scan_naming_it(tmp_path,
                                                       monkeypatch):
    p = tmp_path / "images" / "a.bmp"
    p.parent.mkdir()
    cv2.imwrite(str(p), np.zeros((16, 16, 3), np.uint8))
    assert datasets.scan_dataset([str(p)], with_labels=False)["keep"].all()
    _block(monkeypatch, "PIL")
    with pytest.raises(ImportError, match="a BMP image.*Pillow"):
        datasets.scan_dataset([str(p)], with_labels=False)


@pytest.mark.parametrize("stem", ORIENTS)
def test_imread_turns_by_exif_orientation_as_cv2(stem, monkeypatch):
    """F9: the port's imread ignored the EXIF orientation."""
    path = VARIANTS / f"{stem}.jpg"
    want = _cv2_rgb(path)
    np.testing.assert_array_equal(np.load(VARIANTS / "decode.npz")[stem],
                                  want)
    # the REST service's decode is not turned, as JAX's PIL decode is not
    data = path.read_bytes()
    with Image.open(io.BytesIO(data)) as im:
        pil = np.asarray(im.convert("RGB"))
    flat = _cv2_rgb(path, cv2.IMREAD_COLOR | cv2.IMREAD_IGNORE_ORIENTATION)
    _block(monkeypatch, "PIL", "cv2")
    np.testing.assert_array_equal(imageio.imread(path), want)
    np.testing.assert_array_equal(imageio.imdecode(data), flat)
    assert imageio.imdecode(data).shape == pil.shape


def test_cv2_route_turns_once(monkeypatch):
    """Without a native JPEG decoder the bytes go to cv2, which turns
    them itself: imread turns once, imdecode not at all."""
    monkeypatch.setattr(native, "jpeg_available", lambda: False)
    path = VARIANTS / "orient_6.jpg"
    np.testing.assert_array_equal(imageio.imread(path), _cv2_rgb(path))
    np.testing.assert_array_equal(
        imageio.imdecode(path.read_bytes()),
        _cv2_rgb(path, cv2.IMREAD_COLOR | cv2.IMREAD_IGNORE_ORIENTATION))


def test_load_scaled_of_an_orientation_6_file_equals_jax(monkeypatch):
    path = str(VARIANTS / "orient_6.jpg")
    want = jax_augment.load_scaled(path, 64)
    _block(monkeypatch, "PIL", "cv2")
    got = augment.load_scaled(path, 64)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1] == (48, 32)


def test_detector_serves_an_exif_rotated_pair_as_jax(tmp_path, monkeypatch):
    w = mini_weights(0)
    ckpt = write_jax_checkpoint(tmp_path / "cft", w["params"], w["stats"])
    name = "yolov5n_fusion_transformerx3"
    rgb, ir = [str(VARIANTS / "orient_6.jpg")], [str(VARIANTS /
                                                     "orient_6_mm.jpg")]
    want = jhub.Detector(name, nc=2, weights=ckpt, img_size=64,
                         conf=0.01)(rgb, ir)
    _block(monkeypatch, "PIL", "cv2")
    got = hub.Detector(name, nc=2, weights=ckpt, img_size=64, conf=0.01,
                       dtype=torch.float32, device="cpu")(rgb, ir)
    assert got.images[0].shape == (48, 32, 3)
    _assert_results_match(got, want)


def _ycck(data: bytes) -> bytes:
    """The CMYK fixture with its Adobe transform flag set to 2 (YCCK):
    libjpeg then reads its planes as YCCK, in cv2 as in the port."""
    i = data.index(b"Adobe") + 11
    return data[:i] + b"\x02" + data[i + 1:]


@pytest.mark.parametrize("kind", ["cmyk", "ycck"])
def test_cmyk_and_ycck_decode_as_cv2(kind, tmp_path, monkeypatch):
    """F10: libjpeg was asked for RGB and failed on 4-component files."""
    path = VARIANTS / "cmyk.jpg"
    if kind == "ycck":
        path = tmp_path / "ycck.jpg"
        path.write_bytes(_ycck((VARIANTS / "cmyk.jpg").read_bytes()))
        assert imageio.jpeg_info(path).adobe_transform == 2
    want = _cv2_rgb(path)
    _block(monkeypatch, "PIL", "cv2")
    np.testing.assert_array_equal(imageio.imread(path), want)


def test_nvjpeg_route_refuses_ycck_by_name(monkeypatch):
    """nvJPEG returns a YCCK file's planes without the colour transform:
    that route refuses it, naming it, before any library is loaded."""
    monkeypatch.setattr(native, "jpeg_backend", lambda: "jpeg_nvjpeg")
    monkeypatch.setattr(native, "_jpeg_lib", lambda: pytest.fail("loaded"))
    with pytest.raises(ValueError, match="YCCK-coded CMYK JPEG"):
        native.decode_jpeg(_ycck((VARIANTS / "cmyk.jpg").read_bytes()))


def test_committed_variant_fixtures(tmp_path):
    """The fixtures decode to their stored cv2 decodes, stay small, and
    the generator writes the same files again."""
    ref = np.load(VARIANTS / "decode.npz")
    stems = sorted(p.stem for p in VARIANTS.glob("*.jpg"))
    assert stems == sorted(ref.files) and len(stems) == 12
    assert sum(p.stat().st_size for p in VARIANTS.iterdir()) < 100_000
    for stem in stems:
        np.testing.assert_array_equal(imageio.imread(VARIANTS / f"{stem}.jpg"),
                                      ref[stem])
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "_make_jpeg_fixtures", ROOT / "tools" / "make_jpeg_fixtures.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    again = tool.write_variants(tmp_path / "v")
    for stem in stems:
        assert (tmp_path / "v" / f"{stem}.jpg").read_bytes() == (
            VARIANTS / f"{stem}.jpg").read_bytes(), stem
        np.testing.assert_array_equal(again[stem], ref[stem])
    shutil.rmtree(tmp_path / "v")
