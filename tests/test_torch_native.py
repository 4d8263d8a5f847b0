"""PyTorch port, the host image runtime (data/native.py over
data/csrc/{image_ops,jpeg_decode}.cpp) against cv2, as tests/test_native.py
holds the JAX package's copy: JPEG decode, both resizes (cv2's pixels
exactly), the centred pad (exactly), the affine warp and HSV jitter (the
JAX copy's bounds). Also the readers and loaders built on it, against cv2
and the JAX loaders, byte for byte; and the build: into a gitignored
directory of the port, never native/, and a failed build raises the
compiler's message."""

import subprocess
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest

from multispectral_object_detection_tpu.data import augment as jax_augment
from multispectral_object_detection_tpu_torch.data import augment, imageio
from multispectral_object_detection_tpu_torch.data import native
from tests._torch_port import share_torch_threads  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
RNG_SHAPES = [(50, 70, 100, 140), (100, 50, 128, 64), (37, 53, 91, 29),
              (13, 7, 5, 3), (480, 640, 480, 640), (512, 640, 410, 512),
              (1024, 1280, 512, 640), (1, 5, 3, 9)]
AREA_SHAPES = [(128, 128, 64, 48), (1024, 1280, 512, 640),
               (96, 128, 64, 85), (300, 200, 128, 85), (99, 99, 33, 33),
               (256, 256, 64, 64), (99, 101, 31, 29)]


def _img(seed, h, w):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3), np.uint8)


def _jpeg(img, quality=95) -> bytes:
    ok, enc = cv2.imencode(".jpg", img[:, :, ::-1],
                           [cv2.IMWRITE_JPEG_QUALITY, quality])
    assert ok
    return enc.tobytes()


def test_libraries_build_into_the_ports_build_dir():
    for name in ("image_ops", "jpeg_decode"):
        native.library(name)
        path = native.target(name)
        assert path.is_file() and path.parent == native.BUILD_DIR
    assert native.BUILD_DIR.is_relative_to(
        ROOT / "multispectral_object_detection_tpu_torch")
    ignored = subprocess.run(["git", "check-ignore", "-q",
                              str(native.target("image_ops"))], cwd=ROOT)
    assert ignored.returncode == 0


@pytest.mark.parametrize("quality", [95, 75])
@pytest.mark.parametrize("hw", [(64, 96), (33, 47)])
def test_jpeg_decode_matches_cv2(quality, hw):
    """Tolerance: equal to cv2 here (both libjpeg-turbo's default islow
    IDCT and fancy upsampling); the JAX copy's bound, mean |diff| < 2, is
    what another libjpeg build may need."""
    data = _jpeg(_img(0, *hw), quality)
    ours = native.decode_jpeg(data)
    ref = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    assert native.jpeg_size(data) == hw
    np.testing.assert_array_equal(ours, ref[:, :, ::-1])
    with pytest.raises(ValueError):
        native.decode_jpeg(data[:20])


@pytest.mark.parametrize("h,w,dh,dw", RNG_SHAPES)
def test_resize_bilinear_is_cv2_inter_linear(h, w, dh, dw):
    img = _img(1, h, w)
    np.testing.assert_array_equal(
        native.resize(img, dh, dw),
        cv2.resize(img, (dw, dh), interpolation=cv2.INTER_LINEAR))


@pytest.mark.parametrize("h,w,dh,dw", AREA_SHAPES)
def test_resize_area_is_cv2_inter_area(h, w, dh, dw):
    img = _img(2, h, w)
    np.testing.assert_array_equal(
        native.resize(img, dh, dw, area=True),
        cv2.resize(img, (dw, dh), interpolation=cv2.INTER_AREA))


def test_pad_center_matches_the_jax_letterbox():
    img = _img(3, 480, 640)
    ref, _, (dw, dh) = jax_augment.letterbox(img, (640, 640), auto=False)
    ours = native.pad_center(img, 640, 640, int(round(dh - 0.1)),
                             int(round(dw - 0.1)), 114)
    np.testing.assert_array_equal(ours, ref)
    with pytest.raises(ValueError):
        native.pad_center(img, 400, 640, 0, 0)
    with pytest.raises(ValueError):  # checked before the pointers cross
        native.resize(img, 0, 64)


def test_warp_affine_matches_cv2():
    """The JAX copy's float warp: mean |diff| < 2, 99th percentile <= 30
    (interpolation rounding at the border)."""
    img = _img(4, 96, 96)
    M = np.array([[0.9, 0.1, 5.0], [-0.08, 1.05, -3.0]])
    ours = native.warp_affine(img, M, 96, 96, 114)
    ref = cv2.warpAffine(img, M, (96, 96), borderValue=(114, 114, 114))
    diff = np.abs(ours.astype(int) - ref.astype(int))
    assert np.mean(diff) < 2.0 and np.quantile(diff, 0.99) <= 30


def test_hsv_jitter_matches_cv2_luts():
    """cv2's HSV round trip with the gain tables: mean |diff| < 3 (the JAX
    copy's bound: cv2 rounds its HSV conversions in fixed point)."""
    img = _img(5, 64, 64)
    r = [1.01, 1.2, 0.9]
    ours = native.hsv_jitter(img, *r)
    hue, sat, val = cv2.split(cv2.cvtColor(img, cv2.COLOR_RGB2HSV))
    x = np.arange(0, 256, dtype=np.int16)
    luts = (((x * r[0]) % 180).astype(np.uint8),
            np.clip(x * r[1], 0, 255).astype(np.uint8),
            np.clip(x * r[2], 0, 255).astype(np.uint8))
    ref = cv2.cvtColor(cv2.merge([cv2.LUT(ch, lut) for ch, lut in
                                  zip((hue, sat, val), luts)]),
                       cv2.COLOR_HSV2RGB)
    assert np.mean(np.abs(ours.astype(int) - ref.astype(int))) < 3.0
    assert not np.array_equal(ours, img)  # a new array, the input kept


def test_imread_and_imdecode_read_jpeg_as_cv2(tmp_path):
    img = _img(6, 40, 56)
    p = tmp_path / "x.jpg"
    p.write_bytes(_jpeg(img))
    want = cv2.imread(str(p))[:, :, ::-1]
    np.testing.assert_array_equal(imageio.imread(p), want)
    np.testing.assert_array_equal(imageio.imdecode(p.read_bytes()), want)
    png = cv2.imencode(".png", img[:, :, ::-1])[1].tobytes()
    np.testing.assert_array_equal(imageio.imdecode(png), img)
    with pytest.raises(ValueError):
        imageio.imdecode(b"\xff\xd8\xff" + b"\x00" * 64)


def test_load_scaled_and_letterbox_equal_the_jax_loaders(tmp_path):
    """Shrinking (INTER_AREA), growing and the letterbox (INTER_LINEAR) of
    JPEG files give the JAX package's cv2 pixels exactly."""
    for k, hw in enumerate([(96, 128), (40, 30), (130, 90)]):
        p = tmp_path / f"{k}.jpg"
        p.write_bytes(_jpeg(_img(7 + k, *hw)))
        got, want = augment.load_scaled(str(p), 64), \
            jax_augment.load_scaled(str(p), 64)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]
        for shape in ((64, 64), (96, 80)):
            a = augment.letterbox(got[0], shape)
            b = jax_augment.letterbox(want[0], shape, auto=False)
            np.testing.assert_array_equal(a[0], b[0])
            assert a[1:] == b[1:]


_NO_CV2_OR_PIL = """
import sys
sys.modules["cv2"] = None
sys.modules["PIL"] = None
import numpy as np
from multispectral_object_detection_tpu_torch.data import imageio
img = imageio.imread(sys.argv[1])
assert img.shape == (40, 56, 3), img.shape
try:
    imageio.imdecode(b"BM" + bytes(64), "x.bmp")
except ImportError as e:
    assert "cv2" in str(e) and "PIL" in str(e), e
    print("ok", int(img.sum()))
"""


def test_jpeg_reads_without_cv2_or_pil(tmp_path):
    img = _img(6, 40, 56)
    p = tmp_path / "x.jpg"
    p.write_bytes(_jpeg(img))
    r = subprocess.run([sys.executable, "-c", _NO_CV2_OR_PIL, str(p)],
                       cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.split() == ["ok", str(int(
        cv2.imread(str(p))[:, :, ::-1].sum()))]


def test_a_failed_build_raises_the_compiler_message(tmp_path, monkeypatch):
    (tmp_path / "image_ops.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(native, "CSRC", tmp_path)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native, "_LOADED", {})
    with pytest.raises(RuntimeError, match="building image_ops failed"):
        native.resize(_img(0, 4, 4), 2, 2)
    monkeypatch.setenv("CXX", "")
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        native._cxx()


def test_committed_jpeg_fixtures_decode_to_their_npz():
    """tests/data/jpeg (tools/make_jpeg_fixtures.py; chip_smoke.py decodes
    them on the card): the native decode equals cv2's stored decode here,
    and the files stay under 2 MB."""
    d = ROOT / "tests" / "data" / "jpeg"
    ref = np.load(d / "decode.npz")
    jpgs = sorted(d.glob("*.jpg"))
    assert len(jpgs) == 6
    assert sum(p.stat().st_size for p in d.iterdir()) <= 2 * 1024 * 1024
    for p in jpgs:
        img = native.decode_jpeg(p.read_bytes())
        np.testing.assert_array_equal(img[::8, ::8], ref[f"{p.stem}_sub"])
        assert img.shape == ((1024, 1280, 3) if p.stem.startswith("llvip")
                             else (128, 160, 3))
    np.testing.assert_array_equal(
        native.decode_jpeg((d / "small_rgb.jpg").read_bytes()),
        ref["small_rgb"])

