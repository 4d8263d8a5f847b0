"""PyTorch port, the serving path against the JAX package on the same
checkpoint directories (fp32, CPU): ``Detector.__call__`` on the mini
n-scale two-stream CFT model (K1's plain twin), on the single-stream n
model and with ``int8``, boxes within 1e-3 px and scores within 1e-5 of
JAX's (the forwards differ by fp32 summation order: 2e-5 px measured);
the device letterbox (``ops/preprocess.letterbox_batch``) within 1e-3 of
JAX's on the 0-255 scale; the REST records against JAX's
``DetectionResults.pandas()[0].to_json(orient="records")`` through the
handler function and once through a loopback server; ``MediaSource``
against JAX's on an image directory and a cv2-written video (frames
equal); the hub constructors, drawing and crops."""

import json
import sys
import threading
import urllib.request

import cv2
import numpy as np
import pytest
import torch

from multispectral_object_detection_tpu import hub as jhub
from multispectral_object_detection_tpu.data.sources import (
    MediaSource as JaxMediaSource)
from multispectral_object_detection_tpu.ops import preprocess as jpre
from multispectral_object_detection_tpu.utils.general import (
    save_one_box as jax_save_one_box)
from multispectral_object_detection_tpu_torch import hub, hubconf
from multispectral_object_detection_tpu_torch.data.augment import letterbox
from multispectral_object_detection_tpu_torch.data.sources import MediaSource
from multispectral_object_detection_tpu_torch.ops import preprocess
from multispectral_object_detection_tpu_torch.serve import rest_api
from multispectral_object_detection_tpu_torch.utils import general
from tests._torch_port import (  # noqa: F401
    mini_single_weights, mini_weights, share_torch_threads,
    write_jax_checkpoint)

CFT, NC, IMG = "yolov5n_fusion_transformerx3", 2, 64
BOX_TOL, SCORE_TOL = 1e-3, 1e-5


def _imgs(seed, shapes):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, hw + (3,), dtype=np.uint8) for hw in shapes]


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    root = tmp_path_factory.mktemp("serve")
    cft, single = mini_weights(0), mini_single_weights(0)
    return {"root": root,
            "cft": write_jax_checkpoint(root / "cft", cft["params"],
                                        cft["stats"]),
            "single": write_jax_checkpoint(root / "single",
                                           single["params"], single["stats"])}


@pytest.fixture(scope="module")
def cft_detectors(ckpts):
    """(port, JAX) Detectors of the mini CFT checkpoint, shared by the
    tests that use them (the JAX one compiles per batch size once)."""
    return (_port_detector(CFT, ckpts["cft"]),
            jhub.Detector(CFT, nc=NC, weights=ckpts["cft"], img_size=IMG))


def _port_detector(name, ckpt, **kw):
    return hub.Detector(name, nc=NC, weights=ckpt, img_size=IMG,
                        dtype=torch.float32, device="cpu", **kw)


def _match(got, want) -> int:
    """Rows (box, score, class) of one image against JAX's: the same
    detections, boxes within BOX_TOL px, scores within SCORE_TOL, classes
    equal, matched up to the order of scores that tie within the
    tolerance. Returns the count."""
    assert len(got) == len(want)
    unused = list(range(len(want)))
    for b, s, c in got:
        hit = next((j for j in unused if abs(want[j][1] - s) <= SCORE_TOL
                    and want[j][2] == c and np.abs(
                        np.asarray(want[j][0]) - b).max() <= BOX_TOL), None)
        assert hit is not None, (b, s, c)
        unused.remove(hit)
    return len(got)


def _assert_results_match(got, want):
    """DetectionResults image for image (``_match``)."""
    assert len(got) == len(want)
    n = sum(_match(list(zip(*r[:3])), list(zip(*w[:3])))
            for r, w in zip(zip(got.boxes, got.scores, got.classes),
                            zip(want.boxes, want.scores, want.classes)))
    assert n > 0


def _rows(records):
    return [([r["xmin"], r["ymin"], r["xmax"], r["ymax"]], r["confidence"],
             r["class"]) for r in records]


def test_detector_call_two_stream_matches_jax(cft_detectors, tmp_path):
    """Arrays of two sizes, the IR frames at another size than the RGB
    (each letterboxed with its own ratio, rescaled with the RGB's); then
    the same images as PNG and JPEG paths."""
    rgb = _imgs(0, [(48, 80), (100, 64)])
    ir = _imgs(1, [(96, 160), (100, 64)])
    td, jd = cft_detectors
    want, got = jd(rgb, ir), td(rgb, ir)
    _assert_results_match(got, want)
    for i, im in enumerate(rgb):  # native pixels, clipped
        assert (got.boxes[i][:, [0, 2]] <= im.shape[1]).all()
        assert (got.boxes[i][:, [1, 3]] <= im.shape[0]).all()
    paths = []
    for i, (a, b) in enumerate(zip(rgb, ir)):
        ext = (".png", ".jpg")[i]
        for im, side in ((a, "rgb"), (b, "ir")):
            paths.append(str(tmp_path / f"{side}{i}{ext}"))
            cv2.imwrite(paths[-1], im[:, :, ::-1])
    _assert_results_match(td(paths[0::2], paths[1::2]),
                          jd(paths[0::2], paths[1::2]))
    with pytest.raises(ValueError, match="IR"):
        td(rgb)


def test_detector_call_single_stream_and_int8_match_jax(ckpts):
    imgs = _imgs(2, [(64, 40), (30, 90)])
    _assert_results_match(
        _port_detector("yolov5n", ckpts["single"], conf=0.1)(imgs),
        jhub.Detector("yolov5n", nc=NC, weights=ckpts["single"],
                      img_size=IMG, conf=0.1)(imgs))
    ir = _imgs(3, [(64, 40), (30, 90)])
    td = _port_detector(CFT, ckpts["cft"], int8=True)
    assert any(hasattr(m, "weight_q") for m in td.model.modules())
    _assert_results_match(
        td(imgs, ir), jhub.Detector(CFT, nc=NC, weights=ckpts["cft"],
                                    img_size=IMG, int8=True)(imgs, ir))


def test_rest_records_match_the_jax_pandas_records(cft_detectors):
    """The handler on PNG and JPEG uploads against JAX's records of the
    same decoded images (cv2 decodes here as the port does); then the
    same request through a server on a free loopback port."""
    td, jd = cft_detectors
    rgb, ir = _imgs(4, [(60, 72), (60, 72)])
    for ext in (".png", ".jpg"):
        files = {k: cv2.imencode(ext, im[:, :, ::-1])[1].tobytes()
                 for k, im in (("image", rgb), ("image_ir", ir))}
        dec = [cv2.imdecode(np.frombuffer(files[k], np.uint8),
                            cv2.IMREAD_COLOR)[:, :, ::-1]
               for k in ("image", "image_ir")]
        status, body = rest_api.handle(td, files)
        # image 0 of a batch of two: the batch size the JAX detector has
        # compiled already
        want = json.loads(jd([dec[0]] * 2, [dec[1]] * 2).pandas()[0].to_json(
            orient="records"))
        assert status == 200 and len(body) > 0
        assert all(set(g) == set(want[0]) for g in body)
        assert all(g["name"] == str(g["class"]) for g in body)
        assert _match(_rows(body), _rows(want)) == len(body)
    assert rest_api.handle(td, {"image": files["image"]})[0] == 400
    assert rest_api.handle(td, {})[0] == 400
    assert rest_api.handle(td, {"image": b"junk", "image_ir": b"x"})[0] == 400

    server = rest_api.make_server(td, CFT, "127.0.0.1", 0)
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    try:
        url = f"http://127.0.0.1:{server.server_address[1]}"
        ctype, data = rest_api.encode_multipart(
            {k: (f"{k}{ext}", v) for k, v in files.items()})
        req = urllib.request.Request(f"{url}/v1/object-detection/{CFT}",
                                     data=data,
                                     headers={"Content-Type": ctype})
        with urllib.request.urlopen(req, timeout=60) as r:
            assert json.loads(r.read()) == body
        with urllib.request.urlopen(f"{url}/healthz", timeout=60) as r:
            assert json.loads(r.read()) == {"status": "ok", "model": CFT}
    finally:
        server.shutdown()
        server.server_close()
        t.join()


@pytest.mark.parametrize("shape,size", [((2, 48, 64), 64), ((1, 100, 50), 128),
                                        ((1, 96, 128), 64)])
def test_letterbox_batch_matches_jax(shape, size):
    """Pad only, growing and shrinking; max |port - jax| <= 1e-3 on the
    0-255 scale (fp32 resize sums), pads exactly 114; against the host
    letterbox (cv2's fixed point) mean |diff| < 1, as JAX's test holds its
    own."""
    imgs = np.random.default_rng(5).integers(0, 256, shape + (3,), np.uint8)
    want = np.asarray(jpre.letterbox_batch(imgs, src_hw=shape[1:],
                                           img_size=size, normalize=False))
    got = preprocess.letterbox_batch(torch.from_numpy(imgs), size,
                                     normalize=False).numpy()
    assert got.shape == want.shape == (shape[0], size, size, 3)
    assert np.abs(got - want).max() <= 1e-3
    host = letterbox(imgs[0], (size, size))
    assert np.mean(np.abs(got[0] - host[0])) < 1.0
    assert preprocess.letterbox_params(shape[1:], size) == \
        jpre.letterbox_params(shape[1:], size)
    norm = preprocess.letterbox_batch(torch.from_numpy(imgs), size,
                                      dtype=torch.bfloat16)
    assert norm.dtype == torch.bfloat16
    torch.testing.assert_close(norm.float(), torch.from_numpy(got) / 255.0,
                               atol=4e-3, rtol=0)  # bf16: 8 mantissa bits


def test_media_source_matches_jax(tmp_path):
    """An image directory (PNG and JPEG) with a cv2-written video in it,
    and the video alone: the same names and frames as JAX's."""
    d = tmp_path / "media"
    d.mkdir()
    for i, (ext, im) in enumerate(zip((".png", ".jpg", ".png"),
                                      _imgs(6, [(32, 32)] * 3))):
        cv2.imwrite(str(d / f"{i}{ext}"), im)
    vid = d / "v.mp4"
    w = cv2.VideoWriter(str(vid), cv2.VideoWriter_fourcc(*"mp4v"), 5, (32, 32))
    for im in _imgs(7, [(32, 32)] * 4):
        w.write(im)
    w.release()
    for src in (d, vid, d / "0.png"):
        got, want = list(MediaSource(str(src))), list(JaxMediaSource(str(src)))
        assert len(got) == len(want) > 0
        for (gn, gf, gc), (wn, wf, wc) in zip(got, want):
            assert gn == wn and (gc is None) == (wc is None)
            np.testing.assert_array_equal(gf, wf)
    assert len(list(MediaSource(str(d / "*.png")))) == 2  # a glob


def test_media_source_without_cv2_names_it(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError, match="cv2"):
        list(MediaSource(str(tmp_path / "clip.mp4")))
    with pytest.raises(ImportError, match="cv2"):
        list(MediaSource("0"))


@pytest.mark.parametrize("t", [1, 2, 3, 5])
def test_numpy_rectangle_against_cv2(t):
    """Without cv2 a box is a numpy band of +-(t+1)//2 px: the pixels of
    cv2.rectangle but for its rounded outer corners, a superset with at
    most 4 * ((t+1)//2)**2 extra pixels (none at t = 1)."""
    for p1, p2 in (((10, 12), (40, 30)), ((-5, 10), (30, 70)),
                   ((20, 5), (21, 6))):
        a = np.zeros((48, 64, 3), np.uint8)
        b = a.copy()
        cv2.rectangle(a, p1, p2, (255, 56, 56), t)
        general._rectangle(b, p1, p2, (255, 56, 56), t)
        ca, cb = a.any(-1), b.any(-1)
        assert not (ca & ~cb).any()
        h = 0 if t == 1 else (t + 1) // 2
        assert (cb & ~ca).sum() <= 4 * h * h
        np.testing.assert_array_equal(a[ca & cb], b[ca & cb])


def test_render_save_and_crops_with_and_without_cv2(tmp_path, monkeypatch):
    img = _imgs(8, [(40, 60)])[0]
    res = hub.DetectionResults([np.array([[5.0, 6, 30, 25]])],
                               [np.array([0.5])], [np.array([1])],
                               ["a", "b"], [img])
    assert res.records() == [[{"xmin": 5.0, "ymin": 6.0, "xmax": 30.0,
                               "ymax": 25.0, "confidence": 0.5, "class": 1,
                               "name": "b"}]]
    jres = jhub.DetectionResults(res.boxes, res.scores, res.classes,
                                 res.names, [img])
    np.testing.assert_array_equal(res.render()[0], jres.render()[0])
    crop = general.save_one_box(res.boxes[0][0], img, tmp_path / "c" / "x.jpg")
    want = jax_save_one_box(res.boxes[0][0], img, tmp_path / "j" / "x.jpg")
    np.testing.assert_array_equal(crop, want)
    assert (tmp_path / "c" / "x.jpg").read_bytes() == \
        (tmp_path / "j" / "x.jpg").read_bytes()
    monkeypatch.setattr(general, "_cv2", lambda: None)
    drawn = res.render()[0]
    assert (drawn != img).any() and drawn.shape == img.shape
    out = res.save(str(tmp_path / "s"))
    assert [p.name for p in out.iterdir()] == ["image0.png"]
    general.save_one_box(res.boxes[0][0], img, tmp_path / "n" / "x.jpg")
    assert (tmp_path / "n" / "x.png").is_file()


def test_hub_constructors():
    det = hubconf.yolov5n(nc=3, img_size=64, device="cpu")
    assert det.model.spec.nc == 3 and not det.two_stream
    assert det.names == ["0", "1", "2"]
    det2 = hubconf.cft_s(nc=1, img_size=64, device="cpu", names=["person"])
    assert det2.two_stream and det2.names == ["person"]
    assert hubconf.custom("yolov5n", nc=2, device="cpu").model.spec.nc == 2
