"""PyTorch port, the evaluation data path against the JAX package and cv2:
the PNG reader (every row filter and colour type) against ``cv2.imread``,
the synthetic sets against the JAX generator's pixels and labels, the
loader's batches byte for byte against the JAX ``BatchLoader`` over one
set of PNG files (rect and square, with a listing file, a resize and a
corrupt file), the scan cache's key, and the msgpack checkpoint reader
against ``flax.serialization``. All comparisons are exact."""

import struct
import zlib
from pathlib import Path

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

import multispectral_object_detection_tpu.data.synthetic as jsynthetic
from multispectral_object_detection_tpu.data.datasets import (
    BatchLoader as JaxBatchLoader)
from multispectral_object_detection_tpu.data.datasets import (
    PairedDetectionDataset as JaxDataset)
from multispectral_object_detection_tpu.utils.checkpoint import (
    load_inference_params as jax_load_inference_params)
from multispectral_object_detection_tpu_torch.data import imageio
from multispectral_object_detection_tpu_torch.data.augment import letterbox
from multispectral_object_detection_tpu_torch.data.datasets import (
    BatchLoader, PairedDetectionDataset, scan_pair_cached)
from multispectral_object_detection_tpu_torch.data.synthetic import (
    make_paired_dataset)
from multispectral_object_detection_tpu_torch.utils import checkpoint
from tests._torch_port import share_torch_threads  # noqa: F401


def _filter_row(f, cur, prev, bpp):
    """PNG filter ``f`` applied to one row (ints)."""
    out = []
    for i, x in enumerate(cur):
        a = cur[i - bpp] if i >= bpp else 0
        b = prev[i]
        c = prev[i - bpp] if i >= bpp else 0
        if f == 0:
            pred = 0
        elif f == 1:
            pred = a
        elif f == 2:
            pred = b
        elif f == 3:
            pred = (a + b) // 2
        else:
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        out.append((x - pred) & 0xFF)
    return out


def _encode_png(img, ctype):
    """A PNG whose row y uses filter y % 5, so every filter type occurs."""
    h, w = img.shape[:2]
    bpp = img.shape[2]
    rows, prev = [], [0] * (w * bpp)
    for y in range(h):
        cur = img[y].reshape(-1).tolist()
        rows.append(bytes([y % 5] + _filter_row(y % 5, cur, prev, bpp)))
        prev = cur

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    return (imageio.PNG_SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(rows)))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("ctype,channels", [(0, 1), (2, 3), (4, 2), (6, 4)])
def test_png_reader_matches_cv2_for_every_filter(tmp_path, ctype, channels):
    rng = np.random.default_rng(ctype)
    img = rng.integers(0, 256, (11, 13, channels), dtype=np.uint8)
    img[4:8] = img[3]  # runs that the filters predict well
    path = tmp_path / "f.png"
    path.write_bytes(_encode_png(img, ctype))
    np.testing.assert_array_equal(imageio.read_png(path), img)
    got = imageio.imread(path)
    np.testing.assert_array_equal(got, cv2.imread(str(path))[:, :, ::-1])
    assert imageio.png_size(path) == (13, 11)


def test_png_writer_round_trips_through_cv2(tmp_path):
    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, (17, 9, 3), dtype=np.uint8)
    imageio.write_png(tmp_path / "a.png", img)
    np.testing.assert_array_equal(
        cv2.imread(str(tmp_path / "a.png"))[:, :, ::-1], img)
    np.testing.assert_array_equal(imageio.imread(tmp_path / "a.png"), img)
    cv2.imwrite(str(tmp_path / "b.png"), img[:, :, ::-1])  # libpng's filters
    np.testing.assert_array_equal(imageio.imread(tmp_path / "b.png"), img)
    bad = bytearray((tmp_path / "a.png").read_bytes())
    bad[40] ^= 0xFF
    (tmp_path / "c.png").write_bytes(bytes(bad))
    with pytest.raises(ValueError, match="CRC"):
        imageio.read_png(tmp_path / "c.png")
    with pytest.raises(FileNotFoundError):
        imageio.imread(tmp_path / "missing.png")


def test_letterbox_matches_jax():
    from multispectral_object_detection_tpu.data.augment import (
        letterbox as jax_letterbox)

    img = np.random.default_rng(2).integers(0, 256, (48, 64, 3), np.uint8)
    for shape, kw in (((96, 128), {}), ((64, 64), {}), ((70, 100), {}),
                      ((80, 96), {"scaleup": False}),
                      ((32, 40), {"scaleup": False})):
        got, want = letterbox(img, shape, **kw), jax_letterbox(img, shape, **kw)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1:] == want[1:]


def test_synthetic_set_matches_the_jax_generator(tmp_path, monkeypatch):
    """The same scenes and labels as the JAX generator from one seed: its
    arrays are caught before JPEG encoding and compared with the PNGs."""
    caught = {}

    class Cv2:
        rectangle = staticmethod(cv2.rectangle)

        @staticmethod
        def imwrite(path, bgr):
            caught[path] = bgr[:, :, ::-1].copy()
            return True

    monkeypatch.setattr(jsynthetic, "cv2", Cv2)
    jrgb, jir = jsynthetic.make_paired_dataset(str(tmp_path / "j"), 5, 64,
                                               nc=3, seed=4)
    rgb, ir = make_paired_dataset(str(tmp_path / "t"), 5, 64, nc=3, seed=4)
    for k in range(5):
        for jdir, tdir in ((jrgb, rgb), (jir, ir)):
            np.testing.assert_array_equal(
                imageio.read_png(f"{tdir}/{k:06d}.png"),
                caught[f"{jdir}/{k:06d}.jpg"])
        lab = f"rgb/labels/{k:06d}.txt"
        assert (tmp_path / "t" / lab).read_text() == \
            (tmp_path / "j" / lab).read_text()


@pytest.fixture(scope="module")
def png_set(tmp_path_factory):
    """Landscape and square pairs behind listing files, plus a corrupt
    pair; returns the two listing paths."""
    root = tmp_path_factory.mktemp("pngset")
    a = make_paired_dataset(str(root / "a"), 5, nc=2, seed=1, img_hw=(48, 64))
    b = make_paired_dataset(str(root / "b"), 4, 64, nc=2, seed=2)
    bad = root / "c" / "rgb" / "images"
    bad.mkdir(parents=True)
    (bad / "x.png").write_bytes(b"\x89PNG\r\n\x1a\n truncated")
    lists = []
    for side, extra in ((0, bad / "x.png"), (1, bad / "x.png")):
        files = sorted(str(p) for d in (a[side], b[side])
                       for p in Path(d).glob("*.png"))
        listing = root / f"list{side}.txt"
        listing.write_text("\n".join(files + [str(extra)]) + "\n")
        lists.append(str(listing))
    return lists


@pytest.mark.parametrize("img_size,rect", [(64, True), (64, False),
                                           (96, False)])
def test_batches_equal_the_jax_loader_byte_for_byte(png_set, img_size, rect):
    rgb, ir = png_set
    kw = dict(img_size=img_size, nc=2, rect=rect, pad=0.5)
    jds = JaxDataset.from_sources(rgb, ir, augment=False, **kw)
    tds = PairedDetectionDataset.from_sources(rgb, ir, **kw)
    assert len(tds) == len(jds) == 9  # the corrupt pair is dropped
    jl = JaxBatchLoader(jds, 4, shuffle=False, max_labels=6, drop_last=False)
    tl = BatchLoader(tds, 4, max_labels=6)
    n = 0
    for got, want, idx in zip(tl, jl, tl._batches()):
        # the port's batches also carry each sample's dataset index
        assert set(got) == set(want) | {"index"}
        np.testing.assert_array_equal(got["index"], idx)
        for k in ("rgb", "ir", "targets", "tmask"):
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
        assert got["shapes"] == want["shapes"]
        n += 1
    assert n == len(tl) == len(jl) == 3


def test_scan_cache_key_includes_nc(png_set, tmp_path):
    """A cache written under one nc is not taken under another (the JAX
    package's key leaves nc out)."""
    rgb = open(png_set[0]).read().split()[:9]
    first = scan_pair_cached(rgb, cache_dir=str(tmp_path), nc=2)
    assert first["keep"].all()
    again = scan_pair_cached(rgb, cache_dir=str(tmp_path), nc=2)
    np.testing.assert_array_equal(again["shapes"], first["shapes"])
    assert len(list(tmp_path.glob("scan_*.npz"))) == 1
    one = scan_pair_cached(rgb, cache_dir=str(tmp_path), nc=1)
    assert len(list(tmp_path.glob("scan_*.npz"))) == 2
    has_class_1 = [bool((lab[:, 0] == 1).any()) for lab in first["labels"]]
    np.testing.assert_array_equal(one["keep"], ~np.asarray(has_class_1))


def _jax_tree(rng):
    """A JAX-checkpoint-like tree: the mini model's leaf kinds (fp32 conv
    kernels, bf16 casts, int scalars), nested dicts."""
    return {
        "blocks_0": {"conv": {"kernel": rng.standard_normal(
            (3, 3, 12, 16)).astype(np.float32)},
            "bn": {"scale": np.ones(16, np.float32),
                   "bias": np.zeros(16, np.float32)}},
        "blocks_1": {"kernel": jnp.asarray(
            rng.standard_normal((8, 4)), jnp.bfloat16)},
    }


def test_msgpack_reader_matches_flax(tmp_path):
    rng = np.random.default_rng(0)
    state = {"params": _jax_tree(rng), "ema_params": _jax_tree(rng),
             "ema_stats": {"blocks_0": {"bn": {
                 "mean": np.zeros(16, np.float32),
                 "var": np.ones(16, np.float32)}}},
             "step": np.int32(7), "ema_updates": jnp.asarray(3),
             "opt_state": {"0": {"count": np.int32(1)}, "1": [1.5, None,
                                                              True, "sgd"]},
             "c": 1 + 2j}
    blob = serialization.msgpack_serialize(state)
    want = serialization.msgpack_restore(blob)
    got = checkpoint.msgpack_restore(blob)

    def same(g, w):
        if isinstance(w, dict):
            assert set(g) == set(w)
            for k in w:
                same(g[k], w[k])
        elif isinstance(w, list):
            assert len(g) == len(w)
            for a, b in zip(g, w):
                same(a, b)
        elif isinstance(w, np.ndarray):
            assert g.shape == w.shape
            np.testing.assert_array_equal(g, np.asarray(w, np.float32)
                                          if w.dtype == jnp.bfloat16 else w)
        else:
            assert g == w and type(g) is type(w)

    same(got, want)


def test_load_inference_params_reads_both_checkpoint_forms(tmp_path):
    """state.msgpack (EMA weights) and model.msgpack (stripped) give the
    JAX loader's trees, through the weight bridge; a .pt state dict
    loads as it is."""
    from multispectral_object_detection_tpu_torch.utils.jax_import import (
        state_dict_from_jax)

    rng = np.random.default_rng(1)
    params, stats = _jax_tree(rng), {"blocks_0": {"bn": {
        "mean": rng.standard_normal(16).astype(np.float32),
        "var": np.ones(16, np.float32)}}}
    full = tmp_path / "full"
    full.mkdir()
    (full / "state.msgpack").write_bytes(serialization.msgpack_serialize(
        {"params": _jax_tree(rng), "batch_stats": stats, "ema_params": params,
         "ema_stats": stats, "step": np.int32(3)}))
    slim = tmp_path / "slim"
    slim.mkdir()
    (slim / "model.msgpack").write_bytes(serialization.msgpack_serialize(
        {"params": params, "batch_stats": stats}))
    for d in (full, slim):
        got = checkpoint.load_inference_params(d)
        jp, js = jax_load_inference_params(str(d))
        want = state_dict_from_jax(
            {k: v for k, v in jp.items()}, js)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(
                got[k], np.asarray(want[k], np.float32)
                if want[k].dtype == jnp.bfloat16 else want[k])
    sd = {k: torch.from_numpy(v.copy()) for k, v in got.items()}
    torch.save(sd, tmp_path / "w.pt")
    back = checkpoint.load_inference_params(tmp_path / "w.pt")
    for k in sd:
        np.testing.assert_array_equal(back[k], sd[k].numpy())
    with pytest.raises(FileNotFoundError):
        checkpoint.load_inference_params(tmp_path)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_half_precision_pt_state_dict_loads_as_fp32(tmp_path, dtype):
    """A ``.pt`` state dict saved in bf16 or fp16 reads as the fp32 values
    of its tensors, as the msgpack path reads bf16 leaves; other dtypes
    keep theirs."""
    rng = np.random.default_rng(4)
    sd = {"model.0.conv.weight": torch.from_numpy(
              rng.standard_normal((8, 3, 3, 3)).astype(np.float32)).to(dtype),
          "model.1.bn.num_batches_tracked": torch.tensor(3)}
    torch.save(sd, tmp_path / "half.pt")
    got = checkpoint.load_inference_params(tmp_path / "half.pt")
    w = got["model.0.conv.weight"]
    assert w.dtype == np.float32
    np.testing.assert_array_equal(w, sd["model.0.conv.weight"].float().numpy())
    assert got["model.1.bn.num_batches_tracked"].dtype == np.int64
