"""Write the JPEG fixtures of the port's card smoke test (chip_smoke.py):
the card machine has no JPEG encoder, so these are made here with cv2.

    PYTHONPATH=. python3 tools/make_jpeg_fixtures.py [--out tests/data/jpeg]

From the port's synthetic generator (nc=1): two LLVIP-sized (1280x1024)
pairs, llvip_{rgb,ir}_{0,1}.jpg, and one small (160x128) pair,
small_{rgb,ir}.jpg, at quality 75; and decode.npz with cv2's decode (RGB)
of each: "small_rgb" whole, and "<stem>_sub" every 8th row and column of
every file. About 0.8 MB in all.

In ``variants/``, from one small (48x32) synthetic scene: orient_{1..8}.jpg
with an EXIF orientation tag in a little-endian ("II") block, orient_6_mm.jpg
with a big-endian ("MM") one, progressive.jpg, gray.jpg (4:4:4, quality 90)
and cmyk.jpg (an Adobe-inverted CMYK file as Pillow writes it); and variants/decode.npz with
cv2.imread's decode (RGB, orientation applied) of each, keyed by stem.
"""

import argparse
import struct
import tempfile
from pathlib import Path

import cv2
import numpy as np

from multispectral_object_detection_tpu_torch.data.imageio import imread
from multispectral_object_detection_tpu_torch.data.synthetic import (
    make_paired_dataset, make_scene)

QUALITY = 75
VARIANT_HW = (32, 48)
EXIF_ORIENTATION = 274


def exif_app1(orientation: int, byte_order: str = "II") -> bytes:
    """An APP1 segment holding a TIFF block whose IFD0 has one entry: the
    orientation tag (SHORT)."""
    e = "<" if byte_order == "II" else ">"
    tiff = (byte_order.encode() + struct.pack(e + "HI", 42, 8)
            + struct.pack(e + "HHHIH", 1, EXIF_ORIENTATION, 3, 1, orientation)
            + b"\0\0" + struct.pack(e + "I", 0))
    body = b"Exif\0\0" + tiff
    return b"\xff\xe1" + struct.pack(">H", len(body) + 2) + body


def write_variants(out: Path) -> dict:
    """The EXIF, progressive, gray and CMYK files; returns cv2's decodes."""
    from PIL import Image

    out.mkdir(parents=True, exist_ok=True)
    rgb = make_scene(np.random.default_rng(2), *VARIANT_HW)[0]
    bgr = np.ascontiguousarray(rgb[:, :, ::-1])
    # 4:4:4: chroma at full size, so that another decoder's chroma
    # upsampling (nvJPEG's) does not enter these files' comparison; the
    # LLVIP-sized files above are 4:2:0
    opts = [cv2.IMWRITE_JPEG_QUALITY, 90, cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
            cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444]
    jpg = cv2.imencode(".jpg", bgr, opts)[1].tobytes()
    files = {f"orient_{o}": jpg[:2] + exif_app1(o) + jpg[2:]
             for o in range(1, 9)}
    files["orient_6_mm"] = jpg[:2] + exif_app1(6, "MM") + jpg[2:]
    files["progressive"] = cv2.imencode(
        ".jpg", bgr, opts + [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])[1].tobytes()
    files["gray"] = cv2.imencode(".jpg", cv2.cvtColor(bgr, cv2.COLOR_BGR2GRAY),
                                 opts)[1].tobytes()
    for stem, data in files.items():
        (out / f"{stem}.jpg").write_bytes(data)
    Image.fromarray(rgb).convert("CMYK").save(out / "cmyk.jpg", quality=90)
    return {p.stem: cv2.imread(str(p))[:, :, ::-1]
            for p in sorted(out.glob("*.jpg"))}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="tests/data/jpeg")
    out = Path(ap.parse_args(argv).out)
    out.mkdir(parents=True, exist_ok=True)
    decoded = {}
    with tempfile.TemporaryDirectory() as tmp:
        sets = {"llvip": make_paired_dataset(f"{tmp}/l", n_images=2, nc=1,
                                             seed=0, img_hw=(1024, 1280)),
                "small": make_paired_dataset(f"{tmp}/s", n_images=1, nc=1,
                                             seed=1, img_hw=(128, 160))}
        for kind, dirs in sets.items():
            for side, d in zip(("rgb", "ir"), dirs):
                for k, png in enumerate(sorted(Path(d).glob("*.png"))):
                    stem = f"{kind}_{side}" + (f"_{k}" if kind == "llvip"
                                               else "")
                    path = out / f"{stem}.jpg"
                    cv2.imwrite(str(path), imread(png)[:, :, ::-1],
                                [cv2.IMWRITE_JPEG_QUALITY, QUALITY])
                    dec = cv2.imread(str(path))[:, :, ::-1]
                    decoded[f"{stem}_sub"] = dec[::8, ::8]
                    if stem == "small_rgb":
                        decoded[stem] = dec
    np.savez_compressed(out / "decode.npz", **decoded)
    np.savez_compressed(out / "variants" / "decode.npz",
                        **write_variants(out / "variants"))
    files = [p for p in out.rglob("*") if p.is_file()]
    total = sum(p.stat().st_size for p in files)
    print(f"{len(files)} files, {total} bytes -> {out}")


if __name__ == "__main__":
    main()
