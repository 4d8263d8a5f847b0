"""Write the JPEG fixtures of the port's card smoke test (chip_smoke.py):
the card machine has no JPEG encoder, so these are made here with cv2.

    PYTHONPATH=. python3 tools/make_jpeg_fixtures.py [--out tests/data/jpeg]

From the port's synthetic generator (nc=1): two LLVIP-sized (1280x1024)
pairs, llvip_{rgb,ir}_{0,1}.jpg, and one small (160x128) pair,
small_{rgb,ir}.jpg, at quality 75; and decode.npz with cv2's decode (RGB)
of each: "small_rgb" whole, and "<stem>_sub" every 8th row and column of
every file. About 0.8 MB in all.
"""

import argparse
import tempfile
from pathlib import Path

import cv2
import numpy as np

from multispectral_object_detection_tpu_torch.data.imageio import imread
from multispectral_object_detection_tpu_torch.data.synthetic import (
    make_paired_dataset)

QUALITY = 75


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
    total = sum(p.stat().st_size for p in out.iterdir())
    print(f"{len(list(out.iterdir()))} files, {total} bytes -> {out}")


if __name__ == "__main__":
    main()
