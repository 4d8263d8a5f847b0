"""The port's host image runtime: C++ resize, pad, warp, HSV jitter and JPEG
decode, built with g++ at first use and bound with ctypes.

Counterpart of multispectral_object_detection_tpu/data/native.py over the
port's own sources in ``csrc/``: ``image_ops.cpp`` (geometry, no
dependency), ``jpeg_decode.cpp`` (libjpeg) and ``jpeg_nvjpeg.cpp`` (the
CUDA toolkit's nvJPEG). Each compiles into its own shared library in
``_build/`` beside this file, named by a hash of its source and flags, so
an edited source rebuilds and an unchanged one is reused; nothing is built
or loaded at import. JPEG is decoded by libjpeg where its header
``jpeglib.h`` is found, else by nvJPEG where ``$CUDA_HOME/include/
nvjpeg.h`` is (``jpeg_backend``), else not here. A library that should
build and does not, or does not load, raises with the compiler's or the
loader's message: there is no fallback.

Images are HWC RGB uint8 arrays. The resizes reproduce cv2's INTER_LINEAR
and INTER_AREA pixels (csrc/image_ops.cpp says how).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

import numpy as np

CSRC = Path(__file__).parent / "csrc"
BUILD_DIR = Path(__file__).parent / "_build"
# no -march=native and no FMA contraction: the float sums of the area
# resize must round as OpenCV's do
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-ffp-contract=off")
CUDA_HOME = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))

_u8p = ctypes.POINTER(ctypes.c_uint8)
_i32p = ctypes.POINTER(ctypes.c_int)
_f64p = ctypes.POINTER(ctypes.c_double)
_f32p = ctypes.POINTER(ctypes.c_float)
_I, _D = ctypes.c_int, ctypes.c_double
# library -> {entry point: (argtypes, restype)}
SIGNATURES = {
    "image_ops": {
        "msod_resize_bilinear": ([_u8p, _I, _I, _u8p, _I, _I], None),
        "msod_resize_area": ([_u8p, _I, _I, _u8p, _I, _I], None),
        "msod_resize_bilinear_f32": ([_f32p, _I, _I, _f32p, _I, _I], None),
        "msod_pad_center": ([_u8p, _I, _I, _u8p, _I, _I, _I, _I,
                             ctypes.c_uint8], None),
        "msod_warp_affine": ([_u8p, _I, _I, _f64p, _u8p, _I, _I,
                              ctypes.c_uint8], None),
        "msod_hsv_jitter": ([_u8p, _I, _I, _D, _D, _D], None),
    },
    "jpeg_decode": {
        "msod_jpeg_size": ([_u8p, ctypes.c_long, _i32p, _i32p], _I),
        "msod_jpeg_decode": ([_u8p, ctypes.c_long, _u8p, _I, _I], _I),
    },
}
SIGNATURES["jpeg_nvjpeg"] = SIGNATURES["jpeg_decode"]

_LOADED: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
_JPEG_BACKEND = "unprobed"


def _cxx() -> str:
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if not cxx:
        raise RuntimeError("no C++ compiler (g++ or $CXX): the port's image "
                           "runtime (data/csrc) cannot be built")
    return cxx


def _link_flags(name: str) -> tuple:
    if name == "jpeg_decode":
        return ("-ljpeg",)
    if name == "jpeg_nvjpeg":
        lib = CUDA_HOME / "lib64"
        return ("-I", str(CUDA_HOME / "include"), "-L", str(lib),
                f"-Wl,-rpath,{lib}", "-lnvjpeg", "-lcudart")
    return ()


def target(name: str) -> Path:
    """Path of the shared library for ``csrc/<name>.cpp``."""
    h = hashlib.sha256(" ".join(CXX_FLAGS + _link_flags(name)).encode())
    h.update((CSRC / f"{name}.cpp").read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def jpeg_backend():
    """The JPEG library this machine builds: "jpeg_decode" (libjpeg) where
    ``jpeglib.h`` is found, else "jpeg_nvjpeg" where CUDA's ``nvjpeg.h``
    is, else None."""
    global _JPEG_BACKEND
    if _JPEG_BACKEND == "unprobed":
        probe = subprocess.run(
            [_cxx(), "-fsyntax-only", "-x", "c++", "-"],
            input="#include <cstdio>\n#include <jpeglib.h>\n",
            capture_output=True, text=True)
        _JPEG_BACKEND = "jpeg_decode" if probe.returncode == 0 else (
            "jpeg_nvjpeg" if (CUDA_HOME / "include" / "nvjpeg.h").is_file()
            else None)
    return _JPEG_BACKEND


def jpeg_available() -> bool:
    """True where a JPEG library builds (``jpeg_backend``)."""
    return jpeg_backend() is not None


def build(name: str) -> str:
    """Compile ``csrc/<name>.cpp`` unless its library exists; returns the
    compiler's output, raises RuntimeError with it when g++ fails."""
    if target(name).exists():
        return ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target(name).with_suffix(f".{os.getpid()}.tmp")
    cmd = [_cxx(), *CXX_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cpp"),
           *_link_flags(name)]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building {name} failed:\n{' '.join(cmd)}\n"
                           f"{r.stdout}{r.stderr}")
    os.replace(tmp, target(name))
    return r.stdout + r.stderr


def library(name: str) -> ctypes.CDLL:
    """The loaded library ``name`` ("image_ops", "jpeg_decode" or
    "jpeg_nvjpeg"), built first if needed."""
    lib = _LOADED.get(name)
    if lib is not None:
        return lib
    with _LOCK:
        if name not in _LOADED:
            build(name)
            lib = ctypes.CDLL(str(target(name)))
            for fn, (argtypes, restype) in SIGNATURES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = restype
            _LOADED[name] = lib
    return _LOADED[name]


def _u8(a: np.ndarray):
    return a.ctypes.data_as(_u8p)


def _rgb(img: np.ndarray, dh: int = 1, dw: int = 1) -> np.ndarray:
    """``img`` as a contiguous (H, W, 3) uint8 array of at least one pixel,
    for an output of (dh, dw) pixels."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3 or \
            min(img.shape[:2]) < 1:
        raise ValueError(f"expected an (H, W, 3) uint8 image, got "
                         f"{img.dtype} {img.shape}")
    if dh < 1 or dw < 1:
        raise ValueError(f"output size ({dh}, {dw}) is empty")
    return img


def _jpeg_lib() -> ctypes.CDLL:
    name = jpeg_backend()
    if name is None:
        raise RuntimeError("JPEG decode needs libjpeg's header jpeglib.h or "
                           "CUDA's nvjpeg.h, and this machine has neither")
    return library(name)


def jpeg_size(data: bytes):
    """(height, width) of JPEG bytes; ValueError for a corrupt stream."""
    h, w = ctypes.c_int(), ctypes.c_int()
    rc = _jpeg_lib().msod_jpeg_size(_u8(np.frombuffer(data, np.uint8)),
                                    len(data), ctypes.byref(h),
                                    ctypes.byref(w))
    if rc != 0:
        raise ValueError(f"not a readable JPEG stream (code {rc})")
    return h.value, w.value


def decode_jpeg(data: bytes) -> np.ndarray:
    """JPEG bytes -> (H, W, 3) uint8 RGB; ValueError for a corrupt stream."""
    h, w = jpeg_size(data)
    out = np.empty((h, w, 3), np.uint8)
    rc = _jpeg_lib().msod_jpeg_decode(_u8(np.frombuffer(data, np.uint8)),
                                      len(data), _u8(out), h, w)
    if rc != 0:
        raise ValueError(f"JPEG decode failed (code {rc})")
    return out


def resize(img: np.ndarray, dh: int, dw: int, area: bool = False) -> np.ndarray:
    """(H, W, 3) uint8 -> (dh, dw, 3): cv2.INTER_AREA when ``area`` (for
    shrinking), else cv2.INTER_LINEAR."""
    img = _rgb(img, dh, dw)
    out = np.empty((dh, dw, 3), np.uint8)
    lib = library("image_ops")
    fn = lib.msod_resize_area if area else lib.msod_resize_bilinear
    fn(_u8(img), img.shape[0], img.shape[1], _u8(out), dh, dw)
    return out


def resize_f32(img: np.ndarray, dh: int, dw: int) -> np.ndarray:
    """(H, W) float32 -> (dh, dw) float32, cv2.INTER_LINEAR's float path."""
    img = np.ascontiguousarray(img, np.float32)
    if img.ndim != 2 or min(img.shape) < 1 or dh < 1 or dw < 1:
        raise ValueError(f"expected a non-empty (H, W) map and output size, "
                         f"got {img.shape} -> ({dh}, {dw})")
    out = np.empty((dh, dw), np.float32)
    library("image_ops").msod_resize_bilinear_f32(
        img.ctypes.data_as(_f32p), img.shape[0], img.shape[1],
        out.ctypes.data_as(_f32p), dh, dw)
    return out


def pad_center(img: np.ndarray, th: int, tw: int, top: int, left: int,
               value: int = 114) -> np.ndarray:
    """``img`` at (top, left) of a (th, tw) canvas of gray ``value``."""
    img = _rgb(img)
    if top < 0 or left < 0 or top + img.shape[0] > th or \
            left + img.shape[1] > tw:
        raise ValueError(f"{img.shape[:2]} at ({top}, {left}) does not fit "
                         f"({th}, {tw})")
    out = np.empty((th, tw, 3), np.uint8)
    library("image_ops").msod_pad_center(_u8(img), img.shape[0], img.shape[1],
                                         _u8(out), th, tw, top, left, value)
    return out


def warp_affine(img: np.ndarray, M: np.ndarray, dh: int, dw: int,
                border: int = 114) -> np.ndarray:
    """cv2.warpAffine(img, M, (dw, dh), borderValue=border) (bilinear)."""
    img = _rgb(img, dh, dw)
    m = np.ascontiguousarray(np.asarray(M, np.float64)[:2].reshape(-1))
    out = np.empty((dh, dw, 3), np.uint8)
    library("image_ops").msod_warp_affine(
        _u8(img), img.shape[0], img.shape[1], m.ctypes.data_as(_f64p),
        _u8(out), dh, dw, border)
    return out


def hsv_jitter(img: np.ndarray, rh: float, rs: float, rv: float) -> np.ndarray:
    """HSV gains (rh, rs, rv) through cv2's 8-bit HSV and lookup tables;
    returns a new array."""
    out = _rgb(img).copy()
    library("image_ops").msod_hsv_jitter(_u8(out), out.shape[0], out.shape[1],
                                         rh, rs, rv)
    return out
