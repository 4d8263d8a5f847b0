"""Hand-written CUDA kernels of the port: built with nvcc, bound with ctypes.

Each source in ``csrc/`` compiles on its own into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds, not
minutes). The libraries go into ``_build/`` beside this file, named by a hash
of their sources and flags, so an edited source rebuilds and an unchanged
one is reused. Nothing is built or loaded when this module is imported:
``library`` builds at first use, and ``build`` starts one nvcc per missing
source, all at once.

Pointers and the CUDA stream cross as ``ctypes.c_void_p``; every entry point
returns ``cudaGetLastError()`` of its launch as an int, 0 on success.
``launch`` calls one on the current stream and raises on a non-zero code;
the wrappers in ``ops/`` check their arguments with the helpers below first.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).parent / "csrc"
BUILD_DIR = Path(__file__).parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# after the source: gemm.cu encodes its TMA descriptors with libcuda
NVCC_LIBS = ("-lcuda",)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# library name -> {entry point: argtypes}
SIGNATURES = {
    "layernorm": {"cft_layernorm": [_P, _P, _P, _P, _I, _I, _F, _I, _P]},
    "gemm": {"cft_gemm": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P]},
    "attention": {"cft_attention": [_P, _P, _I, _I, _I, _I, _I, _P]},
    "c3_bottleneck": {"c3_conv": [_P, _P, _P, _I, _P, _P, _I, _I, _I, _I, _I,
                                  _I, _I, _P]},
}
# dtype codes of the kernels' entry points (csrc/cft_common.cuh)
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_LOADED: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found (on PATH or under $CUDA_HOME/bin): "
                       "the CUDA kernels cannot be built")


def target(name: str) -> Path:
    """Path of the shared library for source ``csrc/<name>.cu``."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS + NVCC_LIBS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names=tuple(SIGNATURES)) -> dict[str, str]:
    """Compile every missing library of ``names`` in parallel.

    Returns each built library's compiler output (ptxas register and
    shared-memory report); raises RuntimeError with it if nvcc fails.
    """
    todo = [n for n in names if not target(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for n in todo:
        tmp = target(n).with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{n}.cu"), *NVCC_LIBS]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True))
    logs, failed = {}, []
    for n, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        logs[n] = out
        if proc.returncode == 0:
            os.replace(tmp, target(n))
        else:
            failed.append(n)
            tmp.unlink(missing_ok=True)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def library(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        build((name,))
        lib = ctypes.CDLL(str(target(name)))
        for fn, argtypes in SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _LOADED[name] = lib
    return lib


def on_cpu(*tensors: torch.Tensor) -> bool:
    """True for CPU tensors (plain path), False for CUDA ones (kernel)."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return True
    if kinds == {"cuda"} and len({t.device for t in tensors}) == 1:
        return False
    raise ValueError(f"tensors on {sorted(str(t.device) for t in tensors)}: "
                     "the kernels take tensors on one CUDA device, their "
                     "plain versions CPU tensors")


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def check_args(name: str, **tensors: torch.Tensor) -> None:
    # runs before every launch: messages are formatted only on failure
    for arg, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {arg} must be 16-byte aligned")


def ptr(t) -> ctypes.c_void_p:
    """A tensor's device pointer; None for a null pointer."""
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def launch(lib_name: str, fn: str, device, *args) -> None:
    """Call entry point ``fn`` of library ``lib_name`` on the current stream
    of ``device``; raise if the launch failed."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(library(lib_name), fn)(*args, ctypes.c_void_p(stream))
    if err:
        raise RuntimeError(f"{fn}: kernel launch failed with CUDA error {err}")
