"""Time the port's fused C3 bottleneck kernel (K2) against another build of
its source, on one GPU, in turns.

    python3 tools/compare_k2.py --old DIR

DIR is the ``kernels/csrc`` directory of another checkout of the PyTorch
port (for example the parent commit's, unpacked with ``git archive``). Its
``c3_bottleneck.cu`` is built with that directory's headers and the port's
nvcc flags; this checkout's is built as ``kernels.build`` builds it. Both
are first held against ``c3_bottleneck_plain`` at ragged shapes, then timed
on the K2 blocks of one forward of each pass the bench drives: l@640 bs16
(6, 18 and 18 blocks at C = 64, 128 and 256), the ``--tta`` passes at 544
and 448 px (the same blocks at 136/68/34 and 112/56/28 px, whose 8-pixel
boxes are ragged) and x@1024 bs8 (24 at C = 320). Device ms per forward
by CUDA-graph replay, each block on inputs of its own, the 1x1 and the 3x3
launch apart, in the order new, old, old, new, twice over; the cuDNN
route without the flag once per pass. Prints a line per build, turn
and block class, the totals per pass, then the card line.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from multispectral_object_detection_tpu_torch import kernels  # noqa: E402
from multispectral_object_detection_tpu_torch.ops import c3_bottleneck as k2  # noqa: E402

# pass -> [((B, H, W, C), blocks)]: the K2 blocks of one forward
PASSES = {
    f"l@{s}": [((16, s // 4, s // 4, 64), 6), ((16, s // 8, s // 8, 128), 18),
               ((16, s // 16, s // 16, 256), 18)] for s in (640, 544, 448)}
PASSES["x@1024"] = [(cs.K2_X_SHAPE, cs.K2_X_BLOCKS)]
CHECK_SHAPES = ((2, 34, 34, 256), (2, 28, 28, 256), (2, 68, 68, 128),
                cs.K2_ODD_SHAPE)


def build_old(csrc: Path) -> ctypes.CDLL:
    out = kernels.BUILD_DIR / "libc3_bottleneck-compare-old.so"
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-I", str(csrc),
                    "-o", str(out), str(csrc / "c3_bottleneck.cu"),
                    *kernels.NVCC_LIBS], check=True, capture_output=True)
    lib = ctypes.CDLL(str(out))
    lib.c3_conv.argtypes = kernels.SIGNATURES["c3_bottleneck"]["c3_conv"]
    lib.c3_conv.restype = ctypes.c_int
    return lib


def conv(lib, a, w, b, res, out, taps: int) -> None:
    """One launch of ``lib``'s ``c3_conv``, as ``k2.c3_conv`` makes it."""
    B, H, W, C = a.shape
    err = lib.c3_conv(kernels.ptr(a), kernels.ptr(w), kernels.ptr(b),
                      int(b.dtype == torch.bfloat16), kernels.ptr(res),
                      kernels.ptr(out), B, H, W, C, out.shape[-1], taps,
                      kernels.DTYPE_CODE[a.dtype],
                      ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if err:
        raise RuntimeError(f"c3_conv failed with CUDA error {err}")


def bottleneck(lib, x, w1, b1, w2, b2):
    z, out = torch.empty_like(x), torch.empty_like(x)
    conv(lib, x, w1, b1, None, z, 1)
    conv(lib, z, w2, b2, x, out, 9)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", type=Path, required=True,
                    help="another checkout's kernels/csrc directory")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("compare_k2: needs a CUDA device")
    device = torch.device("cuda:0")
    libs = {"new": kernels.library("c3_bottleneck"), "old": build_old(args.old)}
    gen = torch.Generator().manual_seed(0)
    bf = torch.bfloat16
    for name, lib in libs.items():
        for shape in CHECK_SHAPES:
            for bdt in (bf, torch.float32):
                a = cs.k2_inputs(shape, bf, bdt, gen, device)
                rel = cs.rel_err(bottleneck(lib, *a),
                                 k2.c3_bottleneck_plain(*a))[0]
                print(f"check {name} {shape} bias {str(bdt)[6:]}: "
                      f"rel={rel:.3e} tol={cs.TOL_BF16:.1e}")
                cs.check(rel <= cs.TOL_BF16, f"{name} disagrees at {shape}")

    totals = {}  # (pass, build, turn, slot in the turn) -> ms
    order = ["new", "old", "old", "new"]
    for label, classes in PASSES.items():
        lib_ms = 0.0
        for shape, n in classes:
            blocks = [cs.k2_inputs(shape, bf, bf, gen, device)
                      for _ in range(n)]
            zs = [torch.empty_like(b[0]) for b in blocks]
            outs = [torch.empty_like(b[0]) for b in blocks]
            fns = [cs.k2_library(*b) for b in blocks]
            lib_ms += cs.graph_ms(lambda: [f() for f in fns])
            P, C = shape[0] * shape[1] * shape[2], shape[3]
            for turn in range(2):
                for i, name in enumerate(order):
                    lib = libs[name]
                    ms1 = cs.graph_ms(lambda: [
                        conv(lib, x, w1, b1, None, z, 1)
                        for (x, w1, b1, _, _), z in zip(blocks, zs)])
                    ms9 = cs.graph_ms(lambda: [
                        conv(lib, z, w2, b2, x, o, 9) for (x, _, _, w2, b2),
                        z, o in zip(blocks, zs, outs)])
                    key = (label, name, turn, i)
                    totals[key] = totals.get(key, 0.0) + ms1 + ms9
                    print(f"turn {turn} {label:<7} {str(shape):<20} x{n:<3} "
                          f"{name} 1x1 {ms1:.4f} ms 3x3 {ms9:.4f} ms "
                          f"({n * 18 * P * C * C / ms9 / 1e9:.1f} TFLOP/s) "
                          f"both {ms1 + ms9:.4f} ms")
            del blocks, zs, outs, fns
            torch.cuda.empty_cache()
        for name in ("new", "old"):
            ms = [v for (p, b, _, _), v in totals.items()
                  if p == label and b == name]
            print(f"{label} K2 per forward, {name}: "
                  + ", ".join(f"{v:.4f}" for v in ms) + " ms")
        print(f"{label} K2 per forward, cuDNN route: {lib_ms:.4f} ms")
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
