"""PyTorch port, kernel bindings: every ``extern "C"`` entry point of
``kernels/csrc/*.cu`` has its ctypes signature in ``kernels.SIGNATURES``,
argument for argument, the stream last. The sources compile only on the
card machine, so this is what catches a mismatch here."""

import ctypes
import re

import pytest

from multispectral_object_detection_tpu_torch import kernels
from tests._torch_port import share_torch_threads  # noqa: F401

_ENTRY = re.compile(r'extern\s+"C"\s+int\s+(\w+)\s*\(([^)]*)\)', re.S)
_CTYPE = {"ptr": ctypes.c_void_p, "int": ctypes.c_int,
          "float": ctypes.c_float}


def _c_kind(param: str) -> str:
    """'const void* qkv' -> 'ptr'; 'int N' -> 'int'; 'float eps' -> 'float'."""
    decl = " ".join(param.split())
    if "*" in decl:
        return "ptr"
    return decl.split()[-2]


def _entry_points(name):
    src = (kernels.CSRC / f"{name}.cu").read_text()
    return {fn: [p for p in args.split(",") if p.strip()]
            for fn, args in _ENTRY.findall(src)}


def test_every_source_has_signatures_and_back():
    sources = {p.stem for p in kernels.CSRC.glob("*.cu")}
    assert sources == set(kernels.SIGNATURES)


@pytest.mark.parametrize("name", sorted(kernels.SIGNATURES))
def test_signatures_match_the_c_entry_points(name):
    found = _entry_points(name)
    assert set(found) == set(kernels.SIGNATURES[name]), found
    for fn, params in found.items():
        argtypes = kernels.SIGNATURES[name][fn]
        assert len(argtypes) == len(params), (fn, params)
        assert " ".join(params[-1].split()) == "void* stream", fn
        assert [_CTYPE[_c_kind(p)] for p in params] == argtypes, fn
