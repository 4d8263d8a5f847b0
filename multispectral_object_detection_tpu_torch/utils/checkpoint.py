"""Reading checkpoints for inference, without JAX or flax.

Two forms are taken:

- a checkpoint directory of the JAX package: ``model.msgpack`` (stripped,
  ``{params, batch_stats}``) or else ``state.msgpack`` (its EMA weights,
  ``ema_params``/``ema_stats``). flax writes these with msgpack; the
  decoder below is the port's own (stdlib + numpy) and understands flax's
  extension types: 1 = ndarray, packed as msgpack (shape, dtype name,
  bytes); 2 = complex (real, imag); 3 = a numpy scalar, packed as an
  ndarray; and flax's chunked form of arrays above 1 GiB. bfloat16 arrays
  become float32 with the same values. The trees go through
  ``utils/jax_import.state_dict_from_jax`` into a reference-layout state
  dict.
- a ``.pt`` file holding a reference-layout state dict.
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Dict, Union

import numpy as np

from .jax_import import state_dict_from_jax

_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3
_CHUNKED = "__msgpack_chunked_array__"


class _Reader:
    """A msgpack decoder over one buffer (the subset flax emits: nil, bool,
    ints, floats, str, bin, array, map, ext)."""

    def __init__(self, buf):
        self.buf = memoryview(buf)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("msgpack data ends early")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self):
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return str(self.take(b & 0x1F), "utf-8")
        fixed = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in fixed:
            return fixed[b]
        sized = {0xC4: ("B", "bin"), 0xC5: (">H", "bin"), 0xC6: (">I", "bin"),
                 0xD9: ("B", "str"), 0xDA: (">H", "str"), 0xDB: (">I", "str"),
                 0xDC: (">H", "array"), 0xDD: (">I", "array"),
                 0xDE: (">H", "map"), 0xDF: (">I", "map"),
                 0xC7: ("B", "ext"), 0xC8: (">H", "ext"), 0xC9: (">I", "ext")}
        if b in sized:
            fmt, kind = sized[b]
            n = self.unpack(fmt)
            if kind == "bin":
                return self.take(n)
            if kind == "str":
                return str(self.take(n), "utf-8")
            if kind == "array":
                return self.array(n)
            if kind == "map":
                return self.map(n)
            return self.ext(self.unpack("b"), n)
        if 0xD4 <= b <= 0xD8:  # fixext 1, 2, 4, 8, 16
            return self.ext(self.unpack("b"), 1 << (b - 0xD4))
        numbers = {0xCA: ">f", 0xCB: ">d", 0xCC: "B", 0xCD: ">H", 0xCE: ">I",
                   0xCF: ">Q", 0xD0: "b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in numbers:
            return self.unpack(numbers[b])
        raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out

    def ext(self, code: int, n: int):
        data = self.take(n)
        if code == _EXT_NDARRAY:
            return _ndarray(data)
        if code == _EXT_NPSCALAR:
            return _ndarray(data)[()]
        if code == _EXT_COMPLEX:
            re, im = _Reader(data).value()
            return complex(re, im)
        raise ValueError(f"unknown msgpack extension type {code}")


def _ndarray(data: memoryview) -> np.ndarray:
    shape, name, raw = _Reader(data).value()
    name = name if isinstance(name, str) else str(name, "ascii")
    if name == "bfloat16":  # the top half of a float32
        bits = np.frombuffer(raw, np.uint16).astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(raw, np.dtype(name)).reshape(shape)


def _unchunk(tree):
    if isinstance(tree, dict):
        if _CHUNKED in tree:
            shape = tuple(tree["shape"][str(i)]
                          for i in range(len(tree["shape"])))
            chunks = [tree["chunks"][str(i)]
                      for i in range(len(tree["chunks"]))]
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def msgpack_restore(data: bytes):
    """flax-serialized msgpack bytes -> a tree of dicts, lists, Python
    scalars and numpy arrays (writable, not sharing ``data``)."""
    r = _Reader(bytearray(data))
    tree = r.value()
    if r.pos != len(r.buf):
        raise ValueError("trailing bytes after the msgpack object")
    return _unchunk(tree)


def load_inference_params(path: Union[str, Path]) -> Dict[str, np.ndarray]:
    """A JAX checkpoint directory or a ``.pt`` state dict -> a
    reference-layout state dict {key: array} of the unfused model."""
    p = Path(path)
    if p.is_dir():
        if (p / "model.msgpack").is_file():
            raw = msgpack_restore((p / "model.msgpack").read_bytes())
            params, stats = raw["params"], raw["batch_stats"]
        elif (p / "state.msgpack").is_file():
            raw = msgpack_restore((p / "state.msgpack").read_bytes())
            params, stats = raw["ema_params"], raw["ema_stats"]
        else:
            raise FileNotFoundError(f"{p}: neither model.msgpack nor "
                                    f"state.msgpack")
        return state_dict_from_jax(params, stats)
    import torch

    sd = torch.load(p, map_location="cpu", weights_only=True)
    if not isinstance(sd, dict) or not all(
            isinstance(k, str) and isinstance(v, torch.Tensor)
            for k, v in sd.items()):
        raise ValueError(f"{p}: expected a state dict of tensors")
    # half-precision tensors are read as fp32 of the same values, as the
    # msgpack path reads its bfloat16 leaves (numpy has no bfloat16)
    return {k: (v.float() if v.dtype in (torch.bfloat16, torch.float16)
                else v).numpy() for k, v in sd.items()}
