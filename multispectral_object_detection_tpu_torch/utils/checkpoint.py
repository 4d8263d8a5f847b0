"""Checkpoints: the port's training state, and reading for inference
without JAX or flax.

A run directory keeps the JAX package's layout: ``last/``, ``best/`` and
``epoch{N}/``, each with ``meta.json`` ({epoch, best_fitness, ...}). The
state is the port's own: ``state.pt``, a ``torch.save`` of {model, ema,
opt, step, ema_updates} (``TrainState.state_dict``), written atomically
(temporary file + rename), optionally on a background thread
(``CheckpointWriter``). ``strip_checkpoint`` keeps the EMA weights only, as
``model.pt``: a plain reference-layout state dict.

For inference these forms are read:

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
- a ``.pt`` file holding a reference-layout state dict;
- a port checkpoint directory: ``model.pt`` (stripped) or else the EMA
  of ``state.pt``.
"""

from __future__ import annotations

import json
import os
import struct
import threading
from pathlib import Path
from typing import Any, Dict, Optional, Union

import numpy as np
import torch

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
    """A checkpoint directory (the port's or the JAX package's) or a ``.pt``
    state dict -> a reference-layout state dict {key: array} of the
    unfused model: the stripped weights where there are some, else the
    training state's EMA."""
    p = Path(path)
    if p.is_dir():
        if (p / "model.pt").is_file():
            return load_inference_params(p / "model.pt")
        if (p / "model.msgpack").is_file():
            raw = msgpack_restore((p / "model.msgpack").read_bytes())
            params, stats = raw["params"], raw["batch_stats"]
        elif (p / "state.pt").is_file():
            return _tensors_to_numpy(_torch_load(p / "state.pt")["ema"])
        elif (p / "state.msgpack").is_file():
            raw = msgpack_restore((p / "state.msgpack").read_bytes())
            params, stats = raw["ema_params"], raw["ema_stats"]
        else:
            raise FileNotFoundError(f"{p}: none of model.pt, model.msgpack, "
                                    f"state.pt, state.msgpack")
        return state_dict_from_jax(params, stats)
    sd = _torch_load(p)
    if not isinstance(sd, dict) or not all(
            isinstance(k, str) and isinstance(v, torch.Tensor)
            for k, v in sd.items()):
        raise ValueError(f"{p}: expected a state dict of tensors")
    return _tensors_to_numpy(sd)


def _torch_load(p: Path):
    return torch.load(p, map_location="cpu", weights_only=True)


def _tensors_to_numpy(sd: dict) -> Dict[str, np.ndarray]:
    """Half-precision tensors are read as fp32 of the same values, as the
    msgpack path reads its bfloat16 leaves (numpy has no bfloat16)."""
    return {k: (v.float() if v.dtype in (torch.bfloat16, torch.float16)
                else v).detach().cpu().numpy() for k, v in sd.items()}


# ------------------------------------------------------------------ saving
def _atomic_write(path: Path, write) -> None:
    """write(tmp_path), then rename over ``path``: a crash mid-write never
    leaves a torn file behind."""
    tmp = path.with_name(path.name + ".tmp")
    write(tmp)
    os.replace(tmp, path)


def _to_cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree


def _write_checkpoint(p: Path, host_state: dict, info: dict) -> None:
    p.mkdir(parents=True, exist_ok=True)
    _atomic_write(p / "state.pt", lambda t: torch.save(host_state, t))
    _atomic_write(p / "meta.json",
                  lambda t: t.write_text(json.dumps(info, indent=1)))


class CheckpointWriter:
    """Writes checkpoints on a background thread, one at a time. ``save``
    joins the previous write first; ``wait`` joins the last and re-raises
    what it raised (a failed write must not pass for a saved one). Close
    with ``wait`` before reading a checkpoint back or exiting."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, p: Path, host_state: dict, info: dict) -> None:
        self.wait()

        def run():
            try:
                _write_checkpoint(p, host_state, info)
            except BaseException as e:  # re-raised by wait()
                self._error = e

        self._thread = threading.Thread(target=run, daemon=False)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("background checkpoint write failed") from err


def save_checkpoint(path, state, *, epoch: int, best_fitness: float,
                    meta: Optional[Dict[str, Any]] = None,
                    writer: Optional[CheckpointWriter] = None) -> None:
    """Write ``state`` (a train/trainer.TrainState, or its state dict) to
    the directory ``path``. The copy to host memory happens now; with
    ``writer`` the serialisation and the disk write run on its thread."""
    host_state = _to_cpu(state if isinstance(state, dict)
                         else state.state_dict())
    info = {"epoch": int(epoch), "best_fitness": float(best_fitness)}
    info.update(meta or {})
    if writer is None:
        _write_checkpoint(Path(path), host_state, info)
    else:
        writer.save(Path(path), host_state, info)


def _read_meta(p: Path) -> dict:
    f = p / "meta.json"
    return json.loads(f.read_text()) if f.is_file() else {}


def load_checkpoint(path, state=None):
    """(the raw state dict of ``state.pt``, meta). With ``state`` (a
    TrainState) restores it in place (model, EMA, optimizer, counters) and
    returns (state, meta)."""
    p = Path(path)
    raw = _torch_load(p / "state.pt")
    meta = _read_meta(p)
    if state is None:
        return raw, meta
    state.load_state_dict(raw)
    return state, meta


def partial_load(model, sd: Dict[str, Any]) -> tuple:
    """Copy every entry of ``sd`` (reference-layout arrays or tensors)
    whose key is in the model's state dict with the same shape; the rest
    keep their values (warm starts across class counts or anchors).
    Returns (n_copied, n_total)."""
    target = model.state_dict()
    n_copied = 0
    with torch.no_grad():
        for k, t in target.items():
            v = sd.get(k)
            if v is None or tuple(np.shape(v)) != tuple(t.shape):
                continue
            t.copy_(torch.as_tensor(np.asarray(v)).to(t.dtype))
            n_copied += 1
    return n_copied, len(target)


def strip_checkpoint(path, out_path=None) -> Path:
    """Finish a checkpoint directory for inference: its EMA weights as
    ``model.pt`` (a reference-layout state dict of fp32 tensors) in
    ``out_path`` (default: the same directory), meta marked ``stripped``.
    Takes the port's ``state.pt`` or the JAX package's
    ``state.msgpack``."""
    p = Path(path)
    out = Path(out_path or path)
    out.mkdir(parents=True, exist_ok=True)
    if (p / "state.pt").is_file():
        ema = {k: v.float() if v.is_floating_point() else v
               for k, v in _torch_load(p / "state.pt")["ema"].items()}
    elif (p / "state.msgpack").is_file():
        raw = msgpack_restore((p / "state.msgpack").read_bytes())
        ema = {k: torch.from_numpy(np.array(v)) for k, v in
               state_dict_from_jax(raw["ema_params"],
                                   raw["ema_stats"]).items()}
    else:
        raise FileNotFoundError(f"{p}: no state.pt or state.msgpack to strip")
    _atomic_write(out / "model.pt", lambda t: torch.save(ema, t))
    meta = _read_meta(p)
    meta["stripped"] = True
    _atomic_write(out / "meta.json",
                  lambda t: t.write_text(json.dumps(meta, indent=1)))
    return out / "model.pt"
