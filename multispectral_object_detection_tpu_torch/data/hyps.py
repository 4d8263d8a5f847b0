"""Hyperparameter presets: the reference hyp.scratch.yaml and hyp.finetune.yaml,
and the evolution bounds (key -> (mutation scale, lower, upper)).

The port's copy of multispectral_object_detection_tpu/data/hyps.py.
``dump_flat_yaml`` writes the flat maps of a run directory (``hyp.yaml``,
``opt.yaml``) without PyYAML and ``load_flat_yaml`` reads them back, as it
reads data YAMLs and the reference's model YAMLs (nested flow sequences);
``read_yaml`` reads a YAML file through PyYAML where it is installed, else
through ``load_flat_yaml``.
"""

from __future__ import annotations

import copy
import json
import re
from typing import Dict

HYP_SCRATCH: Dict[str, float] = {
    "lr0": 0.01, "lrf": 0.2, "momentum": 0.937, "weight_decay": 0.0005,
    "warmup_epochs": 3.0, "warmup_momentum": 0.8, "warmup_bias_lr": 0.1,
    "box": 0.05, "cls": 0.5, "cls_pw": 1.0, "obj": 1.0, "obj_pw": 1.0,
    "iou_t": 0.20, "anchor_t": 4.0, "fl_gamma": 0.0,
    "hsv_h": 0.015, "hsv_s": 0.7, "hsv_v": 0.4,
    "degrees": 0.0, "translate": 0.1, "scale": 0.5, "shear": 0.0,
    "perspective": 0.0, "flipud": 0.0, "fliplr": 0.5,
    "mosaic": 1.0, "mixup": 0.0, "label_smoothing": 0.0,
}

HYP_FINETUNE: Dict[str, float] = {
    **HYP_SCRATCH,
    "lr0": 0.0032, "lrf": 0.12, "momentum": 0.843, "weight_decay": 0.00036,
    "warmup_epochs": 2.0, "warmup_momentum": 0.5, "warmup_bias_lr": 0.05,
    "box": 0.0296, "cls": 0.243, "cls_pw": 0.631, "obj": 0.301, "obj_pw": 0.911,
    "anchor_t": 2.91, "fl_gamma": 0.0,
    "hsv_h": 0.0138, "hsv_s": 0.664, "hsv_v": 0.464,
    "degrees": 0.373, "translate": 0.245, "scale": 0.898, "shear": 0.602,
    "perspective": 0.0, "flipud": 0.00856, "fliplr": 0.5,
    "mosaic": 1.0, "mixup": 0.243,
}

# (mutation scale, lower bound, upper bound) per evolvable key
EVOLVE_META = {
    "lr0": (1, 1e-5, 1e-1), "lrf": (1, 0.01, 1.0), "momentum": (0.3, 0.6, 0.98),
    "weight_decay": (1, 0.0, 0.001), "warmup_epochs": (1, 0.0, 5.0),
    "warmup_momentum": (1, 0.0, 0.95), "warmup_bias_lr": (1, 0.0, 0.2),
    "box": (1, 0.02, 0.2), "cls": (1, 0.2, 4.0), "cls_pw": (1, 0.5, 2.0),
    "obj": (1, 0.2, 4.0), "obj_pw": (1, 0.5, 2.0), "iou_t": (0, 0.1, 0.7),
    "anchor_t": (1, 2.0, 8.0), "fl_gamma": (0, 0.0, 2.0),
    "hsv_h": (1, 0.0, 0.1), "hsv_s": (1, 0.0, 0.9), "hsv_v": (1, 0.0, 0.9),
    "degrees": (1, 0.0, 45.0), "translate": (1, 0.0, 0.9),
    "scale": (1, 0.0, 0.9), "shear": (1, 0.0, 10.0),
    "perspective": (0, 0.0, 0.001), "flipud": (1, 0.0, 1.0),
    "fliplr": (0, 0.0, 1.0), "mosaic": (1, 0.0, 1.0), "mixup": (1, 0.0, 1.0),
}


def load_hyp(spec) -> Dict[str, float]:
    """'scratch' | 'finetune' | a YAML path | a dict -> hyp dict (keys the
    spec leaves out keep their scratch values)."""
    if spec is None or spec == "scratch":
        return copy.deepcopy(HYP_SCRATCH)
    if spec == "finetune":
        return copy.deepcopy(HYP_FINETUNE)
    out = copy.deepcopy(HYP_SCRATCH)
    if isinstance(spec, dict):
        out.update(spec)
        return out
    out.update(read_yaml(spec) or {})
    return out


def read_yaml(path):
    """A YAML file's contents: through PyYAML where it imports, else (a
    machine without it) through ``load_flat_yaml``, which reads a map of
    scalars and (nested) lists and raises ValueError on anything else."""
    with open(path) as f:
        text = f.read()
    try:
        import yaml
    except ImportError:
        return load_flat_yaml(text)
    return yaml.safe_load(text)


def _scalar(v) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return repr(v)
    if isinstance(v, float):
        r = repr(v)
        mant, _, exp = r.partition("e")
        # YAML 1.1 reads 1e-05 as a string: its floats need a dot
        return f"{mant}.0e{exp}" if exp and "." not in mant else r
    # a JSON string is a valid YAML double-quoted scalar
    return json.dumps(str(v))


def dump_flat_yaml(d: dict) -> str:
    """A map of scalars and lists of scalars as YAML (block style, keys
    sorted, as yaml.safe_dump writes them); PyYAML reads it back to the
    same values."""
    lines = []
    for k in sorted(d):
        v = d[k]
        if isinstance(v, (list, tuple)):
            lines.append(f"{k}:" if v else f"{k}: []")
            lines.extend(f"- {_scalar(x)}" for x in v)
        else:
            lines.append(f"{k}: {_scalar(v)}")
    return "\n".join(lines) + "\n"


# YAML 1.1's plain scalars, as PyYAML's safe loader resolves them
_NULL = re.compile(r"~|null|Null|NULL|")
_TRUE = re.compile(r"yes|Yes|YES|true|True|TRUE|on|On|ON")
_FALSE = re.compile(r"no|No|NO|false|False|FALSE|off|Off|OFF")
_INT = re.compile(r"[-+]?(?:0|[1-9][0-9_]*)")
_FLOAT = re.compile(r"[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9_]+(?:[eE][-+][0-9]+)?")
_INF = re.compile(r"([-+]?)\.(?:inf|Inf|INF)")
_NAN = re.compile(r"\.(?:nan|NaN|NAN)")
# what PyYAML resolves and this reader does not: octal, hex, binary and
# base-60 numbers, dates and timestamps, the merge and value keys
_UNREAD = re.compile(
    r"[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?0x[0-9a-fA-F_]+"
    r"|[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?"
    r"|[0-9]{4}-[0-9]{2}-[0-9]{2}"
    r"|[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}(?:[Tt]|[ \t]+)[0-9]{1,2}:[0-9]{2}"
    r":[0-9]{2}(?:\.[0-9]*)?(?:[ \t]*(?:Z|[-+][0-9]{1,2}(?::[0-9]{2})?))?"
    r"|<<|=")


def _split_comment(v: str) -> str:
    """A scalar without its trailing `` # comment`` (outside quotes)."""
    quote, escaped = None, False
    for i, ch in enumerate(v):
        if escaped:
            escaped = False
        elif quote:
            escaped = ch == "\\" and quote == '"'
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
        elif ch == "#" and (i == 0 or v[i - 1] in " \t"):
            return v[:i].strip()
    return v.strip()


def _parse_scalar(v: str):
    v = v.strip()
    if v.startswith('"'):
        return json.loads(v)  # dump_flat_yaml's strings are JSON strings
    if v.startswith("'"):
        if len(v) < 2 or not v.endswith("'"):
            raise ValueError(f"unterminated quoted scalar {v!r}")
        return v[1:-1].replace("''", "'")
    if v[:1] in ("[", "{", "&", "*", "!", "|", ">", "%", "@", "`") or \
            v.startswith("- ") or v == "-" or ": " in v or v.endswith(":"):
        raise ValueError(f"not a flat YAML scalar: {v!r}")
    if _NULL.fullmatch(v):
        return None
    if _TRUE.fullmatch(v):
        return True
    if _FALSE.fullmatch(v):
        return False
    if _INT.fullmatch(v):
        return int(v.replace("_", ""))
    if _FLOAT.fullmatch(v):
        return float(v.replace("_", ""))
    m = _INF.fullmatch(v)
    if m:
        return float(f"{m.group(1)}inf")
    if _NAN.fullmatch(v):
        return float("nan")
    if _UNREAD.fullmatch(v):
        raise ValueError(f"a scalar PyYAML reads as a number, date or key "
                         f"and this reader does not: {v!r}")
    return v


class _Flow:
    """A flow sequence (``[a, [b, 'c'], "d"]``, nested to any depth) read
    from ``text``, the lines of the file from where it opens joined by
    newlines, comments taken off; ``line0`` is the first one's number."""

    def __init__(self, text: str, line0: int):
        self.text, self.pos, self.line0 = text, 0, line0

    def error(self, what: str) -> ValueError:
        n = self.line0 + self.text.count("\n", 0, self.pos)
        return ValueError(f"line {n}: {what}")

    def skip_space(self) -> None:
        while self.pos < len(self.text) and self.text[self.pos] in " \t\n":
            self.pos += 1

    def peek(self) -> str:
        return self.text[self.pos:self.pos + 1]

    def sequence(self) -> list:
        self.pos += 1  # [
        items = []
        while True:
            self.skip_space()
            if self.peek() == "]":
                self.pos += 1
                return items
            items.append(self.node())
            self.skip_space()
            if self.peek() == ",":
                self.pos += 1
            elif self.peek() != "]":
                raise self.error("expected ',' or ']' in a flow sequence")

    def node(self):
        c = self.peek()
        if c == "[":
            return self.sequence()
        if c in ("'", '"'):
            end = self.pos + 1
            while True:  # '' is an escaped quote in single quotes
                end = self.text.find(c, end)
                if end < 0 or "\n" in self.text[self.pos:end]:
                    raise self.error("a quoted scalar not closed on its line")
                if c == '"' and self.text[end - 1] == "\\" or \
                        c == "'" and self.text[end + 1:end + 2] == "'":
                    end += 1 if c == '"' else 2
                    continue
                break
            tok, self.pos = self.text[self.pos:end + 1], end + 1
            try:
                return _parse_scalar(tok)
            except json.JSONDecodeError:
                raise self.error(f"a double-quoted scalar JSON does not "
                                 f"read: {tok}") from None
        end = self.pos
        while end < len(self.text) and self.text[end] not in ",[]{}\n":
            end += 1
        tok = self.text[self.pos:end].strip()
        if not tok or ":" in tok or tok[0] in "?#&*!|>%@`{}" or tok == "-" \
                or tok.startswith("- "):
            raise self.error(f"not a plain scalar of a flow sequence: "
                             f"{self.text[self.pos:end + 1]!r}")
        self.pos = end
        try:
            return _parse_scalar(tok)
        except ValueError as e:
            raise self.error(str(e)) from None


def _flow_value(rows: list, i: int, first: str):
    """The flow sequence that opens ``first`` (the rest of row ``i``),
    read across the rows after it. Returns it and the index of the row
    after the one where it closes, whose rest must be blank."""
    n0 = rows[i][0]
    flow = _Flow("\n".join([first] + [r[2] for r in rows[i + 1:]]), n0)
    value = flow.sequence()
    rest = flow.text[flow.pos:].split("\n", 1)[0]
    if rest.strip():
        raise flow.error(f"text after a flow sequence: {rest.strip()!r}")
    return value, i + 1 + flow.text.count("\n", 0, flow.pos)


def load_flat_yaml(text: str):
    """A YAML map read to the values PyYAML's ``safe_load`` gives, without
    PyYAML: the inverse of ``dump_flat_yaml``, data YAMLs, and the
    reference's model YAMLs. Keys at the top level only; their values
    scalars, block ``- x`` items, or flow sequences nested to any depth and
    spread over lines (``backbone:`` then ``[[-1, 1, Focus, [64, 3]], ...]``
    on the lines after it), with comments. None for a text without
    content, as ``safe_load``. Raises ValueError naming the line on any
    other YAML (nested maps, flow maps, anchors, multi-line plain or quoted
    scalars, numbers in a form other than decimal, dates)."""
    rows = [(n, raw[:1] in (" ", "\t"), _split_comment(raw))
            for n, raw in enumerate(text.splitlines(), 1)]
    out: dict = {}
    key, items = None, None  # the last key with no value on its line
    i, started, ended = 0, False, False  # by content; by a "..." line
    while i < len(rows):
        n, indented, line = rows[i]
        if not line:
            i += 1
            continue
        if ended or (line == "---" and started):
            raise ValueError(f"line {n}: a second YAML document")
        started = True
        if line in ("---", "...") and not indented:
            ended = line == "..."
            i += 1
            continue
        if line.startswith(("---", "...")) and not indented:
            raise ValueError(f"line {n}: a document marker with content")
        if line == "-" or line.startswith("- "):
            if key is None:
                raise ValueError(f"line {n}: a list item outside a list")
            if items is None:
                items = out[key] = []
            v = line[1:].strip()
            if v.startswith("["):
                value, i = _flow_value(rows, i, v)
            else:
                value, i = _parse_scalar_at(v, n), i + 1
            items.append(value)
            continue
        if indented and line.startswith("[") and key is not None \
                and items is None:
            out[key], i = _flow_value(rows, i, line)
            key = None
            continue
        if indented:
            raise ValueError(f"line {n}: nested YAML is not a flat map")
        k, sep, v = line.partition(":")
        if not sep or (v and v[0] not in " \t"):
            raise ValueError(f"line {n}: expected 'key: value', got {line!r}")
        k = _parse_scalar_at(k, n)
        if k in out:
            raise ValueError(f"line {n}: duplicate key {k!r}")
        v = v.strip()
        key, items = (k, None) if not v else (None, None)
        if v.startswith("["):
            out[k], i = _flow_value(rows, i, v)
            continue
        out[k] = _parse_scalar_at(v, n) if v else None
        i += 1
    return out or None


def _parse_scalar_at(v: str, n: int):
    try:
        return _parse_scalar(v)
    except ValueError as e:
        raise ValueError(f"line {n}: {e}") from None
