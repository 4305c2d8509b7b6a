"""Reader and writer of the JAX package's msgpack checkpoints.

The JAX package saves ``{"variables": ..., "extra": ...}`` trees with
Flax's ``msgpack_serialize`` (``robustart_tpu/solvers/base.py:50-68``):
msgpack maps with string keys, and every array leaf as msgpack extension
type 1, whose payload is itself msgpack ``[shape, dtype name, raw C-order
bytes]`` (type 3 is a numpy scalar in the same form). Arrays over 2³⁰
bytes are split into ``{"__msgpack_chunked_array__": True, "shape",
"chunks"}`` maps. This module decodes and encodes that format with no
``msgpack``, ``flax`` or ``ml_dtypes`` package: arrays come back as numpy
arrays, except ``bfloat16``, which numpy lacks, as a ``torch.bfloat16``
tensor viewed from the raw 16-bit words.
"""

from __future__ import annotations

import struct
from typing import Any

import numpy as np
import torch

_NDARRAY, _COMPLEX, _NPSCALAR = 1, 2, 3
_CHUNKED = "__msgpack_chunked_array__"


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        out = self.data[self.pos:self.pos + n]
        if len(out) != n:
            raise ValueError("truncated msgpack data")
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self) -> Any:
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.value() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return str(self.take(b & 0x1F), "utf-8")
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        sized = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I", 0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}
        if b in sized:
            raw = bytes(self.take(self.unpack(sized[b])))
            return raw if b <= 0xC6 else raw.decode("utf-8")
        ext = {0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}
        if b in ext:
            n = self.unpack(ext[b])
            return self.ext(self.unpack(">b"), bytes(self.take(n)))
        if 0xD4 <= b <= 0xD8:
            code = self.unpack(">b")
            return self.ext(code, bytes(self.take(1 << (b - 0xD4))))
        numbers = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                   0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in numbers:
            return self.unpack(numbers[b])
        if b in (0xDC, 0xDD):
            return [self.value() for _ in range(self.unpack(">H" if b == 0xDC else ">I"))]
        if b in (0xDE, 0xDF):
            return self.map(self.unpack(">H" if b == 0xDE else ">I"))
        raise ValueError(f"unknown msgpack type byte 0x{b:02x}")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out

    @staticmethod
    def ext(code: int, payload: bytes):
        if code in (_NDARRAY, _NPSCALAR):
            arr = _array_from_payload(payload)
            return arr if code == _NDARRAY else arr[()]
        if code == _COMPLEX:
            re_, im = loads(payload)
            return complex(re_, im)
        raise ValueError(f"unknown msgpack extension type {code}")


def _array_from_payload(payload: bytes):
    shape, name, raw = loads(payload)
    name = name.decode() if isinstance(name, bytes) else name
    if name == "bfloat16":
        words = np.frombuffer(raw, dtype=np.int16).reshape(shape)
        return torch.from_numpy(words.copy()).view(torch.bfloat16)
    return np.frombuffer(raw, dtype=np.dtype(name)).reshape(shape)


def _unchunk(tree):
    if isinstance(tree, dict):
        if _CHUNKED in tree:
            shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
            chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
            if isinstance(chunks[0], torch.Tensor):
                return torch.cat(chunks).reshape(shape)
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def loads(data: bytes) -> Any:
    """Decode one msgpack object (Flax's ``msgpack_restore``: array leaves
    as numpy arrays, bfloat16 as torch tensors, chunked arrays joined)."""
    reader = _Reader(data)
    out = reader.value()
    if reader.pos != len(reader.data):
        raise ValueError("trailing bytes after the msgpack object")
    return _unchunk(out)


def load(path: str) -> Any:
    with open(path, "rb") as f:
        return loads(f.read())


# -- writer -------------------------------------------------------------------


def _pack_len(n: int, fix: int, fix_max: int, codes: tuple[int, int, int]) -> bytes:
    if n <= fix_max and fix is not None:
        return bytes([fix | n])
    for code, fmt, limit in zip(codes, (">B", ">H", ">I"), (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if code is not None and n <= limit:
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"msgpack length {n} too large")


def _array_payload(value) -> bytes:
    if isinstance(value, torch.Tensor):
        t = value.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return dumps([list(t.shape), "bfloat16", t.view(torch.int16).numpy().tobytes()])
        value = t.numpy()
    arr = np.asarray(value)  # tobytes() is C order; a 0-d array keeps its shape
    return dumps([list(arr.shape), arr.dtype.name, arr.tobytes()])


def _ext(code: int, payload: bytes) -> bytes:
    n = len(payload)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    head = (bytes([fixed[n]]) if n in fixed
            else _pack_len(n, None, -1, (0xC7, 0xC8, 0xC9)))
    return head + struct.pack(">b", code) + payload


def dumps(obj: Any) -> bytes:
    """Encode a tree of dicts, lists, str, bytes, numbers, None, numpy
    arrays and torch tensors as Flax's ``msgpack_serialize`` does (arrays
    as extension type 1; no chunking, so an array must be under 2³⁰
    bytes)."""
    if obj is None:
        return b"\xc0"
    if obj is True or obj is False:
        return b"\xc3" if obj else b"\xc2"
    if isinstance(obj, (np.ndarray, torch.Tensor)):
        return _ext(_NDARRAY, _array_payload(obj))
    if isinstance(obj, np.generic):
        return _ext(_NPSCALAR, _array_payload(np.asarray(obj)))
    if isinstance(obj, int):
        if 0 <= obj <= 0x7F:
            return bytes([obj])
        if -32 <= obj < 0:
            return struct.pack(">b", obj)
        return b"\xd3" + struct.pack(">q", obj) if obj < 0 else b"\xcf" + struct.pack(">Q", obj)
    if isinstance(obj, float):
        return b"\xcb" + struct.pack(">d", obj)
    if isinstance(obj, str):
        raw = obj.encode("utf-8")
        return _pack_len(len(raw), 0xA0, 31, (0xD9, 0xDA, 0xDB)) + raw
    if isinstance(obj, (bytes, bytearray)):
        return _pack_len(len(obj), None, -1, (0xC4, 0xC5, 0xC6)) + bytes(obj)
    if isinstance(obj, (list, tuple)):
        return _pack_len(len(obj), 0x90, 15, (None, 0xDC, 0xDD)) + b"".join(map(dumps, obj))
    if isinstance(obj, dict):
        body = b"".join(dumps(k) + dumps(v) for k, v in obj.items())
        return _pack_len(len(obj), 0x80, 15, (None, 0xDE, 0xDF)) + body
    raise TypeError(f"cannot encode {type(obj).__name__} as msgpack")

