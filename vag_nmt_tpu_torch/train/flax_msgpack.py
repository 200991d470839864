"""A pure-Python reader of the msgpack that ``flax.serialization`` writes,
so the port reads a JAX run's ``state_{tag}.msgpack`` without flax, JAX or
the ``msgpack`` package.

It decodes every msgpack type flax emits (nil, bool, ints, floats, str,
bin, arrays as lists, maps as dicts) and flax's ext records: code 1, an
ndarray; code 3, a numpy scalar; code 2, a Python complex. An ndarray's
record is itself msgpack, the array ``(shape, dtype name, raw C-order
bytes)``; a scalar's is the same for a 0-d array. ``bfloat16`` (which
numpy lacks) comes back widened to float32, exactly. Arrays flax wrote in
chunks (``__msgpack_chunked_array__``, leaves over 1 GiB) are joined back.
The result is nested dicts and lists of numpy arrays and Python values,
as ``flax.serialization.msgpack_restore`` gives."""

from __future__ import annotations

import struct
from typing import Any, Tuple

import numpy as np

EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3
_CHUNKED = "__msgpack_chunked_array__"


class _Reader:
    """One msgpack value after another from ``buf``; ``raw``: str values
    stay bytes (flax's inner ndarray records are read so)."""

    def __init__(self, buf: bytes, raw: bool = False):
        self.buf = memoryview(buf)
        self.pos = 0
        self.raw = raw

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("msgpack: truncated input")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str) -> Any:
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def text(self, n: int):
        b = bytes(self.take(n))
        return b if self.raw else b.decode("utf-8")

    def value(self) -> Any:
        c = self.take(1)[0]
        if c <= 0x7F:
            return c
        if c >= 0xE0:
            return c - 0x100
        if 0x80 <= c <= 0x8F:
            return self.map(c & 0x0F)
        if 0x90 <= c <= 0x9F:
            return [self.value() for _ in range(c & 0x0F)]
        if 0xA0 <= c <= 0xBF:
            return self.text(c & 0x1F)
        fixed = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
                 0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if c in fixed:
            return self.unpack(fixed[c])
        if c == 0xC0:
            return None
        if c in (0xC2, 0xC3):
            return c == 0xC3
        lengths = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}
        if c in lengths:
            return bytes(self.take(self.unpack(lengths[c])))
        lengths = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}
        if c in lengths:
            return self.text(self.unpack(lengths[c]))
        if c in (0xDC, 0xDD):
            n = self.unpack(">H" if c == 0xDC else ">I")
            return [self.value() for _ in range(n)]
        if c in (0xDE, 0xDF):
            return self.map(self.unpack(">H" if c == 0xDE else ">I"))
        if 0xD4 <= c <= 0xD8:
            return self.ext(1 << (c - 0xD4))
        lengths = {0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}
        if c in lengths:
            return self.ext(self.unpack(lengths[c]))
        raise ValueError(f"msgpack: unknown type byte 0x{c:02x} at {self.pos - 1}")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out

    def ext(self, n: int) -> Any:
        code = self.unpack(">b")
        data = bytes(self.take(n))
        if code == EXT_NDARRAY:
            return _ndarray(data)
        if code == EXT_NPSCALAR:
            return _ndarray(data)[()]
        if code == EXT_COMPLEX:
            re, im = unpackb(data)
            return complex(re, im)
        raise ValueError(f"msgpack: ext code {code} is not one flax writes")


def _dtype(name: str) -> Tuple[np.dtype, bool]:
    """(numpy dtype of the stored bytes, whether they are bfloat16)."""
    if name == "bfloat16":
        return np.dtype("<u2"), True
    return np.dtype(name), False


def _ndarray(data: bytes) -> np.ndarray:
    shape, name, buf = _Reader(data, raw=True).value()
    dt, bf16 = _dtype(name.decode("ascii"))
    arr = np.frombuffer(buf, dtype=dt).reshape(shape)
    if bf16:         # the high half of a float32: widening is exact
        arr = (arr.astype(np.uint32) << 16).view(np.float32)
    return arr.copy()


def _unchunk(tree: Any) -> Any:
    """flax's chunked leaves (dicts under _CHUNKED) joined back into arrays."""
    if isinstance(tree, dict):
        if _CHUNKED in tree:
            shape = tuple(tree["shape"][k] for k in sorted(tree["shape"], key=int))
            parts = [tree["chunks"][k] for k in sorted(tree["chunks"], key=int)]
            return np.concatenate(parts).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_unchunk(v) for v in tree]
    return tree


def unpackb(data: bytes) -> Any:
    """One msgpack value: the counterpart of ``msgpack.unpackb(data,
    raw=False)`` with flax's ext records decoded (no chunk joining)."""
    r = _Reader(data)
    out = r.value()
    if r.pos != len(r.buf):
        raise ValueError(f"msgpack: {len(r.buf) - r.pos} bytes after the value")
    return out


def msgpack_restore(data: bytes) -> Any:
    """The counterpart of ``flax.serialization.msgpack_restore``."""
    return _unchunk(unpackb(data))
