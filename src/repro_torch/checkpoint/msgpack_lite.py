"""The MessagePack subset of a checkpoint index, without the ``msgpack``
package (the card's machine has none).

``packb`` encodes what an index holds: nil, bool, int (up to 64 bits),
float (as float64), str, list/tuple and dict, each in the smallest format
that holds it, as ``msgpack.packb`` does with its defaults, so the bytes
are the same.
``unpackb`` decodes every MessagePack format but ``ext``, as
``msgpack.unpackb`` does with its defaults: str to ``str``, bin to
``bytes``, arrays to lists, maps to dicts.
"""
from __future__ import annotations

import struct
from typing import Any, Tuple


def _head(n: int, fix: int, fix_max: int, codes: Tuple[int, int, int]) -> bytes:
    """The header of a length-prefixed item: a fix form below ``fix_max``,
    else the 8/16/32-bit length form (``codes``; 0 where there is none:
    arrays and maps have no 8-bit form)."""
    if n < fix_max:
        return bytes([fix | n])
    for code, fmt, limit in zip(codes, (">B", ">H", ">I"), (1 << 8, 1 << 16, 1 << 32)):
        if code and n < limit:
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"msgpack: an item of length {n} is too long")


def _pack(obj: Any, out: bytearray) -> None:
    if obj is None:
        out.append(0xC0)
    elif obj is True:
        out.append(0xC3)
    elif obj is False:
        out.append(0xC2)
    elif isinstance(obj, int):
        if 0 <= obj < 0x80:
            out.append(obj)
        elif -32 <= obj < 0:
            out += struct.pack(">b", obj)
        elif obj >= 0:
            for code, fmt, limit in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
                                     (0xCE, ">I", 1 << 32), (0xCF, ">Q", 1 << 64)):
                if obj < limit:
                    out += bytes([code]) + struct.pack(fmt, obj)
                    return
            raise OverflowError(f"msgpack: int {obj} is too big")
        else:
            for code, fmt, limit in ((0xD0, ">b", 1 << 7), (0xD1, ">h", 1 << 15),
                                     (0xD2, ">i", 1 << 31), (0xD3, ">q", 1 << 63)):
                if obj >= -limit:
                    out += bytes([code]) + struct.pack(fmt, obj)
                    return
            raise OverflowError(f"msgpack: int {obj} is too small")
    elif isinstance(obj, float):
        out += b"\xcb" + struct.pack(">d", obj)
    elif isinstance(obj, str):
        b = obj.encode("utf-8")
        out += _head(len(b), 0xA0, 32, (0xD9, 0xDA, 0xDB)) + b
    elif isinstance(obj, (list, tuple)):
        out += _head(len(obj), 0x90, 16, (0, 0xDC, 0xDD))
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, dict):
        out += _head(len(obj), 0x80, 16, (0, 0xDE, 0xDF))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"msgpack: cannot serialize {type(obj).__name__}")


def packb(obj: Any) -> bytes:
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("msgpack: unexpected end of data")
        b = bytes(self.data[self.pos:self.pos + n])
        self.pos += n
        return b

    def unpack(self, fmt: str) -> Any:
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self) -> Any:
        c = self.unpack(">B")
        if c <= 0x7F:
            return c
        if c >= 0xE0:
            return c - 0x100
        if 0x80 <= c <= 0x8F:
            return self.map(c & 0x0F)
        if 0x90 <= c <= 0x9F:
            return [self.value() for _ in range(c & 0x0F)]
        if 0xA0 <= c <= 0xBF:
            return self.take(c & 0x1F).decode("utf-8")
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if c in simple:
            return simple[c]
        scalars = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                   0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if c in scalars:
            return self.unpack(scalars[c])
        lengths = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I", 0xD9: ">B", 0xDA: ">H", 0xDB: ">I",
                   0xDC: ">H", 0xDD: ">I", 0xDE: ">H", 0xDF: ">I"}
        if c in lengths:
            n = self.unpack(lengths[c])
            if c <= 0xC6:
                return self.take(n)
            if c <= 0xDB:
                return self.take(n).decode("utf-8")
            if c <= 0xDD:
                return [self.value() for _ in range(n)]
            return self.map(n)
        raise ValueError(f"msgpack: format 0x{c:02x} (ext or reserved) is not supported")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            if not isinstance(k, (str, bytes)):
                raise ValueError(f"msgpack: map key of type {type(k).__name__}")
            out[k] = self.value()
        return out


def unpackb(data: bytes) -> Any:
    r = _Reader(data)
    obj = r.value()
    if r.pos != len(r.data):
        raise ValueError("msgpack: extra data after the first object")
    return obj
