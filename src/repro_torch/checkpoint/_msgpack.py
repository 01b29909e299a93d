"""The subset of MessagePack that a checkpoint's manifest uses, written and
read without the ``msgpack`` package.

``packb`` gives the bytes that ``msgpack.packb`` gives with its defaults for
nil, bool, int (the smallest encoding: positive and negative fixint,
uint8-64, int8-64), float (float64), str (fixstr, str8/16/32), list and tuple
(fixarray, array16/32) and dict (fixmap, map16/32), subclasses included.
Any other type raises ``TypeError``; an int outside [-2^63, 2^64) raises
``OverflowError``, as ``msgpack.packb`` does. ``unpackb`` reads those
formats back: arrays as lists, maps as dicts.
"""
from __future__ import annotations

import struct


def _int(v: int) -> bytes:
    if v >= 0:
        if v < 0x80:
            return bytes((v,))
        for code, fmt, limit in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
                                 (0xCE, ">I", 1 << 32), (0xCF, ">Q", 1 << 64)):
            if v < limit:
                return bytes((code,)) + struct.pack(fmt, v)
    else:
        if v >= -32:
            return struct.pack(">b", v)
        for code, fmt, limit in ((0xD0, ">b", 1 << 7), (0xD1, ">h", 1 << 15),
                                 (0xD2, ">i", 1 << 31), (0xD3, ">q", 1 << 63)):
            if v >= -limit:
                return bytes((code,)) + struct.pack(fmt, v)
    raise OverflowError("Integer value out of range")


def _header(n: int, fix: int, fix_max: int, codes: tuple) -> bytes:
    """A length header: the fix form up to ``fix_max``, else the 8-bit (if
    ``codes`` has three), 16-bit or 32-bit form."""
    if n <= fix_max:
        return bytes((fix | n,))
    forms = list(zip(codes, (">B", ">H", ">I")[3 - len(codes):],
                     (1 << 8, 1 << 16, 1 << 32)[3 - len(codes):]))
    for code, fmt, limit in forms:
        if n < limit:
            return bytes((code,)) + struct.pack(fmt, n)
    raise ValueError(f"length {n} exceeds MessagePack's 2^32 - 1")


def _pack(obj, out: list) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True or obj is False:
        out.append(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, int):
        out.append(_int(obj))
    elif isinstance(obj, float):
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        out.append(_header(len(data), 0xA0, 31, (0xD9, 0xDA, 0xDB)) + data)
    elif isinstance(obj, (list, tuple)):
        out.append(_header(len(obj), 0x90, 15, (0xDC, 0xDD)))
        for item in obj:
            _pack(item, out)
    elif isinstance(obj, dict):
        out.append(_header(len(obj), 0x80, 15, (0xDE, 0xDF)))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"can not serialize {type(obj).__qualname__!r} object")


def packb(obj) -> bytes:
    out: list[bytes] = []
    _pack(obj, out)
    return b"".join(out)


# (struct format, byte count) of each fixed-width scalar, by its type byte
_SCALARS = {0xCB: (">d", 8),
            0xCC: (">B", 1), 0xCD: (">H", 2), 0xCE: (">I", 4), 0xCF: (">Q", 8),
            0xD0: (">b", 1), 0xD1: (">h", 2), 0xD2: (">i", 4), 0xD3: (">q", 8)}
# (struct format of the length, kind) of each sized form
_SIZED = {0xD9: (">B", "str"), 0xDA: (">H", "str"), 0xDB: (">I", "str"),
          0xDC: (">H", "array"), 0xDD: (">I", "array"),
          0xDE: (">H", "map"), 0xDF: (">I", "map")}


class _Reader:
    def __init__(self, data: bytes):
        self.data, self.pos = memoryview(data), 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated MessagePack data")
        chunk = self.data[self.pos:self.pos + n]
        self.pos += n
        return chunk

    def unpack(self, fmt: str, n: int):
        return struct.unpack(fmt, self.take(n))[0]

    def value(self):
        code = self.take(1)[0]
        if code <= 0x7F:
            return code
        if code >= 0xE0:
            return code - 0x100
        if 0xA0 <= code <= 0xBF:
            return self.str(code & 0x1F)
        if 0x90 <= code <= 0x9F:
            return self.array(code & 0x0F)
        if 0x80 <= code <= 0x8F:
            return self.map(code & 0x0F)
        if code == 0xC0:
            return None
        if code in (0xC2, 0xC3):
            return code == 0xC3
        if code in _SCALARS:
            return self.unpack(*_SCALARS[code])
        if code in _SIZED:
            fmt, kind = _SIZED[code]
            n = self.unpack(fmt, struct.calcsize(fmt))
            return getattr(self, kind)(n)
        raise ValueError(f"MessagePack type byte 0x{code:02x} is outside the manifest's subset")

    def str(self, n: int) -> str:
        return bytes(self.take(n)).decode("utf-8")

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out


def unpackb(data: bytes):
    reader = _Reader(data)
    obj = reader.value()
    if reader.pos != len(reader.data):
        raise ValueError(f"{len(reader.data) - reader.pos} bytes of extra data")
    return obj
