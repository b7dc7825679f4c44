"""Minimal msgpack for the manifest: map, str, bin, int, list (plus
nil and bool).

The port does not depend on the ``msgpack`` package, and the manifest
must stay byte-identical across the two packages, so this
encoder picks exactly the encodings ``msgpack.packb(obj,
use_bin_type=True)`` picks: the smallest fixed-width form of each int,
``str8`` for short strings, ``bin`` for bytes. ``unpackb`` reads every
form of those types and returns lists for arrays, as
``msgpack.unpackb(raw=False)`` does.
"""
from __future__ import annotations

import struct


def _head(out: bytearray, n: int, fix_base: int, fix_max: int,
          codes: tuple) -> None:
    """Length header: a fix form below `fix_max`, else the 8/16/32-bit
    code of `codes` (None where the type has no such form)."""
    if n < fix_max:
        out.append(fix_base | n)
        return
    for code, width, fmt in zip(codes, (0xFF, 0xFFFF, 0xFFFFFFFF),
                                ("B", ">H", ">I")):
        if code is not None and n <= width:
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"msgpack length {n} too large")


def _int(out: bytearray, v: int) -> None:
    if 0 <= v < 0x80:
        out.append(v)
    elif -32 <= v < 0:
        out.append(v & 0xFF)
    elif v >= 0:
        for code, fmt, top in ((0xCC, "B", 0xFF), (0xCD, ">H", 0xFFFF),
                               (0xCE, ">I", 0xFFFFFFFF),
                               (0xCF, ">Q", 0xFFFFFFFFFFFFFFFF)):
            if v <= top:
                out.append(code)
                out += struct.pack(fmt, v)
                return
        raise OverflowError(v)
    else:
        for code, fmt, low in ((0xD0, "b", -0x80), (0xD1, ">h", -0x8000),
                               (0xD2, ">i", -0x80000000),
                               (0xD3, ">q", -0x8000000000000000)):
            if v >= low:
                out.append(code)
                out += struct.pack(fmt, v)
                return
        raise OverflowError(v)


def _pack(out: bytearray, obj) -> None:
    if obj is None:
        out.append(0xC0)
    elif obj is True or obj is False:
        out.append(0xC3 if obj else 0xC2)
    elif isinstance(obj, int):
        _int(out, int(obj))
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        _head(out, len(raw), 0xA0, 32, (0xD9, 0xDA, 0xDB))
        out += raw
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        raw = bytes(obj)
        _head(out, len(raw), 0x00, 0, (0xC4, 0xC5, 0xC6))
        out += raw
    elif isinstance(obj, (list, tuple)):
        _head(out, len(obj), 0x90, 16, (None, 0xDC, 0xDD))
        for v in obj:
            _pack(out, v)
    elif isinstance(obj, dict):
        _head(out, len(obj), 0x80, 16, (None, 0xDE, 0xDF))
        for k, v in obj.items():
            _pack(out, k)
            _pack(out, v)
    else:
        raise TypeError(f"cannot msgpack {type(obj).__name__}")


def packb(obj, use_bin_type: bool = True) -> bytes:
    if not use_bin_type:
        raise ValueError("only use_bin_type=True is supported")
    out = bytearray()
    _pack(out, obj)
    return bytes(out)


_FIXED = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
          0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
_LEN = {0xD9: ("str", ">B"), 0xDA: ("str", ">H"), 0xDB: ("str", ">I"),
        0xC4: ("bin", ">B"), 0xC5: ("bin", ">H"), 0xC6: ("bin", ">I"),
        0xDC: ("arr", ">H"), 0xDD: ("arr", ">I"),
        0xDE: ("map", ">H"), 0xDF: ("map", ">I")}


def _unpack(buf: bytes, pos: int) -> tuple:
    b = buf[pos]
    pos += 1
    if b < 0x80:
        return b, pos
    if b >= 0xE0:
        return b - 0x100, pos
    if b == 0xC0:
        return None, pos
    if b in (0xC2, 0xC3):
        return b == 0xC3, pos
    if b in _FIXED:
        fmt = _FIXED[b]
        n = struct.calcsize(fmt)
        return struct.unpack_from(fmt, buf, pos)[0], pos + n
    if 0xA0 <= b < 0xC0:
        kind, n = "str", b & 0x1F
    elif 0x90 <= b < 0xA0:
        kind, n = "arr", b & 0x0F
    elif 0x80 <= b < 0x90:
        kind, n = "map", b & 0x0F
    elif b in _LEN:
        kind, fmt = _LEN[b]
        n = struct.unpack_from(fmt, buf, pos)[0]
        pos += struct.calcsize(fmt)
    else:
        raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")
    if kind == "str":
        return buf[pos:pos + n].decode("utf-8"), pos + n
    if kind == "bin":
        return bytes(buf[pos:pos + n]), pos + n
    if kind == "arr":
        out = []
        for _ in range(n):
            v, pos = _unpack(buf, pos)
            out.append(v)
        return out, pos
    out = {}
    for _ in range(n):
        k, pos = _unpack(buf, pos)
        v, pos = _unpack(buf, pos)
        out[k] = v
    return out, pos


def unpackb(blob: bytes, raw: bool = False):
    if raw:
        raise ValueError("only raw=False is supported")
    obj, pos = _unpack(blob, 0)
    if pos != len(blob):
        raise ValueError("extra bytes after msgpack object")
    return obj
