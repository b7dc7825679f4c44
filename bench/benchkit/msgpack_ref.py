"""A plain MessagePack decoder (the formats a manifest uses: nil, bool,
integers, str, bin, array, map), written from the format's
specification for the reference. It shares no code with the program."""
from __future__ import annotations

import struct

_INTS = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
         0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
         0xCA: ">f", 0xCB: ">d"}
_SIZED = {0xC4: ("bin", ">B"), 0xC5: ("bin", ">H"), 0xC6: ("bin", ">I"),
          0xD9: ("str", ">B"), 0xDA: ("str", ">H"), 0xDB: ("str", ">I"),
          0xDC: ("arr", ">H"), 0xDD: ("arr", ">I"),
          0xDE: ("map", ">H"), 0xDF: ("map", ">I")}


def _read(buf: bytes, pos: int):
    b = buf[pos]
    pos += 1
    if b <= 0x7F:
        return b, pos
    if b >= 0xE0:
        return b - 0x100, pos
    if b == 0xC0:
        return None, pos
    if b in (0xC2, 0xC3):
        return b == 0xC3, pos
    if b in _INTS:
        fmt = _INTS[b]
        return struct.unpack_from(fmt, buf, pos)[0], pos + struct.calcsize(fmt)
    if 0x80 <= b <= 0x8F:
        kind, n = "map", b & 0x0F
    elif 0x90 <= b <= 0x9F:
        kind, n = "arr", b & 0x0F
    elif 0xA0 <= b <= 0xBF:
        kind, n = "str", b & 0x1F
    elif b in _SIZED:
        kind, fmt = _SIZED[b]
        n = struct.unpack_from(fmt, buf, pos)[0]
        pos += struct.calcsize(fmt)
    else:
        raise ValueError(f"msgpack type byte 0x{b:02x} is not one a "
                         "manifest uses")
    if kind == "str":
        return bytes(buf[pos:pos + n]).decode("utf-8"), pos + n
    if kind == "bin":
        return bytes(buf[pos:pos + n]), pos + n
    if kind == "arr":
        out = []
        for _ in range(n):
            v, pos = _read(buf, pos)
            out.append(v)
        return out, pos
    out = {}
    for _ in range(n):
        k, pos = _read(buf, pos)
        out[k], pos = _read(buf, pos)
    return out, pos


def unpack(blob: bytes):
    obj, pos = _read(blob, 0)
    if pos != len(blob):
        raise ValueError("bytes left after the msgpack object")
    return obj
