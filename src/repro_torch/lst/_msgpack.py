"""A small MessagePack codec for chunkfile headers and footers.

The reference frames the CHK2/CHK3 header and footer with the ``msgpack``
package, which the port does not depend on.  This codec covers the types
those maps hold and writes the bytes ``msgpack.packb`` writes with its
defaults (``use_bin_type=True``: ``str`` as str8/16/32, ``bytes`` as
bin8/16/32, every int in its smallest encoding, ``float`` as float64);
:func:`unpackb` reads them back as ``msgpack.unpackb(raw=False,
strict_map_key=False)`` does, arrays as lists.

Supported: nil, bool, int (-2**63 .. 2**64 - 1), float, str, bytes /
bytearray / memoryview, list / tuple, dict.  Anything else raises
``TypeError`` when packing (as ``msgpack`` does for numpy scalars that do
not subclass a Python type); ext types and timestamps raise ``ValueError``
when unpacking.
"""

from __future__ import annotations

import struct

__all__ = ["packb", "unpackb"]

_B = struct.Struct(">B")
_H = struct.Struct(">H")
_I = struct.Struct(">I")
_Q = struct.Struct(">Q")
_b = struct.Struct(">b")
_h = struct.Struct(">h")
_i = struct.Struct(">i")
_q = struct.Struct(">q")
_d = struct.Struct(">d")
_f = struct.Struct(">f")


def _pack_int(n: int, out: list) -> None:
    if n < -32:
        if n >= -0x80:
            out.append(b"\xd0" + _b.pack(n))
        elif n >= -0x8000:
            out.append(b"\xd1" + _h.pack(n))
        elif n >= -0x80000000:
            out.append(b"\xd2" + _i.pack(n))
        elif n >= -0x8000000000000000:
            out.append(b"\xd3" + _q.pack(n))
        else:
            raise OverflowError("int too big to convert")
    elif n < 0x80:
        out.append(_B.pack(n & 0xFF))            # positive / negative fixint
    elif n <= 0xFF:
        out.append(b"\xcc" + _B.pack(n))
    elif n <= 0xFFFF:
        out.append(b"\xcd" + _H.pack(n))
    elif n <= 0xFFFFFFFF:
        out.append(b"\xce" + _I.pack(n))
    elif n <= 0xFFFFFFFFFFFFFFFF:
        out.append(b"\xcf" + _Q.pack(n))
    else:
        raise OverflowError("int too big to convert")


def _pack_len(n: int, fix: int, fix_max: int, codes: bytes,
              out: list) -> None:
    """Length prefix: fix form below ``fix_max``, else 8-bit (``codes[0]``,
    when the family has one), 16-bit or 32-bit."""
    if n < fix_max:
        out.append(_B.pack(fix | n))
    elif len(codes) == 3 and n <= 0xFF:
        out.append(codes[0:1] + _B.pack(n))
    elif n <= 0xFFFF:
        out.append(codes[-2:-1] + _H.pack(n))
    elif n <= 0xFFFFFFFF:
        out.append(codes[-1:] + _I.pack(n))
    else:
        raise ValueError(f"object too large to pack: {n}")


def _pack(obj, out: list) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True:
        out.append(b"\xc3")
    elif obj is False:
        out.append(b"\xc2")
    elif isinstance(obj, int) and not isinstance(obj, bool):
        _pack_int(int(obj), out)
    elif isinstance(obj, float):
        out.append(b"\xcb" + _d.pack(obj))
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _pack_len(len(data), 0xA0, 32, b"\xd9\xda\xdb", out)
        out.append(data)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        data = bytes(obj)
        if len(data) <= 0xFF:
            out.append(b"\xc4" + _B.pack(len(data)))
        elif len(data) <= 0xFFFF:
            out.append(b"\xc5" + _H.pack(len(data)))
        elif len(data) <= 0xFFFFFFFF:
            out.append(b"\xc6" + _I.pack(len(data)))
        else:
            raise ValueError(f"bytes too large to pack: {len(data)}")
        out.append(data)
    elif isinstance(obj, (list, tuple)):
        _pack_len(len(obj), 0x90, 16, b"\xdc\xdd", out)
        for item in obj:
            _pack(item, out)
    elif isinstance(obj, dict):
        _pack_len(len(obj), 0x80, 16, b"\xde\xdf", out)
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"can not serialize {type(obj).__name__!r} object")


def packb(obj) -> bytes:
    """``obj`` -> MessagePack bytes, as ``msgpack.packb(obj)`` writes them."""
    out: list = []
    _pack(obj, out)
    return b"".join(out)


class _Reader:
    def __init__(self, data, strict_map_key: bool):
        self.data = memoryview(data)
        self.pos = 0
        self.strict_map_key = strict_map_key

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.data):
            raise ValueError("msgpack: truncated data")
        out = self.data[self.pos:end]
        self.pos = end
        return out

    def unpack(self, st: struct.Struct):
        return st.unpack(self.take(st.size))[0]


# fixed-size scalars, by type byte
_SCALARS = {0xCA: _f, 0xCB: _d, 0xCC: _B, 0xCD: _H, 0xCE: _I, 0xCF: _Q,
            0xD0: _b, 0xD1: _h, 0xD2: _i, 0xD3: _q}
# length-prefixed: type byte -> (length struct, kind)
_SIZED = {0xD9: (_B, "str"), 0xDA: (_H, "str"), 0xDB: (_I, "str"),
          0xC4: (_B, "bin"), 0xC5: (_H, "bin"), 0xC6: (_I, "bin"),
          0xDC: (_H, "array"), 0xDD: (_I, "array"),
          0xDE: (_H, "map"), 0xDF: (_I, "map")}


def _unpack(r: _Reader):
    code = r.unpack(_B)
    if code <= 0x7F:
        return code
    if code >= 0xE0:
        return code - 0x100
    if 0xA0 <= code <= 0xBF:
        return _sized(r, "str", code & 0x1F)
    if 0x90 <= code <= 0x9F:
        return _sized(r, "array", code & 0x0F)
    if 0x80 <= code <= 0x8F:
        return _sized(r, "map", code & 0x0F)
    if code == 0xC0:
        return None
    if code == 0xC2:
        return False
    if code == 0xC3:
        return True
    st = _SCALARS.get(code)
    if st is not None:
        return r.unpack(st)
    sized = _SIZED.get(code)
    if sized is not None:
        return _sized(r, sized[1], r.unpack(sized[0]))
    raise ValueError(f"msgpack: unsupported type byte 0x{code:02x}")


def _sized(r: _Reader, kind: str, n: int):
    if kind == "str":
        return str(r.take(n), "utf-8")
    if kind == "bin":
        return bytes(r.take(n))
    if kind == "array":
        return [_unpack(r) for _ in range(n)]
    out = {}
    for _ in range(n):
        k = _unpack(r)
        if r.strict_map_key and not isinstance(k, (str, bytes)):
            raise ValueError(f"msgpack: {type(k).__name__} is not allowed "
                             f"for a map key when strict_map_key=True")
        out[k] = _unpack(r)
    return out


def unpackb(data, *, strict_map_key: bool = True):
    """MessagePack bytes -> object, as ``msgpack.unpackb(data, raw=False,
    strict_map_key=...)`` reads them (map keys other than str / bytes raise
    unless ``strict_map_key=False``).  Trailing bytes raise."""
    r = _Reader(data, strict_map_key)
    obj = _unpack(r)
    if r.pos != len(r.data):
        raise ValueError("msgpack: extra data after the object")
    return obj
