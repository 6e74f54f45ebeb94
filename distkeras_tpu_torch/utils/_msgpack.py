"""The msgpack byte format, for the subset ``utils.serde`` writes.

The card's machine has no ``msgpack`` package, so the port carries its
own codec of the format.  ``packb(obj, default)`` writes exactly the
bytes ``msgpack.packb(obj, default=default, use_bin_type=True)`` writes
for these types, so blobs and checkpoints interoperate with the JAX
package both ways:

* ``None``, ``bool``;
* ``int`` in its smallest form: positive or negative fixint, uint8–64
  for positive values, int8–64 for negative ones;
* ``float`` as float64 (``float`` subclasses, such as ``np.float64``,
  included);
* ``str`` as fixstr / str8 / str16 / str32 of its UTF-8 bytes;
* ``bytes``, ``bytearray`` and ``memoryview`` as bin8 / bin16 / bin32;
* ``list`` and ``tuple`` as fixarray / array16 / array32;
* ``dict`` as fixmap / map16 / map32, in insertion order;
* anything else through ``default``, once per object (what it returns
  must be one of the above).

``unpackb(data, object_hook)`` reads all of these plus float32, returns
``str`` for strings (``raw=False``) and ``bytes`` for bin, accepts map
keys of any hashable type (``strict_map_key=False``) and calls
``object_hook`` on every decoded map.  Truncated input, bytes after the
object, ext types and the unused byte 0xc1 raise ``ValueError``.
"""

from __future__ import annotations

import struct
from typing import Any, Callable, List, Optional

_B = struct.Struct(">B")
_H = struct.Struct(">H")
_I = struct.Struct(">I")
_Q = struct.Struct(">Q")
_b = struct.Struct(">b")
_h = struct.Struct(">h")
_i = struct.Struct(">i")
_q = struct.Struct(">q")
_f = struct.Struct(">f")
_d = struct.Struct(">d")


def _pack_int(n: int, out: List[bytes]) -> bool:
    if 0 <= n < 0x80:
        out.append(_B.pack(n))
    elif -0x20 <= n < 0:
        out.append(_b.pack(n))
    elif 0 < n <= 0xFF:
        out.append(b"\xcc" + _B.pack(n))
    elif -0x80 <= n < 0:
        out.append(b"\xd0" + _b.pack(n))
    elif 0 < n <= 0xFFFF:
        out.append(b"\xcd" + _H.pack(n))
    elif -0x8000 <= n < 0:
        out.append(b"\xd1" + _h.pack(n))
    elif 0 < n <= 0xFFFFFFFF:
        out.append(b"\xce" + _I.pack(n))
    elif -0x80000000 <= n < 0:
        out.append(b"\xd2" + _i.pack(n))
    elif 0 < n <= 0xFFFFFFFFFFFFFFFF:
        out.append(b"\xcf" + _Q.pack(n))
    elif -0x8000000000000000 <= n < 0:
        out.append(b"\xd3" + _q.pack(n))
    else:
        return False
    return True


def _header(n: int, fix: Optional[int], fix_max: int, codes: bytes,
            what: str) -> bytes:
    """The length header of a str / bin / array / map of ``n`` entries:
    the fix form below ``fix_max`` where the type has one, else the 8-,
    16- or 32-bit form (``codes``; a 0 code means the type has no such
    form)."""
    if fix is not None and n < fix_max:
        return _B.pack(fix | n)
    c8, c16, c32 = codes
    if c8 and n <= 0xFF:
        return bytes((c8, n))
    if n <= 0xFFFF:
        return bytes((c16,)) + _H.pack(n)
    if n <= 0xFFFFFFFF:
        return bytes((c32,)) + _I.pack(n)
    raise ValueError(f"{what} of {n} entries is too large for msgpack")


def packb(obj: Any, default: Optional[Callable] = None) -> bytes:
    """``obj`` in msgpack's byte format (see the module docstring)."""
    out: List[bytes] = []

    def pack(o, default_used=False):
        if o is None:
            out.append(b"\xc0")
        elif o is True:
            out.append(b"\xc3")
        elif o is False:
            out.append(b"\xc2")
        elif isinstance(o, int) and not isinstance(o, bool):
            if not _pack_int(int(o), out):
                if default is None or default_used:
                    raise OverflowError("Integer value out of range")
                pack(default(o), True)
        elif isinstance(o, float):
            out.append(b"\xcb" + _d.pack(o))
        elif isinstance(o, (bytes, bytearray)):
            out.append(_header(len(o), None, 0, b"\xc4\xc5\xc6", "bin"))
            out.append(bytes(o))
        elif isinstance(o, str):
            data = o.encode("utf-8")
            out.append(_header(len(data), 0xA0, 32, b"\xd9\xda\xdb", "str"))
            out.append(data)
        elif isinstance(o, dict):
            out.append(_header(len(o), 0x80, 16, b"\x00\xde\xdf", "map"))
            for k, v in o.items():
                pack(k)
                pack(v)
        elif isinstance(o, (list, tuple)):
            out.append(_header(len(o), 0x90, 16, b"\x00\xdc\xdd", "array"))
            for v in o:
                pack(v)
        elif isinstance(o, memoryview):
            data = o.tobytes()
            out.append(_header(len(data), None, 0, b"\xc4\xc5\xc6", "bin"))
            out.append(data)
        elif default is not None and not default_used:
            pack(default(o), True)
        else:
            raise TypeError(f"can not serialize {type(o).__name__!r} "
                            f"object")

    pack(obj)
    return b"".join(out)


class _Reader:
    """A cursor over the input; every read checks the bytes are there."""

    __slots__ = ("data", "pos", "hook")

    def __init__(self, data, hook):
        self.data = memoryview(data).cast("B")
        self.pos = 0
        self.hook = hook

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.data):
            raise ValueError("msgpack data is truncated")
        chunk = self.data[self.pos:end]
        self.pos = end
        return chunk

    def num(self, st: struct.Struct):
        return st.unpack(self.take(st.size))[0]

    def read(self):
        code = self.num(_B)
        if code <= 0x7F:
            return code
        if code >= 0xE0:
            return code - 0x100
        if 0xA0 <= code <= 0xBF:
            return self._str(code & 0x1F)
        if 0x90 <= code <= 0x9F:
            return self._array(code & 0x0F)
        if 0x80 <= code <= 0x8F:
            return self._map(code & 0x0F)
        if code == 0xC0:
            return None
        if code == 0xC2:
            return False
        if code == 0xC3:
            return True
        if code in _BIN:
            return bytes(self.take(self.num(_BIN[code])))
        if code in _STR:
            return self._str(self.num(_STR[code]))
        if code in _ARRAY:
            return self._array(self.num(_ARRAY[code]))
        if code in _MAP:
            return self._map(self.num(_MAP[code]))
        if code in _NUM:
            return self.num(_NUM[code])
        if 0xC7 <= code <= 0xC9 or 0xD4 <= code <= 0xD8:
            raise ValueError(f"msgpack ext type (0x{code:02x}) is not "
                             f"supported")
        raise ValueError(f"invalid msgpack byte 0x{code:02x}")

    def _str(self, n: int) -> str:
        return str(self.take(n), "utf-8")

    def _array(self, n: int) -> list:
        return [self.read() for _ in range(n)]

    def _map(self, n: int):
        d = {}
        for _ in range(n):
            k = self.read()
            d[k] = self.read()
        return d if self.hook is None else self.hook(d)


_BIN = {0xC4: _B, 0xC5: _H, 0xC6: _I}
_STR = {0xD9: _B, 0xDA: _H, 0xDB: _I}
_ARRAY = {0xDC: _H, 0xDD: _I}
_MAP = {0xDE: _H, 0xDF: _I}
_NUM = {0xCA: _f, 0xCB: _d, 0xCC: _B, 0xCD: _H, 0xCE: _I, 0xCF: _Q,
        0xD0: _b, 0xD1: _h, 0xD2: _i, 0xD3: _q}


def unpackb(data, object_hook: Optional[Callable] = None) -> Any:
    """The one object ``data`` holds (see the module docstring)."""
    reader = _Reader(data, object_hook)
    obj = reader.read()
    if reader.pos != len(reader.data):
        raise ValueError(f"{len(reader.data) - reader.pos} bytes after the "
                         f"msgpack object")
    return obj
