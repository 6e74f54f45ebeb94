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


#: the one-byte encodings of the ints -32..127 (fixints)
_FIXINT = {n: _b.pack(n) if n < 0 else _B.pack(n) for n in range(-32, 128)}
_D_TAG = b"\xcb"
_TAGGED_D = struct.Struct(">Bd")


def packb(obj: Any, default: Optional[Callable] = None) -> bytes:
    """``obj`` in msgpack's byte format (see the module docstring).

    Written for speed in pure Python (every wire message of the port
    goes through it): the exact types of the common leaves (``float``,
    small ``int``, ``str``, ``dict``, ``list``) take a direct path, and
    everything else the general one."""
    out: List[bytes] = []
    append = out.append
    pack_d = _d.pack
    fixint = _FIXINT

    def pack(o, default_used=False):
        t = type(o)
        if t is float:
            append(_D_TAG + pack_d(o))
        elif t is int and -32 <= o < 128:
            append(fixint[o])
        elif t is str:
            data = o.encode("utf-8")
            n = len(data)
            append(_B.pack(0xA0 | n) if n < 32 else
                   _header(n, 0xA0, 32, b"\xd9\xda\xdb", "str"))
            append(data)
        elif t is dict:
            n = len(o)
            append(_B.pack(0x80 | n) if n < 16 else
                   _header(n, 0x80, 16, b"\x00\xde\xdf", "map"))
            for k, v in o.items():
                pack(k)
                pack(v)
        elif t is list or t is tuple:
            n = len(o)
            append(_B.pack(0x90 | n) if n < 16 else
                   _header(n, 0x90, 16, b"\x00\xdc\xdd", "array"))
            # a run of floats (histogram bounds) in one C-level pass
            if n > 2 and type(o[0]) is float and \
                    all(type(v) is float for v in o):
                append(b"".join([_TAGGED_D.pack(0xCB, v) for v in o]))
            else:
                for v in o:
                    pack(v)
        elif o is None:
            append(b"\xc0")
        elif o is True:
            append(b"\xc3")
        elif o is False:
            append(b"\xc2")
        elif isinstance(o, int):
            if not _pack_int(int(o), out):
                if default is None or default_used:
                    raise OverflowError("Integer value out of range")
                pack(default(o), True)
        elif isinstance(o, float):
            append(_D_TAG + pack_d(o))
        elif isinstance(o, (bytes, bytearray)):
            append(_header(len(o), None, 0, b"\xc4\xc5\xc6", "bin"))
            append(bytes(o))
        elif isinstance(o, str):
            pack(str(o))
        elif isinstance(o, dict):
            pack(dict(o))
        elif isinstance(o, (list, tuple)):
            pack(list(o))
        elif isinstance(o, memoryview):
            data = o.tobytes()
            append(_header(len(data), None, 0, b"\xc4\xc5\xc6", "bin"))
            append(data)
        elif default is not None and not default_used:
            pack(default(o), True)
        else:
            raise TypeError(f"can not serialize {type(o).__name__!r} "
                            f"object")

    pack(obj)
    return b"".join(out)


_BIN = {0xC4: _B, 0xC5: _H, 0xC6: _I}
_STR = {0xD9: _B, 0xDA: _H, 0xDB: _I}
_ARRAY = {0xDC: _H, 0xDD: _I}
_MAP = {0xDE: _H, 0xDF: _I}
_NUM = {0xCA: _f, 0xCB: _d, 0xCC: _B, 0xCD: _H, 0xCE: _I, 0xCF: _Q,
        0xD0: _b, 0xD1: _h, 0xD2: _i, 0xD3: _q}
_TRUNCATED = "msgpack data is truncated"


def _reader(data, hook):
    """``read(pos) -> (object, next pos)`` over ``data``; every read
    checks the bytes are there."""
    mv = memoryview(data).cast("B")
    size = len(mv)
    d_unpack = _d.unpack_from

    def length(st, pos):
        end = pos + st.size
        if end > size:
            raise ValueError(_TRUNCATED)
        return st.unpack_from(mv, pos)[0], end

    def chunk(pos, n):
        end = pos + n
        if end > size:
            raise ValueError(_TRUNCATED)
        return mv[pos:end], end

    def read(pos):
        if pos >= size:
            raise ValueError(_TRUNCATED)
        code = mv[pos]
        pos += 1
        if code <= 0x7F:
            return code, pos
        if code >= 0xE0:
            return code - 0x100, pos
        if code == 0xCB:
            if pos + 8 > size:
                raise ValueError(_TRUNCATED)
            return d_unpack(mv, pos)[0], pos + 8
        kind = code & 0xF0
        if kind == 0x80:
            return read_map(code & 0x0F, pos)
        if kind == 0x90:
            return read_array(code & 0x0F, pos)
        if 0xA0 <= code <= 0xBF:
            raw, pos = chunk(pos, code & 0x1F)
            return str(raw, "utf-8"), pos
        if code == 0xC0:
            return None, pos
        if code == 0xC2:
            return False, pos
        if code == 0xC3:
            return True, pos
        if code in _BIN:
            n, pos = length(_BIN[code], pos)
            raw, pos = chunk(pos, n)
            return bytes(raw), pos
        if code in _STR:
            n, pos = length(_STR[code], pos)
            raw, pos = chunk(pos, n)
            return str(raw, "utf-8"), pos
        if code in _ARRAY:
            n, pos = length(_ARRAY[code], pos)
            return read_array(n, pos)
        if code in _MAP:
            n, pos = length(_MAP[code], pos)
            return read_map(n, pos)
        if code in _NUM:
            return length(_NUM[code], pos)
        if 0xC7 <= code <= 0xC9 or 0xD4 <= code <= 0xD8:
            raise ValueError(f"msgpack ext type (0x{code:02x}) is not "
                             f"supported")
        raise ValueError(f"invalid msgpack byte 0x{code:02x}")

    def read_array(n, pos):
        if n > 2:
            # an array of positive fixints, or of float64s, in one call
            end = pos + n
            if end <= size and max(mv[pos:end]) < 0x80:
                return list(mv[pos:end]), end
            end = pos + 9 * n
            if end <= size and mv[pos:end:9] == _D_TAG * n:
                return list(struct.unpack_from(">" + "xd" * n, mv, pos)), \
                    end
        items = []
        append = items.append
        for _ in range(n):
            v, pos = read(pos)
            append(v)
        return items, pos

    def read_map(n, pos):
        d = {}
        for _ in range(n):
            k, pos = read(pos)
            d[k], pos = read(pos)
        return (d if hook is None else hook(d)), pos

    return read, size


def unpackb(data, object_hook: Optional[Callable] = None) -> Any:
    """The one object ``data`` holds (see the module docstring)."""
    read, size = _reader(data, object_hook)
    obj, pos = read(0)
    if pos != size:
        raise ValueError(f"{size - pos} bytes after the msgpack object")
    return obj
