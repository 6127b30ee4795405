"""A msgpack codec in pure Python, with flax's extension types.

The port's counterpart of ``msgpack.packb``/``unpackb`` as
``flax.serialization`` calls them (``msgpack_serialize`` /
``msgpack_restore``): maps, arrays, str, bin, int, float, bool and nil,
encoded in the shortest form msgpack-python picks (``use_bin_type``;
floats as float64), so a blob decoded and encoded again gives the same
bytes. flax's extension types:

- code 1, ndarray: the ext data is itself a msgpack array
  ``(shape, dtype name, C-order bytes)``;
- code 2, native complex: ``(real, imag)``;
- code 3, numpy scalar: an ndarray of shape ``()``, decoded to its scalar.

Decoding a torn or truncated blob, or one with trailing bytes, raises
``ValueError``. Tuples encode as arrays and decode as lists; map keys
must be str or bytes (msgpack-python's ``strict_map_key``).
"""

from __future__ import annotations

import struct
from typing import Any, NamedTuple

import numpy as np

EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3


class ExtType(NamedTuple):
    """An extension value of a code the codec does not interpret."""

    code: int
    data: bytes


# ---------------------------------------------------------------------------
# encoder
# ---------------------------------------------------------------------------

def _ndarray_bytes(arr: np.ndarray) -> bytes:
    if arr.dtype.hasobject or arr.dtype.fields is not None:
        raise ValueError(f"cannot encode an array of dtype {arr.dtype}")
    return packb((tuple(int(s) for s in arr.shape), arr.dtype.name,
                  np.ascontiguousarray(arr).tobytes("C")))


def _pack_len(out, n, fix_tag, fix_max, tags):
    """Header of a sized value: a fix form for n <= fix_max (fix_tag | n),
    else the first of ``tags`` ((tag, struct code, max)) that holds n."""
    if fix_tag is not None and n <= fix_max:
        out.append(struct.pack("B", fix_tag | n))
        return
    for tag, code, top in tags:
        if n <= top:
            out.append(struct.pack(">B" + code, tag, n))
            return
    raise ValueError(f"value too large for msgpack ({n})")


_STR_TAGS = ((0xD9, "B", 0xFF), (0xDA, "H", 0xFFFF), (0xDB, "I", 0xFFFFFFFF))
_BIN_TAGS = ((0xC4, "B", 0xFF), (0xC5, "H", 0xFFFF), (0xC6, "I", 0xFFFFFFFF))
_ARR_TAGS = ((0xDC, "H", 0xFFFF), (0xDD, "I", 0xFFFFFFFF))
_MAP_TAGS = ((0xDE, "H", 0xFFFF), (0xDF, "I", 0xFFFFFFFF))
_FIXEXT = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}


def _pack_int(out, x):
    if 0 <= x < 0x80:
        out.append(struct.pack("B", x))
    elif -0x20 <= x < 0:
        out.append(struct.pack("b", x))
    elif 0x80 <= x <= 0xFF:
        out.append(struct.pack(">BB", 0xCC, x))
    elif -0x80 <= x < 0:
        out.append(struct.pack(">Bb", 0xD0, x))
    elif 0xFF < x <= 0xFFFF:
        out.append(struct.pack(">BH", 0xCD, x))
    elif -0x8000 <= x < -0x80:
        out.append(struct.pack(">Bh", 0xD1, x))
    elif 0xFFFF < x <= 0xFFFFFFFF:
        out.append(struct.pack(">BI", 0xCE, x))
    elif -0x80000000 <= x < -0x8000:
        out.append(struct.pack(">Bi", 0xD2, x))
    elif 0xFFFFFFFF < x <= 0xFFFFFFFFFFFFFFFF:
        out.append(struct.pack(">BQ", 0xCF, x))
    elif -0x8000000000000000 <= x < -0x80000000:
        out.append(struct.pack(">Bq", 0xD3, x))
    else:
        raise ValueError(f"integer out of msgpack's range: {x}")


def _pack_ext(out, code, data):
    n = len(data)
    if n in _FIXEXT:
        out.append(struct.pack(">Bb", _FIXEXT[n], code))
    elif n <= 0xFF:
        out.append(struct.pack(">BBb", 0xC7, n, code))
    elif n <= 0xFFFF:
        out.append(struct.pack(">BHb", 0xC8, n, code))
    else:
        out.append(struct.pack(">BIb", 0xC9, n, code))
    out.append(data)


def _pack(out, x):
    # numpy values first: np.float64 is a float and np.bool_ is no bool,
    # and flax encodes every numpy value as an extension
    if isinstance(x, np.ndarray):
        _pack_ext(out, EXT_NDARRAY, _ndarray_bytes(x))
    elif isinstance(x, np.generic):
        _pack_ext(out, EXT_NPSCALAR, _ndarray_bytes(np.asarray(x)))
    elif x is None:
        out.append(b"\xc0")
    elif x is True:
        out.append(b"\xc3")
    elif x is False:
        out.append(b"\xc2")
    elif isinstance(x, int):
        _pack_int(out, x)
    elif isinstance(x, float):
        out.append(struct.pack(">Bd", 0xCB, x))
    elif isinstance(x, complex):
        _pack_ext(out, EXT_COMPLEX, packb((x.real, x.imag)))
    elif isinstance(x, str):
        raw = x.encode("utf-8")
        _pack_len(out, len(raw), 0xA0, 0x1F, _STR_TAGS)
        out.append(raw)
    elif isinstance(x, (bytes, bytearray, memoryview)):
        raw = bytes(x)
        _pack_len(out, len(raw), None, -1, _BIN_TAGS)
        out.append(raw)
    elif isinstance(x, ExtType):
        _pack_ext(out, x.code, x.data)
    elif isinstance(x, (list, tuple)):
        _pack_len(out, len(x), 0x90, 0x0F, _ARR_TAGS)
        for v in x:
            _pack(out, v)
    elif isinstance(x, dict):
        _pack_len(out, len(x), 0x80, 0x0F, _MAP_TAGS)
        for k, v in x.items():
            _pack(out, k)
            _pack(out, v)
    else:
        raise TypeError(f"cannot encode {type(x).__name__} as msgpack")


def packb(obj: Any) -> bytes:
    """Encode ``obj`` (nested dicts, lists, tuples, scalars, numpy arrays
    and scalars) as flax's ``msgpack_serialize`` does."""
    out = []
    _pack(out, obj)
    return b"".join(out)


# ---------------------------------------------------------------------------
# decoder
# ---------------------------------------------------------------------------

class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> bytes:
        end = self.pos + n
        if end > len(self.data):
            raise ValueError(f"msgpack blob truncated at byte {self.pos} "
                             f"(needs {n} more, has "
                             f"{len(self.data) - self.pos})")
        raw = self.data[self.pos:end].tobytes()
        self.pos = end
        return raw

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]


def _decode_ext(code: int, data: bytes):
    if code in (EXT_NDARRAY, EXT_NPSCALAR):
        shape, dtype, raw = unpackb(data)
        if dtype == "bfloat16":
            raise ValueError("bfloat16 arrays are not supported: numpy has "
                             "no bfloat16")
        arr = np.frombuffer(raw, dtype=np.dtype(dtype)).reshape(
            tuple(shape)).copy()
        return arr[()] if code == EXT_NPSCALAR else arr
    if code == EXT_COMPLEX:
        re, im = unpackb(data)
        return complex(re, im)
    return ExtType(code, data)


_FIXED = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
          0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
_SIZED = {0xC4: ("bin", ">B"), 0xC5: ("bin", ">H"), 0xC6: ("bin", ">I"),
          0xD9: ("str", ">B"), 0xDA: ("str", ">H"), 0xDB: ("str", ">I"),
          0xDC: ("arr", ">H"), 0xDD: ("arr", ">I"),
          0xDE: ("map", ">H"), 0xDF: ("map", ">I"),
          0xC7: ("ext", ">B"), 0xC8: ("ext", ">H"), 0xC9: ("ext", ">I")}
_FIXEXT_LEN = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}


def _read_sized(r: _Reader, kind: str, n: int):
    if kind == "bin":
        return r.take(n)
    if kind == "str":
        return r.take(n).decode("utf-8")
    if kind == "arr":
        return [_read(r) for _ in range(n)]
    if kind == "map":
        out = {}
        for _ in range(n):
            k = _read(r)
            if not isinstance(k, (str, bytes)):
                raise ValueError(f"map key of type {type(k).__name__}")
            out[k] = _read(r)
        return out
    code = r.unpack(">b")
    return _decode_ext(code, r.take(n))


def _read(r: _Reader):
    b = r.unpack(">B")
    if b <= 0x7F:
        return b
    if b >= 0xE0:
        return b - 0x100
    if 0x80 <= b <= 0x8F:
        return _read_sized(r, "map", b & 0x0F)
    if 0x90 <= b <= 0x9F:
        return _read_sized(r, "arr", b & 0x0F)
    if 0xA0 <= b <= 0xBF:
        return _read_sized(r, "str", b & 0x1F)
    if b == 0xC0:
        return None
    if b == 0xC2:
        return False
    if b == 0xC3:
        return True
    if b in _FIXED:
        return r.unpack(_FIXED[b])
    if b in _SIZED:
        kind, fmt = _SIZED[b]
        return _read_sized(r, kind, r.unpack(fmt))
    if b in _FIXEXT_LEN:
        return _read_sized(r, "ext", _FIXEXT_LEN[b])
    raise ValueError(f"invalid msgpack type byte 0x{b:02x} at byte "
                     f"{r.pos - 1}")


def unpackb(data: bytes) -> Any:
    """Decode one msgpack value that spans all of ``data``."""
    r = _Reader(data)
    out = _read(r)
    if r.pos != len(r.data):
        raise ValueError(f"msgpack blob has {len(r.data) - r.pos} bytes "
                         f"after its value")
    return out
