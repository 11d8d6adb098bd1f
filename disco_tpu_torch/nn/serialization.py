"""The msgpack subset that ``flax.serialization.to_bytes`` writes, encoded
and decoded in pure Python (the card has neither ``msgpack`` nor ``flax``;
no counterpart in ``disco_tpu``, which calls flax's own).

A flax checkpoint is one msgpack value: maps with str keys whose leaves
are str, bin, int, float, bool, nil, and numpy arrays.  An array is the
extension type 1 whose payload is itself msgpack: the array
``(shape, dtype name, C-order bytes)``.  Type 3 is a numpy scalar in the
same payload, type 2 a Python complex as ``(real, imag)``.  Arrays above
2**30 bytes are split by flax into a map
``{"__msgpack_chunked_array__": True, "shape": {...}, "chunks": {...}}``;
the decoder joins them back.

:func:`packb` writes what ``msgpack.packb(tree, default=flax's ext packer,
strict_types=True)`` writes for the same tree, byte for byte (the smallest
encoding of each int, floats as float64, str as str and bytes as bin), so
a checkpoint written by the port is the file the JAX package would write
for the same arrays.  :func:`unpackb` reads any msgpack value and returns
nested dicts and lists with numpy arrays at the leaves.
"""
from __future__ import annotations

import struct

import numpy as np

EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3
_CHUNKED = "__msgpack_chunked_array__"


class DecodeError(ValueError):
    """The bytes are not a complete msgpack value of the supported subset."""


# -------------------------------------------------------------------- encoder
def _pack_int(v: int, out: bytearray) -> None:
    if 0 <= v < 0x80:
        out.append(v)
    elif -32 <= v < 0:
        out.append(v & 0xFF)
    elif v >= 0:
        for code, fmt, top in ((0xCC, ">B", 0xFF), (0xCD, ">H", 0xFFFF),
                               (0xCE, ">I", 0xFFFFFFFF), (0xCF, ">Q", 0xFFFFFFFFFFFFFFFF)):
            if v <= top:
                out.append(code)
                out += struct.pack(fmt, v)
                return
        raise OverflowError(f"int {v} does not fit msgpack")
    else:
        for code, fmt, low in ((0xD0, ">b", -0x80), (0xD1, ">h", -0x8000),
                               (0xD2, ">i", -0x80000000), (0xD3, ">q", -0x8000000000000000)):
            if v >= low:
                out.append(code)
                out += struct.pack(fmt, v)
                return
        raise OverflowError(f"int {v} does not fit msgpack")


def _pack_len(n: int, fix_base: int | None, fix_max: int, codes: tuple, out: bytearray) -> None:
    """A str/bin/array/map/ext length header: the fix form where it exists,
    else the 8-, 16- or 32-bit form (``codes``; None where a form is
    missing)."""
    if fix_base is not None and n <= fix_max:
        out.append(fix_base | n)
        return
    for code, fmt, top in zip(codes, (">B", ">H", ">I"), (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if code is not None and n <= top:
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise OverflowError(f"length {n} does not fit msgpack")


def _pack_ext(code: int, data: bytes, out: bytearray) -> None:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if len(data) in fixed:
        out.append(fixed[len(data)])
    else:
        _pack_len(len(data), None, -1, (0xC7, 0xC8, 0xC9), out)
    out += struct.pack(">b", code)
    out += data


def _array_payload(a: np.ndarray) -> bytes:
    if a.dtype.hasobject or a.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes cannot be serialized")
    return packb((tuple(a.shape), a.dtype.name, a.tobytes("C")))


def _pack(v, out: bytearray) -> None:
    if v is None:
        out.append(0xC0)
    elif v is True:
        out.append(0xC3)
    elif v is False:
        out.append(0xC2)
    elif type(v) is int:
        _pack_int(v, out)
    elif type(v) is float:
        out.append(0xCB)
        out += struct.pack(">d", v)
    elif type(v) is str:
        b = v.encode("utf-8")
        _pack_len(len(b), 0xA0, 31, (0xD9, 0xDA, 0xDB), out)
        out += b
    elif type(v) in (bytes, bytearray, memoryview):
        b = bytes(v)
        _pack_len(len(b), None, -1, (0xC4, 0xC5, 0xC6), out)
        out += b
    elif type(v) in (list, tuple):
        _pack_len(len(v), 0x90, 15, (None, 0xDC, 0xDD), out)
        for e in v:
            _pack(e, out)
    elif type(v) is dict:
        _pack_len(len(v), 0x80, 15, (None, 0xDE, 0xDF), out)
        for k, e in v.items():
            _pack(k, out)
            _pack(e, out)
    elif isinstance(v, np.ndarray):
        _pack_ext(EXT_NDARRAY, _array_payload(v), out)
    elif isinstance(v, np.generic):
        _pack_ext(EXT_NPSCALAR, _array_payload(np.asarray(v)), out)
    elif type(v) is complex:
        _pack_ext(EXT_COMPLEX, packb((v.real, v.imag)), out)
    else:
        raise TypeError(f"cannot serialize {type(v).__name__}")


def packb(tree) -> bytes:
    """``tree`` (nested dicts with str keys, lists/tuples, numpy arrays and
    scalars, str, bytes, int, float, bool, None) as msgpack bytes in
    flax's encoding.  Arrays above 2**30 bytes are not split: flax would
    chunk them, and no checkpoint of this package comes near that size."""
    out = bytearray()
    _pack(tree, out)
    return bytes(out)


# -------------------------------------------------------------------- decoder
class _Reader:
    __slots__ = ("buf", "pos")

    def __init__(self, buf: bytes):
        self.buf, self.pos = memoryview(buf), 0

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.buf):
            raise DecodeError(f"truncated: {n} bytes wanted at offset {self.pos}, "
                              f"{len(self.buf) - self.pos} left")
        chunk = self.buf[self.pos:end]
        self.pos = end
        return chunk

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]


def _dtype(name: str) -> np.dtype:
    if name == "bfloat16":
        raise DecodeError("bfloat16 arrays are not supported (numpy has no bfloat16)")
    try:
        return np.dtype(name)
    except TypeError as e:
        raise DecodeError(f"unknown dtype {name!r}") from e


def _array_from_payload(data: bytes) -> np.ndarray:
    shape, name, raw = unpackb(data, raw=True)
    name = name.decode() if isinstance(name, (bytes, bytearray)) else name
    return np.frombuffer(bytes(raw), dtype=_dtype(name)).reshape(tuple(shape), order="C").copy()


def _ext(code: int, data: bytes):
    if code == EXT_NDARRAY:
        return _array_from_payload(data)
    if code == EXT_NPSCALAR:
        return _array_from_payload(data)[()]
    if code == EXT_COMPLEX:
        re, im = unpackb(data)
        return complex(re, im)
    raise DecodeError(f"unknown msgpack extension type {code}")


def _read(r: _Reader, raw: bool):
    b = r.unpack(">B")
    if b <= 0x7F:
        return b
    if b >= 0xE0:
        return b - 0x100
    if 0x80 <= b <= 0x8F:
        return _read_map(r, b & 0x0F, raw)
    if 0x90 <= b <= 0x9F:
        return [_read(r, raw) for _ in range(b & 0x0F)]
    if 0xA0 <= b <= 0xBF:
        return _str(r.take(b & 0x1F), raw)
    if b == 0xC0:
        return None
    if b in (0xC2, 0xC3):
        return b == 0xC3
    simple = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
              0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
    if b in simple:
        return r.unpack(simple[b])
    lens = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I", 0xD9: ">B", 0xDA: ">H", 0xDB: ">I",
            0xDC: ">H", 0xDD: ">I", 0xDE: ">H", 0xDF: ">I", 0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}
    if b in lens:
        n = r.unpack(lens[b])
        if b in (0xC4, 0xC5, 0xC6):
            return bytes(r.take(n))
        if b in (0xD9, 0xDA, 0xDB):
            return _str(r.take(n), raw)
        if b in (0xDC, 0xDD):
            return [_read(r, raw) for _ in range(n)]
        if b in (0xDE, 0xDF):
            return _read_map(r, n, raw)
        code = r.unpack(">b")
        return _ext(code, bytes(r.take(n)))
    fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
    if b in fixext:
        code = r.unpack(">b")
        return _ext(code, bytes(r.take(fixext[b])))
    raise DecodeError(f"unsupported msgpack byte 0x{b:02x} at offset {r.pos - 1}")


def _str(chunk: memoryview, raw: bool):
    if raw:
        return bytes(chunk)
    try:
        return bytes(chunk).decode("utf-8")
    except UnicodeDecodeError as e:
        raise DecodeError(f"invalid utf-8 string: {e}") from e


def _read_map(r: _Reader, n: int, raw: bool) -> dict:
    out = {}
    for _ in range(n):
        key = _read(r, raw)
        out[key] = _read(r, raw)
    return out


def _unchunk(tree):
    if isinstance(tree, dict):
        if tree.get(_CHUNKED) is True:
            shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
            chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def unpackb(data: bytes, raw: bool = False):
    """One msgpack value from ``data`` (all of it: trailing bytes raise);
    maps become dicts, arrays lists, extension types 1-3 numpy arrays,
    numpy scalars and complex numbers, and flax's chunked arrays are joined.
    ``raw``: str values as bytes (the array payload's dtype name).  Raises
    :class:`DecodeError` on truncated or malformed input."""
    r = _Reader(data)
    value = _read(r, raw)
    if r.pos != len(r.buf):
        raise DecodeError(f"{len(r.buf) - r.pos} trailing bytes after the msgpack value")
    return value if raw else _unchunk(value)
