"""A minimal msgpack encoder and decoder for flax's ``serialization.to_bytes`` format.

``params.msgpack`` of a checkpoint is a msgpack map of str keys (nested
maps for submodules), whose array leaves are ``ExtType(1, packb((shape,
dtype name, C-order bytes)))`` and numpy scalars ``ExtType(3, ...)`` of the
same payload, as flax writes them. This module writes that format with no
flax and no msgpack package: ``packb`` encodes None, bool, int, float
(64-bit), str, bytes, lists and tuples, dicts, numpy arrays and scalars,
each in msgpack's shortest form. ``unpackb`` reads the format back, as
flax's ``msgpack_restore`` does: maps, strings, binary data, arrays, ints,
floats, bools and nil, with the array and numpy-scalar extension types
turned into numpy values. flax splits arrays of more than 2**30 bytes into
chunks; no checkpoint of the port comes near that, and such an array raises
here, both ways. ``restore`` shapes a decoded tree by a template, as
``flax.serialization.from_bytes`` does.
"""
from __future__ import annotations

import struct
from typing import Any, Mapping

import numpy as np

EXT_NDARRAY = 1
EXT_NPSCALAR = 3
MAX_ARRAY_BYTES = 2**30


def _sized(out: bytearray, n: int, fix: int | None, fix_max: int, codes: tuple) -> None:
    """A length header: the fix form below ``fix_max``, else the 8/16/32-bit
    form of ``codes`` (None where msgpack has no 8-bit form)."""
    if fix is not None and n < fix_max:
        out.append(fix | n)
    elif codes[0] is not None and n < 2**8:
        out += struct.pack(">BB", codes[0], n)
    elif n < 2**16:
        out += struct.pack(">BH", codes[1], n)
    elif n < 2**32:
        out += struct.pack(">BI", codes[2], n)
    else:
        raise ValueError(f"msgpack object too long: {n}")


def _int(out: bytearray, v: int) -> None:
    if 0 <= v < 128:
        out.append(v)
    elif -32 <= v < 0:
        out += struct.pack(">b", v)
    elif v >= 0:
        for code, fmt, lim in ((0xCC, ">BB", 2**8), (0xCD, ">BH", 2**16),
                               (0xCE, ">BI", 2**32), (0xCF, ">BQ", 2**64)):
            if v < lim:
                out += struct.pack(fmt, code, v)
                return
        raise OverflowError(v)
    else:
        for code, fmt, lim in ((0xD0, ">Bb", 2**7), (0xD1, ">Bh", 2**15),
                               (0xD2, ">Bi", 2**31), (0xD3, ">Bq", 2**63)):
            if v >= -lim:
                out += struct.pack(fmt, code, v)
                return
        raise OverflowError(v)


def _ext(out: bytearray, code: int, data: bytes) -> None:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if len(data) in fixed:
        out.append(fixed[len(data)])
    else:
        _sized(out, len(data), None, 0, (0xC7, 0xC8, 0xC9))
    out.append(code)
    out += data


def _array_payload(arr: np.ndarray) -> bytes:
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes cannot be serialized")
    if arr.nbytes > MAX_ARRAY_BYTES:
        raise ValueError(f"array of {arr.nbytes} bytes exceeds the unchunked limit")
    return packb((tuple(int(d) for d in arr.shape), arr.dtype.name, arr.tobytes("C")))


def _pack(out: bytearray, obj: Any) -> None:
    if obj is None:
        out.append(0xC0)
    elif obj is True or obj is False:
        out.append(0xC3 if obj else 0xC2)
    elif isinstance(obj, np.ndarray):
        _ext(out, EXT_NDARRAY, _array_payload(obj))
    elif isinstance(obj, np.generic):
        _ext(out, EXT_NPSCALAR, _array_payload(np.asarray(obj)))
    elif isinstance(obj, int):
        _int(out, obj)
    elif isinstance(obj, float):
        out += struct.pack(">Bd", 0xCB, obj)
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _sized(out, len(data), 0xA0, 32, (0xD9, 0xDA, 0xDB))
        out += data
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        data = bytes(obj)
        _sized(out, len(data), None, 0, (0xC4, 0xC5, 0xC6))
        out += data
    elif isinstance(obj, (list, tuple)):
        _sized(out, len(obj), 0x90, 16, (None, 0xDC, 0xDD))
        for v in obj:
            _pack(out, v)
    elif isinstance(obj, dict):
        _sized(out, len(obj), 0x80, 16, (None, 0xDE, 0xDF))
        for k, v in obj.items():
            _pack(out, k)
            _pack(out, v)
    else:
        raise TypeError(f"cannot msgpack-encode {type(obj).__name__}")


def packb(obj: Any) -> bytes:
    """``obj`` as msgpack bytes (binary data as bin, strings as str); for a
    tree of dicts with str keys and numpy leaves, the bytes of flax's
    ``serialization.to_bytes``."""
    out = bytearray()
    _pack(out, obj)
    return bytes(out)


# flax's marker of an array split into chunks (serialization._CHUNK_KEY)
CHUNKED_ARRAY_KEY = "__msgpack_chunked_array__"


def _array_from_payload(data: bytes) -> np.ndarray:
    shape, dtype, raw = unpackb(data)
    try:
        dt = np.dtype(dtype)
    except TypeError as exc:
        raise ValueError(f"unsupported array dtype {dtype!r}") from exc
    return np.frombuffer(raw, dtype=dt).reshape(shape).copy()


# type byte -> value, struct format of a number, size of a fixext, or
# (length format, kind) of a sized object
_CONSTANTS = {0xC0: None, 0xC2: False, 0xC3: True}
_NUMBERS = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
            0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
_SIZED = {
    0xC4: (">B", "bin"), 0xC5: (">H", "bin"), 0xC6: (">I", "bin"),
    0xC7: (">B", "ext"), 0xC8: (">H", "ext"), 0xC9: (">I", "ext"),
    0xD9: (">B", "str"), 0xDA: (">H", "str"), 0xDB: (">I", "str"),
    0xDC: (">H", "array"), 0xDD: (">I", "array"),
    0xDE: (">H", "map"), 0xDF: (">I", "map"),
}


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos : self.pos + n].tobytes()
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def ext(self, n: int):
        code = self.unpack(">b")
        data = self.take(n)
        if code == EXT_NDARRAY:
            return _array_from_payload(data)
        if code == EXT_NPSCALAR:
            return _array_from_payload(data)[()]
        raise ValueError(f"unsupported msgpack extension type {code}")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        if CHUNKED_ARRAY_KEY in out:
            raise ValueError("arrays split into chunks (over 2**30 bytes) are not supported")
        return out

    def read(self) -> Any:
        b = self.unpack(">B")
        if b <= 0x7F or b >= 0xE0:  # positive and negative fixint
            return b if b <= 0x7F else b - 0x100
        if b <= 0x8F:
            return self.map(b & 0x0F)
        if b <= 0x9F:
            return [self.read() for _ in range(b & 0x0F)]
        if b <= 0xBF:
            return self.take(b & 0x1F).decode("utf-8")
        if b in _CONSTANTS:
            return _CONSTANTS[b]
        if b in _NUMBERS:
            return self.unpack(_NUMBERS[b])
        if b in _FIXEXT:
            return self.ext(_FIXEXT[b])
        if b not in _SIZED:
            raise ValueError(f"invalid msgpack type byte 0x{b:02x}")
        fmt, kind = _SIZED[b]
        n = self.unpack(fmt)
        if kind == "bin":
            return self.take(n)
        if kind == "str":
            return self.take(n).decode("utf-8")
        if kind == "ext":
            return self.ext(n)
        if kind == "array":
            return [self.read() for _ in range(n)]
        return self.map(n)


def unpackb(data: bytes) -> Any:
    """The object of msgpack bytes: maps as dicts, arrays as lists, strings
    as str, binary data as bytes; flax's array and numpy-scalar extension
    types as numpy arrays and scalars (what ``flax.serialization.
    msgpack_restore`` returns for the bytes of ``to_bytes``)."""
    reader = _Reader(data)
    out = reader.read()
    if reader.pos != len(reader.data):
        raise ValueError(f"{len(reader.data) - reader.pos} trailing bytes after the msgpack object")
    return out


def restore(template: Any, state: Any) -> Any:
    """``state`` shaped by ``template`` as ``flax.serialization.from_bytes``
    restores it: every key of a template dict must be in the state (extra
    keys are dropped), else ``ValueError``; leaves come from the state."""
    if not isinstance(template, Mapping):
        return state
    if not isinstance(state, Mapping):
        raise ValueError(f"expected a dict of keys {sorted(template)}, got {type(state).__name__}")
    missing = set(map(str, template)) - set(state)
    if missing:
        raise ValueError(f"the checkpoint lacks the keys {sorted(missing)}")
    return {k: restore(v, state[str(k)]) for k, v in template.items()}


def leaf_shapes(tree: Any) -> Any:
    """The tree of leaf shapes of a nested dict of arrays."""
    if isinstance(tree, Mapping):
        return {k: leaf_shapes(v) for k, v in tree.items()}
    return tuple(np.shape(tree))
