"""A minimal msgpack encoder for flax's ``serialization.to_bytes`` format.

``params.msgpack`` of a checkpoint is a msgpack map of str keys (nested
maps for submodules), whose array leaves are ``ExtType(1, packb((shape,
dtype name, C-order bytes)))`` and numpy scalars ``ExtType(3, ...)`` of the
same payload, as flax writes them. This module writes that format with no
flax and no msgpack package: ``packb`` encodes None, bool, int, float
(64-bit), str, bytes, lists and tuples, dicts, numpy arrays and scalars,
each in msgpack's shortest form. flax splits arrays of more than 2**30
bytes into chunks; no checkpoint of the port comes near that, and such an
array raises here.
"""
from __future__ import annotations

import struct
from typing import Any

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
