"""A reader for the msgpack files ``flax.serialization.msgpack_serialize``
writes (the JAX package's ``best_model.msgpack`` checkpoints), with no
flax and no ``msgpack`` package.

It decodes the msgpack types such a file holds: maps, arrays, str, bin,
ints, floats, bools and nil, and flax's ext types 1 (an ndarray as the
msgpack array ``(shape, dtype name, C-order bytes)``) and 3 (a numpy
scalar, the same record of shape ``()``).  Arrays come back as CPU torch
tensors of their own dtype (``bfloat16`` included, which numpy lacks),
scalars as Python numbers.  flax splits an array of more than 2**30 bytes
into chunks; such a file is refused with a clear error.
"""

from __future__ import annotations

import struct
from typing import Any

import numpy as np
import torch

_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3
_CHUNKED = "__msgpack_chunked_array__"

_DTYPES = {"float32": torch.float32, "float64": torch.float64,
           "float16": torch.float16, "bfloat16": torch.bfloat16,
           "int8": torch.int8, "int16": torch.int16, "int32": torch.int32,
           "int64": torch.int64, "uint8": torch.uint8, "bool": torch.bool}
# numpy dtypes of the same width, to read the bytes (bfloat16 as int16)
_NP_VIEW = {"bfloat16": np.int16}

# type byte -> value (nil, false, true), or the struct format of a length
# (bin, str, array, map), a number, or an ext's length
_SIMPLE = {0xC0: None, 0xC2: False, 0xC3: True}
_BIN = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}
_STR = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}
_ARRAY = {0xDC: ">H", 0xDD: ">I"}
_MAP = {0xDE: ">H", 0xDF: ">I"}
_NUMBER = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
           0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
_EXT = {0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}


class MsgpackError(ValueError):
    """The bytes are not a flax msgpack tree this reader can decode."""


def _array(shape, dtype_name: str, buf: bytes) -> torch.Tensor:
    if dtype_name not in _DTYPES:
        raise MsgpackError(f"unsupported array dtype {dtype_name!r}")
    np_dtype = _NP_VIEW.get(dtype_name, dtype_name)
    flat = np.frombuffer(buf, dtype=np_dtype).copy()
    t = torch.from_numpy(flat)
    if dtype_name == "bfloat16":
        t = t.view(torch.bfloat16)
    return t.reshape(tuple(shape))


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise MsgpackError("truncated msgpack data")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str) -> Any:
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def ext(self, code: int, n: int) -> Any:
        payload = bytes(self.take(n))
        if code in (_EXT_NDARRAY, _EXT_NPSCALAR):
            inner = _Reader(payload)
            shape, dtype_name, buf = inner.value()
            if isinstance(dtype_name, bytes):
                dtype_name = dtype_name.decode()
            arr = _array(shape, dtype_name, buf)
            return arr if code == _EXT_NDARRAY else arr.item()
        if code == _EXT_COMPLEX:
            real, imag = _Reader(payload).value()
            return complex(real, imag)
        raise MsgpackError(f"unknown msgpack ext type {code}")

    def seq(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def mapping(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        if _CHUNKED in out:
            raise MsgpackError(
                "the file holds a chunked array (flax splits arrays of "
                "more than 2**30 bytes); this reader does not join chunks")
        return out

    def value(self) -> Any:
        b = self.unpack("B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.mapping(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.seq(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return bytes(self.take(b & 0x1F)).decode()
        if b in _SIMPLE:
            return _SIMPLE[b]
        if b in _BIN:
            return bytes(self.take(self.unpack(_BIN[b])))
        if b in _STR:
            return bytes(self.take(self.unpack(_STR[b]))).decode()
        if b in _ARRAY:
            return self.seq(self.unpack(_ARRAY[b]))
        if b in _MAP:
            return self.mapping(self.unpack(_MAP[b]))
        if b in _NUMBER:
            return self.unpack(_NUMBER[b])
        if b in _FIXEXT or b in _EXT:
            n = _FIXEXT[b] if b in _FIXEXT else self.unpack(_EXT[b])
            return self.ext(self.unpack(">b"), n)
        raise MsgpackError(f"unknown msgpack type byte 0x{b:02x}")


def msgpack_restore(data: bytes) -> Any:
    """The tree ``flax.serialization.msgpack_restore`` returns for
    ``data``, with torch tensors for its numpy arrays."""
    reader = _Reader(data)
    out = reader.value()
    if reader.pos != len(reader.data):
        raise MsgpackError(f"{len(reader.data) - reader.pos} bytes after "
                           "the msgpack value")
    return out
