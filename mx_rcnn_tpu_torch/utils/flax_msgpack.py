"""The subset of msgpack that flax's checkpoint files use, in pure Python.

A JAX-package checkpoint is ``flax.serialization.msgpack_serialize`` of a
state dict: nested maps with string keys, sorted (flax rebuilds the tree
with ``jax.tree_util`` before packing), whose leaves are arrays.  Each
array is msgpack ext type 1 whose body packs ``(shape, dtype name,
C-order bytes)``; ext type 3 is a numpy scalar packed the same way.
flax would split an array over ``MAX_CHUNK_SIZE`` bytes into chunks; no
leaf of these models comes near it, and the codec refuses one.

:func:`packb` writes the bytes flax writes for the same tree, and
:func:`unpackb` reads what flax writes, with ``struct`` and no msgpack
package.  numpy has no bfloat16, so a ``bfloat16`` array is read as its
uint16 bits viewed as a ``torch.bfloat16`` tensor, and a ``torch.Tensor``
of any dtype is written as the array of its dtype's name.  Every other
array comes back as a numpy array.
"""

from __future__ import annotations

import math
import struct
from typing import Any, List

import numpy as np
import torch

EXT_NDARRAY = 1
EXT_NPSCALAR = 3
# flax splits an array leaf above this many bytes into chunks
MAX_CHUNK_SIZE = 2 ** 30


# ---- packing ---------------------------------------------------------------

def _pack_int(v: int, out: List[bytes]) -> None:
    if 0 <= v < 128:
        out.append(struct.pack("B", v))
    elif -32 <= v < 0:
        out.append(struct.pack("b", v))
    elif v >= 0:
        for code, fmt, top in ((0xcc, ">B", 0xff), (0xcd, ">H", 0xffff),
                               (0xce, ">I", 0xffffffff),
                               (0xcf, ">Q", 0xffffffffffffffff)):
            if v <= top:
                out.append(bytes([code]) + struct.pack(fmt, v))
                return
        raise OverflowError(f"integer {v} does not fit msgpack")
    else:
        for code, fmt, low in ((0xd0, ">b", -2 ** 7), (0xd1, ">h", -2 ** 15),
                               (0xd2, ">i", -2 ** 31), (0xd3, ">q", -2 ** 63)):
            if v >= low:
                out.append(bytes([code]) + struct.pack(fmt, v))
                return
        raise OverflowError(f"integer {v} does not fit msgpack")


def _pack_len(n: int, fix: int, fix_max: int, codes, out: List[bytes]) -> None:
    """A length header: the fix form below ``fix_max``, else the smallest
    of ``codes`` = ((code, struct format, largest length), ...)."""
    if fix is not None and n < fix_max:
        out.append(bytes([fix | n]))
        return
    for code, fmt, top in codes:
        if n <= top:
            out.append(bytes([code]) + struct.pack(fmt, n))
            return
    raise OverflowError(f"length {n} does not fit msgpack")


_STR = ((0xd9, ">B", 0xff), (0xda, ">H", 0xffff), (0xdb, ">I", 0xffffffff))
_BIN = ((0xc4, ">B", 0xff), (0xc5, ">H", 0xffff), (0xc6, ">I", 0xffffffff))
_ARR = ((0xdc, ">H", 0xffff), (0xdd, ">I", 0xffffffff))
_MAP = ((0xde, ">H", 0xffff), (0xdf, ">I", 0xffffffff))
_FIXEXT = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}
_EXT = ((0xc7, ">B", 0xff), (0xc8, ">H", 0xffff), (0xc9, ">I", 0xffffffff))


def _pack_ext(code: int, data: bytes, out: List[bytes]) -> None:
    if len(data) in _FIXEXT:
        out.append(bytes([_FIXEXT[len(data)]]))
    else:
        _pack_len(len(data), None, 0, _EXT, out)
    out.append(struct.pack("b", code))
    out.append(data)


def _array_body(shape, name: str, raw: bytes) -> bytes:
    """flax's ``_ndarray_to_bytes``: msgpack of (shape, dtype name, bytes)."""
    if len(raw) > MAX_CHUNK_SIZE:
        raise ValueError(f"an array of {len(raw)} bytes: flax would chunk "
                         f"it, and chunks are not supported")
    out: List[bytes] = []
    _pack([list(shape), name, raw], out)
    return b"".join(out)


def _tensor_body(t: torch.Tensor) -> bytes:
    t = t.detach().cpu().contiguous()
    if t.dtype != torch.bfloat16:
        return _numpy_body(t.numpy())
    return _array_body(tuple(t.shape), "bfloat16",
                       t.view(torch.int16).numpy().tobytes())


def _pack(obj: Any, out: List[bytes]) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True or obj is False:
        out.append(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, np.generic):
        # before int and float: np.float64 subclasses float, and flax packs
        # every numpy scalar as ext type 3
        _pack_ext(EXT_NPSCALAR, _numpy_body(np.asarray(obj)), out)
    elif isinstance(obj, int):
        _pack_int(obj, out)
    elif isinstance(obj, float):
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        _pack_len(len(raw), 0xa0, 32, _STR, out)
        out.append(raw)
    elif isinstance(obj, bytes):
        _pack_len(len(obj), None, 0, _BIN, out)
        out.append(obj)
    elif isinstance(obj, list):
        _pack_len(len(obj), 0x90, 16, _ARR, out)
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, dict):
        if not all(isinstance(k, str) for k in obj):
            raise TypeError(f"map keys must be strings: {list(obj)}")
        _pack_len(len(obj), 0x80, 16, _MAP, out)
        for k in sorted(obj):
            _pack(k, out)
            _pack(obj[k], out)
    elif isinstance(obj, torch.Tensor):
        _pack_ext(EXT_NDARRAY, _tensor_body(obj), out)
    elif isinstance(obj, np.ndarray):
        _pack_ext(EXT_NDARRAY, _numpy_body(obj), out)
    else:
        raise TypeError(f"cannot write {type(obj).__name__}")


def _numpy_body(arr: np.ndarray) -> bytes:
    if arr.dtype.hasobject or arr.dtype.fields is not None:
        raise TypeError("object and structured dtypes cannot be written")
    return _array_body(arr.shape, arr.dtype.name, arr.tobytes("C"))


def packb(tree: Any) -> bytes:
    """msgpack bytes of ``tree`` as ``flax.serialization.msgpack_serialize``
    writes them, every map's keys sorted."""
    out: List[bytes] = []
    _pack(tree, out)
    return b"".join(out)


# ---- unpacking -------------------------------------------------------------

class _Reader:
    def __init__(self, data):
        self.buf = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        view = self.buf[self.pos:self.pos + n]
        self.pos += n
        return view

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]


# type byte -> the format of its fixed-width value (ints, float32, float64)
_SCALAR = {0xcc: ">B", 0xcd: ">H", 0xce: ">I", 0xcf: ">Q",
           0xd0: ">b", 0xd1: ">h", 0xd2: ">i", 0xd3: ">q",
           0xca: ">f", 0xcb: ">d"}
# type byte -> the format of the length or count its header gives
_LEN = {0xd9: ">B", 0xda: ">H", 0xdb: ">I", 0xc4: ">B", 0xc5: ">H",
        0xc6: ">I", 0xdc: ">H", 0xdd: ">I", 0xde: ">H", 0xdf: ">I",
        0xc7: ">B", 0xc8: ">H", 0xc9: ">I"}
_FIXEXT_LEN = {v: k for k, v in _FIXEXT.items()}


def _read(r: _Reader) -> Any:
    b = r.unpack("B")
    if b < 0x80:
        return b
    if b >= 0xe0:
        return b - 0x100
    if 0xa0 <= b <= 0xbf:
        return str(r.take(b & 0x1f), "utf-8")
    if 0x90 <= b <= 0x9f:
        return [_read(r) for _ in range(b & 0x0f)]
    if 0x80 <= b <= 0x8f:
        return _read_map(r, b & 0x0f)
    if b == 0xc0:
        return None
    if b in (0xc2, 0xc3):
        return b == 0xc3
    if b in _SCALAR:
        # netlint: disable=NL201 _Reader.take raises ValueError on short data
        return r.unpack(_SCALAR[b])
    if b in _LEN:
        # netlint: disable=NL201 _Reader.take raises ValueError on short data
        return _read_sized(r, b, r.unpack(_LEN[b]))
    if b in _FIXEXT_LEN:
        return _read_sized(r, b, _FIXEXT_LEN[b])
    raise ValueError(f"msgpack type byte 0x{b:02x} is not supported")


def _read_sized(r: _Reader, b: int, n: int) -> Any:
    """The object of type byte ``b`` whose header gave its length or
    count ``n``; a read past the data raises ValueError in
    ``_Reader.take``, so ``n`` sizes nothing before the data is there."""
    if b in (0xd9, 0xda, 0xdb):
        return str(r.take(n), "utf-8")
    if b in (0xc4, 0xc5, 0xc6):
        return bytes(r.take(n))
    if b in (0xdc, 0xdd):
        return [_read(r) for _ in range(n)]
    if b in (0xde, 0xdf):
        return _read_map(r, n)
    return _read_ext(r.unpack("b"), r.take(n))


def _read_map(r: _Reader, n: int) -> dict:
    out = {}
    for _ in range(n):
        key = _read(r)
        if not isinstance(key, str):
            raise ValueError(f"map key {key!r} is not a string")
        out[key] = _read(r)
    return out


def _read_ext(code: int, body: memoryview):
    if code not in (EXT_NDARRAY, EXT_NPSCALAR):
        raise ValueError(f"msgpack ext type {code} is not supported")
    head = _read(_Reader(body))
    if not (isinstance(head, list) and len(head) == 3):
        raise ValueError("an array's ext body is not [shape, dtype, bytes]")
    shape, name, raw = head
    if not (isinstance(shape, list) and isinstance(name, str)
            and isinstance(raw, bytes)
            and all(isinstance(d, int) and d >= 0 for d in shape)):
        raise ValueError(f"an array's ext body holds {shape!r}, {name!r}")
    shape = tuple(shape)
    try:
        itemsize = 2 if name == "bfloat16" else np.dtype(name).itemsize
    except (TypeError, SyntaxError):   # numpy parses some names as code
        raise ValueError(f"unknown array dtype {name!r}") from None
    if math.prod(shape) * itemsize != len(raw):
        raise ValueError(f"{len(raw)} bytes for a {name} array of shape "
                         f"{shape}")
    if name != "bfloat16":
        arr = np.frombuffer(raw, dtype=np.dtype(name)).reshape(shape)
    elif raw:
        arr = torch.frombuffer(bytearray(raw), dtype=torch.bfloat16)
        arr = arr.reshape(shape)
    else:
        arr = torch.empty(shape, dtype=torch.bfloat16)
    if code == EXT_NPSCALAR:
        return arr if isinstance(arr, torch.Tensor) else arr[()]
    return arr


def unpackb(data) -> Any:
    """The tree that ``flax.serialization.msgpack_restore`` returns for
    ``data``, with bfloat16 arrays as ``torch.bfloat16`` tensors.  numpy
    arrays come back read-only."""
    r = _Reader(data)
    out = _read(r)
    if r.pos != len(r.buf):
        raise ValueError(f"{len(r.buf) - r.pos} bytes after the msgpack "
                         f"object")
    return out
