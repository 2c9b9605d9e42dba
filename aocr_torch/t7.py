"""Torch7 binary serialization (.t7) reader/writer (the port's own copy
of aocr/t7.py, numpy only; tests/test_torch_port_t7.py holds the two
equal).

The reference saves checkpoints with `torch.save` (its
src/model/model.lua:724), which emits Torch7's little-endian binary
object stream.  This module implements that public format directly (no
torch7/Lua runtime needed):

stream grammar (all ints int32 LE, longs int64 LE, numbers float64 LE):

    object  := typeid payload
    typeid  := 0 nil | 1 number | 2 string | 3 table | 4 torch class |
               5 boolean | 6 function | 7/8 recursive function
    number  := float64
    string  := int32 len, bytes
    boolean := int32 (0/1)
    table   := int32 heap-index [, int32 npairs, (object object)*]
    torch   := int32 heap-index [, rawstring version ('V <n>'),
               rawstring classname, body]
    rawstring := int32 len, bytes         (no typeid prefix)

    body for torch.*Tensor  := int32 ndim, int64[ndim] size,
                               int64[ndim] stride,
                               int64 storageOffset (1-based),
                               object (the storage, or nil)
    body for torch.*Storage := int64 size, raw elementwise data
    body for anything else  := object (a table of the instance fields)

Heap indices deduplicate shared references: the second occurrence of a
table/object writes only its index.

Reader returns: numbers/strings/bools as Python scalars (bytes decoded to
str when valid UTF-8), tensors as numpy arrays, tables as dicts — or lists
when the keys are exactly 1..n (Lua array part; order preserved) — and any
other torch class as `TorchObject(classname, fields)`.

The writer emits the same grammar, mapping numpy arrays to
torch.<T>Tensor + Storage; it exists so tests and chip_smoke.py can
fabricate reference-layout checkpoints, with 8-byte longs or, as 32-bit
torch builds wrote them, 4-byte longs (`save(..., long_size=4)`).
"""

from __future__ import annotations

import re
import struct
from typing import Any, BinaryIO, Dict, Optional

import numpy as np

TYPE_NIL = 0
TYPE_NUMBER = 1
TYPE_STRING = 2
TYPE_TABLE = 3
TYPE_TORCH = 4
TYPE_BOOLEAN = 5
TYPE_FUNCTION = 6
TYPE_LEGACY_RECUR_FUNCTION = 7
TYPE_RECUR_FUNCTION = 8

_TENSOR_DTYPES = {
    "torch.DoubleTensor": np.float64,
    "torch.FloatTensor": np.float32,
    "torch.CudaTensor": np.float32,  # cast to double on load by model.lua:55
    "torch.HalfTensor": np.float16,
    "torch.LongTensor": np.int64,
    "torch.IntTensor": np.int32,
    "torch.ShortTensor": np.int16,
    "torch.CharTensor": np.int8,
    "torch.ByteTensor": np.uint8,
}
_STORAGE_DTYPES = {
    k.replace("Tensor", "Storage"): v for k, v in _TENSOR_DTYPES.items()
}
_NP_TO_TORCH = {
    np.dtype(np.float64): "Double",
    np.dtype(np.float32): "Float",
    np.dtype(np.int64): "Long",
    np.dtype(np.int32): "Int",
    np.dtype(np.int16): "Short",
    np.dtype(np.int8): "Char",
    np.dtype(np.uint8): "Byte",
}


class TorchObject:
    """A deserialized torch class instance: classname + field dict."""

    def __init__(self, torch_typename: str, fields: Optional[dict] = None):
        self.torch_typename = torch_typename
        self.fields = fields if fields is not None else {}

    def __getitem__(self, key):
        return self.fields[key]

    def get(self, key, default=None):
        return self.fields.get(key, default)

    def __contains__(self, key):
        return key in self.fields

    def __repr__(self):
        return f"TorchObject({self.torch_typename}, {sorted(self.fields)})"


# ------------------------------------------------------------------ reader


class _Reader:
    def __init__(self, f: BinaryIO, long_size: int = 8):
        # long_size: byte width of C `long` on the writing platform —
        # 8 on 64-bit Linux (the overwhelmingly common case), 4 for
        # streams written by 32-bit builds (tensor sizes/strides/offsets
        # and storage lengths are C longs in torch7's File.c).
        assert long_size in (4, 8), long_size
        self.f = f
        self.long_size = long_size
        self._long_fmt = "<q" if long_size == 8 else "<i"
        self.memo: Dict[int, Any] = {}

    def _read(self, n: int) -> bytes:
        # n is stream-controlled (string/storage/bytecode lengths): reject
        # negative and absurd values up front — file objects raise
        # OverflowError past index-size, and a silent all-the-rest read
        # would desync the stream anyway.
        if n < 0 or n > (1 << 40):
            raise ValueError(f"corrupt t7 stream: record length {n}")
        b = self.f.read(n)
        if len(b) != n:
            raise EOFError("truncated t7 stream")
        return b

    def read_int(self) -> int:
        return struct.unpack("<i", self._read(4))[0]

    def read_long(self) -> int:
        return struct.unpack(self._long_fmt, self._read(self.long_size))[0]

    def read_double(self) -> float:
        return struct.unpack("<d", self._read(8))[0]

    def read_rawstring(self):
        n = self.read_int()
        b = self._read(n)
        try:
            return b.decode("utf-8")
        except UnicodeDecodeError:
            return b

    def read_object(self) -> Any:
        t = self.read_int()
        if t == TYPE_NIL:
            return None
        if t == TYPE_NUMBER:
            return self.read_double()
        if t == TYPE_STRING:
            return self.read_rawstring()
        if t == TYPE_BOOLEAN:
            return self.read_int() == 1
        if t == TYPE_TABLE:
            idx = self.read_int()
            if idx in self.memo:
                return self.memo[idx]
            n = self.read_int()
            tbl: Dict[Any, Any] = {}
            self.memo[idx] = tbl  # insert BEFORE recursion (cycles)
            for _ in range(n):
                k = self.read_object()
                v = self.read_object()
                if isinstance(k, float) and k.is_integer():
                    k = int(k)
                tbl[k] = v
            lst = _as_list(tbl)
            if lst is not None:
                # keep the memoized dict identity for cyclic refs, but
                # return the friendlier list for the common array case
                self.memo[idx] = lst
                return lst
            return tbl
        if t == TYPE_TORCH:
            idx = self.read_int()
            if idx in self.memo:
                return self.memo[idx]
            version = self.read_rawstring()
            # torch7 matches the version tag with `^V (.*)$` + tonumber
            # (File.lua): only 'V <number>' is a tag; any other string —
            # including a classname that merely starts with "V " — IS the
            # classname of a legacy versionless stream.
            if (isinstance(version, str)
                    and re.fullmatch(r"V [0-9]+", version)):
                classname = self.read_rawstring()
            else:
                classname = version  # legacy stream without version tag
            if classname in _TENSOR_DTYPES:
                arr = self._read_tensor(classname)
                self.memo[idx] = arr
                return arr
            if classname in _STORAGE_DTYPES:
                arr = self._read_storage(classname)
                self.memo[idx] = arr
                return arr
            obj = TorchObject(classname)
            self.memo[idx] = obj
            fields = self.read_object()
            if isinstance(fields, dict):
                obj.fields = fields
            elif isinstance(fields, list):
                obj.fields = {i + 1: v for i, v in enumerate(fields)}
            elif fields is not None:
                obj.fields = {"value": fields}
            return obj
        if t in (TYPE_FUNCTION, TYPE_RECUR_FUNCTION,
                 TYPE_LEGACY_RECUR_FUNCTION):
            idx = self.read_int()
            if idx in self.memo:
                return self.memo[idx]
            size = self.read_int()
            self._read(size)  # dumped bytecode: opaque, skipped
            self.memo[idx] = None
            upvalues = self.read_object()
            del upvalues
            return None
        raise ValueError(f"unknown t7 type id {t}")

    def _read_tensor(self, classname: str) -> Optional[np.ndarray]:
        ndim = self.read_int()
        if ndim < 0:
            raise ValueError(f"corrupt t7 tensor: ndim={ndim}")
        size = [self.read_long() for _ in range(ndim)]
        stride = [self.read_long() for _ in range(ndim)]
        offset = self.read_long() - 1  # torch is 1-based
        storage = self.read_object()
        if storage is None or ndim == 0:
            return None
        dtype = _TENSOR_DTYPES[classname]
        flat = np.asarray(storage, dtype)
        if flat.ndim != 1:
            raise ValueError("corrupt t7 tensor: storage is not flat")
        # Validate the view geometry BEFORE as_strided: size/stride/offset
        # come straight from the (untrusted) stream, and an out-of-range
        # view would read arbitrary process memory; an absurd element
        # count would be a memory bomb on the materializing copy.
        if any(s < 0 for s in size):
            raise ValueError(f"corrupt t7 tensor: size={size}")
        n_elem = 1
        for s in size:
            n_elem *= s
        # 2^28 elements = 1 GiB of f32 — an order of magnitude above any
        # real OCR checkpoint tensor, but small enough that a crafted
        # stride-0 record can't OOM the importer on the materializing copy
        if n_elem > (1 << 28):
            raise ValueError(f"corrupt t7 tensor: {n_elem} elements")
        if n_elem:
            lo = offset + sum(min(0, (sz - 1) * st)
                              for sz, st in zip(size, stride))
            hi = offset + sum(max(0, (sz - 1) * st)
                              for sz, st in zip(size, stride))
            if lo < 0 or hi >= flat.shape[0]:
                raise ValueError(
                    "corrupt t7 tensor: view [{}, {}] outside storage of "
                    "{} elements".format(lo, hi, flat.shape[0]))
        else:
            return np.empty(tuple(size), dtype)
        itemsize = flat.dtype.itemsize
        strided = np.lib.stride_tricks.as_strided(
            flat[offset:],
            shape=tuple(size),
            strides=tuple(s * itemsize for s in stride),
        )
        return np.array(strided)  # contiguous copy, detached from storage

    def _read_storage(self, classname: str) -> np.ndarray:
        n = self.read_long()
        if classname == "torch.LongStorage" and self.long_size == 4:
            # torch7's File.c writes LongStorage elements as C `long`,
            # which is 4 bytes on the 32-bit builds this long_size mode
            # exists for — reading them 8-wide would misparse the values
            # AND desync the rest of the stream.
            raw = np.frombuffer(self._read(n * 4), np.dtype("<i4"))
            return raw.astype(np.int64)
        dtype = np.dtype(_STORAGE_DTYPES[classname])
        return np.frombuffer(self._read(n * dtype.itemsize), dtype).copy()


def _as_list(tbl: dict) -> Optional[list]:
    """Lua array part: keys exactly 1..n (order preserved by the stream)."""
    n = len(tbl)
    if n == 0:
        return None
    if all(isinstance(k, int) for k in tbl) and sorted(tbl) == list(
            range(1, n + 1)):
        return [tbl[i] for i in range(1, n + 1)]
    return None


def load(path: str, long_size: int = 8) -> Any:
    """Read a .t7 file.  long_size=4 reads streams written by 32-bit
    torch builds (where C `long` — tensor sizes/strides/offsets, storage
    lengths — is 4 bytes)."""
    with open(path, "rb") as f:
        return _Reader(f, long_size=long_size).read_object()


# ------------------------------------------------------------------ writer


class _Writer:
    def __init__(self, f: BinaryIO, long_size: int = 8):
        # long_size as the reader's: the C `long` fields (tensor sizes,
        # strides, offsets, storage lengths and LongStorage elements)
        assert long_size in (4, 8), long_size
        self.f = f
        self.long_size = long_size
        self._long_fmt = "<q" if long_size == 8 else "<i"
        self.memo: Dict[int, int] = {}
        self.next_idx = 1

    def write_int(self, v: int) -> None:
        self.f.write(struct.pack("<i", v))

    def write_long(self, v: int) -> None:
        self.f.write(struct.pack(self._long_fmt, v))

    def write_rawstring(self, s) -> None:
        b = s.encode("utf-8") if isinstance(s, str) else bytes(s)
        self.write_int(len(b))
        self.f.write(b)

    def _heap(self, obj) -> Optional[int]:
        """Returns the existing index (after writing it) or None if new
        (index written, caller writes the body)."""
        key = id(obj)
        if key in self.memo:
            self.write_int(self.memo[key])
            return self.memo[key]
        self.memo[key] = self.next_idx
        self.write_int(self.next_idx)
        self.next_idx += 1
        return None

    def write_object(self, obj) -> None:
        if isinstance(obj, np.generic) or (
                isinstance(obj, np.ndarray) and obj.ndim == 0):
            obj = obj.item()  # torch7 has no 0-d tensors: write a number
        if obj is None:
            self.write_int(TYPE_NIL)
        elif isinstance(obj, bool):
            self.write_int(TYPE_BOOLEAN)
            self.write_int(1 if obj else 0)
        elif isinstance(obj, (int, float)):
            self.write_int(TYPE_NUMBER)
            self.f.write(struct.pack("<d", float(obj)))
        elif isinstance(obj, (str, bytes)):
            self.write_int(TYPE_STRING)
            self.write_rawstring(obj)
        elif isinstance(obj, np.ndarray):
            self._write_tensor(obj)
        elif isinstance(obj, (list, tuple)):
            self.write_int(TYPE_TABLE)
            if self._heap(obj) is None:
                self.write_int(len(obj))
                for i, v in enumerate(obj):
                    self.write_object(i + 1)
                    self.write_object(v)
        elif isinstance(obj, dict):
            self.write_int(TYPE_TABLE)
            if self._heap(obj) is None:
                self.write_int(len(obj))
                for k, v in obj.items():
                    self.write_object(k)
                    self.write_object(v)
        elif isinstance(obj, TorchObject):
            self.write_int(TYPE_TORCH)
            if self._heap(obj) is None:
                self.write_rawstring("V 1")
                self.write_rawstring(obj.torch_typename)
                self.write_object(obj.fields)
        else:
            raise TypeError(f"cannot serialize {type(obj)} to t7")

    def _write_tensor(self, arr: np.ndarray) -> None:
        torch_t = _NP_TO_TORCH.get(arr.dtype)
        if torch_t is None:
            raise TypeError(f"no torch tensor type for dtype {arr.dtype}")
        self.write_int(TYPE_TORCH)
        if self._heap(arr) is not None:
            return
        self.write_rawstring("V 1")
        self.write_rawstring(f"torch.{torch_t}Tensor")
        arr_c = np.ascontiguousarray(arr)
        self.write_int(arr.ndim)
        for s in arr.shape:
            self.write_long(s)
        # contiguous row-major strides in elements
        stride = 1
        strides = []
        for s in reversed(arr.shape):
            strides.append(stride)
            stride *= s
        for s in reversed(strides):
            self.write_long(s)
        self.write_long(1)  # storageOffset (1-based)
        # storage (a fresh heap object)
        self.write_int(TYPE_TORCH)
        self.write_int(self.next_idx)
        self.next_idx += 1
        self.write_rawstring("V 1")
        self.write_rawstring(f"torch.{torch_t}Storage")
        self.write_long(arr_c.size)
        if torch_t == "Long" and self.long_size == 4:
            arr_c = arr_c.astype("<i4")  # C longs, as the reader expects
        self.f.write(arr_c.tobytes())


def save(path: str, obj: Any, long_size: int = 8) -> None:
    """Write obj as a .t7 stream; long_size=4 writes the C longs 4 bytes
    wide, as 32-bit torch builds did."""
    with open(path, "wb") as f:
        _Writer(f, long_size).write_object(obj)
