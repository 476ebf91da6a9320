"""Zero-copy GGUF v3 reader.

Parses the GGUF container (magic, version, KV metadata, tensor index) and
exposes tensor payloads as zero-copy numpy views over an mmap of the file.
Quantized payloads stay packed: the port repacks them on the device
(`tpullm_torch.ops.qmatmul.repack`), so `to_numpy` converts only the plain
float types.
"""

from __future__ import annotations

import mmap
import os
import struct
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any

import numpy as np

from .constants import (
    GGUF_DEFAULT_ALIGNMENT,
    GGUF_MAGIC,
    GGMLType,
    GGUFValueType,
    Keys,
    TYPE_TRAITS,
)

_SCALAR_FORMATS: dict[GGUFValueType, str] = {
    GGUFValueType.UINT8: "<B",
    GGUFValueType.INT8: "<b",
    GGUFValueType.UINT16: "<H",
    GGUFValueType.INT16: "<h",
    GGUFValueType.UINT32: "<I",
    GGUFValueType.INT32: "<i",
    GGUFValueType.FLOAT32: "<f",
    GGUFValueType.BOOL: "<?",
    GGUFValueType.UINT64: "<Q",
    GGUFValueType.INT64: "<q",
    GGUFValueType.FLOAT64: "<d",
}

_SCALAR_NUMPY: dict[GGUFValueType, np.dtype] = {
    GGUFValueType.UINT8: np.dtype(np.uint8),
    GGUFValueType.INT8: np.dtype(np.int8),
    GGUFValueType.UINT16: np.dtype("<u2"),
    GGUFValueType.INT16: np.dtype("<i2"),
    GGUFValueType.UINT32: np.dtype("<u4"),
    GGUFValueType.INT32: np.dtype("<i4"),
    GGUFValueType.FLOAT32: np.dtype("<f4"),
    GGUFValueType.BOOL: np.dtype(np.uint8),
    GGUFValueType.UINT64: np.dtype("<u8"),
    GGUFValueType.INT64: np.dtype("<i8"),
    GGUFValueType.FLOAT64: np.dtype("<f8"),
}


class GGUFFormatError(ValueError):
    pass


@dataclass
class GGUFTensorInfo:
    """One entry of the tensor index.

    `shape` follows ggml `ne` order: shape[0] is the contiguous dimension,
    so a weight of logical shape (n_out, n_in) appears as (n_in, n_out).
    """

    name: str
    ggml_type: GGMLType
    shape: tuple[int, ...]
    offset: int  # relative to start of data section
    data: np.ndarray = field(repr=False, default=None)  # uint8 view, packed bytes

    @property
    def n_elements(self) -> int:
        n = 1
        for d in self.shape:
            n *= d
        return n

    @property
    def n_bytes(self) -> int:
        tt = TYPE_TRAITS[self.ggml_type]
        return self.n_elements // tt.block_size * tt.type_size

    def to_numpy(self) -> np.ndarray:
        """F32/F16/BF16 payload as a float32 array in logical (row-major,
        slowest-first) order: result.shape == shape[::-1]."""
        logical = self.shape[::-1]
        if self.ggml_type == GGMLType.F32:
            return self.data.view("<f4").reshape(logical)
        if self.ggml_type == GGMLType.F16:
            return self.data.view("<f2").astype(np.float32).reshape(logical)
        if self.ggml_type == GGMLType.BF16:
            bits = self.data.view("<u2").astype(np.uint32) << 16
            return bits.view(np.float32).reshape(logical)
        raise NotImplementedError(
            f"{self.name}: {self.ggml_type.name} stays packed; repack it with "
            "tpullm_torch.ops.qmatmul.repack")


class _Parser:
    def __init__(self, buf: memoryview):
        self.buf = buf
        self.pos = 0

    def scalar(self, vtype: GGUFValueType):
        fmt = _SCALAR_FORMATS[vtype]
        (val,) = struct.unpack_from(fmt, self.buf, self.pos)
        self.pos += struct.calcsize(fmt)
        return val

    def string(self) -> str:
        n = self.scalar(GGUFValueType.UINT64)
        raw = bytes(self.buf[self.pos: self.pos + n])
        self.pos += n
        return raw.decode("utf-8", errors="replace")

    def value(self, vtype: GGUFValueType):
        if vtype == GGUFValueType.STRING:
            return self.string()
        if vtype == GGUFValueType.ARRAY:
            etype = GGUFValueType(self.scalar(GGUFValueType.UINT32))
            count = self.scalar(GGUFValueType.UINT64)
            if etype == GGUFValueType.STRING:
                return [self.string() for _ in range(count)]
            if etype == GGUFValueType.ARRAY:
                return [self.value(GGUFValueType.ARRAY) for _ in range(count)]
            dt = _SCALAR_NUMPY[etype]
            arr = np.frombuffer(self.buf, dtype=dt, count=count, offset=self.pos)
            self.pos += count * dt.itemsize
            if etype == GGUFValueType.BOOL:
                arr = arr.astype(bool)
            return arr
        return self.scalar(vtype)


class GGUFReader:
    """Memory-mapped GGUF file: `.metadata` dict + `.tensors` name->info map."""

    def __init__(self, path: str | os.PathLike):
        self.path = Path(path)
        with open(self.path, "rb") as f:
            # the mapping holds its own file reference
            self._mmap = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
        buf = memoryview(self._mmap)

        if bytes(buf[:4]) != GGUF_MAGIC:
            raise GGUFFormatError(f"{path}: not a GGUF file (magic {bytes(buf[:4])!r})")
        p = _Parser(buf)
        p.pos = 4
        self.version = p.scalar(GGUFValueType.UINT32)
        if self.version < 2 or self.version > 3:
            raise GGUFFormatError(f"{path}: unsupported GGUF version {self.version}")
        n_tensors = p.scalar(GGUFValueType.UINT64)
        n_kv = p.scalar(GGUFValueType.UINT64)

        self.metadata: dict[str, Any] = {}
        for _ in range(n_kv):
            key = p.string()
            vtype = GGUFValueType(p.scalar(GGUFValueType.UINT32))
            self.metadata[key] = p.value(vtype)

        self.alignment = int(self.metadata.get(Keys.General.ALIGNMENT, GGUF_DEFAULT_ALIGNMENT))

        self.tensors: dict[str, GGUFTensorInfo] = {}
        for _ in range(n_tensors):
            name = p.string()
            n_dims = p.scalar(GGUFValueType.UINT32)
            shape = tuple(p.scalar(GGUFValueType.UINT64) for _ in range(n_dims))
            ggml_type = GGMLType(p.scalar(GGUFValueType.UINT32))
            offset = p.scalar(GGUFValueType.UINT64)
            self.tensors[name] = GGUFTensorInfo(name, ggml_type, shape, offset)

        data_start = p.pos
        if data_start % self.alignment != 0:
            data_start += self.alignment - data_start % self.alignment

        raw = np.frombuffer(self._mmap, dtype=np.uint8)
        for info in self.tensors.values():
            begin = data_start + info.offset
            info.data = raw[begin: begin + info.n_bytes]

    @property
    def architecture(self) -> str:
        return self.metadata[Keys.General.ARCHITECTURE]

    def close(self):
        """Best-effort close: numpy tensor views may still point into the map,
        in which case the mapping is released when they are garbage-collected."""
        try:
            self._mmap.close()
        except BufferError:
            pass
