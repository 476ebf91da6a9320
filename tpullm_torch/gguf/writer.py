"""GGUF v3 writer: KV metadata, F32/F16 tensors and pre-packed quantized
payloads (what the model synthesis needs). A payload may be a callable that
produces the bytes when the file is written, so a writer of a large model
never holds all of its payloads in host memory at once."""

from __future__ import annotations

import struct
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable, Sequence, Union

import numpy as np

from .constants import (
    GGUF_DEFAULT_ALIGNMENT,
    GGUF_MAGIC,
    GGUF_VERSION,
    GGMLType,
    GGUFValueType,
    TYPE_TRAITS,
    row_size,
)

_SCALAR_FORMATS = {
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


def _infer_scalar_type(v: Any) -> GGUFValueType:
    if isinstance(v, (bool, np.bool_)):
        return GGUFValueType.BOOL
    if isinstance(v, (int, np.integer)):
        iv = int(v)
        if iv < 0:
            return GGUFValueType.INT64 if iv < -(2**31) else GGUFValueType.INT32
        return GGUFValueType.UINT64 if iv >= 2**32 else GGUFValueType.UINT32
    if isinstance(v, (float, np.floating)):
        return GGUFValueType.FLOAT32
    if isinstance(v, str):
        return GGUFValueType.STRING
    raise TypeError(f"cannot infer GGUF type for {type(v)}")


# bytes, or any object with the buffer protocol (a uint8 numpy array)
Payload = Union[bytes, bytearray, memoryview, np.ndarray]


@dataclass
class _TensorRecord:
    name: str
    shape: tuple[int, ...]  # ne order (fastest-varying first)
    ggml_type: GGMLType
    payload: Payload | Callable[[], Payload]
    n_bytes: int


class GGUFWriter:
    def __init__(self, path: str | Path, architecture: str | None = None,
                 alignment: int = GGUF_DEFAULT_ALIGNMENT):
        self.path = Path(path)
        self.alignment = alignment
        self._kv: list[tuple[str, GGUFValueType, Any]] = []
        self._tensors: list[_TensorRecord] = []
        if architecture is not None:
            self.add_kv("general.architecture", architecture)

    def add_kv(self, key: str, value: Any, vtype: GGUFValueType | None = None):
        if vtype is None:
            if isinstance(value, (list, tuple, np.ndarray)):
                vtype = GGUFValueType.ARRAY
            else:
                vtype = _infer_scalar_type(value)
        self._kv.append((key, vtype, value))

    def add_tensor(self, name: str, array: np.ndarray,
                   ggml_type: GGMLType = GGMLType.F32):
        """Add an F32 or F16 tensor given in logical (row-major) order."""
        dt = {GGMLType.F32: "<f4", GGMLType.F16: "<f2"}.get(ggml_type)
        if dt is None:
            raise NotImplementedError(
                f"{name}: {ggml_type.name} payloads go through add_packed_tensor")
        payload = np.ascontiguousarray(array, dtype=dt).tobytes()
        self.add_packed_tensor(name, tuple(reversed(array.shape)), ggml_type, payload)

    def add_packed_tensor(self, name: str, ne_shape: Sequence[int],
                          ggml_type: GGMLType, payload: Payload | Callable[[], Payload]):
        """`payload` is the packed bytes, or a callable that returns them
        when the file is written (called once, in the order of the adds)."""
        n_elements = int(np.prod(ne_shape)) if len(ne_shape) else 1
        tt = TYPE_TRAITS[ggml_type]
        expect = n_elements // tt.block_size * tt.type_size
        if not callable(payload):
            self._check_size(name, payload, expect, ggml_type, ne_shape)
        if ne_shape and ne_shape[0] % tt.block_size != 0:
            row_size(ggml_type, ne_shape[0])  # raises with a good message
        self._tensors.append(_TensorRecord(name, tuple(ne_shape), ggml_type, payload,
                                           expect))

    @staticmethod
    def _check_size(name, payload: Payload, expect: int, ggml_type, ne_shape):
        got = memoryview(payload).nbytes
        if got != expect:
            raise ValueError(
                f"tensor {name}: payload {got}B != expected {expect}B "
                f"for {ggml_type.name} {tuple(ne_shape)}"
            )

    def payload_bytes(self) -> int:
        """Bytes of all tensor payloads, alignment padding excluded."""
        return sum(t.n_bytes for t in self._tensors)

    def _write_str(self, out, s: str):
        raw = s.encode("utf-8")
        out.write(struct.pack("<Q", len(raw)))
        out.write(raw)

    def _write_value(self, out, vtype: GGUFValueType, value: Any):
        if vtype == GGUFValueType.STRING:
            self._write_str(out, value)
        elif vtype == GGUFValueType.ARRAY:
            if isinstance(value, np.ndarray):
                etype = {
                    "f": GGUFValueType.FLOAT32,
                    "i": GGUFValueType.INT32,
                    "u": GGUFValueType.UINT32,
                    "b": GGUFValueType.BOOL,
                }[value.dtype.kind]
                if value.dtype.itemsize == 8 and value.dtype.kind in "iu":
                    etype = GGUFValueType.INT64 if value.dtype.kind == "i" else GGUFValueType.UINT64
                elems = value.tolist()
            else:
                elems = list(value)
                etype = _infer_scalar_type(elems[0]) if elems else GGUFValueType.INT32
            out.write(struct.pack("<I", int(etype)))
            out.write(struct.pack("<Q", len(elems)))
            for e in elems:
                self._write_value(out, etype, e)
        else:
            out.write(struct.pack(_SCALAR_FORMATS[vtype], value))

    def write(self):
        align = self.alignment
        with open(self.path, "wb") as out:
            out.write(GGUF_MAGIC)
            out.write(struct.pack("<I", GGUF_VERSION))
            out.write(struct.pack("<Q", len(self._tensors)))
            out.write(struct.pack("<Q", len(self._kv)))
            for key, vtype, value in self._kv:
                self._write_str(out, key)
                out.write(struct.pack("<I", int(vtype)))
                self._write_value(out, vtype, value)

            # tensor index; offsets are relative to the aligned data section
            offset = 0
            offsets = []
            for t in self._tensors:
                offsets.append(offset)
                offset += t.n_bytes
                if offset % align:
                    offset += align - offset % align
            for t, off in zip(self._tensors, offsets):
                self._write_str(out, t.name)
                out.write(struct.pack("<I", len(t.shape)))
                for d in t.shape:
                    out.write(struct.pack("<Q", d))
                out.write(struct.pack("<I", int(t.ggml_type)))
                out.write(struct.pack("<Q", off))

            pos = out.tell()
            if pos % align:
                out.write(b"\x00" * (align - pos % align))
            for t in self._tensors:
                payload = t.payload() if callable(t.payload) else t.payload
                self._check_size(t.name, payload, t.n_bytes, t.ggml_type, t.shape)
                out.write(payload)
                end = out.tell()
                if end % align:
                    out.write(b"\x00" * (align - end % align))
        return self.path
