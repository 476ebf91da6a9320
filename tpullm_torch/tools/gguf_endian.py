"""tpullm-torch-gguf-convert-endian: a GGUF file between little- and
big-endian (the JAX package's tools/gguf_endian.py, its flags and output;
reference gguf-py/gguf/scripts/gguf_convert_endian.py).

Walks the container and byte-swaps every multi-byte scalar in place: the
header, the typed KV values, the tensor index and every tensor payload.
A plain payload swaps each element; a block-quantized one swaps only its
blocks' multi-byte fields (vectorized over the blocks), as ggml-common.h
lays them out: the f16 scales, and the u16 words of the types that hold
them (IQ2_XXS and IQ2_XS codes, IQ1_S's qh, IQ4_XS's scales_h, IQ1_M's
scale words); code bytes and nibbles carry no byte order (MXFP4 none at
all). The JAX tool certifies the eleven legacy and K-quant types and Q8_K
and refuses the rest; this one takes, beside them, every other type of
the port's kernels (ops/qmatmul.py _SCHEMA: the IQ, TQ and MXFP4 formats),
so a round trip is byte-equal for each; a type outside both sets raises.

    python -m tpullm_torch.tools.gguf_endian model.gguf big [-o out.gguf] [-q]
"""

from __future__ import annotations

import argparse
import mmap
import os
import shutil
import struct
import sys

import numpy as np

from ..gguf.constants import GGMLType, GGUFValueType, TYPE_TRAITS

# byte offsets (within one block) of the f16 fields to swap, per type
_F16_FIELDS = {
    GGMLType.Q4_0: (0,),
    GGMLType.Q4_1: (0, 2),
    GGMLType.Q5_0: (0,),
    GGMLType.Q5_1: (0, 2),
    GGMLType.Q8_0: (0,),
    GGMLType.Q8_1: (0, 2),
    GGMLType.Q2_K: (80, 82),
    GGMLType.Q3_K: (108,),
    GGMLType.Q4_K: (0, 2),
    GGMLType.Q5_K: (0, 2),
    GGMLType.Q6_K: (208,),
    # the types the JAX tool refuses
    GGMLType.IQ4_NL: (0,),
    GGMLType.IQ4_XS: (0, 2),  # d, scales_h
    GGMLType.IQ2_S: (0,),
    GGMLType.IQ3_XXS: (0,),
    GGMLType.IQ3_S: (0,),
    GGMLType.IQ1_S: (0,),
    GGMLType.TQ1_0: (52,),
    GGMLType.TQ2_0: (64,),
}
# (byte offset, count) of runs of u16 fields: Q8_K's 16 i16 bsums, the u16
# codes of IQ2_XXS and IQ2_XS (qs[32] after d), IQ1_S's qh[8], and IQ1_M's
# four scale words (its f16 d spread over their top nibbles)
_EXTRA_U16_RUNS = {
    GGMLType.Q8_K: ((260, 16),),
    GGMLType.IQ2_XXS: ((0, 33),),
    GGMLType.IQ2_XS: ((0, 33),),
    GGMLType.IQ1_S: ((34, 8),),
    GGMLType.IQ1_M: ((48, 4),),
}
_NEUTRAL = (GGMLType.I8, GGMLType.MXFP4)  # byte-wide fields only
_PLAIN_WIDTH = {
    GGMLType.F32: 4, GGMLType.F64: 8, GGMLType.F16: 2, GGMLType.BF16: 2,
    GGMLType.I16: 2, GGMLType.I32: 4, GGMLType.I64: 8,
}

_SCALAR_SIZES = {
    GGUFValueType.UINT8: 1, GGUFValueType.INT8: 1, GGUFValueType.BOOL: 1,
    GGUFValueType.UINT16: 2, GGUFValueType.INT16: 2,
    GGUFValueType.UINT32: 4, GGUFValueType.INT32: 4,
    GGUFValueType.FLOAT32: 4,
    GGUFValueType.UINT64: 8, GGUFValueType.INT64: 8,
    GGUFValueType.FLOAT64: 8,
}


class _Walker:
    """A walk over the container that byte-swaps its scalars in place;
    `src_order` is the byte order the file is in now ('<' or '>')."""

    def __init__(self, buf, src_order: str):
        self.buf = buf
        self.pos = 0
        self.o = src_order

    def _swap(self, size: int) -> None:
        p = self.pos
        self.buf[p:p + size] = self.buf[p:p + size][::-1]
        self.pos += size

    def u(self, size: int, swap: bool = True) -> int:
        fmt = {1: "B", 2: "H", 4: "I", 8: "Q"}[size]
        (val,) = struct.unpack_from(self.o + fmt, self.buf, self.pos)
        if swap and size > 1:
            self._swap(size)
        else:
            self.pos += size
        return val

    def string(self) -> str:
        n = self.u(8)
        s = bytes(self.buf[self.pos:self.pos + n])
        self.pos += n
        return s.decode("utf-8", errors="replace")

    def value(self, vtype: GGUFValueType) -> None:
        if vtype == GGUFValueType.STRING:
            self.string()
            return
        if vtype == GGUFValueType.ARRAY:
            elem = GGUFValueType(self.u(4))
            n = self.u(8)
            if elem == GGUFValueType.STRING:
                for _ in range(n):
                    self.string()
            elif elem == GGUFValueType.ARRAY:
                for _ in range(n):
                    self.value(GGUFValueType.ARRAY)
            else:
                size = _SCALAR_SIZES[elem]
                if size == 1:
                    self.pos += n
                else:
                    arr = np.frombuffer(self.buf, np.uint8, n * size, self.pos).reshape(n, size)
                    np.copyto(arr, arr[:, ::-1])
                    self.pos += n * size
            return
        size = _SCALAR_SIZES[vtype]
        if size == 1:
            self.pos += 1
        else:
            self._swap(size)


def _swap_tensor_payload(data: np.ndarray, gtype: GGMLType, name: str) -> None:
    """Byte-swaps one tensor's payload in place (vectorized over blocks)."""
    if gtype in _NEUTRAL:
        return
    width = _PLAIN_WIDTH.get(gtype)
    if width:
        arr = data.reshape(-1, width)
        np.copyto(arr, arr[:, ::-1])
        return
    fields = _F16_FIELDS.get(gtype, ())
    runs = _EXTRA_U16_RUNS.get(gtype, ())
    if not fields and not runs:
        raise NotImplementedError(
            f"tensor {name}: cannot endian-convert {gtype.name} payloads "
            "(no field layout for this type)")
    blocks = data.reshape(-1, TYPE_TRAITS[gtype].type_size)
    for off in fields:
        col = blocks[:, off:off + 2]
        np.copyto(col, col[:, ::-1])
    if gtype == GGMLType.Q8_K:  # its d is an f32 at offset 0
        col = blocks[:, 0:4]
        np.copyto(col, col[:, ::-1])
    for off, count in runs:
        seg = blocks[:, off:off + 2 * count].reshape(-1, count, 2)
        np.copyto(seg, seg[:, :, ::-1])


def convert_endian(src: str, dst: str, order: str, verbose: bool = True) -> dict:
    """Rewrites `src` as `dst` (in place when they are one file) in the byte
    order `order` ('big' or 'little'); the payloads are swapped in place
    through a map of `dst`, never held in host memory. Returns
    {'tensors': n, 'order': order} (with 'noop' when `src` was in it)."""
    if os.path.abspath(src) != os.path.abspath(dst):
        shutil.copyfile(src, dst)
    with open(dst, "r+b") as f:
        raw = mmap.mmap(f.fileno(), 0)
        if bytes(raw[0:4]) != b"GGUF":
            raise ValueError(f"{src}: not a GGUF file")
        # the source's order from the version field (2 or 3 swapped reads huge)
        (ver_le,) = struct.unpack_from("<I", raw, 4)
        src_big = ver_le > 0xFFFF
        src_order = ">" if src_big else "<"
        if src_big == (order == "big"):
            if verbose:
                print(f"{src}: already {order}-endian", file=sys.stderr)
            raw.close()
            return {"tensors": 0, "order": order, "noop": True}
        w = _Walker(raw, src_order)
        w.pos = 4
        version = w.u(4)
        if version not in (2, 3):
            raise ValueError(f"unsupported GGUF version {version}")
        n_tensors = w.u(8)
        n_kv = w.u(8)
        align = 32
        for _ in range(n_kv):
            key = w.string()
            vtype = GGUFValueType(w.u(4))
            if key == "general.alignment" and vtype == GGUFValueType.UINT32:
                (align,) = struct.unpack_from(src_order + "I", raw, w.pos)
            w.value(vtype)
        infos = []
        for _ in range(n_tensors):
            name = w.string()
            n_dims = w.u(4)
            shape = [w.u(8) for _ in range(n_dims)]
            gtype = GGMLType(w.u(4))
            offset = w.u(8)
            infos.append((name, shape, gtype, offset))
        data_start = (w.pos + align - 1) // align * align
        for name, shape, gtype, offset in infos:
            n_el = int(np.prod(shape)) if shape else 1
            tt = TYPE_TRAITS[gtype]
            nbytes = n_el // tt.block_size * tt.type_size
            view = np.frombuffer(raw, np.uint8, nbytes, data_start + offset)
            _swap_tensor_payload(view, gtype, name)
            del view  # no exported pointer into the map at close
            if verbose:
                print(f"  {name}: {gtype.name} {nbytes} B", file=sys.stderr)
        raw.flush()
        raw.close()
    return {"tensors": n_tensors, "order": order}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="tpullm-torch-gguf-convert-endian",
        description="Convert a GGUF file between little- and big-endian "
                    "(≡ gguf_convert_endian.py)")
    ap.add_argument("model")
    ap.add_argument("order", choices=["big", "little", "native"])
    ap.add_argument("-o", "--output", help="write here instead of in-place")
    ap.add_argument("-q", "--quiet", action="store_true")
    args = ap.parse_args(argv)
    order = args.order
    if order == "native":
        order = "big" if sys.byteorder == "big" else "little"
    out = args.output or args.model
    res = convert_endian(args.model, out, order, verbose=not args.quiet)
    print(f"{out}: {res['tensors']} tensors -> {order}-endian"
          + (" (no-op)" if res.get("noop") else ""))
    return 0


if __name__ == "__main__":
    sys.exit(main())
