"""Build and load the port's CUDA kernels.

Each `csrc/<name>.cu` compiles with nvcc into a shared library with a plain C
interface, `build/tpullm_torch/lib<name>-<digest>.so` under the repository
root, bound with ctypes. The digest covers the sources and flags, so an edited
kernel rebuilds and a stale library is never loaded. The build runs at first
use; `build()` starts one nvcc per source, all at once.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "tpullm_torch"
KERNELS = ("qmm", "qmm_moe", "flash")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                           "the CUDA toolkit is installed")
    return path


def _digest(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{_digest(name)}.so"


def build(names=KERNELS) -> dict[str, str]:
    """Compile every named kernel that is not built yet, one nvcc process
    per source, all started together. Returns nvcc's `-Xptxas -v` report
    (registers, shared memory, spills) per kernel; "" for one already built.
    Raises if any compile fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        lib = library_path(name)
        if lib.exists():
            continue
        fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
        os.close(fd)
        cmd = [nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", tmp, str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), tmp, lib)
    reports = {name: "" for name in names}
    failed = []
    for name, (proc, tmp, lib) in procs.items():
        reports[name] = proc.communicate()[0]
        if proc.returncode == 0:
            os.replace(tmp, lib)  # atomic: concurrent builders never see a torn file
        else:
            os.unlink(tmp)
            failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{reports[name]}")
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return reports


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The kernel library `name`, built first if needed."""
    build((name,))
    return ctypes.CDLL(str(library_path(name)))


@functools.cache
def bind(name: str, symbol: str, argtypes: tuple) -> ctypes._CFuncPtr:
    """The C entry `symbol` of kernel library `name`, with its argument
    types declared (each pointer and the stream a c_void_p)."""
    fn = getattr(load(name), symbol)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def check(rc: int, what: str) -> None:
    """Raise on a nonzero cudaError_t from a launch."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")
