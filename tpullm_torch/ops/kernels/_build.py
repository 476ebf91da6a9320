"""Build and load the port's CUDA kernels.

Each library compiles one `csrc/<source>.cu` with nvcc into a shared library
with a plain C interface, `build/tpullm_torch/lib<name>-<digest>.so` under
the repository root, bound with ctypes. The qmm sources build once per plane
format family (`-DTPULLM_QMM_FAMILY=f`, the formats of csrc/qmm_body.cuh's
TPULLM_QMM_FORMATS), so their many instantiations compile in parallel. The
digest covers the sources and flags, so an edited kernel rebuilds and a stale
library is never loaded. The build runs at first use; `build()` starts one
nvcc per library, all at once.

`counters` is the int32 buffer, one per stream, by which the last block of
a group of blocks that split one output (the K split of the gemv body:
qmm and qmm_grouped at M < 16, qmm_gather; flash's key splits at decode)
finds itself; each such block resets its counter, so
the buffer is all zero between launches on its stream. Launches on two
streams at once each get their own buffer. A kernel that faults part way
leaves counts behind, but a fault on the card is sticky: the CUDA context
refuses every later launch, so no call reads a stale count.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "tpullm_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
QMM_FAMILIES = 13  # format families of csrc/qmm_body.cuh
COUNTERS = 1 << 16  # int32 entries of a stream's counter buffer

# library name → (source in csrc/, its own nvcc flags)
LIBRARIES = {f"{src}{f}": (f"{src}.cu", (f"-DTPULLM_QMM_FAMILY={f}",))
             for src in ("qmm", "qmm_moe") for f in range(QMM_FAMILIES)}
LIBRARIES["flash"] = ("flash.cu", ())
LIBRARIES["flash_narrow"] = ("flash.cu", ("-DTPULLM_FLASH_NARROW",))  # head dims 80 and 96
LIBRARIES["flash_dkdv"] = ("flash.cu", ("-DTPULLM_FLASH_DKDV",))  # Dk ≠ Dv: (192, 128), (96, 64)
LIBRARIES["flash_latent"] = ("flash.cu", ("-DTPULLM_FLASH_LATENT",))  # the MLA latent form
KERNELS = tuple(LIBRARIES)


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                           "the CUDA toolkit is installed")
    return path


def _digest(name: str) -> str:
    source, flags = LIBRARIES[name]
    h = hashlib.sha256(" ".join(NVCC_FLAGS + flags).encode())
    for src in [CSRC / source, *sorted(CSRC.glob("*.cuh"))]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{_digest(name)}.so"


def _compile(name: str) -> tuple[str, float, str | None]:
    """One nvcc into a temporary file, moved into place on success (atomic:
    concurrent builders never see a torn library). Returns (report, seconds,
    failure or None)."""
    source, flags = LIBRARIES[name]
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
    os.close(fd)
    cmd = [nvcc(), *NVCC_FLAGS, *flags, "-I", str(CSRC), "-o", tmp, str(CSRC / source)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode == 0:
        os.replace(tmp, library_path(name))
        return proc.stdout, seconds, None
    os.unlink(tmp)
    return proc.stdout, seconds, f"{name} ({source}, nvcc exit {proc.returncode}):\n{proc.stdout}"


def build(names=KERNELS) -> dict[str, tuple[str, float]]:
    """Compile every named library that is not built yet, one nvcc process
    per library, all started together. Returns, per library, nvcc's
    `-Xptxas -v` report (registers, shared memory, spills) and its compile
    seconds; ("", 0.0) for one already built. Raises if any compile fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = [name for name in names if not library_path(name).exists()]
    out = {name: ("", 0.0) for name in names}
    failed = []
    if todo:
        with ThreadPoolExecutor(max_workers=len(todo)) as pool:
            for name, (report, seconds, fail) in zip(todo, pool.map(_compile, todo)):
                out[name] = (report, seconds)
                if fail:
                    failed.append(fail)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return out


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


_COUNTER_BUFFERS: dict = {}  # (device, stream handle) → int32 [COUNTERS]


@functools.cache
def n_sm(device) -> int:
    """The streaming multiprocessors of CUDA `device`."""
    import torch

    return torch.cuda.get_device_properties(device).multi_processor_count


def counters(device, stream: int, n: int):
    """The zeroed int32 counter buffer of CUDA stream `stream` (its handle)
    on `device`, made at the stream's first launch, which holds the n
    counters of one launch. A CUDA graph captures the buffer of its capture
    stream: launch on that stream once before capturing."""
    if n > COUNTERS:
        raise ValueError(f"a launch needs {n} counters, the buffer holds {COUNTERS}")
    buf = _COUNTER_BUFFERS.get((device, stream))
    if buf is None:
        import torch

        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("the counter buffer of a stream is made outside graph "
                               "capture: launch on the capture stream once before capturing")
        buf = _COUNTER_BUFFERS[(device, stream)] = torch.zeros(COUNTERS, dtype=torch.int32,
                                                               device=device)
    return buf


def check(rc: int, what: str) -> None:
    """Raise on a nonzero cudaError_t from a launch."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")
