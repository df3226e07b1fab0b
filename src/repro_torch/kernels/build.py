"""Builds the port's CUDA kernels at first use and binds them with ctypes.

Every ``*.cu`` under ``kernels/csrc/`` is compiled by ``nvcc`` for
``sm_90a`` into its own shared library with a plain C interface, one
``nvcc`` process per source, all started together.  The libraries go to
``build/torch_kernels/`` at the repository root (git-ignored), named by
a hash of the source and the flags, so an unchanged source is built
once per checkout and an edited one is rebuilt.

Why ``nvcc`` + ``ctypes`` and not ``torch.utils.cpp_extension.load``: a
source that includes PyTorch's headers takes minutes to compile, a
plain C interface seconds, and a fresh machine rebuilds every time.
The wrappers pass ``data_ptr()`` pointers and the current stream's
handle; each C entry point launches on that stream and returns
``cudaGetLastError()``, which the wrapper turns into an exception.

Nothing here runs at import time: the tests import every module on
machines without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-lineinfo",
    "-Xptxas=-v",
    "-shared",
    "-Xcompiler",
    "-fPIC",
)

_lock = threading.Lock()
_libs: dict = {}
# compiler output of the last build (ptxas register/smem report)
build_log: dict = {}
build_seconds: float | None = None


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is not None:
        cand = Path(CUDA_HOME) / "bin" / "nvcc"
        if cand.exists():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found: the CUDA kernels are built on a machine with "
            "the CUDA toolkit (set CUDA_HOME or put nvcc on PATH)"
        )
    return found


def _target(src: Path) -> Path:
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:16]}.so"


def build_all() -> dict:
    """Compile every stale ``csrc/*.cu`` in parallel; returns
    {stem: library path}.  Raises with the compiler's output if any
    source fails to build."""
    global build_seconds
    t0 = time.perf_counter()
    sources = sorted(CSRC.glob("*.cu"))
    targets = {src.stem: _target(src) for src in sources}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for src in sources:
        dst = targets[src.stem]
        if dst.exists():
            continue
        tmp = dst.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs.append((src.stem, dst, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True,
        )))
    failed = []
    for stem, dst, tmp, proc in procs:
        out, _ = proc.communicate()
        build_log[stem] = out
        if proc.returncode != 0:
            failed.append(f"--- {stem}.cu (rc {proc.returncode}) ---\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, dst)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    build_seconds = time.perf_counter() - t0
    return targets


def load_library(stem: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<stem>.cu`` (building every
    kernel on first use; no lock once it is loaded)."""
    lib = _libs.get(stem)
    if lib is not None:
        return lib
    with _lock:
        if stem not in _libs:
            targets = build_all()
            for name, path in targets.items():
                _libs[name] = _bind(name, ctypes.CDLL(str(path)))
        return _libs[stem]


def _bind(stem: str, lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i = ctypes.c_void_p, ctypes.c_int
    if stem == "xnor_gemm":
        lib.xnor_gemm_launch.argtypes = [p, p, p] + [i] * 10 + [p]
        lib.xnor_gemm_launch.restype = i
        lib.xnor_mma_probe_launch.argtypes = [p, i, i, p]
        lib.xnor_mma_probe_launch.restype = i
    elif stem == "segment_fused":
        lib.segment_fused_launch.argtypes = (
            [p] * 5 + [i] * 7 + [ctypes.POINTER(i), p])
        lib.segment_fused_launch.restype = i
    elif stem == "flash_attention":
        lib.flash_attention_launch.argtypes = (
            [p] * 5 + [i] * 7 + [ctypes.c_longlong] * 12
            + [ctypes.c_float, i, i, p])
        lib.flash_attention_launch.restype = i
    err = getattr(lib, f"{stem}_error_string")
    err.argtypes = [i]
    err.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, stem: str, rc: int) -> None:
    """Raise if a launch entry point returned a CUDA error code."""
    if rc != 0:
        msg = getattr(lib, f"{stem}_error_string")(rc).decode()
        raise RuntimeError(f"{stem} launch failed: CUDA error {rc} ({msg})")
