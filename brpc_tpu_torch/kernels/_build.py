"""Builds and loads the port's hand-written CUDA kernels.

Every `csrc/*.cu` is compiled for sm_90a by its own `nvcc` process (all
started together), and the objects are linked into
`build_torch/kernels/libbrpc_tpu_torch_kernels.so`, which is loaded with
ctypes. Each source exports plain C entry points that take raw device
pointers and a stream and return `cudaGetLastError()`.

Nothing happens at import time: `lib()` builds at first use, under a
file lock, and rebuilds when the library is stale: older than any
`csrc/*.cu` or shared `csrc/*.cuh`, or built with other flags than
`NVCC_FLAGS` (kept in a stamp file beside the library). A failed build
raises.
"""
from __future__ import annotations

import ctypes
import fcntl
import json
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build_torch" / "kernels"
SO = BUILD_DIR / "libbrpc_tpu_torch_kernels.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC"]

STAMP = BUILD_DIR / (SO.name + ".flags")
PTXAS = BUILD_DIR / "ptxas.txt"  # nvcc's -Xptxas -v lines of the last build

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
# C entry point -> argtypes (restype is int, the cudaError_t).
_ENTRY_POINTS = {
    "brpc_tpu_torch_adler_frame_checksum": [
        _P, _P, _I64, _I64, ctypes.c_int, ctypes.c_int, _I64, _I64, _I64,
        _P, _I64, _P],
    "brpc_tpu_torch_integrity_word": [_P, _P, _I64, _P],
    "brpc_tpu_torch_integrity_word_cluster": [],
}

_LIB = None


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return nvcc


def stale(so: Path, stamp: Path, csrc: Path, flags: list) -> bool:
    """True when `so` must be rebuilt: it is missing, a source or header
    in `csrc` is newer, or `stamp` does not hold exactly `flags`."""
    if not so.exists() or not stamp.exists():
        return True
    if stamp.read_text() != json.dumps(flags):
        return True
    inputs = list(csrc.glob("*.cu")) + list(csrc.glob("*.cuh"))
    return any(f.stat().st_mtime > so.stat().st_mtime for f in inputs)


def build() -> dict:
    """Compile the kernels if the library is missing or stale. Returns
    {"so", "built", "seconds", "ptxas"}: ptxas holds nvcc's
    `-Xptxas -v` function, register, shared-memory and spill lines of
    the build that made the library."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    sources = sorted(CSRC.glob("*.cu"))
    t0 = time.monotonic()
    with open(BUILD_DIR / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not stale(SO, STAMP, CSRC, NVCC_FLAGS):
            ptxas = PTXAS.read_text().splitlines() if PTXAS.exists() else []
            return {"so": str(SO), "built": False, "seconds": 0.0,
                    "ptxas": ptxas}
        nvcc = _nvcc()
        procs = []
        for src in sources:
            obj = BUILD_DIR / (src.stem + ".o")
            procs.append((src, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", str(src),
                 "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        ptxas, objs = [], []
        for src, proc in procs:
            out, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src.name}:\n{out}")
            ptxas += [f"{src.name}: {ln.strip()}" for ln in out.splitlines()
                      if "Compiling entry" in ln or "registers" in ln
                      or "spill" in ln]
            objs.append(str(BUILD_DIR / (src.stem + ".o")))
        tmp = BUILD_DIR / (SO.name + ".tmp")
        link = subprocess.run([nvcc, "-shared", "-o", str(tmp), *objs],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
        os.replace(tmp, SO)
        STAMP.write_text(json.dumps(NVCC_FLAGS))
        PTXAS.write_text("\n".join(ptxas))
    return {"so": str(SO), "built": True,
            "seconds": time.monotonic() - t0, "ptxas": ptxas}


def lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        build()
        L = ctypes.CDLL(str(SO))
        for name, argtypes in _ENTRY_POINTS.items():
            fn = getattr(L, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIB = L
    return _LIB


def launch(name: str, *args) -> None:
    """Call one C entry point; raise if the launch reported an error."""
    rc = getattr(lib(), name)(*args)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")
