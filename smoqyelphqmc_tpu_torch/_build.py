"""Build the port's CUDA kernels from `csrc/` and bind them with ctypes.

`nvcc` compiles every `csrc/*.cu` for sm_90a into one shared library with a
plain C interface, at first use, into `_build/` (listed in .gitignore). The
library's name carries a hash of the sources and flags, so an edited source
rebuilds and an unchanged one is reused. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signatures of csrc/*.cu: every pointer and the stream are c_void_p
_SIGNATURES = {
    "smoqy_mtm_f32": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "smoqy_mtm_f64": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "smoqy_pcg_grid": [_I],
    "smoqy_pcg_max_grid": [],
    "smoqy_pcg_max_systems": [],
    "smoqy_pcg": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                  _I, _I, _I, _I, _I, _I, _I, _F, _I, _P],
}


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources():
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")
    return found


def library_path() -> Path:
    return BUILD_DIR / f"libsmoqy_kernels_{source_hash()}.so"


def build() -> dict:
    """Compile the kernels if the library for these sources is missing.

    Returns {"path", "seconds", "built", "log"}; `log` holds nvcc's ptxas
    report (registers, shared memory, spills) when it compiled."""
    out = library_path()
    if out.exists():
        return {"path": str(out), "seconds": 0.0, "built": False, "log": ""}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".tmp{os.getpid()}.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *[str(p) for p in sorted(CSRC.glob("*.cu"))]]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, cwd=str(CSRC))
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    log = proc.stdout + proc.stderr
    (BUILD_DIR / f"{out.stem}.log").write_text(log)
    return {"path": str(out), "seconds": seconds, "built": True, "log": log}


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, with declared signatures."""
    lib = ctypes.CDLL(build()["path"])
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(rc: int, what: str) -> None:
    """Raise on a nonzero cudaError_t returned by a launch."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")
