"""Build the port's CUDA kernels from `csrc/` and bind them with ctypes.

At first use, `nvcc` compiles every `csrc/*.cu` for sm_90a, one process per
source, all started together, and links the objects into one shared library
with a plain C interface in `_build/` (listed in .gitignore). The library's
name carries a hash of the sources and flags, so an edited source rebuilds
and an unchanged one is reused. Nothing here runs at import time.
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
GENCODE = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*GENCODE, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signatures of csrc/*.cu: every pointer and the stream are c_void_p
_SIGNATURES = {
    "smoqy_mtm_stamp_slots": [],
    "smoqy_mtm_row_ld": [_I, _I],
    "smoqy_mtm_smem_bytes": [_I, _I, _I],
    "smoqy_mtm_resident": [_I, _I, _I, _I],
    "smoqy_mtm_f32": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P],
    "smoqy_mtm_f64": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P],
    "smoqy_pcg_grid": [_I],
    "smoqy_pcg_max_grid": [],
    "smoqy_pcg_max_systems": [],
    "smoqy_pcg_stamps_per_iteration": [],
    "smoqy_pcg": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                  _I, _I, _I, _I, _I, _I, _I, _F, _I, _P, _P],
    "smoqy_pcg_force_grid": [_I, _I],
    "smoqy_pcg_force_smem_bytes": [_I, _I],
    "smoqy_pcg_force_stamps_per_iteration": [],
    "smoqy_pcg_force": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                        _I, _I, _I, _I, _I, _I, _I, _F, _I, _I, _P, _P],
    "smoqy_force_row_ld": [_I],
    "smoqy_force_smem_bytes": [_I, _I, _I],
    "smoqy_force_resident": [_I, _I, _I, _I, _I],
    "smoqy_force": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P],
    "smoqy_kpm_mf_max_sites": [_I, _I],
    "smoqy_kpm_mf_cluster_fits": [_I, _I, _I, _I, _I, _I, _I],
    "smoqy_kpm_mf": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _F, _I, _I, _I, _I, _I, _I, _I, _I, _P],
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
    nvcc = _nvcc()
    tag = f"{out.stem}.tmp{os.getpid()}"
    t0 = time.perf_counter()
    sources = sorted(CSRC.glob("*.cu"))
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in sources]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)], cwd=str(CSRC),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(sources, objs)]
    logs = [proc.communicate()[0] for proc in procs]
    failed = [(src.name, proc.returncode, log) for src, proc, log in zip(sources, procs, logs) if proc.returncode]
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(f"{name} ({rc}):\n{log}" for name, rc, log in failed))
    tmp = BUILD_DIR / f"{tag}.so"
    link = subprocess.run([nvcc, *GENCODE, "-shared", "-o", str(tmp), *[str(o) for o in objs]], capture_output=True,
                          text=True, cwd=str(CSRC))
    seconds = time.perf_counter() - t0
    for obj in objs:
        obj.unlink()
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{link.stdout}\n{link.stderr}")
    os.replace(tmp, out)
    log = "".join(logs) + link.stdout + link.stderr
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
    for name in ("smoqy_pcg_phases", "smoqy_pcg_force_phases", "smoqy_pcg_force_once_phases"):
        fn = getattr(lib, name)
        fn.argtypes = []
        fn.restype = ctypes.c_char_p
    return lib


def check(rc: int, what: str) -> None:
    """Raise on a nonzero cudaError_t returned by a launch."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")
