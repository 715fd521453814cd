"""Build and load the port's CUDA kernels at first use.

Each ``<name>/<name>.cu`` under ``kernels/`` has a plain C interface.  On
first use every source is compiled by its own ``nvcc`` process, all started
together, into ``build/kernels/lib<name>.so`` at the repo root (for
``sm_90a``), and loaded with ``ctypes``.  A library newer than its source is
reused.  The compiler's report (``-Xptxas -v``: registers, shared memory,
spills) is kept beside each library as ``lib<name>.log``.

There is no fallback: a failed build raises, naming the compiler output.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time
from pathlib import Path

KERNEL_DIR = Path(__file__).resolve().parent
BUILD_DIR = KERNEL_DIR.parents[2] / "build" / "kernels"
SOURCES = {name: KERNEL_DIR / name / f"{name}.cu"
           for name in ("coalesced_gather", "segment_merge", "iru_reorder")}
NVCC_FLAGS = ["-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(
            f"cannot build the CUDA kernels: no nvcc on PATH or at {path}")
    return str(path)


def _stale(name: str) -> bool:
    lib = BUILD_DIR / f"lib{name}.so"
    return (not lib.exists()
            or lib.stat().st_mtime < SOURCES[name].stat().st_mtime)


def build() -> float:
    """Compile the stale libraries in parallel; returns the seconds taken."""
    todo = [name for name in SOURCES if _stale(name)]
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = {}
    for name in todo:
        tmp = BUILD_DIR / f"lib{name}.so.tmp{os.getpid()}"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        (BUILD_DIR / f"lib{name}.log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, BUILD_DIR / f"lib{name}.so")
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return time.perf_counter() - t0


def require_built() -> None:
    """Raise unless every library is built and newer than its source.  The
    ranks of a process group only load the kernels: one build before they
    start (``python -m repro_torch.kernels._build``, or the partitioned
    launcher's ``--nproc``) spares them as many concurrent ``nvcc`` runs."""
    stale = [name for name in SOURCES if _stale(name)]
    if stale:
        raise RuntimeError(
            f"kernels {stale} are not built or older than their sources: "
            f"build them once before starting the ranks (python -m "
            f"repro_torch.kernels._build)")


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, building all kernels first if
    any is missing or older than its source."""
    if name not in _libs:
        build()
        _libs[name] = ctypes.CDLL(str(BUILD_DIR / f"lib{name}.so"))
    return _libs[name]


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise on a nonzero cudaError_t code returned by a launch function."""
    if code != 0:
        lib.iru_error_string.restype = ctypes.c_char_p
        lib.iru_error_string.argtypes = [ctypes.c_int]
        msg = lib.iru_error_string(code).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {code} ({msg})")


if __name__ == "__main__":
    print(f"built in {build():.1f} s into {BUILD_DIR}")
