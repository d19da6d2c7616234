"""Builds the port's CUDA kernels with nvcc and loads them through ctypes.

Each source under ``kubernetes_gpu_cluster_tpu_torch/csrc/`` compiles on its
own into ``build/kernels/lib<name>.so`` beside the package (one ``nvcc``
per source, all started together) for ``sm_90a``, with a plain C interface:
no PyTorch headers, so a build takes seconds. Builds run at first use and
again only when a source or the shared header is newer than its library.
Nothing here runs at import: the CPU tests import every module.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

from ...utils import get_logger

logger = get_logger("ops.cuda.build")

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "kernels"
KERNELS = ("paged_decode", "flash_prefill", "flash_prefill_hist", "int4_matmul",
           "spec_verify")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-lineinfo", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# nvcc's output (ptxas register/shared-memory report) per kernel built in
# this process.
build_log: dict[str, str] = {}


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([str(Path(home) / "bin" / "nvcc")] if home else []) + [
            "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""]:
        if cand and Path(cand).is_file():
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                       "build from source at first use")


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    lib = library_path(name)
    if not lib.exists():
        return True
    newest = max(p.stat().st_mtime for p in
                 [CSRC / f"{name}.cu", *CSRC.glob("*.cuh")])
    return lib.stat().st_mtime < newest


def build(names=KERNELS) -> float:
    """Compile every stale kernel of ``names`` in parallel; returns the
    build's wall seconds (0 when all were current). Raises RuntimeError
    with nvcc's output when any compile fails."""
    with _lock:
        todo = [n for n in names if _stale(n)]
        if not todo:
            return 0.0
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = nvcc_path()
        t0 = time.perf_counter()
        procs = {}
        for n in todo:
            tmp = BUILD_DIR / f"lib{n}.so.tmp{os.getpid()}"
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
                   str(CSRC / f"{n}.cu")]
            procs[n] = (tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        failed = []
        for n, (tmp, proc) in procs.items():
            out, _ = proc.communicate()
            build_log[n] = out
            if proc.returncode != 0:
                failed.append(f"--- {n} (exit {proc.returncode}) ---\n{out}")
            else:
                os.replace(tmp, library_path(n))
        seconds = time.perf_counter() - t0
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        logger.info("built %s in %.1f s", ", ".join(todo), seconds)
        return seconds


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name``, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        build((name,))
        with _lock:
            lib = _libs.get(name)
            if lib is None:
                lib = _libs[name] = ctypes.CDLL(str(library_path(name)))
    return lib


def check_status(lib: ctypes.CDLL, name: str, code: int) -> None:
    """Raise with CUDA's message when a launch returned an error."""
    if code != 0:
        err = getattr(lib, f"kgct_{name}_error")
        err.restype = ctypes.c_char_p
        err.argtypes = [ctypes.c_int]
        raise RuntimeError(f"{name} kernel launch failed: "
                           f"{err(code).decode()} (cudaError {code})")
