"""Builds the port's CUDA kernels with nvcc and loads them through ctypes.

Each source under ``kubernetes_gpu_cluster_tpu_torch/csrc/`` compiles on its
own into ``lib<name>.so`` in the kernel directory (one ``nvcc`` per source,
all started together) for ``sm_90a``, with a plain C interface: no PyTorch
headers, so a build takes seconds. The kernel directory is
``KGCT_KERNEL_DIR``, read at every build or load, else ``build/kernels``
beside the package.

Each library has a stamp beside it, ``lib<name>.so.sha256``: the sha256 of
the source, of every shared header and of ``NVCC_FLAGS``. A library is
current when its stamp matches the sources in the package, whatever the
files' times say, so libraries built ahead of time (a serving image's
kernel stage) load where no ``nvcc`` exists. A missing or stale library is
built at first use; with no ``nvcc`` that raises. The build also keeps
ptxas's report of each entry function (registers, shared memory, stack,
spills) beside the library, ``lib<name>.so.ptxas.json``, so it can be read
when the library is current.

    python -m kubernetes_gpu_cluster_tpu_torch.ops.cuda.build

builds every stale kernel into the kernel directory and prints each one's
seconds and ptxas register lines, and every kernel's kept ptxas report. It needs no card: nvcc cross-compiles
``sm_90a``. Nothing here runs at import: the CPU tests import every module.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
import threading
import time
from pathlib import Path

from ...utils import get_logger

logger = get_logger("ops.cuda.build")

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC = PACKAGE_DIR / "csrc"
DEFAULT_KERNEL_DIR = PACKAGE_DIR.parent / "build" / "kernels"
KERNEL_DIR_ENV = "KGCT_KERNEL_DIR"
KERNELS = ("paged_decode", "flash_prefill", "flash_prefill_hist", "int4_matmul",
           "spec_verify", "graph_gate")
# -split-compile=0: nvcc optimizes a source's device functions in parallel
# threads, one per core (a source is several kernels' instantiations); the
# libraries and ptxas's report are those of a serial build.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-lineinfo", "-Xptxas", "-v", "-split-compile=0", "-shared",
              "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# nvcc's output (ptxas register/shared-memory report) and wall seconds per
# kernel built in this process.
build_log: dict[str, str] = {}
build_seconds: dict[str, float] = {}


def kernel_dir() -> Path:
    """Where the libraries and their stamps live: ``KGCT_KERNEL_DIR``, else
    ``build/kernels`` beside the package."""
    return Path(os.environ.get(KERNEL_DIR_ENV) or DEFAULT_KERNEL_DIR)


def nvcc_path() -> str:
    """nvcc under ``CUDA_HOME`` or ``CUDA_PATH``, else on ``PATH``."""
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError("nvcc not found on PATH, CUDA_HOME or CUDA_PATH")


def library_path(name: str) -> Path:
    return kernel_dir() / f"lib{name}.so"


def stamp_path(name: str) -> Path:
    return kernel_dir() / f"lib{name}.so.sha256"


def ptxas_path(name: str) -> Path:
    return kernel_dir() / f"lib{name}.so.ptxas.json"


def ptxas_of(name: str) -> list[dict] | None:
    """The ptxas report kept by the build of ``name``'s library (see
    ``ptxas_report``), None when there is none."""
    try:
        return json.loads(ptxas_path(name).read_text())
    except FileNotFoundError:
        return None


def source_digest(name: str) -> str:
    """sha256 of ``<name>.cu``, every ``csrc/*.cuh`` in name order and
    ``NVCC_FLAGS``: what a library built from these sources is stamped
    with."""
    h = hashlib.sha256()
    for path in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        data = path.read_bytes()
        h.update(f"{path.name}\0{len(data)}\0".encode())
        h.update(data)
    h.update("\0".join(NVCC_FLAGS).encode())
    return h.hexdigest()


def stale(name: str) -> bool:
    """True when the library, its stamp, or their agreement with the
    sources is missing."""
    lib, stamp = library_path(name), stamp_path(name)
    if not lib.is_file() or not stamp.is_file():
        return True
    return stamp.read_text().strip() != source_digest(name)


def _compile(nvcc: str, name: str, out_dir: Path) -> tuple:
    """Start nvcc on ``name`` into a temp file of this process; a thread
    collects its output and the seconds until it ended."""
    tmp = out_dir / f"lib{name}.so.tmp{os.getpid()}"
    proc = subprocess.Popen(
        [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
         str(CSRC / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    done: dict = {}
    t0 = time.perf_counter()

    def wait():
        done["out"] = proc.communicate()[0]
        done["s"] = time.perf_counter() - t0
    waiter = threading.Thread(target=wait, daemon=True)
    waiter.start()
    return tmp, proc, waiter, done


def build(names=KERNELS) -> float:
    """Compile every stale kernel of ``names`` in parallel; returns the
    build's wall seconds (0 when all were current). Raises RuntimeError
    with nvcc's output when any compile fails, and when one is stale and no
    nvcc exists."""
    with _lock:
        todo = [n for n in names if stale(n)]
        if not todo:
            return 0.0
        out_dir = kernel_dir()
        try:
            nvcc = nvcc_path()
        except RuntimeError as e:
            raise RuntimeError(
                f"kernel {', '.join(todo)}: no library with a current stamp "
                f"in {out_dir} ({KERNEL_DIR_ENV}={os.environ.get(KERNEL_DIR_ENV)!r}"
                f") and {e}; build them ahead of time with `python -m "
                f"{__spec__.name}` into that directory") from None
        out_dir.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        jobs = {n: _compile(nvcc, n, out_dir) for n in todo}
        failed = []
        for n, (tmp, proc, waiter, done) in jobs.items():
            waiter.join()
            build_log[n], build_seconds[n] = done["out"], done["s"]
            if proc.returncode != 0:
                failed.append(f"--- {n} (exit {proc.returncode}) ---\n"
                              f"{done['out']}")
                tmp.unlink(missing_ok=True)
                continue
            # The library, its ptxas report, then its stamp, each by
            # rename: a reader never pairs a new stamp with an old library.
            os.replace(tmp, library_path(n))
            for path, text in (
                    (ptxas_path(n), json.dumps(ptxas_report(done["out"]))),
                    (stamp_path(n), source_digest(n) + "\n")):
                part = Path(f"{path}.tmp{os.getpid()}")
                part.write_text(text)
                os.replace(part, path)
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


_PTXAS = (("function", re.compile(r"Compiling entry function '([^']+)'")),
          ("stack", re.compile(r"(\d+) bytes stack frame")),
          ("spill_stores", re.compile(r"(\d+) bytes spill stores")),
          ("spill_loads", re.compile(r"(\d+) bytes spill loads")),
          ("registers", re.compile(r"Used (\d+) registers")),
          ("smem", re.compile(r"(\d+) bytes smem")))


def ptxas_report(log: str) -> list[dict]:
    """Each entry function of nvcc's ``-Xptxas -v`` output with its
    registers, static shared memory, stack and spill bytes."""
    funcs: list[dict] = []
    for line in log.splitlines():
        for key, pattern in _PTXAS:
            m = pattern.search(line)
            if not m:
                continue
            if key == "function":
                funcs.append({"function": m.group(1)})
            elif funcs:
                funcs[-1][key] = int(m.group(1))
    return funcs


def main() -> int:
    """Build every kernel of ``KERNELS`` into the kernel directory; print
    each built one's seconds and ptxas register lines, and for every
    kernel, current ones too, a JSON line of its kept ptxas report (each
    entry function's registers, shared memory and spills; null if none
    was kept)."""
    todo = [n for n in KERNELS if stale(n)]
    try:
        seconds = build(todo)
    except RuntimeError as e:
        print(f"kernel build failed: {e}", file=sys.stderr)
        return 1
    print(f"kernel dir {kernel_dir()}", flush=True)
    for n in KERNELS:
        if n not in todo:
            print(f"{n}: current", flush=True)
        else:
            print(f"{n}: built in {build_seconds[n]:.1f} s", flush=True)
            for line in build_log[n].splitlines():
                if "registers" in line:
                    print(f"  [{n}] {line.strip()}", flush=True)
        print(f"  [{n}] ptxas: {json.dumps(ptxas_of(n))}", flush=True)
    print(f"built in {seconds:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
