"""The kernel loader (``ops/cuda/build.py``) on the CPU, with no ``nvcc``.

Libraries are trusted by the content they were built from: a stamp beside
each ``lib<name>.so`` holds the sha256 of its source, the shared headers and
``NVCC_FLAGS``. These cases point the kernel directory (``KGCT_KERNEL_DIR``)
and a copy of ``csrc/`` at a temp dir, make ``nvcc_path`` raise, and hold
what counts as current, what as stale, and what a stale library with no
``nvcc`` does. A stand-in ``nvcc`` (a Python script that writes its ``-o``
file) drives the build path itself: the library, its ptxas report and its
stamp, the per-kernel seconds and register lines of the command line, a
failed compile. The split wrappers' calls from two threads with one launch
key each pass the kernel their own stream's workspace and counters.
"""

from __future__ import annotations

import ctypes
import json
import os
import shutil
import stat
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from kubernetes_gpu_cluster_tpu_torch.ops.cuda import build

REPO = Path(__file__).resolve().parent.parent

FAKE_NVCC = """#!{python}
import sys
args = sys.argv[1:]
src = args[-1]
if "FAIL" in open(src).read():
    print("error: a compile error in " + src)
    sys.exit(2)
with open(args[args.index("-o") + 1], "wb") as f:
    f.write(b"\\x7fELF fake " + src.encode())
print("ptxas info    : Compiling entry function 'kgct_fake' for 'sm_90a'")
print("    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads")
print("ptxas info    : Used 42 registers, 0 bytes smem")
"""

FAKE_REPORT = [{"function": "kgct_fake", "stack": 0, "spill_stores": 0,
                "spill_loads": 0, "registers": 42, "smem": 0}]


def _no_nvcc():
    raise RuntimeError("nvcc not found on PATH, CUDA_HOME or CUDA_PATH")


@pytest.fixture
def kdir(tmp_path, monkeypatch):
    """The kernel directory (empty) and a private copy of ``csrc/``; nvcc
    absent."""
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    monkeypatch.setattr(build, "CSRC", csrc)
    monkeypatch.setattr(build, "nvcc_path", _no_nvcc)
    for table in ("_libs", "build_log", "build_seconds"):
        monkeypatch.setattr(build, table, {})
    out = tmp_path / "kernels"
    monkeypatch.setenv("KGCT_KERNEL_DIR", str(out))
    return out


def _current(name: str) -> None:
    """A library of ``name`` and the stamp of the sources as they are."""
    build.kernel_dir().mkdir(parents=True, exist_ok=True)
    build.library_path(name).write_bytes(b"\x7fELF prebuilt")
    build.stamp_path(name).write_text(build.source_digest(name) + "\n")


@pytest.fixture
def fake_nvcc(tmp_path, monkeypatch):
    path = tmp_path / "bin" / "nvcc"
    path.parent.mkdir()
    path.write_text(FAKE_NVCC.format(python=sys.executable))
    path.chmod(path.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setattr(build, "nvcc_path", lambda: str(path))
    return path


def test_an_empty_directory_is_stale(kdir):
    assert not kdir.exists()
    assert all(build.stale(n) for n in build.KERNELS)


@pytest.mark.parametrize("name", build.KERNELS)
def test_a_library_with_its_stamp_is_current_without_nvcc(kdir, name):
    _current(name)
    assert not build.stale(name)
    assert build.build((name,)) == 0.0


def test_every_library_current_builds_nothing(kdir):
    for n in build.KERNELS:
        _current(n)
    assert build.build() == 0.0


def test_a_library_without_its_stamp_is_stale(kdir):
    _current("paged_decode")
    build.stamp_path("paged_decode").unlink()
    assert build.stale("paged_decode")


def test_a_stamp_without_its_library_is_stale(kdir):
    _current("paged_decode")
    build.library_path("paged_decode").unlink()
    assert build.stale("paged_decode")


def test_touching_a_source_leaves_the_library_current(kdir):
    _current("flash_prefill")
    future = time.time() + 3600
    for src in [build.CSRC / "flash_prefill.cu",
                *build.CSRC.glob("*.cuh")]:
        os.utime(src, (future, future))
    assert not build.stale("flash_prefill")
    assert build.build(("flash_prefill",)) == 0.0


@pytest.mark.parametrize("source", ["paged_decode.cu", "flash_mma.cuh",
                                    "flash_tile.cuh"])
def test_one_changed_byte_makes_it_stale(kdir, source):
    _current("paged_decode")
    path = build.CSRC / source
    data = bytearray(path.read_bytes())
    data[len(data) // 2] ^= 0x01
    path.write_bytes(bytes(data))
    assert build.stale("paged_decode")


def test_a_changed_flag_makes_it_stale(kdir, monkeypatch):
    _current("int4_matmul")
    monkeypatch.setattr(build, "NVCC_FLAGS",
                        tuple(f.replace("-O3", "-O2")
                              for f in build.NVCC_FLAGS))
    assert build.stale("int4_matmul")


def test_another_kernels_source_leaves_it_current(kdir):
    _current("paged_decode")
    (build.CSRC / "spec_verify.cu").write_text("// changed\n")
    assert not build.stale("paged_decode")


@pytest.mark.parametrize("prepare", ["empty", "stale-stamp"])
def test_stale_with_no_nvcc_raises_naming_kernel_and_directory(kdir,
                                                               prepare):
    if prepare == "stale-stamp":
        _current("paged_decode")
        build.stamp_path("paged_decode").write_text("0" * 64 + "\n")
    with pytest.raises(RuntimeError) as exc:
        build.library("paged_decode")
    msg = str(exc.value)
    assert "paged_decode" in msg and str(kdir) in msg
    assert "KGCT_KERNEL_DIR" in msg and "nvcc not found" in msg
    assert "paged_decode" not in build._libs


def test_kernel_dir_set_after_import_is_honoured(tmp_path, monkeypatch):
    monkeypatch.delenv("KGCT_KERNEL_DIR", raising=False)
    assert build.kernel_dir() == build.DEFAULT_KERNEL_DIR
    assert build.DEFAULT_KERNEL_DIR == REPO / "build" / "kernels"
    there = tmp_path / "elsewhere"
    monkeypatch.setenv("KGCT_KERNEL_DIR", str(there))
    assert build.kernel_dir() == there
    assert build.library_path("spec_verify") == there / "libspec_verify.so"
    assert build.stamp_path("spec_verify").parent == there


def test_int4_sweep_builds_under_the_kernel_dir(kdir, monkeypatch):
    from kubernetes_gpu_cluster_tpu_torch.tools import int4_sweep
    monkeypatch.setattr(build, "nvcc_path", lambda: "nvcc")
    lib, cmd = int4_sweep._build("d3w4b1p4", {"KGCT_INT4_DECODE_STAGES": 3})
    assert lib.is_relative_to(kdir) and lib.parent.is_dir()
    assert cmd[cmd.index("-o") + 1] == str(lib)


def test_spec_vs_parent_gives_each_tree_its_own_kernels(tmp_path,
                                                       monkeypatch):
    """The two trees' verify kernels differ, so each child and build runs
    with its own tree on the path and its own default kernel directory;
    the child's script is valid Python; an unknown tree name is refused."""
    from kubernetes_gpu_cluster_tpu_torch.tools import spec_vs_parent as svp
    monkeypatch.setenv("KGCT_KERNEL_DIR", str(tmp_path / "shared"))
    env = svp._env(tmp_path)
    assert "KGCT_KERNEL_DIR" not in env
    assert env["PYTHONPATH"] == str(tmp_path)
    compile(svp.CHILD, "spec_vs_parent child", "exec")
    with pytest.raises(SystemExit):
        svp.main(["--parent", str(tmp_path), "--order", "tree,other"])


def test_build_writes_library_then_stamp(kdir, fake_nvcc):
    secs = build.build(("paged_decode", "spec_verify"))
    assert secs > 0
    for n in ("paged_decode", "spec_verify"):
        assert build.library_path(n).read_bytes().startswith(b"\x7fELF")
        assert build.stamp_path(n).read_text().strip() == \
            build.source_digest(n)
        assert not build.stale(n)
        assert "42 registers" in build.build_log[n]
        assert build.build_seconds[n] > 0
        assert build.ptxas_of(n) == FAKE_REPORT
    assert sorted(p.name for p in kdir.iterdir()) == [
        "libpaged_decode.so", "libpaged_decode.so.ptxas.json",
        "libpaged_decode.so.sha256",
        "libspec_verify.so", "libspec_verify.so.ptxas.json",
        "libspec_verify.so.sha256"]
    assert build.build(("paged_decode", "spec_verify")) == 0.0


def test_a_failed_compile_raises_and_leaves_nothing(kdir, fake_nvcc):
    (build.CSRC / "spec_verify.cu").write_text("FAIL\n")
    with pytest.raises(RuntimeError, match="a compile error"):
        build.build(("paged_decode", "spec_verify"))
    assert not build.stale("paged_decode")
    assert build.stale("spec_verify")
    assert sorted(p.name for p in kdir.iterdir()) == [
        "libpaged_decode.so", "libpaged_decode.so.ptxas.json",
        "libpaged_decode.so.sha256"]


def test_command_line_prints_seconds_and_registers(kdir, fake_nvcc, capsys):
    _current("int4_matmul")
    assert build.main() == 0
    out = capsys.readouterr().out
    assert f"kernel dir {kdir}" in out
    assert "int4_matmul: current" in out
    for n in build.KERNELS:
        if n != "int4_matmul":
            assert f"{n}: built in " in out
            assert f"[{n}] ptxas info    : Used 42 registers" in out
    assert build.main() == 0
    out = capsys.readouterr().out
    assert all(f"{n}: current" in out for n in build.KERNELS)


def test_command_line_prints_the_kept_ptxas_report_of_current_kernels(
        kdir, fake_nvcc, capsys):
    """A second run builds nothing and still prints every kernel's ptxas
    report, read from beside its library; a library built with no report
    (by an older build) prints null."""
    _current("int4_matmul")
    assert build.main() == 0
    first = capsys.readouterr().out
    assert build.main() == 0
    again = capsys.readouterr().out
    assert ": built in" not in again
    for n in build.KERNELS:
        want = "null" if n == "int4_matmul" else json.dumps(FAKE_REPORT)
        for out in (first, again):
            assert f"  [{n}] ptxas: {want}\n" in out


def test_ptxas_report_reads_each_entry_function():
    log = """ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z6kernelILi128EEvv' for 'sm_90a'
ptxas info    : Function properties for _Z6kernelILi128EEvv
    8 bytes stack frame, 244 bytes spill stores, 196 bytes spill loads
ptxas info    : Used 168 registers, 16 bytes smem, 400 bytes cmem[0]
ptxas info    : Compiling entry function '_Z6kernelILi64EEvv' for 'sm_90a'
ptxas info    : Function properties for _Z6kernelILi64EEvv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 213 registers, 400 bytes cmem[0]
"""
    assert build.ptxas_report(log) == [
        {"function": "_Z6kernelILi128EEvv", "stack": 8, "spill_stores": 244,
         "spill_loads": 196, "registers": 168, "smem": 16},
        {"function": "_Z6kernelILi64EEvv", "stack": 0, "spill_stores": 0,
         "spill_loads": 0, "registers": 213}]
    assert build.ptxas_report("nvcc: no entry functions\n") == []


def test_command_line_with_no_nvcc_exits_non_zero(tmp_path):
    env = {k: v for k, v in os.environ.items()
           if k not in ("CUDA_HOME", "CUDA_PATH")}
    env.update(KGCT_KERNEL_DIR=str(tmp_path / "kernels"),
               PATH=os.path.dirname(sys.executable), PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-m", "kubernetes_gpu_cluster_tpu_torch.ops.cuda.build"],
        env=env, cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "kernel build failed" in proc.stderr
    assert str(tmp_path / "kernels") in proc.stderr
    assert not (tmp_path / "kernels").exists()


class _OnCard(torch.Tensor):
    """A host tensor the wrappers take for one on card 0 (their per-call
    device checks read ``get_device``)."""

    def get_device(self):
        return 0


def _card(shape, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype).as_subclass(_OnCard)


# Per split wrapper: its call on stand-in tensors, and the launch record
# its key would cache (the C launch struct, the stand-in entry, the
# workspace floats and counters a call takes).
_SPLIT_CALLS = {
    "paged_decode": (
        lambda m: m.paged_decode(
            _card((2, 4, 8)), _card((3, 16, 16)), _card((3, 16, 16)),
            _card((2, 3), torch.int32), _card((2,), torch.int32),
            _card((2, 2, 8)), _card((2, 2, 8)), 0.5),
        lambda m, fn: m._Launch(0, 0, ctypes.pointer(m.LaunchArgs()), fn,
                                64, 8)),
    "spec_verify": (
        lambda m: m.spec_verify(
            _card((4, 4, 8)), _card((4, 2, 8)), _card((4, 2, 8)),
            _card((3, 16, 16)), _card((3, 16, 16)),
            _card((2, 3), torch.int32), _card((2,), torch.int32), 0.5),
        lambda m, fn: m._Launch(0, 0, ctypes.pointer(m.LaunchArgs()), fn,
                                64, 8)),
    "int4_matmul": (
        lambda m: m.int4_matmul(_card((2, 32)), _card((16, 8), torch.int8),
                                _card((1, 8))),
        lambda m, fn: m._Launch((2, 8), torch.device("cpu"), False, None,
                                ctypes.pointer(m.LaunchArgs()), fn, 64, 8)),
}


@pytest.mark.parametrize("kernel", sorted(_SPLIT_CALLS))
def test_split_calls_of_one_key_on_two_threads_pass_their_own_scratch(
        kernel, monkeypatch):
    """Two threads call one split wrapper with the same launch key, each
    on a stream of its own. The library's entry is a stand-in that, like
    the C call (ctypes releases the GIL), lets the other thread run before
    it reads the workspace and counters it was given: every call sees its
    own stream's set. A wrapper that wrote the set into the key's cached
    launch struct would let the other thread's call overwrite it."""
    import importlib
    import threading
    from kubernetes_gpu_cluster_tpu_torch.ops import cuda as cuda_ops
    mod = importlib.import_module(
        f"kubernetes_gpu_cluster_tpu_torch.ops.cuda.{kernel}")
    monkeypatch.setattr(cuda_ops.Scratch, "_new", staticmethod(
        lambda dev, ws, n: (torch.empty(max(ws, 1)),
                            torch.zeros(max(n, 1), dtype=torch.int32))))
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    scratch = cuda_ops.Scratch()
    monkeypatch.setattr(mod, "SCRATCH", scratch)
    monkeypatch.setattr(mod, "_launch_cache", {})
    monkeypatch.setattr(mod, "launches", mod.launches)
    stream = threading.local()
    monkeypatch.setattr(mod, "raw_stream", lambda dev: stream.id)
    seen = []

    def entry(*args):
        at = next(i for i, a in enumerate(args)
                  if isinstance(a, ctypes._Pointer))
        time.sleep(0.0005)              # the other thread runs meanwhile
        launch = args[at].contents
        if hasattr(launch, "ws"):
            ws, counters = launch.ws, launch.counters
        else:
            ws, counters = args[at - 2:at]
        seen.append((args[-1], ws, counters))
        return 0
    call, record = _SPLIT_CALLS[kernel]
    monkeypatch.setattr(mod, "_prepare", lambda *a, **k: record(mod, entry))
    go = threading.Barrier(2)

    def run(sid):
        stream.id = sid
        go.wait()
        for _ in range(100):
            call(mod)
    other = threading.Thread(target=run, args=(0x7f02,))
    other.start()
    run(0x7f01)
    other.join()
    sets = {sid: tuple(t.data_ptr() for t in scratch._sets[(0, sid)])
            for sid in (0x7f01, 0x7f02)}
    assert len(seen) == 200 and len(set(sets.values())) == 2
    wrong = [(sid, ws, cnt) for sid, ws, cnt in seen
             if (ws, cnt) != sets[sid]]
    assert not wrong, f"{len(wrong)} of 200 calls saw another stream's set"
