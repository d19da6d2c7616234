"""The node layer on the card: ``chip_smoke.py`` phase 18.

Run from the repository root on a machine with an NVIDIA driver:

    python -m kubernetes_gpu_cluster_tpu_torch.tools.node_layer

Builds the H100 device plugin and its kubelet stand-in
(``cluster/device-plugin-cuda``) with its Makefile, and then, with
``--plugin-dir`` in a temporary directory (never ``/var/lib/kubelet``):

- the inventory: ``--write-cdi-spec`` lists, UUID for UUID, what
  ``nvidia-smi`` lists, as many as the cards CUDA sees;
- the plugin registers ``nvidia.com/gpu`` at ``kgct-cuda.sock`` with the
  probe; each UUID's ``Allocate`` returns character devices and read-only
  mounts of regular files whose version suffix is the driver's; an unknown
  ID is refused with ``NOT_FOUND``;
- the mounts alone give a working CUDA: a child with an empty environment
  but ``LD_LIBRARY_PATH`` (a directory of links named as the mounts'
  container paths) and ``CUDA_VISIBLE_DEVICES`` initializes CUDA, sees one
  device, the allocated one (its UUID, its name, the node it opened), and
  JIT-loads a PTX module (``libnvidia-ptxjitcompiler`` mapped); every
  NVIDIA driver library it maps is one of the mounts' files; the mounted
  ``nvidia-smi -L`` lists the UUID;
- on SIGTERM the plugin exits 0 within ``STOP_BOUND_S`` and removes its
  socket.

Any miss raises. Every process started here is killed with the thread that
started it (``PR_SET_PDEATHSIG``) and in ``check``'s ``finally``. Prints
one JSON line: build seconds, start-to-register ms, ``Allocate`` µs.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import shutil
import signal
import stat
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Optional

SRC = Path(__file__).resolve().parents[2] / "cluster" / "device-plugin-cuda"
PLUGIN = "kgct-cuda-device-plugin"
PROBE = "kgct-cuda-plugin-probe"
RESOURCE = "nvidia.com/gpu"
ENDPOINT = "kgct-cuda.sock"
UNKNOWN_ID = "GPU-00000000-0000-0000-0000-000000000000"
STOP_BOUND_S = 2.0
# The plugin's mounts land here in a container.
LIB_DIR = "/usr/local/nvidia/lib64"
BIN_DIR = "/usr/local/nvidia/bin"
# A library the NVIDIA driver ships (user-space side), by file name.
DRIVER_LIB = re.compile(r"^lib(cuda|cudadebugger|nvidia-[\w-]+)\.so[.\d]*$")
PR_SET_PDEATHSIG = 1

# Run in the child with only the injected libraries: libcuda from the
# loader's path, one device, its UUID, a PTX module JIT-compiled, then the
# files and device nodes it mapped.
CHILD = r'''
import ctypes, json
PTX = b""".version 7.0
.target sm_50
.address_size 64
.visible .entry kgct_noop() { ret; }
"""
out = {}
cu = ctypes.CDLL("libcuda.so.1")
out["cuInit"] = cu.cuInit(0)
n = ctypes.c_int(0)
out["cuDeviceGetCount"] = cu.cuDeviceGetCount(ctypes.byref(n))
out["count"] = n.value
if out["cuInit"] == 0 and n.value >= 1:
    dev = ctypes.c_int(0)
    cu.cuDeviceGet(ctypes.byref(dev), 0)
    raw = (ctypes.c_ubyte * 16)()
    get_uuid = getattr(cu, "cuDeviceGetUuid_v2", None) or cu.cuDeviceGetUuid
    out["cuDeviceGetUuid"] = get_uuid(raw, dev)
    h = bytes(raw).hex()
    out["uuid"] = f"GPU-{h[:8]}-{h[8:12]}-{h[12:16]}-{h[16:20]}-{h[20:]}"
    name = ctypes.create_string_buffer(256)
    cu.cuDeviceGetName(name, 256, dev)
    out["name"] = name.value.decode()
    ctx, mod = ctypes.c_void_p(), ctypes.c_void_p()
    out["cuDevicePrimaryCtxRetain"] = cu.cuDevicePrimaryCtxRetain(
        ctypes.byref(ctx), dev)
    out["cuCtxSetCurrent"] = cu.cuCtxSetCurrent(ctx)
    out["cuModuleLoadData"] = cu.cuModuleLoadData(ctypes.byref(mod), PTX)
    if out["cuModuleLoadData"] == 0:
        cu.cuModuleUnload(mod)
    cu.cuDevicePrimaryCtxRelease(dev)
out["maps"] = sorted({line.split()[-1] for line in open("/proc/self/maps")
                      if len(line.split()) >= 6
                      and line.split()[-1].startswith("/")})
print(json.dumps(out))
'''


def _die_with_thread():
    """A ``preexec_fn``: the child, between fork and exec, asks for SIGKILL
    when the thread that started it ends. Only a foreign call runs there:
    ``prctl`` is looked up here, in the parent (a ``dlopen`` after a fork
    of a threaded process can wait on a lock another thread held)."""
    prctl = ctypes.CDLL(None).prctl
    prctl.argtypes = [ctypes.c_int] + [ctypes.c_ulong] * 4
    prctl.restype = ctypes.c_int
    return lambda: prctl(PR_SET_PDEATHSIG, signal.SIGKILL, 0, 0, 0)


def build(out: Path, src: Path = SRC) -> dict:
    """Both binaries into ``out`` by the Makefile. Returns their paths and
    the seconds."""
    out.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    proc = subprocess.run(["make", "-C", str(src), f"BUILD={out}", "-j4"],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True, timeout=300, preexec_fn=_die_with_thread())
    if proc.returncode != 0:
        raise RuntimeError(f"node layer build: make exited {proc.returncode}:"
                           f"\n{proc.stdout}")
    return {"plugin": out / PLUGIN, "probe": out / PROBE,
            "s": time.perf_counter() - t0}


def driver_libs_outside(maps: list, mounts: list) -> list:
    """The NVIDIA driver libraries among ``maps`` (paths a process mapped)
    that do not resolve to one of ``mounts``' host files."""
    allowed = {os.path.realpath(m["host_path"]) for m in mounts}
    return [p for p in maps if DRIVER_LIB.match(Path(p).name)
            and os.path.realpath(p) not in allowed]


def injected_dirs(mounts: list, root: Path) -> tuple[Path, Path]:
    """``root/lib64`` and ``root/bin``: a link per mount, named as its
    container path's basename, to its host path (what a bind mount at
    ``/usr/local/nvidia`` gives a container)."""
    lib, bin_ = root / "lib64", root / "bin"
    for d in (lib, bin_):
        d.mkdir(parents=True, exist_ok=True)
    for m in mounts:
        where = {LIB_DIR: lib, BIN_DIR: bin_}[str(Path(m["container_path"])
                                                  .parent)]
        (where / Path(m["container_path"]).name).symlink_to(m["host_path"])
    return lib, bin_


def _smi(*query: str) -> list:
    out = subprocess.run(["nvidia-smi", *query], capture_output=True,
                         text=True, check=True, timeout=60).stdout
    return [line.strip() for line in out.strip().splitlines() if line.strip()]


def _check_allocation(a: dict, uuid: str, driver: str) -> str:
    """One UUID's ``Allocate``: its one card node (returned), character
    devices, read-only regular files at the driver's version, the env."""
    if a["status"] != 0 or len(a["containers"]) != 1:
        raise RuntimeError(f"18: Allocate({uuid}) failed: {a}")
    c = a["containers"][0]
    for d in c["devices"]:
        if d["permissions"] != "rw" or not stat.S_ISCHR(
                os.stat(d["host_path"]).st_mode):
            raise RuntimeError(f"18: {d} is not a rw character device")
    cards = [d["container_path"] for d in c["devices"]
             if re.fullmatch(r"/dev/nvidia\d+", d["container_path"])]
    nodes = {d["container_path"] for d in c["devices"]}
    if len(cards) != 1 or not {"/dev/nvidiactl", "/dev/nvidia-uvm",
                               "/dev/nvidia-uvm-tools"} <= nodes:
        raise RuntimeError(f"18: Allocate({uuid}) devices {sorted(nodes)}")
    names = set()
    for m in c["mounts"]:
        host = m["host_path"]
        names.add(Path(m["container_path"]).name)
        if not m["read_only"] or not stat.S_ISREG(os.stat(host).st_mode):
            raise RuntimeError(f"18: {m} is not a read-only regular file")
        if m["container_path"].startswith(LIB_DIR + "/") and \
                not host.endswith(f".so.{driver}"):
            raise RuntimeError(f"18: {host} is not the driver's {driver}")
    if not {"libcuda.so.1", "libnvidia-ml.so.1", "nvidia-smi"} <= names:
        raise RuntimeError(f"18: Allocate({uuid}) mounts {sorted(names)}")
    if c["envs"] != {"NVIDIA_VISIBLE_DEVICES": uuid}:
        raise RuntimeError(f"18: Allocate({uuid}) envs {c['envs']}")
    return cards[0]


def child_cuda(mounts: list, uuid: str, node: str, name: str,
               work: Path) -> dict:
    """The child with only the injected libraries; raises on a miss."""
    lib, bin_ = injected_dirs(mounts, work / "nvidia")
    die = _die_with_thread()
    env = {"LD_LIBRARY_PATH": str(lib), "CUDA_VISIBLE_DEVICES": uuid}
    proc = subprocess.run([sys.executable, "-I", "-S", "-c", CHILD], env=env,
                          capture_output=True, text=True, timeout=120,
                          preexec_fn=die)
    if proc.returncode != 0:
        raise RuntimeError(f"18: CUDA child exited {proc.returncode}: "
                           f"{proc.stderr[-2000:]}")
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    opened = [p for p in got["maps"] if re.fullmatch(r"/dev/nvidia\d+", p)]
    outside = driver_libs_outside(got["maps"], mounts)
    loaded = sorted(Path(p).name for p in got["maps"]
                    if DRIVER_LIB.match(Path(p).name))
    ok = (got["cuInit"] == 0 and got["count"] == 1
          and got.get("cuModuleLoadData") == 0 and got.get("name") == name
          and got.get("uuid") == uuid and opened == [node] and not outside
          and any(n.startswith("libcuda.so") for n in loaded)
          and any(n.startswith("libnvidia-ptxjitcompiler.so") for n in loaded))
    smi = subprocess.run([str(bin_ / "nvidia-smi"), "-L"],
                         env={"LD_LIBRARY_PATH": str(lib)}, capture_output=True,
                         text=True, timeout=60)
    res = {"env": env, "child": {
        k: v for k, v in got.items() if k != "maps"}, "opened": opened,
        "driver_libs": loaded, "outside": outside,
        "nvidia_smi_L": smi.stdout.strip()}
    if not ok or smi.returncode != 0 or uuid not in smi.stdout:
        raise RuntimeError(f"18: CUDA through the mounts alone: {res}")
    return res


def check(device_count: int, work: Optional[Path] = None,
          built: Optional[dict] = None) -> dict:
    """Phase 18 (the module docstring); ``device_count`` is
    ``torch.cuda.device_count()``."""
    own = work is None
    work = Path(tempfile.mkdtemp(prefix="kgct-node-")) if own else work
    work = work.resolve()
    die = _die_with_thread()
    procs: list = []
    try:
        built = built or build(work / "bin")
        res = {"build_s": built["s"]}
        smi = [line.split(", ") for line in
               _smi("--query-gpu=uuid,driver_version,name",
                    "--format=csv,noheader")]
        uuids = [s[0] for s in smi]
        drivers = {s[1] for s in smi}
        cdi_path = work / "kgct-cuda.json"
        proc = subprocess.run([str(built["plugin"]),
                               f"--write-cdi-spec={cdi_path}"],
                              capture_output=True, text=True, timeout=60)
        if proc.returncode != 0:
            raise RuntimeError(f"18: --write-cdi-spec exited "
                               f"{proc.returncode}: {proc.stderr}")
        cdi = json.loads(cdi_path.read_text())
        listed = [d["name"] for d in cdi["devices"]]
        if cdi["kind"] != RESOURCE or listed != uuids or \
                len(listed) != device_count or len(drivers) != 1:
            raise RuntimeError(f"18: CDI devices {listed} ({cdi['kind']}), "
                               f"nvidia-smi {smi}, CUDA {device_count}")
        driver = drivers.pop()
        res["inventory"] = {"uuids": uuids, "driver": driver,
                            "plugin_log": proc.stderr.strip()}

        # The plugin dir by a relative name from ``work``: a socket's path
        # must fit in 108 bytes, whatever the checkout's path.
        plugdir = work / "plugins"
        plugdir.mkdir()
        probe = subprocess.Popen(
            [str(built["probe"]), "--dir=plugins", f"--ids={','.join(uuids)}",
             f"--unknown={UNKNOWN_ID}", "--timeout-s=30"], cwd=work,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            preexec_fn=die)
        procs.append(probe)
        deadline = time.monotonic() + 10
        while not (plugdir / "kubelet.sock").exists():
            if time.monotonic() > deadline or probe.poll() is not None:
                raise RuntimeError("18: the probe did not listen")
            time.sleep(0.01)
        with open(work / "plugin.stderr", "w") as errf:
            t0 = time.monotonic_ns()
            plugin = subprocess.Popen(
                [str(built["plugin"]), "--plugin-dir=plugins",
                 "--health-interval-s=1"], cwd=work, stderr=errf,
                preexec_fn=die)
        procs.append(plugin)
        out, err = probe.communicate(timeout=60)
        if probe.returncode != 0:
            raise RuntimeError(f"18: probe exited {probe.returncode}: {err}; "
                               f"plugin: {(work / 'plugin.stderr').read_text()}")
        got = json.loads(out)
        res["register_ms"] = (got["registered_at_ns"] - t0) / 1e6
        reg = got["register"]
        if (reg["version"], reg["endpoint"], reg["resource"]) != (
                "v1beta1", ENDPOINT, RESOURCE) or any(reg["options"].values()):
            raise RuntimeError(f"18: registered {reg}")
        if got["options"]["status"] != 0 or any(
                got["options"]["options"].values()):
            raise RuntimeError(f"18: GetDevicePluginOptions {got['options']}")
        if got["unknown"]["status"] != 5:
            raise RuntimeError(f"18: the unknown ID got {got['unknown']}")
        res["allocate_us"] = [a["us"] for a in got["allocate"]]
        res["unknown"] = got["unknown"]["message"]
        nodes = [_check_allocation(a, u, driver)
                 for a, u in zip(got["allocate"], uuids)]
        mounts = got["allocate"][0]["containers"][0]["mounts"]
        res["mounts"] = {Path(m["container_path"]).name: m["host_path"]
                         for m in mounts}
        res["cuda"] = child_cuda(mounts, uuids[0], nodes[0], smi[0][2], work)

        t0 = time.perf_counter()
        plugin.send_signal(signal.SIGTERM)
        rc = plugin.wait(timeout=10)
        res["stop_s"] = time.perf_counter() - t0
        if rc != 0 or res["stop_s"] > STOP_BOUND_S or \
                (plugdir / ENDPOINT).exists():
            raise RuntimeError(f"18: SIGTERM: exit {rc} in "
                               f"{res['stop_s']:.2f} s, socket left "
                               f"{(plugdir / ENDPOINT).exists()}")
        return res
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        if own:
            shutil.rmtree(work, ignore_errors=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.parse_args(argv)
    import torch
    print(json.dumps(check(torch.cuda.device_count())))
    return 0


if __name__ == "__main__":
    sys.exit(main())
