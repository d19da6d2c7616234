"""The H100 node layer's device plugin (``cluster/device-plugin-cuda``) on
the wire, on the CPU.

The plugin discovers GPUs through NVML, which it loads with ``dlopen``; here
NVML is a stub (``STUB_NVML``, built with ``g++ -shared`` per module) whose
inventory is a file named by ``KGCT_STUB_NVML``: the devices (UUID, minor
number, name), the driver version, the UUIDs NVML no longer resolves, and
whether ``nvmlInit_v2`` fails. The driver root is a directory with the
stub as ``libnvidia-ml.so.<ver>`` beside small ELF objects carrying each
driver library's SONAME, and ``usr/bin/nvidia-smi``; the device root a
directory of files named as the card's nodes.

- a grpcio server plays the kubelet (``Registration``) and a grpcio
  client drives ``ListAndWatch``, ``Allocate`` and the options, with the
  real protoc-generated v1beta1 messages (as ``tests/test_device_plugin.py``
  does for the TPU plugin);
- the plugin's own kubelet stand-in (``kgct-cuda-plugin-probe``, what
  ``chip_smoke.py`` phase 18 runs on the card, where there is no grpcio)
  is run against it, from binaries built as phase 18 builds them (the
  Makefile, through ``node_layer.build``);
- one test, over both plugins, holds the contract the TPU plugin set
  (its binary built by its own Makefile) equal.

Skips only where the toolchain (g++, make, protoc) or grpcio is missing.
"""

from __future__ import annotations

import json
import os
import pathlib
import shutil
import subprocess
import sys
import tempfile
import time

import pytest

grpc = pytest.importorskip("grpc")

import test_device_plugin as tpu_tests  # noqa: E402  (its FakeKubelet)
from kubernetes_gpu_cluster_tpu_torch.tools import node_layer  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parent.parent
CUDA_DIR = REPO / "cluster" / "device-plugin-cuda"
TPU_DIR = REPO / "cluster" / "device-plugin"
DRIVER = "550.54.15"
LIBDIR = "usr/lib/x86_64-linux-gnu"
# index 0 has minor 3 and index 1 minor 1: never index == minor.
UUID_A = "GPU-11111111-2222-3333-4444-555555555555"
UUID_B = "GPU-aaaaaaaa-bbbb-cccc-dddd-eeeeeeeeeeee"
GPUS = [(UUID_A, 3, "NVIDIA H100 80GB HBM3"), (UUID_B, 1, "NVIDIA H100 80GB HBM3")]
# Each driver library's SONAME, as the 5xx drivers ship them.
SONAMES = {"cuda": "libcuda.so.1", "nvidia-ptxjitcompiler":
           "libnvidia-ptxjitcompiler.so.1", "nvidia-nvvm": "libnvidia-nvvm.so.4",
           "nvidia-gpucomp": f"libnvidia-gpucomp.so.{DRIVER}",
           "cudadebugger": "libcudadebugger.so.1",
           "nvidia-cfg": "libnvidia-cfg.so.1"}
CONTROL = ["nvidiactl", "nvidia-uvm", "nvidia-uvm-tools"]

STUB_NVML = r"""
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
extern "C" {
struct StubGpu { char uuid[96]; unsigned minor; char name[96]; };
static StubGpu gpus[16];
static int n_gpus, n_lost, fail_init;
static char driver[80], lost[16][96];
static void load() {  // re-read on every call: a test edits the file live
  n_gpus = n_lost = fail_init = 0;
  driver[0] = 0;
  const char* path = getenv("KGCT_STUB_NVML");
  FILE* f = path ? fopen(path, "r") : NULL;
  if (!f) return;
  char line[512];
  while (fgets(line, sizeof line, f)) {
    line[strcspn(line, "\n")] = 0;
    int off = 0;
    if (!strncmp(line, "driver ", 7)) {
      snprintf(driver, sizeof driver, "%s", line + 7);
    } else if (!strncmp(line, "gpu ", 4) && n_gpus < 16 &&
               sscanf(line + 4, "%95s %u %n", gpus[n_gpus].uuid,
                      &gpus[n_gpus].minor, &off) >= 2) {
      snprintf(gpus[n_gpus].name, 96, "%s", line + 4 + off);
      ++n_gpus;
    } else if (!strncmp(line, "lost ", 5) && n_lost < 16) {
      snprintf(lost[n_lost++], 96, "%s", line + 5);
    } else if (!strcmp(line, "fail_init")) {
      fail_init = 1;
    }
  }
  fclose(f);
}
static int slot(void* h) { return (int)(uintptr_t)h - 1; }
int nvmlInit_v2(void) { load(); return fail_init ? 9 : 0; }
int nvmlShutdown(void) { return 0; }
const char* nvmlErrorString(int rc) {
  return rc == 9 ? "Driver Not Loaded" : rc == 6 ? "Not Found" : "Unknown Error";
}
int nvmlDeviceGetCount_v2(unsigned* count) { load(); *count = n_gpus; return 0; }
int nvmlDeviceGetHandleByIndex_v2(unsigned i, void** h) {
  load();
  if (i >= (unsigned)n_gpus) return 2;
  *h = (void*)(uintptr_t)(i + 1);
  return 0;
}
int nvmlDeviceGetHandleByUUID(const char* uuid, void** h) {
  load();
  for (int i = 0; i < n_lost; ++i) if (!strcmp(lost[i], uuid)) return 6;
  for (int i = 0; i < n_gpus; ++i)
    if (!strcmp(gpus[i].uuid, uuid)) { *h = (void*)(uintptr_t)(i + 1); return 0; }
  return 6;
}
int nvmlDeviceGetUUID(void* h, char* buf, unsigned len) {
  snprintf(buf, len, "%s", gpus[slot(h)].uuid); return 0;
}
int nvmlDeviceGetMinorNumber(void* h, unsigned* minor) {
  *minor = gpus[slot(h)].minor; return 0;
}
int nvmlDeviceGetName(void* h, char* buf, unsigned len) {
  snprintf(buf, len, "%s", gpus[slot(h)].name); return 0;
}
int nvmlSystemGetDriverVersion(char* buf, unsigned len) {
  load(); snprintf(buf, len, "%s", driver); return 0;
}
}
"""


def _run(cmd, **kw):
    r = subprocess.run(cmd, capture_output=True, text=True, **kw)
    assert r.returncode == 0, f"{cmd} failed:\n{r.stdout}\n{r.stderr}"
    return r


@pytest.fixture(scope="module")
def toolchain():
    if shutil.which("g++") is None or shutil.which("make") is None:
        pytest.skip("no C++ toolchain")


@pytest.fixture(scope="module")
def cuda_bin(toolchain, tmp_path_factory):
    """The plugin and probe, built as phase 18 builds them (the Makefile)
    into a directory of this module's own (no race with another worker's
    build)."""
    return node_layer.build(tmp_path_factory.mktemp("cuda-plugin-build"))


@pytest.fixture(scope="module")
def tpu_bin(toolchain, tmp_path_factory):
    """The TPU plugin, built by its own unchanged Makefile."""
    out = tmp_path_factory.mktemp("tpu-plugin-build")
    _run(["make", "-C", str(TPU_DIR), f"BUILD={out}", "-j4"], timeout=300)
    return out / "kgct-tpu-device-plugin"


@pytest.fixture(scope="module")
def pb():
    if shutil.which("protoc") is None:
        pytest.skip("no protoc")
    out = tempfile.mkdtemp(prefix="kgct-proto-cuda-")
    _run(["protoc", f"--python_out={out}", "v1beta1.proto"],
         cwd=TPU_DIR / "proto")
    sys.path.insert(0, out)
    try:
        import v1beta1_pb2
        yield v1beta1_pb2
    finally:
        sys.path.remove(out)
        shutil.rmtree(out, ignore_errors=True)


@pytest.fixture(scope="module")
def driver_template(toolchain, tmp_path_factory):
    """A driver root: the stub NVML and an ELF object per library."""
    root = tmp_path_factory.mktemp("driver-root")
    lib = root / LIBDIR
    lib.mkdir(parents=True)
    src = root / "stub_nvml.cc"
    src.write_text(STUB_NVML)
    _run(["g++", "-shared", "-fPIC", "-Wl,-soname,libnvidia-ml.so.1",
          "-o", str(lib / f"libnvidia-ml.so.{DRIVER}"), str(src)])
    (lib / "libnvidia-ml.so.1").symlink_to(f"libnvidia-ml.so.{DRIVER}")
    empty = root / "empty.cc"
    empty.write_text("extern \"C\" int kgct_driver_stub(void) { return 0; }\n")
    _run(["g++", "-c", "-fPIC", "-o", str(root / "empty.o"), str(empty)])
    for name, soname in SONAMES.items():
        _run(["g++", "-shared", f"-Wl,-soname,{soname}", "-o",
              str(lib / f"lib{name}.so.{DRIVER}"), str(root / "empty.o")])
    # A library of another driver beside it, as after an upgrade: not taken.
    shutil.copy(lib / f"libcuda.so.{DRIVER}", lib / "libcuda.so.535.00.01")
    (root / "usr" / "bin").mkdir(parents=True)
    (root / "usr" / "bin" / "nvidia-smi").write_text("#!/bin/sh\n")
    for p in (src, empty, root / "empty.o"):
        p.unlink()
    return root


class Node:
    """A fake node: driver root, device root, inventory, plugin dir."""

    def __init__(self, template: pathlib.Path, tmp: pathlib.Path,
                 gpus=GPUS, extra_dev=()):
        self.root = tmp / "host"
        shutil.copytree(template, self.root, symlinks=True)
        self.dev = tmp / "dev"
        self.dev.mkdir()
        for name in [f"nvidia{m}" for _, m, _ in gpus] + CONTROL + \
                ["nvidia0", *extra_dev]:
            (self.dev / name).touch()
        self.plugdir = tmp / "plugins"
        self.plugdir.mkdir()
        self.inventory = tmp / "nvml.txt"
        self.write_inventory(gpus)
        self.tmp = tmp
        self.procs: list = []

    def write_inventory(self, gpus, lost=(), fail_init=False):
        lines = [f"driver {DRIVER}"] + [f"gpu {u} {m} {n}" for u, m, n in gpus]
        lines += [f"lost {u}" for u in lost] + (["fail_init"] if fail_init
                                                 else [])
        self.inventory.write_text("\n".join(lines) + "\n")

    def env(self):
        return {**os.environ, "KGCT_STUB_NVML": str(self.inventory)}

    def args(self, binary, *extra):
        return [str(binary), f"--plugin-dir={self.plugdir}",
                f"--dev-root={self.dev}", f"--driver-root={self.root}", *extra]

    def start(self, binary, *extra):
        errpath = self.tmp / f"plugin{len(self.procs)}.stderr"
        with open(errpath, "w") as errf:
            proc = subprocess.Popen(self.args(binary, "--health-interval-s=1",
                                              *extra),
                                    stderr=errf, env=self.env())
        proc.errpath = errpath
        self.procs.append(proc)
        return proc

    def stop(self):
        for p in self.procs:
            if p.poll() is None:
                p.terminate()
            p.wait(timeout=10)


@pytest.fixture()
def node(driver_template, tmp_path):
    n = Node(driver_template, tmp_path)
    yield n
    n.stop()


@pytest.fixture()
def served(node, cuda_bin, pb):
    """The plugin running against a grpcio kubelet, registered."""
    kubelet = tpu_tests.FakeKubelet(pb, str(node.plugdir))
    proc = node.start(cuda_bin["plugin"])
    try:
        assert kubelet.event.wait(timeout=15), proc.errpath.read_text()
        yield pb, node, kubelet, proc
    finally:
        node.stop()
        kubelet.stop()


def _channel(plugdir, sock="kgct-cuda.sock"):
    ch = grpc.insecure_channel(f"unix://{plugdir}/{sock}")
    grpc.channel_ready_future(ch).result(timeout=10)
    return ch


def _allocate(pb, ch, *requests):
    req = pb.AllocateRequest()
    for ids in requests:
        req.container_requests.add().devicesIDs.extend(ids)
    return ch.unary_unary(
        "/v1beta1.DevicePlugin/Allocate",
        request_serializer=pb.AllocateRequest.SerializeToString,
        response_deserializer=pb.AllocateResponse.FromString)(req, timeout=10)


def _watch(pb, ch):
    return iter(ch.unary_stream(
        "/v1beta1.DevicePlugin/ListAndWatch",
        request_serializer=pb.Empty.SerializeToString,
        response_deserializer=pb.ListAndWatchResponse.FromString,
    )(pb.Empty(), timeout=30))


def _host(path: str) -> str:
    return f"/{LIBDIR}/{path}"


def _expected_mounts():
    """(container path, host path) of every mount, in the plugin's order:
    each library under its SONAME, then nvidia-smi."""
    sonames = {"cuda": "libcuda.so.1", "nvidia-ml": "libnvidia-ml.so.1",
               **SONAMES}
    order = ["cuda", "nvidia-ml", "nvidia-ptxjitcompiler", "nvidia-nvvm",
             "nvidia-gpucomp", "cudadebugger", "nvidia-cfg"]
    return [(f"/usr/local/nvidia/lib64/{sonames[k]}",
             f"/{LIBDIR}/lib{k}.so.{DRIVER}") for k in order] + [
        ("/usr/local/nvidia/bin/nvidia-smi", "/usr/bin/nvidia-smi")]


# -- the plugin against grpcio ------------------------------------------------

def test_registers_nvidia_gpu_at_its_endpoint(served):
    pb, node, kubelet, proc = served
    req = kubelet.requests[0]
    assert (req.version, req.endpoint, req.resource_name) == (
        "v1beta1", "kgct-cuda.sock", "nvidia.com/gpu")
    assert not req.options.pre_start_required
    assert not req.options.get_preferred_allocation_available
    log = proc.errpath.read_text()
    assert f"driver {DRIVER}" in log and "2 GPUs, 8 mounts" in log


def test_list_and_watch_pushes_health_changes(served):
    pb, node, kubelet, proc = served
    ch = _channel(node.plugdir)
    it = _watch(pb, ch)
    first = next(it)
    assert {d.ID: d.health for d in first.devices} == {
        UUID_A: "Healthy", UUID_B: "Healthy"}
    # NVML stops resolving B's UUID: pushed within the health interval.
    node.write_inventory(GPUS, lost=[UUID_B])
    second = next(it)
    assert {d.ID: d.health for d in second.devices} == {
        UUID_A: "Healthy", UUID_B: "Unhealthy"}
    # A's node goes: A turns unhealthy too; B comes back.
    node.write_inventory(GPUS)
    (node.dev / "nvidia3").unlink()
    third = next(it)
    assert {d.ID: d.health for d in third.devices} == {
        UUID_A: "Unhealthy", UUID_B: "Healthy"}
    ch.close()


@pytest.mark.parametrize("ids", [[UUID_A], [UUID_B, UUID_A]],
                         ids=["one", "two"])
def test_allocate_returns_nodes_mounts_and_env(served, ids):
    pb, node, kubelet, proc = served
    ch = _channel(node.plugdir)
    resp = _allocate(pb, ch, ids)
    (cr,) = resp.container_responses
    minor = {u: m for u, m, _ in GPUS}
    cards = [f"nvidia{minor[u]}" for u in ids]
    assert [(d.container_path, d.host_path, d.permissions)
            for d in cr.devices] == [
        (f"/dev/{n}", f"{node.dev}/{n}", "rw") for n in cards + CONTROL]
    assert [(m.container_path, m.host_path, m.read_only)
            for m in cr.mounts] == [(c, h, True)
                                    for c, h in _expected_mounts()]
    assert dict(cr.envs) == {"NVIDIA_VISIBLE_DEVICES": ",".join(ids)}
    # Two containers in one request: one response each, in order.
    two = _allocate(pb, ch, [UUID_A], [UUID_B])
    assert [dict(c.envs)["NVIDIA_VISIBLE_DEVICES"]
            for c in two.container_responses] == [UUID_A, UUID_B]
    ch.close()


def test_the_node_is_the_minor_not_the_index(node, cuda_bin, pb, tmp_path):
    """Index 0 has minor 3: its node is /dev/nvidia3, although a
    /dev/nvidia0 exists; and the modeset node is passed where it exists."""
    (node.dev / "nvidia-modeset").touch()
    kubelet = tpu_tests.FakeKubelet(pb, str(node.plugdir))
    try:
        proc = node.start(cuda_bin["plugin"])
        assert kubelet.event.wait(timeout=15), proc.errpath.read_text()
        ch = _channel(node.plugdir)
        (cr,) = _allocate(pb, ch, [UUID_A]).container_responses
        assert [d.container_path for d in cr.devices] == [
            "/dev/nvidia3", "/dev/nvidiactl", "/dev/nvidia-uvm",
            "/dev/nvidia-uvm-tools", "/dev/nvidia-modeset"]
        ch.close()
    finally:
        kubelet.stop()
    spec = tmp_path / "spec.json"
    _run(node.args(cuda_bin["plugin"], f"--write-cdi-spec={spec}"),
         env=node.env())
    dev = json.loads(spec.read_text())["devices"][0]["containerEdits"]
    assert dev["deviceNodes"][0]["path"] == "/dev/nvidia3"


def test_allocate_unknown_device_is_not_found(served):
    pb, node, kubelet, proc = served
    ch = _channel(node.plugdir)
    with pytest.raises(grpc.RpcError) as e:
        _allocate(pb, ch, [UUID_A, node_layer.UNKNOWN_ID])
    assert e.value.code() == grpc.StatusCode.NOT_FOUND
    assert node_layer.UNKNOWN_ID in e.value.details()
    ch.close()


def test_reregisters_after_kubelet_restart(served):
    """A starting kubelet clears the plugin directory, the plugin's socket
    with it, then binds kubelet.sock anew: the plugin serves again before
    it registers, so the kubelet's dial back finds it. The new socket may
    take the old one's inode number (as here, bound at once on the same
    filesystem): its change time tells it apart."""
    pb, node, kubelet, proc = served
    before = os.stat(node.plugdir / "kubelet.sock").st_ino
    kubelet.stop()
    for sock in ("kubelet.sock", "kgct-cuda.sock"):
        (node.plugdir / sock).unlink(missing_ok=True)
    again = tpu_tests.FakeKubelet(pb, str(node.plugdir))
    reused = os.stat(node.plugdir / "kubelet.sock").st_ino == before
    try:
        assert again.event.wait(timeout=15), proc.errpath.read_text()
        assert again.requests[0].resource_name == "nvidia.com/gpu"
        assert "re-registering" in proc.errpath.read_text()
        # The kubelet's dial back, on a new channel.
        ch = _channel(node.plugdir)
        assert {d.ID for d in next(_watch(pb, ch)).devices} == {UUID_A,
                                                               UUID_B}
        (cr,) = _allocate(pb, ch, [UUID_A]).container_responses
        assert dict(cr.envs) == {"NVIDIA_VISIBLE_DEVICES": UUID_A}
        ch.close()
    finally:
        again.stop()
    print(f"inode number reused: {reused}")


def test_cdi_spec(node, cuda_bin, tmp_path):
    spec_path = tmp_path / "kgct-cuda.json"
    r = _run(node.args(cuda_bin["plugin"], f"--write-cdi-spec={spec_path}"),
             env=node.env())
    assert "wrote CDI spec (2 devices)" in r.stderr
    spec = json.loads(spec_path.read_text())
    assert spec["cdiVersion"] == "0.6.0" and spec["kind"] == "nvidia.com/gpu"
    assert [(d["name"], d["containerEdits"]["deviceNodes"])
            for d in spec["devices"]] == [
        (u, [{"path": f"/dev/nvidia{m}", "hostPath": f"{node.dev}/nvidia{m}",
              "permissions": "rw"}]) for u, m, _ in GPUS]
    common = spec["containerEdits"]
    assert common["env"] == ["NVIDIA_VISIBLE_DEVICES=void"]
    assert common["deviceNodes"] == [
        {"path": f"/dev/{c}", "hostPath": f"{node.dev}/{c}",
         "permissions": "rw"} for c in CONTROL]
    assert [(m["containerPath"], m["hostPath"]) for m in common["mounts"]] \
        == _expected_mounts()
    assert all(m["options"] == ["ro", "nosuid", "nodev", "bind"]
               for m in common["mounts"])


def _break(node, what):
    lib = node.root / LIBDIR
    if what == "no NVML":
        for p in lib.glob("libnvidia-ml.so*"):
            p.unlink()
        return "NVML library libnvidia-ml.so.1 not found under the driver root"
    if what == "NVML init fails":
        node.write_inventory(GPUS, fail_init=True)
        return "nvmlInit_v2 failed (9): Driver Not Loaded"
    if what == "no device node":
        (node.dev / "nvidia1").unlink()
        return f"device {UUID_B} (index 1): its node {node.dev}/nvidia1 is missing"
    if what == "no libcuda":
        (lib / f"libcuda.so.{DRIVER}").unlink()
        return "the driver's libcuda is missing: no"
    if what == "no nvidia-uvm":
        (node.dev / "nvidia-uvm").unlink()
        return f"control node {node.dev}/nvidia-uvm is missing"
    if what == "a UUID twice":
        node.write_inventory([GPUS[0], (UUID_A, 1, "NVIDIA H100 80GB HBM3")])
        return f"NVML reports the UUID {UUID_A} twice"
    raise AssertionError(what)


@pytest.mark.parametrize("mode", ["serve", "cdi"])
@pytest.mark.parametrize("what", ["no NVML", "NVML init fails",
                                  "no device node", "no libcuda",
                                  "no nvidia-uvm", "a UUID twice"])
def test_refuses_to_start_without_what_it_needs(node, cuda_bin, pb, what,
                                                mode):
    """No fallback: a message naming what is missing, a non-zero exit, no
    socket, no registration, no spec written."""
    want = _break(node, what)
    kubelet = tpu_tests.FakeKubelet(pb, str(node.plugdir))
    spec = node.tmp / "spec.json"
    extra = [f"--write-cdi-spec={spec}"] if mode == "cdi" else []
    try:
        r = subprocess.run(node.args(cuda_bin["plugin"], *extra),
                           capture_output=True, text=True, env=node.env(),
                           timeout=30)
        assert r.returncode == 1, r.stderr
        assert "refused: " + want in r.stderr, r.stderr
        assert not (node.plugdir / "kgct-cuda.sock").exists()
        assert not spec.exists()
        assert not kubelet.requests
    finally:
        kubelet.stop()


def test_an_optional_library_absent_is_left_out(node, cuda_bin, tmp_path):
    (node.root / LIBDIR / f"libcudadebugger.so.{DRIVER}").unlink()
    (node.root / "usr" / "bin" / "nvidia-smi").unlink()
    spec_path = tmp_path / "spec.json"
    _run(node.args(cuda_bin["plugin"], f"--write-cdi-spec={spec_path}"),
         env=node.env())
    mounts = [m["containerPath"] for m in
              json.loads(spec_path.read_text())["containerEdits"]["mounts"]]
    assert mounts == [c for c, _ in _expected_mounts()
                      if "cudadebugger" not in c and "nvidia-smi" not in c]


def test_sigterm_exits_and_removes_the_socket(node, cuda_bin):
    proc = node.start(cuda_bin["plugin"], "--no-register")
    sock = node.plugdir / "kgct-cuda.sock"
    deadline = time.monotonic() + 10
    while not sock.exists():
        assert time.monotonic() < deadline and proc.poll() is None
        time.sleep(0.02)
    t0 = time.monotonic()
    proc.terminate()
    assert proc.wait(timeout=10) == 0
    assert time.monotonic() - t0 < node_layer.STOP_BOUND_S
    assert not sock.exists()


# -- the probe (phase 18's kubelet) against the plugin --------------------------

@pytest.mark.parametrize("name", ["hpack.h", "hpack.cc",
                                  "hpack_huffman_table.h", "http2.h",
                                  "http2.cc", "grpc.h", "grpc.cc", "pb.h"])
def test_the_transport_is_a_copy_of_the_tpu_plugins(name):
    """The carried files differ from the TPU plugin's by their header
    comment alone."""
    ours = (CUDA_DIR / "src" / name).read_text().splitlines()
    theirs = (TPU_DIR / "src" / name).read_text().splitlines()
    assert all(line.startswith("// ") for line in ours[:3])
    assert ours[3:] == theirs


def test_probe_reports_registration_and_allocations(node, cuda_bin):
    probe = subprocess.Popen(
        [str(cuda_bin["probe"]), f"--dir={node.plugdir}",
         f"--ids={UUID_A},{UUID_B}", f"--unknown={node_layer.UNKNOWN_ID}",
         "--timeout-s=20"], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        deadline = time.monotonic() + 10
        while not (node.plugdir / "kubelet.sock").exists():
            assert time.monotonic() < deadline and probe.poll() is None
            time.sleep(0.01)
        t0 = time.monotonic_ns()
        node.start(cuda_bin["plugin"])
        out, err = probe.communicate(timeout=30)
    finally:
        if probe.poll() is None:
            probe.kill()
    assert probe.returncode == 0, err
    got = json.loads(out)
    assert 0 < got["registered_at_ns"] - t0 < 10e9
    assert got["register"] == {
        "version": "v1beta1", "endpoint": "kgct-cuda.sock",
        "resource": "nvidia.com/gpu",
        "options": {"pre_start_required": False,
                    "get_preferred_allocation_available": False}}
    assert got["options"] == {"status": 0, "options": {
        "pre_start_required": False,
        "get_preferred_allocation_available": False}}
    assert [a["id"] for a in got["allocate"]] == [UUID_A, UUID_B]
    for a, (uuid, minor, _) in zip(got["allocate"], GPUS):
        assert a["status"] == 0 and a["us"] > 0
        (c,) = a["containers"]
        assert c["envs"] == {"NVIDIA_VISIBLE_DEVICES": uuid}
        assert [d["container_path"] for d in c["devices"]] == [
            f"/dev/nvidia{minor}"] + [f"/dev/{n}" for n in CONTROL]
        assert [(m["container_path"], m["host_path"], m["read_only"])
                for m in c["mounts"]] == [(cp, hp, True)
                                          for cp, hp in _expected_mounts()]
    assert got["unknown"]["status"] == 5
    assert node_layer.UNKNOWN_ID in got["unknown"]["message"]


def test_probe_exits_1_when_no_plugin_registers(cuda_bin, tmp_path):
    r = subprocess.run([str(cuda_bin["probe"]), f"--dir={tmp_path}",
                        f"--ids={UUID_A}", "--timeout-s=1"],
                       capture_output=True, text=True, timeout=30)
    assert r.returncode == 1 and "no plugin registered within 1 s" in r.stderr
    assert r.stdout == ""


def test_phase_18_helpers_link_the_mounts_and_find_strays(tmp_path):
    """The card check's pieces that need no card: the links named as the
    container paths, and a driver library mapped from outside the mounts."""
    host = tmp_path / "host"
    host.mkdir()
    for f in (f"libcuda.so.{DRIVER}", f"libnvidia-nvvm.so.{DRIVER}",
              "nvidia-smi", "libnvidia-glcore.so.1"):
        (host / f).touch()
    mounts = [{"container_path": "/usr/local/nvidia/lib64/libcuda.so.1",
               "host_path": str(host / f"libcuda.so.{DRIVER}")},
              {"container_path": "/usr/local/nvidia/lib64/libnvidia-nvvm.so.4",
               "host_path": str(host / f"libnvidia-nvvm.so.{DRIVER}")},
              {"container_path": "/usr/local/nvidia/bin/nvidia-smi",
               "host_path": str(host / "nvidia-smi")}]
    lib, bin_ = node_layer.injected_dirs(mounts, tmp_path / "nvidia")
    assert sorted(p.name for p in lib.iterdir()) == ["libcuda.so.1",
                                                     "libnvidia-nvvm.so.4"]
    assert (lib / "libnvidia-nvvm.so.4").resolve() == \
        host / f"libnvidia-nvvm.so.{DRIVER}"
    assert [p.name for p in bin_.iterdir()] == ["nvidia-smi"]
    maps = [str(lib / "libcuda.so.1"), str(host / "libnvidia-glcore.so.1"),
            "/usr/lib/x86_64-linux-gnu/libc.so.6", "/dev/nvidia3"]
    assert node_layer.driver_libs_outside(maps, mounts) == [
        str(host / "libnvidia-glcore.so.1")]


# -- the contract both plugins share ------------------------------------------

class _Flavor:
    def __init__(self, kind, binary, node, tmp):
        self.kind, self.binary, self.node = kind, binary, node
        if kind == "tpu":
            self.dev = tmp / "accel"
            self.dev.mkdir()
            for i in range(2):
                (self.dev / f"accel{i}").touch()
            self.plugdir = tmp / "tpu-plugins"
            self.plugdir.mkdir()
            self.sock, self.known, self.unknown = ("kgct-tpu.sock", "accel1",
                                                   "accel9")
        else:
            self.plugdir = node.plugdir
            self.sock, self.known, self.unknown = ("kgct-cuda.sock", UUID_B,
                                                   node_layer.UNKNOWN_ID)

    def args(self, *extra):
        if self.kind == "tpu":
            return [str(self.binary), f"--plugin-dir={self.plugdir}",
                    f"--dev-root={self.dev}", *extra]
        return self.node.args(self.binary, *extra)

    def env(self):
        return self.node.env()

    def start(self, *extra):
        proc = subprocess.Popen(self.args("--health-interval-s=1", *extra),
                                stderr=subprocess.DEVNULL, env=self.env())
        self.node.procs.append(proc)
        return proc


@pytest.mark.parametrize("kind", ["tpu", "cuda"])
def test_shared_contract_with_the_tpu_plugin(kind, node, tpu_bin, cuda_bin, pb,
                                             tmp_path):
    """Register v1beta1 with empty options; empty GetDevicePluginOptions;
    GetPreferredAllocation UNIMPLEMENTED; an unknown ID NOT_FOUND;
    re-registration on a new kubelet.sock; --oneshot exits 0 once its one
    ListAndWatch ends; a CDI write that comes up short fails and leaves no
    file."""
    f = _Flavor(kind, tpu_bin if kind == "tpu" else cuda_bin["plugin"], node,
                tmp_path)
    contract = {}
    kubelet = tpu_tests.FakeKubelet(pb, str(f.plugdir))
    try:
        proc = f.start("--oneshot")
        assert kubelet.event.wait(timeout=15)
        req = kubelet.requests[0]
        contract["register"] = (req.version, req.endpoint == f.sock,
                                req.HasField("options"),
                                req.options.SerializeToString())
        ch = _channel(f.plugdir, f.sock)
        opts = ch.unary_unary(
            "/v1beta1.DevicePlugin/GetDevicePluginOptions",
            request_serializer=pb.Empty.SerializeToString,
            response_deserializer=pb.DevicePluginOptions.FromString,
        )(pb.Empty(), timeout=10)
        contract["options"] = opts.SerializeToString()
        codes = []
        for method, req_msg, ser, de in (
                ("GetPreferredAllocation", pb.PreferredAllocationRequest(),
                 pb.PreferredAllocationRequest.SerializeToString,
                 pb.PreferredAllocationResponse.FromString),
                ("Allocate", None, None, None)):
            if req_msg is None:
                req_msg = pb.AllocateRequest()
                req_msg.container_requests.add().devicesIDs.append(f.unknown)
                ser = pb.AllocateRequest.SerializeToString
                de = pb.AllocateResponse.FromString
            with pytest.raises(grpc.RpcError) as e:
                ch.unary_unary(f"/v1beta1.DevicePlugin/{method}",
                               request_serializer=ser,
                               response_deserializer=de)(req_msg, timeout=10)
            codes.append(e.value.code())
        contract["codes"] = codes
        known = pb.AllocateRequest()
        known.container_requests.add().devicesIDs.append(f.known)
        contract["known"] = len(ch.unary_unary(
            "/v1beta1.DevicePlugin/Allocate",
            request_serializer=pb.AllocateRequest.SerializeToString,
            response_deserializer=pb.AllocateResponse.FromString,
        )(known, timeout=10).container_responses)

        # A restarted kubelet clears the directory, the plugin's socket
        # with it, and binds its socket under a new inode number: a file
        # holds the freed number while the new socket is bound (the TPU
        # plugin compares inode numbers alone; test_reregisters_after_
        # kubelet_restart lets the number be reused). The TPU plugin does
        # not serve again on a new socket, so the stream below rides the
        # channel opened before the restart (ROADMAP C15).
        kubelet.stop()
        for sock in ("kubelet.sock", f.sock):
            (f.plugdir / sock).unlink(missing_ok=True)
        (f.plugdir / "inode-holder").touch()
        kubelet = tpu_tests.FakeKubelet(pb, str(f.plugdir))
        (f.plugdir / "inode-holder").unlink()
        contract["reregistered"] = kubelet.event.wait(timeout=15)

        it = _watch(pb, ch)
        contract["first_push"] = len(next(it).devices)
        ch.close()
        try:
            contract["oneshot_rc"] = proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            contract["oneshot_rc"] = "still running"
    finally:
        kubelet.stop()

    # A CDI spec that cannot be written in full: /dev/full through a link
    # (so the failed write's unlink removes the link, never the device).
    link = tmp_path / "full.json"
    link.symlink_to("/dev/full")
    r = subprocess.run(f.args(f"--write-cdi-spec={link}"),
                       capture_output=True, text=True, env=f.env(),
                       timeout=30)
    contract["short_write"] = (r.returncode, "short write to" in r.stderr,
                               os.path.lexists(link))
    assert os.path.exists("/dev/full")

    assert contract == {
        "register": ("v1beta1", True, True, b""),
        "options": b"",
        "codes": [grpc.StatusCode.UNIMPLEMENTED, grpc.StatusCode.NOT_FOUND],
        "known": 1,
        "reregistered": True,
        "first_push": 2,
        "oneshot_rc": 0,
        "short_write": (1, True, False),
    }


def test_the_daemonsets_args_are_the_plugins_flags(cuda_bin, tmp_path):
    """The DaemonSet's args parse (no usage exit 2): on this host, with no
    /host, the plugin refuses for want of NVML under the driver root."""
    import yaml
    ds = yaml.safe_load((CUDA_DIR / "manifest" / "daemonset.yaml").read_text())
    (c,) = ds["spec"]["template"]["spec"]["containers"]
    args = [a.replace("/var/lib/kubelet/device-plugins", str(tmp_path))
            for a in c["args"]]
    assert c["command"] == [f"/{node_layer.PLUGIN}"]
    r = subprocess.run([str(cuda_bin["plugin"]), *args], capture_output=True,
                       text=True, timeout=30)
    assert r.returncode == 1, r.stderr
    assert "refused: NVML library libnvidia-ml.so.1 not found under the " \
        "driver root /host" in r.stderr
