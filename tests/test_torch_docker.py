"""The port's serving image, held statically: ``docker/Dockerfile.cuda-serving``
must build the image that the port's renderer names, from the port alone,
with its kernels compiled in a devel stage and served from a runtime stage
that has no ``nvcc``; ``docker/build_cuda.sh`` must tag it as the renderer
does and gate the build on ``scripts/check_torch.sh``.

There is no docker daemon here (and the build downloads base images and
wheels), so these are checks of the files: the stage graph, the COPY
sources, the kernel directory, the install lines, the entrypoint, the tag and
the scripts. ``chip_smoke.py`` phases 1, 14b and 14c reproduce the image's
situation on the card: kernels built by the image's command, a server
started by the rendered pod's command with no ``nvcc`` reachable.

The node layer's image, ``docker/Dockerfile.cuda-device-plugin``, is held
the same way: its COPY sources exist, its runtime stage copies the binary
the Makefile builds, its entrypoint is that binary, and the DaemonSet runs
it from the image the file's build line tags. The serving image sets
``LD_LIBRARY_PATH`` and ``PATH`` to where that plugin mounts the driver.
"""

from __future__ import annotations

import ast
import fnmatch
import os
import re
import shlex
import subprocess
import tomllib
from pathlib import Path

import pytest

from kubernetes_gpu_cluster_tpu_torch.deploy import render

REPO = Path(__file__).resolve().parent.parent
DOCKER = REPO / "docker"
DF = DOCKER / "Dockerfile.cuda-serving"
BUILD_SH = DOCKER / "build_cuda.sh"
CHECK_SH = REPO / "scripts" / "check_torch.sh"
PORT = "kubernetes_gpu_cluster_tpu_torch"


def _parse_dockerfile(path: Path) -> list:
    """``[(stage, base, [(INSTRUCTION, text), ...]), ...]``: continuation
    lines joined, comments dropped (the shape of ``tests/test_docker.py``'s
    parser, by stage)."""
    stages, logical, buf = [], [], ""
    for line in path.read_text().splitlines():
        if line.strip().startswith("#"):
            continue
        buf += line.rstrip()
        if buf.endswith("\\"):
            buf = buf[:-1] + " "
            continue
        if buf.strip():
            logical.append(" ".join(buf.split()))
        buf = ""
    for line in logical:
        op, _, rest = line.partition(" ")
        m = re.match(r"(\S+)(?:\s+AS\s+(\S+))?$", rest, re.I)
        if op.upper() == "FROM" and m:
            stages.append((m.group(2), m.group(1), []))
        else:
            stages[-1][2].append((op.upper(), rest))
    return stages


@pytest.fixture(scope="module")
def stages():
    return _parse_dockerfile(DF)


def _stage(stages, name):
    return next(s for s in stages if s[0] == name)


def _ops(stage, op):
    return [rest for o, rest in stage[2] if o == op]


def _env(stage) -> dict:
    env = {}
    for rest in _ops(stage, "ENV"):
        for part in shlex.split(rest):
            k, _, v = part.partition("=")
            env[k] = v
    return env


def _pyproject() -> dict:
    return tomllib.loads((REPO / "pyproject.toml").read_text())


def test_two_stages_and_the_runtime_is_not_devel(stages):
    assert [s[0] for s in stages] == ["kernels", "runtime"]
    kernels, runtime = stages
    assert kernels[1] == "nvidia/cuda:12.8.1-devel-ubuntu24.04"
    assert runtime[1] == "nvidia/cuda:12.8.1-runtime-ubuntu24.04"
    assert "-devel" not in runtime[1]


def test_copy_sources_exist_in_the_repo(stages):
    names = {s[0] for s in stages}
    for stage in stages:
        for rest in _ops(stage, "COPY"):
            args = rest.split()
            if args[0].startswith("--from="):
                assert args[0].split("=", 1)[1] in names
                continue
            for src in args[:-1]:
                assert (REPO / src).exists(), f"COPY source missing: {src}"


def test_only_the_port_enters_the_image(stages):
    copied = [src for s in stages for rest in _ops(s, "COPY")
              if not rest.startswith("--from=")
              for src in rest.split()[:-1]]
    assert sorted(copied) == ["kubernetes_gpu_cluster_tpu_torch",
                              "pyproject.toml"]
    # The repo's JAX package, the JAX image's entry and bench stay out.
    text = DF.read_text()
    assert "COPY kubernetes_gpu_cluster_tpu " not in text


def test_the_kernel_directory_agrees_in_both_stages(stages):
    kernels, runtime = stages
    kdir = _env(kernels)["KGCT_KERNEL_DIR"]
    assert kdir == _env(runtime)["KGCT_KERNEL_DIR"] == "/opt/kgct/kernels"
    assert f"--from=kernels {kdir} {kdir}" in _ops(runtime, "COPY")
    # The kernel directory is set before the build runs.
    ops = kernels[2]
    env_at = next(i for i, (o, r) in enumerate(ops)
                  if o == "ENV" and "KGCT_KERNEL_DIR" in r)
    run_at = next(i for i, (o, r) in enumerate(ops)
                  if o == "RUN" and "ops.cuda.build" in r)
    assert env_at < run_at


def test_the_kernel_run_is_the_command_chip_smoke_runs(stages):
    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    module = next(node.value.value for node in tree.body
                  if isinstance(node, ast.Assign)
                  and [t.id for t in node.targets] == ["BUILD_MODULE"])
    assert module == f"{PORT}.ops.cuda.build"
    builds = [r for r in _ops(_stage(stages, "kernels"), "RUN")
              if "ops.cuda.build" in r]
    assert builds == [f"python -m {module}"]
    from kubernetes_gpu_cluster_tpu_torch.ops.cuda import build
    assert build.__spec__.name == module and callable(build.main)


def test_no_install_names_jax_and_the_port_installs_without_deps(stages):
    installs = [r for s in stages for r in _ops(s, "RUN")
                if "pip install" in r or "apt-get install" in r]
    assert installs
    for r in installs:
        assert not re.search(r"\bjax", r), r
    port = [r for r in installs if re.search(r"pip install .*\s\.$", r)]
    assert port == ["pip install --no-cache-dir --no-deps ."]
    # pyproject's dependencies name jax: only --no-deps keeps it out.
    assert any(d.startswith("jax") for d in _pyproject()["project"][
        "dependencies"])
    assert any("torch==2.11.0" in r and "whl/cu128" in r for r in installs)


def test_the_runtime_stage_has_no_nvcc_and_no_build(stages):
    runtime = _stage(stages, "runtime")
    for rest in _ops(runtime, "RUN"):
        assert "nvcc" not in rest and "ops.cuda.build" not in rest
        assert "cuda-nvcc" not in rest and "toolkit" not in rest
    assert "CUDA_HOME" not in _env(runtime)
    assert "cuda/bin" not in _env(runtime).get("PATH", "")


def test_entrypoint_is_a_console_script_into_the_port(stages):
    runtime = _stage(stages, "runtime")
    (entry,) = _ops(runtime, "ENTRYPOINT")
    (script,) = ast.literal_eval(entry)
    target = _pyproject()["project"]["scripts"][script]
    mod, _, func = target.partition(":")
    assert mod.startswith(PORT + ".")
    import importlib
    assert callable(getattr(importlib.import_module(mod), func))
    assert _ops(runtime, "EXPOSE") == ["8000"]
    assert _ops(runtime, "VOLUME") == ["/models"]


def test_the_rendered_commands_name_modules_of_the_port():
    ms = render.render_values({"servingEngineSpec": {"modelSpec": [{
        "name": "m", "modelURL": "/models/m", "requestGPU": 1}]},
        "routerSpec": {"enableRouter": True}})
    commands = [c["command"] for m in ms.values() if isinstance(m, dict)
                for c in m.get("spec", {}).get("template", {}).get(
                    "spec", {}).get("containers", [])]
    modules = {c[2] for c in commands if c[:2] == ["python", "-m"]}
    assert modules == {f"{PORT}.serving.api_server", f"{PORT}.serving.router"}
    for mod in modules:
        path = REPO / Path(*mod.split("."))
        assert path.with_suffix(".py").is_file()
        assert "if __name__ == \"__main__\":" in \
            path.with_suffix(".py").read_text()
    assert all(c["image"] == render.DEFAULT_IMAGE for m in ms.values()
               if isinstance(m, dict)
               for c in m.get("spec", {}).get("template", {}).get(
                   "spec", {}).get("containers", []))


def test_build_script_tag_equals_the_renderer_image():
    sh = BUILD_SH.read_text()
    registry = re.search(r'REGISTRY="\$\{REGISTRY:-([^}]*)\}"', sh).group(1)
    tag = re.search(r'TAG="\$\{TAG:-([^}]*)\}"', sh).group(1)
    name = re.search(r'NAME="([^"]*)"', sh).group(1)
    assert f"{registry}/{name}:{tag}" == render.DEFAULT_IMAGE
    assert "--platform linux/amd64" in sh and "--push" in sh
    assert "docker/Dockerfile.cuda-serving" in sh


@pytest.mark.parametrize("path", [BUILD_SH, CHECK_SH], ids=lambda p: p.name)
def test_scripts_are_executable_bash(path):
    assert path.stat().st_mode & 0o111, f"{path.name} must be executable"
    subprocess.run(["bash", "-n", str(path)], check=True)
    assert "set -euo pipefail" in path.read_text()


def test_build_script_gates_on_check_torch_before_docker_build():
    sh = BUILD_SH.read_text()
    gate = sh.index('"${REPO_ROOT}/scripts/check_torch.sh" ${KGCT_CHECK_ARGS:-}')
    assert gate < sh.index("docker build")
    assert 'if [[ "${KGCT_SKIP_CHECKS:-0}" != 1 ]]' in sh
    assert "WARNING: KGCT_SKIP_CHECKS=1" in sh


def test_check_torch_lints_the_port_and_runs_its_tests():
    sh = CHECK_SH.read_text()
    assert "python -m kubernetes_gpu_cluster_tpu_torch.analysis" in sh
    assert "LINT_ARGS=(kubernetes_gpu_cluster_tpu_torch --sarif" in sh
    assert "_kgct_torch_check.sarif" in sh
    assert "--lint-only" in sh and "--changed" in sh
    assert ("JAX_PLATFORMS=cpu python -m pytest tests/test_torch_*.py -q "
            "-m 'not slow'") in sh
    assert "-p no:cacheprovider" in sh
    assert "rc=${PIPESTATUS[0]}" in sh


def test_check_torch_lint_only_runs_clean(tmp_path):
    proc = subprocess.run(["bash", str(CHECK_SH), "--lint-only"], cwd=REPO,
                          env={**os.environ,
                               "TMPDIR": str(tmp_path)},
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "0 finding(s)" in proc.stderr
    assert (tmp_path / "_kgct_torch_check.sarif").is_file()


def test_every_csrc_file_ships_as_package_data():
    globs = _pyproject()["tool"]["setuptools"]["package-data"][PORT]
    csrc = REPO / PORT / "csrc"
    files = [p.relative_to(REPO / PORT).as_posix() for p in csrc.iterdir()]
    assert files
    for f in files:
        assert any(fnmatch.fnmatch(f, g) for g in globs), f
    from kubernetes_gpu_cluster_tpu_torch.ops.cuda import build
    for n in build.KERNELS:
        assert (csrc / f"{n}.cu").is_file()


# -- the node layer's image (docker/Dockerfile.cuda-device-plugin) -----------

PLUGIN_DF = DOCKER / "Dockerfile.cuda-device-plugin"


@pytest.fixture(scope="module")
def plugin_stages():
    return _parse_dockerfile(PLUGIN_DF)


def test_device_plugin_image_copies_only_what_exists(plugin_stages):
    assert [s[0] for s in plugin_stages] == ["build", "runtime"]
    build, runtime = plugin_stages
    assert runtime[1] == "gcr.io/distroless/cc-debian12"
    (src,) = [r for r in _ops(build, "COPY")]
    assert src == "cluster/device-plugin-cuda ./cluster/device-plugin-cuda"
    assert (REPO / "cluster" / "device-plugin-cuda" / "Makefile").is_file()
    (copied,) = _ops(runtime, "COPY")
    frm, path, dest = copied.split()
    assert frm == "--from=build"
    assert path == ("/src/cluster/device-plugin-cuda/build/"
                    "kgct-cuda-device-plugin")
    # The Makefile's target is the binary the runtime stage copies.
    assert "$(BUILD)/kgct-cuda-device-plugin:" in (
        REPO / "cluster" / "device-plugin-cuda" / "Makefile").read_text()
    assert any("make -C cluster/device-plugin-cuda" in r
               for r in _ops(build, "RUN"))
    assert dest == "/kgct-cuda-device-plugin"


def test_device_plugin_image_entrypoint_is_the_binary(plugin_stages):
    runtime = plugin_stages[-1]
    (entry,) = _ops(runtime, "ENTRYPOINT")
    assert ast.literal_eval(entry) == ["/kgct-cuda-device-plugin"]
    # The DaemonSet runs that binary from the image this file builds.
    ds = (REPO / "cluster" / "device-plugin-cuda" / "manifest" /
          "daemonset.yaml").read_text()
    assert 'command: ["/kgct-cuda-device-plugin"]' in ds
    tag = re.search(r"-t (\S+) \.", PLUGIN_DF.read_text()).group(1)
    assert f"image: {tag}" in ds


def test_serving_image_finds_the_plugins_mounts(stages):
    """The plugin mounts the driver's libraries at /usr/local/nvidia/lib64
    and nvidia-smi at /usr/local/nvidia/bin: the runtime stage sets both
    paths itself."""
    env = _env(_stage(stages, "runtime"))
    assert env["LD_LIBRARY_PATH"] == "/usr/local/nvidia/lib64"
    path = env["PATH"].split(":")
    assert path[:2] == ["/opt/venv/bin", "/usr/local/nvidia/bin"]
    assert "$PATH" not in env["PATH"] and "/usr/bin" in path
    assert "NVIDIA container toolkit exposes" not in DF.read_text()
