"""The H100 node script (``cluster/scripts/gpu_node_setup.sh``) in DRY_RUN
mode and the node layer's DaemonSet, held statically.

The script is the counterpart of ``tpu_node_setup.sh``: these cases mirror
``tests/test_cluster_scripts.py``'s ``test_node_setup_*`` (teardown order,
NO_PROXY, the join's CRI socket, the CNI and its gate, the CoreDNS fix),
then pin the GPU phase: the labels read from ``nvidia-smi`` (a stand-in on
``PATH``), CDI enabled and its spec written by the plugin binary where it
is installed, no driver installed where none is found, a broken driver
refused, and the DaemonSet path. ``test_bash_syntax`` and
``test_shellcheck`` there glob ``cluster/scripts/*.sh`` and cover it too.
"""

from __future__ import annotations

import pathlib
import re
import subprocess

import pytest
import yaml

import test_cluster_scripts as tpu_scripts

REPO = pathlib.Path(__file__).resolve().parent.parent
SCRIPT = "gpu_node_setup.sh"
DAEMONSET = "cluster/device-plugin-cuda/manifest/daemonset.yaml"
SMI = ("#!/bin/sh\n"
       "printf 'NVIDIA H100 80GB HBM3, 580.159.03\\n"
       "NVIDIA H100 80GB HBM3, 580.159.03\\n'\n")


def _bin(tmp_path, **tools) -> str:
    """A PATH with stand-ins for ``tools`` (name -> script) first."""
    d = tmp_path / "bin"
    d.mkdir(parents=True, exist_ok=True)
    for name, text in tools.items():
        (d / name).write_text(text)
        (d / name).chmod(0o755)
    return f"{d}:/usr/bin:/bin:/usr/sbin:/sbin"


def run(*args, env=None):
    return tpu_scripts.run_script(SCRIPT, *args, env=env)


def test_gpu_node_setup_teardown_order():
    out = run("--role=control_plane", "--yes")
    stop = out.index("DRY: systemctl stop kubelet")
    rm = out.index("DRY: rm -rf /etc/kubernetes")
    init = out.index("DRY: kubeadm init")
    assert stop < rm < init
    assert out.index("DRY: swapoff") < init
    assert "DRY: kubeadm reset -f" in out


def test_gpu_node_setup_no_proxy_covers_cluster_cidrs():
    out = run("--role=control_plane", "--yes",
              env={"HTTP_PROXY_URL": "http://127.0.0.1:8118",
                   "POD_CIDR": "10.244.0.0/16",
                   "SERVICE_CIDR": "10.96.0.0/12"})
    (line,) = [ln for ln in out.splitlines() if "NO_PROXY=" in ln]
    for needed in ("10.244.0.0/16", "10.96.0.0/12", ".svc", ".cluster.local",
                   "localhost"):
        assert needed in line


@pytest.mark.parametrize("join, socket", [
    ("kubeadm join 10.0.0.1:6443 --token abc "
     "--discovery-token-ca-cert-hash sha256:xyz",
     "--cri-socket=unix:///run/containerd/containerd.sock"),
    ("kubeadm join 10.0.0.1:6443 --token abc --cri-socket=unix:///run/crio/"
     "crio.sock", "--cri-socket=unix:///run/crio/crio.sock")],
    ids=["appended", "kept"])
def test_gpu_node_setup_join_cri_socket(join, socket):
    out = run("--role=node", "--yes", f"--join={join}")
    (line,) = [ln for ln in out.splitlines()
               if "kubeadm join" in ln and "DRY" in ln]
    assert line.count("--cri-socket") == 1 and socket in line


def test_gpu_node_setup_labels_from_nvidia_smi(tmp_path):
    out = run("--role=control_plane", "--yes",
              env={"PATH": _bin(tmp_path, **{"nvidia-smi": SMI})})
    assert "GPU: count=2 product=NVIDIA-H100-80GB-HBM3 driver=580.159.03" \
        in out
    (label,) = [ln for ln in out.splitlines()
                if ln.startswith("DRY: kubectl label node")]
    assert label.endswith(" --overwrite kgct.io/gpu=true kgct.io/gpu-count=2 "
                          "kgct.io/gpu-product=NVIDIA-H100-80GB-HBM3")
    # Labels come after init, before the CNI.
    assert out.index("DRY: kubeadm init") < out.index(label) < \
        out.index("DRY: kubectl apply -f https://")


def test_gpu_node_setup_enables_cdi_and_writes_the_spec(tmp_path):
    path = _bin(tmp_path, **{"nvidia-smi": SMI,
                             "kgct-cuda-device-plugin": "#!/bin/sh\n"})
    out = run("--role=control_plane", "--yes", env={"PATH": path})
    assert "DRY: containerd config: enable_cdi = true" in out
    assert "DRY: mkdir -p /etc/cdi" in out
    assert ("DRY: kgct-cuda-device-plugin "
            "--write-cdi-spec=/etc/cdi/kgct-cuda.json") in out
    # Without the binary: CDI enabled, no spec written.
    out = run("--role=control_plane", "--yes",
              env={"PATH": _bin(tmp_path / "other", **{"nvidia-smi": SMI})})
    assert "enable_cdi = true" in out and "--write-cdi-spec" not in out
    assert "kgct-cuda-device-plugin not installed" in out


def test_gpu_node_setup_warns_where_it_cannot_enable_cdi(tmp_path):
    """Another runtime's socket: no containerd edit, and a warning that
    says so instead of a claim that CDI was enabled."""
    out = run("--role=control_plane", "--yes",
              "--cri-socket=unix:///run/crio/crio.sock",
              env={"PATH": _bin(tmp_path, **{"nvidia-smi": SMI})})
    assert "CDI not enabled: unix:///run/crio/crio.sock is not " \
        "containerd's" in out
    assert "enabling CDI" not in out and "enable_cdi = true" not in out


def test_gpu_node_setup_without_a_driver_labels_nothing():
    out = run("--role=control_plane", "--yes")
    assert "no NVIDIA driver (nvidia-smi not found)" in out
    assert "never installs one" in out
    assert "kubectl label" not in out and "enable_cdi" not in out
    for download in ("apt install nvidia", "cuda-drivers", ".run"):
        assert download not in out


def test_gpu_node_setup_refuses_a_broken_driver(tmp_path):
    path = _bin(tmp_path, **{"nvidia-smi": "#!/bin/sh\nexit 9\n"})
    r = subprocess.run(
        ["bash", str(tpu_scripts.SCRIPTS / SCRIPT), "--role=control_plane",
         "--yes"], capture_output=True, text=True, timeout=60,
        env={"PATH": path, "DRY_RUN": "1", "HOME": "/tmp"})
    assert r.returncode == 1
    assert "the driver is installed but not working" in r.stderr


def test_gpu_node_setup_applies_cni_and_points_at_the_daemonset():
    out = run("--role=control_plane", "--yes")
    assert ("DRY: kubectl apply -f https://raw.githubusercontent.com/"
            "projectcalico/calico/v3.28.0/manifests/calico.yaml") in out
    assert "DRY: wait for node Ready" in out
    assert f"kubectl apply -f {DAEMONSET}" in out
    assert (REPO / DAEMONSET).is_file()
    assert "cluster/device-plugin/manifest" not in out


def test_gpu_node_setup_cni_and_coredns_gates():
    out = run("--role=control_plane", "--yes", env={"APPLY_CNI": "0"})
    assert "skipping CNI" in out
    assert "calico.yaml" not in out.replace("skipping CNI", "")
    assert "coredns" not in run("--role=control_plane", "--yes")
    assert "patch configmap coredns" in run(
        "--role=control_plane", "--yes", env={"FIX_COREDNS": "1"})


def test_gpu_node_setup_flags_match_the_tpu_script():
    """The same flags, and an unknown one refused the same way."""
    def flags(name):
        text = (tpu_scripts.SCRIPTS / name).read_text()
        return sorted(re.findall(r"^\s+(--[^)\s]*)\) ", text, re.M))
    assert flags(SCRIPT) == flags("tpu_node_setup.sh")
    r = subprocess.run(["bash", str(tpu_scripts.SCRIPTS / SCRIPT), "--nope"],
                       capture_output=True, text=True, timeout=60,
                       env={"PATH": "/usr/bin:/bin", "DRY_RUN": "1"})
    assert r.returncode == 1 and "unknown flag: --nope" in r.stderr


def _container(ds):
    (c,) = ds["spec"]["template"]["spec"]["containers"]
    return c


def test_daemonset_is_the_tpu_ones_counterpart():
    gpu = yaml.safe_load((REPO / DAEMONSET).read_text())
    tpu = yaml.safe_load((REPO / "cluster" / "device-plugin" / "manifest" /
                          "daemonset.yaml").read_text())
    gspec, tspec = gpu["spec"]["template"]["spec"], tpu["spec"]["template"][
        "spec"]
    assert gspec["nodeSelector"] == {"kgct.io/gpu": "true"}
    assert tspec["tolerations"][0] in gspec["tolerations"]
    assert {"key": "nvidia.com/gpu", "operator": "Exists",
            "effect": "NoSchedule"} in gspec["tolerations"]
    assert gspec["priorityClassName"] == tspec["priorityClassName"]
    gc, tc = _container(gpu), _container(tpu)
    assert gc["resources"] == tc["resources"]
    assert gc["securityContext"] == tc["securityContext"]
    assert tc["volumeMounts"] == gc["volumeMounts"][:2]
    assert gc["volumeMounts"][2] == {"name": "host-root", "mountPath": "/host",
                                     "readOnly": True}
    assert tspec["volumes"] == gspec["volumes"][:2]
    assert gspec["volumes"][2] == {"name": "host-root",
                                   "hostPath": {"path": "/"}}
    assert "--driver-root=/host" in gc["args"]
    assert "--resource=nvidia.com/gpu" in gc["args"]
    assert gpu["metadata"]["namespace"] == "kube-system"


def test_the_script_labels_what_the_daemonset_selects(tmp_path):
    gpu = yaml.safe_load((REPO / DAEMONSET).read_text())
    ((key, value),) = gpu["spec"]["template"]["spec"]["nodeSelector"].items()
    out = run("--role=control_plane", "--yes",
              env={"PATH": _bin(tmp_path, **{"nvidia-smi": SMI})})
    assert f"{key}={value}" in out
