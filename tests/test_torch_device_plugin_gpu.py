"""The H100 node layer ON THE CARD: the device plugin's mounts alone give a
container a working CUDA.

Marked ``gpu``: the ``card`` fixture decides whether a card (and g++ and
``nvidia-smi``) is present and skips without one; the CPU proof of the
plugin is ``tests/test_torch_device_plugin.py`` (a stub NVML, a grpcio
kubelet). This file imports only torch and the port, so it runs on the
card's machine, which has no JAX:

    python -m pytest tests/test_torch_device_plugin_gpu.py -m gpu \\
        --noconftest -q

``tools/node_layer.py`` builds the plugin and its kubelet stand-in with
g++, runs them against the card's driver (``--plugin-dir`` in a temporary
directory) and starts a child with an empty environment but
``LD_LIBRARY_PATH`` (links named as the allocated mounts) and
``CUDA_VISIBLE_DEVICES``, as ``chip_smoke.py`` phase 18 does.
"""

import shutil

import pytest
import torch

from kubernetes_gpu_cluster_tpu_torch.tools import node_layer


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and its driver "
                    "(python3 chip_smoke.py phase 18 runs the same check)")
    for tool in ("g++", "nvidia-smi"):
        if shutil.which(tool) is None:
            pytest.skip(f"needs {tool}")
    return torch.cuda.device_count()


@pytest.mark.gpu
def test_the_mounts_alone_give_a_working_cuda(card, tmp_path):
    res = node_layer.check(card, tmp_path)
    cuda = res["cuda"]
    assert cuda["child"]["cuInit"] == 0 and cuda["child"]["count"] == 1
    assert cuda["child"]["cuModuleLoadData"] == 0
    assert cuda["outside"] == []
    assert set(cuda["env"]) == {"LD_LIBRARY_PATH", "CUDA_VISIBLE_DEVICES"}
    assert any(n.startswith("libcuda.so") for n in cuda["driver_libs"])
    assert res["inventory"]["uuids"][0] in cuda["nvidia_smi_L"]
    assert res["mounts"]["libcuda.so.1"].endswith(
        ".so." + res["inventory"]["driver"])
    assert res["stop_s"] < node_layer.STOP_BOUND_S
    # Nothing of the plugin's is left in the temporary plugin dir.
    assert not (tmp_path / "plugins" / node_layer.ENDPOINT).exists()
