"""The port's deploy renderer (``kubernetes_gpu_cluster_tpu_torch/deploy``)
against the JAX package's, and rendered pods that run the port.

- Every case of ``tests/test_deploy.py``, loaded from that file with its
  imports re-pointed at the port and ``google.com/tpu`` read as
  ``nvidia.com/gpu`` (the two exact substitutions the load makes); the
  reference-values cases stay gated on the reference checkout. The
  carried cases keep their names, prefixed ``test_deploy__`` (classes
  ``TestDeploy_``).
- Parity: each carried case runs again with every render going through
  both renderers: the port's manifests must equal the JAX renderer's after
  exactly ``SUBSTITUTIONS`` (whole strings, keys and values), a values
  dict one renderer refuses the other refuses with the same message, and
  every rendered engine container's ``args`` parse with the port CLI's
  parser. The charts differ only in ``description`` and ``keywords``.
- The multihost env: ``KGCT_NUM_PROCESSES`` is the pod count, and a pod
  of two cards at pp 2 runs two ranks.
- ``deploy/render.py`` and ``deploy/chart.py`` import without torch.
- Ranks per pod on the CPU: the rendered pp 2 StatefulSet of two-card pods
  started as two "pods" (each the rendered container command, args and
  env, with ``--device cpu``, the coordinator and follower addresses on
  localhost), each pod starting its second rank: pp 2 x tp 2, four gloo
  ranks streaming a local checkpoint; they serve the JAX pp 2 x tp 2
  engine's greedy tokens. A layout the pods do not divide fails at
  start with its message. Every wait has a deadline, so a hung rendezvous
  fails its test, not the run.
"""

from __future__ import annotations

import copy
import inspect
import json
import os
import signal
import socket
import subprocess
import sys
import time
import types
import urllib.error
import urllib.request
from pathlib import Path

import pytest
import torch
import yaml

from kubernetes_gpu_cluster_tpu.deploy import chart as jax_chart
from kubernetes_gpu_cluster_tpu.deploy import render as jax_render
from kubernetes_gpu_cluster_tpu_torch.deploy import chart as port_chart
from kubernetes_gpu_cluster_tpu_torch.deploy import render as port_render
from kubernetes_gpu_cluster_tpu_torch.serving.api_server import build_parser
from kubernetes_gpu_cluster_tpu_torch.serving.multihost import ranks_per_pod

torch.set_num_threads(2)

TESTS = Path(__file__).resolve().parent
REPO = TESTS.parent
PORT = "kubernetes_gpu_cluster_tpu_torch"

# The JAX renderer's strings -> the port's: the whole difference between
# the two renderers' manifests.
SUBSTITUTIONS = {
    "google.com/tpu": "nvidia.com/gpu",
    "kubernetes_gpu_cluster_tpu.serving.api_server":
        f"{PORT}.serving.api_server",
    "kubernetes_gpu_cluster_tpu.serving.router": f"{PORT}.serving.router",
    jax_render.DEFAULT_IMAGE: port_render.DEFAULT_IMAGE,
}


def _carry() -> types.ModuleType:
    """``tests/test_deploy.py`` re-pointed at the port's renderer."""
    path = TESTS / "test_deploy.py"
    src = path.read_text()
    for old, new in (("kubernetes_gpu_cluster_tpu.", PORT + "."),
                     ('"google.com/tpu"', '"nvidia.com/gpu"')):
        if old not in src:
            raise AssertionError(f"test_deploy.py: {old!r} no longer found")
        src = src.replace(old, new)
    mod = types.ModuleType("carried_test_deploy")
    mod.__file__ = str(path)
    sys.modules[mod.__name__] = mod
    exec(compile(src, str(path), "exec"), mod.__dict__)
    return mod


DEPLOY = _carry()
for _attr, _obj in list(vars(DEPLOY).items()):
    if _attr.startswith("Test") and inspect.isclass(_obj):
        globals()[f"TestDeploy_{_attr[len('Test'):]}"] = _obj
    elif _attr.startswith("test_") and callable(_obj):
        globals()[f"test_deploy__{_attr[len('test_'):]}"] = _obj


def _substituted(obj):
    if isinstance(obj, dict):
        return {SUBSTITUTIONS.get(k, k): _substituted(v)
                for k, v in obj.items()}
    if isinstance(obj, list):
        return [_substituted(v) for v in obj]
    if isinstance(obj, str):
        return SUBSTITUTIONS.get(obj, obj)
    return obj


def _engine_args(manifests: dict) -> list[list[str]]:
    out = []
    for m in manifests.values():
        if m["kind"] in ("Deployment", "StatefulSet"):
            for c in m["spec"]["template"]["spec"]["containers"]:
                if c["name"] == "serving-engine":
                    out.append(c["args"])
    return out


_PORT_RENDER = port_render.render_values


def _both(values: dict, renders: list) -> dict:
    """Render ``values`` with both renderers and hold the port's to the
    JAX renderer's; record the values dict."""
    renders.append(copy.deepcopy(values))
    try:
        want = jax_render.render_values(copy.deepcopy(values))
    except Exception as e:   # noqa: BLE001 - the port must refuse alike
        with pytest.raises(type(e)) as got:
            _PORT_RENDER(values)
        assert str(got.value) == str(e)
        raise
    got = _PORT_RENDER(values)
    assert got == _substituted(want)
    parser = build_parser()
    for args in _engine_args(got):
        parser.parse_args(args)
    return got


PARITY_CASES = sorted(
    [name for name, obj in vars(DEPLOY).items()
     if name.startswith("test_") and inspect.isfunction(obj)
     and set(inspect.signature(obj).parameters) <= {"tmp_path"}]
    + [f"{cls}.{name}" for cls, obj in vars(DEPLOY).items()
       if cls.startswith("Test") and inspect.isclass(obj)
       for name, fn in vars(obj).items()
       if name.startswith("test_")
       and set(inspect.signature(fn).parameters) <= {"self", "tmp_path"}])


@pytest.mark.parametrize("case", PARITY_CASES)
def test_port_renders_the_jax_manifests(case, monkeypatch, tmp_path):
    """The carried case ``case`` again, every render through ``_both``."""
    renders: list = []
    both = lambda values: _both(values, renders)   # noqa: E731
    for mod in (DEPLOY, port_render, port_chart):
        monkeypatch.setattr(mod, "render_values", both)
    owner, _, name = case.rpartition(".")
    fn = getattr(getattr(DEPLOY, owner)(), name) if owner \
        else getattr(DEPLOY, name)
    kw = {"tmp_path": tmp_path} \
        if "tmp_path" in inspect.signature(fn).parameters else {}
    fn(**kw)
    assert renders, f"{case} rendered nothing"


def test_charts_differ_only_in_description_and_keywords(tmp_path):
    values = copy.deepcopy(DEPLOY.VALUES)
    jax_files = jax_chart.emit_chart(values, str(tmp_path / "jax"))
    port_files = port_chart.emit_chart(values, str(tmp_path / "port"))
    assert jax_files == port_files
    for rel in port_files:
        want = (tmp_path / "jax" / rel).read_text()
        got = (tmp_path / "port" / rel).read_text()
        if rel == "Chart.yaml":
            want, got = yaml.safe_load(want), yaml.safe_load(got)
            assert {k for k in want if want[k] != got[k]} == {
                "description", "keywords"}
            assert "cuda" in got["keywords"] and "tpu" not in got["keywords"]
        elif rel.startswith("templates/") and rel.endswith(".yaml"):
            assert yaml.safe_load(got) == _substituted(yaml.safe_load(want))
        else:
            assert got == want, rel


def test_multihost_env_counts_pods_and_ranks_per_pod():
    """pp 2 with two cards a pod: two pods (``KGCT_NUM_PROCESSES`` 2), each
    requesting two ``nvidia.com/gpu`` and tp 2; the port's world of four
    ranks runs two a pod."""
    values = copy.deepcopy(DEPLOY.VALUES)
    spec = values["servingEngineSpec"]["modelSpec"][0]
    spec["vllmConfig"] = {"pipelineParallelSize": 2}
    sts = port_render.render_values(values)["qwen3-engine-statefulset.yaml"]
    assert sts["spec"]["replicas"] == 2
    c = sts["spec"]["template"]["spec"]["containers"][0]
    env = {e["name"]: e.get("value") for e in c["env"]}
    assert env["KGCT_NUM_PROCESSES"] == "2"
    assert c["resources"]["limits"]["nvidia.com/gpu"] == 2
    args = build_parser().parse_args(c["args"])
    world = args.tensor_parallel_size * args.pipeline_parallel_size
    assert args.distributed and world == 4
    assert ranks_per_pod(world, int(env["KGCT_NUM_PROCESSES"])) == 2
    with pytest.raises(ValueError, match="does not divide"):
        ranks_per_pod(4, 3)


def test_follower_addresses_cover_every_local_rank(monkeypatch):
    """Without KGCT_FOLLOWER_ADDRS rank 0 dials every other rank: local
    rank k of pod q at pod q's DNS name, port KGCT_CONTROL_PORT + k."""
    from kubernetes_gpu_cluster_tpu_torch.serving.multihost import \
        follower_addrs_from_env
    monkeypatch.delenv("KGCT_FOLLOWER_ADDRS", raising=False)
    monkeypatch.delenv("KGCT_CONTROL_PORT", raising=False)
    monkeypatch.setenv("KGCT_COORDINATOR",
                       "kgct-m-engine-0.kgct-m-engine-hl:8476")
    monkeypatch.setenv("KGCT_NUM_PROCESSES", "2")
    assert follower_addrs_from_env(4) == [
        "kgct-m-engine-0.kgct-m-engine-hl:8478",
        "kgct-m-engine-1.kgct-m-engine-hl:8477",
        "kgct-m-engine-1.kgct-m-engine-hl:8478"]
    assert follower_addrs_from_env() == ["kgct-m-engine-1.kgct-m-engine-hl:"
                                         "8477"]
    monkeypatch.setenv("KGCT_FOLLOWER_ADDRS", "a:1,b:2")
    assert follower_addrs_from_env(4) == ["a:1", "b:2"]


def test_render_imports_without_torch():
    code = (
        "import sys; sys.modules['torch'] = None\n"
        "from kubernetes_gpu_cluster_tpu_torch.deploy.render import "
        "render_values\n"
        "from kubernetes_gpu_cluster_tpu_torch.deploy.chart import "
        "emit_chart\n"
        "v = {'servingEngineSpec': {'modelSpec': [{'name': 'm', "
        "'modelURL': '/models/llama', 'requestGPU': 1}]}}\n"
        "assert render_values(v)\n"
        "assert 'torch' not in [m for m in sys.modules if sys.modules[m]]\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=60)
    assert r.returncode == 0, r.stderr[-2000:]


# -- rendered pods on the CPU ------------------------------------------------

# The pod's container command run in-process, with each finished
# request's tokens recorded by prompt (the engine's, not the HTTP text).
POD_SHIM = r'''
import json, os, runpy, sys
sys.path.insert(0, os.environ["KGCT_REPO"])
from kubernetes_gpu_cluster_tpu_torch.engine.engine import LLMEngine
served, step = [], LLMEngine.step


def recorded(self):
    outs = step(self)
    served.extend([o.prompt_token_ids, o.output_token_ids]
                  for o in outs if o.finished)
    return outs
LLMEngine.step = recorded
module = sys.argv[2]
sys.argv = [module] + sys.argv[3:]
try:
    runpy.run_module(module, run_name="__main__", alter_sys=True)
finally:
    with open(os.environ["KGCT_TEST_OUT"], "w") as f:
        json.dump(served, f)
'''

POD_PROMPTS = [[1, 5, 9, 2, 44], [3, 3, 7], [11, 12, 13, 14, 15, 16, 17]]
POD_TOKENS = 8
POD_DEADLINE_S = 180


def _port_pair() -> int:
    """A port p with p and p + 1 free (a pod's two control ports)."""
    for _ in range(50):
        with socket.socket() as a:
            a.bind(("127.0.0.1", 0))
            p = a.getsockname()[1]
            try:
                with socket.socket() as b:
                    b.bind(("127.0.0.1", p + 1))
                    return p
            except OSError:
                continue
    raise RuntimeError("no two adjacent free ports")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def tiny_ckpt(tmp_path_factory):
    """A checkpoint of debug-tiny's shapes that ``transformers`` saved; the
    dir's name maps ``--model <dir>`` to the debug-tiny preset."""
    from transformers import LlamaConfig, LlamaForCausalLM
    from kubernetes_gpu_cluster_tpu_torch.config import get_model_config
    cfg = get_model_config("debug-tiny")
    torch.manual_seed(5)
    model = LlamaForCausalLM(LlamaConfig(
        vocab_size=cfg.vocab_size, hidden_size=cfg.hidden_size,
        intermediate_size=cfg.intermediate_size,
        num_hidden_layers=cfg.num_layers, num_attention_heads=cfg.num_heads,
        num_key_value_heads=cfg.num_kv_heads, head_dim=cfg.head_dim,
        rms_norm_eps=cfg.rms_norm_eps, rope_theta=cfg.rope_theta,
        max_position_embeddings=cfg.max_model_len)).eval()
    path = tmp_path_factory.mktemp("pods") / "debug-tiny"
    model.save_pretrained(path, safe_serialization=True,
                          max_shard_size="200KB")
    return str(path)


def _statefulset(ckpt: str, **cfg) -> dict:
    values = {"servingEngineSpec": {"modelSpec": [{
        "name": "tiny", "modelURL": ckpt, "requestGPU": 2,
        "vllmConfig": {"pipelineParallelSize": 2,
                       "extraArgs": ["--tokenizer", "byte",
                                     "--max-num-seqs", "4"], **cfg}}]}}
    return port_render.render_values(values)["tiny-engine-statefulset.yaml"]


def _pod_env(container: dict, pod: int, **extra) -> dict:
    env = dict(os.environ, KGCT_REPO=str(REPO), GLOO_SOCKET_IFNAME="lo",
               OMP_NUM_THREADS="1")
    for e in container["env"]:
        if "value" in e:
            env[e["name"]] = e["value"]
    env["KGCT_PROCESS_ID"] = str(pod)     # the pod-index label
    env.update(extra)
    return env


def _jax_pod_tokens(ckpt: str) -> dict:
    from kubernetes_gpu_cluster_tpu.config import CacheConfig as JCache
    from kubernetes_gpu_cluster_tpu.config import \
        EngineConfig as JEngineConfig
    from kubernetes_gpu_cluster_tpu.config import SchedulerConfig as JSched
    from kubernetes_gpu_cluster_tpu.config import get_model_config as jmodel
    from kubernetes_gpu_cluster_tpu.engine import LLMEngine as JaxEngine
    from kubernetes_gpu_cluster_tpu.engine import SamplingParams as JParams
    from kubernetes_gpu_cluster_tpu.engine.engine import resolve_shardings
    from kubernetes_gpu_cluster_tpu.engine.weights import load_weights
    from kubernetes_gpu_cluster_tpu.parallel import make_mesh as jax_mesh
    cfg = jmodel("debug-tiny")
    mesh = jax_mesh(pp=2, tp=2)
    shardings, _ = resolve_shardings(mesh, cfg)
    eng = JaxEngine(JEngineConfig(
        model=cfg, cache=JCache(page_size=8, num_pages=64),
        scheduler=JSched(max_num_seqs=4, max_prefill_tokens=64,
                         decode_buckets=(1, 2, 4), prefill_buckets=(32, 64))),
        params=load_weights(ckpt, cfg, shardings=shardings),
        eos_token_id=2, mesh=mesh)
    outs = eng.generate(POD_PROMPTS, JParams(max_tokens=POD_TOKENS,
                                             temperature=0.0))
    return {tuple(p): o.output_token_ids for p, o in zip(POD_PROMPTS, outs)}


def _wait_health(url: str, procs: list, deadline: float) -> None:
    while True:
        try:
            with urllib.request.urlopen(url, timeout=2):
                return
        except (urllib.error.URLError, OSError):
            for p in procs:
                assert p.poll() is None, f"a pod exited {p.returncode}"
            assert time.monotonic() < deadline, f"{url} never came up"
            time.sleep(0.5)


def _complete(port: int, prompt: list) -> dict:
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/completions",
        data=json.dumps({"prompt": prompt, "max_tokens": POD_TOKENS,
                         "temperature": 0}).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


@pytest.mark.skipif(sys.platform != "linux", reason="localhost gloo test")
def test_rendered_pods_run_two_ranks_each(tiny_ckpt, tmp_path):
    """Two pods of the rendered StatefulSet, two local ranks each:
    pp 2 x tp 2 over four gloo ranks that stream the checkpoint, serving
    the JAX pp 2 x tp 2 engine's greedy tokens; SIGTERM on pod 0 drains it
    and the stop lets every rank exit 0."""
    from test_torch_distributed import _children
    c = _statefulset(tiny_ckpt)["spec"]["template"]["spec"]["containers"][0]
    assert c["command"][:2] == ["python", "-m"]
    coord = f"127.0.0.1:{_free_port()}"
    bases = [_port_pair(), _port_pair()]
    http = [_free_port(), _free_port()]
    followers = [f"127.0.0.1:{bases[0] + 1}", f"127.0.0.1:{bases[1]}",
                 f"127.0.0.1:{bases[1] + 1}"]
    shim = tmp_path / "pod.py"
    shim.write_text(POD_SHIM)
    procs, logs = [], []
    for pod in range(2):
        logs.append(open(tmp_path / f"pod{pod}.log", "w"))
        env = _pod_env(c, pod, KGCT_COORDINATOR=coord,
                       KGCT_CONTROL_PORT=str(bases[pod]),
                       KGCT_FOLLOWER_ADDRS=",".join(followers),
                       KGCT_TEST_OUT=str(tmp_path / f"pod{pod}.json"),
                       KGCT_FLIGHT_DIR=str(tmp_path))
        procs.append(subprocess.Popen(
            [sys.executable, str(shim), *c["command"][1:], *c["args"],
             "--device", "cpu", "--host", "127.0.0.1",
             "--port", str(http[pod])],
            cwd=REPO, env=env, stdout=logs[-1], stderr=subprocess.STDOUT))
    want = _jax_pod_tokens(tiny_ckpt)
    try:
        deadline = time.monotonic() + POD_DEADLINE_S
        _wait_health(f"http://127.0.0.1:{http[0]}/health", procs, deadline)
        local = [_children(p.pid) for p in procs]
        assert [len(x) for x in local] == [1, 1], local
        replies = [_complete(http[0], p) for p in POD_PROMPTS]
        procs[0].send_signal(signal.SIGTERM)
        rcs = [p.wait(timeout=max(deadline - time.monotonic(), 1.0))
               for p in procs]
        assert rcs == [0, 0], rcs
        for pid in sum(local, []):
            assert not Path(f"/proc/{pid}").exists(), "a local rank is left"
    except BaseException:
        for f in logs:
            f.flush()
        print("\n".join((tmp_path / f"pod{i}.log").read_text()[-3000:]
                        for i in range(2)))
        raise
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    served = {tuple(p): t for p, t in
              json.loads((tmp_path / "pod0.json").read_text())}
    for prompt, reply in zip(POD_PROMPTS, replies):
        assert served[tuple(prompt)] == want[tuple(prompt)], prompt
        assert reply["usage"]["completion_tokens"] == len(want[tuple(prompt)])


def test_layout_the_pods_do_not_divide_fails_at_start(tiny_ckpt, tmp_path):
    """The rendered pod with KGCT_NUM_PROCESSES 3 (a world of 4): the CLI
    exits at once with the reason, before any rendezvous."""
    c = _statefulset(tiny_ckpt)["spec"]["template"]["spec"]["containers"][0]
    env = _pod_env(c, 0, KGCT_NUM_PROCESSES="3",
                   KGCT_COORDINATOR=f"127.0.0.1:{_free_port()}")
    t0 = time.monotonic()
    r = subprocess.run([sys.executable, *c["command"][1:], *c["args"],
                        "--device", "cpu", "--port", str(_free_port())],
                       cwd=REPO, env=env, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode != 0
    assert "does not divide over KGCT_NUM_PROCESSES=3 pods" in r.stderr
    assert time.monotonic() - t0 < 60
