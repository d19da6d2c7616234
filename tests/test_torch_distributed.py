"""Two real OS processes over the ``KGCT_*`` bootstrap, on the CPU (gloo):
the JAX package's ``tests/test_distributed.py`` re-pointed at the port.

- The bootstrap: ``parallel.initialize_distributed()`` reads
  ``KGCT_COORDINATOR`` / ``KGCT_NUM_PROCESSES`` / ``KGCT_PROCESS_ID``, and
  an all-reduce and a tp all-gather cross the process boundary.
- The full engine: an ``LLMEngine`` at tp 2 spanning the two processes
  (random weights from the seed, each rank drawing the full tensors and
  keeping its slice) greedy-decodes exactly the single-process engine's
  tokens, on both ranks.
- Leader/follower serving: rank 0 drives ``AsyncLLMEngine(leader=
  DirectiveLeader)`` with a second request submitted mid-flight, rank 1
  follows the directive stream; the tokens equal the single-process
  engine's.
- The CLI on one node: ``--tensor-parallel-size 2`` (and
  ``--pipeline-parallel-size 2``, ``--sequence-parallel-size 2``) without
  ``--distributed`` starts its second rank itself, answers a completion
  exactly as a one-rank server on the same seed does, and on SIGINT stops
  the rank it started.

No JAX in the ranks; the references run in this process.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import time
import urllib.error
import urllib.request
from pathlib import Path

import pytest
import torch

from kubernetes_gpu_cluster_tpu_torch.config import (CacheConfig,
                                                     EngineConfig,
                                                     SchedulerConfig,
                                                     get_model_config)
from kubernetes_gpu_cluster_tpu_torch.engine import LLMEngine, SamplingParams
from kubernetes_gpu_cluster_tpu_torch.serving.api_server import build_server
from test_torch_api_server import start_port_server
from test_torch_parallel import (finish_ranks, free_port, rank_env,
                                 result_of, start_ranks)

torch.set_num_threads(2)

PROMPTS = [[1, 5, 9, 2], [3, 3, 7]]

BOOTSTRAP = r"""
import os, sys
import torch
sys.path.insert(0, os.environ["KGCT_REPO"])
from kubernetes_gpu_cluster_tpu_torch.parallel import (initialize_distributed,
                                                       make_mesh)
assert initialize_distributed(device="cpu", timeout_s=60)
import torch.distributed as dist
assert dist.get_world_size() == 2 and dist.get_backend() == "gloo"
rank = dist.get_rank()
groups = make_mesh(tp=2)
assert groups.tp_rank == rank
# 1) a cross-process sum: each rank contributes rank + 1.
x = torch.full((1, 4), float(rank + 1))
groups.all_reduce(x)
assert torch.all(x == 3.0), x
# 2) the logits' all-gather: rank order along the last axis.
y = groups.all_gather(torch.full((2, 3), float(rank)), dim=-1)
assert y.tolist() == [[0.0] * 3 + [1.0] * 3] * 2, y
assert groups.world_min(10 + rank) == 10
assert groups.world_agree(7) and not groups.world_agree(rank)
print(f"RANK{rank}-OK", flush=True)
dist.destroy_process_group()
"""

_CFG = r"""
from kubernetes_gpu_cluster_tpu_torch.config import (
    CacheConfig, EngineConfig, ParallelConfig, SchedulerConfig,
    get_model_config)
cfg = EngineConfig(
    model=get_model_config("debug-tiny"),
    cache=CacheConfig(page_size=16, num_pages=64),
    scheduler=SchedulerConfig(max_num_seqs=4, max_prefill_tokens=128,
                              decode_buckets=(1, 2, 4),
                              prefill_buckets=(64, 128)),
    parallel=ParallelConfig(tp=2, lockstep_check=LOCKSTEP))
"""

ENGINE_WORKER = r"""
import json, os, sys
import torch
torch.set_num_threads(1)
sys.path.insert(0, os.environ["KGCT_REPO"])
from kubernetes_gpu_cluster_tpu_torch.parallel import initialize_distributed
initialize_distributed(device="cpu", timeout_s=60)
import torch.distributed as dist
LOCKSTEP = True
""" + _CFG + r"""
from kubernetes_gpu_cluster_tpu_torch.engine import LLMEngine, SamplingParams
from kubernetes_gpu_cluster_tpu_torch.parallel import mesh_from_config
eng = LLMEngine(cfg, device="cpu", groups=mesh_from_config(cfg.parallel))
assert eng.groups is not None and eng.groups.tp == 2
prompts = json.loads(os.environ["KGCT_TEST_PROMPTS"])
outs = eng.generate([list(p) for p in prompts],
                    SamplingParams(temperature=0.0, max_tokens=8))
print(f"RANK{dist.get_rank()}-TOKENS:"
      + json.dumps([o.output_token_ids for o in outs]), flush=True)
dist.destroy_process_group()
"""

SERVING_LEADER = r"""
import asyncio, json, os, sys
import torch
torch.set_num_threads(1)
sys.path.insert(0, os.environ["KGCT_REPO"])
from kubernetes_gpu_cluster_tpu_torch.parallel import initialize_distributed
initialize_distributed(device="cpu", timeout_s=60)
LOCKSTEP = False
""" + _CFG + r"""
from kubernetes_gpu_cluster_tpu_torch.engine import SamplingParams
from kubernetes_gpu_cluster_tpu_torch.serving.async_engine import \
    AsyncLLMEngine
from kubernetes_gpu_cluster_tpu_torch.serving.multihost import (
    DirectiveLeader, follower_addrs_from_env)

from kubernetes_gpu_cluster_tpu_torch.parallel import mesh_from_config
eng = AsyncLLMEngine(cfg, device="cpu",
                     groups=mesh_from_config(cfg.parallel),
                     leader=DirectiveLeader(follower_addrs_from_env()))

async def main():
    eng.start(asyncio.get_running_loop())
    prompts = json.loads(os.environ["KGCT_TEST_PROMPTS"])
    async def run_one(i, p):
        toks = []
        async for chunk in eng.generate(f"r{i}", list(p), SamplingParams(
                temperature=0.0, max_tokens=8)):
            toks = chunk.output_token_ids
        return toks
    # The second request joins mid-flight: admissions at different steps.
    t0 = asyncio.create_task(run_one(0, prompts[0]))
    await asyncio.sleep(0.2)
    t1 = asyncio.create_task(run_one(1, prompts[1]))
    print("LEADER-TOKENS:" + json.dumps([await t0, await t1]), flush=True)

asyncio.run(main())
eng.shutdown()
"""

SERVING_FOLLOWER = r"""
import os, sys
import torch
torch.set_num_threads(1)
sys.path.insert(0, os.environ["KGCT_REPO"])
from kubernetes_gpu_cluster_tpu_torch.serving.multihost import \
    DirectiveFollower
# Bound before the rendezvous blocks on the process group.
follower = DirectiveFollower(port=int(os.environ["KGCT_CONTROL_PORT"]),
                             host="127.0.0.1")
from kubernetes_gpu_cluster_tpu_torch.parallel import initialize_distributed
initialize_distributed(device="cpu", timeout_s=60)
LOCKSTEP = False
""" + _CFG + r"""
from kubernetes_gpu_cluster_tpu_torch.engine import LLMEngine
from kubernetes_gpu_cluster_tpu_torch.parallel import mesh_from_config
eng = LLMEngine(cfg, device="cpu", groups=mesh_from_config(cfg.parallel))
follower.run(eng)
print("FOLLOWER-DONE", flush=True)
"""


def _single_process_tokens() -> list:
    cfg = EngineConfig(
        model=get_model_config("debug-tiny"),
        cache=CacheConfig(page_size=16, num_pages=64),
        scheduler=SchedulerConfig(max_num_seqs=4, max_prefill_tokens=128,
                                  decode_buckets=(1, 2, 4),
                                  prefill_buckets=(64, 128)))
    return [o.output_token_ids for o in LLMEngine(cfg, device="cpu").generate(
        PROMPTS, SamplingParams(temperature=0.0, max_tokens=8))]


@pytest.mark.skipif(sys.platform != "linux", reason="localhost gloo test")
def test_two_process_bootstrap_collectives(tmp_path):
    script = tmp_path / "worker.py"
    script.write_text(BOOTSTRAP)
    outs = finish_ranks(start_ranks(script, 2), timeout_s=120)
    for rank, (rc, out, err) in enumerate(outs):
        assert rc == 0, f"rank {rank} failed:\n{err[-3000:]}"
        assert f"RANK{rank}-OK" in out, (out, err[-1000:])


@pytest.mark.skipif(sys.platform != "linux", reason="localhost gloo test")
def test_two_process_full_engine(tmp_path):
    expected = _single_process_tokens()
    script = tmp_path / "engine_worker.py"
    script.write_text(ENGINE_WORKER)
    outs = finish_ranks(start_ranks(script, 2,
                                    KGCT_TEST_PROMPTS=json.dumps(PROMPTS)),
                        timeout_s=180)
    for rank, out in enumerate(outs):
        got = result_of(out, f"RANK{rank}-TOKENS:")
        assert got == expected, f"rank {rank}: {got} vs {expected}"


@pytest.mark.skipif(sys.platform != "linux", reason="localhost gloo test")
def test_two_process_serving_leader_follower(tmp_path):
    """Only rank 0 is driven (the AsyncLLMEngine front door, as behind the
    HTTP API); rank 1 follows the step-directive stream; the pair gives
    the single-process engine's greedy tokens."""
    expected = _single_process_tokens()
    ctrl = free_port()
    scripts = [tmp_path / "leader.py", tmp_path / "follower.py"]
    scripts[0].write_text(SERVING_LEADER)
    scripts[1].write_text(SERVING_FOLLOWER)
    coordinator = f"127.0.0.1:{free_port()}"
    procs = [subprocess.Popen(
        [sys.executable, str(scripts[r])],
        env=rank_env(2, r, coordinator, KGCT_CONTROL_PORT=str(ctrl),
                     KGCT_FOLLOWER_ADDRS=f"127.0.0.1:{ctrl}",
                     KGCT_TEST_PROMPTS=json.dumps(PROMPTS)),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in (0, 1)]
    lead, follow = finish_ranks(procs, timeout_s=180)
    assert follow[0] == 0, f"follower failed:\n{follow[2][-3000:]}"
    assert "FOLLOWER-DONE" in follow[1], (follow[1], follow[2][-800:])
    assert result_of(lead, "LEADER-TOKENS:") == expected


def _children(pid: int) -> list[int]:
    out = []
    for stat in Path("/proc").glob("[0-9]*/stat"):
        try:
            fields = stat.read_text().rsplit(")", 1)[1].split()
        except OSError:
            continue
        if int(fields[1]) == pid:
            out.append(int(stat.parent.name))
    return out


def _post(base: str, body: dict) -> dict:
    req = urllib.request.Request(base + "/v1/completions",
                                 data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def _one_rank_text(body: dict) -> str:
    """The same request on an in-process one-rank server (the CLI's
    defaults, the same seed)."""
    server = build_server(EngineConfig(model=get_model_config("debug-tiny"),
                                       scheduler=SchedulerConfig(
                                           max_num_seqs=4)), device="cpu")
    loop, client, stop = start_port_server(server)
    try:
        async def go():
            r = await client.post("/v1/completions", json=body)
            return await r.json()
        return loop.run_until_complete(go())["choices"][0]["text"]
    finally:
        stop()


@pytest.mark.skipif(sys.platform != "linux", reason="localhost gloo test")
def test_cli_tp2_on_one_node_starts_and_stops_its_rank(tmp_path):
    _cli_on_one_node(tmp_path, "--tensor-parallel-size")


@pytest.mark.skipif(sys.platform != "linux", reason="localhost gloo test")
@pytest.mark.parametrize("flag", ["--pipeline-parallel-size",
                                  "--sequence-parallel-size"])
def test_cli_pp_and_sp_on_one_node(tmp_path, flag):
    """The same at pp 2 (a stage each) and sp 2 (the prefill's attention
    around the ring)."""
    _cli_on_one_node(tmp_path, flag)


def _cli_on_one_node(tmp_path, flag: str) -> None:
    port = free_port()
    env = dict(os.environ, GLOO_SOCKET_IFNAME="lo", OMP_NUM_THREADS="1",
               KGCT_FLIGHT_DIR=str(tmp_path))
    proc = subprocess.Popen(
        [sys.executable, "-m", "kubernetes_gpu_cluster_tpu_torch.serving."
         "api_server", "--model", "debug-tiny", "--device", "cpu",
         flag, "2", "--max-num-seqs", "4",
         "--host", "127.0.0.1", "--port", str(port)],
        cwd=str(Path(__file__).resolve().parents[1]), env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    base = f"http://127.0.0.1:{port}"
    body = {"prompt": [1, 5, 9, 2], "max_tokens": 8, "temperature": 0}
    try:
        deadline = time.monotonic() + 120
        while True:
            try:
                with urllib.request.urlopen(base + "/health", timeout=2):
                    break
            except (urllib.error.URLError, OSError):
                assert proc.poll() is None, proc.stdout.read()[-3000:]
                assert time.monotonic() < deadline, "server never came up"
                time.sleep(0.5)
        ranks = _children(proc.pid)
        assert len(ranks) == 1, ranks
        got = _post(base, body)
        assert got["usage"]["completion_tokens"] == 8
        proc.send_signal(signal.SIGINT)
        proc.wait(timeout=60)
        assert proc.returncode == 0, proc.stdout.read()[-3000:]
        assert not Path(f"/proc/{ranks[0]}").exists(), "rank 1 left running"
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert got["choices"][0]["text"] == _one_rank_text(body)
