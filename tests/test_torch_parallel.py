"""The port's tensor and expert parallelism against the JAX package, on the
CPU over gloo.

- Shard rules: for debug-tiny, debug-moe, int8, int4 (gs 32) and the
  qwen2- and OPT-like variants, every rank's local tensor is exactly the
  block the JAX ``param_shardings`` hands the device at the same mesh
  position (``NamedSharding.devices_indices_map``), so each key is split
  on the axis its ``PartitionSpec`` names and the rank slices tile the
  full tensor. Where tp exceeds the kv heads the JAX package replicates
  them; the port keeps the one head a rank's q heads read.
- The ``not divisible`` errors and the int4 group rule; pp and sp
  refused without process groups.
- Engines in spawned rank processes (gloo, no JAX imported there): greedy
  tokens of tp 2, tp 4 (kv heads kept one per rank), tp 2 x ep 2 and
  tp 2 x dp 2 equal the port's tp 1 and the JAX engine on
  ``make_mesh(tp=..., ep=..., dp=...)`` with the same numpy weights, token
  for token (fp32; both sides' logits agree to ~1e-6, far from ties); the
  OPT-like (random biases: a bias added on every rank would show), the
  qwen2-like and int4 models at tp 2 equal tp 1; seeded sampling with
  penalties and logit_bias, n-gram speculative decoding and swap
  preemption at tp 2 equal tp 1; ``moe_block_ep`` at
  tp 2 x ep 2 equals the JAX dense block within 2e-5; a 12 q / 6 kv
  model at tp 4 (q heads straddling kv heads: one kv head kept per local
  q head) equals the JAX tp 4 engine. Every rank of a group returns the
  same tokens, and every step ran the lockstep hash.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_gpu_cluster_tpu.config import CacheConfig as JCache
from kubernetes_gpu_cluster_tpu.config import EngineConfig as JEngineConfig
from kubernetes_gpu_cluster_tpu.config import SchedulerConfig as JSched
from kubernetes_gpu_cluster_tpu.config import get_model_config as jax_model
from kubernetes_gpu_cluster_tpu.engine import LLMEngine as JaxEngine
from kubernetes_gpu_cluster_tpu.engine import SamplingParams as JaxParams
from kubernetes_gpu_cluster_tpu.models import llama as JM
from kubernetes_gpu_cluster_tpu.parallel import make_mesh as jax_mesh
from kubernetes_gpu_cluster_tpu.parallel import param_shardings
from kubernetes_gpu_cluster_tpu_torch.config import (CacheConfig,
                                                     EngineConfig,
                                                     ParallelConfig,
                                                     SchedulerConfig,
                                                     get_model_config)
from kubernetes_gpu_cluster_tpu_torch.engine import LLMEngine, SamplingParams
from kubernetes_gpu_cluster_tpu_torch.models import llama as TM
from kubernetes_gpu_cluster_tpu_torch.parallel import make_mesh
from kubernetes_gpu_cluster_tpu_torch.parallel.sharding import (
    local_kv_heads, shard_params, split_rules, validate)
from test_torch_model import variant_cfgs, variant_params

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
CACHE = dict(page_size=8, num_pages=64)
SCHED = dict(max_num_seqs=4, max_prefill_tokens=64, decode_buckets=(1, 2, 4),
             prefill_buckets=(32, 64), decode_window=4)
PROMPT_LENS = (5, 40, 100, 17)      # 100 > the prefill budget: chunked
MAX_TOKENS = 12
RANK_TIMEOUT_S = 240

# One rank: jobs from KGCT_TEST_JOBS, group from the KGCT_* environment.
RANK_WORKER = r'''
import json, os, sys
import numpy as np
import torch
torch.set_num_threads(1)
sys.path.insert(0, os.environ["KGCT_REPO"])
from kubernetes_gpu_cluster_tpu_torch.parallel import (initialize_distributed,
                                                       make_mesh)
initialize_distributed(device="cpu", timeout_s=120)
import torch.distributed as dist
from kubernetes_gpu_cluster_tpu_torch.config import (
    CacheConfig, EngineConfig, ParallelConfig, SchedulerConfig,
    get_model_config)
from kubernetes_gpu_cluster_tpu_torch.engine import LLMEngine, SamplingParams
from kubernetes_gpu_cluster_tpu_torch.models import llama as TM
from kubernetes_gpu_cluster_tpu_torch.parallel.ep import moe_block_ep
from kubernetes_gpu_cluster_tpu_torch.parallel.sharding import shard_params

out = {}
for job in json.load(open(os.environ["KGCT_TEST_JOBS"])):
    groups = make_mesh(**job["sizes"])
    mcfg = get_model_config(job["preset"]).replace(**job["model"])
    npz = np.load(job["weights"])
    np_params = {"layers": {k[7:]: npz[k] for k in npz.files
                            if k.startswith("layers.")}}
    np_params.update({k: npz[k] for k in npz.files
                      if not k.startswith("layers.")})
    params = TM.params_from_numpy(np_params, mcfg, "cpu")
    if job.get("moe_block"):
        local = shard_params(params, mcfg, groups)["layers"]
        lp = {k: local[k][0] for k in ("router", "w_gate", "w_up", "w_down")}
        x = torch.from_numpy(np.load(job["moe_block"]))
        out[job["name"]] = moe_block_ep(groups, mcfg, lp, x).tolist()
        continue
    cfg = EngineConfig(model=mcfg, cache=CacheConfig(**job["cache"]),
                       scheduler=SchedulerConfig(**job["sched"]),
                       parallel=ParallelConfig(**job["sizes"],
                                               lockstep_check=True))
    eng = LLMEngine(cfg, params=params, device="cpu", groups=groups)
    sps = []
    for p in job["params"]:
        if p.get("logit_bias"):
            p["logit_bias"] = {int(k): v for k, v in p["logit_bias"].items()}
        sps.append(SamplingParams(**p))
    outs = eng.generate(job["prompts"], sps)
    out[job["name"]] = {
        "tokens": [o.output_token_ids for o in outs],
        "kv_shape": list(eng.kv_cache.k.shape),
        "wq_shape": list(eng.params["layers"]["wq"].shape),
        "preemptions": eng.scheduler.num_preemptions_by_kind,
        "drafted": eng.obs.spec_drafted_tokens,
        "programs": eng.compiled_step_variants()}
    del eng
print("RESULT:" + json.dumps(out), flush=True)
dist.destroy_process_group()
'''


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_env(world: int, rank: int, coordinator: str, **extra) -> dict:
    """The environment of rank ``rank``: the ``KGCT_*`` bootstrap, gloo on
    the loopback interface, the repo on the path."""
    env = dict(os.environ)
    env.update(KGCT_REPO=str(REPO), KGCT_COORDINATOR=coordinator,
               KGCT_NUM_PROCESSES=str(world), KGCT_PROCESS_ID=str(rank),
               GLOO_SOCKET_IFNAME="lo", OMP_NUM_THREADS="1")
    env.update(extra)
    return env


def start_ranks(script: Path, world: int, **extra) -> list:
    coordinator = f"127.0.0.1:{free_port()}"
    return [subprocess.Popen(
        [sys.executable, str(script)],
        env=rank_env(world, r, coordinator, **extra),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)]


def finish_ranks(procs: list, timeout_s: float = RANK_TIMEOUT_S) -> list:
    """Wait for every rank (one shared deadline), kill what is left, and
    return [(rc, stdout, stderr)]."""
    deadline = time.monotonic() + timeout_s
    outs = []
    try:
        for p in procs:
            try:
                out, err = p.communicate(
                    timeout=max(deadline - time.monotonic(), 1.0))
            except subprocess.TimeoutExpired:
                p.kill()
                out, err = p.communicate()
                err += "\n[killed at the deadline]"
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def result_of(out: tuple, marker: str = "RESULT:"):
    rc, stdout, stderr = out
    assert rc == 0, f"rank failed (rc {rc}):\n{stderr[-3000:]}"
    line = next(ln for ln in stdout.splitlines() if ln.startswith(marker))
    return json.loads(line[len(marker):])


# -- weights and references ---------------------------------------------------

def _prompts():
    rng = np.random.default_rng(0)
    return [[int(x) for x in rng.integers(1, 500, n)] for n in PROMPT_LENS]


GREEDY = dict(max_tokens=MAX_TOKENS, temperature=0.0)
# The JAX package's test_sampled_tail_features_under_mesh requests.
SAMPLED_PROMPTS = [[3, 1, 4], [2, 7, 1]]
SAMPLED = [dict(max_tokens=10, temperature=0.8, seed=5,
                frequency_penalty=1.0, presence_penalty=0.5),
           dict(max_tokens=10, temperature=0.0, logit_bias={7: 100.0})]


# Spec decoding (n-gram drafts on repetitive prompts) and swap preemption
# (a pool too small for the batch, a host tier) compose with tp.
SPEC_SCHED = dict(SCHED, spec_decode_enabled=True, num_speculative_tokens=3)
SPEC_PROMPTS = [[7, 3, 9, 11] * 6, [5, 6, 7, 8, 5, 6, 7] * 3]
SWAP_CACHE = dict(page_size=8, num_pages=24, swap_space_gb=0.05)
# At tp 4 a rank's 3 q heads straddle kv heads (q heads 2j and 2j+1 read
# kv head j): neither of tp and the 6 kv heads divides the other.
STRADDLE = dict(num_heads=12, num_kv_heads=6)


def _save(np_params: dict, path: Path) -> str:
    flat = {f"layers.{k}": np.asarray(v)
            for k, v in np_params["layers"].items()}
    flat.update({k: np.asarray(v) for k, v in np_params.items()
                 if k != "layers"})
    np.savez(path, **flat)
    return str(path)


def _port_tokens(preset, model, np_params, prompts, params, cache=CACHE,
                 sched=SCHED) -> list:
    mcfg = get_model_config(preset).replace(**model)
    eng = LLMEngine(EngineConfig(model=mcfg, cache=CacheConfig(**cache),
                                 scheduler=SchedulerConfig(**sched)),
                    params=TM.params_from_numpy(np_params, mcfg, "cpu"),
                    device="cpu")
    plist = [SamplingParams(**p) for p in params]
    return [o.output_token_ids for o in eng.generate(prompts, plist)]


def _jax_tokens(preset, np_params, prompts, model=None, **mesh) -> list:
    cfg = JEngineConfig(model=jax_model(preset).replace(**(model or {})),
                        cache=JCache(**CACHE), scheduler=JSched(**SCHED))
    jp = jax.tree.map(jnp.asarray, np_params)
    eng = JaxEngine(cfg, params=jp, mesh=jax_mesh(**mesh))
    return [o.output_token_ids for o in eng.generate(
        prompts, JaxParams(**GREEDY))]


@pytest.fixture(scope="module")
def weights():
    """numpy weight sets, drawn by the JAX init from fixed keys."""
    tiny = jax.tree.map(np.asarray, JM.init_params(jax_model("debug-tiny"),
                                                   jax.random.key(3)))
    moe = jax.tree.map(np.asarray, JM.init_params(jax_model("debug-moe"),
                                                  jax.random.key(4)))
    int4 = jax.tree.map(np.asarray, JM.init_params(
        jax_model("debug-tiny").replace(quantization="int4",
                                        quant_group_size=32),
        jax.random.key(5)))
    opt = variant_params(variant_cfgs("opt-relu")[0], 6)
    qwen2 = variant_params(variant_cfgs("qwen2")[0], 7)
    straddle = jax.tree.map(np.asarray, JM.init_params(
        jax_model("debug-tiny").replace(**STRADDLE), jax.random.key(9)))
    return dict(tiny=tiny, moe=moe, int4=int4, opt=opt, qwen2=qwen2,
                straddle=straddle)


def _variant_model(name):
    from test_torch_model import VARIANTS
    return dict(VARIANTS[name][1])


def _jobs(weights, tmp: Path) -> tuple[list, list]:
    """(the tp-2 pool's jobs, the four-rank pool's jobs)."""
    paths = {k: _save(v, tmp / f"{k}.npz") for k, v in weights.items()}
    greedy = dict(prompts=_prompts(), params=[GREEDY] * len(PROMPT_LENS),
                  cache=CACHE, sched=SCHED)

    def job(name, preset, model, w, sizes, **kw):
        return dict(greedy, name=name, preset=preset, model=model,
                    weights=paths[w], sizes=sizes, **kw)
    two = [job("tp2", "debug-tiny", {}, "tiny", dict(tp=2)),
           job("opt", "debug-tiny", _variant_model("opt-relu"), "opt",
               dict(tp=2)),
           job("qwen2", "debug-tiny", _variant_model("qwen2"), "qwen2",
               dict(tp=2)),
           job("int4", "debug-tiny",
               dict(quantization="int4", quant_group_size=32), "int4",
               dict(tp=2)),
           dict(job("sampled", "debug-tiny", {}, "tiny", dict(tp=2)),
                prompts=SAMPLED_PROMPTS, params=SAMPLED),
           dict(job("spec", "debug-tiny", {}, "tiny", dict(tp=2)),
                sched=SPEC_SCHED, prompts=SPEC_PROMPTS,
                params=[GREEDY] * len(SPEC_PROMPTS)),
           dict(job("swap", "debug-tiny", {}, "tiny", dict(tp=2)),
                cache=SWAP_CACHE)]
    x = np.random.default_rng(8).standard_normal((6, 128)).astype(np.float32)
    np.save(tmp / "moe_x.npy", x)
    four = [job("tp4", "debug-tiny", {}, "tiny", dict(tp=4)),
            job("tp2ep2", "debug-moe", {}, "moe", dict(tp=2, ep=2)),
            job("tp2dp2", "debug-tiny", {}, "tiny", dict(tp=2, dp=2)),
            job("moe_block", "debug-moe", {}, "moe", dict(tp=2, ep=2),
                moe_block=str(tmp / "moe_x.npy")),
            job("straddle", "debug-tiny", STRADDLE, "straddle",
                dict(tp=4))]
    return two, four


@pytest.fixture(scope="module")
def ranks(weights, tmp_path_factory):
    """Both rank pools run once, concurrently: {job: [per-rank result]}."""
    tmp = tmp_path_factory.mktemp("ranks")
    script = tmp / "rank_worker.py"
    script.write_text(RANK_WORKER)
    two, four = _jobs(weights, tmp)
    pools = []
    for world, jobs in ((2, two), (4, four)):
        (tmp / f"jobs{world}.json").write_text(json.dumps(jobs))
        pools.append(start_ranks(script, world,
                                 KGCT_TEST_JOBS=str(tmp / f"jobs{world}.json")))
    results: dict = {}
    for procs in pools:
        for out in finish_ranks(procs):
            for name, res in result_of(out).items():
                results.setdefault(name, []).append(res)
    return results


# -- shard rules ----------------------------------------------------------------

SHARD_CASES = {
    # name: (jax cfg, port cfg, tp, ep)
    "debug-tiny": ("debug-tiny", {}, 2, 1),
    "debug-moe": ("debug-moe", {}, 2, 2),
    "int8": ("debug-tiny", dict(quantization="int8"), 2, 1),
    "int4-gs32": ("debug-tiny", dict(quantization="int4",
                                     quant_group_size=32), 2, 1),
    "int8-moe": ("debug-moe", dict(quantization="int8"), 2, 2),
    "qwen2": ("debug-tiny", "qwen2", 2, 1),
    "opt": ("debug-tiny", "opt-relu", 2, 1),
}


def _case_cfgs(name):
    preset, over, tp, ep = SHARD_CASES[name]
    if isinstance(over, str):
        jcfg, tcfg = variant_cfgs(over)
    else:
        jcfg = jax_model(preset).replace(**over)
        tcfg = get_model_config(preset).replace(**over)
    return jcfg, tcfg, tp, ep


@pytest.mark.parametrize("name", sorted(SHARD_CASES))
def test_shard_rules_match_jax_partition_specs(name):
    """Every rank's slice of every key is the block JAX places on the
    device at the same mesh position; together they tile the tensor."""
    jcfg, tcfg, tp, ep = _case_cfgs(name)
    np_params = jax.tree.map(np.asarray, JM.init_params(jcfg,
                                                        jax.random.key(0)))
    full = TM.params_from_numpy(np_params, tcfg, "cpu")
    mesh = jax_mesh(tp=tp, ep=ep)
    specs = param_shardings(mesh, jcfg)
    layer_rules, top_rules = split_rules(tcfg)
    devices = list(mesh.devices.flat)
    for rank, dev in enumerate(devices):
        local = shard_params(full, tcfg, make_mesh(tp=tp, ep=ep, rank=rank))
        for store, jstore, rules in ((local["layers"], specs["layers"],
                                      layer_rules), (local, specs, top_rules)):
            for key, got in store.items():
                if key == "layers":
                    continue
                src = full["layers"][key] if store is local["layers"] \
                    else full[key]
                idx = jstore[key].devices_indices_map(tuple(src.shape))[dev]
                np.testing.assert_array_equal(got.numpy(),
                                              src.numpy()[idx], err_msg=key)
                named = {i for i, a in enumerate(jstore[key].spec)
                         if a is not None}
                assert named == {a for a, _ in rules.get(key, ())}, key
    assert set(layer_rules) <= set(specs["layers"])


def test_kv_heads_below_tp_keep_one_head_per_rank():
    """debug-tiny (4 q heads, 2 kv heads) at tp 4: rank r keeps q head r
    and kv head r // 2 (JAX replicates the kv heads instead)."""
    cfg = get_model_config("debug-tiny")
    np_params = jax.tree.map(np.asarray, JM.init_params(
        jax_model("debug-tiny"), jax.random.key(0)))
    full = TM.params_from_numpy(np_params, cfg, "cpu")
    hd = cfg.head_dim
    assert local_kv_heads(cfg, 4) == 1
    for rank in range(4):
        lp = shard_params(full, cfg, make_mesh(tp=4, rank=rank))["layers"]
        head = rank // 2
        for key in ("wk", "wv"):
            np.testing.assert_array_equal(
                lp[key].numpy(),
                full["layers"][key][..., head * hd:(head + 1) * hd].numpy())
        np.testing.assert_array_equal(
            lp["wq"].numpy(),
            full["layers"]["wq"][..., rank * hd:(rank + 1) * hd].numpy())


@pytest.mark.parametrize("model,tp,ep,match", [
    (dict(), 8, 1, "num_heads=4 not divisible by tp=8"),
    (dict(num_experts=4), 1, 3, "num_experts=4 not divisible by ep=3"),
    (dict(vocab_size=510), 4, 1, "vocab_size=510 not divisible by tp=4"),
    (dict(quantization="int4", quant_group_size=128), 2, 1,
     "whole number of 128-row groups"),
], ids=["heads", "experts", "vocab", "int4-groups"])
def test_layouts_the_rules_refuse(model, tp, ep, match):
    cfg = get_model_config("debug-moe" if "num_experts" in model
                           else "debug-tiny").replace(**model)
    with pytest.raises(ValueError, match=match):
        validate(cfg, tp, ep)
    with pytest.raises(ValueError, match=match):
        make = make_mesh(tp=tp, ep=ep, rank=0)
        shard_params(TM.init_params(cfg, torch.Generator().manual_seed(0),
                                    "cpu"), cfg, make)


@pytest.mark.parametrize("axis", ["pp", "sp"])
def test_engine_refuses_pp_and_sp(axis):
    """pp and sp serve (tests/test_torch_pp.py, test_torch_sp.py) but,
    as tp, not without this rank's process groups."""
    cfg = EngineConfig(model=get_model_config("debug-tiny"),
                       parallel=ParallelConfig(**{axis: 2}))
    with pytest.raises(RuntimeError, match="initialize_distributed"):
        LLMEngine(cfg, device="cpu")


# -- engines in rank processes ------------------------------------------------

JAX_MESHES = {"tp2": ("tiny", "debug-tiny", dict(tp=2)),
              "tp4": ("tiny", "debug-tiny", dict(tp=4)),
              "tp2ep2": ("moe", "debug-moe", dict(tp=2, ep=2)),
              "tp2dp2": ("tiny", "debug-tiny", dict(tp=2, dp=2))}


@pytest.mark.parametrize("job", sorted(JAX_MESHES))
def test_greedy_matches_tp1_and_jax_mesh(job, ranks, weights):
    w, preset, mesh = JAX_MESHES[job]
    got = ranks[job]
    assert all(r["tokens"] == got[0]["tokens"] for r in got), "ranks differ"
    # A rank's gloo collectives stage through the host and cannot be
    # captured: its engine builds no step program.
    assert all(r["programs"] == 0 for r in got)
    tp1 = _port_tokens(preset, {}, weights[w], _prompts(),
                       [GREEDY] * len(PROMPT_LENS))
    assert got[0]["tokens"] == tp1
    assert got[0]["tokens"] == _jax_tokens(preset, weights[w], _prompts(),
                                           **mesh)


@pytest.mark.parametrize("job,variant", [("opt", "opt-relu"),
                                         ("qwen2", "qwen2"),
                                         ("int4", None)])
def test_variant_greedy_tp2_matches_tp1(job, variant, ranks, weights):
    model = (_variant_model(variant) if variant
             else dict(quantization="int4", quant_group_size=32))
    got = ranks[job]
    assert got[0]["tokens"] == got[1]["tokens"]
    assert got[0]["tokens"] == _port_tokens(
        "debug-tiny", model, weights[job], _prompts(),
        [GREEDY] * len(PROMPT_LENS))


@pytest.mark.parametrize("job", ["spec", "swap"])
def test_spec_and_swap_compose_with_tp(job, ranks, weights):
    """n-gram speculative decoding and swap preemption at tp 2 give the
    tp 1 tokens (and drafts, and swaps) on both ranks."""
    got = ranks[job]
    assert got[0] == got[1]
    cache, sched, prompts = ((CACHE, SPEC_SCHED, SPEC_PROMPTS) if job == "spec"
                             else (SWAP_CACHE, SCHED, _prompts()))
    assert got[0]["tokens"] == _port_tokens(
        "debug-tiny", {}, weights["tiny"], prompts,
        [GREEDY] * len(prompts), cache=cache, sched=sched)
    if job == "spec":
        assert got[0]["drafted"] > 0
    else:
        assert got[0]["preemptions"]["swap"] > 0


def test_sampled_tail_features_under_tp(ranks, weights):
    """Seeded sampling with penalties, and logit_bias, at tp 2 give the
    tp 1 tokens on every rank (the JAX package's
    ``test_sampled_tail_features_under_mesh``)."""
    got = ranks["sampled"]
    assert got[0]["tokens"] == got[1]["tokens"]
    assert got[0]["tokens"][1] == [7] * 10
    assert got[0]["tokens"] == _port_tokens("debug-tiny", {}, weights["tiny"],
                                            SAMPLED_PROMPTS, SAMPLED)


def test_rank_pool_and_weight_geometry(ranks):
    """Each rank's pool holds its kv heads [L, P, ps, n_kv_local * hd] and
    its q projection its heads."""
    cfg = get_model_config("debug-tiny")
    hd, L = cfg.head_dim, cfg.num_layers
    for job, tp in (("tp2", 2), ("tp4", 4), ("tp2dp2", 2)):
        for r in ranks[job]:
            assert r["kv_shape"] == [L, CACHE["num_pages"], 8,
                                     local_kv_heads(cfg, tp) * hd]
            assert r["wq_shape"] == [L, cfg.hidden_size,
                                     cfg.num_heads // tp * hd]


def test_straddling_kv_heads_serve_at_tp4(ranks, weights):
    """12 q / 6 kv heads at tp 4: each rank keeps one kv head per local q
    head (3, repeating the kv head each reads) and serves the JAX tp 4
    engine's greedy tokens (which replicates the 6 kv heads), token for
    token, on every rank."""
    cfg = get_model_config("debug-tiny").replace(**STRADDLE)
    got = ranks["straddle"]
    assert all(r["tokens"] == got[0]["tokens"] for r in got), "ranks differ"
    for r in got:
        assert r["kv_shape"] == [cfg.num_layers, CACHE["num_pages"], 8,
                                 3 * cfg.head_dim]
    assert got[0]["tokens"] == _jax_tokens("debug-tiny", weights["straddle"],
                                           _prompts(), model=STRADDLE, tp=4)


def test_moe_block_ep_matches_dense(ranks, weights):
    """``moe_block_ep`` at tp 2 x ep 2 against the JAX dense block on the
    same layer within 2e-5, on every rank."""
    cfg = jax_model("debug-moe")
    lp = {k: jnp.asarray(weights["moe"]["layers"][k][0])
          for k in ("router", "w_gate", "w_up", "w_down")}
    x = np.random.default_rng(8).standard_normal((6, 128)).astype(np.float32)
    dense = np.asarray(JM._moe_mlp(lp, jnp.asarray(x), cfg))
    for out in ranks["moe_block"]:
        np.testing.assert_allclose(np.asarray(out), dense, rtol=2e-5,
                                   atol=2e-5)
