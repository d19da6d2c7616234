"""The port's sequence parallelism against the JAX package's, on the CPU
over gloo.

- Ring attention (``parallel.sp``) in a four-rank pool against the JAX
  ring (``build_ring_prefill``) and the XLA oracle
  (``ragged_prefill_attention_xla``), ``tests/test_sp.py``'s four cases:
  ragged segments with -1 padding at sp 2 and sp 4, one long sequence,
  inputs already sharded (each rank holds only its rows and keeps only
  its output rows), and the ring composed with tp (sp 2 x tp 2, each rank
  on its heads); within ``test_sp.py``'s 2e-5.
- The engine at sp 4 gives the JAX sp 4 engine's greedy tokens, token for
  token, on every rank (prefill through the ring, decode and the chunked
  prompt's history on every rank, mixed batching off).
- Refusals: prefill buckets the ring cannot split; sp with pp.
"""

from __future__ import annotations

import json

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
from kubernetes_gpu_cluster_tpu.ops.attention import \
    ragged_prefill_attention_xla
from kubernetes_gpu_cluster_tpu.parallel import make_mesh as jax_mesh
from kubernetes_gpu_cluster_tpu.parallel.sp import build_ring_prefill
from kubernetes_gpu_cluster_tpu_torch.config import (EngineConfig,
                                                     ParallelConfig,
                                                     SchedulerConfig,
                                                     get_model_config)
from kubernetes_gpu_cluster_tpu_torch.engine import LLMEngine
from test_torch_parallel import _save, finish_ranks, result_of, start_ranks

torch.set_num_threads(2)

CACHE = dict(page_size=8, num_pages=64)
SCHED = dict(max_num_seqs=4, max_prefill_tokens=64, decode_buckets=(1, 2, 4),
             prefill_buckets=(32, 64), decode_window=4)
PROMPT_LENS = (5, 40, 100, 17)      # 100 > the prefill budget: chunked
GREEDY = dict(max_tokens=12, temperature=0.0)

# name: (port sizes (4 ranks), T, nh, n_kv, hd, segment lengths, mode)
RINGS = {
    "ragged-sp2": (dict(sp=2, dp=2), 64, 4, 2, 32, [23, 17, 11], "full"),
    "ragged-sp4": (dict(sp=4), 64, 4, 2, 32, [23, 17, 11], "full"),
    "long": (dict(sp=4), 128, 2, 1, 16, [128], "full"),
    "sharded": (dict(sp=4), 64, 4, 2, 32, [40, 20], "shard"),
    "tp": (dict(sp=2, tp=2), 32, 4, 2, 16, [30], "full"),
}

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
from kubernetes_gpu_cluster_tpu_torch.parallel.sp import (
    ring_attention_shard, ring_prefill_attention)

out = {}
for job in json.load(open(os.environ["KGCT_TEST_JOBS"])):
    groups = make_mesh(**job["sizes"])
    if job.get("ring"):
        x = {k: torch.from_numpy(v) for k, v in np.load(job["ring"]).items()}
        scale = x["q"].shape[-1] ** -0.5
        # Each tp rank attends with its heads: q heads and kv heads split.
        nh, n_kv = x["q"].shape[1] // groups.tp, x["k"].shape[1] // groups.tp
        q = x["q"][:, groups.tp_rank * nh:(groups.tp_rank + 1) * nh]
        k = x["k"][:, groups.tp_rank * n_kv:(groups.tp_rank + 1) * n_kv]
        v = x["v"][:, groups.tp_rank * n_kv:(groups.tp_rank + 1) * n_kv]
        if job["mode"] == "shard":
            Tl = q.shape[0] // groups.sp
            rows = slice(groups.sp_rank * Tl, (groups.sp_rank + 1) * Tl)
            got = ring_attention_shard(q[rows], k[rows], v[rows],
                                       x["seg"][rows], x["pos"][rows], scale,
                                       groups)
        else:
            got = ring_prefill_attention(q, k, v, x["seg"], x["pos"], scale,
                                         groups=groups)
        out[job["name"]] = {"out": got.tolist(), "sp_rank": groups.sp_rank,
                            "tp_rank": groups.tp_rank}
        continue
    mcfg = get_model_config("debug-tiny")
    npz = np.load(job["weights"])
    np_params = {"layers": {k[7:]: npz[k] for k in npz.files
                            if k.startswith("layers.")}}
    np_params.update({k: npz[k] for k in npz.files
                      if not k.startswith("layers.")})
    cfg = EngineConfig(model=mcfg, cache=CacheConfig(**job["cache"]),
                       scheduler=SchedulerConfig(**job["sched"]),
                       parallel=ParallelConfig(**job["sizes"],
                                               lockstep_check=True))
    eng = LLMEngine(cfg, params=TM.params_from_numpy(np_params, mcfg, "cpu"),
                    device="cpu", groups=groups)
    outs = eng.generate(job["prompts"],
                        [SamplingParams(**p) for p in job["params"]])
    out[job["name"]] = {"tokens": [o.output_token_ids for o in outs],
                        "kv_shape": list(eng.kv_cache.k.shape),
                        "mixed": eng.scheduler.mixed_enabled}
    del eng
print("RESULT:" + json.dumps(out), flush=True)
dist.destroy_process_group()
'''


def _mk(T, nh, n_kv, hd, seg_lens, seed=0) -> dict:
    """``tests/test_sp.py``'s inputs, as numpy."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((T, nh, hd)).astype(np.float32)
    k = rng.standard_normal((T, n_kv, hd)).astype(np.float32)
    v = rng.standard_normal((T, n_kv, hd)).astype(np.float32)
    seg, pos = [], []
    for s, ln in enumerate(seg_lens):
        seg += [s] * ln
        pos += list(range(ln))
    seg += [-1] * (T - len(seg))
    pos += [0] * (T - len(pos))
    return dict(q=q, k=k, v=v, seg=np.asarray(seg, np.int32),
                pos=np.asarray(pos, np.int32))


def _prompts():
    rng = np.random.default_rng(0)
    return [[int(x) for x in rng.integers(1, 500, n)] for n in PROMPT_LENS]


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    """The four-rank pool runs every job once while the JAX references are
    computed here: ({job: [per-rank result]}, {reference: value})."""
    tmp = tmp_path_factory.mktemp("sp")
    weights = jax.tree.map(np.asarray, JM.init_params(
        jax_model("debug-tiny"), jax.random.key(0)))
    jobs, inputs = [], {}
    for name, (sizes, T, nh, n_kv, hd, segs, mode) in RINGS.items():
        inputs[name] = _mk(T, nh, n_kv, hd, segs)
        np.savez(tmp / f"{name}.npz", **inputs[name])
        jobs.append(dict(name=name, sizes=sizes, mode=mode,
                         ring=str(tmp / f"{name}.npz")))
    jobs.append(dict(name="engine", sizes=dict(sp=4), cache=CACHE,
                     sched=SCHED, prompts=_prompts(),
                     params=[GREEDY] * len(PROMPT_LENS),
                     weights=_save(weights, tmp / "tiny.npz")))
    script = tmp / "rank_worker.py"
    script.write_text(RANK_WORKER)
    (tmp / "jobs.json").write_text(json.dumps(jobs))
    procs = start_ranks(script, 4, KGCT_TEST_JOBS=str(tmp / "jobs.json"))
    try:
        refs = {}
        for name, (sizes, T, nh, n_kv, hd, segs, mode) in RINGS.items():
            x = {k: jnp.asarray(v) for k, v in inputs[name].items()}
            scale = hd ** -0.5
            fn = build_ring_prefill(jax_mesh(sp=sizes["sp"]), n_kv,
                                    nh // n_kv, scale)
            refs[name] = (
                np.asarray(fn(x["q"], x["k"], x["v"], x["seg"], x["pos"])),
                np.asarray(ragged_prefill_attention_xla(
                    x["q"], x["k"], x["v"], x["seg"], x["pos"], scale)))
        cfg = JEngineConfig(model=jax_model("debug-tiny"),
                            cache=JCache(**CACHE), scheduler=JSched(**SCHED))
        eng = JaxEngine(cfg, params=jax.tree.map(jnp.asarray, weights),
                        mesh=jax_mesh(sp=4, dp=2))
        assert eng.sp_size == 4
        refs["engine"] = [o.output_token_ids for o in eng.generate(
            _prompts(), JaxParams(**GREEDY))]
    finally:
        outs = finish_ranks(procs)
    results: dict = {}
    for out in outs:
        for name, res in result_of(out).items():
            results.setdefault(name, []).append(res)
    return results, refs


@pytest.mark.parametrize("name", sorted(RINGS))
def test_ring_matches_jax_ring_and_oracle(name, pool):
    """Every rank's output (the whole [T, nh, hd], or its own rows when
    the inputs were sharded; its heads under tp) within 2e-5 of the JAX
    ring and of the XLA oracle."""
    results, refs = pool
    sizes, T, nh, n_kv, hd, segs, mode = RINGS[name]
    ring, oracle = refs[name]
    np.testing.assert_allclose(ring, oracle, rtol=2e-5, atol=2e-5)
    tp, sp = sizes.get("tp", 1), sizes["sp"]
    seen = set()
    for r in results[name]:
        got = np.asarray(r["out"], np.float32)
        heads = slice(r["tp_rank"] * nh // tp, (r["tp_rank"] + 1) * nh // tp)
        rows = slice(None)
        if mode == "shard":
            rows = slice(r["sp_rank"] * T // sp, (r["sp_rank"] + 1) * T // sp)
        for want in (ring, oracle):
            np.testing.assert_allclose(got, want[rows, heads], rtol=2e-5,
                                       atol=2e-5)
        seen.add((r["sp_rank"], r["tp_rank"]))
    assert len(seen) == sp * tp


def test_sp_engine_greedy_matches_jax(pool):
    """sp 4: the JAX sp 4 engine's greedy tokens on every rank; each rank
    holds the whole pool and has mixed batching off."""
    results, refs = pool
    cfg = get_model_config("debug-tiny")
    got = results["engine"]
    assert all(r["tokens"] == got[0]["tokens"] for r in got), "ranks differ"
    assert got[0]["tokens"] == refs["engine"]
    for r in got:
        assert not r["mixed"]
        assert r["kv_shape"] == [cfg.num_layers, CACHE["num_pages"], 8,
                                 cfg.num_kv_heads * cfg.head_dim]


def test_sp_refuses_indivisible_buckets():
    cfg = EngineConfig(model=get_model_config("debug-tiny"),
                       scheduler=SchedulerConfig(prefill_buckets=(100,)),
                       parallel=ParallelConfig(sp=8))
    with pytest.raises(ValueError, match="prefill buckets"):
        LLMEngine(cfg, device="cpu")


def test_sp_refuses_pp_combination():
    cfg = EngineConfig(model=get_model_config("debug-tiny"),
                       parallel=ParallelConfig(sp=2, pp=2))
    with pytest.raises(ValueError, match="sp and pp"):
        LLMEngine(cfg, device="cpu")
