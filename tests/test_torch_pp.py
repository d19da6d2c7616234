"""The port's pipeline parallelism against the JAX package's, on the CPU
over gloo.

- The pipeline forward (``parallel.pp.run_pipeline`` + ``pp_logits``)
  against the JAX ``build_pp_forward`` + ``pp_logits`` on the same numpy
  weights and inputs (``tests/test_parallel.py``'s cases): a prefill of
  M = 3 microbatches at pp 2 x tp 2 and a decode of M = 2 at pp 2, logits
  within 2e-4 and each rank's pool slab (its stage's layers, its tp heads)
  equal to the same block of the JAX pool outside page 0, within 2e-4.
- Engines in spawned rank processes (no JAX imported there), fp32: greedy
  tokens at pp 2 x tp 2, pp 2, pp 4 (a 4-layer model), int8 and int4 at
  pp 2, debug-moe at pp 2 x ep 2, and a 40-token prompt chunked under a
  16-token budget (the pipelined history path) equal the JAX engine's on
  the same mesh, token for token, on every rank of every stage (every
  step ran the lockstep hash).
- The draft model's pool takes the MIN of the ranks' free memory.
- Refusals: layers that pp does not divide; and the stage shapes of
  llama-3-70b at pp 2 x tp 4, built on the ``meta`` device (nothing
  allocated), the counterpart of ``test_north_star_70b_tp_pp_traces``.
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
from kubernetes_gpu_cluster_tpu.engine.kv_cache import KVCache as JKV
from kubernetes_gpu_cluster_tpu.models import llama as JM
from kubernetes_gpu_cluster_tpu.parallel import make_mesh as jax_mesh
from kubernetes_gpu_cluster_tpu.parallel.pp import build_pp_forward
from kubernetes_gpu_cluster_tpu.parallel.pp import pp_logits as jax_pp_logits
from kubernetes_gpu_cluster_tpu_torch.config import (EngineConfig,
                                                     ParallelConfig,
                                                     get_model_config)
from kubernetes_gpu_cluster_tpu_torch.engine import LLMEngine
from kubernetes_gpu_cluster_tpu_torch.models import llama as TM
from kubernetes_gpu_cluster_tpu_torch.parallel import make_mesh
from kubernetes_gpu_cluster_tpu_torch.parallel.pp import stage_layers
from kubernetes_gpu_cluster_tpu_torch.parallel.sharding import init_shard_fn
from test_torch_parallel import _save, finish_ranks, result_of, start_ranks

torch.set_num_threads(2)

CACHE = dict(page_size=8, num_pages=64)
SCHED = dict(max_num_seqs=4, max_prefill_tokens=64, decode_buckets=(1, 2, 4),
             prefill_buckets=(32, 64), decode_window=4)
CHUNK_SCHED = dict(SCHED, max_prefill_tokens=16, prefill_buckets=(16,))
PROMPT_LENS = (5, 40, 100, 17)      # 100 > the prefill budget: chunked
LONG_PROMPT = [((7 * i) % 500) + 1 for i in range(40)]
MAX_TOKENS = 12
GREEDY = dict(max_tokens=MAX_TOKENS, temperature=0.0)
PIPE_PAGES = 17                      # the JAX pipeline tests' pool
DRAFT_WANT, DRAFT_PAGE_BYTES = 1000, 997

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
from kubernetes_gpu_cluster_tpu_torch.engine.kv_cache import KVCache
from kubernetes_gpu_cluster_tpu_torch.engine.spec.draft_model import \
    draft_pool_pages
from kubernetes_gpu_cluster_tpu_torch.models import llama as TM
from kubernetes_gpu_cluster_tpu_torch.parallel.pp import (pp_logits,
                                                          run_pipeline,
                                                          stage_layers)
from kubernetes_gpu_cluster_tpu_torch.parallel.sharding import (
    local_kv_heads, shard_params)


def load(path, mcfg):
    npz = np.load(path)
    np_params = {"layers": {k[7:]: npz[k] for k in npz.files
                            if k.startswith("layers.")}}
    np_params.update({k: npz[k] for k in npz.files
                      if not k.startswith("layers.")})
    return TM.params_from_numpy(np_params, mcfg, "cpu")


def pipe(job, groups, mcfg):
    params = shard_params(load(job["weights"], mcfg), mcfg, groups)
    x = {k: torch.from_numpy(v) for k, v in np.load(job["inputs"]).items()}
    layers = stage_layers(mcfg, groups)
    kd = local_kv_heads(mcfg, groups.tp) * mcfg.head_dim
    cols = slice(groups.tp_rank * kd, (groups.tp_rank + 1) * kd)
    kv = KVCache(k=x["kv_k"][layers.start:layers.stop, ..., cols].clone(),
                 v=x["kv_v"][layers.start:layers.stop, ..., cols].clone())
    M = x["tokens"].shape[0]
    if job["kind"] == "prefill":
        mbs = [(x["tokens"][m], TM.PrefillMeta(
            seg_ids=x["seg_ids"][m], positions=x["positions"][m],
            slot_mapping=x["slot_mapping"][m],
            logits_indices=x["logits_indices"][m]), ()) for m in range(M)]
    else:
        mbs = [(x["tokens"][m], TM.DecodeMeta(
            positions=x["positions"][m], slot_mapping=x["slot_mapping"][m],
            page_tables=x["page_tables"][m],
            context_lens=x["context_lens"][m]), ()) for m in range(M)]
    hidden = run_pipeline(job["kind"], params, mcfg, mbs, kv, groups)
    logits = torch.stack([pp_logits(
        params, mcfg, hidden[m], mbs[m][1].logits_indices
        if job["kind"] == "prefill" else None, groups) for m in range(M)])
    np.savez(job["out"] + f"-rank{dist.get_rank()}.npz",
             logits=logits.numpy(), kv_k=kv.k.numpy(), kv_v=kv.v.numpy())
    return {"layers": [layers.start, layers.stop], "tp_rank": groups.tp_rank}


out = {}
for job in json.load(open(os.environ["KGCT_TEST_JOBS"])):
    groups = make_mesh(**job["sizes"])
    if job.get("draft_pool"):
        free = (dist.get_rank() + 1) * 10 ** 6 + 12345 * dist.get_rank()
        want, page_bytes = job["draft_pool"]
        out[job["name"]] = draft_pool_pages(want, free, page_bytes, groups)
        continue
    mcfg = get_model_config(job["preset"]).replace(**job["model"])
    if job.get("kind"):
        out[job["name"]] = pipe(job, groups, mcfg)
        continue
    cfg = EngineConfig(model=mcfg, cache=CacheConfig(**job["cache"]),
                       scheduler=SchedulerConfig(**job["sched"]),
                       parallel=ParallelConfig(**job["sizes"],
                                               lockstep_check=True))
    eng = LLMEngine(cfg, params=load(job["weights"], mcfg), device="cpu",
                    groups=groups)
    outs = eng.generate(job["prompts"],
                        [SamplingParams(**p) for p in job["params"]])
    out[job["name"]] = {
        "tokens": [o.output_token_ids for o in outs],
        "kv_shape": list(eng.kv_cache.k.shape),
        "mixed": eng.scheduler.mixed_enabled,
        "kinds": dict(eng.obs.step_kind_counts)}
    del eng
print("RESULT:" + json.dumps(out), flush=True)
dist.destroy_process_group()
'''


def _prompts():
    rng = np.random.default_rng(0)
    return [[int(x) for x in rng.integers(1, 500, n)] for n in PROMPT_LENS]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


# -- the pipeline forward's inputs: tests/test_parallel.py's ------------------

def _prefill_inputs():
    M, T = 3, 8
    tokens = np.array([[1, 5, 9, 2, 7, 3, 4, 6], [3, 3, 7, 1, 2, 8, 5, 9],
                       [11, 4, 8, 6, 2, 10, 1, 5]], np.int32)
    page0 = np.array([1, 2, 3])           # page 0 is scrap
    return dict(
        tokens=tokens, seg_ids=np.zeros((M, T), np.int32),
        positions=np.tile(np.arange(T, dtype=np.int32), (M, 1)),
        slot_mapping=np.stack([page0[m] * 8 + np.arange(T, dtype=np.int32)
                               for m in range(M)]),
        logits_indices=np.full((M, 1), T - 1, np.int32))


def _decode_inputs(pool_shape):
    M, B = 2, 2
    rng = np.random.default_rng(0)
    pages = 1 + 2 * np.arange(M)[:, None] + np.arange(B)[None, :]
    return dict(
        kv_k=rng.standard_normal(pool_shape).astype(np.float32) * 0.02,
        kv_v=rng.standard_normal(pool_shape).astype(np.float32) * 0.02,
        tokens=np.array([[7, 9], [2, 4]], np.int32),
        positions=np.full((M, B), 3, np.int32),
        slot_mapping=(pages * 8 + 3).astype(np.int32),
        page_tables=pages[..., None].astype(np.int32),
        context_lens=np.full((M, B), 4, np.int32))


def _jax_pipe(kind, np_params, x, **mesh):
    """(logits [M, rows, V], pool k, pool v) of the JAX pipeline."""
    cfg = jax_model("debug-tiny")
    params = jax.tree.map(jnp.asarray, np_params)
    meta_t = JM.PrefillMeta if kind == "prefill" else JM.DecodeMeta
    meta = meta_t(**{f: jnp.asarray(x[f]) for f in meta_t._fields})
    kv = JKV(k=jnp.asarray(x["kv_k"]), v=jnp.asarray(x["kv_v"]))
    fn = build_pp_forward(jax_mesh(**mesh), cfg, kind)
    hidden, kv = fn(params, kv, jnp.asarray(x["tokens"]), meta)
    logits = [jax_pp_logits(params, cfg, hidden[m],
                            logits_indices=(meta.logits_indices[m]
                                            if kind == "prefill" else None))
              for m in range(x["tokens"].shape[0])]
    return np.stack([np.asarray(lg) for lg in logits]), _np(kv)


# -- rank pool and references ---------------------------------------------------

def _weights():
    """numpy weight sets from the JAX init (the pipeline cases use
    tests/test_parallel.py's key 4)."""
    tiny = jax_model("debug-tiny")
    return {
        "tiny": _np(JM.init_params(tiny, jax.random.key(0))),
        "pipe": _np(JM.init_params(tiny, jax.random.key(4))),
        "deep": _np(JM.init_params(tiny.replace(num_layers=4),
                                   jax.random.key(1))),
        "int8": _np(JM.init_params(tiny.replace(quantization="int8"),
                                   jax.random.key(2))),
        "int4": _np(JM.init_params(tiny.replace(quantization="int4",
                                                quant_group_size=32),
                                   jax.random.key(3))),
        "moe": _np(JM.init_params(jax_model("debug-moe"),
                                  jax.random.key(5)))}


# name: (weights, preset, model overrides, port sizes (4 ranks), JAX mesh,
#        prompts, scheduler)
ENGINES = {
    "pp2tp2": ("tiny", "debug-tiny", {}, dict(pp=2, tp=2),
               dict(pp=2, tp=2, dp=2), "mixed", SCHED),
    "pp2": ("tiny", "debug-tiny", {}, dict(pp=2, dp=2), dict(pp=2),
            "mixed", SCHED),
    "pp4": ("deep", "debug-tiny", dict(num_layers=4), dict(pp=4),
            dict(pp=4, dp=2), "short", SCHED),
    "int8": ("int8", "debug-tiny", dict(quantization="int8"),
             dict(pp=2, dp=2), dict(pp=2), "short", SCHED),
    "int4": ("int4", "debug-tiny", dict(quantization="int4",
                                        quant_group_size=32),
             dict(pp=2, dp=2), dict(pp=2), "short", SCHED),
    "moe": ("moe", "debug-moe", {}, dict(pp=2, ep=2), dict(pp=2, ep=2),
            "short", SCHED),
    "chunked": ("tiny", "debug-tiny", {}, dict(pp=2, tp=2),
                dict(pp=2, tp=2, dp=2), "long", CHUNK_SCHED),
}


def _engine_prompts(which):
    """"mixed": PROMPT_LENS (one chunked); "short": its two shortest
    (one prefill bucket, fewer JAX compiles); "long": LONG_PROMPT."""
    return {"mixed": _prompts(), "short": [_prompts()[0], _prompts()[3]],
            "long": [LONG_PROMPT]}[which]


def _jax_tokens(name, weights) -> list:
    w, preset, model, _, mesh, prompts, sched = ENGINES[name]
    cfg = JEngineConfig(model=jax_model(preset).replace(**model),
                        cache=JCache(**CACHE), scheduler=JSched(**sched))
    eng = JaxEngine(cfg, params=jax.tree.map(jnp.asarray, weights[w]),
                    mesh=jax_mesh(**mesh))
    assert eng.pp_size == mesh["pp"]
    return [o.output_token_ids for o in eng.generate(
        _engine_prompts(prompts), JaxParams(**GREEDY))]


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    """The four-rank pool runs every job once while the JAX references are
    computed here: ({job: [per-rank result]}, {reference: value})."""
    tmp = tmp_path_factory.mktemp("pp")
    weights = _weights()
    paths = {k: _save(v, tmp / f"{k}.npz") for k, v in weights.items()}
    pipe_cfg = jax_model("debug-tiny")
    pool_shape = (pipe_cfg.num_layers, PIPE_PAGES, 8,
                  pipe_cfg.num_kv_heads * pipe_cfg.head_dim)
    inputs = {"prefill": dict(_prefill_inputs(),
                              kv_k=np.zeros(pool_shape, np.float32),
                              kv_v=np.zeros(pool_shape, np.float32)),
              "decode": _decode_inputs(pool_shape)}
    jobs = []
    for kind, sizes in (("prefill", dict(pp=2, tp=2)),
                        ("decode", dict(pp=2, dp=2))):
        np.savez(tmp / f"{kind}-in.npz", **inputs[kind])
        jobs.append(dict(name=kind, kind=kind, preset="debug-tiny", model={},
                         weights=paths["pipe"], sizes=sizes,
                         inputs=str(tmp / f"{kind}-in.npz"),
                         out=str(tmp / f"{kind}-out")))
    for name, (w, preset, model, sizes, _, prompts, sched) in ENGINES.items():
        jobs.append(dict(name=name, preset=preset, model=model,
                         weights=paths[w], sizes=sizes, cache=CACHE,
                         sched=sched, prompts=_engine_prompts(prompts),
                         params=[GREEDY] * len(_engine_prompts(prompts))))
    jobs.append(dict(name="draft_pool", sizes=dict(pp=2, tp=2),
                     draft_pool=[DRAFT_WANT, DRAFT_PAGE_BYTES]))
    script = tmp / "rank_worker.py"
    script.write_text(RANK_WORKER)
    (tmp / "jobs.json").write_text(json.dumps(jobs))
    procs = start_ranks(script, 4, KGCT_TEST_JOBS=str(tmp / "jobs.json"))
    try:
        refs = {f"jax:{name}": _jax_tokens(name, weights)
                for name in ENGINES}
        refs["pipe:prefill"] = _jax_pipe("prefill", weights["pipe"],
                                         inputs["prefill"], pp=2, tp=2, dp=2)
        refs["pipe:decode"] = _jax_pipe("decode", weights["pipe"],
                                        inputs["decode"], pp=2, dp=4)
    finally:
        outs = finish_ranks(procs)
    results: dict = {}
    for rank, out in enumerate(outs):
        for name, res in result_of(out).items():
            if name in ("prefill", "decode"):
                res = dict(res, **np.load(tmp / f"{name}-out-rank{rank}.npz"))
            results.setdefault(name, []).append(res)
    return results, refs


# -- the pipeline forward -------------------------------------------------------

@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_pipeline_forward_matches_jax(kind, pool):
    """Logits of every microbatch within 2e-4 of the JAX pipeline's on
    every rank; each rank's pool slab (its stage's layers, its tp heads)
    within 2e-4 of the same block of the JAX pool, page 0 (the scrap page
    of the JAX pipeline's inactive ticks) excluded."""
    results, refs = pool
    want_logits, want_kv = refs[f"pipe:{kind}"]
    hd = get_model_config("debug-tiny").head_dim
    for r in results[kind]:
        np.testing.assert_allclose(r["logits"], want_logits, rtol=2e-4,
                                   atol=2e-4)
        lo, hi = r["layers"]
        kd = r["kv_k"].shape[-1]
        assert kd in (hd, 2 * hd)
        cols = slice(r["tp_rank"] * kd, (r["tp_rank"] + 1) * kd)
        for got, full in ((r["kv_k"], want_kv.k), (r["kv_v"], want_kv.v)):
            np.testing.assert_allclose(got[:, 1:], full[lo:hi, 1:, :, cols],
                                       rtol=2e-4, atol=2e-4)
    layers = sorted({tuple(r["layers"]) for r in results[kind]})
    assert layers == [(0, 1), (1, 2)]


# -- engines --------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(ENGINES))
def test_pp_engine_greedy_matches_jax(name, pool):
    """Greedy tokens equal the JAX engine's on the same mesh, on every
    rank; mixed batching is off under pp, as in the JAX engine, and each
    rank's pool holds its stage's layers."""
    results, refs = pool
    got = results[name]
    assert all(r["tokens"] == got[0]["tokens"] for r in got), "ranks differ"
    assert got[0]["tokens"] == refs[f"jax:{name}"]
    _, preset, model, sizes, *_ = ENGINES[name]
    L = get_model_config(preset).replace(**model).num_layers
    for r in got:
        assert not r["mixed"] and r["kinds"].get("mixed", 0) == 0
        assert r["kv_shape"][0] == L // sizes["pp"]
    if name == "chunked":
        assert got[0]["kinds"]["prefill"] >= 3     # 40 tokens in 16s


def test_draft_pool_takes_the_min_of_free_memory(pool):
    """Four ranks read four different free byte counts; every draft pool
    gets the pages of the least (half of it over the page bytes)."""
    results, _ = pool
    want = max(min(DRAFT_WANT, (10 ** 6 // 2) // DRAFT_PAGE_BYTES), 2)
    assert results["draft_pool"] == [want] * 4


# -- refusals and shapes --------------------------------------------------------

def test_pp_refuses_indivisible_layers():
    cfg = EngineConfig(model=get_model_config("debug-tiny").replace(
        num_layers=3), parallel=ParallelConfig(pp=2))
    with pytest.raises(ValueError, match="num_layers=3 not divisible by "
                                         "pp=2"):
        LLMEngine(cfg, device="cpu")


def test_north_star_70b_tp_pp_stage_shapes():
    """llama-3-70b at pp 2 x tp 4, drawn on the ``meta`` device (no
    memory): each rank holds a 40-layer stage of its tp slices, the
    embedding and head vocab-split and whole over pp."""
    cfg = get_model_config("llama-3-70b")
    d, hd, ff, V = (cfg.hidden_size, cfg.head_dim, cfg.intermediate_size,
                    cfg.vocab_size)
    for rank in (0, 5):
        groups = make_mesh(pp=2, tp=4, rank=rank)
        params = TM.init_params(cfg, None, "meta",
                                shard=init_shard_fn(cfg, groups))
        layers = params["layers"]
        assert len(stage_layers(cfg, groups)) == 40
        assert stage_layers(cfg, groups).start == 40 * groups.pp_rank
        assert tuple(layers["wq"].shape) == (40, d, 64 // 4 * hd)
        assert tuple(layers["wk"].shape) == (40, d, 8 // 4 * hd)
        assert tuple(layers["wo"].shape) == (40, 64 // 4 * hd, d)
        assert tuple(layers["w_down"].shape) == (40, ff // 4, d)
        assert tuple(layers["input_norm"].shape) == (40, d)
        assert tuple(params["embed"].shape) == (V // 4, d)
        assert tuple(params["lm_head"].shape) == (d, V // 4)
        assert params["final_norm"].device.type == "meta"
