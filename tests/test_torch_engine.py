"""The port's LLMEngine / AsyncLLMEngine against the JAX package, on the CPU.

One JAX weight set (``debug-tiny``, fp32) drives both engines through the
same batch: prompts longer than the prefill budget (chunked prefill), more
prompts than seats (mixed steps while others decode), decode windows, and a
page pool small enough to force recompute preemptions. Greedy outputs must
be token-for-token identical (tolerance: none — both sides compute fp32
logits that agree to ~1e-6, far from any argmax tie on these weights).
Mixed batching on and off must give identical outputs, greedy and seeded.
The same greedy workload runs on every model family of
``tests/test_torch_model.py``'s ``VARIANTS`` (random biases and norm
weights) against the JAX engine on the same weights.

Also here: the no-device default raises, the port imports neither JAX nor
the JAX package, and the port's flight recorder snapshots on a freshly
booted host.
"""

import asyncio
import subprocess
import sys
from pathlib import Path

import jax
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
from kubernetes_gpu_cluster_tpu_torch.config import (CacheConfig,
                                                     EngineConfig,
                                                     ParallelConfig,
                                                     SchedulerConfig,
                                                     get_model_config)
from kubernetes_gpu_cluster_tpu_torch.engine import LLMEngine, SamplingParams
from kubernetes_gpu_cluster_tpu_torch.models import llama as TM
from kubernetes_gpu_cluster_tpu_torch.observability.flightrecorder import \
    FlightRecorder
from kubernetes_gpu_cluster_tpu_torch.serving.async_engine import \
    AsyncLLMEngine
from test_torch_model import (VARIANTS, both_packages, variant_cfgs,
                              variant_params)

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent

CACHE = dict(page_size=8, num_pages=24)
SCHED = dict(max_num_seqs=4, max_prefill_tokens=64, decode_buckets=(1, 2, 4),
             prefill_buckets=(32, 64), decode_window=4)
PROMPT_LENS = (5, 40, 100, 17, 9, 70)
MAX_TOKENS = 20


def _port_cfg(**sched):
    return EngineConfig(model=get_model_config("debug-tiny"),
                        cache=CacheConfig(**CACHE),
                        scheduler=SchedulerConfig(**{**SCHED, **sched}))


def _prompts():
    rng = np.random.default_rng(0)
    return [[int(x) for x in rng.integers(1, 500, n)] for n in PROMPT_LENS]


@pytest.fixture(scope="module")
def weights():
    cfg = jax_model("debug-tiny")
    jp = JM.init_params(cfg, jax.random.key(3))
    return jp, TM.params_from_numpy(jax.tree.map(np.asarray, jp),
                                    get_model_config("debug-tiny"), "cpu")


@pytest.fixture(scope="module")
def jax_greedy(weights):
    cfg = JEngineConfig(model=jax_model("debug-tiny"), cache=JCache(**CACHE),
                        scheduler=JSched(**SCHED))
    eng = JaxEngine(cfg, params=weights[0])
    outs = eng.generate(_prompts(), JaxParams(max_tokens=MAX_TOKENS,
                                              temperature=0.0))
    return [o.output_token_ids for o in outs]


def _run(engine, prompts, params):
    """Step the engine to completion; returns (outputs by request, the
    count of each forward pass that ran)."""
    calls = {"forward_prefill": 0, "forward_prefill_hist": 0,
             "forward_mixed": 0, "forward_decode": 0}
    originals = {name: getattr(TM, name) for name in calls}

    def counted(name):
        def fn(*a, **k):
            calls[name] += 1
            return originals[name](*a, **k)
        return fn

    plist = params if isinstance(params, list) else [params] * len(prompts)
    for i, (p, sp) in enumerate(zip(prompts, plist)):
        engine.add_request(f"req-{i}", p, sp)
    final = {}
    mp = pytest.MonkeyPatch()
    try:
        for name in calls:
            mp.setattr(TM, name, counted(name))
        while engine.has_unfinished_requests():
            for out in engine.step():
                if out.finished:
                    final[out.request_id] = out
    finally:
        mp.undo()
    return [final[f"req-{i}"] for i in range(len(prompts))], calls


def test_greedy_generate_matches_jax_engine(weights, jax_greedy):
    engine = LLMEngine(_port_cfg(), params=weights[1], device="cpu")
    outs, calls = _run(engine, _prompts(),
                       SamplingParams(max_tokens=MAX_TOKENS, temperature=0.0))
    assert [o.output_token_ids for o in outs] == jax_greedy
    assert all(o.finish_reason == "length" for o in outs)
    # The batch really went through every step kind and preempted.
    assert all(n > 0 for n in calls.values()), calls
    assert engine.scheduler.num_preemptions > 0
    # Every page returned to the pool (page 0 is scrap).
    assert engine.scheduler.allocator.num_free == CACHE["num_pages"] - 1


# One prefill and one decode bucket: the JAX engine compiles five programs
# per model, not a dozen.
VSCHED = dict(SCHED, decode_buckets=(4,), prefill_buckets=(64,))


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_variant_greedy_generate_matches_jax_engine(name):
    """Each model family through chunked prefill, mixed steps, decode
    windows and preemption: token-identical to the JAX engine."""
    jcfg, tcfg = variant_cfgs(name)
    jp, tp = both_packages(jcfg, tcfg, variant_params(jcfg, 3))
    sp = dict(max_tokens=MAX_TOKENS, temperature=0.0)
    jeng = JaxEngine(JEngineConfig(model=jcfg, cache=JCache(**CACHE),
                                   scheduler=JSched(**VSCHED)), params=jp)
    want = [o.output_token_ids for o in jeng.generate(_prompts(),
                                                      JaxParams(**sp))]
    engine = LLMEngine(EngineConfig(model=tcfg, cache=CacheConfig(**CACHE),
                                    scheduler=SchedulerConfig(**VSCHED)),
                       params=tp, device="cpu")
    outs, calls = _run(engine, _prompts(), SamplingParams(**sp))
    assert [o.output_token_ids for o in outs] == want
    assert all(n > 0 for n in calls.values()), calls
    assert engine.scheduler.num_preemptions > 0


def test_mixed_on_off_identical_greedy_and_seeded(weights, jax_greedy):
    params = [SamplingParams(max_tokens=MAX_TOKENS, temperature=0.0)] * 6
    params[1] = SamplingParams(max_tokens=MAX_TOKENS, temperature=0.9,
                               top_k=40, top_p=0.9, seed=11)
    params[4] = SamplingParams(max_tokens=MAX_TOKENS, temperature=0.7,
                               seed=5, presence_penalty=0.5,
                               frequency_penalty=0.3, logprobs=True,
                               top_logprobs=2, logit_bias={7: 2.0})
    results = {}
    for mixed in (True, False):
        engine = LLMEngine(_port_cfg(mixed_batch_enabled=mixed),
                           params=weights[1], device="cpu")
        outs, calls = _run(engine, _prompts(), params)
        assert (calls["forward_mixed"] > 0) == mixed
        results[mixed] = outs
    for a, b in zip(results[True], results[False]):
        assert a.output_token_ids == b.output_token_ids
        assert a.output_logprobs == b.output_logprobs or (
            np.allclose(a.output_logprobs, b.output_logprobs, atol=1e-5))
    # Greedy rows keep the JAX engine's tokens in a heterogeneous batch.
    for i in (0, 2, 3, 5):
        assert results[True][i].output_token_ids == jax_greedy[i]
    tops = results[True][4].output_top_logprobs
    assert len(tops) == MAX_TOKENS and all(2 <= len(t) <= 3 for t in tops)


def test_prefix_caching_reuses_pages_with_identical_output(weights):
    """Prompts sharing a page-aligned prefix: with prefix caching on, the
    second wave reuses cached pages (hits > 0) and every output equals the
    caching-off engine's."""
    rng = np.random.default_rng(5)
    shared = [int(x) for x in rng.integers(1, 500, 24)]
    prompts = [shared + [int(x) for x in rng.integers(1, 500, n)]
               for n in (3, 11, 30)]
    sp = SamplingParams(max_tokens=8, temperature=0.0)
    outs = {}
    for caching in (True, False):
        engine = LLMEngine(_port_cfg(enable_prefix_caching=caching),
                           params=weights[1], device="cpu")
        first = engine.generate(prompts, sp)
        second = engine.generate(prompts, sp)
        assert ([o.output_token_ids for o in first]
                == [o.output_token_ids for o in second])
        outs[caching] = [o.output_token_ids for o in second]
        if caching:
            assert engine.scheduler.prefix_cache.hits > 0
    assert outs[True] == outs[False]


def test_abort_mid_window_defers_page_release(weights):
    """An abort while a chained decode window is in flight finishes the
    request at once but frees its pages only when the chain drains; the
    other requests run on unchanged and every page comes back."""
    engine = LLMEngine(_port_cfg(), params=weights[1], device="cpu")
    prompts = _prompts()[:3]
    sp = SamplingParams(max_tokens=MAX_TOKENS, temperature=0.0)
    want = LLMEngine(_port_cfg(), params=weights[1], device="cpu").generate(
        prompts, sp)
    for i, p in enumerate(prompts):
        engine.add_request(f"req-{i}", p, sp)
    final = {}
    while engine._inflight is None and engine.has_unfinished_requests():
        for out in engine.step():
            final[out.request_id] = out
    assert engine._inflight is not None
    assert engine.abort_request("req-1")
    assert "req-1" in engine._inflight["zombies"]
    while engine.has_unfinished_requests():
        for out in engine.step():
            if out.finished:
                final[out.request_id] = out
    assert final["req-0"].output_token_ids == want[0].output_token_ids
    assert final["req-2"].output_token_ids == want[2].output_token_ids
    assert len(final["req-1"].output_token_ids) < MAX_TOKENS
    assert engine.scheduler.allocator.num_free == CACHE["num_pages"] - 1


def test_async_engine_streams(weights):
    prompts = _prompts()[:3]
    sp = SamplingParams(max_tokens=12, temperature=0.0)
    want = LLMEngine(_port_cfg(), params=weights[1], device="cpu").generate(
        prompts, sp)

    async def main():
        aeng = AsyncLLMEngine(_port_cfg(), params=weights[1], device="cpu")
        aeng.start()

        async def one(i, p):
            toks, chunks = [], 0
            async for chunk in aeng.generate(f"s{i}", p, sp):
                toks += chunk.new_token_ids
                chunks += 1
            return toks, chunks
        try:
            return await asyncio.wait_for(
                asyncio.gather(*(one(i, p) for i, p in enumerate(prompts))),
                timeout=60)
        finally:
            aeng.shutdown()

    got = asyncio.run(main())
    assert [t for t, _ in got] == [o.output_token_ids for o in want]
    assert all(chunks > 1 for _, chunks in got)   # streamed, not one blob


def test_no_device_default_raises(monkeypatch, weights):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LLMEngine(_port_cfg(), params=weights[1])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        AsyncLLMEngine(_port_cfg(), params=weights[1])


def test_unported_engine_options_raise(weights):
    """tp, pp and sp above 1 need the process group
    (tests/test_torch_parallel.py, test_torch_pp.py and test_torch_sp.py
    run them); the host KV tier is ported, so swap_space_gb > 0 builds a
    swapper, on the CPU too."""
    for axis in ("pp", "sp", "tp"):
        with pytest.raises(RuntimeError, match="initialize_distributed"):
            LLMEngine(EngineConfig(model=get_model_config("debug-tiny"),
                                   parallel=ParallelConfig(**{axis: 2})),
                      params=weights[1], device="cpu")
    eng = LLMEngine(EngineConfig(model=get_model_config("debug-tiny"),
                                 cache=CacheConfig(swap_space_gb=0.1)),
                    params=weights[1], device="cpu")
    assert eng.swapper is not None and eng.scheduler.swapper is eng.swapper
    assert eng.swapper.host.num_pages > 0


def test_port_imports_neither_jax_nor_the_jax_package():
    """Import every module of the port in a fresh interpreter, ``analysis/``
    (the linter and the sanitizers) included: neither ``jax`` nor
    ``kubernetes_gpu_cluster_tpu`` (exact package name — the port's own
    name shares its prefix) may be loaded."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import kubernetes_gpu_cluster_tpu_torch as port\n"
        "names = [m.name for m in pkgutil.walk_packages(port.__path__, "
        "'kubernetes_gpu_cluster_tpu_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'kubernetes_gpu_cluster_tpu')]\n"
        "analysis = [n for n in names if '.analysis.' in n]\n"
        "print(len(names), len(analysis), bad, 'WALKED')\n"
        "sys.exit(1 if bad or len(names) < 20 or len(analysis) < 20 "
        "else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "WALKED" in proc.stdout, proc.stdout + proc.stderr
    # chip_smoke.py, the on-card entry, imports neither either.
    src = (REPO / "chip_smoke.py").read_text()
    assert "import jax" not in src and "kubernetes_gpu_cluster_tpu." \
        not in src.replace("kubernetes_gpu_cluster_tpu_torch", "")


def test_port_serves_without_aiohttp_or_transformers():
    """The card's installation has neither aiohttp nor transformers: with
    both blocked, a fresh interpreter imports every port module, builds the
    port's server on the CPU and serves one completion over a socket."""
    code = (
        "import sys\n"
        "sys.modules['aiohttp'] = None\n"
        "sys.modules['transformers'] = None\n"
        "import asyncio, http.client, importlib, json, pkgutil\n"
        "import kubernetes_gpu_cluster_tpu_torch as port\n"
        "for m in pkgutil.walk_packages(port.__path__, "
        "'kubernetes_gpu_cluster_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "from kubernetes_gpu_cluster_tpu_torch.config import EngineConfig, "
        "CacheConfig, get_model_config\n"
        "from kubernetes_gpu_cluster_tpu_torch.serving import build_server\n"
        "from kubernetes_gpu_cluster_tpu_torch.serving.http import Server\n"
        "cfg = EngineConfig(model=get_model_config('debug-tiny'), "
        "cache=CacheConfig(page_size=16, num_pages=32))\n"
        "async def main():\n"
        "    srv = Server(build_server(cfg, device='cpu').build_app())\n"
        "    await srv.start('127.0.0.1', 0)\n"
        "    def call():\n"
        "        c = http.client.HTTPConnection('127.0.0.1', srv.port, "
        "timeout=60)\n"
        "        c.request('POST', '/v1/completions', json.dumps({'prompt': "
        "'hi', 'max_tokens': 3, 'temperature': 0}), "
        "{'Content-Type': 'application/json'})\n"
        "        r = c.getresponse()\n"
        "        return r.status, json.loads(r.read())\n"
        "    try:\n"
        "        return await asyncio.to_thread(call)\n"
        "    finally:\n"
        "        await srv.close()\n"
        "status, body = asyncio.run(main())\n"
        "print(status, body['usage'])\n"
        "sys.exit(0 if status == 200 and body['usage']['completion_tokens'] "
        "== 3 else 1)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "aiohttp" not in (REPO / "chip_smoke.py").read_text()


def test_flight_recorder_snapshots_on_a_fresh_host(monkeypatch):
    """The port's copy starts ``_last_snapshot`` at -inf: the first
    snapshot is taken even while time.monotonic() (time since boot) is
    still below the snapshot interval."""
    import kubernetes_gpu_cluster_tpu_torch.observability.flightrecorder as fr
    monkeypatch.setattr(fr.time, "monotonic", lambda: 5.0)
    rec = FlightRecorder(snapshot_interval_s=3600.0, enabled=True)
    rec.set_snapshot_source(lambda: {"waiting": 0})
    rec.maybe_snapshot()
    rec.maybe_snapshot()          # within the interval: not again
    snaps = [e for e in rec._ring if e[1] == "snapshot"]
    assert len(snaps) == 1 and snaps[0][3] == {"waiting": 0}
