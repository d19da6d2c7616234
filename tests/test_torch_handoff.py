"""The port's KV export/import seams against the JAX package, on the CPU.

One JAX weight set (``debug-tiny``, fp32) drives every engine, so a state
exported by either package imports into either:

- the engine-level cases of ``tests/test_disagg.py::TestHandoffByteIdentity``,
  ``tests/test_migration.py::TestMidStreamByteIdentity`` and
  ``tests/test_fleet_cache.py``'s ``TestPulledPrefixByteIdentity``,
  ``TestDeltaExport`` and ``TestRemoteSpill``, re-pointed at the port, with
  the states passed as dicts (the port's own codec is held to the JAX
  package's in ``tests/test_torch_wire.py``);
- across packages, both directions, through the JAX package's own wire
  codec (``serving/handoff.py``, imported here only): a JAX prefill
  replica's ``export_held`` state imports into the port and a port export
  into the JAX engine, and the same for ``export_prefix`` into the streamed
  prefix import; the tokens equal the JAX colocated run and no page leaks
  on either side. A bf16 port state crosses the codec through the 16-bit
  view of ``ml_dtypes.bfloat16``;
- the async engine: ``generate(hold_kv=True)`` then
  ``run_in_worker(export_held)``, and ``generate(handoff=state)``, with the
  fallback to a local prefill when the import is refused.
"""

import asyncio
import dataclasses
import time

import jax
import ml_dtypes
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
from kubernetes_gpu_cluster_tpu.serving.handoff import (
    PrefixStreamDecoder, decode_handoff, encode_handoff, encode_prefix_frames)
from kubernetes_gpu_cluster_tpu_torch.config import (CacheConfig,
                                                     EngineConfig,
                                                     SchedulerConfig,
                                                     get_model_config)
from kubernetes_gpu_cluster_tpu_torch.engine import LLMEngine, SamplingParams
from kubernetes_gpu_cluster_tpu_torch.models import llama as TM
from kubernetes_gpu_cluster_tpu_torch.serving.async_engine import \
    AsyncLLMEngine

torch.set_num_threads(2)

_SCHED = dict(max_num_seqs=4, max_prefill_tokens=128, decode_buckets=(1, 2),
              prefill_buckets=(32, 64, 128), decode_window=4,
              mixed_batch_enabled=False)
PROMPT = np.random.default_rng(3).integers(1, 500, 40).tolist()
PREFIX_PROMPT = np.random.default_rng(4).integers(1, 500, 80).tolist()


@pytest.fixture(scope="module")
def weights():
    jp = JM.init_params(jax_model("debug-tiny"), jax.random.key(9))
    return jp, TM.params_from_numpy(jax.tree.map(np.asarray, jp),
                                    get_model_config("debug-tiny"), "cpu")


def _cfg(prefix=False, swap_gb=0.0, num_pages=64, dtype=None):
    model = get_model_config("debug-tiny")
    if dtype is not None:
        model = model.replace(dtype=dtype)
    return EngineConfig(
        model=model,
        cache=CacheConfig(page_size=16, num_pages=num_pages,
                          swap_space_gb=swap_gb),
        scheduler=SchedulerConfig(enable_prefix_caching=prefix, **_SCHED))


def _mk(weights, **kw):
    return LLMEngine(_cfg(**kw), params=weights[1], device="cpu")


@pytest.fixture(scope="module")
def engines(weights):
    """Two port engines on one weight set, no prefix caching: the first is
    colocated reference, prefill replica and migration source; the second
    the decode replica / migration target."""
    return _mk(weights), _mk(weights)


@pytest.fixture(scope="module")
def fleet(weights):
    """(owner, importer) with prefix caching; the importer has a host tier
    so the remote-spill rung is exercisable on the same pair."""
    return (_mk(weights, prefix=True, num_pages=96),
            _mk(weights, prefix=True, num_pages=96, swap_gb=0.001))


@pytest.fixture(scope="module")
def jax_engine(weights):
    cfg = JEngineConfig(model=jax_model("debug-tiny"),
                        cache=JCache(page_size=16, num_pages=96),
                        scheduler=JSched(enable_prefix_caching=True,
                                         **_SCHED))
    return JaxEngine(cfg, params=weights[0])


def _drain(eng):
    while eng.has_unfinished_requests():
        eng.step()


def _run_to_completion(eng, rid):
    final = None
    while eng.has_unfinished_requests():
        for o in eng.step():
            if o.request_id == rid and o.finished:
                final = o
    return final


def _step_until_outputs(eng, rid, n):
    while True:
        seq = eng.scheduler.find_running(rid)
        if seq is not None and len(seq.output_token_ids) >= n:
            return seq
        assert eng.has_unfinished_requests(), \
            f"{rid} finished before reaching {n} outputs"
        eng.step()


def _held_state(eng, rid, prompt, params):
    """prefill with hold_kv and max_tokens=1, then export_held."""
    eng.add_request(rid, prompt, dataclasses.replace(params, max_tokens=1),
                    hold_kv=True)
    _drain(eng)
    return eng.export_held(rid)


def _finish_import(eng, rid, prompt, params, state):
    outs = eng.import_request(rid, prompt, params, state)
    assert outs[0].new_token_ids == list(state["output_token_ids"])
    if outs[0].finished:
        return list(outs[0].output_token_ids)
    return list(_run_to_completion(eng, rid).output_token_ids)


def _disagg_roundtrip(eng, rid, prompt, params):
    state = _held_state(eng, f"{rid}-pf", prompt, params)
    return _finish_import(eng, f"{rid}-dc", prompt, params, state)


def _numpy_state(state):
    """A port state with its K/V as numpy arrays, as the JAX package's
    codec wants them (bf16 through its 16-bit pattern)."""
    out = dict(state)
    for key in ("k", "v"):
        t = state[key]
        out[key] = (t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
                    if t.dtype == torch.bfloat16 else t.numpy())
    return out


class TestHandoffByteIdentity:
    def test_greedy_identical_to_colocated(self, engines):
        eng = engines[0]
        params = SamplingParams(max_tokens=12, temperature=0.0)
        ref = eng.generate([PROMPT], params)[0].output_token_ids
        assert _disagg_roundtrip(eng, "g", PROMPT, params) == ref

    def test_seeded_sampled_identical_to_colocated(self, engines):
        eng = engines[0]
        params = SamplingParams(max_tokens=12, temperature=0.8, top_k=30,
                                top_p=0.95, seed=17)
        ref = eng.generate([PROMPT], params)[0].output_token_ids
        assert _disagg_roundtrip(eng, "s", PROMPT, params) == ref

    def test_no_pages_leak_across_the_handoff(self, engines):
        eng = engines[0]
        alloc = eng.scheduler.allocator
        free0 = alloc.num_free
        _disagg_roundtrip(eng, "leak", PROMPT,
                          SamplingParams(max_tokens=4, temperature=0.0))
        assert alloc.num_free == free0

    def test_eos_on_first_token_finishes_at_import(self, engines):
        eng = engines[0]
        params = SamplingParams(max_tokens=8, temperature=0.0)
        stop_tok = eng.generate([PROMPT], params)[0].output_token_ids[0]
        params = SamplingParams(max_tokens=8, temperature=0.0,
                                stop_token_ids=(stop_tok,))
        free0 = eng.scheduler.allocator.num_free
        assert _disagg_roundtrip(eng, "eos", PROMPT, params) == [stop_tok]
        assert eng.scheduler.allocator.num_free == free0

    def test_discard_held_releases_without_export(self, engines):
        eng = engines[0]
        free0 = eng.scheduler.allocator.num_free
        eng.add_request("dis-pf", PROMPT,
                        SamplingParams(max_tokens=1, temperature=0.0),
                        hold_kv=True)
        _drain(eng)
        assert "dis-pf" in eng.scheduler.held
        eng.discard_held("dis-pf")
        eng.discard_held("dis-pf")   # idempotent
        assert eng.scheduler.allocator.num_free == free0
        with pytest.raises(KeyError):
            eng.export_held("dis-pf")

    def test_abort_releases_held_kv(self, engines):
        eng = engines[0]
        free0 = eng.scheduler.allocator.num_free
        eng.add_request("abt-pf", PROMPT,
                        SamplingParams(max_tokens=1, temperature=0.0),
                        hold_kv=True)
        _drain(eng)
        assert "abt-pf" in eng.scheduler.held
        assert eng.abort_request("abt-pf")
        assert "abt-pf" not in eng.scheduler.held
        assert eng.scheduler.allocator.num_free == free0

    def test_held_in_a_chained_window_is_parked(self, engines):
        """A hold_kv request finishing inside a chained decode window is
        parked by the deferred release, not freed."""
        eng = engines[0]
        free0 = eng.scheduler.allocator.num_free
        eng.add_request("chain-pf", PROMPT,
                        SamplingParams(max_tokens=10, temperature=0.0),
                        hold_kv=True)
        _drain(eng)
        seq = eng.scheduler.held["chain-pf"]
        assert len(seq.output_token_ids) == 10 and seq.pages
        eng.discard_held("chain-pf")
        assert eng.scheduler.allocator.num_free == free0

    def test_import_breaks_a_chained_window(self, engines):
        """An import joins ``running`` outside schedule(): the decode-window
        chain in flight breaks at the next step, so the imported sequence
        is served at once instead of after the chain's own sequences."""
        e1, e2 = engines
        params = SamplingParams(max_tokens=4, temperature=0.0)
        ref = e1.generate([PROMPT], params)[0].output_token_ids
        state = _held_state(e1, "stale-pf", PROMPT, params)
        e2.add_request("stale-long", PROMPT[::-1],
                       SamplingParams(max_tokens=200, temperature=0.0))
        while e2._inflight is None:
            e2.step()
        e2.import_request("stale-dc", PROMPT, params, state)
        done = {}
        for _ in range(3):
            for o in e2.step():
                if o.finished:
                    done[o.request_id] = o.output_token_ids
        assert done.get("stale-dc") == ref
        assert e2.abort_request("stale-long")
        _drain(e2)

    def test_import_records_decode_side_ttft(self, engines):
        eng = engines[0]
        obs = eng.obs
        params = SamplingParams(max_tokens=4, temperature=0.0)
        state = _held_state(eng, "ttft-pf", PROMPT, params)
        obs.slo.clear()
        state["_ttft_t0"] = time.monotonic() - 5.0   # the pull "took" 5 s
        eng.import_request("ttft-dc", PROMPT, params, state)
        ttfts = list(obs.slo._ttfts)
        assert len(ttfts) == 1 and ttfts[0] >= 5.0
        assert obs.slo.attainment() == 0.0
        _run_to_completion(eng, "ttft-dc")
        assert len(obs.slo._good) == 0
        obs.slo.clear()

    def test_malformed_output_state_rejected_without_page_leak(self,
                                                               engines):
        eng = engines[0]
        params = SamplingParams(max_tokens=4, temperature=0.0)
        state = _held_state(eng, "mal-pf", PROMPT, params)
        free0 = eng.scheduler.allocator.num_free
        for field, garbage in (("output_token_ids", ["x"]),
                               ("output_logprobs", ["nope"]),
                               ("output_top_logprobs", [5])):
            bad = dict(state, **{field: garbage})
            with pytest.raises(ValueError, match="malformed handoff"):
                eng.import_request(f"mal-{field}", PROMPT, params, bad)
            assert eng.scheduler.allocator.num_free == free0
        outs = eng.import_request("mal-ok", PROMPT, params, state)
        assert outs[0].new_token_ids
        _run_to_completion(eng, "mal-ok")

    def test_failed_pull_backdates_arrival(self, engines):
        eng = engines[0]
        obs = eng.obs
        obs.slo.clear()
        t0 = time.monotonic() - 5.0
        eng.add_request("bkd", PROMPT,
                        SamplingParams(max_tokens=2, temperature=0.0),
                        arrival_t0=t0)
        seq = next(s for s in eng.scheduler.waiting
                   if s.request_id == "bkd")
        assert seq.arrival_time == t0
        _run_to_completion(eng, "bkd")
        ttfts = list(obs.slo._ttfts)
        assert len(ttfts) == 1 and ttfts[0] >= 5.0
        assert obs.slo.attainment() == 0.0
        obs.slo.clear()

    def test_import_rejects_mismatched_state(self, engines):
        eng = engines[0]
        params = SamplingParams(max_tokens=4, temperature=0.0)
        state = _held_state(eng, "rej-pf", PROMPT, params)
        free0 = eng.scheduler.allocator.num_free
        with pytest.raises(ValueError, match="prompt does not match"):
            eng.import_request("rej-a", PROMPT[:-1] + [1], params, state)
        for field, garbage, match in (
                ("page_size", 32, "page_size"), ("model", "llama-3-8b",
                                                 "model"),
                ("k", state["k"][:, :1], "shape"),
                ("v", state["v"].to(torch.float16), "dtype"),
                ("k", [[0.0]], "malformed")):
            with pytest.raises(ValueError, match=match):
                eng.import_request("rej-b", PROMPT, params,
                                   dict(state, **{field: garbage}))
        assert eng.scheduler.allocator.num_free == free0
        outs = eng.import_request("rej-d", PROMPT, params, state)
        assert outs[0].new_token_ids
        _run_to_completion(eng, "rej-d")

    def test_import_without_pages_is_refused(self, weights):
        """Capacity shortfalls raise the refusal type the async engine
        degrades on (a RuntimeError), before any page is taken."""
        from kubernetes_gpu_cluster_tpu_torch.engine.kv_cache import \
            KVTransferRefused
        src = _mk(weights)
        params = SamplingParams(max_tokens=4, temperature=0.0)
        state = _held_state(src, "cap-pf", PROMPT, params)
        small = _mk(weights, num_pages=3)
        with pytest.raises(KVTransferRefused, match="no KV pages"):
            small.import_request("cap", PROMPT, params, state)
        assert small.scheduler.allocator.num_free == 2


class TestMidStreamByteIdentity:
    def _roundtrip(self, engines, rid, params, split=4):
        e1, e2 = engines
        ref = e1.generate([PROMPT], params)[0]
        free1 = e1.scheduler.allocator.num_free
        free2 = e2.scheduler.allocator.num_free
        e1.add_request(f"{rid}-src", PROMPT, params)
        _step_until_outputs(e1, f"{rid}-src", split)
        state = e1.export_running(f"{rid}-src")
        assert state["mid_stream"] is True
        assert len(state["output_token_ids"]) < len(ref.output_token_ids)
        assert ref.output_token_ids[:len(state["output_token_ids"])] == \
            state["output_token_ids"]
        rt = SamplingParams.from_state(state["sampling"])
        assert rt.seed == params.seed and rt.max_tokens == params.max_tokens
        outs = e2.import_request(f"{rid}-dst", PROMPT, params, state)
        assert outs[0].new_token_ids == state["output_token_ids"]
        final = (_run_to_completion(e2, f"{rid}-dst")
                 if not outs[0].finished else outs[0])
        _drain(e1)   # zombie chain: deferred page release
        assert e1.scheduler.allocator.num_free == free1, "exporter leaked"
        assert e2.scheduler.allocator.num_free == free2, "importer leaked"
        return ref, final

    def test_greedy_midstream_identical_to_uninterrupted(self, engines):
        params = SamplingParams(max_tokens=12, temperature=0.0,
                                logprobs=True)
        ref, got = self._roundtrip(engines, "g", params)
        assert got.output_token_ids == ref.output_token_ids
        np.testing.assert_allclose(got.output_logprobs, ref.output_logprobs,
                                   rtol=1e-5, atol=1e-5)
        assert got.finish_reason == ref.finish_reason

    def test_seeded_sampled_with_penalties_identical(self, engines):
        params = SamplingParams(max_tokens=12, temperature=0.9, top_k=30,
                                top_p=0.95, seed=17, presence_penalty=0.4,
                                frequency_penalty=0.3, logprobs=True)
        ref, got = self._roundtrip(engines, "s", params, split=5)
        assert got.output_token_ids == ref.output_token_ids
        np.testing.assert_allclose(got.output_logprobs, ref.output_logprobs,
                                   rtol=1e-5, atol=1e-5)

    def test_token_replay_resume_identical(self, engines):
        e1, e2 = engines
        for tag, params in (
                ("rp-g", SamplingParams(max_tokens=10, temperature=0.0)),
                ("rp-s", SamplingParams(max_tokens=10, temperature=0.8,
                                        top_k=40, seed=23,
                                        presence_penalty=0.5))):
            ref = e1.generate([PROMPT], params)[0]
            e2.add_request(tag, PROMPT, params,
                           resume_outputs=ref.output_token_ids[:4])
            final = _run_to_completion(e2, tag)
            assert final.output_token_ids == ref.output_token_ids, tag

    def test_resume_history_already_stopped_rejected(self, engines):
        e1, e2 = engines
        params = SamplingParams(max_tokens=4, temperature=0.0)
        ref = e1.generate([PROMPT], params)[0]
        with pytest.raises(ValueError, match="nothing to resume"):
            e2.add_request("rp-done", PROMPT, params,
                           resume_outputs=ref.output_token_ids)
        assert e2.scheduler.find_running("rp-done") is None
        _drain(e2)

    def test_export_running_requires_a_running_sequence(self, engines):
        e1, _ = engines
        with pytest.raises(KeyError):
            e1.export_running("never-seen")
        e1.add_request("wt", PROMPT, SamplingParams(max_tokens=2,
                                                    temperature=0.0))
        try:
            with pytest.raises(KeyError):
                e1.export_running("wt")
        finally:
            _drain(e1)

    def test_migrated_outcome_splits_out_in_observability(self, engines):
        e1, _ = engines
        params = SamplingParams(max_tokens=12, temperature=0.0)
        cell0 = e1.obs.e2e_latency._cells.get(("migrated",))
        n0 = cell0[2] if cell0 else 0
        e1.add_request("obs", PROMPT, params)
        _step_until_outputs(e1, "obs", 4)
        e1.export_running("obs")
        _drain(e1)
        assert e1.obs.e2e_latency._cells[("migrated",)][2] == n0 + 1


def _stream_import(dst, state, chunk_pages=2) -> int:
    """The streamed import with the state passed as a dict: begin with the
    header, one chunk of ``chunk_pages`` pages at a time, commit."""
    handle = dst.begin_prefix_import(
        {k: v for k, v in state.items() if k not in ("k", "v")})
    n = state["k"].shape[1]
    for i in range(0, n, chunk_pages):
        dst.import_prefix_chunk(handle, state["k"][:, i:i + chunk_pages],
                                state["v"][:, i:i + chunk_pages])
    return dst.commit_prefix_import(handle)


class TestPulledPrefixByteIdentity:
    def test_greedy_identical_and_cache_hit(self, fleet):
        owner, importer = fleet
        params = SamplingParams(max_tokens=8, temperature=0.0)
        ref = owner.generate([PREFIX_PROMPT], params)[0].output_token_ids
        pc = owner.scheduler.prefix_cache
        hits0, misses0 = pc.hits, pc.misses
        state = owner.export_prefix(PREFIX_PROMPT)
        assert (pc.hits, pc.misses) == (hits0, misses0)
        assert state["matched_tokens"] == 64      # 80 tokens, 16/page, <80
        assert _stream_import(importer, state) == 64
        assert importer.prefix_peek(PREFIX_PROMPT) == 64
        hits_before = importer.scheduler.prefix_cache.hits
        got = importer.generate([PREFIX_PROMPT], params)[0].output_token_ids
        assert got == ref
        assert importer.scheduler.prefix_cache.hits == hits_before + 1

    def test_seeded_sampled_identical(self, fleet):
        owner, importer = fleet
        params = SamplingParams(max_tokens=8, temperature=0.9, top_k=30,
                                top_p=0.95, seed=17)
        ref = owner.generate([PREFIX_PROMPT], params)[0].output_token_ids
        got = importer.generate([PREFIX_PROMPT], params)[0].output_token_ids
        assert got == ref

    def test_truncated_import_raises_and_frees(self, fleet):
        owner, importer = fleet
        state = owner.export_prefix(PREFIX_PROMPT)
        free0 = importer.scheduler.allocator.num_free
        handle = importer.begin_prefix_import(
            {k: v for k, v in state.items() if k not in ("k", "v")})
        importer.import_prefix_chunk(handle, state["k"][:, :2],
                                     state["v"][:, :2])
        with pytest.raises(ValueError, match="truncated"):
            importer.commit_prefix_import(handle)
        assert importer.scheduler.allocator.num_free == free0

    def test_abort_import_frees(self, fleet):
        owner, importer = fleet
        state = owner.export_prefix(PREFIX_PROMPT)
        free0 = importer.scheduler.allocator.num_free
        handle = importer.begin_prefix_import(
            {k: v for k, v in state.items() if k not in ("k", "v")})
        assert importer.scheduler.allocator.num_free < free0
        importer.abort_prefix_import(handle)
        importer.abort_prefix_import(handle)      # idempotent
        assert importer.scheduler.allocator.num_free == free0

    def test_mismatched_header_rejected_without_pages(self, fleet):
        owner, importer = fleet
        state = owner.export_prefix(PREFIX_PROMPT)
        free0 = importer.scheduler.allocator.num_free
        hdr = {k: v for k, v in state.items() if k not in ("k", "v")}
        for field, garbage in (("model", "llama-3-8b"), ("page_size", 32),
                               ("dtype", "float16"),
                               ("dtype", "torch.float32"),
                               ("matched_tokens", 63)):
            with pytest.raises(ValueError):
                importer.begin_prefix_import(dict(hdr, **{field: garbage}))
            assert importer.scheduler.allocator.num_free == free0

    def test_mismatched_chunk_aborts_the_import(self, fleet):
        owner, importer = fleet
        state = owner.export_prefix(PREFIX_PROMPT)
        free0 = importer.scheduler.allocator.num_free
        handle = importer.begin_prefix_import(
            {k: v for k, v in state.items() if k not in ("k", "v")})
        bad = state["k"][:, :1].to(torch.float16)
        with pytest.raises(ValueError):
            importer.import_prefix_chunk(handle, bad, bad)
        assert importer.scheduler.allocator.num_free == free0
        with pytest.raises(ValueError, match="unknown"):
            importer.commit_prefix_import(handle)


class TestDeltaExport:
    P2 = np.random.default_rng(21).integers(1, 500, 80).tolist()

    def test_delta_then_head_compose(self, fleet):
        owner, importer = fleet
        params = SamplingParams(max_tokens=6, temperature=0.0)
        ref = owner.generate([self.P2], params)[0].output_token_ids
        delta = owner.export_prefix(self.P2, skip_tokens=32)
        assert delta["start_tokens"] == 32
        assert delta["matched_tokens"] == 64
        assert delta["k"].shape[1] == 2          # pages 2..3 only
        _stream_import(importer, delta)
        assert importer.prefix_peek(self.P2) == 0
        free0 = importer.scheduler.allocator.num_free
        full = owner.export_prefix(self.P2)
        assert full["start_tokens"] == 0 and full["k"].shape[1] == 4
        _stream_import(importer, full)
        assert importer.scheduler.allocator.num_free == free0 - 2
        assert importer.prefix_peek(self.P2) == 64
        got = importer.generate([self.P2], params)[0].output_token_ids
        assert got == ref

    def test_skip_past_match_is_a_miss(self, fleet):
        owner, _ = fleet
        with pytest.raises(KeyError, match="beyond"):
            owner.export_prefix(self.P2, skip_tokens=64)

    def test_export_reads_host_tier_in_place(self, fleet):
        """A chain in the HOST tier is served without restoring it into the
        device pool, without counters, bit-identical to the live export."""
        _, importer = fleet
        pc = importer.scheduler.prefix_cache
        ref_state = importer.export_prefix(self.P2)
        pc.evict(len(pc))                # spills to the host tier
        assert len(pc._host_entries) >= 4
        free0 = importer.scheduler.allocator.num_free
        host_hits0 = pc.host_hits
        state = importer.export_prefix(self.P2)
        assert torch.equal(state["k"], ref_state["k"])
        assert torch.equal(state["v"], ref_state["v"])
        assert importer.scheduler.allocator.num_free == free0
        assert pc.host_hits == host_hits0
        assert len(pc) == 0


class TestRemoteSpill:
    SPILL_PROMPT = np.random.default_rng(11).integers(1, 500, 80).tolist()

    def test_spill_to_peer_host_tier_and_second_chance(self, fleet):
        owner, importer = fleet
        params = SamplingParams(max_tokens=6, temperature=0.0)
        ref = owner.generate([self.SPILL_PROMPT],
                             params)[0].output_token_ids
        spills = []
        assert owner.enable_fleet_spill(
            lambda d, k, v: (spills.append((d, k, v)) or True))
        pc = owner.scheduler.prefix_cache
        pc.evict(len(pc))
        assert len(spills) >= 4
        owner.scheduler.prefix_cache.fleet_spill = None
        accepted = sum(importer.accept_remote_spill(d, k, v)
                       for d, k, v in spills)
        assert accepted >= 4
        assert importer.prefix_peek(self.SPILL_PROMPT) == 64
        host_hits0 = importer.scheduler.prefix_cache.host_hits
        got = importer.generate([self.SPILL_PROMPT],
                                params)[0].output_token_ids
        assert got == ref
        assert importer.scheduler.prefix_cache.host_hits >= host_hits0 + 4

    def test_duplicate_and_malformed_spills_refused(self, fleet):
        owner, importer = fleet
        k = torch.zeros((2, 1, 16, 64))
        assert not importer.accept_remote_spill("aa", k[:, :, :8],
                                                k[:, :, :8])
        assert not importer.accept_remote_spill("not-hex", k, k)
        assert not owner.accept_remote_spill("ab" * 16, k, k)

    def test_spill_off_the_host_refused(self, fleet):
        # A buffer of the right shape and dtype that does not lie in host
        # memory is refused like any malformed page, not raised.
        _, importer = fleet
        host = importer.swapper.host
        in_use = host.num_in_use
        k = torch.empty((2, 1, 16, 64), device="meta")
        assert not importer.accept_remote_spill("cd" * 16, k, k)
        assert host.num_in_use == in_use


class TestAcrossPackages:
    """States cross between the JAX engine and the port, both ways, through
    the JAX package's wire codec."""

    P_HAND = np.random.default_rng(31).integers(1, 500, 40).tolist()
    P_JAX_PREFIX = np.random.default_rng(32).integers(1, 500, 80).tolist()
    P_PORT_PREFIX = np.random.default_rng(33).integers(1, 500, 80).tolist()

    def test_jax_handoff_imports_into_the_port(self, jax_engine, engines):
        params = dict(max_tokens=12, temperature=0.0)
        ref = jax_engine.generate([self.P_HAND], JaxParams(**params))[0]
        jax_engine.add_request("x-pf", self.P_HAND,
                               JaxParams(**dict(params, max_tokens=1)),
                               hold_kv=True)
        _drain(jax_engine)
        state = decode_handoff(encode_handoff(
            jax_engine.export_held("x-pf")))
        assert isinstance(state["k"], np.ndarray)
        port = engines[1]
        free0 = port.scheduler.allocator.num_free
        got = _finish_import(port, "x-dc", self.P_HAND,
                             SamplingParams(**params), state)
        assert got == ref.output_token_ids
        assert port.scheduler.allocator.num_free == free0

    def test_port_handoff_imports_into_jax(self, jax_engine, engines):
        params = dict(max_tokens=12, temperature=0.0)
        ref = jax_engine.generate([self.P_HAND], JaxParams(**params))[0]
        port = engines[0]
        free0 = port.scheduler.allocator.num_free
        state = _held_state(port, "y-pf", self.P_HAND,
                            SamplingParams(**params))
        assert port.scheduler.allocator.num_free == free0
        assert state["dtype"] == "float32"
        state = decode_handoff(encode_handoff(_numpy_state(state)))
        jfree0 = jax_engine.scheduler.allocator.num_free
        outs = jax_engine.import_request("y-dc", self.P_HAND,
                                         JaxParams(**params), state)
        assert outs[0].new_token_ids == state["output_token_ids"]
        got = _run_to_completion(jax_engine, "y-dc").output_token_ids
        assert got == ref.output_token_ids
        assert jax_engine.scheduler.allocator.num_free == jfree0

    def test_jax_prefix_imports_into_the_port(self, jax_engine, fleet):
        params = dict(max_tokens=8, temperature=0.0)
        ref = jax_engine.generate([self.P_JAX_PREFIX], JaxParams(**params))
        state = jax_engine.export_prefix(self.P_JAX_PREFIX)
        importer = fleet[1]
        assert importer.prefix_peek(self.P_JAX_PREFIX) == 0
        dec = PrefixStreamDecoder()
        handle = None
        for part in encode_prefix_frames(state, chunk_pages=2):
            chunks = dec.feed(bytes(part))
            if handle is None and dec.header is not None:
                handle = importer.begin_prefix_import(dict(dec.header))
            for ck, cv in chunks:
                importer.import_prefix_chunk(handle, ck, cv)
        assert dec.done
        assert importer.commit_prefix_import(handle) == 64
        hits0 = importer.scheduler.prefix_cache.hits
        got = importer.generate([self.P_JAX_PREFIX],
                                SamplingParams(**params))[0]
        assert importer.scheduler.prefix_cache.hits == hits0 + 1
        assert got.output_token_ids == ref[0].output_token_ids

    def test_port_prefix_imports_into_jax(self, jax_engine, fleet):
        params = dict(max_tokens=8, temperature=0.0)
        owner = fleet[0]
        owner.generate([self.P_PORT_PREFIX], SamplingParams(**params))
        state = _numpy_state(owner.export_prefix(self.P_PORT_PREFIX))
        assert jax_engine.prefix_peek(self.P_PORT_PREFIX) == 0
        dec = PrefixStreamDecoder()
        handle = None
        for part in encode_prefix_frames(state, chunk_pages=3):
            chunks = dec.feed(bytes(part))
            if handle is None and dec.header is not None:
                handle = jax_engine.begin_prefix_import(dict(dec.header))
            for ck, cv in chunks:
                jax_engine.import_prefix_chunk(handle, ck, cv)
        assert jax_engine.commit_prefix_import(handle) == 64
        jpc = jax_engine.scheduler.prefix_cache
        hits0 = jpc.hits
        got = jax_engine.generate([self.P_PORT_PREFIX], JaxParams(**params))
        assert jpc.hits == hits0 + 1
        # The JAX colocated run: its own cache emptied, a full recompute.
        jpc.evict(len(jpc))
        assert jax_engine.prefix_peek(self.P_PORT_PREFIX) == 0
        ref = jax_engine.generate([self.P_PORT_PREFIX], JaxParams(**params))
        assert got[0].output_token_ids == ref[0].output_token_ids
        alloc = jax_engine.scheduler.allocator
        jpc.evict(len(jpc))
        assert alloc.num_free == alloc.num_pages - 1

    def test_bf16_state_crosses_the_codec(self, weights):
        """A bf16 port export survives the JAX codec (numpy bfloat16 from
        ml_dtypes, read back through its 16-bit pattern): the import
        decodes as the colocated run does."""
        eng = LLMEngine(_cfg(dtype="bfloat16"), params=weights[1],
                        device="cpu")
        params = SamplingParams(max_tokens=8, temperature=0.0)
        ref = eng.generate([PROMPT], params)[0].output_token_ids
        state = _held_state(eng, "bf-pf", PROMPT, params)
        assert state["dtype"] == "bfloat16"
        wire = decode_handoff(encode_handoff(_numpy_state(state)))
        assert str(wire["k"].dtype) == "bfloat16"
        got = _finish_import(eng, "bf-dc", PROMPT, params, wire)
        assert got == ref


class TestAsyncEngine:
    def test_hold_export_and_handoff_through_the_worker(self, weights):
        """generate(hold_kv=True) parks the KV; run_in_worker(export_held)
        collects it; generate(handoff=state) imports instead of
        prefilling and streams the colocated tokens. A state the engine
        refuses falls back to a local prefill, reported once."""
        aeng = AsyncLLMEngine(_cfg(), params=weights[1], device="cpu")
        fallbacks = []
        aeng.on_import_fallback = fallbacks.append
        params = SamplingParams(max_tokens=10, temperature=0.0)

        async def collect(rid, **kw):
            toks = []
            async for chunk in aeng.generate(rid, PROMPT, params, **kw):
                toks.extend(chunk.new_token_ids)
            return toks

        async def main():
            aeng.start()
            try:
                ref = await collect("ref")
                pf = []
                async for chunk in aeng.generate(
                        "pf", PROMPT, dataclasses.replace(params,
                                                          max_tokens=1),
                        hold_kv=True):
                    pf.extend(chunk.new_token_ids)
                state = await aeng.run_in_worker(
                    lambda e: e.export_held("pf"))
                prefills = aeng.engine.stats.prefill_tokens
                got = await collect("dc", handoff=state)
                imported_prefill = (aeng.engine.stats.prefill_tokens
                                    - prefills)
                bad = dict(state, model="llama-3-8b")
                fell_back = await collect("fb", handoff=bad)
                # A stream ends with its last token; a chained window may
                # still hold its pages until the chain drains.
                await aeng.run_in_worker(_drain)
                return ref, pf, got, imported_prefill, fell_back
            finally:
                aeng.shutdown()

        ref, pf, got, imported_prefill, fell_back = asyncio.run(main())
        assert pf == ref[:1]
        assert got == ref and imported_prefill == 0
        assert fell_back == ref and fallbacks == ["fb"]
        alloc = aeng.engine.scheduler.allocator
        assert alloc.num_free == alloc.num_pages - 1
