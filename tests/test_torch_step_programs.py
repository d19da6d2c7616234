"""The prefill, solo-chunk, mixed, spec, spec×mixed and draft step
programs (``engine/step_programs.py``) against ``enforce_eager`` on the
CPU.

On the CPU the program cache keys each step's program around the same
body an ``enforce_eager`` engine runs over its own buffers, so tokens,
logprobs and alternatives must agree bit for bit on a wave that reaches
every family: pure prefills of several rows (greedy, seeded, unseeded,
top-k/top-p, penalized, biased, alternatives), partial and final solo
chunks, partial and final mixed chunks, and the re-prefill of a
recompute preemption (whose penalty counts come from the batch itself).
The stale-buffer case: a chunk's penalty history is uploaded only when a
row has penalties, so a program that ran a penalized row and then runs
without one keeps the old history, which must not change a bit.

Speculation: with n-gram drafts, an oracle draft model (the target's
weights) under adaptive k, and a mismatched draft model (other weights)
under adaptive k, whose rungs change S from step to step, staggered
requests of every sampling kind (greedy with alternatives, seeded,
unseeded, penalized and biased, top-k/top-p) give the same tokens,
logprobs, alternatives and drafted / accepted totals through the spec,
spec×mixed and draft programs as through the same bodies run eagerly.

The cyclic garbage collector is paused while any capture is open, and
captures may overlap across threads: it runs again only once the last
one closes, also when a capture raises.

Gated stages: the JAX engine's step functions record the batches they are
called with beside the port's programs on the same weights and waves
(nine batch kinds, and an oracle-draft spec×mixed wave); every step's
uploaded flags equal the JAX functions' ``lax.cond`` conditions evaluated
on the JAX engine's batch, each eager step runs each gated stage exactly
where (and as often as) its condition holds, and a program's skipped
alternatives are zero-filled.
"""

from __future__ import annotations

import dataclasses
import gc

import numpy as np
import pytest
import torch

from kubernetes_gpu_cluster_tpu_torch.config import (CacheConfig,
                                                     EngineConfig,
                                                     SchedulerConfig,
                                                     get_model_config)
from kubernetes_gpu_cluster_tpu_torch.engine import LLMEngine, SamplingParams
from kubernetes_gpu_cluster_tpu_torch.models import llama as model_lib

torch.set_num_threads(2)

SP = SamplingParams


def _config(num_pages: int) -> EngineConfig:
    return EngineConfig(
        model=get_model_config("debug-tiny"),
        cache=CacheConfig(page_size=8, num_pages=num_pages),
        scheduler=SchedulerConfig(max_num_seqs=4, max_prefill_tokens=32,
                                  decode_buckets=(1, 2, 4),
                                  prefill_buckets=(16, 32), decode_window=2))


def _pair(num_pages: int) -> dict:
    """A program engine and an ``enforce_eager`` one on the same weights."""
    graph = LLMEngine(_config(num_pages), device="cpu")
    eager = LLMEngine(dataclasses.replace(_config(num_pages),
                                          enforce_eager=True),
                      params=graph.params, device="cpu")
    return {"graph": graph, "eager": eager}


@pytest.fixture(scope="module")
def engines():
    return _pair(160)


@pytest.fixture(scope="module")
def tight():
    """A pool the wave outgrows: decode growth preempts by recompute."""
    return _pair(14)


_ROWS = [
    dict(temperature=0.0, logprobs=True, top_logprobs=3),
    dict(temperature=0.8, seed=11, logprobs=True),
    dict(temperature=1.0, logprobs=True),                       # unseeded
    dict(temperature=0.7, top_k=5, top_p=0.8, seed=4, logprobs=True),
    dict(temperature=0.0, presence_penalty=0.6, frequency_penalty=0.4,
         logprobs=True),
    dict(temperature=0.9, seed=6, logit_bias={3: 3.0, 9: -2.0},
         logprobs=True, top_logprobs=2),
]


def _outputs(outs) -> list:
    return [(o.output_token_ids, o.output_logprobs, o.output_top_logprobs)
            for o in outs]


def _staggered(eng, tag: str, rows: list, lengths: list,
               max_tokens: int) -> list:
    """Requests arrive one per two steps, in order; returns the finished
    outputs in request order."""
    rng = np.random.default_rng(len(lengths) + max_tokens)
    pending = [(f"{tag}-{i}", rng.integers(1, 500, n).tolist(),
                SP(max_tokens=max_tokens, **rows[i % len(rows)]))
               for i, n in enumerate(lengths)]
    final = {}
    while pending or eng.has_unfinished_requests():
        if pending:
            eng.add_request(*pending.pop(0))
        for _ in range(2):
            for o in eng.step():
                if o.finished:
                    final[o.request_id] = o
    return [final[f"{tag}-{i}"] for i in range(len(lengths))]


def _wave(eng) -> list:
    """Solo chunks (a 70-token prompt alone: chunks of 32, 32 and 6), a
    four-row prefill of every sampling kind, then staggered arrivals whose
    long prompts chunk beside decoding rows (mixed, partial and final)."""
    rng = np.random.default_rng(3)
    outs = eng.generate([rng.integers(1, 500, 70).tolist()],
                        [SP(max_tokens=5, **_ROWS[0])])
    outs += eng.generate([rng.integers(1, 500, n).tolist()
                          for n in (6, 9, 3, 12)],
                         [SP(max_tokens=7, **r) for r in _ROWS[1:5]])
    outs += _staggered(eng, "s", _ROWS, [5, 14, 50, 9, 75, 20], 6)
    return _outputs(outs)


def test_programs_match_eager_on_every_family(engines):
    got, want = (_wave(engines[k]) for k in ("graph", "eager"))
    assert got == want
    progs = engines["graph"]._programs
    for family in ("prefill", "prefill_hist", "mixed"):
        assert progs.keys(family), family
    assert engines["eager"].compiled_step_variants() == 0
    kinds = engines["graph"].obs.step_kind_counts
    assert kinds["prefill"] > 0 and kinds["mixed"] > 0
    # A second wave replays the same keys: nothing new is built.
    keys = progs.keys()
    assert _wave(engines["graph"]) == _wave(engines["eager"])
    assert progs.keys() == keys


def test_recompute_reprefill_matches_eager(tight):
    """Decode growth outruns a 13-page pool: sequences are preempted by
    recompute and re-prefilled with their generated tokens in the batch,
    which the prefill program counts for penalties itself."""
    rows = [dict(temperature=0.0, presence_penalty=0.8,
                 frequency_penalty=0.5, logprobs=True),
            dict(temperature=0.6, seed=9, frequency_penalty=0.7,
                 logprobs=True, top_logprobs=2),
            dict(temperature=0.0, logprobs=True),
            dict(temperature=0.8, seed=2, logprobs=True)]
    rng = np.random.default_rng(8)
    prompts = [rng.integers(1, 500, 20).tolist() for _ in rows]
    runs = {k: _outputs(eng.generate(prompts,
                                     [SP(max_tokens=18, **r) for r in rows]))
            for k, eng in tight.items()}
    assert runs["graph"] == runs["eager"]
    for eng in tight.values():
        assert eng.scheduler.num_preemptions_by_kind["recompute"] > 0
    assert tight["graph"]._programs.keys("prefill")


def test_stale_penalty_history_changes_no_bit():
    """One engine serves a wave with penalized and biased rows, then the
    same shapes with neither: its programs keep the first wave's penalty
    history, and the second wave's tokens and logprobs equal a fresh
    engine's that only ever served the second wave."""
    used = LLMEngine(_config(160), device="cpu")
    fresh = LLMEngine(_config(160), params=used.params, device="cpu")
    lengths = [6, 40, 9, 45]
    penalized = [dict(temperature=0.0, presence_penalty=0.9,
                      frequency_penalty=0.6, logit_bias={5: 2.0}),
                 dict(temperature=0.7, seed=3, frequency_penalty=1.0)]
    plain = [dict(temperature=0.0, logprobs=True, top_logprobs=2),
             dict(temperature=0.7, seed=3, logprobs=True)]
    _staggered(used, "p", penalized, lengths, 6)
    keys = used._programs.keys("mixed")
    stale = {k: used._programs.buffers(k)["out_tokens"].clone()
             for k in keys}
    assert any(t.ne(0).any() for t in stale.values())
    got = _outputs(_staggered(used, "q", plain, lengths, 6))
    want = _outputs(_staggered(fresh, "q", plain, lengths, 6))
    assert got == want
    assert used._programs.keys("mixed") == keys
    for k, t in stale.items():             # nothing was uploaded again
        assert torch.equal(used._programs.buffers(k)["out_tokens"], t)


# -- speculation ---------------------------------------------------------------

# name -> (draft model, adaptive k, seed of the draft's weights: None is
# the target's own, an oracle)
_DRAFTS = {"ngram": (None, False, None),
           "oracle": ("debug-tiny", True, None),
           "mismatched": ("debug-tiny", True, 123)}
_PATTERN = [7, 3, 9, 11, 5]


def _spec_config(draft, adaptive: bool) -> EngineConfig:
    cfg = _config(160)
    return dataclasses.replace(cfg, scheduler=dataclasses.replace(
        cfg.scheduler, mixed_batch_enabled=True, spec_decode_enabled=True,
        num_speculative_tokens=4, spec_draft_model=draft,
        spec_adaptive_k=adaptive))


@pytest.fixture(scope="module", params=sorted(_DRAFTS))
def spec_engines(request):
    draft, adaptive, seed = _DRAFTS[request.param]
    cfg = _spec_config(draft, adaptive)
    graph = LLMEngine(cfg, device="cpu")
    draft_params = None
    if draft is not None:
        draft_params = graph.params if seed is None else model_lib.init_params(
            get_model_config(draft), torch.Generator().manual_seed(seed),
            "cpu")
        graph = LLMEngine(cfg, params=graph.params, device="cpu",
                          draft_params=draft_params)
    eager = LLMEngine(dataclasses.replace(cfg, enforce_eager=True),
                      params=graph.params, device="cpu",
                      draft_params=draft_params)
    return request.param, {"graph": graph, "eager": eager}


def _spec_wave(eng, tag: str) -> tuple:
    """Repetitive prompts (drafts hit) of every sampling kind arriving one
    per two steps, a long one chunking beside verify rows (spec×mixed);
    returns the outputs and the wave's drafted / accepted totals."""
    obs = eng.obs
    d0, a0 = obs.spec_drafted_tokens, obs.spec_accepted_tokens
    lengths = [20, 12, 45, 9, 30, 16]
    rows = _ROWS[:2] + [dict(temperature=1.0, seed=21, logprobs=True,
                             top_logprobs=1)] + _ROWS[2:]
    pending = [(f"{tag}-{i}", (_PATTERN * 10)[i:i + n],
                SP(max_tokens=14, **rows[i % len(rows)]))
               for i, n in enumerate(lengths)]
    final = {}
    while pending or eng.has_unfinished_requests():
        if pending:
            eng.add_request(*pending.pop(0))
        for _ in range(2):
            for o in eng.step():
                if o.finished:
                    final[o.request_id] = o
    outs = _outputs([final[f"{tag}-{i}"] for i in range(len(lengths))])
    return outs, (obs.spec_drafted_tokens - d0,
                  obs.spec_accepted_tokens - a0)


def test_spec_programs_match_eager(spec_engines):
    name, engines = spec_engines
    got, want = (_spec_wave(engines[k], "a") for k in ("graph", "eager"))
    assert got == want
    assert got[1][0] > 0
    graph = engines["graph"]
    kinds = graph.obs.step_kind_counts
    assert kinds["spec"] > 0 and kinds["spec_mixed"] > 0, kinds
    progs = graph._programs
    families = ["spec", "spec_mixed"] + (
        ["draft_decode", "draft_prefill"] if name != "ngram" else [])
    for family in families:
        assert progs.keys(family), family
    assert engines["eager"].compiled_step_variants() == 0
    assert graph.compiled_step_variants() == len(progs.keys())
    if name == "mismatched":       # adaptive k moved: more than one rung
        assert len({k[-1] for k in progs.keys("spec")
                    + progs.keys("spec_mixed")}) > 1
    # The same wave again: the same outputs both ways (the unseeded row's
    # keys move with the engine's generator, and the adaptive controller
    # starts the wave where the first left it: compared between the two
    # engines only); at a static k nothing new is built.
    keys = progs.keys()
    again = {k: _spec_wave(e, "b") for k, e in engines.items()}
    assert again["graph"] == again["eager"]
    if name == "ngram":
        assert progs.keys() == keys


def test_program_bytes_reckons_the_largest_program_of_every_family():
    """The shared pool's reckoning takes the largest program of every
    family the engine may build: with speculation, the spec×mixed step at
    the ladder's top rung, whose ``[R * S, V]`` fp32 logits alone are 148
    MB for llama-3-8b at 32 rows and S 9; with a draft model, the draft's
    programs too (never above the target's here, so the same max)."""
    from kubernetes_gpu_cluster_tpu_torch.engine.step_programs import (
        activation_bytes, program_bytes)
    cfg = EngineConfig(model=get_model_config("llama-3-8b"),
                       scheduler=SchedulerConfig(max_num_seqs=32))
    off = program_bytes(cfg)
    sc = dataclasses.replace(cfg.scheduler, spec_decode_enabled=True,
                             num_speculative_tokens=8)
    spec = program_bytes(dataclasses.replace(cfg, scheduler=sc))
    T, R, V = max(sc.prefill_buckets), max(sc.decode_buckets), \
        cfg.model.vocab_size
    assert off == activation_bytes(cfg.model, T + R, R + 1,
                                   cfg.effective_max_len)
    assert spec - off >= R * 9 * 4 * V - (R + 1) * 4 * V
    assert R * 9 * 4 * V > 147 * 2 ** 20
    draft = get_model_config("tinyllama-1.1b")
    assert program_bytes(dataclasses.replace(cfg, scheduler=sc),
                         draft) == spec


def test_the_collector_is_paused_while_any_capture_is_open():
    from kubernetes_gpu_cluster_tpu_torch.engine.step_programs import \
        _collector_paused
    assert gc.isenabled()
    first, second = _collector_paused(), _collector_paused()
    first.__enter__()
    assert not gc.isenabled()
    second.__enter__()
    first.__exit__(None, None, None)
    assert not gc.isenabled()           # the second capture is still open
    second.__exit__(None, None, None)
    assert gc.isenabled()
    with pytest.raises(RuntimeError, match="capture failed"):
        with _collector_paused():
            assert not gc.isenabled()
            raise RuntimeError("capture failed")
    assert gc.isenabled()


@pytest.mark.parametrize("kernel", ["paged_decode", "flash_prefill",
                                    "flash_prefill_hist", "int4_matmul",
                                    "spec_verify"])
def test_note_launch_counts_in_the_wrappers_launches(kernel):
    """The one call at a wrapper's launch site counts the launch in that
    wrapper's ``launches`` and no other's."""
    import importlib

    from kubernetes_gpu_cluster_tpu_torch.ops import cuda as cuda_ops
    mods = {n: importlib.import_module(f"{cuda_ops.__name__}.{n}")
            for n in ("paged_decode", "flash_prefill", "flash_prefill_hist",
                      "int4_matmul", "spec_verify")}
    saved = {n: m.launches for n, m in mods.items()}
    try:
        for m in mods.values():
            m.launches = 5
        with cuda_ops.tally_launches() as tally:
            cuda_ops.note_launch(kernel)
            cuda_ops.note_launch(kernel)
        assert tally == {kernel: 2}
        assert {n: m.launches for n, m in mods.items()} == {
            n: 7 if n == kernel else 5 for n in mods}
        cuda_ops.note_launch(kernel)            # no tally open: global only
        assert mods[kernel].launches == 8
    finally:
        for n, m in mods.items():
            m.launches = saved[n]


def test_a_capture_tallies_only_its_own_threads_launches():
    """Engines of one process step in threads of their own: a capture's
    tally holds its thread's kernel launches only, whatever another thread
    launches (or captures) meanwhile, and taking it back leaves the other
    thread's counts whole. Each launch also counts in its wrapper's
    global ``launches``."""
    import threading

    from kubernetes_gpu_cluster_tpu_torch.ops import cuda as cuda_ops
    from kubernetes_gpu_cluster_tpu_torch.ops.cuda import paged_decode as pd
    from kubernetes_gpu_cluster_tpu_torch.ops.cuda import spec_verify as sv
    saved = pd.launches, sv.launches
    opened, done = threading.Event(), threading.Event()
    other = {}

    def engine_b():
        opened.wait()
        with cuda_ops.tally_launches() as tally:
            for _ in range(7):
                cuda_ops.note_launch("paged_decode")
        other.update(tally)
        done.set()
    try:
        pd.launches, sv.launches = 100, 0
        worker = threading.Thread(target=engine_b)
        worker.start()
        with cuda_ops.tally_launches() as recorded:
            cuda_ops.note_launch("paged_decode")
            opened.set()
            done.wait()
            with cuda_ops.tally_launches() as inner:   # nested: its own
                cuda_ops.note_launch("spec_verify")
            cuda_ops.note_launch("paged_decode")
        worker.join()
        assert recorded == {"paged_decode": 2} and inner == {"spec_verify": 1}
        assert other == {"paged_decode": 7}
        assert (pd.launches, sv.launches) == (100 + 2 + 7, 1)
        cuda_ops.add_launches({k: -n for k, n in recorded.items()})
        assert pd.launches == 100 + 7           # the other thread's stay
    finally:
        pd.launches, sv.launches = saved


@pytest.fixture
def host_scratch(monkeypatch):
    """A ``Scratch`` whose sets are host tensors, and a switch for
    whether the current stream is capturing (the CPU tests have no card)."""
    from kubernetes_gpu_cluster_tpu_torch.ops import cuda as cuda_ops
    monkeypatch.setattr(cuda_ops.Scratch, "_new", staticmethod(
        lambda dev, ws, n: (torch.empty(max(ws, 1)),
                            torch.zeros(max(n, 1), dtype=torch.int32))))
    capturing = {"on": False}
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: capturing["on"])
    return cuda_ops.Scratch(), capturing


def test_scratch_gives_each_stream_a_set_of_its_own(host_scratch):
    """Calls on one stream share a set, grown to the largest call; calls
    on two streams (an engine's capture warm-up on its side stream, other
    engines on the default one) never share one."""
    s, _ = host_scratch
    main = s.pointers(0, 0, 10, 4)
    assert s.pointers(0, 0, 8, 2) == main
    side = s.pointers(0, 0x7f01, 10, 4)
    assert not set(side) & set(main)
    grown = s.pointers(0, 0, 20, 2)
    assert grown != main
    ws, cnt = s._sets[(0, 0)]
    assert (ws.numel(), cnt.numel()) == (20, 4)       # the largest of each
    assert len(s._sets.retired) == 2                  # the outgrown pair lives
    assert s.pointers(1, 0, 10, 4) not in (main, grown)   # another device
    assert s.counters_in_use() == 0
    cnt[1] = 1
    assert s.counters_in_use() == 1


def test_scratch_gives_each_capture_a_set_of_its_own(host_scratch):
    """Inside ``capture_scratch`` every call of the capture takes the
    capture's one set, apart from its stream's and from any other
    capture's; the set is handed to the caller to keep with the graph.
    The context is this thread's only."""
    import threading

    from kubernetes_gpu_cluster_tpu_torch.ops import cuda as cuda_ops
    s, capturing = host_scratch
    eager = s.pointers(0, 0x7f01, 10, 4)
    capturing["on"] = True
    with cuda_ops.capture_scratch() as first:
        a = s.pointers(0, 0x7f01, 10, 4)
        assert s.pointers(0, 0x7f01, 6, 2) == a
        seen = {}
        t = threading.Thread(target=lambda: seen.update(
            p=s.pointers(0, 0x7f01, 10, 4)))
        t.start()
        t.join()
    with cuda_ops.capture_scratch() as second:
        b = s.pointers(0, 0x7f01, 10, 4)
    capturing["on"] = False
    assert seen["p"] == eager              # the other thread: its stream's
    assert len({eager, a, b}) == 3
    assert [tuple(t.data_ptr() for t in v) for v in first.values()] == [a]
    assert [tuple(t.data_ptr() for t in v) for v in second.values()] == [b]
    assert s.pointers(0, 0x7f01, 10, 4) == eager


def test_a_capture_without_its_context_makes_no_stream_set(host_scratch):
    """A capture outside ``capture_scratch`` uses its stream's set when
    that is made and large enough; else it takes a set of the call's own
    (zeroed only when the graph runs), and never leaves one behind as the
    stream's."""
    s, capturing = host_scratch
    capturing["on"] = True
    own = s.pointers(0, 5, 10, 4)
    assert (0, 5) not in s._sets and len(s._kept) == 2
    capturing["on"] = False
    stream = s.pointers(0, 5, 10, 4)
    assert stream != own
    capturing["on"] = True
    assert s.pointers(0, 5, 10, 4) == stream
    assert s.pointers(0, 5, 40, 4) not in (stream, own)
    assert s._sets[(0, 5)][0].numel() == 10 and len(s._kept) == 4


# -- the JAX programs' lax.cond stages, as gates ------------------------------

# The JAX engine's jitted step functions -> the port's program family.
_JAX_STEP_FAMILY = {"_prefill_fn": "prefill",
                    "_prefill_hist_fn": "prefill_hist", "_mixed_fn": "mixed",
                    "_spec_verify_fn": "spec", "_spec_mixed_fn": "spec_mixed",
                    "_decode_fn_greedy": "greedy", "_decode_fn": "sampled"}


def _jax_conditions(family: str, args: dict) -> dict:
    """The conditions of the JAX step function's ``lax.cond`` stages, by
    the JAX expressions themselves on the arguments it was called with
    (``int_b``'s top_k and top_n columns are the family's own)."""
    import jax.numpy as jnp
    ib, fb = jnp.asarray(args["int_b"]), jnp.asarray(args["float_b"])
    spec = family.startswith("spec")
    top_k = 0 if spec else 1
    top_n = 2 if spec else 3 if family in ("greedy", "sampled") else 4
    if family == "greedy":
        return {"any_top": bool(jnp.any(ib[:, top_n] > 0))}

    def rows(sl):
        return (jnp.any(fb[sl, 0] > 0),
                jnp.any((ib[sl, top_k] > 0) | (fb[sl, 1] < 1.0)),
                jnp.any((fb[sl, 2] != 0.0) | (fb[sl, 3] != 0.0)))
    R = args["page_tables"].shape[0] if family == "spec_mixed" else None
    out = dict(zip(("any_sampled", "needs_filter", "any_pen"),
                   rows(slice(R))),
               any_bias=jnp.any(jnp.asarray(args["bias_ids"]) >= 0),
               any_top=jnp.any(ib[:, top_n] > 0))
    if R is not None:
        out.update(zip(("chunk_sampled", "chunk_filter", "chunk_pen"),
                       rows(slice(R, None))))
    return {k: bool(v) for k, v in out.items()}


def _taken_per_step(family: str, key, flags: dict, window: int):
    """The gated stages an eager step of ``key`` runs, by stage: each
    stage as often as the step meets it (W substeps, S verify positions),
    where its flag holds."""
    import collections
    f = flags
    if family in ("greedy", "sampled"):
        n = dict(top_logprobs=f["any_top"])
        if family == "sampled":
            n.update(bias=f["any_bias"], penalties=f["any_pen"],
                     count_bump=f["any_pen"], sampled=f["any_sampled"],
                     filters=f["any_sampled"] and f["needs_filter"])
        return collections.Counter(
            {k: window * v for k, v in n.items() if v})
    if family in ("prefill", "prefill_hist", "mixed"):
        n = dict(bias=f["any_bias"], penalties=f["any_pen"],
                 sampled=f["any_sampled"],
                 filters=f["any_sampled"] and f["needs_filter"],
                 top_logprobs=f["any_top"])
        return collections.Counter({k: v for k, v in n.items() if v})
    S = key[-1]
    n = collections.Counter({k: v for k, v in dict(
        bias=f["any_bias"], counts=2 * f["any_pen"],
        penalties=S * f["any_pen"], count_bump=(S - 1) * f["any_pen"],
        filters=S * f["needs_filter"], sampled=S * f["any_sampled"],
        top_logprobs=S * f["any_top"]).items() if v})
    if family == "spec_mixed":           # the chunk row's one draw
        n.update({k: 1 for k, v in dict(
            penalties=f["chunk_pen"], sampled=f["chunk_sampled"],
            filters=f["chunk_sampled"] and f["chunk_filter"],
            top_logprobs=f["any_top"]).items() if v})
    return n


def _recorded_pair(spec: bool):
    """A JAX engine whose step functions record the batches they are
    called with, and the port (programs on the CPU) on its weights, whose
    program cache records each step's uploaded flags and the gated stages
    it ran eagerly."""
    import collections
    import inspect

    import jax
    from kubernetes_gpu_cluster_tpu.config import (
        CacheConfig as JCache, EngineConfig as JConfig,
        SchedulerConfig as JSched, get_model_config as jax_model)
    from kubernetes_gpu_cluster_tpu.engine import LLMEngine as JaxEngine
    from kubernetes_gpu_cluster_tpu.models import llama as JM
    from kubernetes_gpu_cluster_tpu_torch.engine.engine import STEP_FLAGS

    def sched(cls):
        kw = dict(max_num_seqs=4, max_prefill_tokens=32,
                  decode_buckets=(1, 2, 4), prefill_buckets=(16, 32),
                  decode_window=2)
        if spec:        # an oracle draft: spec×mixed steps fire for sure
            kw.update(mixed_batch_enabled=True, spec_decode_enabled=True,
                      num_speculative_tokens=3,
                      spec_draft_model="debug-tiny")
        return cls(**kw)
    jcfg = JConfig(model=jax_model("debug-tiny"),
                   cache=JCache(page_size=8, num_pages=160),
                   scheduler=sched(JSched))
    cfg = EngineConfig(model=get_model_config("debug-tiny"),
                       cache=CacheConfig(page_size=8, num_pages=160),
                       scheduler=sched(SchedulerConfig))
    calls, steps = [], []
    jparams = JM.init_params(jax_model("debug-tiny"),
                             jax.random.key(jcfg.seed))
    jax_eng = JaxEngine(jcfg, params=jparams,
                        **({"draft_params": jparams} if spec else {}))
    for attr, family in _JAX_STEP_FAMILY.items():
        fn = getattr(jax_eng, attr, None)
        if fn is None:
            continue

        def call(*args, _fn=fn, _family=family,
                 _sig=inspect.signature(fn), **kw):
            bound = _sig.bind(*args, **kw).arguments
            calls.append((_family, {
                k: np.asarray(v) for k, v in bound.items()
                if k in ("int_b", "float_b", "bias_ids", "page_tables")}))
            return _fn(*args, **kw)
        setattr(jax_eng, attr, call)
    tparams = model_lib.params_from_numpy(
        jax.tree.map(np.asarray, jparams), cfg.model, "cpu")
    port = LLMEngine(cfg, params=tparams, device="cpu",
                     **({"draft_params": tparams} if spec else {}))
    progs = port._programs
    plain_run = progs.run
    live = {"taken": collections.Counter()}   # the wave's stage counts

    def run(key):
        before = collections.Counter(live["taken"])
        plain_run(key)
        flags = progs.buffers(key).host.get("flags")
        if flags is not None:           # not the draft's or KV programs
            steps.append((key, dict(zip(STEP_FLAGS, map(bool, flags))),
                          live["taken"] - before))
    progs.run = run
    return {"jax": jax_eng, "port": port, "calls": calls, "steps": steps,
            "live": live, "window": cfg.scheduler.decode_window}


@pytest.fixture(scope="module")
def recorded():
    return _recorded_pair(spec=False)


@pytest.fixture(scope="module")
def recorded_spec():
    return _recorded_pair(spec=True)


# Batch kinds: each row's sampling parameters (cycled over the wave's
# requests).
_GATE_BATCHES = {
    "all_greedy": [dict(temperature=0.0)],
    "greedy_top_logprobs": [dict(temperature=0.0, logprobs=True,
                                 top_logprobs=2)],
    "sampled_no_filter": [dict(temperature=0.8, seed=3)],
    "top_k_50": [dict(temperature=0.8, top_k=50, seed=4)],
    "top_p_095": [dict(temperature=0.8, top_p=0.95, seed=5)],
    "top_k_past_the_cap": [dict(temperature=0.8, top_k=200, seed=6)],
    "penalties": [dict(temperature=0.0, presence_penalty=0.5,
                       frequency_penalty=0.2)],
    "bias": [dict(temperature=0.0, logit_bias={5: 2.0})],
    "mixed_rows": [dict(temperature=0.0),
                   dict(temperature=0.7, top_k=20, seed=7),
                   dict(temperature=0.0, presence_penalty=0.4,
                        logit_bias={9: -1.0}),
                   dict(temperature=0.0, logprobs=True, top_logprobs=1)],
}


def _gate_wave(eng, sp, tag: str, rows: list, lengths: list,
               pattern=None, max_tokens: int = 5) -> None:
    """Requests of ``rows`` arriving one per step (the long ones chunk
    beside decoding rows), then drained; no stop on EOS, so that both
    engines take the same steps whatever they sample. Prompts are random,
    or the first tokens of ``pattern``."""
    rng = np.random.default_rng(len(lengths))
    pending = [(f"{tag}-{i}", pattern[:n] if pattern else
                rng.integers(1, 500, n).tolist(),
                sp(max_tokens=max_tokens, ignore_eos=True,
                   **rows[i % len(rows)]))
               for i, n in enumerate(lengths)]
    while pending or eng.has_unfinished_requests():
        if pending:
            eng.add_request(*pending.pop(0))
        eng.step()


def _held_to_jax(pair: dict, runs) -> list:
    """Run the same wave on both engines; the port's flags of every step
    equal the JAX step's conditions, and each eager step ran exactly the
    gated stages whose condition holds. Returns the steps' flags."""
    from kubernetes_gpu_cluster_tpu.engine import SamplingParams as JSP
    from test_torch_sampling import counting_stages
    del pair["calls"][:], pair["steps"][:]
    runs(pair["jax"], JSP)
    with counting_stages() as taken:
        pair["live"]["taken"] = taken
        runs(pair["port"], SP)
    got = [(key[0], flags) for key, flags, _ in pair["steps"]]
    want = [(family, _jax_conditions(family, args))
            for family, args in pair["calls"]]
    assert [f for f, _ in got] == [f for f, _ in want]
    for (family, flags), (_, cond) in zip(got, want):
        assert {k: flags[k] for k in cond} == cond, family
    for key, flags, taken in pair["steps"]:
        assert taken == _taken_per_step(key[0], key, flags,
                                        pair["window"]), (key, flags)
    return [flags for _, flags in got]


@pytest.mark.parametrize("kind", sorted(_GATE_BATCHES))
def test_step_flags_are_the_jax_conditions(recorded, kind):
    """A wave of ``kind``'s rows (a prefill, decode windows, a long prompt
    chunked beside decoding rows, a lone prompt's solo chunks) through the
    JAX engine and the port on one weight set: every step's uploaded flags
    equal what the JAX step function's ``lax.cond``s compute on the batch
    the JAX engine built, and each eager stage ran where, and as often as,
    that condition holds."""
    rows = _GATE_BATCHES[kind]

    def runs(eng, sp):
        _gate_wave(eng, sp, kind, rows, [6, 45, 9, 12])
        _gate_wave(eng, sp, kind + "-solo", rows, [70])
    flags = _held_to_jax(recorded, runs)
    families = {key[0] for key, _, _ in recorded["steps"]}
    assert {"prefill", "prefill_hist", "mixed"} <= families, families
    for name, on in (("any_top", "top_logprobs" in str(rows)),
                     ("any_pen", "penalty" in str(rows)),
                     ("any_bias", "logit_bias" in str(rows)),
                     ("any_sampled", "seed" in str(rows))):
        assert any(f[name] for f in flags) == on, name


def test_spec_step_flags_are_the_jax_conditions(recorded_spec):
    """The compile guard's spec×mixed wave (an oracle draft keeps verify
    rows live while a long prompt chunks beside them) with greedy rows
    asking for alternatives, penalties (the chunk row's alone) and bias:
    the spec and spec×mixed steps' flags (the chunk row's apart) equal the
    JAX verify programs' conditions, and each eager verify step ran its
    gated stages at every position where they hold."""
    def runs(eng, sp):
        rng = np.random.default_rng(2)
        pattern = rng.integers(1, 500, 4).tolist()
        eng.add_request("s0", pattern * 5, sp(max_tokens=30, temperature=0.0,
                                              ignore_eos=True))
        for _ in range(3):
            eng.step()
        eng.add_request("s1", pattern * 3, sp(
            max_tokens=30, temperature=0.0, ignore_eos=True, logprobs=True,
            top_logprobs=2))
        for _ in range(2):
            eng.step()
        eng.add_request("long", pattern * 12, sp(
            max_tokens=6, temperature=0.0, ignore_eos=True,
            presence_penalty=0.5, frequency_penalty=0.3))
        eng.add_request("p", rng.integers(1, 500, 12).tolist(), sp(
            max_tokens=6, temperature=0.0, ignore_eos=True,
            logit_bias={7: 1.0}))
        while eng.has_unfinished_requests():
            eng.step()
    flags = _held_to_jax(recorded_spec, runs)
    families = [key[0] for key, _, _ in recorded_spec["steps"]]
    assert "spec" in families and "spec_mixed" in families, families
    assert any(f["any_pen"] for f in flags)
    assert any(f["chunk_pen"] != f["any_pen"] for f, (key, _, _) in
               zip(flags, recorded_spec["steps"]) if key[0] == "spec_mixed")


def test_skipped_alternatives_are_zero_filled(engines):
    """A program that ran a row asking for alternatives, then steps whose
    rows ask for none: its top ids and logprobs are the zeros the JAX
    false branch returns, not the earlier step's."""
    eng = engines["graph"]
    rng = np.random.default_rng(12)
    prompt = rng.integers(1, 500, 10).tolist()
    eng.generate([prompt], [SP(max_tokens=4, temperature=0.0, logprobs=True,
                               top_logprobs=3)])
    keys = [k for k in eng._programs.keys() if k[0] in ("prefill", "greedy")]
    assert any(eng._programs.buffers(k)["out_tid"].any() for k in keys)
    eng.generate([prompt], [SP(max_tokens=4, temperature=0.0)])
    for k in keys:
        bufs = eng._programs.buffers(k)
        assert not bufs["out_tid"].any() and not bufs["out_tlp"].any(), k
