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
