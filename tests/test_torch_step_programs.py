"""The prefill, solo-chunk and mixed step programs (``engine/
step_programs.py``) against ``enforce_eager`` on the CPU.

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
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from kubernetes_gpu_cluster_tpu_torch.config import (CacheConfig,
                                                     EngineConfig,
                                                     SchedulerConfig,
                                                     get_model_config)
from kubernetes_gpu_cluster_tpu_torch.engine import LLMEngine, SamplingParams

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
