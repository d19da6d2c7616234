"""The JAX package's compile guard, carried to the port's step programs,
and the programs themselves, on the CPU.

``tests/test_compile_guard.py`` is loaded with its imports re-pointed at
the port (``torch_carry``) and its engines built on the CPU, where the
program cache keys the same programs around the eager bodies that the
card captures (``engine/step_programs.py``): the decode window per
(greedy|sampled, decode bucket), the pure prefill, solo chunk and mixed
step per key of the JAX bucket grid. Exact substitutions (each must still
match, or the load fails):

- ``_compiled_variants`` cross-checks the engine's count against the
  program cache's own keys (the JAX guard reads one raw jit cache);
- every term of the bounds (pure prefill, mixed, solo chunk, decode, the
  swap gather and scatter, spec verify, spec×mixed, the draft model's
  decode and chunked prefill) stands as the JAX guard wrote it;
- the engines take the JAX engine's default weights (its seed, through
  ``params_from_numpy``), so each wave steps as the reference's does.

Then the programs: per family the port's keys against the JAX jit
caches on the guard's wave (equal on the greedy wave, no more on a
sampled, penalized and biased one, none new on a repeat), on its spec
and spec×mixed/draft waves (the verify, spec×mixed and both draft
families equal, none new on a repeat) and on its swap wave and a
handoff's export and import (the KV gather and scatter families equal,
none new on a repeat); a padded scatter against the JAX scatter, keys per
(variant, bucket) within two per bucket, ``enforce_eager`` building none
with the same tokens, the device-side filter-tier choice and the tensor
step key against the host-branch functions they replace, and the sampled
program's rows against the JAX engine.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from kubernetes_gpu_cluster_tpu.config import (CacheConfig as JCache,
                                               EngineConfig as JEngineConfig,
                                               SchedulerConfig as JSched,
                                               get_model_config as jax_model)
from kubernetes_gpu_cluster_tpu.engine import LLMEngine as JaxEngine
from kubernetes_gpu_cluster_tpu.engine import SamplingParams as JSP
from kubernetes_gpu_cluster_tpu.engine import kv_cache as JKV
from kubernetes_gpu_cluster_tpu.models import llama as JM
from kubernetes_gpu_cluster_tpu_torch.config import (CacheConfig,
                                                     EngineConfig,
                                                     SchedulerConfig,
                                                     get_model_config)
from kubernetes_gpu_cluster_tpu_torch.engine import LLMEngine, SamplingParams
from kubernetes_gpu_cluster_tpu_torch.engine import kv_cache as TKV
from kubernetes_gpu_cluster_tpu_torch.engine.step_programs import (
    StaticBuffers, StepPrograms)
from kubernetes_gpu_cluster_tpu_torch.models import llama as TM
from kubernetes_gpu_cluster_tpu_torch.ops import sampling as TS
from torch_carry import carry, expose

torch.set_num_threads(2)

_FIXES = [
    ("    if hasattr(eng._prefill_fn, \"_cache_size\"):\n"
     "        assert total >= eng._prefill_fn._cache_size()\n",
     "    assert total == len(eng._programs.keys())\n"),
    ("model_lib.init_params(cfg.model, jax.random.key(0))",
     "_jax_weights(cfg.model, 0)"),
]


def _jax_weights(cfg, seed: int):
    """The weights the JAX engine draws from ``seed`` (its default), on the
    port: the carried waves then take the reference's steps (n-gram drafts
    hit where the JAX engine's do)."""
    jparams = JM.init_params(jax_model(cfg.name), jax.random.key(seed))
    return TM.params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                                "cpu")


def _cpu_engine(config, params=None, **kw):
    if params is None:
        params = _jax_weights(config.model, config.seed)
    return LLMEngine(config, params=params, device="cpu", **kw)


def _carry_guard():
    mod = carry("test_compile_guard", _FIXES, _jax_weights=_jax_weights)
    mod.LLMEngine = _cpu_engine
    return mod


_GUARD = _carry_guard()
expose("test_compile_guard", _GUARD, None, globals())


# -- per family against the JAX jit caches -------------------------------------

# The port's program family -> the JAX engine's jitted step function (None
# there when the engine's configuration has no such step).
_JAX_FNS = {"prefill": "_prefill_fn", "prefill_hist": "_prefill_hist_fn",
            "mixed": "_mixed_fn", "greedy": "_decode_fn_greedy",
            "sampled": "_decode_fn", "spec": "_spec_verify_fn",
            "spec_mixed": "_spec_mixed_fn"}
# The draft runner's families -> the JAX draft runner's jitted functions.
_JAX_DRAFT_FNS = {"draft_decode": "_decode_fn",
                  "draft_prefill": "_prefill_fn"}
# The KV transfer families -> the JAX engine's shared gather/scatter pair.
_JAX_KV_FNS = {"kv_gather": "_gather_fn", "kv_scatter": "_scatter_fn"}


def _families(eng) -> dict:
    if isinstance(eng, LLMEngine):
        return {f: len(eng._programs.keys(f))
                for f in (*_JAX_FNS, *_JAX_DRAFT_FNS, *_JAX_KV_FNS)}
    draft = eng.scheduler.spec_proposer
    fns = {**{f: getattr(eng, fn) for f, fn in _JAX_FNS.items()},
           **{f: getattr(draft, fn, None)
              for f, fn in _JAX_DRAFT_FNS.items()},
           **{f: getattr(eng._kv_programs, fn)
              for f, fn in _JAX_KV_FNS.items()}}
    return {f: 0 if fn is None else fn._cache_size()
            for f, fn in fns.items()}


def _sampled_wave(eng, tag: str, sp) -> None:
    """The guard's wave (``_run_wave``: the same lengths and arrivals) with
    a sampled, penalized, biased or alternatives-asking row per request."""
    rng = np.random.default_rng(0)
    lengths = [5, 16, 33, 60, 90, 12]
    rows = [dict(temperature=0.8, seed=7),
            dict(temperature=0.0, presence_penalty=0.5,
                 frequency_penalty=0.3),
            dict(temperature=0.7, top_k=5, top_p=0.9, logit_bias={3: 2.0}),
            dict(temperature=1.0, logprobs=True, top_logprobs=2),
            dict(temperature=0.0, logit_bias={11: -3.0}),
            dict(temperature=0.9, seed=2, frequency_penalty=0.4)]
    pending = [(f"{tag}-{i}", rng.integers(1, 500, n).tolist(),
                sp(max_tokens=4, **rows[i]))
               for i, n in enumerate(lengths)]
    while pending or eng.has_unfinished_requests():
        if pending:
            eng.add_request(*pending.pop(0))
        for _ in range(2):
            if eng.has_unfinished_requests():
                eng.step()
    while eng.has_unfinished_requests():
        eng.step()


def _solo_wave(eng, tag: str, sp) -> None:
    """One 70-token prompt on an idle engine: solo chunks of 32, 32 and 6
    tokens over 4-, 8- and 16-page tables (the guard's wave mixes every
    chunk)."""
    prompt = np.random.default_rng(1).integers(1, 500, 70).tolist()
    eng.add_request(f"{tag}-solo", prompt, sp(max_tokens=3,
                                              temperature=0.0))
    while eng.has_unfinished_requests():
        eng.step()


def test_families_match_the_jax_jit_caches():
    """The guard's greedy wave, and a lone long prompt's solo chunks,
    through the JAX engine and the port on one weight set: per family, the
    port's programs equal the JAX function's ``_cache_size()``; a sampled,
    penalized and biased wave adds no more programs to the port than to
    JAX (one program per key, where the JAX decode window splits greedy
    from sampled); a repeated wave adds none to either."""
    import test_compile_guard as jguard
    engines = {"jax": jguard._engine(), "port": _GUARD._engine()}
    for name, sp in (("jax", JSP), ("port", SamplingParams)):
        jguard._run_wave(engines[name], "w1")
        _solo_wave(engines[name], "w1", sp)
    counts = {k: _families(e) for k, e in engines.items()}
    assert counts["port"] == counts["jax"], counts
    assert all(counts["port"][f] > 0 for f in ("prefill", "prefill_hist",
                                                "mixed", "greedy"))
    for name, sp in (("jax", JSP), ("port", SamplingParams)):
        jguard._run_wave(engines[name], "w2")
        _solo_wave(engines[name], "w2", sp)
    assert {k: _families(e) for k, e in engines.items()} == counts
    for name, sp in (("jax", JSP), ("port", SamplingParams)):
        _sampled_wave(engines[name], "s1", sp)
    grown = {k: _families(e) for k, e in engines.items()}
    for f in _JAX_FNS:
        assert (grown["port"][f] - counts["port"][f]
                <= grown["jax"][f] - counts["jax"][f]), (f, counts, grown)
    assert grown["port"]["sampled"] > 0
    _sampled_wave(engines["port"], "s2", SamplingParams)
    assert _families(engines["port"]) == grown["port"]


# The guard's spec waves: (engine builder, wave) of ``test_compile_guard``,
# and the families each must build.
_SPEC_WAVES = {
    "spec": ("_spec_engine", "_run_spec_wave", ("spec",)),
    "spec_mixed_draft": ("_spec_draft_engine", "_run_spec_mixed_wave",
                         ("spec", "spec_mixed", "draft_decode",
                          "draft_prefill")),
}


@pytest.mark.parametrize("wave", sorted(_SPEC_WAVES))
def test_spec_families_match_the_jax_jit_caches(wave):
    """The guard's spec wave (n-gram drafts, k 3) and its spec×mixed wave
    (an oracle draft model, mixing on) through the JAX engine and the
    port on one weight set: per family, the verify, spec×mixed and both
    draft programs (and every other family) equal the JAX functions'
    ``_cache_size()``; a repeated wave builds none on either."""
    import test_compile_guard as jguard
    make, run, built = _SPEC_WAVES[wave]
    mods = {"jax": jguard, "port": _GUARD}
    engines = {k: getattr(m, make)() for k, m in mods.items()}
    for k, m in mods.items():
        getattr(m, run)(engines[k], "w1")
    counts = {k: _families(e) for k, e in engines.items()}
    assert counts["port"] == counts["jax"], counts
    assert all(counts["port"][f] > 0 for f in built), counts
    for k, m in mods.items():
        getattr(m, run)(engines[k], "w2")
    assert {k: _families(e) for k, e in engines.items()} == counts


def _kv_families(eng) -> dict:
    return {f: n for f, n in _families(eng).items() if f in _JAX_KV_FNS}


def test_kv_transfer_families_match_the_jax_jit_caches_on_the_swap_wave():
    """The guard's swap wave (a 13-page pool with a host tier: swap
    preemptions and restores) through the JAX engine and the port on one
    weight set: the port's ``kv_gather`` and ``kv_scatter`` programs equal
    the JAX gather and scatter ``_cache_size()`` (and every other family
    its jit cache); a repeated wave builds none on either."""
    import test_compile_guard as jguard
    mods = {"jax": jguard, "port": _GUARD}
    engines = {k: m._swap_engine() for k, m in mods.items()}
    for k, m in mods.items():
        m._run_swap_wave(engines[k], "w1")
    counts = {k: _families(e) for k, e in engines.items()}
    assert counts["port"] == counts["jax"], counts
    assert all(counts["port"][f] > 0 for f in _JAX_KV_FNS), counts
    assert (engines["port"].scheduler.num_preemptions_by_kind
            == engines["jax"].scheduler.num_preemptions_by_kind)
    for k, m in mods.items():
        m._run_swap_wave(engines[k], "w2")
    assert {k: _families(e) for k, e in engines.items()} == counts


def _handoffs(pre, dec, sp, tag: str) -> list:
    """Prompts of 1, 3, 5 and 9 committed pages, each prefilled on ``pre``
    with ``hold_kv``, exported and imported into ``dec``, then decoded
    there; the tokens each import produced."""
    rng = np.random.default_rng(4)
    toks = []
    for i, n in enumerate((6, 20, 40, 70)):
        prompt = rng.integers(1, 500, n).tolist()
        pre.add_request(f"{tag}-pf-{i}", prompt,
                        sp(max_tokens=1, temperature=0.0), hold_kv=True)
        while pre.has_unfinished_requests():
            pre.step()
        state = pre.export_held(f"{tag}-pf-{i}")
        outs = dec.import_request(f"{tag}-dc-{i}", prompt,
                                  sp(max_tokens=5, temperature=0.0), state)
        got = list(outs[0].output_token_ids)
        while dec.has_unfinished_requests():
            for o in dec.step():
                if o.request_id == f"{tag}-dc-{i}":
                    got = list(o.output_token_ids)
        toks.append(got)
    return toks


def test_kv_transfer_families_match_the_jax_jit_caches_on_handoffs():
    """A prefill and a decode engine of each package on one weight set
    hand four requests over (``export_held`` -> ``import_request``): the
    exporter's ``kv_gather`` and the importer's ``kv_scatter`` programs
    equal the JAX engines' gather and scatter ``_cache_size()``, the
    imported requests decode the JAX tokens, and handing the same
    requests over again builds none."""
    import test_compile_guard as jguard
    mods = {"jax": (jguard, JSP), "port": (_GUARD, SamplingParams)}
    pairs = {k: (m._engine(), m._engine()) for k, (m, _) in mods.items()}
    toks = {k: _handoffs(*pairs[k], sp, "h1")
            for k, (_, sp) in mods.items()}
    assert toks["port"] == toks["jax"]
    counts = {k: [_kv_families(e) for e in pair]
              for k, pair in pairs.items()}
    assert counts["port"] == counts["jax"], counts
    pre, dec = counts["port"]
    assert pre["kv_gather"] == 4 and dec["kv_scatter"] == 4, counts
    for k, (_, sp) in mods.items():
        _handoffs(*pairs[k], sp, "h2")
    assert {k: [_kv_families(e) for e in pair]
            for k, pair in pairs.items()} == counts


def test_padded_scatter_zeroes_the_scrap_page_as_the_jax_scatter():
    """Five pages scatter as a key of eight: the three padded rows write
    zeros into ``SCRAP_PAGE`` (whatever it held), as the JAX scatter's
    zero ``k_data`` rows do, and every page equals the JAX pool's bit for
    bit; the gather of the same pages equals the JAX gather."""
    L, P, ps, kd = 2, 16, 8, 32
    rng = np.random.default_rng(9)
    k, v = (rng.standard_normal((L, P, ps, kd)).astype(np.float32)
            for _ in range(2))
    hk, hv = (rng.standard_normal((L, 5, ps, kd)).astype(np.float32)
              for _ in range(2))
    pages = [3, 12, 4, 9, 15]
    jprog = JKV.KVTransferPrograms()
    jkv = jprog.scatter_pages(JKV.KVCache(k=jax.numpy.asarray(k),
                                          v=jax.numpy.asarray(v)),
                              pages, hk, hv)
    tkv = TKV.KVCache(k=torch.from_numpy(k.copy()),
                      v=torch.from_numpy(v.copy()))
    tprog = TKV.KVTransferPrograms(
        "cpu", StepPrograms({}, None, torch.device("cpu"), enabled=True), 8)
    tprog.scatter_pages(tkv, pages, torch.from_numpy(hk),
                        torch.from_numpy(hv))
    assert tprog.programs.keys() == [("kv_scatter", 8)]
    for got, want in zip(tkv, jkv):
        assert not got[:, TKV.SCRAP_PAGE].any()
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for got, want in zip(tprog.gather_pages(tkv, pages),
                         jprog.gather_pages(jkv, pages)):
        np.testing.assert_array_equal(got.numpy(), want)
    assert tprog.programs.keys() == [("kv_gather", 8), ("kv_scatter", 8)]


def test_transfer_staging_sized_once_with_programs_grown_without():
    """With programs the staging holds the largest bucket from the first
    transfer on (a captured program keeps its address); with programs
    disabled it grows to the largest bucket moved. Both give the same
    buffers and pools, and only the first builds keys."""
    L, P, ps, kd, top = 2, 40, 4, 8, 32
    rng = np.random.default_rng(10)
    k, v = (torch.from_numpy(rng.standard_normal((L, P, ps, kd))
                             .astype(np.float32)) for _ in range(2))
    pools = [TKV.KVCache(k.clone(), v.clone()) for _ in range(2)]
    progs = [TKV.KVTransferPrograms("cpu", StepPrograms(
        {}, None, torch.device("cpu"), enabled=on), top)
        for on in (True, False)]
    for pages, dst in (([5, 6, 7], [30, 2, 9]),
                       (list(range(1, 10)), list(range(20, 29))),
                       ([11, 3], [12, 13])):
        got = [p.gather_pages(kv, pages) for p, kv in zip(progs, pools)]
        for a, b, pool in zip(*got, pools[0]):
            assert torch.equal(a, b)
            assert torch.equal(a, pool[:, pages])
        for p, kv in zip(progs, pools):
            p.scatter_pages(kv, dst, *got[0])
        assert all(torch.equal(a, b) for a, b in zip(*pools))
    assert [len(p._staging[0]) for p in progs] == [L * top, L * 16]
    assert progs[0].programs.keys() == [
        (f, n) for f in ("kv_gather", "kv_scatter") for n in (2, 4, 16)]
    assert progs[1].programs.keys() == []


# -- the programs -------------------------------------------------------------

BUCKETS = (1, 2, 4)


def _engine(**kw):
    cfg = EngineConfig(
        model=get_model_config("debug-tiny"),
        cache=CacheConfig(page_size=8, num_pages=160),
        scheduler=SchedulerConfig(max_num_seqs=4, max_prefill_tokens=64,
                                  decode_buckets=BUCKETS,
                                  prefill_buckets=(32, 64), decode_window=3),
        **kw)
    return LLMEngine(cfg, device="cpu")


_PARAMS = [
    SamplingParams(max_tokens=9, temperature=0.0),
    SamplingParams(max_tokens=9, temperature=0.9, seed=3),
    SamplingParams(max_tokens=9, temperature=0.0, presence_penalty=0.4,
                   frequency_penalty=0.2, logprobs=True, top_logprobs=2),
    SamplingParams(max_tokens=9, temperature=0.7, top_k=7, top_p=0.8,
                   seed=5, logit_bias={3: 2.0}),
]


def _waves(eng):
    """Greedy alone, greedy pairs, then every variant at 1, 2 and 4 rows."""
    rng = np.random.default_rng(11)
    outs = []
    for group in ([0], [0, 0], [1], [2, 3], [0, 1, 2, 3]):
        prompts = [rng.integers(1, 500, int(rng.integers(4, 30))).tolist()
                   for _ in group]
        outs += [o.output_token_ids for o in
                 eng.generate(prompts, [_PARAMS[i] for i in group])]
    return outs


def test_program_keys_per_variant_and_bucket_bounded():
    eng = _engine()
    outs = _waves(eng)
    keys = eng._programs.keys("greedy") + eng._programs.keys("sampled")
    assert keys and set(keys) <= {(v, b) for v in ("greedy", "sampled")
                                  for b in BUCKETS}
    assert {v for v, _ in keys} == {"greedy", "sampled"}
    assert len(keys) <= 2 * len(BUCKETS)
    assert eng.compiled_step_variants() == len(eng._programs.keys())
    # Steady state: the same waves again build nothing new.
    built = eng._programs.keys()
    assert _waves(eng) == outs
    assert eng._programs.keys() == built


def test_enforce_eager_builds_no_programs_same_tokens():
    eager = _engine(enforce_eager=True)
    outs = _waves(eager)
    assert eager.compiled_step_variants() == 0
    assert eager._programs.keys() == []
    assert outs == _waves(_engine())


def test_program_cache_counts_keys_only_when_enabled():
    calls = []

    def layout(key):
        return {"x": ((2,), torch.int32)}, {"y": ((2,), torch.int32)}

    def body(key, bufs):
        calls.append(key)
        bufs["y"].copy_(bufs["x"] * 2)

    for enabled, count in ((True, 2), (False, 0)):
        progs = StepPrograms({"a": body, "b": body}, layout,
                             torch.device("cpu"), enabled)
        for key in (("a", 1), ("b", 1), ("a", 1)):
            progs.buffers(key).upload({"x": np.array([1, 2])})
            progs.run(key)
        assert len(progs) == count
        assert progs.keys("a") == ([("a", 1)] if enabled else [])
        assert progs.buffers(("a", 1))["y"].tolist() == [2, 4]
        assert not progs.captures
    assert calls == [("a", 1), ("b", 1), ("a", 1)] * 2


def test_static_buffers_upload_checks_shapes():
    bufs = StaticBuffers(torch.device("cpu"),
                         {"a": ((2, 3), torch.int32), "b": ((2,), torch.int32),
                          "c": ((2,), torch.float32)}, {})
    bufs.upload({"a": np.arange(6).reshape(2, 3), "b": np.array([7, 8]),
                 "c": np.array([0.5, 1.5], np.float32)})
    assert bufs["a"].tolist() == [[0, 1, 2], [3, 4, 5]]
    assert bufs["b"].tolist() == [7, 8] and bufs["c"].tolist() == [0.5, 1.5]
    with pytest.raises(ValueError, match="static input a"):
        bufs.upload({"a": np.zeros((3, 2)), "b": np.zeros(2),
                     "c": np.zeros(2)})


# -- the device-side decisions against the host branches they replace ---------

def _host_branch_filters(scaled, top_k, top_p):
    """``ops/sampling.py::_apply_filters`` as it was before the decode
    window was captured: the tier chosen on the host by ``bool(ok)``."""
    V = scaled.shape[-1]
    k = torch.clamp(torch.where(top_k <= 0, torch.full_like(top_k, V), top_k),
                    1, V)
    neg_inf = float("-inf")

    def full_sort(s):
        sorted_logits = torch.sort(s, dim=-1, descending=True).values
        pos = torch.arange(V)[None, :]
        lse = torch.logsumexp(torch.where(pos < k[:, None], sorted_logits,
                                          torch.full_like(sorted_logits,
                                                          neg_inf)), dim=-1)
        k_t, p_t, _ = TS._filter_thresholds_sorted(sorted_logits, k, top_p,
                                                   lse)
        return torch.maximum(k_t, p_t)

    def cut(s, thresh):
        return torch.where(s < thresh, torch.full_like(s, neg_inf), s)

    if V <= TS.TOP_K_CAP:
        return cut(scaled, full_sort(scaled)), "full"

    def window_thresholds(s, W):
        top_vals = torch.topk(s, W, dim=-1).values
        k_in = k <= W
        pos = torch.arange(W)[None, :]
        lse_win = torch.logsumexp(torch.where(pos < k[:, None], top_vals,
                                              torch.full_like(top_vals,
                                                              neg_inf)),
                                  dim=-1)
        lse = torch.where(k_in, lse_win, torch.logsumexp(s, dim=-1))
        k_t, p_t, covered = TS._filter_thresholds_sorted(top_vals, k, top_p,
                                                         lse)
        ok = torch.all((k_in | (k >= V))
                       & ((top_p >= 1.0) | (covered >= top_p)))
        return torch.maximum(k_t, p_t), bool(ok)

    thresh, ok = window_thresholds(scaled, TS.TOP_K_CAP)
    if ok:
        return cut(scaled, thresh), "narrow"
    if V > TS.TOP_K_CAP_WIDE:
        thresh, ok = window_thresholds(scaled, TS.TOP_K_CAP_WIDE)
        if ok:
            return cut(scaled, thresh), "wide"
    return cut(scaled, full_sort(scaled)), "full"


# Rows by the tier they need at V 4096 on peaked logits, plus flat rows.
_ROWS = {
    "narrow": [(0, 1.0), (40, 1.0), (0, 0.5), (100, 0.9)],
    "wide": [(1500, 1.0), (0, 0.97), (700, 0.99)],
    "full": [(3000, 1.0), (0, 0.9999)],
}


@pytest.mark.parametrize("tiers,flat", [
    (("narrow",), False), (("narrow", "wide"), False),
    (("narrow", "wide", "full"), False), (("wide",), False),
    (("narrow",), True), (("full",), True)])
def test_filter_tier_chosen_on_device_equals_host_branch(tiers, flat):
    rng = np.random.default_rng(len(tiers) + 10 * flat)
    rows = [r for t in tiers for r in _ROWS[t]]
    V = 4096
    scale = 0.01 if flat else 3.0
    scaled = torch.from_numpy(
        (rng.standard_normal((len(rows), V)) * scale).astype(np.float32))
    top_k = torch.tensor([k for k, _ in rows], dtype=torch.int32)
    top_p = torch.tensor([p for _, p in rows], dtype=torch.float32)
    want, tier = _host_branch_filters(scaled, top_k, top_p)
    if not flat:
        assert tier == tiers[-1]            # the batch takes its widest row
    got = TS._apply_filters(scaled, top_k, top_p)
    assert torch.equal(got, want)


def test_step_key_tensor_equals_int_key():
    seed = torch.tensor([3, -1, 5, -1, -1], dtype=torch.int32)
    pos = torch.tensor([0, 7, 2**20, 31, 2**31 - 1], dtype=torch.int32)
    for key in (0, 1, 12345, 2**31 - 2):
        want = TS.row_sample_keys(key, seed, pos)
        got = TS.row_sample_keys(torch.tensor([key], dtype=torch.int32),
                                 seed, pos)
        assert torch.equal(got, want)
    a = TS.row_sample_keys(torch.tensor([1], dtype=torch.int32), seed, pos)
    b = TS.row_sample_keys(torch.tensor([2], dtype=torch.int32), seed, pos)
    assert torch.equal(a[seed >= 0], b[seed >= 0])
    assert not torch.equal(a[seed < 0], b[seed < 0])


# -- the sampled program against the JAX engine -------------------------------

def test_sampled_program_greedy_rows_match_jax_engine():
    """Greedy rows with penalties and a logit bias ride the sampled program
    (bias, penalties, filters and draw over every row); their tokens are
    the JAX engine's, as the host-branch window's were."""
    jcfg = jax_model("debug-tiny")
    jparams = JM.init_params(jcfg, jax.random.key(3))
    sched = dict(max_num_seqs=4, max_prefill_tokens=64,
                 decode_buckets=BUCKETS, prefill_buckets=(32, 64),
                 decode_window=3)
    jeng = JaxEngine(JEngineConfig(model=jcfg, cache=JCache(page_size=8,
                                                           num_pages=160),
                                   scheduler=JSched(**sched)),
                     params=jparams)
    teng = LLMEngine(EngineConfig(
        model=get_model_config("debug-tiny"),
        cache=CacheConfig(page_size=8, num_pages=160),
        scheduler=SchedulerConfig(**sched)),
        params=TM.params_from_numpy(
            jax.tree.map(np.asarray, jparams),
            get_model_config("debug-tiny"), "cpu"), device="cpu")
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, 500, n).tolist() for n in (6, 17, 28)]
    kw = [dict(presence_penalty=0.6, frequency_penalty=0.3),
          dict(logit_bias={7: 1.5, 11: -2.0}),
          dict(top_k=5, top_p=0.9)]
    j = jeng.generate(prompts, [JSP(max_tokens=10, temperature=0.0, **k)
                                for k in kw])
    t = teng.generate(prompts, [SamplingParams(max_tokens=10,
                                               temperature=0.0, **k)
                                for k in kw])
    assert [o.output_token_ids for o in t] == \
        [o.output_token_ids for o in j]
    assert teng._programs.keys("greedy") == []
    assert teng._programs.keys("sampled")
