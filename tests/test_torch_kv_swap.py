"""The port's host KV tier against the JAX package, on the CPU.

One JAX weight set (``debug-tiny``, fp32) drives both packages:

- the port's swap engine under the pressure shape of
  ``tests/test_kv_swap.py`` (three sequences whose decode growth overflows
  a 7-usable-page pool) gives greedy and seeded-sampled outputs,
  preemption counts by kind and swapped page counts EQUAL to the JAX swap
  engine's, and outputs equal to its own never-preempted run;
- ``HostKVPool`` + ``KVSwapper`` round trips are bit-identical to the JAX
  ``HostKVPool`` + ``KVTransferPrograms`` on the same pool contents (fp32
  and bf16);
- the engine-level cases of ``tests/test_kv_swap.py`` re-pointed at the
  port: accounting drains and swap-off builds nothing, trace events,
  prefix spill second chance, the FakeSwapper scheduler cases, abort of a
  swapped sequence, the oversubscribed soak, and ``kv_swap_fail``
  degrading to recompute;
- the split between degrading and failing: a refused swap
  (``KVTransferRefused``: host pool full, or the chaos site) degrades to
  recompute, any other error out of a transfer (a device fault on the
  card) propagates;
- swap with speculative decoding on (n-gram, then a draft model, whose
  runner re-ingests a restored sequence with a reset prefill).

Waiting for later slices: the ``/metrics`` text of the host-pool gauges
(``serving/metrics.py``, ROADMAP A5) and the sanitizer's swap-restore case
(ROADMAP A9).
"""

import dataclasses

import jax
import jax.numpy as jnp
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
from kubernetes_gpu_cluster_tpu.engine import kv_cache as JKV
from kubernetes_gpu_cluster_tpu.models import llama as JM
from kubernetes_gpu_cluster_tpu_torch.config import (CacheConfig,
                                                     EngineConfig,
                                                     SchedulerConfig,
                                                     get_model_config)
from kubernetes_gpu_cluster_tpu_torch.engine import LLMEngine, SamplingParams
from kubernetes_gpu_cluster_tpu_torch.engine import kv_cache as TKV
from kubernetes_gpu_cluster_tpu_torch.engine.scheduler import Scheduler
from kubernetes_gpu_cluster_tpu_torch.engine.sequence import (Sequence,
                                                              SequenceStatus)
from kubernetes_gpu_cluster_tpu_torch.models import llama as TM
from kubernetes_gpu_cluster_tpu_torch.resilience.faults import \
    configure_faults

torch.set_num_threads(2)

_PROMPTS = [[9, 8, 7, 6], [1, 2, 3, 4], [5, 5, 5, 5]]
_PARAMS = [
    dict(max_tokens=16, temperature=0.8, seed=11, frequency_penalty=1.5,
         presence_penalty=0.5),
    dict(max_tokens=16, temperature=0.8, seed=22, frequency_penalty=1.5),
    dict(max_tokens=16, temperature=0.0),
]
_SCHED = dict(max_prefill_tokens=256, decode_buckets=(1, 2, 4, 8),
              prefill_buckets=(32, 64, 128, 256), decode_window=4)


@pytest.fixture(autouse=True)
def _clean_faults():
    configure_faults(None)
    yield
    configure_faults(None)


@pytest.fixture(scope="module")
def weights():
    jp = JM.init_params(jax_model("debug-tiny"), jax.random.key(5))
    return jp, TM.params_from_numpy(jax.tree.map(np.asarray, jp),
                                    get_model_config("debug-tiny"), "cpu")


def _cfg(num_pages, swap_gb=0.0, max_seqs=8, prefix=False, max_prefill=256,
         **sched):
    kw = dict(_SCHED, max_num_seqs=max_seqs, max_prefill_tokens=max_prefill,
              enable_prefix_caching=prefix, **sched)
    return EngineConfig(
        model=get_model_config("debug-tiny"),
        cache=CacheConfig(page_size=8, num_pages=num_pages,
                          swap_space_gb=swap_gb),
        scheduler=SchedulerConfig(**kw))


def _mk(weights, num_pages, swap_gb=0.0, **kw):
    return LLMEngine(_cfg(num_pages, swap_gb, **kw), params=weights[1],
                     device="cpu")


def _tokens(outs):
    return [o.output_token_ids for o in outs]


@pytest.fixture(scope="module")
def trio(weights):
    """(never-preempted outputs, the port's swap engine and its outputs,
    the JAX swap engine's outputs and counters) on one weight set; the
    port's swap engine comes back with its post-churn state."""
    ref = _tokens(_mk(weights, 128).generate(
        _PROMPTS, [SamplingParams(**p) for p in _PARAMS]))
    swp = _mk(weights, 8, swap_gb=0.05)
    got = _tokens(swp.generate(_PROMPTS,
                               [SamplingParams(**p) for p in _PARAMS]))
    jcfg = JEngineConfig(
        model=jax_model("debug-tiny"),
        cache=JCache(page_size=8, num_pages=8, swap_space_gb=0.05),
        scheduler=JSched(max_num_seqs=8, **_SCHED))
    jeng = JaxEngine(jcfg, params=weights[0])
    jgot = _tokens(jeng.generate(_PROMPTS,
                                 [JaxParams(**p) for p in _PARAMS]))
    jax_side = {"tokens": jgot,
                "kinds": dict(jeng.scheduler.num_preemptions_by_kind),
                "swap_pages": dict(jeng.obs.swap_pages),
                "host_pages": jeng.swapper.host.num_pages}
    return ref, swp, got, jax_side


def test_swap_engine_matches_jax_swap_engine(trio):
    """Same weights, same pressure: the port makes the JAX engine's swap
    decisions (preemptions by kind, pages out and in, host pool size from
    the same bytes-per-page) and emits its tokens, greedy and seeded."""
    _, swp, got, jax_side = trio
    assert swp.swapper.host.num_pages == jax_side["host_pages"]
    assert dict(swp.scheduler.num_preemptions_by_kind) == jax_side["kinds"]
    assert dict(swp.obs.swap_pages) == jax_side["swap_pages"]
    assert jax_side["kinds"]["swap"] > 0
    assert got[2] == jax_side["tokens"][2]       # greedy: token-identical


def test_swap_restore_identical_to_never_preempted(trio):
    """Greedy AND seeded-sampled (with penalties) continuations across a
    swap-preempt/restore cycle match the never-preempted run exactly: the
    restored pages are bit copies of the committed KV."""
    ref, swp, got, _ = trio
    assert swp.scheduler.num_preemptions_by_kind["swap"] > 0
    assert swp.scheduler.num_preemptions_by_kind["recompute"] == 0
    assert got == ref


def test_swap_accounting_drains_and_swap_off_builds_nothing(trio, weights):
    _, swp, _, _ = trio
    alloc = swp.scheduler.allocator
    assert alloc.num_free == alloc.num_pages - 1
    assert swp.swapper.host.num_in_use == 0
    assert not swp.scheduler.swapped
    snap = swp._flight_snapshot()
    assert snap["host_pages_in_use"] == 0
    assert snap["host_pages_total"] == swp.swapper.host.num_pages
    off = _mk(weights, 8)
    assert off.swapper is None and off.scheduler.swapper is None
    assert "host_pages_total" not in off._flight_snapshot()
    assert not CacheConfig().kv_swap_enabled
    assert CacheConfig(swap_space_gb=0.5).kv_swap_enabled


def test_swap_counters_and_trace(trio):
    """The observability counters and the trace ring carry the swaps:
    kind-tagged preempt events, swap events with page counts, resume
    events on restoration; the rendered counters read the same pages."""
    _, swp, _, _ = trio
    out_pages = swp.obs.swap_pages["out"]
    assert out_pages > 0 and swp.obs.swap_pages["in"] == out_pages
    text = "\n".join(swp.obs.render_prometheus())
    assert f"kgct_kv_swap_out_pages_total {out_pages}" in text
    assert f"kgct_kv_swap_in_pages_total {out_pages}" in text
    assert "kgct_kv_swap_seconds_bucket" in text
    events = swp.obs.tracer.events()
    swaps = [e for e in events if e.kind == "swap"]
    assert swaps and all(e.args["pages"] > 0 and e.args["dir"] in ("out", "in")
                         for e in swaps)
    assert sum(e.args["pages"] for e in swaps
               if e.args["dir"] == "out") == out_pages
    preempts = [e for e in events if e.kind == "preempt"]
    assert preempts and all(e.args["preempt_kind"] == "swap"
                            for e in preempts)
    assert any(e.kind == "resume" for e in events)


def test_prefix_spill_second_chance(weights):
    """An evicted prefix-cache entry spills to host; a later lookup
    restores it (host hit) instead of re-prefilling, and the continuation
    matches the first run exactly."""
    rng = np.random.default_rng(7)
    shared = rng.integers(1, 500, 16).tolist()         # 2 full pages
    params = SamplingParams(max_tokens=4, temperature=0.0)
    eng = _mk(weights, 9, swap_gb=0.05, max_seqs=2, prefix=True,
              max_prefill=64)
    pc = eng.scheduler.prefix_cache
    out1 = eng.generate([shared + [7, 7]], params)[0]
    assert len(pc._entries) == 2 and not pc._host_entries
    for _ in range(3):
        eng.generate([rng.integers(1, 500, 16).tolist() + [3]], params)
    assert pc._host_entries, "eviction never spilled to host"
    assert eng.prefix_peek(shared + [7, 7]) == 16      # host tier counts
    out2 = eng.generate([shared + [7, 7]], params)[0]
    assert pc.host_hits > 0, "second-chance host hit never fired"
    assert out1.output_token_ids == out2.output_token_ids


def _pool(L, P, ps, kd, dtype, seed):
    """The same random pool contents for both packages: (jax KVCache,
    torch KVCache)."""
    rng = np.random.default_rng(seed)
    k = rng.standard_normal((L, P, ps, kd)).astype(dtype)
    v = rng.standard_normal((L, P, ps, kd)).astype(dtype)
    return (JKV.KVCache(k=jnp.asarray(k), v=jnp.asarray(v)),
            TKV.KVCache(k=TKV.host_tensor(k).clone(),
                        v=TKV.host_tensor(v).clone()))


def _bits(a) -> np.ndarray:
    """Raw bits of a jax/numpy/torch buffer, for bit-identity checks."""
    if isinstance(a, torch.Tensor):
        a = (a.view(torch.int16) if a.dtype == torch.bfloat16 else a).numpy()
    a = np.asarray(a)
    return a.view(np.uint16 if a.dtype.itemsize == 2 else np.uint32)


@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16],
                         ids=["fp32", "bf16"])
def test_host_pool_round_trip_bit_identical_to_jax(dtype):
    """Swap pages out to the host tier, overwrite them on the device, swap
    them back into DIFFERENT device pages: every host page, gathered buffer
    and final pool is bit-identical to the JAX package's HostKVPool +
    KVTransferPrograms doing the same on the same contents."""
    L, P, ps, kd = 2, 12, 8, 64
    jkv, tkv = _pool(L, P, ps, kd, dtype, seed=1)
    out_pages, in_pages = [3, 7, 4, 9], [10, 2, 11, 5]
    jprog = JKV.KVTransferPrograms()
    jhost = JKV.HostKVPool(8, L, ps, kd, np.dtype(dtype))
    jk, jv = jprog.gather_pages(jkv, out_pages)
    jhp = jhost.allocate(len(out_pages))
    jhost.put(jhp, jk, jv)
    tswap = TKV.KVSwapper(
        TKV.HostKVPool(8, L, ps, kd, tkv.k.dtype), lambda: tkv,
        TKV.KVTransferPrograms("cpu"))
    thp = tswap.swap_out(out_pages)
    assert thp == jhp
    np.testing.assert_array_equal(_bits(tswap.host.k[:, thp]),
                                  _bits(jhost.k[:, jhp]))
    np.testing.assert_array_equal(_bits(tswap.host.v[:, thp]),
                                  _bits(jhost.v[:, jhp]))
    # Overwrite the swapped-out pages on the device, then swap back in
    # elsewhere: the restore must come from the host copy.
    tkv.k[:, out_pages] = 0
    tkv.v[:, out_pages] = 0
    jkv = JKV.KVCache(k=jkv.k.at[:, jnp.asarray(out_pages)].set(0),
                      v=jkv.v.at[:, jnp.asarray(out_pages)].set(0))
    hk, hv = jhost.get(jhp)
    jkv = jprog.scatter_pages(jkv, in_pages, hk, hv)
    tswap.swap_in(thp, in_pages)
    np.testing.assert_array_equal(_bits(tkv.k), _bits(jkv.k))
    np.testing.assert_array_equal(_bits(tkv.v), _bits(jkv.v))
    assert tswap.host.num_in_use == 0
    # The handoff seam rides the same pair: export matches the JAX gather.
    io = TKV.KVPageIO(lambda: tkv, tswap.programs)
    ek, ev = io.export_pages(in_pages)
    gk, gv = jprog.gather_pages(jkv, in_pages)
    np.testing.assert_array_equal(_bits(ek), _bits(gk))
    np.testing.assert_array_equal(_bits(ev), _bits(gv))


def test_export_state_dtype_spelling_reads_as_jax():
    """States carry the JAX spelling of the pool dtype, and the importers
    take numpy buffers of either package's decoding."""
    assert TKV.dtype_name(torch.float32) == str(np.dtype(np.float32))
    assert TKV.dtype_name(torch.bfloat16) == str(np.dtype(ml_dtypes.bfloat16))
    a = np.arange(12, dtype=np.float32).astype(ml_dtypes.bfloat16)
    t = TKV.host_tensor(a)
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(), a.astype(np.float32))
    ro = np.frombuffer(np.arange(4, dtype=np.float32).tobytes(), np.float32)
    assert TKV.host_tensor(ro).tolist() == [0.0, 1.0, 2.0, 3.0]


class _Event:
    """A stand-in CUDA event: records whether the copy was waited for."""

    def __init__(self):
        self.waited = False

    def synchronize(self):
        self.waited = True


def test_host_pages_freed_under_an_event_are_reused_only_after_it():
    """A swap-in's host pages return with the copy's event: they count as
    free at once (the port's capacity decisions equal the JAX package's),
    but allocate() waits on the event before handing one out again."""
    host = TKV.HostKVPool(3, 1, 2, 4, torch.float32)
    pages = host.allocate(3)
    ev = _Event()
    host.free(pages[:2], ev)
    assert host.num_free == 2 and host.num_in_use == 1
    assert host.can_allocate(2) and not ev.waited
    got = host.allocate(2)
    assert ev.waited and sorted(got) == sorted(pages[:2])
    host.free(got)
    host.free(pages[2:])
    assert host.num_free == 3


def test_host_pool_hands_freed_runs_back_in_ascending_order():
    """Consecutive host pages make one copy per layer and run on the card:
    a freed run comes back ascending, not reversed by the free stack."""
    host = TKV.HostKVPool(8, 1, 2, 4, torch.float32)
    a, b = host.allocate(3), host.allocate(3)
    assert (a, b) == ([0, 1, 2], [3, 4, 5])
    host.free(b)
    host.free(list(reversed(a)), _Event())
    assert host.allocate(6) == [0, 1, 2, 3, 4, 5]
    assert TKV._runs([0, 1, 2, 5, 7, 8]) == [(0, 0, 3), (5, 3, 1), (7, 4, 2)]


# -- scheduler-level lifecycle (no device work: FakeSwapper) -----------------

class FakeHost:
    def __init__(self, num_pages=64):
        self.num_pages = num_pages
        self.num_free = num_pages

    @property
    def num_in_use(self):
        return self.num_pages - self.num_free


class FakeSwapper:
    """``fail_out`` / ``fail_in``: the exception a transfer raises —
    ``KVTransferRefused`` degrades, anything else is a device fault."""

    def __init__(self, fail_out=None, fail_in=None):
        self.host = FakeHost()
        self.fail_out = fail_out
        self.fail_in = fail_in
        self.freed_host: list = []
        self.swapped_in: list = []
        self._next = 1000

    def swap_out(self, pages, request_id=""):
        if self.fail_out is not None:
            raise self.fail_out
        hps = list(range(self._next, self._next + len(pages)))
        self._next += len(pages)
        self.host.num_free -= len(pages)
        return hps

    def swap_in(self, host_pages, device_pages, request_id=""):
        if self.fail_in is not None:
            raise self.fail_in
        self.swapped_in.append((list(host_pages), list(device_pages)))
        self.host.num_free += len(host_pages)

    def free_host(self, host_pages):
        self.freed_host.extend(host_pages)
        self.host.num_free += len(host_pages)


REFUSED = TKV.KVTransferRefused("host KV pool full")


def _sched_cfg(window=1):
    return EngineConfig(
        model=get_model_config("debug-tiny"),
        cache=CacheConfig(page_size=2, num_pages=3),
        scheduler=SchedulerConfig(max_num_seqs=4, max_prefill_tokens=64,
                                  decode_buckets=(1, 2, 4),
                                  prefill_buckets=(16, 32, 64),
                                  decode_window=window))


def _pressure_pair(swapper, window=1):
    """Two 1-page sequences on a 2-usable-page pool, both needing a second
    page, with a swapper attached."""
    sched = Scheduler(_sched_cfg(window), 3)
    sched.attach_swapper(swapper)
    a = Sequence("a", [1, 2], SamplingParams(max_tokens=64))
    b = Sequence("b", [3, 4], SamplingParams(max_tokens=64))
    sched.add(a)
    sched.add(b)
    assert sched.schedule().kind == "prefill"
    a.append_token(5)
    b.append_token(6)
    return sched, a, b


def test_scheduler_preempts_by_swap_and_state_survives():
    fake = FakeSwapper()
    sched, a, b = _pressure_pair(fake)
    prefilled_before = b.num_prefilled
    batch = sched.schedule()
    assert batch.kind == "decode"
    assert [s.request_id for s in batch.seqs] == ["a"]
    assert sched.num_preemptions_by_kind == {"recompute": 0, "swap": 1}
    assert list(sched.swapped) == [b] and not sched.waiting
    assert b.status == SequenceStatus.PREEMPTED
    assert b.host_pages and not b.pages
    assert b.num_prefilled == prefilled_before
    sched.finish(a, None)
    batch = sched.schedule()
    assert batch is not None and batch.kind == "decode"
    assert [s.request_id for s in batch.seqs] == ["b"]
    assert b.status == SequenceStatus.RUNNING
    assert b.pages and not b.host_pages
    assert fake.swapped_in and fake.host.num_in_use == 0


def test_scheduler_refused_swap_out_degrades_to_recompute():
    fake = FakeSwapper(fail_out=REFUSED)
    sched, a, b = _pressure_pair(fake)
    batch = sched.schedule()
    assert batch.kind == "decode"           # never wedges the step
    assert sched.num_preemptions_by_kind == {"recompute": 1, "swap": 0}
    assert not sched.swapped and sched.waiting[0] is b
    assert b.num_prefilled == 0 and not b.host_pages


def test_scheduler_refused_swap_in_degrades_to_recompute():
    fake = FakeSwapper()
    sched, a, b = _pressure_pair(fake)
    sched.schedule()                        # b swap-preempted
    fake.fail_in = REFUSED
    sched.finish(a, None)
    batch = sched.schedule()
    assert not sched.swapped and not b.host_pages
    assert batch is not None and batch.kind == "prefill"
    assert [s.request_id for s in batch.seqs] == ["b"]
    assert b.status == SequenceStatus.RUNNING
    assert fake.freed_host
    assert sched.num_preemptions_by_kind == {"recompute": 1, "swap": 0}


@pytest.mark.parametrize("where", ["out", "in"])
def test_scheduler_device_fault_in_a_transfer_propagates(where):
    """A fault that is not a refusal (on the card: a CUDA error out of the
    gather or the scatter) must not be turned into a recompute
    preemption: it propagates out of schedule()."""
    fault = RuntimeError("CUDA error: an illegal memory access")
    fake = FakeSwapper(fail_out=fault if where == "out" else None)
    sched, a, b = _pressure_pair(fake)
    if where == "in":
        sched.schedule()                    # b swap-preempted
        fake.fail_in = fault
        sched.finish(a, None)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        sched.schedule()


def test_unrestorable_swapped_sequence_degrades_to_recompute():
    """A swapped sequence whose committed+window page need exceeds TOTAL
    pool capacity degrades to recompute readmission instead of pinning
    schedule() in a forever-None loop."""
    fake = FakeSwapper()
    sched, a, b = _pressure_pair(fake, window=6)
    assert sched.schedule() is None
    assert sched.num_preemptions_by_kind["swap"] == 2
    batch = sched.schedule()
    assert not sched.swapped
    assert batch is not None and batch.kind == "prefill"
    assert not b.host_pages and not a.host_pages
    assert fake.host.num_in_use == 0
    assert sched.num_preemptions_by_kind == {"recompute": 2, "swap": 0}


def test_abort_swapped_sequence_frees_host_pages():
    fake = FakeSwapper()
    sched, a, b = _pressure_pair(fake)
    sched.schedule()
    hps = list(b.host_pages)
    assert sched.abort("b")
    assert b.is_finished and not b.host_pages
    assert fake.freed_host == hps and fake.host.num_in_use == 0


def test_abort_swapped_sequence_on_the_engine(weights):
    """Through the engine: aborting a sequence parked in the host tier
    frees its host pages, and the rest still finish."""
    eng = _mk(weights, 8, swap_gb=0.05)
    for i, p in enumerate(_PROMPTS):
        eng.add_request(f"r{i}", p, SamplingParams(max_tokens=16,
                                                   temperature=0.0))
    while not eng.scheduler.swapped:
        assert eng.has_unfinished_requests(), "no swap preemption happened"
        eng.step()
    victim = eng.scheduler.swapped[0]
    assert victim.host_pages
    assert eng.abort_request(victim.request_id)
    assert eng.swapper.host.num_in_use == 0
    while eng.has_unfinished_requests():
        eng.step()
    alloc = eng.scheduler.allocator
    assert alloc.num_free == alloc.num_pages - 1


# -- engine-level degradation and soak ----------------------------------------

def test_kv_swap_fail_chaos_degrades_to_recompute(trio, weights):
    """KGCT_FAULT=kv_swap_fail: every swap-out is refused, every
    preemption recomputes, the host pool stays empty, outputs unchanged."""
    ref = trio[0]
    configure_faults("kv_swap_fail")
    eng = _mk(weights, 8, swap_gb=0.05)
    got = _tokens(eng.generate(_PROMPTS,
                               [SamplingParams(**p) for p in _PARAMS]))
    kinds = eng.scheduler.num_preemptions_by_kind
    assert kinds["recompute"] > 0 and kinds["swap"] == 0
    assert eng.swapper.host.num_in_use == 0 and eng.obs.swap_pages["out"] == 0
    assert got == ref


def test_full_host_pool_degrades_device_fault_propagates(trio, weights,
                                                         monkeypatch):
    """The split on a real engine: a host tier too small for the victim
    refuses the swap and the engine recomputes with unchanged outputs; a
    fault raised inside the transfer itself (what a CUDA error looks like
    on the card) propagates out of step()."""
    ref = trio[0]
    bpp = TKV.kv_cache_bytes_per_page(get_model_config("debug-tiny"),
                                      CacheConfig(page_size=8))
    one_page = (bpp + 1) / (1 << 30)
    eng = _mk(weights, 8, swap_gb=one_page)
    assert eng.swapper.host.num_pages == 1
    got = _tokens(eng.generate(_PROMPTS,
                               [SamplingParams(**p) for p in _PARAMS]))
    assert eng.scheduler.num_preemptions_by_kind["recompute"] > 0
    assert got == ref

    def fault(*a, **k):
        raise RuntimeError("CUDA error: unspecified launch failure")

    eng = _mk(weights, 8, swap_gb=0.05)
    monkeypatch.setattr(eng._kv_programs, "gather_to_host", fault)
    for i, p in enumerate(_PROMPTS):
        eng.add_request(f"r{i}", p, SamplingParams(max_tokens=16,
                                                   temperature=0.0))
    with pytest.raises(RuntimeError, match="unspecified launch failure"):
        while eng.has_unfinished_requests():
            eng.step()
    assert eng.scheduler.num_preemptions_by_kind["recompute"] == 0
    assert eng.swapper.host.num_in_use == 0


def test_swap_soak_oversubscribed_sessions(weights):
    """8 greedy sessions on a ~2x-oversubscribed pool churn through
    repeated swap-preempt/restore cycles; outputs equal an unpressured
    engine's and both tiers drain to empty."""
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, 500, 24).tolist() for _ in range(8)]
    params = SamplingParams(max_tokens=24, temperature=0.0)
    ref = _tokens(_mk(weights, 256).generate(prompts, params))
    eng = _mk(weights, 25, swap_gb=0.1)
    got = _tokens(eng.generate(prompts, params))
    assert eng.scheduler.num_preemptions_by_kind["swap"] >= 2
    assert got == ref
    alloc = eng.scheduler.allocator
    assert alloc.num_free == alloc.num_pages - 1
    assert eng.swapper.host.num_in_use == 0


@pytest.mark.parametrize("proposer", ["ngram", "draft"])
def test_swap_with_speculative_decoding(weights, proposer):
    """Spec on under swap pressure: greedy outputs equal the spec-off
    never-preempted run (the n-gram proposer and the verify step read only
    the restored pages). With a draft model (the target's own weights, an
    oracle) the runner drops a swapped-out sequence's draft state and
    re-ingests it on its return with a reset prefill, never stale KV."""
    prompts = [[7, 3, 9, 11] * 2, [1, 2, 3, 4], [5, 5, 5, 5]]
    greedy = SamplingParams(max_tokens=16, temperature=0.0)
    ref = _tokens(_mk(weights, 128).generate(prompts, greedy))
    kw = dict(spec_decode_enabled=True, num_speculative_tokens=4)
    if proposer == "draft":
        kw["spec_draft_model"] = "debug-tiny"
    eng = LLMEngine(_cfg(8, 0.05, **kw), params=weights[1], device="cpu",
                    draft_params=weights[1])
    got = _tokens(eng.generate(prompts, greedy))
    assert eng.scheduler.num_preemptions_by_kind["swap"] > 0
    assert eng.obs.step_kind_counts["spec"] > 0
    assert got == ref
    if proposer == "draft":
        runner = eng.scheduler.spec_proposer
        # one reset prefill per first sight, and more for restored rows
        assert runner.num_reset_prefills > len(prompts)
    assert eng.swapper.host.num_in_use == 0


def test_engine_with_swap_builds_a_swapper(weights):
    """swap_space_gb > 0 builds the host tier on the CPU too; its size
    follows the JAX formula (whole pages of kv_cache_bytes_per_page)."""
    eng = LLMEngine(dataclasses.replace(
        _cfg(8), cache=CacheConfig(page_size=8, num_pages=8,
                                   swap_space_gb=0.001)),
        params=weights[1], device="cpu")
    bpp = TKV.kv_cache_bytes_per_page(get_model_config("debug-tiny"),
                                      CacheConfig(page_size=8))
    assert eng.swapper.host.num_pages == int(0.001 * (1 << 30)) // bpp
    assert eng.scheduler.swapper is eng.swapper
    assert eng.swapper.programs is eng.kv_io.programs
