"""The port's runtime sanitizers (``KGCT_SANITIZE`` and
``KGCT_SANITIZE_INTERLEAVE``) against the JAX package's, on the CPU.

- Every case of ``tests/test_sanitize.py`` (``TestNoOpWhenOff``,
  ``TestSeededFaults``, ``TestKVShadowUnit``, ``TestOutputGuardUnit``,
  ``TestInterleaveSanitizer``; 19 cases) re-pointed at the port
  (``torch_carry``), on the JAX file's weights (``jax.random.key(7)``)
  carried by ``models/llama.py::params_from_numpy``; and
  ``tests/test_kv_swap.py::test_sanitizer_accepts_swap_churn``.
- With ``KGCT_SANITIZE=1`` the port's and the JAX engine on one weight set
  give the same greedy tokens and the same shadow ``checks`` count over
  decode windows, spec steps and swap churn; ``nan_step_output`` and
  ``kv_commit_stomp`` raise at the same ``step()`` call in both.
- The draft-model pool's shadow (``_DraftShadow``): a clean draft-model
  run raises nothing and checked every feed; a mis-aimed feed slot raises.
- tp 2 over gloo: a ``SanitizerError`` on rank 0 (the leader) fails its
  stream and ends both ranks through the leader/follower failure path,
  without a hang.
"""

from __future__ import annotations

import functools
import subprocess
import sys

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
from kubernetes_gpu_cluster_tpu.resilience import \
    configure_faults as jax_faults
from kubernetes_gpu_cluster_tpu_torch.analysis.sanitize import SanitizerError
from kubernetes_gpu_cluster_tpu_torch.config import (CacheConfig,
                                                     EngineConfig,
                                                     SchedulerConfig,
                                                     get_model_config)
from kubernetes_gpu_cluster_tpu_torch.engine import LLMEngine, SamplingParams
from kubernetes_gpu_cluster_tpu_torch.engine.spec import draft_model
from kubernetes_gpu_cluster_tpu_torch.models import llama as TM
from kubernetes_gpu_cluster_tpu_torch.resilience import configure_faults
from test_torch_parallel import finish_ranks, free_port, rank_env
from torch_carry import carry, expose

torch.set_num_threads(2)
pytestmark = pytest.mark.chaos

_MODEL = get_model_config("debug-tiny")
_JMODEL = jax_model("debug-tiny")
_JAX_PARAMS = JM.init_params(_JMODEL, jax.random.key(7))
_PARAMS = TM.params_from_numpy(jax.tree.map(np.asarray, _JAX_PARAMS),
                               _MODEL, "cpu")

_carried = carry("test_sanitize", [
    ("_PARAMS = model_lib.init_params(_MODEL, jax.random.key(7))",
     "_PARAMS = _port_params"),
], _port_params=_PARAMS)
_carried.LLMEngine = functools.partial(_carried.LLMEngine, device="cpu")
expose("test_sanitize", _carried, None, globals())
REPETITIVE = _carried.REPETITIVE


@pytest.fixture(autouse=True)
def _clear_faults():
    configure_faults(None)
    jax_faults(None)
    yield
    configure_faults(None)
    jax_faults(None)


# -- the port's engine against the JAX engine, sanitizer on -------------------

_SWAP_PROMPTS = [[9, 8, 7, 6], [1, 2, 3, 4], [5, 5, 5, 5]]


def _cfgs(kind: str) -> tuple:
    """(JAX, port) engine configs of one scenario: "decode" and "spec" are
    ``tests/test_sanitize.py::make_engine``'s, "swap" the swap-churn shape
    of ``tests/test_kv_swap.py``."""
    if kind == "swap":
        cache = dict(page_size=8, num_pages=8, swap_space_gb=0.05)
        sched = dict(max_num_seqs=8, max_prefill_tokens=256,
                     decode_buckets=(1, 2, 4, 8),
                     prefill_buckets=(32, 64, 128, 256), decode_window=4)
    else:
        cache = dict(page_size=8, num_pages=128)
        sched = dict(max_num_seqs=4, max_prefill_tokens=256,
                     decode_buckets=(1, 2, 4),
                     prefill_buckets=(32, 64, 128, 256), decode_window=8,
                     spec_decode_enabled=kind == "spec",
                     num_speculative_tokens=4)
    return (JEngineConfig(model=_JMODEL, cache=JCache(**cache),
                          scheduler=JSched(**sched)),
            EngineConfig(model=_MODEL, cache=CacheConfig(**cache),
                         scheduler=SchedulerConfig(**sched)))


def _engines(kind: str, monkeypatch) -> tuple:
    """The JAX and the port engine of ``kind``, both sanitized; spec
    engines get the carried always-drafting proposer."""
    monkeypatch.setenv("KGCT_SANITIZE", "1")
    jcfg, cfg = _cfgs(kind)
    jeng = JaxEngine(jcfg, params=_JAX_PARAMS)
    eng = LLMEngine(cfg, params=_PARAMS, device="cpu")
    if kind == "spec":
        import test_sanitize as jax_tests
        jeng.scheduler.spec_proposer = jax_tests._AlwaysDraft(4)
        eng.scheduler.spec_proposer = _carried._AlwaysDraft(4)
    assert jeng._sanitizer is not None and eng._sanitizer is not None
    return jeng, eng


_WORK = {"decode": ([REPETITIVE, [5, 1, 4]], 12),
         "spec": ([REPETITIVE], 12),
         "swap": (_SWAP_PROMPTS, 16)}


@pytest.mark.parametrize("kind", sorted(_WORK))
def test_sanitized_tokens_and_checks_equal_the_jax_engine(kind, monkeypatch):
    jeng, eng = _engines(kind, monkeypatch)
    prompts, n = _WORK[kind]
    want = jeng.generate(prompts, JaxParams(max_tokens=n, temperature=0.0))
    got = eng.generate(prompts, SamplingParams(max_tokens=n, temperature=0.0))
    assert [o.output_token_ids for o in got] == \
        [o.output_token_ids for o in want]
    assert eng._sanitizer.checks == jeng._sanitizer.checks > 0
    if kind == "spec":
        assert eng.obs.step_kind_counts["spec"] > 0
    if kind == "swap":
        assert eng.scheduler.num_preemptions_by_kind["swap"] > 0
        assert dict(eng.scheduler.num_preemptions_by_kind) == \
            dict(jeng.scheduler.num_preemptions_by_kind)


def _switched(base, k: int):
    """A proposer (subclassing ``base``) that drafts token 1 while its
    ``on`` is set and nothing otherwise."""
    class Switched(base):
        on = True

        def propose(self, token_ids):
            return [1] * self.k if self.on else []
    return Switched(k)


def _spec_mixed_spec(engine, SP) -> list:
    """prefill; spec (its rejected drafts go stale); a mixed step whose
    decode row overwrites the first stale slot; spec again. Returns the
    step kinds."""
    sp = SP(max_tokens=24, temperature=0.0)
    engine.add_request("a", list(REPETITIVE), sp)
    kinds = []
    for on, arrival in ((False, None), (True, None), (False, [5, 1, 4]),
                        (True, None)):
        engine.scheduler.spec_proposer.on = on
        if arrival is not None:
            engine.add_request("b", arrival, sp)
        engine.step()
        kinds.append(engine._last_step_info[0])
    return kinds


def test_mixed_step_decode_rows_reach_the_kv_shadow(monkeypatch):
    """A mixed step's decode rows write one KV slot each; the port hands
    them to the shadow as a one-token decode window, so a rejected-draft
    slot they overwrite is no longer stale at the next spec step. The JAX
    engine has no hook there: its shadow raises a false 'never
    overwritten' on the same steps."""
    from kubernetes_gpu_cluster_tpu.analysis.sanitize import \
        SanitizerError as JaxSanitizerError
    from kubernetes_gpu_cluster_tpu.engine.spec import \
        DraftProposer as JaxDraftProposer
    from kubernetes_gpu_cluster_tpu_torch.engine.spec import DraftProposer
    monkeypatch.setenv("KGCT_SANITIZE", "1")
    jcfg, cfg = _cfgs("spec")
    eng = LLMEngine(cfg, params=_PARAMS, device="cpu")
    eng.scheduler.spec_proposer = _switched(DraftProposer, 4)
    stale = []
    commit = eng._sanitizer.on_spec_commit
    eng._sanitizer.on_spec_commit = lambda *a: (
        commit(*a), stale.append(sorted(eng._sanitizer._stale.get("a", {}))))
    kinds = _spec_mixed_spec(eng, SamplingParams)
    assert kinds == ["prefill", "spec", "mixed", "spec"]
    assert stale[0], "the first spec step left no rejected draft"
    jeng = JaxEngine(jcfg, params=_JAX_PARAMS)
    jeng.scheduler.spec_proposer = _switched(JaxDraftProposer, 4)
    with pytest.raises(JaxSanitizerError, match="never overwritten"):
        _spec_mixed_spec(jeng, JaxParams)


def _raising_call(engine, params, error) -> tuple:
    """(1-based step() call that raised, the message)."""
    engine.add_request("req-0", list(REPETITIVE), params)
    for call in range(1, 200):
        try:
            engine.step()
        except error as e:
            return call, str(e)
        if not engine.has_unfinished_requests():
            break
    raise AssertionError("the seeded fault was never caught")


@pytest.mark.parametrize("fault,kind,match", [
    ("nan_step_output", "decode", "non-finite logprob"),
    ("kv_commit_stomp", "spec", "COMMITTED slot")])
def test_seeded_fault_raises_at_the_jax_engines_step(fault, kind, match,
                                                     monkeypatch):
    from kubernetes_gpu_cluster_tpu.analysis.sanitize import \
        SanitizerError as JaxSanitizerError
    jeng, eng = _engines(kind, monkeypatch)
    spec = f"{fault}:after=2,times=1"
    jax_faults(spec)
    want = _raising_call(jeng, JaxParams(max_tokens=12, temperature=0.0),
                         JaxSanitizerError)
    configure_faults(spec)
    got = _raising_call(eng, SamplingParams(max_tokens=12, temperature=0.0),
                        SanitizerError)
    assert got[0] == want[0] and match in got[1]
    assert eng.step_count == jeng.step_count


def test_kv_swap__sanitizer_accepts_swap_churn(monkeypatch):
    """``tests/test_kv_swap.py``'s case on the port: KGCT_SANITIZE=1 and
    swap churn — the KV-slot shadow treats swapped-in slots as committed
    history, no false positive across a full preempt/restore cycle, and
    every restore reached it."""
    monkeypatch.setenv("KGCT_SANITIZE", "1")
    eng = LLMEngine(_cfgs("swap")[1], params=_PARAMS, device="cpu")
    assert eng._sanitizer is not None
    restores = []
    hook = eng.swapper.on_restored
    eng.swapper.on_restored = lambda seq: (restores.append(seq), hook(seq))
    outs = eng.generate(_SWAP_PROMPTS,
                        SamplingParams(max_tokens=16, temperature=0.0))
    assert eng.scheduler.num_preemptions_by_kind["swap"] > 0
    assert len(restores) == eng.scheduler.num_preemptions_by_kind["swap"]
    assert eng._sanitizer.checks > 0
    assert [o.finished for o in outs] == [True] * 3


# -- the draft-model pool's shadow ---------------------------------------------

def _draft_engine():
    cfg = EngineConfig(
        model=_MODEL, cache=CacheConfig(page_size=8, num_pages=128),
        scheduler=SchedulerConfig(
            max_num_seqs=4, max_prefill_tokens=256, decode_buckets=(1, 2, 4),
            prefill_buckets=(32, 64, 128, 256), decode_window=8,
            spec_decode_enabled=True, num_speculative_tokens=4,
            spec_draft_model="debug-tiny"))
    return LLMEngine(cfg, params=_PARAMS, device="cpu", draft_params=_PARAMS)


def test_draft_shadow_checks_every_feed_of_a_clean_run(monkeypatch):
    params = SamplingParams(max_tokens=12, temperature=0.0)
    monkeypatch.delenv("KGCT_SANITIZE", raising=False)
    off = _draft_engine().generate([REPETITIVE, [3, 1, 4, 1, 5]], params)
    monkeypatch.setenv("KGCT_SANITIZE", "1")
    eng = _draft_engine()
    runner = eng.scheduler.spec_proposer
    assert runner._shadow is not None
    feeds = []
    check = runner._shadow.check_feed
    monkeypatch.setattr(runner._shadow, "check_feed",
                        lambda *a: (feeds.append(a[3]), check(*a)))
    on = eng.generate([REPETITIVE, [3, 1, 4, 1, 5]], params)
    assert [o.output_token_ids for o in on] == \
        [o.output_token_ids for o in off]
    assert runner.num_dispatches > 0
    # one check per planned feed: k per active row per round
    assert len(feeds) >= runner.num_dispatches


def test_draft_shadow_refuses_a_mis_aimed_feed_slot(monkeypatch):
    monkeypatch.setenv("KGCT_SANITIZE", "1")
    eng = _draft_engine()
    aim = draft_model._feed_slot
    monkeypatch.setattr(draft_model, "_feed_slot",
                        lambda pages, pos, ps, ml: aim(pages, pos, ps, ml) + 1)
    with pytest.raises(SanitizerError, match="page table derives"):
        eng.generate([REPETITIVE], SamplingParams(max_tokens=12,
                                                  temperature=0.0))


# -- tp 2: a SanitizerError on rank 0 ends both ranks --------------------------

_TP_HEAD = r"""
import os, sys, time
import torch
torch.set_num_threads(1)
sys.path.insert(0, os.environ["KGCT_REPO"])
"""

_TP_CFG = r"""
from kubernetes_gpu_cluster_tpu_torch.config import (
    CacheConfig, EngineConfig, ParallelConfig, SchedulerConfig,
    get_model_config)
cfg = EngineConfig(
    model=get_model_config("debug-tiny"),
    cache=CacheConfig(page_size=16, num_pages=64),
    scheduler=SchedulerConfig(max_num_seqs=4, max_prefill_tokens=128,
                              decode_buckets=(1, 2, 4),
                              prefill_buckets=(64, 128)),
    parallel=ParallelConfig(tp=2))
"""

_TP_LEADER = _TP_HEAD + r"""
from kubernetes_gpu_cluster_tpu_torch.parallel import (initialize_distributed,
                                                       mesh_from_config)
initialize_distributed(device="cpu", timeout_s=60)
""" + _TP_CFG + r"""
import asyncio
from kubernetes_gpu_cluster_tpu_torch.analysis.sanitize import SanitizerError
from kubernetes_gpu_cluster_tpu_torch.engine import SamplingParams
from kubernetes_gpu_cluster_tpu_torch.serving.async_engine import \
    AsyncLLMEngine
from kubernetes_gpu_cluster_tpu_torch.serving.multihost import (
    DirectiveLeader, follower_addrs_from_env)
eng = AsyncLLMEngine(cfg, device="cpu",
                     groups=mesh_from_config(cfg.parallel),
                     leader=DirectiveLeader(follower_addrs_from_env()))
assert eng.engine._sanitizer is not None

async def main():
    eng.start(asyncio.get_running_loop())
    try:
        async for _ in eng.generate("r0", [1, 5, 9, 2], SamplingParams(
                temperature=0.0, max_tokens=8)):
            pass
    except SanitizerError as e:
        print("LEADER-RAISED:", str(e)[:60], flush=True)

asyncio.run(main())
print(f"LEADER-DOWN-AT:{time.time()}", flush=True)
eng.shutdown()
"""

_TP_FOLLOWER = _TP_HEAD + r"""
from kubernetes_gpu_cluster_tpu_torch.serving.multihost import \
    DirectiveFollower
follower = DirectiveFollower(port=int(os.environ["KGCT_CONTROL_PORT"]),
                             host="127.0.0.1")
from kubernetes_gpu_cluster_tpu_torch.parallel import (initialize_distributed,
                                                       mesh_from_config)
initialize_distributed(device="cpu", timeout_s=60)
""" + _TP_CFG + r"""
from kubernetes_gpu_cluster_tpu_torch.engine import LLMEngine
eng = LLMEngine(cfg, device="cpu", groups=mesh_from_config(cfg.parallel))
assert eng._sanitizer is not None
follower.run(eng)
print(f"FOLLOWER-DONE-AT:{time.time()}", flush=True)
"""


@pytest.mark.skipif(sys.platform != "linux", reason="localhost gloo test")
def test_tp2_sanitizer_error_on_rank0_ends_both_ranks(tmp_path):
    ctrl, coordinator = free_port(), f"127.0.0.1:{free_port()}"
    scripts = [tmp_path / "leader.py", tmp_path / "follower.py"]
    scripts[0].write_text(_TP_LEADER)
    scripts[1].write_text(_TP_FOLLOWER)
    extra = dict(KGCT_SANITIZE="1", KGCT_CONTROL_PORT=str(ctrl),
                 KGCT_FOLLOWER_ADDRS=f"127.0.0.1:{ctrl}",
                 KGCT_FLIGHT_DIR=str(tmp_path / "flight"))
    procs = [subprocess.Popen(
        [sys.executable, str(scripts[r])],
        env=rank_env(2, r, coordinator, **extra,
                     **({"KGCT_FAULT": "nan_step_output:after=1,times=1"}
                        if r == 0 else {})),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in (0, 1)]
    lead, follow = finish_ranks(procs, timeout_s=120)
    assert lead[0] == 0, lead[2][-3000:]
    assert follow[0] == 0, follow[2][-3000:]
    assert "LEADER-RAISED: step output sanitizer: non-finite" in lead[1]
    down = float(lead[1].split("LEADER-DOWN-AT:")[1].split()[0])
    done = float(follow[1].split("FOLLOWER-DONE-AT:")[1].split()[0])
    # the follower group-aborts its copy of the request when the leader
    # detaches: no rank is left blocked in a collective
    assert "group-abort" in follow[2]
    assert done - down < 7.0
