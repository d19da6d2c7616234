"""Engine/runtime configuration.

Field names deliberately mirror the operator-facing knobs of the reference's
Helm values schema (``vllmConfig`` in ``values-01-minimal-example8.yaml:24-38``):
``tensorParallelSize`` -> ParallelConfig.tp, ``pipelineParallelSize`` -> .pp,
``gpuMemoryUtilization`` -> CacheConfig.hbm_utilization, ``maxModelLen`` ->
EngineConfig.max_model_len — so the deployment surface
(kubernetes_gpu_cluster_tpu.deploy.render) maps reference values files 1:1
onto this engine; tests/test_deploy.py renders all nine.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from .model_config import ModelConfig, get_model_config


@dataclasses.dataclass(frozen=True)
class CacheConfig:
    """Paged KV cache sizing (reference knob: gpuMemoryUtilization 0.90-0.99,
    maxModelLen 128-4096 — values-01-minimal-example4.yaml:19-22, ...8.yaml:26-27)."""
    # Tokens per KV page. None = 16 at engine init (the attention kernels
    # take 8-128; 16 is the finest granularity that keeps a page's K rows
    # one 4 KB run at n_kv*hd = 1024 bf16). Set explicitly to pin it.
    page_size: Optional[int] = None
    num_pages: Optional[int] = None    # explicit page count; None = derive from HBM
    hbm_utilization: float = 0.90      # fraction of free HBM to give the KV cache
    dtype: Optional[str] = None        # KV dtype; None = model dtype
    # Host-DRAM second KV tier (vLLM swap-space parity): GB of host memory
    # for swapped-out pages. 0 (default) disables the tier entirely and is
    # byte-identical to the single-tier engine — preemption recomputes and
    # prefix-cache eviction drops pages. >0 turns preempt-by-swap and
    # prefix-spill on: the session-capacity bound becomes "<= host RAM" and
    # warm resumption is a memcpy instead of a prefill
    # (engine/kv_cache.HostKVPool / KVSwapper).
    swap_space_gb: float = 0.0

    @property
    def kv_swap_enabled(self) -> bool:
        return self.swap_space_gb > 0


@dataclasses.dataclass(frozen=True)
class QoSTier:
    """One multi-tenant QoS priority class (engine/qos.py owns the runtime
    accounting). Tiers are the unit of isolation: weighted fair sharing of
    the scheduler's token budget runs across tiers, preemption victims are
    chosen from lower-priority tiers first, and admission budgets + shed
    accounting are kept per tier — so one flooding tenant degrades its own
    tier while the others keep their SLO. Tier NAMES are also Prometheus
    label values (``tier=``), so they are validated to a bounded charset at
    parse time (engine/qos.py) — KGCT007 metric hygiene."""
    name: str
    # Fair-share weight: a tier's virtual-token clock advances at
    # served_tokens / weight, so a weight-4 tier receives ~4x the service
    # of a weight-1 tier when both have work queued.
    weight: float = 1.0
    # Preemption rank: HIGHER preempts lower. Victims are picked from
    # strictly-lower-priority tiers first; a tier's own sequences are only
    # preempted by their own tier (never by a lower one).
    priority: int = 0
    # Per-tier concurrent-request admission budget (serving layer): the
    # (max_concurrent+1)-th in-flight request of this tier is shed with
    # 429 + Retry-After while other tiers' admission is untouched.
    # None = unbounded (the global admission machinery still applies).
    max_concurrent: Optional[int] = None
    # Per-tier TTFT budget for the PR-2 queue-wait shedder, applied to
    # requests of this tier that carry no explicit x-kgct-ttft-budget-ms
    # header. None = fall through to the operator-wide default.
    ttft_budget_ms: Optional[float] = None
    # Tenant keys (the request's ``session_id``/``user`` value) pinned to
    # this tier when no explicit x-kgct-qos-tier header names one.
    users: tuple[str, ...] = ()


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    """Continuous-batching scheduler limits (the hot loop the reference only
    shaped indirectly via maxModelLen / gpuMemoryUtilization, SURVEY §3.4)."""
    max_num_seqs: int = 64             # max sequences resident per step
    max_prefill_tokens: int = 2048     # token budget per prefill step
    # Shape bucketing to keep the XLA jit cache small: decode batch sizes and
    # prefill token counts are padded up to these buckets.
    decode_buckets: tuple[int, ...] = (1, 2, 4, 8, 16, 32, 64)
    prefill_buckets: tuple[int, ...] = (128, 256, 512, 1024, 2048)
    # Multi-step decode: run this many autoregressive decode steps inside one
    # XLA program (sampled tokens feed back on-device via lax.scan), so host
    # round-trips happen once per window, not once per token. Stop conditions
    # are checked on the host after each window; tokens generated past a stop
    # are discarded.
    decode_window: int = 8
    # Automatic prefix caching (vLLM enablePrefixCaching parity): completed
    # prompts' full KV pages are content-addressed and reused by later
    # requests sharing a page-aligned prefix (engine/kv_cache.PrefixCache).
    enable_prefix_caching: bool = False
    # Stall-free mixed prefill/decode batching (Sarathi-Serve-style): when
    # running decodes and waiting prefill work coexist, one device step
    # carries every running sequence's decode token PLUS a budgeted chunk of
    # the queue-head prompt — prefills no longer stall decode and decode no
    # longer starves prefill (engine/mixed_batch.py). ON by default since the
    # PR-3 CPU A/B showed sustained p50 TTFT 2408->2117 ms with mixing on;
    # serving opts out via --disable-mixed-batch, bench via
    # KGCT_BENCH_MIXED=0 (legacy prefill-else-decode policy).
    mixed_batch_enabled: bool = True
    # Per-mixed-step token budget. Decode rows claim their tokens FIRST
    # (decode is never dropped from a mixed step); the head prompt's chunk
    # fills the remainder, still capped by max_prefill_tokens. None = use
    # max_prefill_tokens as the mixed budget.
    decode_priority_token_budget: Optional[int] = None
    # Speculative decoding (engine/spec/): pure-decode steps draft
    # num_speculative_tokens per running sequence with an n-gram
    # prompt-lookup proposer (no draft model) and verify all drafts in ONE
    # dispatched device program; acceptance is exact-match for greedy and
    # lossless rejection sampling for sampled decode, so outputs keep the
    # target distribution. Off by default: serving enables it via
    # --enable-spec-decode, bench via KGCT_BENCH_SPEC.
    spec_decode_enabled: bool = False
    # Draft length k per spec step. STATIC: the verify program compiles per
    # (decode bucket) at token width B_pad * (k + 1), so k is part of the
    # bounded compile-shape grid, never a runtime dimension.
    num_speculative_tokens: int = 4
    # Prompt-lookup window: the proposer matches the sequence's trailing
    # n-gram (n from max down to min) against its own prompt+output history
    # and drafts the continuation of the most recent match.
    spec_ngram_max: int = 3
    spec_ngram_min: int = 1
    # Draft-MODEL speculative decoding (engine/spec/draft_model.py): name of
    # a second, small model preset (e.g. tinyllama-1.1b drafting for
    # llama-3-8b) run by the SAME engine process with its own paged KV pool.
    # It replaces the n-gram proposer: k draft tokens per spec step come
    # from k cheap greedy decode dispatches of the draft model, batched
    # across all spec rows. None (default) keeps prompt-lookup drafting.
    # The draft vocab must match the target's (drafts are target token ids).
    spec_draft_model: Optional[str] = None
    # Acceptance-adaptive k (engine/spec/adaptive.py): shrink/grow the
    # per-step draft length from the rolling acceptance ratio, bounded to a
    # pow-2 ladder in [0, spec_k_max] so the compile family stays one
    # variant per (ladder rung, decode bucket). k=0 degrades to plain
    # decode (and plain mixed batching); a cooldown re-probes at k=1 so a
    # workload shift back toward draftable text is noticed.
    spec_adaptive_k: bool = False
    # Ceiling for the adaptive ladder. None = num_speculative_tokens.
    spec_k_max: Optional[int] = None
    # Multi-tenant QoS (engine/qos.py): the configured priority classes.
    # EMPTY (default) disables the whole QoS layer and is byte-identical
    # to the tier-less scheduler — promotion, priority preemption, and
    # virtual-token accounting never run. Parse operator JSON with
    # engine/qos.parse_qos_tiers (validates names/weights/duplicates).
    qos_tiers: tuple[QoSTier, ...] = ()
    # Tier applied to requests that name none (no header, no user match).
    # None = the first configured tier.
    qos_default_tier: Optional[str] = None

    @property
    def effective_spec_k_max(self) -> int:
        """Draft-length ceiling: the adaptive ladder's top rung, and the k
        the proposer is built for."""
        return (self.spec_k_max if self.spec_k_max is not None
                else self.num_speculative_tokens)


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    """Device-mesh axes. TP rides ICI within a slice; PP/DP may cross hosts
    over DCN (replaces the reference's NCCL TP + Ray PP,
    values-01-minimal-example8.yaml:37-38 and ...4.yaml:18)."""
    tp: int = 1    # tensor parallel (attention heads / MLP shards)
    pp: int = 1    # pipeline parallel (layer stages)
    dp: int = 1    # data parallel (replicated engine)
    ep: int = 1    # expert parallel (MoE experts)
    sp: int = 1    # sequence parallel (ring-attention prefill, long context)
    # Debug: after every step all ranks compare a hash of the step's
    # tokens (one extra collective per step) and raise when they differ.
    lockstep_check: bool = False

    @property
    def world_size(self) -> int:
        return self.tp * self.pp * self.dp * self.ep * self.sp


@dataclasses.dataclass(frozen=True)
class ResilienceConfig:
    """Fault-tolerance knobs (kubernetes_gpu_cluster_tpu.resilience): TTFT
    deadlines + load shedding, the engine step watchdog, graceful drain, and
    multihost failure detection. Defaults keep pre-existing behavior except
    where detection is pure upside (watchdog, heartbeats)."""
    # Default TTFT budget applied to requests that carry no
    # x-kgct-ttft-budget-ms header; None = admit everything (no shedding).
    default_ttft_budget_ms: Optional[float] = None
    # Queue-wait estimator quantile over kgct_queue_wait_seconds.
    admission_quantile: float = 0.9
    # A step running longer than this flips /health (hung device dispatch).
    # The default must exceed the WORST first-use XLA compile: the engine
    # compiles one program per (kind, bucketed shape) lazily inside the
    # first step that needs it (60-180 s for big models on TPU), and a
    # tighter default would crash-loop pods during normal warm-up. Tighten
    # per-deployment once the shape set is warm.
    watchdog_timeout_s: float = 300.0
    # SIGTERM drain: max wait for in-flight requests before exiting anyway.
    drain_grace_s: float = 120.0
    # Multihost leader->follower heartbeat cadence, and how long a follower
    # tolerates silence (no directives, no heartbeats) before declaring the
    # leader dead and group-aborting.
    heartbeat_interval_s: float = 2.0
    liveness_timeout_s: float = 10.0


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    model: ModelConfig
    cache: CacheConfig = dataclasses.field(default_factory=CacheConfig)
    scheduler: SchedulerConfig = dataclasses.field(default_factory=SchedulerConfig)
    parallel: ParallelConfig = dataclasses.field(default_factory=ParallelConfig)
    resilience: ResilienceConfig = dataclasses.field(
        default_factory=ResilienceConfig)
    max_model_len: Optional[int] = None  # override model.max_model_len
    seed: int = 0
    enforce_eager: bool = False          # parity with vllm --enforce-eager: no CUDA
                                         # graph capture of the decode window
                                         # (debug only; always slower)

    @property
    def effective_max_len(self) -> int:
        return self.max_model_len or self.model.max_model_len

    @staticmethod
    def from_model_name(name: str, **kw) -> "EngineConfig":
        return EngineConfig(model=get_model_config(name), **kw)
