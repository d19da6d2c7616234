"""Prometheus-format serving metrics (/metrics endpoint).

The families are the JAX package's, name for name: tok/s, TTFT under
continuous batching, preemptions, KV page occupancy, device memory.

Counters come from engine.EngineStats (filled inside the step loop) and
scheduler/allocator state; latency distributions are REAL histograms
(``_bucket``/``_sum``/``_count`` with outcome labels, rendered by the
engine's Observability) so Prometheus can compute any quantile across
replicas — the two-point host-side summaries this module used to emit
could not aggregate. Text format per the exposition spec, scrapeable
without any client library; nan-free by construction even on a freshly
started server.
"""

from __future__ import annotations

import time

from ..engine.engine import device_memory_stats


class Metrics:
    def __init__(self, engine):
        self.engine = engine               # LLMEngine
        self.requests_total = 0
        self.responses_total = 0
        self.response_tokens_total = 0
        self._started = time.monotonic()

    # -- hooks called by the API layer --------------------------------------

    def on_request(self) -> None:
        self.requests_total += 1

    def on_finish(self, n_tokens: int) -> None:
        """HTTP-layer completion: counts responses actually delivered to
        clients (engine-side requests_finished also covers aborts/terminated
        sequences, so the two legitimately differ under churn)."""
        self.responses_total += 1
        self.response_tokens_total += n_tokens

    # -- rendering ----------------------------------------------------------

    def render(self) -> str:
        eng = self.engine
        stats = eng.stats
        sched = eng.scheduler
        alloc = sched.allocator
        lines = [
            "# TYPE kgct_requests_total counter",
            f"kgct_requests_total {self.requests_total}",
            "# TYPE kgct_responses_total counter",
            f"kgct_responses_total {self.responses_total}",
            "# TYPE kgct_response_tokens_total counter",
            f"kgct_response_tokens_total {self.response_tokens_total}",
            "# TYPE kgct_requests_finished_total counter",
            f"kgct_requests_finished_total {stats.requests_finished}",
            "# TYPE kgct_tokens_generated_total counter",
            f"kgct_tokens_generated_total {stats.tokens_generated}",
            "# TYPE kgct_prefill_tokens_total counter",
            f"kgct_prefill_tokens_total {stats.prefill_tokens}",
            "# TYPE kgct_engine_steps_total counter",
            f"kgct_engine_steps_total {stats.steps}",
            # Split by kind: "swap" preemptions park KV in
            # host DRAM and resume via memcpy, "recompute" ones burn a full
            # re-prefill — the ratio is the two-tier cache's value signal.
            "# TYPE kgct_preemptions_total counter",
            'kgct_preemptions_total{kind="recompute"} %d'
            % sched.num_preemptions_by_kind["recompute"],
            'kgct_preemptions_total{kind="swap"} %d'
            % sched.num_preemptions_by_kind["swap"],
            "# TYPE kgct_num_waiting gauge",
            f"kgct_num_waiting {len(sched.waiting)}",
            "# TYPE kgct_num_running gauge",
            f"kgct_num_running {len(sched.running)}",
            "# TYPE kgct_num_swapped gauge",
            f"kgct_num_swapped {len(sched.swapped)}",
            "# TYPE kgct_kv_pages_total gauge",
            f"kgct_kv_pages_total {alloc.num_pages}",
            "# TYPE kgct_kv_pages_free gauge",
            f"kgct_kv_pages_free {alloc.num_free}",
            "# TYPE kgct_uptime_seconds gauge",
            f"kgct_uptime_seconds {time.monotonic() - self._started:.1f}",
        ]
        # Prefix-cache reuse (engine/kv_cache.PrefixCache counts lookups;
        # nothing scraped them until now). Emitted unconditionally — zeros
        # when caching is off or nothing was looked up yet — so a fresh
        # scrape is nan-free and dashboards need no existence check.
        pc = sched.prefix_cache
        hits = pc.hits if pc is not None else 0
        misses = pc.misses if pc is not None else 0
        looked = hits + misses
        lines += [
            "# TYPE kgct_prefix_cache_hit_ratio gauge",
            f"kgct_prefix_cache_hit_ratio {hits / looked if looked else 0.0}",
            "# TYPE kgct_prefix_cache_hits_total counter",
            f"kgct_prefix_cache_hits_total {hits}",
            "# TYPE kgct_prefix_cache_misses_total counter",
            f"kgct_prefix_cache_misses_total {misses}",
            # Second-chance restores of host-spilled prefix pages.
            "# TYPE kgct_prefix_cache_host_hits_total counter",
            "kgct_prefix_cache_host_hits_total %d"
            % (pc.host_hits if pc is not None else 0),
        ]
        # Host KV tier occupancy (two-tier cache). Zeros when swap is off —
        # a fresh scrape stays nan-free and dashboards need no existence
        # check, same contract as the prefix-cache series above.
        swapper = getattr(eng, "swapper", None)
        host_total = swapper.host.num_pages if swapper is not None else 0
        host_used = swapper.host.num_in_use if swapper is not None else 0
        lines += [
            "# TYPE kgct_kv_host_pages_total gauge",
            f"kgct_kv_host_pages_total {host_total}",
            "# TYPE kgct_kv_host_pages_in_use gauge",
            f"kgct_kv_host_pages_in_use {host_used}",
        ]
        # Device telemetry (autoscaler inputs): the card's memory and the
        # caching allocator's live bytes (0/0 on the CPU — nan-free), and
        # the step programs built: every family's captured graphs, one per
        # key seen (the same keys on the CPU, 0 with --enforce-eager or
        # under torch.distributed). A gauge
        # despite the _total spelling, as in the JAX package, where it
        # reads a live cache that can shrink.
        hbm_limit, hbm_in_use = device_memory_stats(eng.device)
        lines += [
            "# TYPE kgct_hbm_bytes_limit gauge",
            f"kgct_hbm_bytes_limit {hbm_limit}",
            "# TYPE kgct_hbm_bytes_in_use gauge",
            f"kgct_hbm_bytes_in_use {hbm_in_use}",
            "# TYPE kgct_jit_compiles_total gauge",
            f"kgct_jit_compiles_total {eng.compiled_step_variants()}",
        ]
        # Histograms (TTFT/TPOT/queue-wait/prefill/step/batch-size/e2e),
        # per-phase step-time counters, and the sampled-decode-ratio gauge —
        # all owned by the engine's Observability.
        lines.extend(eng.obs.render_prometheus())
        return "\n".join(lines) + "\n"
