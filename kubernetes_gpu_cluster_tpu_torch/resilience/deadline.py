"""Per-request TTFT deadlines + admission control (load shedding).

Without it, past a fraction of decode capacity every accepted request
queues unboundedly and TTFT balloons for everyone. vLLM-style serving shreds that queue instead of honoring it: a request whose
TTFT budget is already blown BY THE QUEUE IN FRONT OF IT gets an immediate
OpenAI-shaped ``429 + Retry-After`` — the client retries against another
replica (or later) instead of holding a doomed slot, and admitted requests
keep their TTFT. The budget rides ``x-kgct-ttft-budget-ms`` (per request) or
``ResilienceConfig.default_ttft_budget_ms`` (operator default; None = admit
everything).

The queue-wait estimate is intentionally cheap and conservative — three
signals the engine already maintains, no new bookkeeping on the hot path:

- the ``kgct_queue_wait_seconds`` histogram's q-quantile over a SLIDING
  WINDOW (bucket-count deltas against a rotating snapshot, ~window_s to
  2x window_s of history): what requests recently admitted actually waited.
  The raw lifetime histogram never decays, so one past overload episode
  would inflate the estimate — and shed requests — forever on a long-lived
  server;
- current queue depth x mean engine-step duration: the backlog in front of
  this request expressed in steps (each waiting prefill needs at least one
  step before a newcomer is scheduled);
- when every scheduler slot is occupied (the slot-bound regime continuous
  batching lives in under load), expected slot-turnover wait: with S busy
  slots of median-residual ~e2e_q50/2 each, the (depth+1)-th queued request
  waits ~(depth+1) * e2e_q50 / (2S). The step-based term badly
  underestimates here — decode steps are fast, but a newcomer cannot be
  scheduled until a whole running request FINISHES.

The max of the three is the estimate: the histogram lags a building queue
(it only fills when requests get scheduled), the depth/slot terms lead it.
"""

from __future__ import annotations

import math
import time
from typing import Optional

from ..observability.prometheus import quantile_from_counts
from ..utils import get_logger
from .faults import fault_value

logger = get_logger("resilience.deadline")


class AdmissionController:
    def __init__(self, engine, default_budget_ms: Optional[float] = None,
                 quantile: float = 0.9, window_s: float = 30.0):
        self.engine = engine                 # LLMEngine
        self.default_budget_ms = default_budget_ms
        self.quantile = quantile
        self.window_s = window_s
        self.shed_total = 0
        self.last_estimate_s = 0.0
        # Multi-tenant QoS: per-tier admission budgets layered ON TOP of
        # the TTFT-budget shedder — a tier's (max_concurrent+1)-th
        # in-flight request sheds while other tiers' admission is
        # untouched, and every shed is attributed to its tier (bounded
        # label set: configured tier names only). Empty when QoS is off.
        self.tiers: dict[str, object] = {}
        self.qos_default_tier: Optional[str] = None
        self.tier_inflight: dict[str, int] = {}
        self.shed_by_tier: dict[str, int] = {}
        # The tenant_flood chaos target: the LOWEST-priority tier (the
        # canonical batch tier) — resolved once at configure time.
        self._flood_tier: Optional[str] = None
        # Rotating bucket-count snapshots for the windowed quantile: the
        # delta against ``_prev_base`` covers the last 1-2 windows. None
        # means "zeros" (the first window covers everything since start).
        self._base: Optional[list] = None
        self._prev_base: Optional[list] = None
        self._base_t = time.monotonic()

    # -- multi-tenant QoS ----------------------------------------------------

    def configure_tiers(self, tiers, default_tier: Optional[str]) -> None:
        """Install the per-tier budgets (config.QoSTier tuple). Shed and
        inflight accounting render zeros for every configured tier from
        the first scrape on (nan/absent-free dashboards)."""
        self.tiers = {t.name: t for t in tiers}
        self.qos_default_tier = (default_tier if default_tier in self.tiers
                                 else (next(iter(self.tiers))
                                       if self.tiers else None))
        self.tier_inflight = {n: 0 for n in self.tiers}
        self.shed_by_tier = {n: 0 for n in self.tiers}
        self._flood_tier = min(
            self.tiers.values(),
            key=lambda t: (t.priority, t.name)).name if self.tiers else None

    def resolve_tier(self, name: Optional[str]) -> Optional[str]:
        if not self.tiers:
            return None
        return name if name in self.tiers else self.qos_default_tier

    def on_admit(self, tier: Optional[str]) -> None:
        """The serving layer's in-flight accounting pair (called around a
        request's lifetime, NOT the fairness clocks — those are scheduler-
        owned, KGCT015)."""
        tier = self.resolve_tier(tier)
        if tier is not None:
            self.tier_inflight[tier] += 1

    def on_release(self, tier: Optional[str]) -> None:
        tier = self.resolve_tier(tier)
        if tier is not None and self.tier_inflight[tier] > 0:
            self.tier_inflight[tier] -= 1

    def _tier_load(self, tier: str) -> int:
        """This tier's offered load as admission sees it: real in-flight
        requests plus the deterministic ``tenant_flood`` chaos inflation
        (applied to the lowest-priority tier — the canonical flooding
        batch tenant), so chaos tests can pin that the flooded tier
        absorbs every 429 while the others' admission is untouched."""
        load = self.tier_inflight.get(tier, 0)
        if tier == self._flood_tier:
            flood = fault_value("tenant_flood")
            if flood is not None:
                load += int(flood)
        return load

    def _recent_queue_wait_quantile(self) -> float:
        hist = self.engine.obs.queue_wait
        cur = hist.merged_counts()
        now = time.monotonic()
        if now - self._base_t > self.window_s:
            self._prev_base, self._base = self._base, cur
            self._base_t = now
        base = self._prev_base
        counts = (cur if base is None
                  else [a - b for a, b in zip(cur, base)])
        return quantile_from_counts(hist.buckets, counts, self.quantile)

    def estimate_queue_wait_s(self) -> float:
        forced = fault_value("queue_wait_est")
        if forced is not None:
            self.last_estimate_s = forced
            return forced
        obs = self.engine.obs
        sched = self.engine.scheduler
        depth = len(sched.waiting)
        slots = getattr(sched, "max_num_seqs", 0)
        slot_bound = slots and len(sched.running) >= slots
        if depth == 0 and not slot_bound:
            # Nothing queued and a slot is free: the next schedule() admits
            # immediately — the historical quantile would punish a drained
            # server for its past.
            self.last_estimate_s = 0.0
            return 0.0
        recent = self._recent_queue_wait_quantile()
        steps = obs.step_duration
        step_mean = (steps.sum / steps.count) if steps.count else 0.0
        est = max(recent, depth * step_mean)
        if slot_bound:
            e2e = obs.e2e_latency
            if e2e.count:
                est = max(est,
                          (depth + 1) * e2e.quantile(0.5) / (2 * slots))
        self.last_estimate_s = est
        return est

    def check(self, budget_ms: Optional[float],
              tier: Optional[str] = None) -> Optional[float]:
        """None = admit. A float = SHED, and the value is the Retry-After
        seconds to return (>= 1, bounded so clients never park forever).
        ``budget_ms`` None falls back to the tier's TTFT budget (QoS on),
        then the config default; all None admits unconditionally
        (deadline-free requests keep today's behavior).

        ``tier`` engages the per-tier admission budgets: a tier at its
        max_concurrent sheds IMMEDIATELY — whatever the queue estimate —
        and every shed (concurrency or TTFT) is attributed to the tier,
        so one flooding tenant's 429s never show up on another tier's
        ledger."""
        tier = self.resolve_tier(tier)
        tier_cfg = self.tiers.get(tier) if tier is not None else None
        if tier_cfg is not None and tier_cfg.max_concurrent is not None \
                and self._tier_load(tier) >= tier_cfg.max_concurrent:
            self.shed_total += 1
            self.shed_by_tier[tier] += 1
            # Concurrency sheds clear as the tier's own requests finish;
            # a short bounded retry beats parking on the queue estimate.
            est = self.estimate_queue_wait_s()
            return float(min(max(math.ceil(est), 1), 60))
        if budget_ms is None and tier_cfg is not None:
            budget_ms = tier_cfg.ttft_budget_ms
        if budget_ms is None:
            budget_ms = self.default_budget_ms
        if budget_ms is None:
            return None
        est = self.estimate_queue_wait_s()
        if est * 1000.0 <= budget_ms:
            return None
        self.shed_total += 1
        if tier is not None:
            self.shed_by_tier[tier] += 1
        # Advise retrying once the CURRENT backlog should have drained; the
        # cap keeps a pathological estimate from benching a client for
        # minutes against a server that may recover in seconds.
        return float(min(max(math.ceil(est), 1), 60))
