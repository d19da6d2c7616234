"""Multi-tenant QoS: tier parsing + weighted fair-share accounting.

The scheduler serves heterogeneous traffic off one page pool, and before
this layer every admitted request was scheduled equally — one tenant's
8k-token batch job degraded every other tenant's chat TTFT. Tiers
(config.QoSTier) make *who* is asking a scheduling input:

- **Weighted fair sharing** via virtual-token counting (WFQ/SFQ-style):
  each tier carries a virtual clock that advances by
  ``served_tokens / weight`` whenever the scheduler grants it service
  (prefill chunk tokens, decode rows). The scheduler prefers the waiting
  tier with the SMALLEST virtual clock, so a tier's deficit accrues while
  it waits and no class starves — a weight-4 interactive tier gets ~4x
  the admission service of a weight-1 batch tier under contention, and
  the batch tier still drains (its clock falls behind and eventually
  wins the comparison).
- **Priority preemption**: under page/seat pressure, victims are chosen
  from strictly-lower-priority tiers first (youngest within the tier,
  preserving the single-tier policy's churn properties); a tier's own
  sequences are only ever preempted by their own tier.
- **Idle catch-up**: a tier that re-activates after idling has its clock
  raised to the minimum active clock (start-time fair queuing), so
  sleeping does not bank unbounded credit it could later burn while
  starving everyone else.

MUTATION DISCIPLINE (KGCT015 ``tenant-accounting-safety``): the
``virtual_tokens`` clocks are only ever written by :meth:`charge` /
:meth:`sync_active` here, and those methods are only called from the
scheduler's fair-share seam (engine/scheduler.py + engine/mixed_batch.py).
Serving-layer code reads snapshots; it never accounts. Ad-hoc accounting
would silently skew every subsequent fairness decision, exactly like a
stray ``Replica.inflight`` write skews the router (KGCT011).

``parse_qos_tiers`` is the one operator-JSON entry point, shared by the
API-server CLI, the router CLI, and the deploy renderer — one validation,
three surfaces.
"""

from __future__ import annotations

from typing import Optional

from ..config.engine_config import QoSTier
# Re-exported parsing/resolution half — config/qos.py is the home so the
# router can import it without pulling the engine package in; engine-side
# callers keep this module as their one stop.
from ..config.qos import (DEFAULT_TIERS_JSON, TIER_NAME_RE,  # noqa: F401
                          parse_qos_tiers, resolve_tier_name,
                          tenant_key_of, tiers_to_json)

class QoSAccounting:
    """Per-tier virtual-token clocks + the fairness/priority decisions the
    scheduler consults. One instance per scheduler; None = QoS off and
    every scheduler path is byte-identical to the tier-less engine."""

    def __init__(self, tiers: tuple[QoSTier, ...],
                 default_tier: Optional[str] = None):
        if not tiers:
            raise ValueError("QoSAccounting requires at least one tier")
        self.tiers: dict[str, QoSTier] = {t.name: t for t in tiers}
        if len(self.tiers) != len(tiers):
            raise ValueError("duplicate qos tier names")
        self.default_tier = (default_tier if default_tier in self.tiers
                             else tiers[0].name)
        # The WFQ virtual clocks (tokens / weight). Mutated ONLY by
        # charge() / sync_active() — the KGCT015 seam.
        self.virtual_tokens: dict[str, float] = {n: 0.0 for n in self.tiers}
        # Cumulative raw service per tier (observability: the scheduler's
        # served-token attribution, rendered as a counter).
        self.served_tokens: dict[str, int] = {n: 0 for n in self.tiers}
        self._active: set = set()
        # Monotone system virtual time (SFQ): the high-water of "minimum
        # clock among settled active tiers" ever observed. Re-activating
        # tiers floor to IT — not to the instantaneous active minimum —
        # so a tier that re-enters ALONE (nothing else active to compare
        # against) still forfeits the credit it banked while idle.
        self._vtime = 0.0

    # -- resolution ----------------------------------------------------------

    def resolve(self, name: Optional[str]) -> str:
        """Request-carried tier name -> configured tier name (unknown/None
        falls to the default: the serving layer already 400'd explicit
        unknowns, so anything else here is an internal caller)."""
        return name if name in self.tiers else self.default_tier

    def tier_of(self, seq) -> QoSTier:
        return self.tiers[self.resolve(getattr(seq.params, "qos_tier",
                                               None))]

    def priority_of(self, seq) -> int:
        return self.tier_of(seq).priority

    # -- the fair-share seam (scheduler-only mutation, KGCT015) --------------

    def charge(self, tier_name: str, tokens: int) -> None:
        """Advance ``tier_name``'s virtual clock by ``tokens`` of granted
        service. Called at batch-assembly time from the scheduler paths
        (full prefill, chunk, decode rows) — never from serving code."""
        if tokens <= 0:
            return
        tier = self.tiers[self.resolve(tier_name)]
        self.virtual_tokens[tier.name] += tokens / tier.weight
        self.served_tokens[tier.name] += tokens

    def sync_active(self, active_names) -> None:
        """Start-time-fair-queuing catch-up, called once per schedule()
        with the tiers that currently have work (waiting/running/swapped):
        a tier that was idle re-enters at the SYSTEM virtual time (the
        monotone high-water of the settled tiers' minimum clock), so
        idleness banks no credit — even when the tier re-activates alone,
        with no settled tier left to compare against. Clocks of
        still-active tiers are never touched — their deficit is the
        fairness signal."""
        active = {self.resolve(n) for n in active_names}
        fresh = active - self._active
        settled = active - fresh
        if settled:
            self._vtime = max(self._vtime,
                              min(self.virtual_tokens[n] for n in settled))
        for name in fresh:
            if self.virtual_tokens[name] < self._vtime:
                self.virtual_tokens[name] = self._vtime
        self._active = active

    # -- decisions (read-only) -----------------------------------------------

    def pick_tier(self, waiting_names) -> Optional[str]:
        """The waiting tier owed the most service: smallest virtual clock,
        ties broken by (priority desc, name) so the choice is total and
        deterministic."""
        best = None
        for name in {self.resolve(n) for n in waiting_names}:
            key = (self.virtual_tokens[name], -self.tiers[name].priority,
                   name)
            if best is None or key < best[0]:
                best = (key, name)
        return best[1] if best else None

    def owes(self, debtor: str, creditor: str) -> bool:
        """True when ``debtor``'s clock has run ahead of ``creditor``'s —
        i.e. the creditor tier is owed service relative to fair share.
        The chunk-defer and restore-defer gates pair this with a strict
        priority comparison, so equal-priority tiers never defer each
        other and the gate self-releases as the creditor is served (its
        clock catches up and the comparison flips)."""
        return (self.virtual_tokens[self.resolve(debtor)]
                >= self.virtual_tokens[self.resolve(creditor)])

    def snapshot(self) -> dict:
        """Read-only view for /metrics and debugging."""
        return {"virtual_tokens": dict(self.virtual_tokens),
                "served_tokens": dict(self.served_tokens),
                "default_tier": self.default_tier}


def build_qos(sc) -> Optional[QoSAccounting]:
    """SchedulerConfig -> accounting, or None when no tiers are configured
    (the byte-identity contract: None means no QoS branch ever runs)."""
    if not sc.qos_tiers:
        return None
    return QoSAccounting(sc.qos_tiers, default_tier=sc.qos_default_tier)
