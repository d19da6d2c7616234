"""Fault-tolerance subsystem: deadlines, shedding, watchdog, drain, chaos.

Admission control sheds requests whose TTFT budget is already blown by the
queue in front of them instead of queueing them to death
(``deadline.AdmissionController``), a step watchdog flags hung device
dispatch (``watchdog.StepWatchdog``), SIGTERM-triggered graceful drain stops
admissions while in-flight streams finish (``drain.DrainState``), a loop
heartbeat backs a health endpoint (``heartbeat.LoopLiveness``), and a
deterministic ``KGCT_FAULT`` injection harness (``faults``) lets chaos tests
exercise every recovery path without real failures.

``ResilienceHub`` bundles the per-server pieces and renders their Prometheus
series (kgct_requests_shed_total / kgct_watchdog_trips_total /
kgct_drain_state) for serving/metrics.py.
"""

from __future__ import annotations

from .deadline import AdmissionController
from .drain import DrainState
from .faults import FaultInjector, configure_faults, get_injector, inject
from .heartbeat import LoopLiveness
from .watchdog import StepWatchdog

__all__ = ["AdmissionController", "DrainState", "FaultInjector",
           "LoopLiveness", "StepWatchdog", "ResilienceHub",
           "configure_faults", "get_injector", "inject"]


class ResilienceHub:
    """One per API server: the admission controller, watchdog, and drain
    state wired together, plus their /metrics exposition."""

    def __init__(self, admission: AdmissionController,
                 watchdog: StepWatchdog, drain: DrainState):
        self.admission = admission
        self.watchdog = watchdog
        self.drain = drain

    def render_prometheus(self) -> list[str]:
        lines = [
            "# TYPE kgct_requests_shed_total counter",
            f"kgct_requests_shed_total {self.admission.shed_total}",
        ]
        # Per-tier shed attribution inside the same family — label values
        # are the CONFIGURED tier names only (bounded cardinality), zeros
        # from the first scrape, absent entirely when QoS is off.
        lines += [
            f'kgct_requests_shed_total{{tier="{n}"}} '
            f"{self.admission.shed_by_tier[n]}"
            for n in sorted(self.admission.shed_by_tier)]
        if self.admission.tier_inflight:
            lines.append("# TYPE kgct_qos_tier_inflight gauge")
            lines += [
                f'kgct_qos_tier_inflight{{tier="{n}"}} '
                f"{self.admission.tier_inflight[n]}"
                for n in sorted(self.admission.tier_inflight)]
        lines += [
            "# TYPE kgct_watchdog_trips_total counter",
            f"kgct_watchdog_trips_total {self.watchdog.trips}",
            # 0 = serving, 1 = draining, 2 = drained (a gauge: the state is
            # a level, and Prometheus alerts on == 1/2).
            "# TYPE kgct_drain_state gauge",
            f"kgct_drain_state {self.drain.gauge_value}",
        ]
        return lines
