"""Deterministic fault injection (``KGCT_FAULT``).

Every recovery path in the serving stack has a named injection point; chaos
tests (and operators reproducing an incident) arm them through one env var
instead of trusting the path on inspection:

    KGCT_FAULT="replica_hang:p=1;step_stall:after=10,delay=0.5"

Grammar::

    spec  := rule (';' rule)*
    rule  := site (':' param (',' param)*)?
    param := key '=' value

Sites are free-form strings checked by the code that owns the injection
point (grep for ``inject(`` / ``fault_value(``):

- ``router_connect``   router: upstream connect raises (connect-phase
                       failure -> bounded-backoff failover path)
- ``replica_hang``     router: upstream stream read raises a simulated
                       read-timeout (stalled replica -> circuit break)
- ``replica_down``     router: the health probe of replica index ``value``
                       is forced to fail (drained/dead replica -> its
                       ring-owned keys remap to the ring successor)
- ``step_stall``       engine: step() sleeps ``delay`` seconds (hung device
                       dispatch -> watchdog trip)
- ``broadcast_fail``   multihost leader: directive broadcast raises
                       (dead follower -> group abort)
- ``queue_wait_est``   admission controller: the queue-wait estimate is
                       forced to ``value`` seconds (deterministic shedding)
- ``kv_swap_fail``     kv swapper: swap-out raises (two-tier KV cache ->
                       graceful recompute-preemption fallback)
- ``kv_handoff_fail``  decode replica: the disaggregated KV-handoff pull
                       raises before contacting the prefill replica ->
                       graceful local-recompute fallback
- ``replica_kill_midstream``  router: the upstream socket is severed after
                       N relayed chunks (param ``after``) -> transparent
                       mid-stream failover to a ring successor via
                       /internal/resume (truncated-error rung when resume
                       is impossible)
- ``migrate_fail``     draining replica: the live-migration export/push
                       raises before the sequence detaches -> per-sequence
                       fallback to the wait-it-out drain path
- ``tenant_flood``     admission controller (multi-tenant QoS): the
                       LOWEST-priority tier's offered load is inflated by
                       ``value`` phantom in-flight requests, so that tier
                       deterministically blows its max_concurrent budget
                       and absorbs 429s while higher tiers' admission is
                       untouched (the overload-isolation chaos drill)
- ``kv_wire_corrupt``  KV wire plane: a byte of the encoded frame is
                       flipped IN TRANSIT at the client/push seam (fleet
                       pull chunk, handoff pull blob, migration push,
                       spill frame) -> the integrity layer must detect
                       it, abort the import, recompute byte-identically,
                       and decay the peer's score toward quarantine
- ``peer_stale_frame`` KV wire plane, serve side: the exporter serves a
                       frame with a mismatched model header (default) or,
                       with ``value`` = 1, speaks the pre-integrity wire
                       dialect -> the receiver's model check / protocol
                       negotiation rejects it loudly (426-style) instead
                       of attempting a decode

Params (all optional): ``p`` fire probability in [0, 1] (default 1; drawn
from a PRIVATE ``random.Random(seed)`` per rule, so sequences are
deterministic and independent of global RNG state), ``after`` skip the
first N checks (default 0), ``times`` maximum fires (default unlimited),
``delay`` seconds slept in-line whenever the rule fires, ANY site (default
0 — hang-style sites like ``step_stall`` set it explicitly), ``value`` free
scalar for sites that need one, ``seed`` the p-draw seed (default 0).

The injector is process-global and read on the hot path as one ``is None``
check when no spec is armed — serving pays nothing for the capability.
"""

from __future__ import annotations

import os
import random
import threading
import time
from typing import Optional

from ..utils import get_logger

logger = get_logger("resilience.faults")


class FaultRule:
    def __init__(self, site: str, p: float = 1.0, after: int = 0,
                 times: Optional[int] = None, delay: float = 0.0,
                 value: float = 0.0, seed: int = 0):
        if not 0.0 <= p <= 1.0:
            raise ValueError(f"fault {site!r}: p={p} outside [0, 1]")
        if after < 0:
            raise ValueError(f"fault {site!r}: after={after} negative")
        self.site = site
        self.p = p
        self.after = after
        self.times = times
        self.delay = delay
        self.value = value
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self.calls = 0
        self.fires = 0

    def should_fire(self) -> bool:
        """One check at the injection point; deterministic given the rule's
        construction (counters + private seeded RNG, never wall clock)."""
        with self._lock:
            self.calls += 1
            if self.calls <= self.after:
                return False
            if self.times is not None and self.fires >= self.times:
                return False
            if self.p < 1.0 and self._rng.random() >= self.p:
                return False
            self.fires += 1
            return True


def _parse_rule(text: str) -> FaultRule:
    site, _, params_text = text.partition(":")
    site = site.strip()
    if not site:
        raise ValueError(f"KGCT_FAULT rule {text!r}: empty site")
    kw: dict = {}
    if params_text:
        for param in params_text.split(","):
            key, sep, value = param.partition("=")
            key = key.strip()
            if not sep or key not in ("p", "after", "times", "delay",
                                      "value", "seed"):
                raise ValueError(
                    f"KGCT_FAULT rule {text!r}: bad param {param!r} "
                    "(known: p, after, times, delay, value, seed)")
            kw[key] = (int(value) if key in ("after", "times", "seed")
                       else float(value))
    return FaultRule(site, **kw)


class FaultInjector:
    def __init__(self, spec: str):
        self.spec = spec
        self.rules: dict[str, FaultRule] = {}
        for part in spec.split(";"):
            part = part.strip()
            if not part:
                continue
            rule = _parse_rule(part)
            if rule.site in self.rules:
                raise ValueError(
                    f"KGCT_FAULT: duplicate site {rule.site!r}")
            self.rules[rule.site] = rule

    def fires(self, site: str) -> Optional[FaultRule]:
        rule = self.rules.get(site)
        if rule is not None and rule.should_fire():
            logger.warning("KGCT_FAULT firing: %s (fire %d)", site,
                           rule.fires)
            return rule
        return None


_injector: Optional[FaultInjector] = None
_loaded = False


def get_injector() -> Optional[FaultInjector]:
    """The process-global injector, lazily parsed from KGCT_FAULT once (a
    bad spec fails loudly at the FIRST injection-point check, not silently)."""
    global _injector, _loaded
    if not _loaded:
        spec = os.environ.get("KGCT_FAULT", "")
        _injector = FaultInjector(spec) if spec.strip() else None
        _loaded = True
    return _injector


def configure_faults(spec: Optional[str]) -> Optional[FaultInjector]:
    """Install (or clear, with None/empty) the injector programmatically —
    the chaos-test entry point; also lets an embedded server re-arm without
    process restart."""
    global _injector, _loaded
    _injector = FaultInjector(spec) if spec and spec.strip() else None
    _loaded = True
    return _injector


def inject(site: str) -> bool:
    """Check-and-fire at an injection point. A rule with ``delay`` > 0
    sleeps here — whatever the site — simulating the stall in-line; returns
    True iff the rule fired (callers that need to RAISE decide what to
    raise — the failure type belongs to the injection point, not the
    harness)."""
    injector = get_injector()
    if injector is None:
        return False
    rule = injector.fires(site)
    if rule is None:
        return False
    if rule.delay > 0:
        time.sleep(rule.delay)
    return True


def fault_value(site: str) -> Optional[float]:
    """Fire a value-carrying site and return its ``value`` (None when not
    armed / not firing) — e.g. a forced queue-wait estimate."""
    injector = get_injector()
    if injector is None:
        return None
    rule = injector.fires(site)
    return rule.value if rule is not None else None
