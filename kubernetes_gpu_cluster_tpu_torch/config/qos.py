"""Multi-tenant QoS: tier parsing + resolution (the config half).

The operator-facing surface of the QoS layer: ``parse_qos_tiers`` is the
one ``--qos-tiers`` JSON entry point, shared by the API-server CLI, the
ROUTER CLI, and the deploy renderer — one validation, three surfaces —
and ``resolve_tier_name`` is the one request->tier resolution order both
the router and the replica apply (header > user pin > default), so the
two layers always attribute a request to the same tier. Lives under
``config`` (not ``engine``) so the router can import it WITHOUT pulling
the engine package in — and the router imports even this module lazily,
only when ``--qos-tiers`` is set, so a tier-less router process stays as
light as before. The scheduler-side accounting (virtual-token clocks,
priority decisions) is ``engine/qos.py``.
"""

from __future__ import annotations

import json
import re
from typing import Optional

from .engine_config import QoSTier

# Tier names become Prometheus label values (``tier=``) and HTTP header
# values — a bounded charset keeps KGCT007 metric hygiene green and the
# header round-trippable.
TIER_NAME_RE = re.compile(r"^[A-Za-z0-9_-]{1,32}$")

# ``--qos-tiers default``: the canonical interactive/batch pair the ISSUE
# and README document — chat traffic outweighs and outranks batch jobs.
DEFAULT_TIERS_JSON = ('{"interactive": {"weight": 4, "priority": 10}, '
                      '"batch": {"weight": 1, "priority": 0}}')

_TIER_KEYS = frozenset({"weight", "priority", "max_concurrent",
                        "ttft_budget_ms", "users"})


def parse_qos_tiers(text: Optional[str]) -> tuple[QoSTier, ...]:
    """Operator JSON -> validated tier tuple (insertion order preserved:
    the FIRST tier is the default unless qos_default_tier names another).

    Spelling: ``{"interactive": {"weight": 4, "priority": 10,
    "max_concurrent": 64, "ttft_budget_ms": 1000, "users": ["alice"]},
    "batch": {...}}`` — or the literal ``default`` for the canonical
    interactive/batch pair. Empty/None -> no tiers (QoS off).

    Raises ValueError on anything an operator could typo: non-object
    JSON, bad tier names (label-hygiene charset), unknown keys, non-
    positive weights, duplicate user pins across tiers (one tenant in two
    tiers would make resolution order-dependent)."""
    if text is None or not text.strip():
        return ()
    if text.strip() == "default":
        text = DEFAULT_TIERS_JSON
    try:
        obj = json.loads(text)
    except ValueError as e:
        raise ValueError(f"--qos-tiers is not valid JSON: {e}") from None
    if not isinstance(obj, dict) or not obj:
        raise ValueError("--qos-tiers must be a non-empty JSON object of "
                         "tier name -> spec")
    tiers: list[QoSTier] = []
    seen_users: dict[str, str] = {}
    for name, spec in obj.items():
        if not isinstance(name, str) or not TIER_NAME_RE.match(name):
            raise ValueError(
                f"qos tier name {name!r} must match {TIER_NAME_RE.pattern} "
                "(it becomes a Prometheus label value)")
        if spec is None:
            spec = {}
        if not isinstance(spec, dict):
            raise ValueError(f"qos tier {name!r}: spec must be an object")
        unknown = set(spec) - _TIER_KEYS
        if unknown:
            raise ValueError(
                f"qos tier {name!r}: unknown key(s) "
                f"{', '.join(sorted(unknown))} "
                f"(known: {', '.join(sorted(_TIER_KEYS))})")
        weight = float(spec.get("weight", 1.0))
        if not weight > 0:
            raise ValueError(f"qos tier {name!r}: weight must be > 0")
        mc = spec.get("max_concurrent")
        if mc is not None:
            mc = int(mc)
            if mc < 1:
                raise ValueError(
                    f"qos tier {name!r}: max_concurrent must be >= 1")
        budget = spec.get("ttft_budget_ms")
        if budget is not None:
            budget = float(budget)
            if not budget > 0:
                raise ValueError(
                    f"qos tier {name!r}: ttft_budget_ms must be > 0")
        users = spec.get("users") or ()
        if (not isinstance(users, (list, tuple))
                or not all(isinstance(u, (str, int)) for u in users)):
            raise ValueError(
                f"qos tier {name!r}: users must be a list of tenant keys")
        users = tuple(str(u) for u in users)
        for u in users:
            if u in seen_users:
                raise ValueError(
                    f"tenant key {u!r} pinned to both "
                    f"{seen_users[u]!r} and {name!r}")
            seen_users[u] = name
        tiers.append(QoSTier(name=name, weight=weight,
                             priority=int(spec.get("priority", 0)),
                             max_concurrent=mc, ttft_budget_ms=budget,
                             users=users))
    names = [t.name for t in tiers]
    if len(set(names)) != len(names):
        # Unreachable through json.loads (duplicate object keys collapse)
        # but reachable through programmatic construction — and the deploy
        # renderer's list spelling routes here via tiers_to_json.
        raise ValueError(f"duplicate qos tier names: {names}")
    return tuple(tiers)


def tiers_to_json(tiers: tuple[QoSTier, ...]) -> str:
    """Inverse of :func:`parse_qos_tiers` — the deploy renderer serializes
    validated tiers back into the one CLI spelling."""
    obj: dict = {}
    for t in tiers:
        spec: dict = {"weight": t.weight, "priority": t.priority}
        if t.max_concurrent is not None:
            spec["max_concurrent"] = t.max_concurrent
        if t.ttft_budget_ms is not None:
            spec["ttft_budget_ms"] = t.ttft_budget_ms
        if t.users:
            spec["users"] = list(t.users)
        obj[t.name] = spec
    return json.dumps(obj)


def tenant_key_of(obj) -> Optional[str]:
    """The tenant key of a parsed request body — THE one definition of
    which body field identifies the tenant (``session_id`` beats OpenAI's
    ``user``) and what counts as a scalar key (str/int, bools excluded),
    shared by the router's and the replica's tier resolution so both
    layers attribute a request to the same tier. None when no key is
    derivable (the request falls to the header/default rungs)."""
    if not isinstance(obj, dict):
        return None
    for field in ("session_id", "user"):
        val = obj.get(field)
        if (val is not None and not isinstance(val, bool)
                and isinstance(val, (str, int))):
            return str(val)
    return None


def resolve_tier_name(tiers: tuple[QoSTier, ...],
                      default_tier: Optional[str],
                      header: Optional[str] = None,
                      tenant_key: Optional[str] = None
                      ) -> tuple[Optional[str], Optional[str]]:
    """(tier name, error) — the ONE resolution order, shared by the API
    server and the router so both layers attribute a request identically:
    explicit header beats the tenant key's user pin beats the default.
    ``error`` is set (and the name None) when the header names an
    unconfigured tier — the caller's 400 to give. No tiers configured ->
    (None, None): QoS off, nothing resolves."""
    if not tiers:
        return None, None
    by_name = {t.name: t for t in tiers}
    if header is not None:
        if header not in by_name:
            return None, (f"unknown qos tier {header!r} "
                          f"(configured: {', '.join(by_name)})")
        return header, None
    if tenant_key is not None:
        for t in tiers:
            if str(tenant_key) in t.users:
                return t.name, None
    if default_tier is not None and default_tier in by_name:
        return default_tier, None
    return tiers[0].name, None


