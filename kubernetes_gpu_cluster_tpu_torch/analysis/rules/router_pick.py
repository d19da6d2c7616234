"""KGCT011 router-pick-path: replica selection flows through ``_pick``.

The fleet router's one distribution-correctness contract
(serving/router.py): every replica choice — first attempt, connect-phase
retry-with-exclude, desperation rounds — goes through the single ``_pick``
seam, because that seam is where ALL the policy invariants live at once
(bounded-load affinity walk, deterministic tie-break, health/bench/exclude
filtering, affinity accounting). A second ad-hoc selection site would
bypass the ring (scattering sessions off their warm replica), skip the
load bound, and desynchronize the tie-break sequence two routers must
share to replay identically. Likewise ``Replica.inflight`` is the load
signal both policies balance on: the ONLY sanctioned mutations are the
``+= 1 / -= 1`` accounting pairs around a proxied request in
``proxy``/``_forward`` (and field initialization in ``__init__``) — a
stray mutation anywhere else skews every subsequent pick on every policy.

Fires on, in ``serving/`` modules:

- a ``min``/``max``/``sorted`` call over the replica set or their
  ``.inflight`` loads, or a ``random.choice``/``random.randrange``-style
  pick from it, OUTSIDE ``_pick`` — that is a replica selection bypassing
  the seam (READING replicas/inflight for health or metrics rendering
  stays silent: iteration is not selection);
- an assignment/augmented assignment to ``<x>.inflight`` outside
  ``proxy``/``_forward``/``__init__``.

Scope: ``serving/`` (the router and anything embedding it). Other modules
are free to use min/sorted however they like.
"""

from __future__ import annotations

import ast
import re
from typing import Iterator

from ..core import Finding, LintModule, Rule

_SCOPE = re.compile(r"(^|/)serving/")
# Functions sanctioned to SELECT a replica / to mutate inflight.
_PICK_FNS = frozenset({"_pick"})
# proxy holds the prefill-pool pull slot; _forward (its failover loop,
# split out so that slot's try/finally brackets it) holds the main-pool
# pair; _failover_midstream holds the resume-target pair while a
# re-dispatched stream relays (its TARGET is not a load-balanced pick at
# all — it must be the ring successor where the dying replica's migration
# push parked the stream's KV, a state-locality lookup _pick cannot
# express). All three are sanctioned accounting sites.
_INFLIGHT_MUTATION_FNS = frozenset({"proxy", "_forward",
                                    "_failover_midstream", "__init__"})
_SELECTORS = frozenset({"min", "max", "sorted"})
_RANDOM_PICKS = frozenset({"choice", "randrange", "randint", "sample",
                           "shuffle"})


def _mentions_replica_load(node: ast.AST) -> bool:
    """Does this expression read the replica set or its load signal?"""
    for sub in ast.walk(node):
        if isinstance(sub, ast.Attribute) and sub.attr in ("inflight",
                                                           "replicas"):
            return True
        if isinstance(sub, ast.Name) and "replica" in sub.id.lower():
            return True
    return False


class RouterPickPathRule(Rule):
    code = "KGCT011"
    name = "router-pick-path"
    description = ("replica selection outside the router's _pick seam, or "
                   "Replica.inflight mutated outside the proxy accounting "
                   "pair")

    def check(self, mod: LintModule) -> Iterator[Finding]:
        if not _SCOPE.search(mod.relpath.replace("\\", "/")):
            return
        for fn in mod.functions:
            in_pick = fn.name in _PICK_FNS
            for node in ast.walk(fn):
                if mod.enclosing_function(node) is not fn:
                    continue    # nested defs are visited as their own fn
                if (not in_pick and isinstance(node, ast.Call)
                        and self._is_selection(node)):
                    yield self.finding(
                        mod, node,
                        f"replica selection in {fn.name!r} bypasses the "
                        "_pick seam — ring affinity, the load bound, the "
                        "deterministic tie-break, and health/exclude "
                        "filtering only hold when every choice flows "
                        "through Router._pick")
                if (fn.name not in _INFLIGHT_MUTATION_FNS
                        and self._mutates_inflight(node)):
                    yield self.finding(
                        mod, node,
                        f"Replica.inflight mutated in {fn.name!r} — the "
                        "only sanctioned mutations are the proxy/_forward "
                        "+=1/-=1 accounting pairs (and __init__); a stray "
                        "write skews every subsequent load-balanced pick")

    @staticmethod
    def _is_selection(call: ast.Call) -> bool:
        func = call.func
        name = (func.id if isinstance(func, ast.Name)
                else getattr(func, "attr", ""))
        if name in _SELECTORS:
            return any(_mentions_replica_load(a)
                       for a in list(call.args) + [kw.value
                                                   for kw in call.keywords])
        if name in _RANDOM_PICKS:
            return any(_mentions_replica_load(a) for a in call.args)
        return False

    @staticmethod
    def _mutates_inflight(node: ast.AST) -> bool:
        targets: list = []
        if isinstance(node, ast.AugAssign):
            targets = [node.target]
        elif isinstance(node, ast.Assign):
            targets = node.targets
        elif isinstance(node, ast.AnnAssign):
            targets = [node.target]
        return any(isinstance(t, ast.Attribute) and t.attr == "inflight"
                   for t in targets)
