"""KGCT015 tenant-accounting-safety: QoS fairness clocks mutate only in
the scheduler's fair-share seam.

The multi-tenant QoS layer's one distribution-correctness contract
(engine/qos.py): every weighted-fair decision — admission promotion, the
chunk/restore defer gates, priority preemption — reads the per-tier
``virtual_tokens`` clocks, and those clocks are only meaningful if EVERY
grant of service is charged exactly once, at batch-assembly time, by the
scheduler. The sanctioned mutation surface is:

- direct writes to ``virtual_tokens`` (and the ``served_tokens`` /
  ``_active`` companions) inside ``engine/qos.py`` itself — the
  ``charge``/``sync_active`` method bodies;
- calls to the mutating methods ``charge``/``sync_active`` on a qos
  accounting object from the scheduler seam only: ``engine/scheduler.py``
  and ``engine/mixed_batch.py`` (the mixed assembler mutates scheduler
  state exactly like the pure paths do).

Anything else — a serving handler bumping a tier's clock to "help" a
tenant, a metrics renderer charging on scrape, a bench loop double-
counting — would skew every subsequent fairness comparison for the life
of the process, the same failure class as a stray ``Replica.inflight``
write in the router (KGCT011). Per-tier ADMISSION ledgers
(``tier_inflight``/``shed_by_tier`` in resilience/deadline.py) are a
different mechanism with serving-side accounting pairs and are NOT
covered here.

Fires on, anywhere in the package:

- an assignment / augmented assignment whose target is (a subscript of)
  an attribute named ``virtual_tokens`` or ``served_tokens``, outside
  ``engine/qos.py``;
- a call to ``<x>.charge(...)`` or ``<x>.sync_active(...)`` where the
  receiver chain mentions ``qos``, outside ``engine/scheduler.py`` /
  ``engine/mixed_batch.py`` / ``engine/qos.py``.
"""

from __future__ import annotations

import ast
import re
from typing import Iterator

from ..core import Finding, LintModule, Rule

_CLOCK_ATTRS = frozenset({"virtual_tokens", "served_tokens"})
_MUTATORS = frozenset({"charge", "sync_active"})
# The sanctioned seam, module-relative paths (forward slashes).
_CLOCK_HOME = re.compile(r"(^|/)engine/qos\.py$")
_SEAM = re.compile(r"(^|/)engine/(scheduler|mixed_batch|qos)\.py$")


def _target_attr(node: ast.AST):
    """The attribute a (possibly subscripted) store targets, else None:
    ``x.virtual_tokens = ...``, ``x.virtual_tokens[n] += ...``."""
    if isinstance(node, ast.Subscript):
        node = node.value
    if isinstance(node, ast.Attribute):
        return node.attr
    return None


def _mentions_qos(node: ast.AST) -> bool:
    """Does the receiver chain read a qos accounting object?"""
    for sub in ast.walk(node):
        if isinstance(sub, ast.Attribute) and "qos" in sub.attr.lower():
            return True
        if isinstance(sub, ast.Name) and "qos" in sub.id.lower():
            return True
    return False


class TenantAccountingSafetyRule(Rule):
    code = "KGCT015"
    name = "tenant-accounting-safety"
    description = ("per-tenant virtual-token/deficit clocks mutated outside "
                   "the scheduler's fair-share seam")

    def check(self, mod: LintModule) -> Iterator[Finding]:
        rel = mod.relpath.replace("\\", "/")
        clock_home = bool(_CLOCK_HOME.search(rel))
        in_seam = bool(_SEAM.search(rel))
        for node in ast.walk(mod.tree):
            if not clock_home:
                targets: list = []
                if isinstance(node, ast.AugAssign):
                    targets = [node.target]
                elif isinstance(node, ast.Assign):
                    targets = list(node.targets)
                elif isinstance(node, ast.AnnAssign):
                    targets = [node.target]
                for t in targets:
                    attr = _target_attr(t)
                    if attr in _CLOCK_ATTRS:
                        yield self.finding(
                            mod, node,
                            f"direct write to the QoS fairness clock "
                            f"{attr!r} outside engine/qos.py — the clocks "
                            "are only meaningful when every grant is "
                            "charged once through QoSAccounting.charge "
                            "from the scheduler seam")
            if in_seam:
                continue
            if isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and node.func.attr in _MUTATORS \
                    and _mentions_qos(node.func.value):
                yield self.finding(
                    mod, node,
                    f"QoS accounting mutator {node.func.attr!r} called "
                    "outside the scheduler's fair-share seam "
                    "(engine/scheduler.py, engine/mixed_batch.py) — "
                    "ad-hoc charging skews every subsequent weighted-fair "
                    "decision")
