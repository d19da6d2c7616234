"""KGCT019 await-atomicity: no await between a guard read of shared
serving state and the dependent write that claims it.

Every coroutine sharing the event loop interleaves at EVERY ``await``.
The classic serving TOCTOU is therefore lexical:

    if req_id not in self._active:       # guard: read shared state
        result = await self._admit(req)  # suspension point
        self._active[req_id] = result    # claim: dependent write

Two requests with the same id both pass the guard before either claims
— double admission, double KV allocation, the reserve-vs-claim bug the
request-id reservation seam exists to prevent. The rule fires on exactly
this shape inside ``async def``s in ``serving/``: an ``if`` whose test
reads a ``self.<attr>`` container (membership, ``.get()``, subscript,
``is [not] None``, bare/negated truthiness) and whose body claims the
SAME attribute (subscript store, mutating method, rebind) with an
``await`` at or before the claim line.

Sanctioned seams are structural, never allowlisted:

- **sync functions** — the declared atomic-reservation seam
  (``reserve_request_id``/``release_reservation``) is synchronous
  precisely so no interleaving fits between check and claim; a sync def
  cannot suspend, so it cannot race itself on the loop;
- **guard and claim with no await between** — ``if self._http is None:
  self._http = make_session()`` is check-then-act with nothing
  interleaved, which IS atomic on the loop;
- **while-test guards** — a ``while`` re-evaluates its condition after
  every await (the condition-variable idiom), so the stale-guard window
  the rule hunts does not exist.
"""

from __future__ import annotations

import ast
import re
from typing import Iterator, Optional

from ..core import Finding, LintModule, Rule

_SCOPE = re.compile(r"(^|/)serving/")

# Method calls that mutate a container in place: claiming forms.
_MUTATORS = frozenset({
    "add", "append", "appendleft", "insert", "extend", "update",
    "setdefault", "pop", "popleft", "remove", "discard", "clear",
})


def _self_attr(node: ast.AST) -> Optional[str]:
    """'x' for ``self.x``; None for anything else."""
    if (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"):
        return node.attr
    return None


class AwaitAtomicityRule(Rule):
    code = "KGCT019"
    name = "await-atomicity"
    description = ("guard read of shared serving state and dependent "
                   "claim separated by an await — the reserve-then-claim "
                   "TOCTOU window")

    def check(self, mod: LintModule) -> Iterator[Finding]:
        relpath = mod.relpath.replace("\\", "/")
        if not _SCOPE.search(relpath):
            return
        for fn in mod.functions:
            if isinstance(fn, ast.AsyncFunctionDef):
                yield from self._check_fn(mod, fn)

    def _check_fn(self, mod: LintModule, fn: ast.AsyncFunctionDef
                  ) -> Iterator[Finding]:
        for node in ast.walk(fn):
            if not isinstance(node, ast.If):
                continue
            guarded = self._guard_attrs(node.test)
            if not guarded:
                continue
            awaits = [sub for stmt in node.body for sub in ast.walk(stmt)
                      if isinstance(sub, ast.Await)]
            if not awaits:
                continue
            first_await = min(a.lineno for a in awaits)
            for claim, attr in self._claims(node.body, guarded):
                if first_await <= claim.lineno:
                    yield self.finding(
                        mod, claim,
                        f"'self.{attr}' is claimed here after an await "
                        f"(line {first_await}) inside a guard that read it "
                        f"(line {node.lineno}) — every await interleaves "
                        "other coroutines, so two callers can both pass "
                        "the guard before either claims; reserve "
                        "synchronously before the await (atomic "
                        "reservation seam) or re-check after it")

    def _guard_attrs(self, test: ast.AST) -> set:
        """``self.<attr>`` names the guard test reads in race-relevant
        forms: membership, .get(), subscript, is-None, truthiness."""
        attrs: set = set()

        def add(node) -> None:
            a = _self_attr(node)
            if a is not None:
                attrs.add(a)

        # Bare / negated truthiness: `if not self._claimed:`.
        bare = test.operand if (isinstance(test, ast.UnaryOp)
                                and isinstance(test.op, ast.Not)) else test
        add(bare)
        for node in ast.walk(test):
            if isinstance(node, ast.Compare):
                if any(isinstance(op, (ast.In, ast.NotIn, ast.Is, ast.IsNot,
                                       ast.Eq, ast.NotEq))
                       for op in node.ops):
                    add(node.left)
                    for comp in node.comparators:
                        add(comp)
            elif (isinstance(node, ast.Call)
                  and isinstance(node.func, ast.Attribute)
                  and node.func.attr == "get"):
                add(node.func.value)
            elif isinstance(node, ast.Subscript):
                add(node.value)
        return attrs

    def _claims(self, body: list, guarded: set) -> Iterator[tuple]:
        """(node, attr) for every write to a guarded attr in the body."""
        for stmt in body:
            for node in ast.walk(stmt):
                targets: list = []
                if isinstance(node, ast.Assign):
                    targets = node.targets
                elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
                    targets = [node.target]
                for tgt in targets:
                    attr = _self_attr(tgt)          # self.x = ... rebind
                    if attr is None and isinstance(tgt, ast.Subscript):
                        attr = _self_attr(tgt.value)  # self.x[k] = ...
                    if attr in guarded:
                        yield node, attr
                if (isinstance(node, ast.Call)
                        and isinstance(node.func, ast.Attribute)
                        and node.func.attr in _MUTATORS):
                    attr = _self_attr(node.func.value)
                    if attr in guarded:
                        yield node, attr
