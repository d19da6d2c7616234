"""KGCT017 draft-state-boundary: draft-model KV/param state is written
only through the proposer seam.

The draft-model proposer (engine/spec/draft_model.py) owns a SECOND paged
KV pool plus its own params, page allocator and per-request sync state.
Its correctness contract — the append-only draft pool with
overwritten-before-read rollback, the valid/tail bookkeeping, the page
lifecycle — is maintained entirely inside ``propose_batch``/``retain``.
An engine or scheduler that reaches into that state directly (rebinding
the draft ``kv_cache``, allocating from the draft allocator, mutating a
row's pages) would bypass every one of those invariants with no sanitizer
shadow watching, and the corruption would surface as silently-wrong draft
KV — lossless acceptance masks it as a mysterious acceptance-rate
collapse, the worst kind of perf bug.

Fires on, in ``engine/`` modules OUTSIDE ``engine/spec/``:

- any attribute access that reaches THROUGH a ``spec_proposer`` handle
  (directly, e.g. ``sched.spec_proposer.kv_cache``, or via a local alias
  assigned from one) into draft STATE: ``kv_cache``, ``params``,
  ``allocator``, ``_rows``, ``_decode_fn``, ``_prefill_fn``;
- any ASSIGNMENT through a ``spec_proposer`` handle (mutating proposer
  attributes from outside the seam), except rebinding ``spec_proposer``
  itself — installing a proposer (the engine's construction site, and the
  test suite's proposer-swap idiom) IS the seam.

Silent: the seam itself — ``propose``/``propose_batch``/``retain``/``k``/
``compiled_variants`` and the ``spec_proposer`` rebind. ``engine/spec/``
is the implementation and is out of scope. No allowlist: the package
satisfies the rule by construction and the tier-1 empty-baseline test
keeps it that way.
"""

from __future__ import annotations

import ast
import re
from typing import Iterator

from ..core import Finding, LintModule, Rule

_SCOPE = re.compile(r"(^|/)engine/")
_EXEMPT = re.compile(r"(^|/)engine/spec/")

# Draft-pool/state attributes a non-seam module must never touch.
_DRAFT_STATE = frozenset({
    "kv_cache", "params", "allocator", "_rows", "_decode_fn", "_prefill_fn",
})


def _chain(node: ast.AST) -> list[str]:
    """Attribute chain names, innermost-first: a.b.c -> ["a", "b", "c"]
    (the base Name included when present)."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    return list(reversed(parts))


class DraftStateBoundaryRule(Rule):
    code = "KGCT017"
    name = "draft-state-boundary"
    description = ("engine/scheduler code reaching into the draft-model "
                   "proposer's KV/param state outside the proposer seam")

    def check(self, mod: LintModule) -> Iterator[Finding]:
        relpath = mod.relpath.replace("\\", "/")
        if not _SCOPE.search(relpath) or _EXEMPT.search(relpath):
            return
        # Local aliases of a spec_proposer handle, per function scope:
        # ``proposer = self.scheduler.spec_proposer`` taints ``proposer``.
        aliases: set[str] = set()
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name):
                if "spec_proposer" in _chain(node.value):
                    aliases.add(node.targets[0].id)

        def touches_draft_state(node: ast.Attribute):
            """(handle name, offending attr) when this node IS the
            draft-state access through a proposer handle (flagging only
            the node whose own attr is the state name keeps one finding
            per expression — outer attributes of the same chain stay
            silent), else None."""
            if node.attr not in _DRAFT_STATE:
                return None
            chain = _chain(node)
            for h in ("spec_proposer", *aliases):
                if h in chain[:-1]:
                    return h, node.attr
            return None

        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Attribute):
                hit = touches_draft_state(node)
                if hit is not None:
                    yield self.finding(
                        mod, node,
                        f"reaches through {hit[0]!r} into draft-model state "
                        f"{hit[1]!r} — the draft pool's append-only/rollback"
                        " invariants live inside the proposer seam "
                        "(propose_batch/retain); route the operation "
                        "through a proposer method instead")
                    continue
            targets: list = []
            if isinstance(node, ast.Assign):
                targets = node.targets
            elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
                targets = [node.target]
            for t in targets:
                if isinstance(t, ast.Attribute):
                    chain = _chain(t)
                    # Rebinding spec_proposer itself (installation) is the
                    # seam; writing THROUGH it is not — but that case is
                    # already an Attribute the walk above flags when it
                    # ends in draft state. Flag the remaining case: any
                    # assignment to a non-state attribute through the
                    # handle (e.g. proposer.k = 8 from the scheduler).
                    for h in ("spec_proposer", *aliases):
                        if h in chain and chain[-1] != h:
                            yield self.finding(
                                mod, node,
                                f"assigns {chain[-1]!r} through "
                                f"{h!r} — proposer attributes are "
                                "mutated only inside the proposer seam")
                            break
