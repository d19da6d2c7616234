"""KGCT005 kv-commit-safety: KV slot math must be anchored and guarded.

The paged KV pool's one write-safety contract (engine/spec/verifier.py
docstring): a slot may be written only at positions at-or-past the
sequence's committed length, and positions past the model cap (or past the
allocated page list) must route to the scrap page — an unguarded
``page * page_size + pos % page_size`` wraps the write back into committed
history and serves corrupted context to every later read.

Statically this rule requires, for any function in the KV-owning modules
(``engine/``) that computes a slot expression or stores into a
``slot_mapping`` buffer, at least one of:

- a committed-length anchor (``num_tokens`` / ``num_prefilled`` /
  ``context_len*`` / ``hist_len``) tying the position arithmetic to the
  sequence's committed state (sufficient for single-position writes whose
  position IS the committed length), or
- an overflow guard (``SCRAP_PAGE`` routing, or a clamp/compare against a
  ``max_len``-class bound) for range writes that can run past the cap.

The runtime half of the contract — rejected-draft slots overwritten before
any read — is dynamic by nature and enforced by the ``KGCT_SANITIZE=1``
KV-slot shadow (analysis/sanitize.py).
"""

from __future__ import annotations

import ast
import re
from typing import Iterator

from ..core import Finding, LintModule, Rule

_SCOPE = re.compile(r"(^|/)engine/")
_ANCHORS = re.compile(
    r"num_tokens|num_prefilled|context_len|hist_len|committed")
_GUARDS = re.compile(r"SCRAP_PAGE|max_len|effective_max_len|max_model_len")
_PAGEISH = re.compile(r"page")
_SLOT_STORE = re.compile(r"slot")


def _is_slot_expr(node: ast.AST) -> bool:
    """``<page-ish> * ps + <pos> % ps`` — the canonical slot computation."""
    if not (isinstance(node, ast.BinOp) and isinstance(node.op, ast.Add)):
        return False
    sides = (node.left, node.right)
    has_mult = any(isinstance(s, ast.BinOp) and isinstance(s.op, ast.Mult)
                   and _PAGEISH.search(ast.dump(s)) for s in sides)
    has_mod = any(isinstance(s, ast.BinOp) and isinstance(s.op, ast.Mod)
                  for s in sides)
    return has_mult and has_mod


class KVCommitSafetyRule(Rule):
    code = "KGCT005"
    name = "kv-commit-safety"
    description = ("KV slot computation without a committed-length anchor "
                   "and an overflow guard (scrap-page / max-len clamp)")

    def check(self, mod: LintModule) -> Iterator[Finding]:
        if not _SCOPE.search(mod.relpath.replace("\\", "/")):
            return
        for fn in mod.functions:
            triggers = []
            for node in ast.walk(fn):
                if _is_slot_expr(node):
                    triggers.append((node, "slot expression"))
                elif (isinstance(node, ast.Subscript)
                      and isinstance(node.ctx, ast.Store)
                      and _SLOT_STORE.search(ast.dump(node.value))):
                    triggers.append((node, "slot_mapping store"))
            if not triggers:
                continue
            src = ast.dump(fn)
            if _ANCHORS.search(src) or _GUARDS.search(src):
                continue
            node, what = triggers[0]
            yield self.finding(
                mod, node,
                f"{what} in {fn.name!r} with neither a committed-length "
                "anchor (num_tokens/num_prefilled/context_len/hist_len) nor "
                "an overflow guard (SCRAP_PAGE routing / max-len clamp) — "
                "an unanchored slot can wrap a KV write into committed "
                "history (see engine/spec/verifier.py contract)")
