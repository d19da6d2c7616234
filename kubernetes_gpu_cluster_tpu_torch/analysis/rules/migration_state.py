"""KGCT014 migration-state-safety: exported sequence state is committed-only.

The live-migration/handoff export seam (``engine.export_held`` /
``export_running`` / ``_export_state``) serializes a sequence for another
replica to resume BYTE-IDENTICALLY. The one correctness contract: every
field must come from COMMITTED quantities — the sequence's host-known
token/logprob history and the already-fetched committed-page buffers.
Nothing from an in-flight decode window may enter the wire state: the
window's sampled-but-unfetched tokens are device-resident speculation that
the chain may still rewrite (zombie discipline), and a peer that imported
them would fork the stream from history the exporting engine never
committed.

Statically this rule scans export-seam functions in the engine modules and
flags any UNCOMMITTED-source reference — the in-flight window dict
(``_inflight``), window scratch (``float_b``, ``window_*``), zombie sets,
or draft/pending buffers — flowing into the serialized state: a value in a
returned dict literal, a store into the state mapping, or an ``update()``
of it. Window BOOKKEEPING in the same function (zombie registration,
deferred page release) is legitimate and stays silent — only data flowing
into the state dict is policed.
"""

from __future__ import annotations

import ast
import re
from typing import Iterator

from ..core import Finding, LintModule, Rule

_SCOPE = re.compile(r"(^|/)engine/")
_EXPORT_FN = re.compile(r"^(_export_state$|export_)")
# Uncommitted sources: the in-flight window and its scratch. Matched against
# the ast dump of VALUE expressions only, so bookkeeping reads elsewhere in
# the function never fire.
_FORBIDDEN = re.compile(
    r"_inflight|float_b|zombies|window_toks|window_lps|in_window"
    r"|_pending|uncommitted|draft_")


def _returned_names(fn: ast.AST) -> set:
    """Names the function returns (directly or via ``return name``) — the
    candidate state-dict variables whose stores/updates are policed."""
    names = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Return) and isinstance(node.value, ast.Name):
            names.add(node.value.id)
    return names


class MigrationStateSafetyRule(Rule):
    code = "KGCT014"
    name = "migration-state-safety"
    description = ("export-seam state built from uncommitted quantities "
                   "(in-flight window / scratch data serialized into a "
                   "cross-replica handoff)")

    def check(self, mod: LintModule) -> Iterator[Finding]:
        if not _SCOPE.search(mod.relpath.replace("\\", "/")):
            return
        for fn in mod.functions:
            if not _EXPORT_FN.match(fn.name):
                continue
            state_names = _returned_names(fn)
            values: list = []
            for node in ast.walk(fn):
                if isinstance(node, ast.Return) and isinstance(node.value,
                                                               ast.Dict):
                    values.extend(v for v in node.value.values
                                  if v is not None)
                elif (isinstance(node, ast.Assign)
                      and isinstance(node.value, ast.Dict)
                      and any(isinstance(t, ast.Name)
                              and t.id in state_names
                              for t in node.targets)):
                    values.extend(v for v in node.value.values
                                  if v is not None)
                elif (isinstance(node, ast.Assign) and node.targets
                      and isinstance(node.targets[0], ast.Subscript)
                      and isinstance(node.targets[0].value, ast.Name)
                      and node.targets[0].value.id in state_names):
                    values.append(node.value)
                elif (isinstance(node, ast.Call)
                      and isinstance(node.func, ast.Attribute)
                      and node.func.attr == "update"
                      and isinstance(node.func.value, ast.Name)
                      and node.func.value.id in state_names):
                    values.extend(node.args)
                    values.extend(kw.value for kw in node.keywords)
            for val in values:
                hit = _FORBIDDEN.search(ast.dump(val))
                if hit:
                    yield self.finding(
                        mod, val,
                        f"export seam {fn.name!r} serializes the "
                        f"uncommitted source {hit.group(0)!r} into the "
                        "cross-replica state — exports must be built from "
                        "committed quantities only (host-known token/"
                        "logprob history + committed-page buffers); a peer "
                        "importing window speculation forks the stream "
                        "from history this engine never committed")
                    break
