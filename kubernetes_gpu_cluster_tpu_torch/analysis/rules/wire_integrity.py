"""KGCT018 wire-integrity: pages that crossed the wire commit only behind
a checksum verification.

The KV wire plane (serving/handoff.py) carries per-page CRC checksums and
a whole-frame digest on every frame; the codec's decode paths
(``decode_handoff``, ``decode_spill_frame``, ``PrefixStreamDecoder``) and
the import-seam re-check (``verify_import_state``) are the ONLY places
allowed to turn wire bytes back into pool pages. A serving-side commit of
imported pages whose reaching path never verifies a checksum silently
re-opens the corruption window the integrity layer closed — one flipped
bit in transit lands in the pool and poisons every prefix-cache
hit downstream.

Fires on, in ``serving/`` modules (except ``handoff.py`` — the codec
itself, whose decoders DO the verification — and ``async_engine.py``, the
worker loop where the already-verified op executes):

- a commit-class call (``commit_prefix_import`` / ``import_request``, or
  a ``generate(..., handoff=<non-None>)`` resume import) whose reaching
  path — the enclosing function plus its intra-module transitive callees
  — contains no checksum-verify call (``verify_import_state``,
  ``decode_handoff``, ``decode_spill_frame``, or a
  ``PrefixStreamDecoder`` construction, all of which raise
  ``WireCorruptionError`` before a bad page can commit);
- any raw ``np.frombuffer`` call: reinterpreting wire bytes belongs to
  the codec alone — a serving-side ``frombuffer`` is an unverified decode
  path by construction.

No allowlist: the whole serving package satisfies the rule by
construction, and the tier-1 empty-baseline test keeps it that way.
"""

from __future__ import annotations

import ast
import re
from typing import Iterator, Optional

from ..core import Finding, LintModule, Rule

_SCOPE = re.compile(r"(^|/)serving/")
# The codec (verification lives here) and the worker loop (ops execute
# already-verified — the serving seam that enqueued them is in scope).
_EXEMPT = ("serving/handoff.py", "serving/async_engine.py")

# Commit-class calls: imported pages become committed history here.
_COMMIT_CALLS = frozenset({"commit_prefix_import", "import_request"})
# Checksum-verify calls: each raises WireCorruptionError on a bad page
# before the commit can happen.
_VERIFY_CALLS = frozenset({
    "verify_import_state", "decode_handoff", "decode_spill_frame",
    "PrefixStreamDecoder",
})


def _call_name(node: ast.Call) -> Optional[str]:
    if isinstance(node.func, ast.Attribute):
        return node.func.attr
    if isinstance(node.func, ast.Name):
        return node.func.id
    return None


class WireIntegrityRule(Rule):
    code = "KGCT018"
    name = "wire-integrity"
    description = ("imported KV pages committed without a checksum "
                   "verification in the reaching path (or a raw "
                   "np.frombuffer decode outside the wire codec)")

    def check(self, mod: LintModule) -> Iterator[Finding]:
        relpath = mod.relpath.replace("\\", "/")
        if not _SCOPE.search(relpath) or relpath.endswith(_EXEMPT):
            return
        # Intra-module call graph by bare function/method name: enough to
        # follow serving handlers into their self._helper() chains.
        funcs: dict[str, ast.AST] = {}
        for node in ast.walk(mod.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                funcs.setdefault(node.name, node)

        def _callees(fn: ast.AST) -> set:
            out = set()
            for sub in ast.walk(fn):
                if isinstance(sub, ast.Call):
                    name = _call_name(sub)
                    if name in funcs:
                        out.add(name)
            return out

        def _verifies(fn: Optional[ast.AST]) -> bool:
            """Any checksum-verify call in ``fn`` or its transitive
            intra-module callees (the commit's reaching path)."""
            roots = [fn] if fn is not None else [mod.tree]
            seen: set = set()
            stack = list(roots)
            while stack:
                cur = stack.pop()
                for sub in ast.walk(cur):
                    if (isinstance(sub, ast.Call)
                            and _call_name(sub) in _VERIFY_CALLS):
                        return True
                for name in _callees(cur):
                    if name not in seen:
                        seen.add(name)
                        stack.append(funcs[name])
            return False

        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            name = _call_name(node)
            if name == "frombuffer":
                yield self.finding(
                    mod, node,
                    "raw np.frombuffer outside serving/handoff.py — "
                    "reinterpreting wire bytes belongs to the codec, "
                    "whose decoders checksum every page before it can "
                    "reach the pool (decode through decode_handoff/"
                    "decode_spill_frame/PrefixStreamDecoder instead)")
                continue
            is_commit = name in _COMMIT_CALLS
            if not is_commit and name == "generate":
                # The resume/handoff import: generate(handoff=<state>)
                # commits a parked wire frame as request history.
                is_commit = any(
                    kw.arg == "handoff"
                    and not (isinstance(kw.value, ast.Constant)
                             and kw.value.value is None)
                    for kw in node.keywords)
            if is_commit and not _verifies(mod.enclosing_function(node)):
                yield self.finding(
                    mod, node,
                    f"commit-class call {name!r} with no checksum-verify "
                    "in its reaching path — pages that crossed the wire "
                    "must pass verify_import_state (or a verifying "
                    "decode: decode_handoff/decode_spill_frame/"
                    "PrefixStreamDecoder) before they commit, or a "
                    "flipped bit in transit becomes poisoned cache "
                    "history")
