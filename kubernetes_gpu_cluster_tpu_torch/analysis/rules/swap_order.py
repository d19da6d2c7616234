"""KGCT010 swap-order-safety: gather to host BEFORE freeing device pages.

The two-tier KV cache's one new write-safety contract (engine/kv_cache.py
``KVSwapper`` docstring): the device->host gather of a page's content must
COMPLETE before the page returns to the allocator. ``swap_out`` fetches
synchronously (``np.asarray`` inside the call), so the invariant reduces to
ordering at every call site: in any function that both swap-gathers pages
(``swap_out`` / ``spill_page``) and releases device pages (``_release`` /
an allocator-pool ``free``), every release must come AFTER the gather — a
release issued first can hand the page to the very next allocation, whose
step dispatch overwrites the KV the gather was about to save ("dispatch
succeeded, resumed session decodes garbage").

Scope: the KV-owning modules (``engine/``). Functions that only release
(abort/finish paths) or only gather are not in scope — the hazard is the
interleaving.
"""

from __future__ import annotations

import ast
import re
from typing import Iterator

from ..core import Finding, LintModule, Rule

_SCOPE = re.compile(r"(^|/)engine/")
_GATHERS = frozenset({"swap_out", "spill_page", "export_pages"})
# Device-page releases: the scheduler's _release helper, and .free() on an
# allocator-ish receiver (self.allocator.free / allocator.free). Host-pool
# frees (swapper.free_host / host.free) are NOT releases — the host copy
# has no dispatch racing it.
_RELEASE_ATTRS = frozenset({"_release"})
_ALLOCATOR_RECV = re.compile(r"allocator")


def _dotted_src(node: ast.AST) -> str:
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    return ".".join(reversed(parts))


class SwapOrderRule(Rule):
    code = "KGCT010"
    name = "swap-order-safety"
    description = ("device pages released before the swap gather that must "
                   "read them (two-tier KV cache ordering contract)")

    def check(self, mod: LintModule) -> Iterator[Finding]:
        if not _SCOPE.search(mod.relpath.replace("\\", "/")):
            return
        for fn in mod.functions:
            gathers: list = []
            releases: list = []
            for node in ast.walk(fn):
                if not (isinstance(node, ast.Call)
                        and isinstance(node.func, ast.Attribute)):
                    continue
                attr = node.func.attr
                if attr in _GATHERS:
                    gathers.append(node)
                elif attr in _RELEASE_ATTRS or (
                        attr == "free"
                        and _ALLOCATOR_RECV.search(
                            _dotted_src(node.func.value))):
                    releases.append(node)
            if not gathers or not releases:
                continue
            first_gather = min(n.lineno for n in gathers)
            for rel in releases:
                if rel.lineno < first_gather:
                    yield self.finding(
                        mod, rel,
                        f"device pages released at line {rel.lineno} before "
                        f"the swap gather at line {first_gather} — the "
                        "gather must read the pages while they are still "
                        "owned; a freed page can be reallocated and "
                        "overwritten by the next dispatch (see "
                        "engine/kv_cache.KVSwapper ordering contract)")
