"""KGCT016 fleet-fetch-boundary: remote KV bytes enter the pool only
through the engine's import seam, executed on the worker thread.

The fleet prefix cache (and the disaggregated handoff before it) moves KV
pages between replicas over HTTP. The bytes coming off a socket may only
enter the device pool through the engine's sanctioned import methods
(``import_request``, the streamed ``begin_prefix_import`` /
``import_prefix_chunk`` / ``commit_prefix_import`` family,
``accept_remote_spill``, and the underlying ``KVPageIO`` scatter) — and
those methods must run ON THE WORKER THREAD, where every engine/
scheduler/device touch is single-threaded by construction. A serving
handler that calls an import seam directly from the event loop races the
step loop against the pool (the class of corruption KGCT010 exists to
prevent), and a handler-side scatter forks a second,
unguarded entry path for peer-controlled bytes.

Fires on, in ``serving/`` modules (except ``async_engine.py`` — the
worker loop itself, where the ops queue executes and the inbox's
``import_request`` call IS the seam):

- any call whose attribute name is an import-seam method, UNLESS the call
  sits inside a lambda/def passed to ``run_in_worker``/``post_to_worker``
  (the worker-op wrappers);
- any assignment to a ``.kv_cache`` attribute (rebinding the engine's
  pool from serving code).

No allowlist: the whole serving package satisfies the rule by
construction, and the tier-1 empty-baseline test keeps it that way.
"""

from __future__ import annotations

import ast
import re
from typing import Iterator

from ..core import Finding, LintModule, Rule

_SCOPE = re.compile(r"(^|/)serving/")
# The worker loop: ops and the inbox drain execute here BY DEFINITION —
# it is the other side of the run_in_worker seam, not a bypass of it.
_EXEMPT = "serving/async_engine.py"

# Engine import-seam methods: the only entry points for remote KV bytes.
_SEAM_CALLS = frozenset({
    "import_request", "import_pages", "scatter_pages",
    "begin_prefix_import", "import_prefix_chunk", "commit_prefix_import",
    "abort_prefix_import", "accept_remote_spill",
})
# The worker-op wrappers: a callable passed to these runs on the worker
# thread, which is the sanctioned execution context.
_WORKER_WRAPPERS = frozenset({"run_in_worker", "post_to_worker"})


class FleetFetchBoundaryRule(Rule):
    code = "KGCT016"
    name = "fleet-fetch-boundary"
    description = ("remote KV bytes entering the pool outside the "
                   "worker-executed import seam (handler-side scatter / "
                   "event-loop import call)")

    def check(self, mod: LintModule) -> Iterator[Finding]:
        relpath = mod.relpath.replace("\\", "/")
        if not _SCOPE.search(relpath) or relpath.endswith(_EXEMPT):
            return
        # Every lambda/def node passed as an argument to a worker-op
        # wrapper: calls INSIDE those run on the worker thread.
        wrapped: set = set()
        for node in ast.walk(mod.tree):
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in _WORKER_WRAPPERS):
                for arg in list(node.args) + [kw.value
                                              for kw in node.keywords]:
                    if isinstance(arg, (ast.Lambda, ast.FunctionDef,
                                        ast.AsyncFunctionDef)):
                        for sub in ast.walk(arg):
                            wrapped.add(id(sub))
        for node in ast.walk(mod.tree):
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in _SEAM_CALLS
                    and id(node) not in wrapped):
                yield self.finding(
                    mod, node,
                    f"import-seam call {node.func.attr!r} outside a "
                    "run_in_worker/post_to_worker op — remote KV bytes "
                    "may only enter the pool on the worker thread, where "
                    "the scatter cannot race a dispatched step against "
                    "the pool (wrap it: await engine."
                    "run_in_worker(lambda e: e.%s(...)))" % node.func.attr)
            targets: list = []
            if isinstance(node, ast.Assign):
                targets = node.targets
            elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
                targets = [node.target]
            for t in targets:
                if isinstance(t, ast.Attribute) and t.attr == "kv_cache":
                    yield self.finding(
                        mod, node,
                        "serving code rebinds an engine's .kv_cache — the "
                        "pool is written only by the engine's own step and "
                        "transfer seams, in place; a serving-side write "
                        "races every in-flight step")
