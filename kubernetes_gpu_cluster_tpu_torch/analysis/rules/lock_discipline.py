"""KGCT021 lock-discipline: threading locks may not outlive a suspension
point, stall their loop-side contenders, or straddle the loop/worker
boundary outside the one sanctioned handshake.

``threading.Lock`` is invisible to the event loop: a coroutine that
holds one across an ``await`` keeps it locked while every other
coroutine runs — any of them touching the same lock deadlocks the loop
against itself. A blocking call under a lock that loop-side code also
acquires is the indirect form: the worker sleeps or does socket I/O
under the lock while a handler coroutine blocks the whole loop in
``acquire()``. And a lock acquired on BOTH sides of the loop/worker
boundary is a cross-thread handshake — the engine has exactly one
(``AsyncLLMEngine._cv``), and new ones belong behind the worker-op seam,
not scattered through serving code.

Uses the package-wide :class:`~..core.PackageModel`: which functions are
proven to run on the event loop (``async def`` seeds + resolvable call
edges), which on worker threads (``threading.Thread`` targets +
worker-op callables), and hence which *contexts* contend for each lock.
The graph under-approximates, so the rule fires only on proven overlap:

- **await under lock** — an ``await`` inside ``with <threading lock>:``
  — always a bug, fires unconditionally;
- **blocking call under a loop-contended lock** — a
  ``BLOCKING_DOTTED`` call (KGCT006's set) inside a ``with`` on a lock
  some loop-context function also acquires; a worker-only lock over
  blocking sends (the directive leader's socket serialization) is
  legitimate and stays silent;
- **cross-boundary lock** — acquisition of a lock whose acquirers span
  both contexts, anywhere except ``serving/async_engine.py`` (the
  ``_cv`` step/submit handshake IS the sanctioned crossing).

Condition-variable ``wait``/``wait_for`` release the lock while
waiting and are not in the blocking set — the handshake idiom stays
legal where the handshake is.
"""

from __future__ import annotations

import ast
from typing import Iterator, Optional

from ..core import CTX_LOOP, CTX_WORKER, Finding, LintModule, Rule, _dotted
from .asyncio_hygiene import BLOCKING_DOTTED, BLOCKING_PREFIXES

# The one sanctioned cross-boundary handshake: the engine's _cv.
_EXEMPT = "serving/async_engine.py"


def _lock_name(expr: ast.AST, lock_names: set) -> Optional[str]:
    """The lock's name when ``with <expr>`` acquires a known threading
    lock (``self.<lock>`` or a module-level ``<LOCK>``); None else."""
    name = None
    if (isinstance(expr, ast.Attribute)
            and isinstance(expr.value, ast.Name)
            and expr.value.id == "self"):
        name = expr.attr
    elif isinstance(expr, ast.Name):
        name = expr.id
    return name if name in lock_names else None


class LockDisciplineRule(Rule):
    code = "KGCT021"
    name = "lock-discipline"
    description = ("await or blocking call while holding a threading "
                   "lock; lock acquired on both sides of the loop/worker "
                   "boundary outside the sanctioned handshake")

    def check(self, mod: LintModule) -> Iterator[Finding]:
        lock_names = mod.concurrency.lock_names
        if not lock_names:
            return
        pm = mod.package_model
        relpath = mod.relpath.replace("\\", "/")
        handshake_module = relpath.endswith(_EXEMPT)
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.With):
                continue
            for item in node.items:
                lock = _lock_name(item.context_expr, lock_names)
                if lock is None:
                    continue
                ctxs = pm.lock_contexts_of(mod, lock)
                if ({CTX_LOOP, CTX_WORKER} <= ctxs
                        and not handshake_module):
                    yield self.finding(
                        mod, node,
                        f"lock {lock!r} is acquired on both sides of the "
                        "loop/worker boundary — a second cross-thread "
                        "handshake outside the engine's _cv; route the "
                        "shared state through the run_in_worker/"
                        "post_to_worker seam instead")
                yield from self._check_body(mod, node, lock, ctxs)

    def _check_body(self, mod: LintModule, with_node: ast.With, lock: str,
                    ctxs: frozenset) -> Iterator[Finding]:
        for stmt in with_node.body:
            for sub in ast.walk(stmt):
                if isinstance(sub, ast.Await):
                    yield self.finding(
                        mod, sub,
                        f"await while holding threading lock {lock!r} — "
                        "the lock stays held across every interleaved "
                        "coroutine, and any of them acquiring it "
                        "deadlocks the loop against itself; release "
                        "before the await or move the work to the "
                        "worker-op seam")
                elif isinstance(sub, ast.Call) and CTX_LOOP in ctxs:
                    dotted = _dotted(sub.func)
                    if (dotted in BLOCKING_DOTTED
                            or dotted.startswith(BLOCKING_PREFIXES)):
                        yield self.finding(
                            mod, sub,
                            f"blocking {dotted}() while holding "
                            f"{lock!r}, a lock event-loop code also "
                            "acquires — a handler coroutine contending "
                            "for it blocks the WHOLE loop for the "
                            "duration; narrow the lock scope to exclude "
                            "the blocking call")
