"""KGCT020 engine-thread-ownership: engine/scheduler/KV-pool state is
worker-thread property — async serving code may not reach into it.

The static twin of KGCT016: that rule polices the import-seam *calls*;
this one covers state *reads* and attribute rebinds. The engine worker
thread mutates ``scheduler.waiting``/``running``/``swapped``, the KV
pool and the prefix cache between every step — an ``async def`` that
iterates, subscripts, or calls methods on that state from the event loop
observes it mid-mutation (the SLOTracker concurrent-scrape bug class),
and a rebind from the loop races the step in flight.

Fires, in ``serving/`` modules except ``async_engine.py`` (the seam
module — its worker loop IS the owning thread), inside ``async def``
bodies, on engine-owned expressions — attribute chains that pass through
an ``.engine`` handle into an owned component (``scheduler``,
``kv_cache``, ``prefix_cache``, ``page_allocator``, ``worker``,
``model_runner``), directly or through a local alias:

- method calls on owned state (``sched.step()``, ``pool.free(...)``);
- subscripts (``sched.running[0]``, read or write);
- iteration (``for r in sched.waiting``, comprehensions included);
- attribute rebinds (``eng.scheduler = ...``, ``sched.policy = ...``).

Sanctioned by construction, never allowlisted:

- **the worker-op seam** — anything inside a callable passed to
  ``run_in_worker``/``post_to_worker`` executes on the worker thread
  between steps;
- **GIL-atomic snapshots** — ``len(owned)``, truthiness tests,
  ``is None`` compares, and plain alias assignment read one reference
  atomically and copy nothing mutable (the /healthz queue-depth gauges);
- **sync functions** — server ``__init__``/setup runs before the worker
  thread exists; the loop/worker overlap this rule polices only opens
  once coroutines are in flight.
"""

from __future__ import annotations

import ast
import re
from typing import Iterator, Optional

from ..core import Finding, LintModule, Rule

_SCOPE = re.compile(r"(^|/)serving/")
_EXEMPT = "serving/async_engine.py"

# Engine components owned by the worker thread once it is running.
_OWNED = frozenset({
    "scheduler", "kv_cache", "prefix_cache", "page_allocator",
    "worker", "model_runner", "block_manager",
})


def _chain(node: ast.AST) -> Optional[list]:
    """['self', 'engine', 'engine', 'scheduler'] for the dotted chain;
    None when the root is not a plain Name."""
    parts: list = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        parts.reverse()
        return parts
    return None


class ThreadOwnershipRule(Rule):
    code = "KGCT020"
    name = "engine-thread-ownership"
    description = ("engine/scheduler/KV-pool state reached from an async "
                   "def outside the worker-op seam — reads, iteration, "
                   "and rebinds, the static twin of KGCT016")

    def check(self, mod: LintModule) -> Iterator[Finding]:
        relpath = mod.relpath.replace("\\", "/")
        if not _SCOPE.search(relpath) or relpath.endswith(_EXEMPT):
            return
        wrapped = mod.concurrency.worker_wrapped
        for fn in mod.functions:
            if isinstance(fn, ast.AsyncFunctionDef):
                yield from self._check_fn(mod, fn, wrapped)

    def _check_fn(self, mod: LintModule, fn: ast.AsyncFunctionDef,
                  wrapped: set) -> Iterator[Finding]:
        engine_aliases, owned_aliases = self._aliases(fn)

        def owned(node: ast.AST) -> Optional[str]:
            """Dotted name of ``node`` when it denotes engine-owned
            state (directly or through an alias); None otherwise."""
            if isinstance(node, ast.Name):
                return node.id if node.id in owned_aliases else None
            parts = _chain(node)
            if not parts:
                return None
            root_owned = (parts[0] in owned_aliases)
            for i, part in enumerate(parts[1:], 1):
                engine_before = ("engine" in parts[:i]
                                 or parts[0] in engine_aliases)
                if part in _OWNED and (engine_before or root_owned):
                    return ".".join(parts)
                if root_owned:
                    return ".".join(parts)
            return None

        for node in ast.walk(fn):
            if id(node) in wrapped:
                continue
            hit: Optional[tuple] = None   # (expr dotted name, verb)
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)):
                name = owned(node.func.value)
                if name:
                    hit = (f"{name}.{node.func.attr}()", "calls a method on")
            elif isinstance(node, ast.Subscript):
                name = owned(node.value)
                if name:
                    hit = (f"{name}[...]", "subscripts")
            elif isinstance(node, ast.For):
                name = owned(node.iter)
                if name:
                    hit = (name, "iterates")
            elif isinstance(node, (ast.ListComp, ast.SetComp, ast.DictComp,
                                   ast.GeneratorExp)):
                for gen in node.generators:
                    name = owned(gen.iter)
                    if name:
                        hit = (name, "iterates")
                        break
            elif isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
                targets = (node.targets if isinstance(node, ast.Assign)
                           else [node.target])
                for tgt in targets:
                    if not isinstance(tgt, ast.Attribute):
                        continue
                    name = owned(tgt.value)
                    parts = _chain(tgt)
                    if name:
                        hit = (f"{name}.{tgt.attr}", "rebinds")
                    elif (parts and tgt.attr in _OWNED
                          and ("engine" in parts[:-1]
                               or parts[0] in engine_aliases)):
                        hit = (".".join(parts), "rebinds")
            if hit:
                expr, verb = hit
                yield self.finding(
                    mod, node,
                    f"async def {fn.name!r} {verb} engine-owned state "
                    f"{expr!r} from the event loop — the worker thread "
                    "mutates it between steps, so loop-side access "
                    "observes it mid-mutation; route through await "
                    "engine.run_in_worker(lambda e: ...) (GIL-atomic "
                    "snapshots — len()/truthiness/is-None — stay legal)")

    @staticmethod
    def _aliases(fn: ast.AsyncFunctionDef) -> tuple:
        """(engine aliases, owned-state aliases): plain names assigned
        from an engine handle / an owned component, one fixpoint pass."""
        engine_aliases: set = set()
        owned_aliases: set = set()
        for _ in range(4):
            grew = False
            for node in ast.walk(fn):
                if not (isinstance(node, ast.Assign)
                        and len(node.targets) == 1
                        and isinstance(node.targets[0], ast.Name)):
                    continue
                tgt = node.targets[0].id
                parts = _chain(node.value)
                if not parts:
                    continue
                is_engine = (parts[-1] == "engine"
                             or (len(parts) == 1
                                 and parts[0] in engine_aliases))
                is_owned = (parts[-1] in _OWNED
                            and ("engine" in parts[:-1]
                                 or parts[0] in engine_aliases)
                            ) or parts[0] in owned_aliases
                if is_engine and tgt not in engine_aliases:
                    engine_aliases.add(tgt)
                    grew = True
                if is_owned and tgt not in owned_aliases:
                    owned_aliases.add(tgt)
                    grew = True
            if not grew:
                break
        return engine_aliases, owned_aliases
