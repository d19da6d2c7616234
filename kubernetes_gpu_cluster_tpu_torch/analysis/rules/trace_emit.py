"""KGCT012 trace-emit-hygiene: observability writes stay O(append).

The request tracer and the flight recorder sit on the serving hot paths —
``Engine.step*`` emits per-step events, the router's ``proxy`` emits
per-request spans — so their WRITE methods must be non-blocking appends:
no file I/O, no serialization, no locks, no sleeps, no host syncs. One
slow ``emit`` stalls every token of every in-flight request, invisibly
(the stall hides inside the instrumentation that exists to find stalls).
The expensive half (``dump``/``export``) belongs OFF the hot path: debug
endpoints and failure handlers only.

Fires on:

- inside a write method (``emit``/``record``/``maybe_snapshot`` of a class
  whose name contains ``Tracer`` or ``Recorder``, any module): calls to
  ``open``/``print``/``json.dump(s)``/``time.sleep``/
  ``torch.cuda.synchronize``/``jax.device_get``, attribute calls named
  ``write``/``flush``/``fsync``/``acquire`` or a host sync (torch's
  ``item``/``cpu``/``tolist``/``numpy``/``synchronize``, JAX's
  ``block_until_ready``), or a ``with`` held on a lock-named attribute —
  each is blocking work smuggled into the append path;
- a tracer/recorder ``dump``/``export``/``export_perfetto`` call inside an
  Engine class's step-reachable methods (the shared hot-path analysis) or
  inside a ``proxy`` method in ``serving/`` — serialization on the token
  path;
- ``await`` of an ``.emit(...)``/``.record(...)`` call in ``serving/``:
  the write API is synchronous by contract; an awaitable emit means
  someone rebuilt it around I/O.
"""

from __future__ import annotations

import ast
import re
from typing import Iterator

from ..core import Finding, LintModule, Rule, _dotted

_WRITE_CLASSES = re.compile(r"(Tracer|Recorder)")
_WRITE_METHODS = frozenset({"emit", "record", "maybe_snapshot"})
_BLOCKING_NAMES = frozenset({"open", "print"})
_BLOCKING_DOTTED = frozenset({"time.sleep", "json.dump", "json.dumps",
                              "torch.cuda.synchronize", "jax.device_get",
                              "os.makedirs"})
# The host-sync spellings are KGCT002's (torch's and the JAX package's).
_BLOCKING_ATTRS = frozenset({"write", "flush", "fsync", "acquire",
                             "item", "cpu", "tolist", "numpy",
                             "synchronize", "block_until_ready"})
_EXPORT_ATTRS = frozenset({"dump", "export", "export_perfetto"})
_OBS_TARGET = re.compile(r"(tracer|recorder|flight|obs)", re.IGNORECASE)
_SERVING_SCOPE = re.compile(r"(^|/)serving/")


def _mentions_obs_target(node: ast.AST) -> bool:
    """Does the callee's receiver chain name a tracer/recorder-ish object
    (``self.obs.flight``, ``self.tracer``, a local named ``recorder``)?"""
    for sub in ast.walk(node):
        if isinstance(sub, ast.Attribute) and _OBS_TARGET.search(sub.attr):
            return True
        if isinstance(sub, ast.Name) and _OBS_TARGET.search(sub.id):
            return True
    return False


class TraceEmitHygieneRule(Rule):
    code = "KGCT012"
    name = "trace-emit-hygiene"
    description = ("blocking work (I/O, serialization, locks, host syncs) "
                   "inside tracer/recorder write methods, or dump/export "
                   "reachable from Engine.step*/the router proxy path")

    def check(self, mod: LintModule) -> Iterator[Finding]:
        yield from self._check_write_methods(mod)
        yield from self._check_hot_path_exports(mod)
        if _SERVING_SCOPE.search(mod.relpath.replace("\\", "/")):
            yield from self._check_awaited_emits(mod)

    # -- write methods must be pure appends ----------------------------------

    def _check_write_methods(self, mod: LintModule) -> Iterator[Finding]:
        for cls in mod.classes:
            if not _WRITE_CLASSES.search(cls.name):
                continue
            for fn in cls.body:
                if not (isinstance(fn, ast.FunctionDef)
                        and fn.name in _WRITE_METHODS):
                    continue
                for node in ast.walk(fn):
                    blocking = self._blocking_call(node) \
                        or self._lock_with(node)
                    if blocking:
                        yield self.finding(
                            mod, node,
                            f"{blocking} inside {cls.name}.{fn.name} — the "
                            "tracer/recorder write path rides Engine.step* "
                            "and the router proxy, so it must be an "
                            "O(append) with no I/O, locks, serialization, "
                            "or host syncs; move the blocking work to "
                            "dump/export (off the hot path)")

    @staticmethod
    def _blocking_call(node: ast.AST):
        if not isinstance(node, ast.Call):
            return None
        callee = node.func
        if isinstance(callee, ast.Name) and callee.id in _BLOCKING_NAMES:
            return f"{callee.id}() call"
        dotted = _dotted(callee)
        if dotted in _BLOCKING_DOTTED:
            return f"{dotted}() call"
        if isinstance(callee, ast.Attribute) and callee.attr in _BLOCKING_ATTRS:
            return f".{callee.attr}() call"
        return None

    @staticmethod
    def _lock_with(node: ast.AST):
        if not isinstance(node, ast.With):
            return None
        for item in node.items:
            expr = item.context_expr
            name = (expr.attr if isinstance(expr, ast.Attribute)
                    else expr.id if isinstance(expr, ast.Name) else "")
            if "lock" in name.lower():
                return f"lock held ({name})"
        return None

    # -- dump/export stays off the hot path ----------------------------------

    def _check_hot_path_exports(self, mod: LintModule) -> Iterator[Finding]:
        hot = list(mod.hot_path_functions)
        if _SERVING_SCOPE.search(mod.relpath.replace("\\", "/")):
            hot += [fn for fn in mod.functions if fn.name == "proxy"]
        for fn in hot:
            for node in ast.walk(fn):
                if not (isinstance(node, ast.Call)
                        and isinstance(node.func, ast.Attribute)
                        and node.func.attr in _EXPORT_ATTRS
                        and _mentions_obs_target(node.func.value)):
                    continue
                yield self.finding(
                    mod, node,
                    f"tracer/recorder .{node.func.attr}() in hot-path "
                    f"{fn.name!r} — export/dump serializes the whole ring "
                    "(I/O + json) and belongs on debug endpoints or "
                    "failure handlers, never the step/proxy path")

    # -- emit/record are synchronous by contract -----------------------------

    def _check_awaited_emits(self, mod: LintModule) -> Iterator[Finding]:
        for node in ast.walk(mod.tree):
            if not (isinstance(node, ast.Await)
                    and isinstance(node.value, ast.Call)
                    and isinstance(node.value.func, ast.Attribute)
                    and node.value.func.attr in ("emit", "record")):
                continue
            yield self.finding(
                mod, node,
                "awaited .%s() — the tracer/recorder write API is "
                "synchronous by contract (a coroutine emit means blocking "
                "work moved into the append path)" % node.value.func.attr)
