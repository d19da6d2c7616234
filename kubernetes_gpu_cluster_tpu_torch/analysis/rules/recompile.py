"""KGCT003 recompile-risk: bounded program families only.

Two ways serving code silently grows the set of captured programs without
bound (the port's counterpart of the JAX package's jit-cache rule):

1. Capturing a graph anywhere but the program cache's capture method
   (``StepPrograms._capture``), or inside a loop or a hot-path method:
   each such capture is a program no cache keys, counts
   (``kgct_jit_compiles_total``) or bounds, and one per call in a loop.
2. Keying a program (``self.<cache>.run(key)`` / ``.buffers(key)``) by a
   value derived from a per-request ``len()`` that no bucketing helper
   quantized: one capture, and one graph's memory, per distinct batch
   size, exactly the variant explosion tests/test_torch_compile_guard.py
   bounds. The key's names are followed through the function's
   assignments.

Scope: the package but ``tools/``, whose sweeps capture graphs on purpose
to time one kernel.
"""

from __future__ import annotations

import ast
import re
from typing import Iterator

from ..core import (CAPTURE_METHOD, PROGRAM_CACHE, Finding, LintModule,
                    Rule, _dotted)

_CAPTURES = frozenset({"torch.cuda.CUDAGraph", "torch.cuda.graph",
                       "torch.cuda.make_graphed_callables"})
_CAPTURE_METHODS = frozenset({"capture_begin"})
_BUCKETING = re.compile(r"bucket|next_power_of_2", re.I)


def _is_capture(node: ast.Call) -> bool:
    dotted = _dotted(node.func)
    return dotted in _CAPTURES or (isinstance(node.func, ast.Attribute)
                                   and node.func.attr in _CAPTURE_METHODS)


def _bound_exprs(fn: ast.AST, expr: ast.AST) -> list:
    """``expr`` and the values assigned in ``fn`` to every name it reads,
    transitively."""
    assigned: dict = {}
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign):
            for tgt in node.targets:
                for leaf in ast.walk(tgt):
                    if isinstance(leaf, ast.Name):
                        assigned.setdefault(leaf.id, []).append(node.value)
    out, seen, todo = [], set(), [expr]
    while todo:
        e = todo.pop()
        out.append(e)
        for leaf in ast.walk(e):
            if isinstance(leaf, ast.Name) and leaf.id not in seen:
                seen.add(leaf.id)
                todo.extend(assigned.get(leaf.id, ()))
    return out


class RecompileRiskRule(Rule):
    code = "KGCT003"
    name = "recompile-risk"
    description = ("a CUDA graph captured outside the program cache's "
                   "capture method (or in a loop / hot path), or a "
                   "program key built from an unbucketed per-request len()")

    def check(self, mod: LintModule) -> Iterator[Finding]:
        if mod.relpath.replace("\\", "/").split("/")[-2:-1] == ["tools"]:
            return
        hot = set(mod.hot_path_functions)
        for node in ast.walk(mod.tree):
            if not (isinstance(node, ast.Call) and _is_capture(node)):
                continue
            fn = mod.enclosing_function(node)
            cls = mod.enclosing_class(node)
            in_loop = any(isinstance(a, (ast.For, ast.While))
                          for a in mod.ancestors(node))
            sanctioned = (fn is not None and fn.name == CAPTURE_METHOD
                          and cls is not None and cls.name == PROGRAM_CACHE)
            if sanctioned and not in_loop and fn not in hot:
                continue
            where = ("a loop" if in_loop else
                     f"hot-path {fn.name!r}" if fn in hot else
                     f"{getattr(fn, 'name', '<module>')!r}, not "
                     f"{PROGRAM_CACHE}.{CAPTURE_METHOD}")
            yield self.finding(
                mod, node,
                f"CUDA graph captured in {where}: a program no cache keys, "
                "counts or bounds; capture through the engine's "
                "StepPrograms, once per (variant, bucket)")
        for cls in mod.classes:
            attrs = mod.program_cache_attrs(cls)
            if not attrs:
                continue
            for fn in mod.methods_of(cls).values():
                seen: set = set()
                for call in (mod.program_calls(fn, attrs, "run")
                             + mod.program_calls(fn, attrs, "buffers")):
                    if call.args:
                        yield from self._unbucketed(mod, fn, call.args[0],
                                                    seen)

    def _unbucketed(self, mod: LintModule, fn, key,
                    seen: set) -> Iterator[Finding]:
        for expr in _bound_exprs(fn, key):
            for sub in ast.walk(expr):
                if not (isinstance(sub, ast.Call)
                        and isinstance(sub.func, ast.Name)
                        and sub.func.id == "len") or sub in seen:
                    continue
                seen.add(sub)
                if any(isinstance(anc, ast.Call) and _BUCKETING.search(
                        getattr(anc.func, "id",
                                getattr(anc.func, "attr", "")) or "")
                       for anc in mod.ancestors(sub)):
                    continue
                yield self.finding(
                    mod, sub,
                    "decode program keyed by a per-request len() with no "
                    "bucketing: one capture (and one graph's memory) per "
                    "distinct batch size; key by the scheduler's padded "
                    "bucket")
