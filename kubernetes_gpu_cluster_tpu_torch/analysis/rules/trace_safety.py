"""KGCT001 capture-safety: nothing inside a captured window reads the
device from the host.

The engine's program cache captures each decode window body into a CUDA
graph (``engine/step_programs.py``). Inside a capture a host read cannot
happen: ``.item()``, ``.cpu()``, ``.tolist()``, ``.numpy()``, ``bool()`` /
``int()`` / ``float()`` of a tensor, a synchronize, an ``if`` / ``while`` /
``assert`` on a tensor, or a pageable upload (``torch.from_numpy(...)
.to(device)``) fails the capture at best; a value the host computed from
a tensor during capture is baked into the graph as a constant at worst,
and every replay then reuses it (a step key read with ``int()`` draws the
same randomness every window). Branching on host-side metadata
(``x.shape``, ``len(x)``, the program key, configuration) stays silent;
the body routes runtime decisions through ``torch.where`` on the device
instead (the JAX package's trace-safety rule, for captured graphs).

Scope: every body the module hands to ``StepPrograms`` (or registers
with ``add_families``) and the methods of its class it calls with tensor
arguments (``LintModule.captured_functions``).
"""

from __future__ import annotations

import ast
from typing import Iterator

from ..core import (Finding, LintModule, Rule, _dotted, propagate_taint,
                    tainted_refs)

_SYNC_METHODS = frozenset({"item", "cpu", "tolist", "numpy", "synchronize"})
_SYNC_DOTTED = frozenset({"torch.cuda.synchronize"})
_IMPLICIT = frozenset({"bool", "int", "float"})
_UPLOADS = frozenset({"to", "cuda"})


def _problem(node: ast.AST, tainted: set):
    """(what, kind) when ``node`` reads the device from the host."""
    test = None
    if isinstance(node, (ast.If, ast.While)):
        test, kind = node.test, type(node).__name__.lower()
    elif isinstance(node, ast.IfExp):
        test, kind = node.test, "conditional expression"
    elif isinstance(node, ast.Assert):
        test, kind = node.test, "assert"
    elif isinstance(node, ast.Call):
        callee = node.func
        if _dotted(callee) in _SYNC_DOTTED:
            return f"{_dotted(callee)}()", "host sync"
        if isinstance(callee, ast.Attribute):
            if callee.attr in _SYNC_METHODS:
                return f".{callee.attr}()", "host sync"
            if (callee.attr in _UPLOADS
                    and isinstance(callee.value, ast.Call)
                    and _dotted(callee.value.func) == "torch.from_numpy"):
                return (f"torch.from_numpy(...).{callee.attr}()",
                        "pageable upload")
        if (isinstance(callee, ast.Name) and callee.id in _IMPLICIT
                and node.args):
            test, kind = node.args[0], f"{callee.id}()"
    if test is None:
        return None
    refs = tainted_refs(test, tainted)
    return (f"{sorted(set(refs))}", kind) if refs else None


class TraceSafetyRule(Rule):
    code = "KGCT001"
    name = "capture-safety"
    description = ("host sync, tensor-valued if/while/assert/bool()/int()/"
                   "float() or pageable upload inside a function the "
                   "program cache captures into a CUDA graph")

    def check(self, mod: LintModule) -> Iterator[Finding]:
        seen: set = set()       # a helper two bodies share is reported once
        for cf in mod.captured_functions:
            tainted = propagate_taint(cf.node, cf.tensor_params)
            for node in ast.walk(cf.node):
                hit = _problem(node, tainted)
                if hit is None or id(node) in seen:
                    continue
                seen.add(id(node))
                what, kind = hit
                yield self.finding(
                    mod, node,
                    f"{kind} {what} inside captured {cf.node.name!r}: a "
                    "CUDA graph capture cannot read the device from the "
                    "host (and a value read during capture would be a "
                    "constant of every replay); decide on the device with "
                    "torch.where, or take the value as a static input")
