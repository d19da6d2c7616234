"""KGCT004 donation-safety: never read a replay's outputs after a later
replay.

The captured counterpart of a donated buffer is a program's static output:
every replay of the program writes its window's tokens into the same
tensors (``engine/step_programs.py``), so a reference to a window's
outputs held across the next replay reads the NEXT window's tokens, or a
mix, depending on timing ("dispatch succeeded, decode output wrong" — the
worst failure class, as with a donated buffer). The engine's chained
windows are safe by construction: the successor copies ``dev_out[:, -1]``
into its first tokens BEFORE its replay (stream order), and the
predecessor's tokens leave through the pinned fetch started right after
its own replay.

The rule finds, per class holding a program cache, the methods that
replay (``self.<cache>.run(...)``, and transitively the methods calling
them) and the dict keys under which a replaying method returns its
program's buffers (``{"dev_out": bufs["out_tok"], ...}``). In every method
it flags a read of ``x[<output key>]`` (or of a name bound from one) after
a replaying call when ``x`` was bound before that call and not rebound in
between; a ``.clone()`` of the output is a copy and is not tracked.
Lexical order approximates execution order, as in the JAX rule.
"""

from __future__ import annotations

import ast
from typing import Iterator

from ..core import Finding, LintModule, Rule


def _base(node: ast.AST):
    """The Name an expression ``x[...]...`` reads, else None."""
    while isinstance(node, (ast.Subscript, ast.Attribute)):
        node = node.value
    return node.id if isinstance(node, ast.Name) else None


def _const_key(node: ast.Subscript):
    sl = node.slice
    return sl.value if isinstance(sl, ast.Constant) else None


class DonationSafetyRule(Rule):
    code = "KGCT004"
    name = "donation-safety"
    description = ("a program's static output read after a later replay "
                   "without being copied or rebound before it")

    def check(self, mod: LintModule) -> Iterator[Finding]:
        for cls in mod.classes:
            attrs = mod.program_cache_attrs(cls)
            if not attrs:
                continue
            methods = mod.methods_of(cls)
            replaying = {name for name, fn in methods.items()
                         if mod.program_calls(fn, attrs, "run")}
            out_keys = self._output_keys(mod, methods, replaying, attrs)
            grew = True
            while grew:
                grew = False
                for name, fn in methods.items():
                    if name not in replaying and any(
                            self._self_call(n) in replaying
                            for n in ast.walk(fn)):
                        replaying.add(name)
                        grew = True
            if not out_keys:
                continue
            for fn in methods.values():
                yield from self._check_function(mod, fn, attrs, replaying,
                                                out_keys)

    @staticmethod
    def _self_call(node: ast.AST):
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and isinstance(node.func.value, ast.Name)
                and node.func.value.id == "self"):
            return node.func.attr
        return None

    @staticmethod
    def _output_keys(mod, methods, replaying, attrs) -> set:
        """Dict keys a replaying method returns its buffers under."""
        keys: set = set()
        for name in replaying:
            fn = methods[name]
            bufs = {tgt.id for call in mod.program_calls(fn, attrs, "buffers")
                    for stmt in [mod.parent(call)]
                    if isinstance(stmt, ast.Assign)
                    for tgt in stmt.targets if isinstance(tgt, ast.Name)}
            for ret in ast.walk(fn):
                if not (isinstance(ret, ast.Return)
                        and isinstance(ret.value, ast.Dict)):
                    continue
                for k, v in zip(ret.value.keys, ret.value.values):
                    if (isinstance(k, ast.Constant)
                            and isinstance(v, ast.Subscript)
                            and _base(v) in bufs):
                        keys.add(k.value)
        return keys

    def _check_function(self, mod, fn, attrs, replaying, out_keys):
        replays = [n for n in ast.walk(fn) if isinstance(n, ast.Call) and (
            self._self_call(n) in replaying
            or n in mod.program_calls(fn, attrs, "run"))]
        if not replays:
            return
        # Names bound from an output subscript (not a copy of one).
        aliases = {}
        for node in ast.walk(fn):
            if (isinstance(node, ast.Assign)
                    and isinstance(node.value, ast.Subscript)
                    and _const_key(node.value) in out_keys):
                for tgt in node.targets:
                    if isinstance(tgt, ast.Name):
                        aliases[tgt.id] = node
        stores: dict = {}
        for node in ast.walk(fn):
            if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Store):
                stores.setdefault(node.id, []).append(node.lineno)
        for arg in fn.args.args:
            stores.setdefault(arg.arg, []).append(fn.lineno)
        reported = set()
        for call in replays:
            for node in ast.walk(fn):
                name = None
                if (isinstance(node, ast.Subscript)
                        and isinstance(node.ctx, ast.Load)
                        and _const_key(node) in out_keys):
                    name = _base(node)
                elif (isinstance(node, ast.Name)
                      and isinstance(node.ctx, ast.Load)
                      and node.id in aliases):
                    name = node.id
                if name is None or node.lineno <= call.end_lineno:
                    continue
                lines = stores.get(name, [])
                bound_before = any(ln <= call.lineno for ln in lines)
                rebound = any(call.lineno < ln <= node.lineno
                              for ln in lines)
                if not bound_before or rebound or node in reported:
                    continue
                reported.add(node)
                yield self.finding(
                    mod, node,
                    f"{name!r} holds a decode program's static output, read"
                    f" after the replay at line {call.lineno} overwrote it;"
                    " copy it (or take what it feeds) before that replay")
