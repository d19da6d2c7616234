"""KGCT002 host-sync-in-hot-path: no hidden device->host syncs in step().

Every device->host synchronization reachable from an Engine class's
``step``/``_step*`` methods stalls the dispatch pipeline for a full round
trip: the host waits for the card to drain its queue, and the next launch
starts on an idle card. The sanctioned syncs of a step live inside
``with ph("device_fetch")``, where the phase attribution makes their cost
visible in /metrics; a sync anywhere else on the hot path is an invisible
TTFT/TPOT tax.

Torch spellings: ``.item()``, ``.cpu()``, ``.tolist()``, ``.numpy()``,
``torch.cuda.synchronize``, ``Event.synchronize`` / ``Stream.synchronize``
(any ``.synchronize()``) and the engine's own ``self._sync()``; the JAX
package's ``.block_until_ready()`` and ``jax.device_get`` stay in the set.
``float()``/``int()``/``bool()`` on a forward's or sampler's result is the
same sync in implicit clothing.

A helper the hot path reaches only from inside a fetch window (the
engine's ``_sync`` and ``_finish_fetch``) inherits the window's sanction
(``LintModule.unfetched_hot_path_functions``); called from anywhere else
on the hot path, its body is policed like any other.
"""

from __future__ import annotations

import ast
import re
from typing import Iterator

from ..core import Finding, LintModule, Rule, _dotted

SYNC_METHOD_CALLS = frozenset({"item", "cpu", "tolist", "numpy",
                               "synchronize", "block_until_ready"})
SYNC_DOTTED = frozenset({"jax.device_get", "torch.cuda.synchronize"})
SYNC_SELF_CALLS = frozenset({"_sync"})
IMPLICIT_SYNC_BUILTINS = frozenset({"float", "int", "bool"})
# Calls whose result lives on the device: the JAX package's compiled step
# programs (``self._decode_fn``) and the port's forwards and samplers.
_DEVICE_RESULT_ATTR = re.compile(
    r"^(_\w+_fn|_forward|_sample|_verify|forward_\w+|compute_logits)$")


def _device_result_names(fn: ast.AST) -> set:
    """Names bound from device-result calls in ``fn``."""
    names: set = set()
    for node in ast.walk(fn):
        if not (isinstance(node, ast.Assign)
                and isinstance(node.value, ast.Call)
                and isinstance(node.value.func, ast.Attribute)
                and _DEVICE_RESULT_ATTR.match(node.value.func.attr)):
            continue
        for tgt in node.targets:
            for leaf in ast.walk(tgt):
                if isinstance(leaf, ast.Name):
                    names.add(leaf.id)
    return names


def _base_name(node: ast.AST):
    """``x`` for ``x`` and ``x[...]``."""
    while isinstance(node, ast.Subscript):
        node = node.value
    return node.id if isinstance(node, ast.Name) else None


def _sync_spelling(node: ast.Call, device_names: set):
    callee = node.func
    dotted = _dotted(callee)
    if dotted in SYNC_DOTTED:
        return dotted
    if isinstance(callee, ast.Attribute):
        if (callee.attr in SYNC_SELF_CALLS
                and isinstance(callee.value, ast.Name)
                and callee.value.id == "self"):
            return f"self.{callee.attr}()"
        if callee.attr in SYNC_METHOD_CALLS:
            return f".{callee.attr}()"
    if (isinstance(callee, ast.Name)
            and callee.id in IMPLICIT_SYNC_BUILTINS and node.args
            and _base_name(node.args[0]) in device_names):
        return f"{callee.id}() on a device result"
    return None


class HostSyncRule(Rule):
    code = "KGCT002"
    name = "host-sync-in-hot-path"
    description = (".item()/.cpu()/.tolist()/.numpy()/synchronize (or "
                   "implicit float()/int()/bool() on a device result) "
                   "reachable from Engine.step outside the device_fetch "
                   "phase window")

    def check(self, mod: LintModule) -> Iterator[Finding]:
        for fn in mod.unfetched_hot_path_functions:
            device_names = _device_result_names(fn)
            for node in ast.walk(fn):
                if not isinstance(node, ast.Call):
                    continue
                sync = _sync_spelling(node, device_names)
                if sync is None:
                    continue
                if mod.inside_phase_block(node, "device_fetch"):
                    continue    # the sanctioned, phase-attributed sync point
                yield self.finding(
                    mod, node,
                    f"host sync {sync} in hot-path {fn.name!r} outside a "
                    "with ph(\"device_fetch\") window — stalls dispatch "
                    "unattributed; move it into the fetch phase or off the "
                    "step path")
