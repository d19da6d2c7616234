"""KGCT013 kv-export-boundary: KV pages cross the process boundary only
through the sanctioned export/import seam.

Disaggregated prefill/decode serving ships KV pages between replicas, and
the two-tier cache ships them between device and host. Every one of those
transfers must flow through ``engine/kv_cache.py``'s gather/scatter
primitives (``KVTransferPrograms`` / ``KVSwapper`` / ``KVPageIO``): they
are the only code that honors the ordering contracts (the copy completes,
or its event is held, before the pages can be freed — KGCT010) and moves
pages through pinned host buffers on the transfer stream. A raw fetch of
the KV pool anywhere else is an unsanctioned device fetch: it silently
forks a second transfer path with none of those guarantees — a host sync
on an arbitrary thread, racing the step that writes the pool.

Fetch spellings: torch's ``.cpu()``, ``.numpy()``, ``.tolist()``,
``.to("cpu")`` (or ``device="cpu"`` / ``torch.device("cpu")``) and
``dst.copy_(<pool>)``, beside the JAX package's ``np.asarray`` /
``jax.device_get``.

Scope: the whole package except ``engine/kv_cache.py`` itself (the seam's
home). The heuristic keys on the source expression: a fetch whose source's
attribute chain contains a KV-pool name segment (``kv_cache`` / ``kv`` /
``kv_pool`` / ``host_pool``) fires.
"""

from __future__ import annotations

import ast
from typing import Iterator

from ..core import Finding, LintModule, Rule

_EXEMPT = "engine/kv_cache.py"
# Device-fetch spellings: numpy materialization and explicit device_get.
_FETCH_DOTTED = frozenset({"np.asarray", "numpy.asarray", "np.array",
                           "numpy.array", "jax.device_get"})
# torch: methods whose receiver is the fetched tensor.
_FETCH_METHODS = frozenset({"cpu", "numpy", "tolist"})
_KV_SEGMENTS = frozenset({"kv_cache", "kv", "kv_pool", "host_pool"})


def _dotted(node: ast.AST) -> str:
    parts: list[str] = []
    while True:
        if isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        elif isinstance(node, ast.Subscript):
            node = node.value
        elif isinstance(node, ast.Name):
            parts.append(node.id)
            break
        else:
            break
    return ".".join(reversed(parts))


def _names_cpu(node: ast.AST) -> bool:
    """``"cpu"`` or ``torch.device("cpu")``."""
    if isinstance(node, ast.Constant):
        return node.value == "cpu"
    return (isinstance(node, ast.Call) and _dotted(node.func).endswith(
        "device") and bool(node.args) and _names_cpu(node.args[0]))


def _fetched(node: ast.Call):
    """(spelling, source expression) when ``node`` copies a tensor or array
    to the host, else None."""
    fn = _dotted(node.func)
    if node.args and (fn in _FETCH_DOTTED
                      or fn.endswith((".asarray", ".device_get"))):
        return fn, node.args[0]
    if not isinstance(node.func, ast.Attribute):
        return None
    attr, recv = node.func.attr, node.func.value
    if attr in _FETCH_METHODS:
        return f".{attr}()", recv
    if attr == "to" and (any(_names_cpu(a) for a in node.args) or any(
            kw.arg == "device" and _names_cpu(kw.value)
            for kw in node.keywords)):
        return '.to("cpu")', recv
    if attr == "copy_" and node.args:
        return ".copy_()", node.args[0]
    return None


class KVBoundaryRule(Rule):
    code = "KGCT013"
    name = "kv-export-boundary"
    description = ("KV pool fetched to the host outside engine/kv_cache.py's "
                   "sanctioned gather (the export/import seam of "
                   "disaggregated serving and the two-tier cache)")

    def check(self, mod: LintModule) -> Iterator[Finding]:
        relpath = mod.relpath.replace("\\", "/")
        if relpath.endswith(_EXEMPT):
            return
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            hit = _fetched(node)
            if hit is None:
                continue
            fn, src_node = hit
            src = _dotted(src_node)
            segments = set(src.split(".")) if src else set()
            if segments & _KV_SEGMENTS:
                yield self.finding(
                    mod, node,
                    f"device fetch of KV pool contents ({fn} of {src}) "
                    "outside engine/kv_cache.py — KV pages may only cross "
                    "the process/host boundary through the sanctioned "
                    "KVSwapper/KVPageIO gather, which owns the "
                    "fetch-before-free ordering and the pinned transfer "
                    "path (use LLMEngine.export_held/import_request or "
                    "the swapper)")
