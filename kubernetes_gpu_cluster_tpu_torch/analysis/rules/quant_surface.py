"""KGCT009 quant-surface: quantized weights flow only through the fused dot.

The quant ladder's one silent failure mode: a weight named in
``ops.quant.QUANT_LAYER_KEYS`` that reaches a matmul OUTSIDE the sanctioned
dequant-fused consumer (``models.llama._dot``, which dispatches to
``ops/quant.py``'s int8 path and int4 kernel). A raw
``torch.matmul(x, lp["wq"])`` / ``F.linear`` / ``x @ lp["wq"]`` still runs —
int8 silently skips its scale (wrong numerics), int4 multiplies packed
nibbles, and a manual ``lp["wq"].to(torch.bfloat16)`` (``.float()``,
``.half()``, ...) dequantizes the weight into a full-precision HBM copy,
quietly undoing the entire reason the ladder exists (decode is
weight-streaming-bound).

Two checks keep the surface in sync with no allowlist:

- In model modules (``models/``): any matmul primitive call (torch's
  ``matmul`` / ``mm`` / ``bmm`` / ``addmm`` / ``linear`` / ``einsum``, the
  JAX package's ``dot`` / ``dot_general``) or dtype cast (``.to`` /
  ``.float`` / ``.half`` / ``.bfloat16`` / ``.type``, JAX's ``.astype``)
  whose operand subscripts a store with a quantized-key string constant is
  a finding,
  unless it sits inside a sanctioned consumer function (``_dot``); the
  quantization-aware access pattern is ``_dot(x, lp, "wq")`` — key as
  DATA, never direct subscript-into-matmul.
- In ``ops/quant.py``: the ``QUANT_LAYER_KEYS`` literal must equal the
  tuple this rule pins. Extending the eligibility surface therefore forces
  a lint-visible touch here, at which point the reviewer checks the fused
  call sites cover the new key (the per-rule pins in
  tests/test_torch_lint.py and the quant tests do the numeric half).
"""

from __future__ import annotations

import ast
from typing import Iterator

from ..core import Finding, LintModule, Rule, _dotted

# Must mirror the port's ops.quant.QUANT_LAYER_KEYS (+ the quantized head).
# The check against the real literal below turns drift into a finding, not
# a silent divergence — the linter never imports the linted package.
_PINNED_KEYS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
_QUANT_KEYS = frozenset(_PINNED_KEYS) | {"lm_head"}

# Functions allowed to touch quantized weights directly: the fused-dot
# consumer in models/llama.py. (ops/quant.py and ops/cuda are the fused
# implementations themselves and are out of the models/ scope check.)
_SANCTIONED_FNS = frozenset({"_dot"})

_MATMUL_CALLEES = frozenset({"matmul", "mm", "bmm", "addmm", "linear",
                             "einsum", "tensordot", "dot", "dot_general"})
# Dtype casts: torch's, and the JAX package's astype.
_CAST_ATTRS = frozenset({"to", "float", "half", "bfloat16", "double",
                         "type", "astype"})


def _is_quant_subscript(node: ast.AST) -> bool:
    """``<store>["wq"]`` (possibly wrapped in attribute/astype chains)."""
    while isinstance(node, (ast.Attribute, ast.Call)):
        node = node.func.value if (isinstance(node, ast.Call)
                                   and isinstance(node.func, ast.Attribute)
                                   ) else getattr(node, "value", None)
        if node is None:
            return False
    return (isinstance(node, ast.Subscript)
            and isinstance(node.slice, ast.Constant)
            and node.slice.value in _QUANT_KEYS)


class QuantSurfaceRule(Rule):
    code = "KGCT009"
    name = "quant-surface"
    description = ("quantized weight key consumed outside the dequant-fused "
                   "dot, or QUANT_LAYER_KEYS drifted from the rule's pinned "
                   "eligibility surface")

    def check(self, mod: LintModule) -> Iterator[Finding]:
        rel = mod.relpath.replace("\\", "/")
        if rel.endswith("ops/quant.py") or rel == "quant.py":
            yield from self._check_key_literal(mod)
            return
        if "models/" not in rel and not rel.startswith("models"):
            return
        for node in ast.walk(mod.tree):
            is_astype = False
            if isinstance(node, ast.BinOp) and isinstance(node.op,
                                                          ast.MatMult):
                # the ``x @ lp["wq"]`` spelling
                hit = any(_is_quant_subscript(s)
                          for s in (node.left, node.right))
            elif isinstance(node, ast.Call):
                callee = _dotted(node.func)
                is_matmul = callee.rsplit(".", 1)[-1] in _MATMUL_CALLEES
                is_astype = (isinstance(node.func, ast.Attribute)
                             and node.func.attr in _CAST_ATTRS
                             and _is_quant_subscript(node.func.value))
                if not (is_matmul or is_astype):
                    continue
                hit = is_astype or any(_is_quant_subscript(a)
                                       for a in node.args)
            else:
                continue
            if not hit:
                continue
            fn = mod.enclosing_function(node)
            if fn is not None and fn.name in _SANCTIONED_FNS:
                continue
            yield self.finding(
                mod, node,
                "quantized weight key used directly in a "
                f"{'dtype cast' if is_astype else 'matmul'} outside the "
                "fused consumer (_dot): int8 would skip its scale and a "
                "manual astype dequantizes into a full-precision HBM copy — "
                "route it through models.llama._dot (ops.quant's int8 "
                "path and int4_matmul kernel)")

    def _check_key_literal(self, mod: LintModule) -> Iterator[Finding]:
        for node in ast.walk(mod.tree):
            if not (isinstance(node, ast.Assign)
                    and any(isinstance(t, ast.Name)
                            and t.id == "QUANT_LAYER_KEYS"
                            for t in node.targets)):
                continue
            val = node.value
            keys = (tuple(e.value for e in val.elts
                          if isinstance(e, ast.Constant))
                    if isinstance(val, (ast.Tuple, ast.List)) else None)
            if keys != _PINNED_KEYS:
                yield self.finding(
                    mod, node,
                    f"QUANT_LAYER_KEYS {keys!r} drifted from the pinned "
                    f"quant-eligibility surface {_PINNED_KEYS!r}: update "
                    "analysis/rules/quant_surface.py IN THE SAME CHANGE as "
                    "the fused call sites, or the new key silently streams "
                    "unquantized")
            return
        yield self.finding(
            mod, mod.tree,
            "ops/quant.py no longer defines a literal QUANT_LAYER_KEYS "
            "tuple — the quant-surface rule cannot pin the eligibility "
            "surface")
