"""KGCT007 metric-hygiene: bounded metric registration and cardinality.

Prometheus state must be registered ONCE per process (module scope or an
owning object's ``__init__``) — constructing a Histogram/Counter/Gauge in
request- or step-scope silently forks the series: every scrape sees a
fresh, near-empty cell and the aggregated history is gone.

Label values must come from a BOUNDED set. A request id (or any f-string
embedding one) as a label value grows one series per request until the
scrape payload and the Prometheus head explode — the textbook cardinality
incident. Bounded enums (outcome, phase, kind) are the pattern.
"""

from __future__ import annotations

import ast
import re
from typing import Iterator

from ..core import Finding, LintModule, Rule

_METRIC_CTORS = re.compile(r"(Histogram|Counter|Gauge|Summary)$")
_CTOR_OK_SCOPES = frozenset({"__init__", "__post_init__"})
_UNBOUNDED_NAME = re.compile(r"request_id|req_id|\brid\b", re.I)


class MetricHygieneRule(Rule):
    code = "KGCT007"
    name = "metric-hygiene"
    description = ("metric constructed outside module scope/owning "
                   "__init__, or label values from an unbounded set "
                   "(request ids, f-strings)")

    def check(self, mod: LintModule) -> Iterator[Finding]:
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            callee = node.func
            ctor_name = (callee.id if isinstance(callee, ast.Name)
                         else getattr(callee, "attr", ""))
            if _METRIC_CTORS.search(ctor_name or ""):
                # skip the class's own definition module internals (methods
                # of the metric class itself don't construct it)
                fn = mod.enclosing_function(node)
                if fn is not None and fn.name not in _CTOR_OK_SCOPES:
                    yield self.finding(
                        mod, node,
                        f"{ctor_name} constructed inside {fn.name!r}: "
                        "metric state must be process-lifetime (module "
                        "scope or the owning object's __init__) or every "
                        "scrape sees a fresh series")
                # constructor label NAMES that promise unbounded values
                for kw in node.keywords:
                    if kw.arg == "labels" and _UNBOUNDED_NAME.search(
                            ast.dump(kw.value)):
                        yield self.finding(
                            mod, kw.value,
                            f"{ctor_name} declares a per-request label — "
                            "one series per request is unbounded "
                            "cardinality; label with a bounded enum")
                continue
            # observe()/labels() with unbounded label VALUES
            if (isinstance(callee, ast.Attribute)
                    and callee.attr in ("observe", "labels")):
                label_args = list(node.args[1:]) if callee.attr == "observe" \
                    else list(node.args)
                label_args += [kw.value for kw in node.keywords]
                for arg in label_args:
                    exprs = arg.elts if isinstance(arg, (ast.Tuple, ast.List)) \
                        else [arg]
                    for e in exprs:
                        if isinstance(e, ast.JoinedStr) or (
                                isinstance(e, (ast.Name, ast.Attribute))
                                and _UNBOUNDED_NAME.search(
                                    ast.dump(e))):
                            yield self.finding(
                                mod, e,
                                f".{callee.attr}() label value from an "
                                "unbounded set (f-string / request id): "
                                "one series per distinct value; use a "
                                "bounded enum label")
