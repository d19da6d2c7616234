"""KGCT008 logging-hygiene: lazy %-formatting only, everywhere.

An eagerly formatted log call (f-string, ``%`` / ``+`` / ``.format()`` at
the call site) pays its formatting cost even when the level is filtered —
and on the engine hot path the cost is not strings: formatting a
``jax.Array`` calls ``__repr__``, which is a full device->host sync. A
DEBUG log line that "never runs" then stalls every production step.
``logger.info("x: %s", y)`` defers both the formatting and the sync to
the handler, which filtered-out levels never reach.
"""

from __future__ import annotations

import ast
import re
from typing import Iterator

from ..core import Finding, LintModule, Rule

_LOG_METHODS = frozenset({"debug", "info", "warning", "error", "exception",
                          "critical", "log"})
_LOGGERISH = re.compile(r"log", re.I)


class LoggingHygieneRule(Rule):
    code = "KGCT008"
    name = "logging-hygiene"
    description = ("eagerly formatted logger call (f-string / % / + / "
                   ".format()) — formats (and device-syncs arrays) even "
                   "when the level is filtered")

    def check(self, mod: LintModule) -> Iterator[Finding]:
        for node in ast.walk(mod.tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in _LOG_METHODS):
                continue
            base = node.func.value
            base_name = (base.id if isinstance(base, ast.Name)
                         else getattr(base, "attr", ""))
            if not (base_name and _LOGGERISH.search(base_name)):
                continue
            # .log(level, msg, ...) carries the template second
            idx = 1 if node.func.attr == "log" else 0
            if idx >= len(node.args):
                continue
            msg = node.args[idx]
            eager = None
            if isinstance(msg, ast.JoinedStr):
                eager = "f-string"
            elif isinstance(msg, ast.BinOp) and isinstance(msg.op, ast.Mod):
                eager = "% interpolation at the call site"
            elif isinstance(msg, ast.BinOp) and isinstance(msg.op, ast.Add):
                eager = "string concatenation"
            elif (isinstance(msg, ast.Call)
                  and isinstance(msg.func, ast.Attribute)
                  and msg.func.attr == "format"):
                eager = ".format()"
            if eager:
                yield self.finding(
                    mod, msg,
                    f"eagerly formatted log message ({eager}): formats — "
                    "and device-syncs any embedded array — even when the "
                    "level is filtered; pass a %-template with args "
                    "(logger.info(\"x: %s\", y))")
