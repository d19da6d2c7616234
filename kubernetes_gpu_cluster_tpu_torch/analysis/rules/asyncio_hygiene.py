"""KGCT006 asyncio-hygiene: the serving event loop must never block.

One blocking call inside an ``async def`` freezes EVERY in-flight stream
on the loop — ``time.sleep(0.5)`` in a handler is a 500 ms TTFT tax on all
concurrent requests, and a sync HTTP/socket call is unbounded. The serving
layer's blocking work (the engine step, directive sockets) lives on
dedicated threads; coroutines use ``asyncio.sleep`` / aiohttp.

Also flagged module-wide: ``asyncio.get_event_loop()`` — deprecated, and
from a non-loop thread it silently CREATES a loop nothing ever runs,
making the cross-thread ``call_soon_threadsafe`` fan-out a black hole.
Use ``get_running_loop()`` or pass the loop explicitly.
"""

from __future__ import annotations

import ast
from typing import Iterator

from ..core import Finding, LintModule, Rule, _dotted

BLOCKING_DOTTED = frozenset({
    "time.sleep",
    "socket.create_connection",
    "subprocess.run", "subprocess.call", "subprocess.check_call",
    "subprocess.check_output", "subprocess.Popen",
    "os.system", "os.waitpid",
    "urllib.request.urlopen",
})
BLOCKING_PREFIXES = ("requests.", "http.client.")


class AsyncioHygieneRule(Rule):
    code = "KGCT006"
    name = "asyncio-hygiene"
    description = ("blocking calls (time.sleep / sync HTTP / subprocess) "
                   "inside async def; asyncio.get_event_loop anywhere")

    def check(self, mod: LintModule) -> Iterator[Finding]:
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            dotted = _dotted(node.func)
            if dotted == "asyncio.get_event_loop":
                yield self.finding(
                    mod, node,
                    "asyncio.get_event_loop() is deprecated and, off-loop, "
                    "silently creates a loop nothing runs — use "
                    "get_running_loop() or pass the loop explicitly")
                continue
            if not (dotted in BLOCKING_DOTTED
                    or dotted.startswith(BLOCKING_PREFIXES)):
                continue
            enclosing = mod.enclosing_function(node)
            if isinstance(enclosing, ast.AsyncFunctionDef):
                yield self.finding(
                    mod, node,
                    f"blocking {dotted}() inside async def "
                    f"{enclosing.name!r} stalls the whole event loop (every "
                    "in-flight stream); use the async equivalent or a "
                    "worker thread")
