"""Graceful drain: SIGTERM -> stop admitting, finish in-flight, flip health.

The k8s pod-termination contract: on delete, the kubelet sends SIGTERM, the
endpoint controller removes the pod from Services, and after
``terminationGracePeriodSeconds`` SIGKILL lands. Today SIGTERM kills
mid-stream generations. With drain wired (deploy/render.py adds the
``preStop`` sleep so endpoint removal outruns the signal):

1. SIGTERM -> ``DrainState.start_drain()``: new completions get an
   OpenAI-shaped 503 + Retry-After (the router/k8s sends them elsewhere);
2. ``/health`` flips 503 immediately, so readiness drops the pod from
   rotation even where the endpoint controller lags;
3. in-flight requests keep streaming until the engine is idle, then the
   state reaches DRAINED and the server may exit well inside the grace
   period.

The state machine is its own tiny object (not server code) so bench,
follower ranks, and tests drive the same transitions the signal handler
does.
"""

from __future__ import annotations

import asyncio
import signal
import time
from typing import Callable, Optional

from ..utils import get_logger

logger = get_logger("resilience.drain")

SERVING, DRAINING, DRAINED = "serving", "draining", "drained"


class DrainState:
    def __init__(self):
        self.state = SERVING
        self.started_at: Optional[float] = None

    @property
    def is_draining(self) -> bool:
        return self.state != SERVING

    @property
    def gauge_value(self) -> int:
        return {SERVING: 0, DRAINING: 1, DRAINED: 2}[self.state]

    def start_drain(self) -> bool:
        """Idempotent (SIGTERM may arrive repeatedly); True on the first."""
        if self.state != SERVING:
            return False
        self.state = DRAINING
        self.started_at = time.monotonic()
        logger.warning("drain started: admissions stopped, health now 503, "
                       "finishing in-flight requests")
        return True

    def mark_drained(self) -> None:
        if self.state == DRAINING:
            self.state = DRAINED
            logger.info("drain complete after %.1fs",
                        time.monotonic() - (self.started_at or 0.0))


async def drain_and_notify(drain: DrainState, engine,
                           grace_s: float = 120.0,
                           on_drained: Optional[Callable[[], None]] = None,
                           poll_s: float = 0.1) -> None:
    """Wait for the engine to go idle (or the grace budget to lapse), then
    mark DRAINED and fire ``on_drained`` (the CLI exits there; embedded
    servers pass their own). In-flight work is not cancelled — that is the
    point."""
    deadline = time.monotonic() + grace_s
    while time.monotonic() < deadline:
        if not engine.engine.has_unfinished_requests():
            break
        await asyncio.sleep(poll_s)
    else:
        logger.error("drain grace (%.0fs) lapsed with requests still in "
                     "flight; exiting anyway", grace_s)
    drain.mark_drained()
    if on_drained is not None:
        on_drained()


def install_sigterm_drain(loop: asyncio.AbstractEventLoop, drain: DrainState,
                          engine, grace_s: float = 120.0,
                          on_drained: Optional[Callable[[], None]] = None,
                          ) -> Callable[[], None]:
    """Register the SIGTERM handler on ``loop``; returns an uninstaller (so
    test servers restore the default disposition on teardown). Installed
    only by the CLI path / opt-in — a library embedding the server must not
    have its process-wide signal handling hijacked by construction."""
    def _on_sigterm():
        if drain.start_drain():
            loop.create_task(
                drain_and_notify(drain, engine, grace_s=grace_s,
                                 on_drained=on_drained))

    loop.add_signal_handler(signal.SIGTERM, _on_sigterm)

    def _uninstall():
        try:
            loop.remove_signal_handler(signal.SIGTERM)
        except (ValueError, RuntimeError):
            pass    # loop already closed

    return _uninstall
