"""Loop liveness: the contract between a work loop and its health endpoint.

A health endpoint that answers 200 while its engine loop is dead keeps a
zombie rank alive (kubelet never restarts it) while the whole process
group hangs on its collectives. ``LoopLiveness`` closes it: the
loop ``beat()``s on every directive/heartbeat/step it processes, and the
health endpoint reports alive only while beats are recent. A loop that
detects a terminal condition (dead leader, unrecoverable error) calls
``mark_dead(reason)`` so health flips immediately instead of waiting out the
timeout. Thread-safe by GIL-atomicity: single float/bool stores, read by the
health thread, written by the loop thread.
"""

from __future__ import annotations

import time


class LoopLiveness:
    """The timeout clock only starts at the FIRST beat: before the loop has
    ever run (a follower waiting for the leader's lazy connect — which
    happens on the first user request and may be minutes after boot), the
    loop is 'starting', not dead. Flipping 503 on an idle-but-healthy rank
    would make kubelet crash-loop the whole process group."""

    def __init__(self, timeout_s: float = 10.0):
        self.timeout_s = timeout_s
        self._last_beat: float | None = None
        self._dead = False
        self._reason = ""

    def beat(self) -> None:
        self._last_beat = time.monotonic()

    def mark_dead(self, reason: str) -> None:
        self._dead = True
        self._reason = reason

    @property
    def seconds_since_beat(self) -> float:
        if self._last_beat is None:
            return 0.0
        return time.monotonic() - self._last_beat

    def alive(self) -> bool:
        if self._dead:
            return False
        if self._last_beat is None:
            return True         # starting: the loop has not begun yet
        return self.seconds_since_beat <= self.timeout_s

    @property
    def reason(self) -> str:
        """Why the loop is (or would be reported) dead — empty while alive."""
        if self._dead:
            return self._reason
        if not self.alive():
            return (f"no heartbeat for {self.seconds_since_beat:.1f}s "
                    f"(timeout {self.timeout_s:.1f}s)")
        return ""
