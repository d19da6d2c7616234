"""Engine step watchdog: flag hung device dispatch.

A wedged device dispatch (a device fault, a kernel that never returns, a
collective waiting on a dead peer) blocks the engine worker thread inside
step() forever — requests park, /health keeps saying "ok", and nothing restarts the pod.
The watchdog is a daemon thread watching an armed deadline: the worker arms
it before each step() and disarms after; if a step overstays
``timeout_s`` the watchdog TRIPS — ``healthy`` flips False (the API server's
/health turns 503 so kubelet's liveness probe restarts the pod, the
reference's restart-first runbook made automatic) and
``kgct_watchdog_trips_total`` increments. A step that eventually completes
after a trip recovers ``healthy`` (logged) — transient stalls self-heal
without a restart.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional

from ..utils import get_logger

logger = get_logger("resilience.watchdog")


class StepWatchdog:
    def __init__(self, timeout_s: float = 300.0,
                 on_trip: Optional[Callable[[], None]] = None):
        self.timeout_s = timeout_s
        self.on_trip = on_trip
        self.trips = 0
        self.healthy = True
        self._dead = False
        self._armed_at: Optional[float] = None
        self._tripped_current = False
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def mark_dead(self, reason: str) -> None:
        """Terminal: the engine worker loop exited (step raised, loop dead).
        ``healthy`` goes False and STAYS false — a later disarm must not
        resurrect health for a loop that no longer exists."""
        with self._lock:
            self._dead = True
            self.healthy = False
        logger.error("engine loop dead: %s — /health stays 503 until "
                     "restart", reason)

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._watch, daemon=True, name="kgct-step-watchdog")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    # -- called by the engine worker thread ---------------------------------

    def arm(self) -> None:
        with self._lock:
            self._armed_at = time.monotonic()
            self._tripped_current = False

    def disarm(self) -> None:
        with self._lock:
            self._armed_at = None
            if self._tripped_current and not self._dead:
                # The hung step finished after all — transient stall.
                self._tripped_current = False
                self.healthy = True
                logger.warning("step completed after watchdog trip; "
                               "engine healthy again")

    # -- watcher thread ------------------------------------------------------

    def _watch(self) -> None:
        # Check at a fraction of the deadline so a trip is detected within
        # ~1.25x timeout_s worst case.
        interval = max(self.timeout_s / 4.0, 0.01)
        while not self._stop.wait(interval):
            self._check_once()

    def _check_once(self) -> bool:
        """One deadline check (the watcher loop body; tests call it
        directly for determinism). True iff a trip fired."""
        with self._lock:
            armed_at = self._armed_at
            already = self._tripped_current
        if armed_at is None or already:
            return False
        overstay = time.monotonic() - armed_at
        if overstay <= self.timeout_s:
            return False
        with self._lock:
            if self._armed_at != armed_at or self._tripped_current:
                return False    # step finished or re-armed while we checked
            self._tripped_current = True
            self.trips += 1
            self.healthy = False
        logger.error("watchdog trip: engine step running %.1fs "
                     "(timeout %.1fs) — device dispatch presumed hung",
                     overstay, self.timeout_s)
        if self.on_trip is not None:
            try:
                self.on_trip()
            except Exception:
                logger.exception("watchdog on_trip callback failed")
        return True
