"""Acceptance-adaptive speculation depth (``spec_adaptive_k``).

Speculation only pays when drafts get accepted: a verify step runs S = k+1
forward tokens per row to commit ``accepted + 1``, so at acceptance ratio r
the expected commit is ``r*k + 1`` tokens for ``k+1`` tokens of compute —
below roughly ``r < cost_ratio`` the verify step is pure overhead and plain
decode is strictly faster. Workloads drift (a chat session leaves its
repetitive suffix, a draft model meets out-of-distribution text), so k must
be a CONTROLLED quantity, not a static config.

:class:`AdaptiveK` is that controller: a per-engine rolling window of
(drafted, accepted) draft-token counts, adapted between steps along a
bounded pow-2 ladder ``0, 1, 2, 4, ..., k_max``:

- ratio below ``low`` over a full window -> step DOWN one rung (eventually
  to 0: speculation off, the scheduler falls through to plain decode /
  plain mixed batching);
- ratio above ``high`` -> step UP one rung (capped at ``k_max``);
- at k=0 no spec step runs, so no acceptance signal exists — after
  ``cooldown`` spec-eligible schedule() calls the controller re-probes at
  the smallest non-zero rung, cheap enough to pay while the workload is
  undraftable and instant to climb back when it stops being so.

The ladder is what keeps the COMPILE family bounded: each k the controller
can emit compiles its own verify token width ``R_pad * (k+1)`` per decode
bucket, so restricting k to the pow-2 rungs reuses the same per-k bucket
variants forever — at most ``len(ladder)-1`` spec families, never a fresh
shape per adaptation (tests/test_compile_guard.py pins the bound).

Thread model: touched only from the engine worker thread (scheduler
``schedule()`` reads ``current_k``/ticks idle; engine ``_step_spec*``
observes outcomes) — no locking needed. The live value is exported as the
``kgct_spec_current_k`` gauge.
"""

from __future__ import annotations


def k_ladder(k_max: int) -> tuple[int, ...]:
    """The bounded rung set: 0, then powers of two up to (and always
    including) ``k_max``."""
    if k_max < 1:
        raise ValueError(f"spec k_max must be >= 1, got {k_max}")
    rungs = {0, k_max}
    p = 1
    while p < k_max:
        rungs.add(p)
        p *= 2
    return tuple(sorted(rungs))


class AdaptiveK:
    def __init__(self, k_max: int, window: int = 8,
                 low: float = 0.25, high: float = 0.7,
                 cooldown: int = 64):
        if not (0.0 <= low < high <= 1.0):
            raise ValueError(f"need 0 <= low < high <= 1, got ({low}, {high})")
        self.ladder = k_ladder(k_max)
        self.k_max = k_max
        self.window = max(1, int(window))
        self.low = low
        self.high = high
        self.cooldown = max(1, int(cooldown))
        # Start at the ceiling: the first window measures the workload at
        # full depth; a hostile one decays within window steps per rung.
        self.current_k = k_max
        self._drafted = 0
        self._accepted = 0
        self._steps = 0
        self._idle_ticks = 0
        # Observability: how many times the controller moved (each way).
        self.num_steps_down = 0
        self.num_steps_up = 0

    # -- signals -------------------------------------------------------------

    def observe(self, drafted: int, accepted: int) -> None:
        """One spec/spec-mixed step's REAL-proposal outcome (filler-padded
        slots excluded, matching kgct_spec_acceptance_ratio). Adapts once
        per full window; steps that drafted nothing still count toward the
        window so an all-bowed-out proposer cannot pin k forever."""
        self._idle_ticks = 0
        self._drafted += int(drafted)
        self._accepted += int(accepted)
        self._steps += 1
        if self._steps < self.window:
            return
        ratio = (self._accepted / self._drafted) if self._drafted else 0.0
        if ratio < self.low:
            self._move(-1)
        elif ratio > self.high:
            self._move(+1)
        self._drafted = self._accepted = self._steps = 0

    def tick_idle(self) -> None:
        """One spec-eligible schedule() call while k == 0 (no spec step can
        run). After ``cooldown`` ticks, re-probe at the smallest non-zero
        rung; the next window of real acceptance then decides whether to
        climb or fall back to 0."""
        if self.current_k > 0:
            return
        self._idle_ticks += 1
        if self._idle_ticks >= self.cooldown:
            self._idle_ticks = 0
            self._drafted = self._accepted = self._steps = 0
            self.current_k = self.ladder[1]

    # -- internals -----------------------------------------------------------

    def _move(self, direction: int) -> None:
        i = self.ladder.index(self.current_k)
        j = min(max(i + direction, 0), len(self.ladder) - 1)
        if j < i:
            self.num_steps_down += 1
        elif j > i:
            self.num_steps_up += 1
        self.current_k = self.ladder[j]
