"""Conditional stages of the step programs: the port's ``lax.cond``.

The JAX step programs skip their costly stages (logit bias, penalties and
their counts, the sampled path, the filter stage and its tiers, top
logprobs) with ``lax.cond`` on flags they compute on the device. The port
computes the same flags on the host from the batch (the JAX expressions,
on the same arrays) and uploads them with a step's other static inputs, so
one program serves every mix of rows, as one jit program does.

``when(name, flag, then, otherwise)`` is one such stage:

- outside a capture (the CPU, ``enforce_eager``, a program's eager
  warm-up), a Python branch on the host flag (``name`` names the stage
  for a reader, and for tests that count the stages run);
- inside a capture opened with ``capturing`` (``StepPrograms._capture``),
  a CUDA-graph conditional node on the device flag, its body ``then``; and
  with ``otherwise``, a second node on the flag's negation (an if/else from
  two if-nodes). Both branches write into the same tensors, made before
  the gate, so what follows reads one result whichever ran; a replay after
  the flag flips leaves nothing of the other branch behind.

A plain ``bool`` flag is a Python branch everywhere (a program's static
choice). ``when_device`` gates on a value computed on the device by the
program itself (the filter tiers' ``ok``); it exists only inside a
capture: eagerly the caller computes both sides and picks with
``torch.where``, so no step reads the device from the host.

Inside a capture each nesting depth captures its bodies from one stream of
the caller's, reused by every gate: the caching allocator keeps its blocks
per stream, so the bodies of one depth share their scratch. While a body
captures, the program's memory pool takes that stream's allocations. A
body whose capture CUDA voids leaves its node half built, which CUDA
cannot end or destroy safely; so a program takes every branch once in a
throwaway capture with ``inline`` gates first, where such a body fails
the capture as any other capture fails.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, NamedTuple, Optional, Union

import torch

from .cuda import graph_gate


class Flag(NamedTuple):
    """A per-step flag: the host's value and its device copy (one int32
    of a program's static inputs, filled by the step's upload)."""
    host: bool
    device: torch.Tensor


_state = threading.local()


class _Gates:
    """The gates of one capture on this thread."""

    def __init__(self, device: torch.device, pool, children: list,
                 inline: bool):
        self.index = device_index(device)
        self.device = device
        self.pool = pool
        self.children = children
        self.inline = inline
        self.depth = 0

    def _route_current_stream(self) -> None:
        """Make the pool take the current stream's allocations, in place of
        whatever stream it took them from. A filter begun here holds no
        reference to the pool (the capture's own keeps it alive), so a
        capture that ends, or fails, anywhere leaves the count as PyTorch
        reckons it."""
        torch._C._cuda_endAllocateToPool(self.index, self.pool)
        torch._C._cuda_beginAllocateCurrentStreamToPool(self.index, self.pool)
        torch._C._cuda_releasePool(self.index, self.pool)

    def gate(self, flag: torch.Tensor, body: Callable, negate: bool) -> None:
        """``body`` captured as the body of a conditional node on ``flag``
        (or, ``inline``, into the graph as it is)."""
        if self.inline:
            body()
            return
        parent = torch.cuda.current_stream(self.device)
        if len(self.children) <= self.depth:
            self.children.append(torch.cuda.Stream(self.device))
        child = self.children[self.depth]
        graph_gate.open_gate(parent.cuda_stream, flag, negate,
                             child.cuda_stream)
        self.depth += 1
        try:
            with torch.cuda.stream(child):
                self._route_current_stream()
                body()
        except BaseException:
            self._close(child, failed=True)
            raise
        self._close(child, failed=False)

    def _close(self, child: torch.cuda.Stream, failed: bool) -> None:
        """End ``child``'s body capture and route the pool back to the
        parent stream; after a failed body, its own error is the one to
        raise."""
        self.depth -= 1
        try:
            graph_gate.close_gate(child.cuda_stream)
        except RuntimeError:
            if not failed:
                raise
        finally:
            self._route_current_stream()


def device_index(device: torch.device) -> int:
    """``device``'s card index (the current card's for a bare "cuda")."""
    return (device.index if device.index is not None
            else torch.cuda.current_device())


@contextlib.contextmanager
def capturing(device: torch.device, pool, children: list,
              inline: bool = False):
    """Open on the capturing thread around ``capture_begin`` ..
    ``capture_end`` of a graph captured into ``pool``: gates inside become
    conditional nodes. ``children`` holds the caller's body streams, one
    per nesting depth (made here as needed; keep the list with the pool).
    ``inline`` captures every branch of every gate into the graph as it is,
    one after another, and makes no node: a throwaway capture that takes
    each branch once (``collecting``; its first call's set-up; a branch a
    capture refuses fails there as a plain capture fails)."""
    gates = _Gates(device, pool, children, inline)
    outer = getattr(_state, "gates", None)
    _state.gates = gates
    try:
        yield gates
    finally:
        _state.gates = outer


@contextlib.contextmanager
def collecting():
    """Open around a program's eager warm-up on this thread: every gate the
    body meets outside another gate's branch has its branches listed (each
    ``then`` and ``otherwise``, the one the host flags took too), so that a
    throwaway capture can take each of them once (``StepPrograms._capture``:
    nested gates inside them run there inline). Yields the list."""
    outer = getattr(_state, "branches", None)
    _state.branches = branches = []
    _state.nested = 0
    try:
        yield branches
    finally:
        _state.branches = outer


def _eager(fn: Callable) -> None:
    """Run a gate's branch eagerly; gates met inside it are nested ones,
    which ``collecting`` does not list (the throwaway capture runs them
    inline inside their outer branch)."""
    _state.nested = getattr(_state, "nested", 0) + 1
    try:
        fn()
    finally:
        _state.nested -= 1


def in_capture() -> bool:
    """True inside ``capturing`` on this thread."""
    return getattr(_state, "gates", None) is not None


def when(name: str, flag: Union[bool, Flag], then: Callable,
         otherwise: Optional[Callable] = None) -> None:
    """Run ``then`` where ``flag`` holds, else ``otherwise`` (if given)."""
    if isinstance(flag, bool):
        branch = then if flag else otherwise
        if branch is not None:
            branch()
        return
    gates = getattr(_state, "gates", None)
    if gates is None:
        branches = getattr(_state, "branches", None)
        if branches is not None and not _state.nested:
            branches += [then] + ([otherwise] if otherwise else [])
        branch = then if flag.host else otherwise
        if branch is not None:
            _eager(branch)
        return
    gates.gate(flag.device, then, False)
    if otherwise is not None:
        gates.gate(flag.device, otherwise, True)


def when_device(pred: torch.Tensor, then: Callable,
                negate: bool = False) -> None:
    """Inside a capture only: ``then`` as a conditional node on ``pred``,
    one bool or int32 the program computed (its negation with
    ``negate``)."""
    gates = getattr(_state, "gates", None)
    if gates is None:
        raise RuntimeError("when_device gates a captured program only; "
                           "eagerly pick with torch.where")
    gates.gate(pred, then, negate)
