"""AsyncLLMEngine: asyncio front door over the blocking LLMEngine.

The engine's step() blocks on device sync, so it runs on a dedicated worker
thread; request submission and output streaming cross the thread boundary
through a thread-safe inbox and ``loop.call_soon_threadsafe`` fan-out into
per-request asyncio queues. This is the piece the OpenAI server wraps.

The worker thread idles on a condition variable when there is no work — an
idle replica burns no CPU and wakes in O(µs) on the first request.

Disaggregated prefill/decode and migration: ``generate(handoff=state)``
has the worker import an exported KV state (``LLMEngine.import_request``)
instead of prefilling, and falls back to a normal admission when the import
fails; ``generate(hold_kv=True)`` parks a finished request's KV for
``run_in_worker(lambda e: e.export_held(rid))``.

The api_server's fleet plane drives these seams: the prefill replica's
export, the decode replica's import, drain-time ``export_running`` with
``post_exception(StreamMigratedError)`` to sever the client stream, and
``generate(resume_outputs=...)`` for the failover re-dispatch.

Multi-rank serving (``serving/multihost.py``): with ``leader=`` (a
``DirectiveLeader``, on rank 0 of a tp/ep group) every worker-loop
iteration's adds and aborts are broadcast to the follower ranks BEFORE the
local apply and step, so every rank's engine schedules and steps in
lockstep. Handoff imports and KV holds are ignored under a leader (rank 0
alone would leave the followers' schedulers behind). A failed broadcast
fails every waiter, group-aborts the in-flight work and detaches the
leader; a rank of a real process group then stops taking work (its
collectives have no partner left) and flips the watchdog, so the pod is
restarted.

``KGCT_SANITIZE_INTERLEAVE=1`` (``analysis/sanitize.py``) injects seeded
yields at the four loop/worker seam crossings (``generate.submit``,
``generate.stream``, ``worker.wake``, ``worker.step``), never under
``_cv``; off, each hook is one ``is None`` test.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import dataclasses
import itertools
import threading
from typing import AsyncIterator, Optional

import torch

from ..analysis.sanitize import build_interleave_sanitizer
from ..config import EngineConfig
from ..engine import LLMEngine, RequestOutput, SamplingParams
from ..engine.kv_cache import KVTransferRefused
from ..utils import get_logger

logger = get_logger("serving.async_engine")


@dataclasses.dataclass
class StreamChunk:
    """One step's worth of progress for a request."""
    request_id: str
    new_token_ids: list[int]
    output_token_ids: list[int]
    finished: bool
    finish_reason: Optional[str]
    new_logprobs: list[float] = dataclasses.field(default_factory=list)
    new_top_logprobs: list = dataclasses.field(default_factory=list)


class AsyncLLMEngine:
    def __init__(self, config: EngineConfig, params=None,
                 eos_token_id: Optional[int] = None,
                 device: torch.device | str = "cuda", draft_params=None,
                 leader=None, groups=None):
        """``leader``: ``serving.multihost.DirectiveLeader`` when this
        process is rank 0 of a multi-rank group. ``groups``: the engine's
        ``parallel.ParallelGroups`` (None at world size 1)."""
        self.engine = LLMEngine(config, params=params,
                                eos_token_id=eos_token_id, device=device,
                                draft_params=draft_params, groups=groups)
        self.leader = leader
        # resilience watchdog (set by the server): armed around each step()
        # so a hung device dispatch flips /health.
        self.watchdog = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._queues: dict[str, asyncio.Queue] = {}
        # Ids reserved via reserve_request_id whose generate() has not
        # started yet.
        self._reserved: set = set()
        self._inbox: list = []            # (request_id, token_ids, params)
        self._aborts: list[str] = []
        # Disaggregated prefill/decode side-channels, keyed by request id:
        # a KV-handoff state an inbox entry IMPORTS instead of prefilling,
        # and the entries whose finished KV the export seam collects.
        self._handoffs: dict[str, dict] = {}
        self._holds: set = set()
        # Mid-stream failover: already-relayed output token ids to replay
        # as forced context when an entry is admitted.
        self._resumes: dict[str, list] = {}
        # Backdated arrival stamps (time.monotonic).
        self._arrival_t0s: dict[str, float] = {}
        # Serving-layer hook, called on the worker thread with the request
        # id when an import fails and the request falls back to a local
        # prefill.
        self.on_import_fallback = None
        # Worker-thread operations: (fn(engine), future) pairs executed
        # between steps, where every engine/scheduler/device touch is
        # single-threaded by construction.
        self._ops: list = []
        # KGCT_SANITIZE_INTERLEAVE: deterministic seeded yields at the
        # loop/worker seam crossings (None when off — every hook is one
        # `is None` test, byte-identical to the sanitizer being absent).
        self._interleave = build_interleave_sanitizer()
        self._cv = threading.Condition()
        self._shutdown = False
        self._counter = itertools.count()
        self._thread = threading.Thread(target=self._worker, daemon=True,
                                        name="kgct-engine-step-loop")

    # -- lifecycle -----------------------------------------------------------

    def start(self, loop: Optional[asyncio.AbstractEventLoop] = None) -> None:
        # get_running_loop, not get_event_loop: a loop silently CREATED here
        # (never run) would swallow every posted chunk.
        self._loop = loop if loop is not None else asyncio.get_running_loop()
        self._thread.start()

    def shutdown(self) -> None:
        with self._cv:
            self._shutdown = True
            self._cv.notify()
        self._thread.join(timeout=30)
        if self.leader is not None:
            if self._thread.is_alive():
                # A wedged worker may still write the directive sockets;
                # closing now would interleave frames on the followers'
                # NDJSON stream. Leave the sockets to the OS.
                logger.warning("worker thread still alive after join "
                               "timeout; skipping leader close")
            else:
                self.leader.close()

    # -- request API ---------------------------------------------------------

    def next_request_id(self, prefix: str = "cmpl") -> str:
        return f"{prefix}-{next(self._counter)}"

    def reserve_request_id(self, request_id: str) -> bool:
        """Atomically claim ``request_id``'s output-queue slot (False if a
        live request already holds it). Synchronous on the event-loop
        thread — no await between check and claim. Pair it with
        :meth:`release_reservation` on every handler exit path."""
        if request_id in self._queues:
            return False
        self._queues[request_id] = asyncio.Queue()
        self._reserved.add(request_id)
        return True

    def release_reservation(self, request_id: str) -> bool:
        """Free a reservation whose ``generate()`` never STARTED. Returns
        True when a reservation WAS released (the engine never saw the
        request, so the caller must not enqueue an abort for it)."""
        if request_id in self._reserved:
            self._reserved.discard(request_id)
            self._queues.pop(request_id, None)
            return True
        return False

    async def generate(self, request_id: str, prompt_token_ids: list[int],
                       params: SamplingParams, handoff: Optional[dict] = None,
                       hold_kv: bool = False,
                       arrival_t0: Optional[float] = None,
                       resume_outputs: Optional[list] = None
                       ) -> AsyncIterator[StreamChunk]:
        """Submit a request and yield StreamChunks until finished.

        Id contract: serving callers reserve the id first (see
        reserve_request_id); a DIRECT caller must use an id it knows to be
        unique. ``handoff``: an exported KV state the worker imports as
        committed history; when the import fails the request is admitted
        normally (local recompute, the same tokens). ``hold_kv``: park the
        finished request's KV for the export seam. ``resume_outputs``:
        output tokens already relayed elsewhere, replayed as forced context
        when the entry admits without a usable ``handoff``. Under a leader
        ``handoff``, ``hold_kv``, ``arrival_t0`` and ``resume_outputs``
        raise ValueError: rank 0 alone would leave the followers behind."""
        if self.leader is not None and (
                handoff is not None or hold_kv or arrival_t0 is not None
                or resume_outputs):
            raise ValueError("handoff, hold_kv, arrival_t0 and "
                             "resume_outputs are refused under a multihost "
                             "leader")
        izer = self._interleave
        if izer is not None and izer.decide("generate.submit")[0]:
            # Equivalent to the caller being scheduled later: runs before
            # the reservation consume, so no new await-window opens
            # between a guard and its claim.
            await asyncio.sleep(0)
        if request_id in self._reserved:
            self._reserved.discard(request_id)
            queue: asyncio.Queue = self._queues[request_id]
        else:
            # Direct (unreserved) callers get a FRESH queue: two consumers
            # must never share one.
            queue = asyncio.Queue()
            self._queues[request_id] = queue
        with self._cv:
            if handoff is not None:
                self._handoffs[request_id] = handoff
            if hold_kv:
                self._holds.add(request_id)
            if arrival_t0 is not None:
                self._arrival_t0s[request_id] = arrival_t0
            if resume_outputs:
                self._resumes[request_id] = list(resume_outputs)
            self._inbox.append((request_id, prompt_token_ids, params))
            self._cv.notify()
        try:
            while True:
                chunk = await queue.get()
                if izer is not None and izer.decide("generate.stream")[0]:
                    await asyncio.sleep(0)
                if isinstance(chunk, Exception):
                    raise chunk
                yield chunk
                if chunk.finished:
                    return
        finally:
            self._queues.pop(request_id, None)

    def abort(self, request_id: str) -> None:
        with self._cv:
            self._aborts.append(request_id)
            self._cv.notify()

    def post_exception(self, request_id: str, exc: Exception) -> None:
        """Fail a live stream's consumer with ``exc`` (thread-safe; no-op
        when the queue is gone)."""
        self._post_exc(request_id, exc)

    def run_in_worker(self, fn):
        """Awaitable execution of ``fn(engine)`` on the worker thread — the
        one place engine/scheduler/device state may be touched outside
        step() without racing it."""
        fut: concurrent.futures.Future = concurrent.futures.Future()
        with self._cv:
            if self._worker_dead():
                fut.set_exception(RuntimeError("engine shut down"))
            else:
                self._ops.append((fn, fut))
                self._cv.notify()
        return asyncio.wrap_future(fut)

    def post_to_worker(self, fn) -> None:
        """Fire-and-forget variant of :meth:`run_in_worker`."""
        with self._cv:
            if self._worker_dead():
                logger.warning("worker op dropped: engine shut down")
                return
            self._ops.append((fn, None))
            self._cv.notify()

    def _worker_dead(self) -> bool:
        """Caller holds ``_cv``. True once no future wakeup can drain
        ``_ops``."""
        return self._shutdown or (self._thread.ident is not None
                                  and not self._thread.is_alive())

    # -- worker thread -------------------------------------------------------

    def _worker(self) -> None:
        izer = self._interleave
        while True:
            with self._cv:
                while not (self._shutdown or self._inbox or self._aborts
                           or self._ops
                           or self.engine.has_unfinished_requests()):
                    self._cv.wait()
                inbox, self._inbox = self._inbox, []
                aborts, self._aborts = self._aborts, []
                ops, self._ops = self._ops, []
                if self._shutdown:
                    for _, fut in ops:
                        if fut is not None:
                            fut.set_exception(
                                RuntimeError("engine shut down"))
                    return
            if izer is not None:
                # Post-wake, OUTSIDE _cv (a sleep under a loop-contended
                # lock is the KGCT021 bug class itself): widen the window
                # between inbox capture and ops/admission/step.
                izer.worker_yield("worker.wake")
            for fn, fut in ops:
                try:
                    result = fn(self.engine)
                except BaseException as e:
                    if fut is not None:
                        fut.set_exception(e)
                    else:
                        logger.exception("worker op failed")
                else:
                    if fut is not None:
                        fut.set_result(result)
            # A request whose add and abort arrived in the same wakeup must
            # not be admitted: the abort would no-op and the request would
            # then run orphaned to completion.
            aborted = set(aborts)
            inbox = [item for item in inbox if item[0] not in aborted]
            for rid in aborted:
                self._handoffs.pop(rid, None)
                self._holds.discard(rid)
                self._arrival_t0s.pop(rid, None)
                self._resumes.pop(rid, None)
            if self.leader is not None and not self._broadcast(inbox, aborts):
                if self.engine.groups is not None:
                    return
                continue
            for rid in aborts:
                self.engine.abort_request(rid)
                self._post(StreamChunk(rid, [], [], True, "abort"))
            for rid, ids, params in inbox:
                handoff = self._handoffs.pop(rid, None)
                arrival_t0 = self._arrival_t0s.pop(rid, None)
                hold = rid in self._holds
                self._holds.discard(rid)
                try:
                    if handoff is not None:
                        # import_request pops the stamp; keep it so a failed
                        # import backdates the recompute admission.
                        if arrival_t0 is None:
                            arrival_t0 = handoff.get("_ttft_t0")
                        if self._import(rid, ids, params, handoff):
                            self._resumes.pop(rid, None)
                            continue
                    self.engine.add_request(
                        rid, ids, params, hold_kv=hold,
                        arrival_t0=arrival_t0,
                        resume_outputs=self._resumes.pop(rid, None))
                except ValueError as e:   # oversized prompt etc.
                    self._post_exc(rid, e)
            if self.engine.has_unfinished_requests():
                if izer is not None:
                    # Between admission and dispatch: the window a loop-
                    # side engine-state read (KGCT020) would race.
                    izer.worker_yield("worker.step")
                wd = self.watchdog
                if wd is not None:
                    wd.arm()
                try:
                    for out in self.engine.step():
                        self._post(_chunk_of(out))
                except Exception as e:  # engine wedged: fail all waiters
                    logger.exception("engine step failed")
                    self.engine.obs.flight.dump("engine_step_failed",
                                                error=str(e))
                    if wd is not None:
                        wd.mark_dead(f"engine step raised: {e}")
                    for rid in list(self._queues):
                        self._post_exc(rid, e)
                    with self._cv:
                        self._shutdown = True
                        ops, self._ops = self._ops, []
                    for _, fut in ops:
                        if fut is not None:
                            fut.set_exception(
                                RuntimeError(f"engine step raised: {e}"))
                    return
                if wd is not None:
                    wd.disarm()

    def _broadcast(self, inbox: list, aborts: list) -> bool:
        """Send this iteration's events to the follower ranks before the
        local apply and step. On failure (a dead follower; the process
        group is broken): fail every waiter first, detach the leader and
        group-abort the in-flight work under the armed watchdog. A rank of
        a real process group then stops the worker and marks the watchdog
        dead (no partner is left for its collectives); a single-device
        leader serves on. Returns False after a failure."""
        try:
            self.leader.broadcast(inbox, aborts)
            return True
        except Exception as e:
            logger.exception("directive broadcast failed; group-aborting "
                             "in-flight work")
            cause = e
        err = RuntimeError(f"multihost process group failed: {cause}")
        for rid in list(self._queues):
            self._post_exc(rid, err)
        try:
            self.leader.close()
        except Exception:
            pass
        self.leader = None
        from .multihost import group_abort
        wd = self.watchdog
        if wd is not None:
            wd.arm()
        try:
            group_abort(self.engine)
        except Exception:
            logger.exception("group-abort drain failed")
        finally:
            if wd is not None:
                wd.disarm()
        if self.engine.groups is not None:
            if wd is not None:
                wd.mark_dead(f"process group lost: {cause}")
            with self._cv:
                self._shutdown = True
                ops, self._ops = self._ops, []
            for _, fut in ops:
                if fut is not None:
                    fut.set_exception(RuntimeError(
                        "engine stopped: process group lost"))
        return False

    def _import(self, rid: str, ids: list[int], params: SamplingParams,
                handoff: dict) -> bool:
        """Import ``handoff`` for ``rid`` and post its first chunk; False
        (traced, and reported to ``on_import_fallback``) when the engine
        refuses it — the caller then admits the request normally."""
        try:
            outs = self.engine.import_request(rid, ids, params, handoff)
        except (ValueError, KeyError, KVTransferRefused) as e:
            logger.warning("kv import for %s failed (%s); falling back to "
                           "local prefill", rid, e,
                           extra={"request_id": rid})
            self.engine.obs.tracer.emit("handoff", rid, side="import",
                                        outcome="import_fallback",
                                        error=str(e))
            if self.on_import_fallback is not None:
                try:
                    self.on_import_fallback(rid)
                except Exception:
                    logger.exception("import-fallback hook failed")
            return False
        for out in outs:
            self._post(_chunk_of(out))
        return True

    def _post(self, chunk: StreamChunk) -> None:
        queue = self._queues.get(chunk.request_id)
        if queue is not None and self._loop is not None:
            self._loop.call_soon_threadsafe(queue.put_nowait, chunk)

    def _post_exc(self, request_id: str, exc: Exception) -> None:
        queue = self._queues.get(request_id)
        if queue is not None and self._loop is not None:
            self._loop.call_soon_threadsafe(queue.put_nowait, exc)


def _chunk_of(out: RequestOutput) -> StreamChunk:
    return StreamChunk(
        request_id=out.request_id,
        new_token_ids=list(out.new_token_ids or []),
        output_token_ids=list(out.output_token_ids),
        finished=out.finished,
        finish_reason=out.finish_reason,
        new_logprobs=list(out.new_logprobs or []),
        new_top_logprobs=list(out.new_top_logprobs or []))
