"""OpenAI-compatible HTTP server over AsyncLLMEngine: the JAX package's
``serving/api_server.py`` on ``serving/http.py``.

Endpoints (routes, JSON and SSE shapes, messages and status codes are the
JAX package's):

- ``POST /v1/completions``        text in -> text out, optional SSE streaming
- ``POST /v1/chat/completions``   chat messages via the model's chat template
- ``GET  /v1/models``             the model card the router aggregates
- ``GET  /health``                liveness + engine queue depth (503 while
                                  draining or when the step watchdog trips)
- ``GET  /metrics``               Prometheus text format (serving.metrics)
- ``GET  /debug/trace``           request-lifecycle + step-phase trace
                                  (Chrome/Perfetto trace-event JSON)
- ``GET  /debug/flightrecorder``  black-box ring: recent events + state
                                  snapshots (auto-dumped on watchdog trip
                                  and SIGTERM drain)
- ``POST /debug/profile``         torch.profiler capture of live traffic
- ``POST /internal/kv_handoff``   the fleet plane (below): a prefill
                                  export, or (octet-stream) a migration push
- ``POST /internal/resume``       the router's failover re-dispatch
- ``POST /internal/fetch_prefix`` a peer's fleet-cache prefix pull
- ``POST /internal/fleet_spill``  a peer's remote-spilled prefix page

Fleet tracing: an inbound ``x-kgct-request-id`` (the router's mint) is
adopted as the ENGINE request id and every /v1 response echoes the id,
success or error (serving/errors.py owns the header contract).

Completion bodies may carry ``session_id`` (or OpenAI's ``user``): scalar
affinity keys the prefix-affinity router peeks at. The server validates the
type (400 on non-scalars) and otherwise ignores them.

Stop semantics: stop TOKEN ids fire inside the engine; stop STRINGS are
evaluated here on incrementally detokenized text (IncrementalDetokenizer
holds back a potential partial match, then the request is aborted
engine-side so no further device work is spent on it).

Fault tolerance (``resilience``): requests may carry a TTFT budget in the
``x-kgct-ttft-budget-ms`` header (or inherit
``ResilienceConfig.default_ttft_budget_ms``); a request whose budget is
already blown by the estimated queue wait is SHED with an OpenAI-shaped
``429 + Retry-After``. SIGTERM (CLI path) starts a graceful drain:
admissions stop with 503, ``/health`` flips, running streams with a
router-named peer are live-migrated there, and the rest finish before
exit. A step watchdog flips ``/health`` when device dispatch hangs.

The fleet plane, driven by router-set headers (serving/errors.py):
disaggregated prefill/decode (``role`` prefill/decode, the decode replica
pulls the prefilled KV named by ``x-kgct-prefill-url``), the fleet prefix
cache (``fleet_prefix_cache``: pull the owner's cached prefix named by
``x-kgct-prefix-source``, serve peers' fetches, remote-spill evicted pages
to ``peer_pool``), and drain-time live migration to ``x-kgct-migrate-url``
with the router's ``/internal/resume`` re-dispatch. Frames go through
``serving/handoff.py`` (byte for byte the JAX package's wire, CRC32
integrity on by default), peer calls through the standard-library client
of ``serving/http.py``. Every failed pull or push degrades to local
recompute (the same tokens, slower), counted on ``/metrics`` and traced.
Tensor, expert, pipeline and sequence parallelism
(``--tensor-parallel-size``, ``--expert-parallel-size``,
``--pipeline-parallel-size``, ``--sequence-parallel-size``): rank 0 serves
the API and broadcasts each engine-loop iteration's adds and aborts to the
follower ranks of every stage (``serving/multihost.py``), which serve only
``/health``. With ``--distributed`` each rank is its own pod (``KGCT_*``
environment, ``parallel/mesh.py``); without it, on one node, rank 0 starts
the other ranks as local processes on the next cards. KV handoff,
migration and the fleet prefix cache are off under a leader.
"""

from __future__ import annotations

import asyncio
import dataclasses
import json
import math
import os
import tempfile
import time
from typing import Any, Optional

import torch

from ..config import EngineConfig
from ..config.engine_config import ResilienceConfig
from ..engine import SamplingParams
from ..engine.qos import resolve_tier_name, tenant_key_of
from ..observability import Histogram
from ..parallel.mesh import initialize_distributed, mesh_from_config
from ..resilience import (AdmissionController, DrainState, ResilienceHub,
                          StepWatchdog)
from ..resilience.drain import drain_and_notify
from ..resilience.faults import fault_value as _fault_value
from ..resilience.faults import inject as _inject_fault
from ..utils import get_logger
from .async_engine import AsyncLLMEngine
from .errors import (MIGRATE_URL_HEADER, PREFILL_URL_HEADER,
                     PREFIX_SOURCE_HEADER, QOS_TIER_HEADER, REQUEST_ID_HEADER,
                     RESUME_MODE_HEADER, StreamMigratedError,
                     valid_request_id)
from .errors import overloaded_error as _overloaded
from .fleet_cache import PeerScoreboard, SpillQueue, build_pull_policy
from .handoff import (HANDOFF_TIMEOUT_S, MIGRATE_PUSH_TIMEOUT_S,
                      PREFIX_PULL_TIMEOUT_S, MigrationStore,
                      PrefixStreamDecoder, ProtocolSkewError,
                      WireCorruptionError, decode_handoff, decode_spill_frame,
                      encode_handoff, encode_prefix_frames,
                      encode_spill_frame, fetch_handoff, handoff_request_body,
                      push_handoff, verify_import_state)
from .http import (Application, ClientSession, Request, Response,
                   StreamResponse, json_response, run_app)
from .metrics import Metrics
from .tokenizer import (IncrementalDetokenizer, Tokenizer,
                        apply_chat_template, load_tokenizer)

logger = get_logger("serving.api")

# Per-request TTFT budget (milliseconds). Absent -> the config default;
# both absent -> admit unconditionally.
TTFT_BUDGET_HEADER = "x-kgct-ttft-budget-ms"

# Replica roles (disaggregated prefill/decode serving): "both", the
# default, serves everything; "prefill" dedicates the replica to
# /internal/kv_handoff exports; "decode" dedicates it to decode resumption
# (it never serves handoff exports and always honors an inbound
# prefill-url header).
REPLICA_ROLES = ("prefill", "decode", "both")


class DisaggStats:
    """Per-role KV-handoff accounting, rendered on /metrics. Zeros when
    disaggregation is off — a fresh scrape is nan-free by construction,
    the same contract as every other serving series."""

    def __init__(self, role: str):
        self.role = role
        # side="export" / "import"; outcome "ok" | "error" | "fallback"
        # (import degraded to local recompute).
        self.handoffs: dict[tuple, int] = {}
        self.kv_bytes = {"export": 0, "import": 0}
        self.latency = Histogram(
            "kgct_disagg_handoff_seconds",
            "KV handoff wall latency (prefill export / decode import)",
            labels=("side",))

    def on_handoff(self, side: str, outcome: str, n_bytes: int = 0,
                   duration_s: Optional[float] = None) -> None:
        key = (side, outcome)
        self.handoffs[key] = self.handoffs.get(key, 0) + 1
        self.kv_bytes[side] = self.kv_bytes.get(side, 0) + n_bytes
        if duration_s is not None:
            self.latency.observe(duration_s, (side,))

    def render(self) -> list[str]:
        lines = [
            "# TYPE kgct_engine_role gauge",
            f'kgct_engine_role{{role="{self.role}"}} 1',
            "# TYPE kgct_disagg_handoffs_total counter",
        ]
        keys = {("export", "ok"), ("import", "ok"), ("import", "fallback"),
                ("export", "error")} | set(self.handoffs)
        for side, outcome in sorted(keys):
            lines.append(
                f'kgct_disagg_handoffs_total{{side="{side}",'
                f'outcome="{outcome}"}} {self.handoffs.get((side, outcome), 0)}')
        lines.append("# TYPE kgct_disagg_kv_bytes_total counter")
        for side in ("export", "import"):
            lines.append(f'kgct_disagg_kv_bytes_total{{side="{side}"}} '
                         f"{self.kv_bytes.get(side, 0)}")
        lines.extend(self.latency.render())
        return lines


class MigrationStats:
    """Session-survivability accounting, rendered on /metrics next to the
    disaggregation series. Sides: "push" (a draining replica ships a
    running sequence), "recv" (a peer parks a pushed state), "resume" (the
    router's failover re-dispatch reconstructs a stream here: outcome "ok"
    = parked-KV import, "fallback" = token-replay recompute). Zeros when
    migration never ran — a fresh scrape is nan-free."""

    def __init__(self):
        self.migrations: dict[tuple, int] = {}
        self.bytes: dict[str, int] = {}
        self.latency = Histogram(
            "kgct_migration_seconds",
            "mid-stream migration wall latency (push / recv / resume)",
            labels=("side",))

    def on_migrate(self, side: str, outcome: str, n_bytes: int = 0,
                   duration_s: Optional[float] = None) -> None:
        key = (side, outcome)
        self.migrations[key] = self.migrations.get(key, 0) + 1
        if n_bytes:
            self.bytes[side] = self.bytes.get(side, 0) + n_bytes
        if duration_s is not None:
            self.latency.observe(duration_s, (side,))

    def render(self) -> list[str]:
        lines = ["# TYPE kgct_migrations_total counter"]
        keys = {("push", "ok"), ("push", "fallback"), ("recv", "ok"),
                ("resume", "ok"), ("resume", "fallback"),
                ("recv", "error")} | set(self.migrations)
        for side, outcome in sorted(keys):
            lines.append(
                f'kgct_migrations_total{{side="{side}",'
                f'outcome="{outcome}"}} {self.migrations.get((side, outcome), 0)}')
        lines.append("# TYPE kgct_migration_bytes_total counter")
        for side in sorted({"push", "recv"} | set(self.bytes)):
            lines.append(f'kgct_migration_bytes_total{{side="{side}"}} '
                         f'{self.bytes.get(side, 0)}')
        lines.extend(self.latency.render())
        return lines


def _sampling_params(body: dict, eos_token_id: Optional[int],
                     n_logprobs: int = 0) -> SamplingParams:
    seed = body.get("seed")
    return SamplingParams(
        max_tokens=int(body.get("max_tokens") or 256),
        temperature=float(body.get("temperature", 1.0)),
        top_p=float(body.get("top_p", 1.0)),
        top_k=int(body.get("top_k", 0)),
        stop_token_ids=tuple([eos_token_id] if eos_token_id is not None else [])
        + tuple(body.get("stop_token_ids") or ()),
        logprobs=n_logprobs >= 1,
        # OpenAI: logprobs=N returns top-N alternatives for every N >= 1
        # (plus the sampled token; True maps to N=1).
        top_logprobs=max(n_logprobs, 0),
        presence_penalty=float(body.get("presence_penalty", 0.0)),
        frequency_penalty=float(body.get("frequency_penalty", 0.0)),
        seed=int(seed) if seed is not None else None,
        logit_bias=body.get("logit_bias") or None,
    )


def _logprobs_requested(body: dict):
    """OpenAI completions ``logprobs``: null/0/false => off; N in 1..5 (or
    true => 1) => chosen-token logprobs plus the N most likely tokens per
    position (the sampled token is always included, so up to N+1 entries).
    Returns (n, error)."""
    lp = body.get("logprobs")
    if lp is None or lp is False:
        return 0, None
    if lp is True:
        return 1, None
    if isinstance(lp, float) and lp.is_integer():
        lp = int(lp)   # json floats: 1.0 and 1 are the same request
    if not isinstance(lp, int):
        return 0, _error(400, "logprobs must be a boolean or an integer")
    if not (0 <= lp <= 5):
        return 0, _error(400, "logprobs must be in [0, 5] (OpenAI cap)")
    return lp, None


def _stops(body: dict) -> list[str]:
    stop = body.get("stop")
    if stop is None:
        return []
    return [stop] if isinstance(stop, str) else list(stop)


class APIServer:
    def __init__(self, engine: AsyncLLMEngine, tokenizer: Tokenizer,
                 model_name: str,
                 resilience: Optional[ResilienceConfig] = None,
                 role: str = "both",
                 prefill_pool: Optional[list] = None,
                 peer_pool: Optional[list] = None,
                 fleet_prefix_cache: bool = False,
                 integrity_checks: bool = True):
        if role not in REPLICA_ROLES:
            raise ValueError(f"unknown replica role {role!r} "
                             f"(known: {', '.join(REPLICA_ROLES)})")
        self.engine = engine
        self.tokenizer = tokenizer
        self.model_name = model_name
        self.metrics = Metrics(engine.engine)
        self.role = role
        self.disagg = DisaggStats(role)
        self.migration = MigrationStats()
        # Engine-side import failures (no batch seat, no free pages, state
        # mismatch) surface AFTER the pull was counted outcome="ok": the
        # worker degrades to local recompute and reports it here, so the
        # fallback counter reflects replicas that recompute everything.
        # Mid-stream (migration) imports attribute to the migration series.
        engine.on_import_fallback = self._on_import_fallback
        # Session survivability: parked mid-stream states pushed by
        # draining peers, the live streams' migrate targets (rid -> (peer
        # url, prompt ids, params), from the router-owned
        # MIGRATE_URL_HEADER), and the bookkeeping that attributes an
        # engine-side import failure to the resume series.
        self.migrate_store = MigrationStore()
        self._migrate_urls: dict[str, tuple] = {}
        self._mid_stream_rids: set = set()
        self._resume_fallbacks: set = set()
        # Push allowlist (mirror of --prefill-pool): the migrate-url header
        # is router-owned, but a client reaching the pod directly could
        # otherwise point the drain push at an arbitrary URL. None = trust
        # the network boundary (dev/tests).
        self.peer_pool = (frozenset(u.rstrip("/") for u in peer_pool)
                          if peer_pool else None)
        # Ordered sibling list for the remote-spill push (the same set;
        # order gives the round-robin target rotation a stable spelling).
        self.peer_list = (tuple(u.rstrip("/") for u in peer_pool)
                          if peer_pool else ())
        # KV handoff does not compose with multi-rank lockstep: an import
        # or hold on rank 0 alone would leave the followers' schedulers
        # behind, so a leader serves colocated only.
        self._handoff_ok = engine.leader is None
        # Bounded pull: a single sequence's handoff can never legitimately
        # exceed the local pool's own byte size (plus header slack).
        kv = engine.engine.kv_cache
        self._handoff_max_bytes = int(kv.k.nbytes + kv.v.nbytes) + (1 << 20)
        # Spill frames carry ONE page of K and V: bound the
        # /internal/fleet_spill body to that plus header slack, checked on
        # Content-Length before the handler reads the body.
        self._spill_max_bytes = (
            2 * int(kv.k.nbytes // max(int(kv.k.shape[1]), 1)) + (1 << 20))
        # The resume envelope is JSON only (original body + the relayed
        # token ledger, never KV): a generous per-token byte budget over
        # the model's max length plus slack bounds it.
        self._resume_max_bytes = (
            32 * int(engine.engine.config.effective_max_len) + (1 << 20))
        # The transport admits a migration PUSH body (one sequence's KV
        # pages as octet-stream); the handlers re-check their own bounds.
        self.client_max_size = self._handoff_max_bytes + (1 << 20)
        # KV wire integrity (--no-integrity-checks to disable): every frame
        # this replica ENCODES carries per-page checksums and every frame it
        # DECODES is verified (pre-integrity peers rejected 426-style at
        # receive seams, skew-attributed at pull seams). Off = the
        # pre-integrity wire bytes, for mixed-fleet rollout.
        self.integrity_on = bool(integrity_checks)
        # Peer reputation over the wire plane: quarantined peers are skipped
        # by every pull/spill/migration target walk for a backoff window
        # (the first post-window attempt is the probe).
        self.peer_scores = PeerScoreboard()
        # KV-pull allowlist (--prefill-pool): any other PREFILL_URL_HEADER
        # degrades to local recompute (SSRF guard for direct-to-pod
        # traffic). None = trust the network boundary (dev/tests).
        self.prefill_pool = (frozenset(u.rstrip("/") for u in prefill_pool)
                             if prefill_pool else None)
        # Quarantine metric labels come ONLY from the configured allowlists
        # (bounded cardinality), seeded so idle peers render 0.
        engine.engine.obs.seed_peers(self.peer_list)
        if self.prefill_pool:
            engine.engine.obs.seed_peers(sorted(self.prefill_pool))
        self._http: Optional[ClientSession] = None
        # Fleet-wide prefix cache (--fleet-prefix-cache): serve peers'
        # prefix fetches, pull the ring owner's cached prefix on
        # PREFIX_SOURCE_HEADER, remote-spill evicted prefix pages to
        # siblings' host tiers. Requires the local prefix cache. Off =
        # byte-identical serving.
        pc = engine.engine.scheduler.prefix_cache
        self.fleet_on = bool(fleet_prefix_cache and self._handoff_ok
                             and pc is not None)
        if fleet_prefix_cache and not self.fleet_on:
            logger.warning(
                "fleet prefix cache disabled: %s",
                "prefix caching is off (--enable-prefix-caching)"
                if pc is None else "multi-rank leader (lockstep)")
        self._pull_policy = None
        self._spill_queue: Optional[SpillQueue] = None
        self._spill_task: Optional[asyncio.Task] = None
        if self.fleet_on:
            eng = engine.engine
            self._pull_policy = build_pull_policy(
                eng.model_config, eng.config.cache.page_size,
                eng.kv_cache.k.element_size(), eng.device.type)
            logger.info("fleet prefix cache on: pull policy %s",
                        self._pull_policy.describe())
            if self.peer_list:
                # Remote-spill rung: the eviction hook (worker thread) only
                # enqueues; the async drain task pushes to peers.
                self._spill_queue = SpillQueue()
                eng.enable_fleet_spill(self._offer_spill)
        self._profile_busy = False
        res = resilience or ResilienceConfig()
        self.res_config = res
        self.drain_state = DrainState()
        # Watchdog trips auto-dump the flight recorder: the ring holds the
        # seconds that preceded the hang.
        self.watchdog = StepWatchdog(timeout_s=res.watchdog_timeout_s,
                                     on_trip=self._on_watchdog_trip)
        self.admission = AdmissionController(
            engine.engine, default_budget_ms=res.default_ttft_budget_ms,
            quantile=res.admission_quantile)
        # Multi-tenant QoS: the tier table lives in the ENGINE config (one
        # source for scheduler fairness AND serving admission). Empty = QoS
        # off, byte-identical serving.
        sc = engine.engine.config.scheduler
        self.qos_tiers = sc.qos_tiers
        self.qos_default_tier = (
            engine.engine.scheduler.qos.default_tier
            if engine.engine.scheduler.qos is not None else None)
        if self.qos_tiers:
            self.admission.configure_tiers(self.qos_tiers,
                                           self.qos_default_tier)
        self.hub = ResilienceHub(self.admission, self.watchdog,
                                 self.drain_state)
        # The worker thread arms/disarms the watchdog around each step().
        engine.watchdog = self.watchdog
        # SLO layer grades against the SAME bar admission control sheds on.
        engine.engine.obs.slo.ttft_budget_ms = res.default_ttft_budget_ms

    def _on_watchdog_trip(self) -> None:
        self.engine.engine.obs.flight.dump(
            "watchdog_trip", trips=self.watchdog.trips,
            timeout_s=self.watchdog.timeout_s)

    def _wire_corruption(self, path: str, peer: Optional[str], rid: str,
                         err: Exception) -> None:
        """One integrity detection on a client/receive seam: counter,
        trace span, flight-recorder evidence — and, when the peer is
        known, a corruption-weight score decay. The transition INTO
        quarantine is itself counted and dumped (the operator's "which
        peer is lying about bytes" answer)."""
        obs = self.engine.engine.obs
        outcome = ("skew" if isinstance(err, ProtocolSkewError)
                   else "corrupt")
        obs.on_wire_corruption(path, outcome)
        obs.tracer.emit("handoff", rid, side="integrity", path=path,
                        outcome=outcome, peer=peer or "",
                        error=str(err)[:200])
        obs.flight.dump("wire_corruption", request_id=rid, path=path,
                        outcome=outcome, peer=peer or "",
                        error=str(err)[:200])
        if peer and self.peer_scores.record_corruption(peer):
            obs.on_peer_quarantine(peer)
            obs.flight.dump("peer_quarantine", peer=peer, path=path,
                            request_id=rid)
            logger.warning("peer %s quarantined after wire corruption "
                           "on %s", peer, path,
                           extra={"request_id": rid})

    def _peer_failure(self, peer: Optional[str]) -> None:
        """A timeout/transport failure against ``peer``: lighter decay
        than a corruption, same quarantine accounting on the crossing."""
        if peer and self.peer_scores.record_timeout(peer):
            obs = self.engine.engine.obs
            obs.on_peer_quarantine(peer)
            obs.flight.dump("peer_quarantine", peer=peer, path="timeout")
            logger.warning("peer %s quarantined after repeated failures",
                           peer)

    def _chaos_stale(self, state: dict) -> tuple[dict, bool]:
        """The ``peer_stale_frame`` chaos site (serve side): ``value`` 1
        serves the pre-integrity wire dialect (drilling the receiver's
        426-style skew rejection); any other value serves a frame whose
        model header lies (the stale-peer drill — the receiver's model
        check rejects it before any page can commit). Unarmed:
        passthrough."""
        val = _fault_value("peer_stale_frame")
        if val is None:
            return state, self.integrity_on
        if int(val) == 1:
            return state, False
        stale = dict(state)
        stale["model"] = str(state.get("model", "")) + "-stale"
        return stale, self.integrity_on

    @staticmethod
    def _chaos_corrupt(blob):
        """The ``kv_wire_corrupt`` chaos site (transit): flip one payload
        byte of an already-encoded frame, the bit-flip the integrity layer
        exists to catch. Unarmed: passthrough."""
        if _inject_fault("kv_wire_corrupt"):
            blob = bytearray(blob)
            blob[-1] ^= 0xFF
        return blob

    def _on_import_fallback(self, rid: str = None) -> None:
        """Engine-side import failure (worker thread). A mid-stream resume
        import degrades to TOKEN REPLAY — a different operator story than a
        disaggregated prefill re-run — so it lands in the migration series
        (and flags the rid so the resume handler reports mode=recompute);
        everything else keeps the pre-existing disagg attribution."""
        if rid is not None and rid in self._mid_stream_rids:
            self._resume_fallbacks.add(rid)
            self.migration.on_migrate("resume", "fallback")
        else:
            self.disagg.on_handoff("import", "fallback")

    # -- app wiring ----------------------------------------------------------

    def build_app(self) -> Application:
        app = Application(middleware=self._request_id_mw,
                          client_max_size=self.client_max_size)
        app.add_post("/v1/completions", self.completions)
        app.add_post("/v1/chat/completions", self.chat_completions)
        app.add_post("/internal/kv_handoff", self.kv_handoff)
        app.add_post("/internal/resume", self.resume)
        app.add_post("/internal/fetch_prefix", self.fetch_prefix)
        app.add_post("/internal/fleet_spill", self.fleet_spill)
        app.add_get("/v1/models", self.models)
        app.add_get("/health", self.health)
        app.add_get("/metrics", self.prometheus)
        app.add_get("/debug/trace", self.trace)
        app.add_get("/debug/flightrecorder", self.flightrecorder)
        app.add_post("/debug/profile", self.profile)
        app.on_startup.append(self._on_startup)
        app.on_cleanup.append(self._on_cleanup)
        return app

    async def _request_id_mw(self, request: Request, handler):
        """Fleet-tracing correlation: adopt the router-minted
        ``x-kgct-request-id`` (minting an OpenAI-style id for direct
        clients) and echo it on every /v1 response — success or error. The
        id becomes the ENGINE request id in ``_run``. Streaming responses
        set the header themselves before ``prepare()``."""
        rid = valid_request_id(request.headers.get(REQUEST_ID_HEADER))
        if rid is None and request.path.startswith("/v1/"):
            rid = self.engine.next_request_id(
                "chatcmpl" if "chat" in request.path else "cmpl")
        request["kgct_request_id"] = rid
        resp = await handler(request)
        # Re-read the stash: the duplicate-id guard in _run may have
        # suffixed the id after this middleware ran.
        final = request.get("kgct_request_id") or rid
        if final and not resp.prepared:
            resp.headers[REQUEST_ID_HEADER] = final
        return resp

    async def _on_startup(self, app: Application) -> None:
        if self.engine.engine.device.type == "cuda":
            # Build the kernels before listening: the first request's step
            # must not hold an nvcc build inside the watchdog window and
            # the admission estimate.
            from ..ops.cuda import build
            secs = await asyncio.to_thread(build.build)
            if secs:
                logger.info("CUDA kernels built in %.1f s", secs)
        self.engine.start(asyncio.get_running_loop())
        self.watchdog.start()
        if self._spill_queue is not None:
            self._spill_task = asyncio.get_running_loop().create_task(
                self._drain_spills())

    async def _on_cleanup(self, app: Application) -> None:
        if self._spill_task is not None:
            self._spill_task.cancel()
        if self._http is not None:
            await self._http.close()
        self.engine.shutdown()
        self.watchdog.stop()

    def _client(self) -> ClientSession:
        if self._http is None:
            self._http = ClientSession()
        return self._http

    # -- resilience gates ----------------------------------------------------

    def begin_drain(self, on_drained=None):
        """Start graceful drain (idempotent): stop admitting, flip /health,
        LIVE-MIGRATE every running stream that has a router-named peer
        (drain time becomes transfer-bound instead of waiting out the
        longest decode), finish whatever remains, then fire ``on_drained``.
        Returns the drain task, or None if a drain was already running.
        Must be called on the server's event loop (the SIGTERM handler and
        tests both are)."""
        if not self.drain_state.start_drain():
            return None
        # Black-box capture of the pre-drain seconds: what was queued or
        # mid-stream when the SIGTERM landed outlives the pod in the dump.
        self.engine.engine.obs.flight.dump(
            "sigterm_drain", grace_s=self.res_config.drain_grace_s,
            migrate_targets=len(self._migrate_urls))

        async def _drain():
            # The migrate phase spends part of the SAME budget the
            # wait-it-out fallback gets: drain_grace_s bounds the WHOLE
            # drain (the deploy renderer sizes
            # terminationGracePeriodSeconds from it + fixed margins), so
            # the fallback wait receives only what the pushes left over —
            # otherwise a wedged peer burning the push timeout would push
            # the total past the pod's SIGKILL deadline and hard-truncate
            # the very streams the fallback exists to protect.
            t0 = time.monotonic()
            await self._drain_migrate()
            remaining = max(
                self.res_config.drain_grace_s - (time.monotonic() - t0),
                1.0)
            await drain_and_notify(
                self.drain_state, self.engine,
                grace_s=remaining, on_drained=on_drained)

        return asyncio.get_running_loop().create_task(_drain())

    async def _drain_migrate(self) -> None:
        """Push every migratable running stream to its router-named peer.
        Per-sequence and never-raising: any failure on any rung degrades
        THAT sequence to the old wait-it-out drain path (or, past the
        point of no return, to router token-replay failover) while the
        rest keep migrating."""
        targets = list(self._migrate_urls.items())
        if not targets:
            return
        await asyncio.gather(
            *(self._migrate_one(rid, url, ids, params)
              for rid, (url, ids, params) in targets),
            return_exceptions=True)

    async def _migrate_one(self, rid: str, url: str, ids: list,
                           params) -> None:
        """One sequence's live migration: export_running (which retires it
        locally) -> encode -> push to the peer's /internal/kv_handoff ->
        sever the client relay so the router's failover re-dispatch finds
        the parked state. Failure ladder: export failed -> the sequence
        never detached, wait-it-out; push failed -> re-import the snapshot
        locally (the stream resumes here as if never exported); re-import
        failed too -> sever the relay anyway and let the router's
        token-replay recompute rung carry the session."""
        obs = self.engine.engine.obs
        peer = url.rstrip("/")
        if self.peer_scores.quarantined(peer):
            # Quarantined target: never export toward it — the sequence
            # stays attached and rides the wait-it-out drain rung.
            self.migration.on_migrate("push", "fallback", 0, 0.0)
            obs.tracer.emit("migrate", rid, side="push", outcome="fallback",
                            reason="quarantined", peer=peer)
            return
        t0 = time.perf_counter()
        try:
            if _inject_fault("migrate_fail"):
                raise RuntimeError(
                    "KGCT_FAULT migrate_fail: injected migration failure")
            state = await self.engine.run_in_worker(
                lambda e: e.export_running(rid))
        except KeyError:
            return      # already finished: nothing to migrate
        except Exception as e:
            # Nothing detached: the stream keeps decoding here — the
            # wait-it-out rung the pre-migration drain always took.
            dt = time.perf_counter() - t0
            self.migration.on_migrate("push", "fallback", 0, dt)
            obs.tracer.emit("migrate", rid, side="push", outcome="fallback",
                            error=str(e)[:200])
            logger.warning("live migration of %s skipped (%s); waiting "
                           "out the decode", rid, e,
                           extra={"request_id": rid})
            return
        blob = self._chaos_corrupt(
            encode_handoff(state, integrity=self.integrity_on))
        try:
            # One push may spend at most half the drain budget: the
            # wait-it-out fallback (and a local re-import) must still fit
            # inside drain_grace_s after a wedged peer times out.
            await push_handoff(
                self._client(), url, blob, rid,
                timeout_s=min(MIGRATE_PUSH_TIMEOUT_S,
                              max(self.res_config.drain_grace_s / 2, 1.0)))
        except Exception as e:
            logger.warning("migration push of %s to %s failed (%s); "
                           "re-importing locally", rid, url, e,
                           extra={"request_id": rid})
            self._peer_failure(peer)
            dt = time.perf_counter() - t0
            try:
                # The export already retired the sequence — restore it
                # from the snapshot (the same import a peer would run,
                # integrity-stash verified the same way) so the client
                # stream continues locally, wait-it-out style.
                verify_import_state(state)
                await self.engine.run_in_worker(
                    lambda eng: eng.import_request(rid, ids, params, state))
                self.migration.on_migrate("push", "fallback", len(blob), dt)
                obs.tracer.emit("migrate", rid, side="push",
                                outcome="fallback", error=str(e)[:200])
            except Exception as e2:
                # Point of no return: the KV is gone locally and the peer
                # never parked it. Sever the relay — the router's failover
                # recomputes from the relayed tokens (the recompute rung).
                self.migration.on_migrate("push", "error", len(blob), dt)
                obs.tracer.emit("migrate", rid, side="push",
                                outcome="error", error=str(e2)[:200])
                self._migrate_urls.pop(rid, None)
                self.engine.post_exception(rid, StreamMigratedError(url))
            return
        dt = time.perf_counter() - t0
        self.peer_scores.record_ok(peer)
        self.migration.on_migrate("push", "ok", len(blob), dt)
        obs.tracer.emit("migrate", rid, side="push", outcome="ok",
                        bytes=len(blob), ms=round(dt * 1e3, 2))
        self._migrate_urls.pop(rid, None)
        # The broken relay IS the router's failover signal: no terminal
        # SSE frame, just a severed stream (engine state is already gone —
        # post_exception touches only the output queue).
        self.engine.post_exception(rid, StreamMigratedError(url))

    def _resolve_tier(self, request: Request, body: Optional[dict]
                      ) -> tuple[Optional[str], Optional[Response]]:
        """(resolved tier name, error response): explicit
        ``x-kgct-qos-tier`` header (must name a configured tier, else a
        loud 400) > the ``session_id``/``user`` tenant key against the
        tiers' user pins > the default tier. (None, None) when QoS is off."""
        if not self.qos_tiers:
            return None, None
        name, err = resolve_tier_name(
            self.qos_tiers, self.qos_default_tier,
            header=request.headers.get(QOS_TIER_HEADER),
            tenant_key=tenant_key_of(body))
        if err is not None:
            return None, _error(400, err)
        return name, None

    def _admission_gate(self, request: Request,
                        tier: Optional[str] = None) -> Optional[Response]:
        """None = admit. A Response = reject BEFORE the request touches the
        engine: 503 while draining, 429 + Retry-After when the estimated
        queue wait already blows the request's TTFT budget OR the request's
        QoS tier is at its per-tier concurrency budget."""
        if self.drain_state.is_draining:
            return _overloaded(503, "server is draining for shutdown; "
                               "retry against another replica", 5)
        hdr = request.headers.get(TTFT_BUDGET_HEADER)
        budget_ms = None
        if hdr is not None:
            try:
                budget_ms = float(hdr)
            except ValueError:
                return _error(400, f"invalid {TTFT_BUDGET_HEADER}: {hdr!r} "
                                   "(expected milliseconds as a number)")
            # nan would pass "<= 0" and then fail every est<=budget check —
            # shedding unconditionally on an idle server; inf means "no
            # budget", which is spelled by omitting the header.
            if not math.isfinite(budget_ms) or budget_ms <= 0:
                return _error(400, f"{TTFT_BUDGET_HEADER} must be a finite "
                                   "number > 0")
        retry_after = self.admission.check(budget_ms, tier=tier)
        if retry_after is not None:
            est_ms = round(self.admission.last_estimate_s * 1e3, 1)
            rid = request.get("kgct_request_id")
            logger.info("request shed%s: estimated queue wait %.1f ms over "
                        "budget (retry-after %ss)",
                        f" (tier={tier})" if tier else "",
                        est_ms, retry_after,
                        extra={"request_id": rid} if rid else None)
            return _overloaded(
                429, f"request shed: estimated queue wait {est_ms} ms "
                     f"exceeds the TTFT budget; retry after the backlog "
                     f"drains", retry_after)
        return None

    # -- endpoints -----------------------------------------------------------

    async def health(self, request: Request) -> Response:
        sched = self.engine.engine.scheduler
        body = {"status": "ok", "model": self.model_name, "role": self.role,
                "waiting": len(sched.waiting), "running": len(sched.running),
                "swapped": len(sched.swapped)}
        if self.qos_tiers:
            body["qos_tiers"] = dict(self.admission.tier_inflight)
        if self.drain_state.is_draining:
            body["status"] = self.drain_state.state
            return json_response(body, status=503)
        if not self.watchdog.healthy:
            body["status"] = "engine step hung (watchdog tripped)"
            return json_response(body, status=503)
        return json_response(body)

    async def prometheus(self, request: Request) -> Response:
        text = (self.metrics.render()
                + "\n".join(self.hub.render_prometheus()) + "\n"
                + "\n".join(self.disagg.render()) + "\n"
                + "\n".join(self.migration.render()) + "\n")
        return Response(text=text, content_type="text/plain")

    async def trace(self, request: Request) -> Response:
        """Export the engine's request-lifecycle trace ring + step-phase
        slices as Chrome/Perfetto trace-event JSON. ``?clear=1`` empties
        the ring after export."""
        obs = self.engine.engine.obs
        data = obs.export_perfetto()
        if request.query.get("clear") in ("1", "true"):
            obs.clear_trace()
        return json_response(data)

    async def flightrecorder(self, request: Request) -> Response:
        """The engine's black-box ring: recent lifecycle/step events plus
        periodic state snapshots (queue depths, KV occupancy both tiers)."""
        return json_response(self.engine.engine.obs.flight.export())

    def _detok_push(self, detok: IncrementalDetokenizer, ids, final) -> str:
        """detok.push with its wall time attributed to the ``detokenize``
        phase — host-side text assembly the engine's step loop cannot see
        (it owns no tokenizer)."""
        t0 = time.perf_counter()
        try:
            return detok.push(ids, final=final)
        finally:
            self.engine.engine.obs.phases.record(
                "detokenize", time.perf_counter() - t0)

    async def profile(self, request: Request) -> Response:
        """Capture a torch.profiler trace of live serving traffic.

        ``POST /debug/profile?seconds=3`` blocks for the window and returns
        the trace directory (``kgct-profile`` under the temp directory; a
        Chrome trace-event JSON per capture, host and CUDA activities on a
        card). One capture at a time — concurrent requests get 409 rather
        than clobbering the active trace."""
        from torch.profiler import ProfilerActivity
        from torch.profiler import profile as torch_profile

        # Atomic try-acquire: the flag flips synchronously (no await between
        # test and set).
        if self._profile_busy:
            return _error(409, "a profile capture is already running")
        self._profile_busy = True
        try:
            seconds = float(request.query.get("seconds", 3))
            seconds = min(max(seconds, 0.1), 60.0)
            trace_dir = os.path.join(tempfile.gettempdir(), "kgct-profile")
            activities = [ProfilerActivity.CPU]
            if self.engine.engine.device.type == "cuda":
                activities.append(ProfilerActivity.CUDA)
            prof = torch_profile(activities=activities)
            # Started and stopped between two engine steps, on the worker
            # thread: a trace that starts or stops while a step program
            # captures can void the capture (engine/step_programs.py).
            await self.engine.run_in_worker(lambda eng: prof.start())
            try:
                await asyncio.sleep(seconds)
            finally:
                await self.engine.run_in_worker(lambda eng: prof.stop())
            path = os.path.join(
                trace_dir, f"trace-{os.getpid()}-{time.time_ns()}.json")
            try:
                os.makedirs(trace_dir, exist_ok=True)
                await asyncio.to_thread(prof.export_chrome_trace, path)
            except OSError as e:
                return _error(500, f"profiler trace export failed: {e}")
        finally:
            self._profile_busy = False
        return json_response({"trace_dir": trace_dir, "seconds": seconds})

    async def models(self, request: Request) -> Response:
        return json_response({
            "object": "list",
            "data": [{"id": self.model_name, "object": "model",
                      "owned_by": "kubernetes-gpu-cluster-tpu"}]})

    def _reserve_rid(self, request: Request, rid: str) -> str:
        """Duplicate-id guard, atomic with the caller's submission (no
        await between this and the ``generate`` call): a client reusing an
        in-flight correlation id gets a unique suffix instead of crossing
        output streams. The final id is stored back on the request so the
        middleware echoes what the engine actually ran."""
        base = rid
        while not self.engine.reserve_request_id(rid):
            rid = f"{base}+{self.engine.next_request_id('dup')}"
        request["kgct_request_id"] = rid
        return rid

    # -- disaggregated prefill/decode (KV handoff) ---------------------------

    async def kv_handoff(self, request: Request) -> Response:
        """Prefill-replica half of the handoff: run the prompt through the
        local engine up to its FIRST token (max_tokens clamped to 1 — the
        phase boundary), hold the committed KV, and return one binary blob
        (serving/handoff.py) carrying the pages plus the sequence state.
        The decode replica imports it as committed history and resumes
        decode directly; the first token samples here with the client's
        sampling params, so the disaggregated output is byte-identical to
        a colocated run. Served by ``prefill``/``both`` roles only.

        The PUSH direction (octet-stream content type) is the live-
        migration receive: a draining peer ships a running sequence's
        mid-stream state here and it is PARKED host-side (MigrationStore)
        until the router's /internal/resume re-dispatch claims it."""
        if request.content_type == "application/octet-stream":
            return await self._kv_handoff_recv(request)
        if self.role == "decode" or not self._handoff_ok:
            return _error(404, f"kv handoff is not served by this replica "
                               f"(role={self.role})")
        try:
            body = await request.json()
        except Exception:
            return _error(400, "invalid JSON body")
        # Resolve the tier BEFORE the gate (the decode replica forwards
        # its resolution in QOS_TIER_HEADER; the body carries the tenant
        # key): the pull must be gated against — and any shed attributed
        # to — the REQUESTING tier's budgets, never the default tier's.
        tier, terr = self._resolve_tier(request, body)
        if terr is not None:
            return terr
        gate = self._admission_gate(request, tier=tier)
        if gate is not None:
            return gate
        ids = body.get("prompt_token_ids")
        if (not isinstance(ids, list) or not ids
                or not all(isinstance(t, int) and not isinstance(t, bool)
                           for t in ids)):
            return _error(400, "prompt_token_ids must be a non-empty "
                               "list of token ids")
        n_lp, lp_err = _logprobs_requested(body)
        if lp_err is not None:
            return lp_err
        try:
            params = _sampling_params(body, self.tokenizer.eos_token_id,
                                      n_logprobs=n_lp)
        except (TypeError, ValueError) as e:
            return _error(400, str(e))
        if tier is not None:
            # Resolved above (forwarded header > tenant key > default):
            # the remote prefill competes in THIS replica's fair-share
            # scheduler under the requesting class.
            params = dataclasses.replace(params, qos_tier=tier)
        params = dataclasses.replace(params, max_tokens=1)
        rid = request.get("kgct_request_id") or self.engine.next_request_id(
            "handoff")
        rid = self._reserve_rid(request, rid)
        t0 = time.perf_counter()
        complete = exported = False
        gen = self.engine.generate(rid, ids, params, hold_kv=True)
        try:
            async for chunk in gen:
                if chunk.finished:
                    complete = True
                    break
            state = await self.engine.run_in_worker(
                lambda e: e.export_held(rid))
            exported = True
            exp_state, integ = self._chaos_stale(state)
            payload = encode_handoff(exp_state, integrity=integ)
            # The frame holds the only copy now: the export's pinned host
            # buffers are released here, not with the response.
            del state, exp_state
        except ValueError as e:
            self.disagg.on_handoff("export", "error")
            return _error(400, str(e))
        except KeyError:
            # Finished without exportable KV (capacity-terminated before
            # any page committed): the decode side recomputes locally.
            self.disagg.on_handoff("export", "error")
            return _overloaded(503, "prefill finished without exportable "
                                    "KV; recompute locally", 1)
        except BaseException:
            # Unexpected failure or client-disconnect cancellation: either
            # way no blob left this replica — an operator watching a
            # failing prefill pool must see outcome="error" move, not a
            # flat ok-counter (the decode side only ever reports its own
            # fallbacks).
            self.disagg.on_handoff("export", "error")
            raise
        finally:
            if not self.engine.release_reservation(rid) and not complete:
                self.engine.abort(rid)
            if complete and not exported:
                # Held pages whose export never happened must not leak.
                self.engine.post_to_worker(lambda e: e.discard_held(rid))
        dt = time.perf_counter() - t0
        self.disagg.on_handoff("export", "ok", len(payload), dt)
        self.engine.engine.obs.tracer.emit(
            "handoff", rid, side="export", bytes=len(payload),
            ms=round(dt * 1e3, 2))
        return Response(body=payload,
                            content_type="application/octet-stream",
                            headers={REQUEST_ID_HEADER: rid})

    # -- session survivability (live migration + mid-stream failover) --------

    async def _kv_handoff_recv(self, request: Request) -> Response:
        """Receive a draining peer's mid-stream push and PARK it (host
        memory only — no device pages are spent on a stream whose client
        may never fail over here). The router's /internal/resume claims it
        by request id; TTL/cap bounds in MigrationStore keep a crashing
        fleet from ballooning this replica."""
        if self.role == "prefill" or not self._handoff_ok:
            self.migration.on_migrate("recv", "error")
            return _error(404, "migration push is not served by this "
                               f"replica (role={self.role})")
        if self.drain_state.is_draining:
            # A draining replica is the wrong parking lot — the pusher
            # falls back and the router walks on.
            self.migration.on_migrate("recv", "error")
            return _overloaded(503, "server is draining; push elsewhere", 1)
        rid = valid_request_id(request.headers.get(REQUEST_ID_HEADER))
        if rid is None:
            self.migration.on_migrate("recv", "error")
            return _error(400, "migration push requires a valid "
                               f"{REQUEST_ID_HEADER}")
        t0 = time.perf_counter()
        # Reject an oversized push on its declared length (the transport
        # already answered 413 past client_max_size, before reading it);
        # the post-read check backstops chunked pushes that declare
        # nothing.
        if (request.content_length is not None
                and request.content_length > self._handoff_max_bytes):
            self.migration.on_migrate("recv", "error")
            return _error(413, "migration blob exceeds the local KV bound")
        data = await request.read()
        if len(data) > self._handoff_max_bytes:
            self.migration.on_migrate("recv", "error")
            return _error(413, "migration blob exceeds the local KV bound")
        try:
            state = decode_handoff(data,
                                   require_integrity=self.integrity_on)
        except ProtocolSkewError as e:
            # Version-skew negotiation is LOUD: a pre-integrity pusher
            # gets a clean upgrade-required rejection, not a decode
            # attempt (it falls back to keeping the stream local).
            self.migration.on_migrate("recv", "error")
            self._wire_corruption("migrate", None, rid, e)
            return _error(426, f"{e}; upgrade the peer or disable "
                               "integrity checks fleet-wide")
        except WireCorruptionError as e:
            self.migration.on_migrate("recv", "error")
            self._wire_corruption("migrate", None, rid, e)
            return _error(400, f"bad migration blob: {e}")
        except ValueError as e:
            self.migration.on_migrate("recv", "error")
            return _error(400, f"bad migration blob: {e}")
        if not state.get("mid_stream"):
            self.migration.on_migrate("recv", "error")
            return _error(400, "not a mid-stream migration state")
        if state.get("model") != self.engine.engine.model_config.name:
            self.migration.on_migrate("recv", "error")
            return _error(409, f"migration model {state.get('model')!r} != "
                               f"{self.engine.engine.model_config.name!r}")
        self.migrate_store.put(rid, state)
        dt = time.perf_counter() - t0
        self.migration.on_migrate("recv", "ok", len(data), dt)
        self.engine.engine.obs.tracer.emit(
            "migrate", rid, side="recv", bytes=len(data),
            tokens=len(state.get("output_token_ids") or []),
            ms=round(dt * 1e3, 2))
        return json_response({"parked": True, "request_id": rid})

    def _prompt_ids_of(self, body: dict, kind: str):
        """(prompt token ids, error response): THE one tokenization of a
        completion body."""
        if kind == "chat.completion":
            messages = body.get("messages")
            if not messages:
                return None, _error(400, "missing 'messages'")
            return self.tokenizer.encode(
                apply_chat_template(self.tokenizer, messages)), None
        prompt = body.get("prompt")
        if prompt is None:
            return None, _error(400, "missing 'prompt'")
        if isinstance(prompt, list):
            if prompt and isinstance(prompt[0], int):
                return [int(t) for t in prompt], None
            if len(prompt) == 1 and isinstance(prompt[0], str):
                return self.tokenizer.encode(prompt[0]), None
            return None, _error(400, "batched prompts are not supported; "
                                     "send one request per prompt")
        return self.tokenizer.encode(prompt), None

    async def resume(self, request: Request) -> StreamResponse:
        """Mid-stream failover re-dispatch: reconstruct a dead replica's
        live stream and continue it as SSE, emitting ONLY the tokens the
        client has not seen. Body: {"body": <original request body>,
        "relayed_token_ids": [...], "kind": "completion"|"chat.completion"}.

        Resume ladder: a parked migration state for this request id
        imports directly (mode "import": KV scatter, no recompute); no
        parked state — or a failed import — replays the relayed tokens as
        forced context through the recompute-prefill path (mode
        "recompute", byte-identical for greedy/seeded sampling). The mode
        is echoed in RESUME_MODE_HEADER for the router's failover
        attribution."""
        if self.role == "prefill" or not self._handoff_ok:
            return _error(404, "resume is not served by this replica "
                               f"(role={self.role})")
        if self.drain_state.is_draining:
            return _overloaded(503, "server is draining; resume elsewhere",
                               1)
        # The resume envelope carries JSON only (body + token ledger):
        # reject an oversized one on its declared length BEFORE buffering.
        if (request.content_length is not None
                and request.content_length > self._resume_max_bytes):
            return _error(413, "resume envelope exceeds the local bound")
        try:
            envelope = await request.json()
        except Exception:
            return _error(400, "invalid JSON body")
        body = envelope.get("body")
        relayed = envelope.get("relayed_token_ids")
        kind = envelope.get("kind") or "completion"
        if not isinstance(body, dict):
            return _error(400, "resume requires the original request body")
        if (not isinstance(relayed, list)
                or not all(isinstance(t, int) and not isinstance(t, bool)
                           for t in relayed)):
            return _error(400, "relayed_token_ids must be a list of ints")
        if kind not in ("completion", "chat.completion"):
            return _error(400, f"unknown resume kind {kind!r}")
        rid = valid_request_id(request.headers.get(REQUEST_ID_HEADER))
        if rid is None:
            return _error(400, "resume requires a valid "
                               f"{REQUEST_ID_HEADER}")
        request["kgct_request_id"] = rid
        ids, err = self._prompt_ids_of(body, kind)
        if err is not None:
            return err
        n_lp, lp_err = _logprobs_requested(body)
        if lp_err is not None:
            return lp_err
        want_lps = n_lp >= 1 and kind == "completion"
        try:
            params = _sampling_params(body, self.tokenizer.eos_token_id,
                                      n_logprobs=n_lp)
        except (TypeError, ValueError) as e:
            return _error(400, str(e))
        # A resumed stream keeps its QoS class: re-resolve from the
        # replayed body's tenant key (the failover dispatch carries no
        # client headers), so a migrated interactive stream is not
        # silently re-classed to the default tier here.
        tier, terr = self._resolve_tier(request, body)
        if terr is not None:
            return terr
        if tier is not None:
            params = dataclasses.replace(params, qos_tier=tier)
        obs = self.engine.engine.obs
        parked = self.migrate_store.pop(rid)
        if parked is not None:
            # The parked outputs must EXTEND what the client already saw,
            # or the import would desynchronize the stream — a stale or
            # foreign snapshot drops to token replay instead.
            po = list(parked.get("output_token_ids") or [])
            if po[:len(relayed)] != list(relayed):
                obs.tracer.emit("migrate", rid, side="resume",
                                outcome="stale_park",
                                parked=len(po), relayed=len(relayed))
                parked = None
        if parked is not None:
            # Import-seam verify: the parked pages sat in host memory
            # since the push's decode — re-checksum against the frame's
            # own integrity stash right before they can enter the pool
            # (no-op for pre-integrity frames). A mismatch drops to token
            # replay, the same recompute rung as a stale park.
            try:
                verify_import_state(parked)
            except WireCorruptionError as e:
                self._wire_corruption("resume", None, rid, e)
                parked = None
        detok = IncrementalDetokenizer(self.tokenizer, stop=_stops(body))
        migrate_url = request.headers.get(MIGRATE_URL_HEADER)
        rid = self._reserve_rid(request, rid)
        t0 = time.perf_counter()
        self._mid_stream_rids.add(rid)
        gen = self.engine.generate(rid, ids, params, handoff=parked,
                                   resume_outputs=list(relayed))
        complete = False
        resp = None
        n_out = len(relayed)
        try:
            try:
                first = await gen.__anext__()
            except StopAsyncIteration:
                complete = True
                return _error(500, "resume produced no output")
            mode = "import" if (parked is not None
                                and rid not in self._resume_fallbacks) \
                else "recompute"
            dt = time.perf_counter() - t0
            if mode == "import":
                self.migration.on_migrate("resume", "ok", 0, dt)
            elif parked is None:
                # No parked state was ever available: pure token replay
                # (the fallback-after-import case already counted through
                # the on_import_fallback hook).
                self.migration.on_migrate("resume", "fallback", 0, dt)
            obs.tracer.emit("migrate", rid, side="resume", outcome=mode,
                            relayed=len(relayed), ms=round(dt * 1e3, 2))
            resp = StreamResponse(headers={
                "Content-Type": "text/event-stream",
                "Cache-Control": "no-cache",
                REQUEST_ID_HEADER: rid,
                RESUME_MODE_HEADER: mode})
            await resp.prepare(request)
            # A resumed stream is itself migratable (nested drains).
            if (migrate_url
                    and migrate_url.startswith(("http://", "https://"))
                    and (self.peer_pool is None
                         or migrate_url.rstrip("/") in self.peer_pool)):
                self._migrate_urls[rid] = (migrate_url, list(ids), params)
            # Seed the detokenizer with the relayed prefix: its emission is
            # byte-identical to what the dead replica already delivered
            # (same deterministic incremental function over the same
            # tokens), so only genuinely-new text leaves here.
            if relayed:
                self._detok_push(detok, list(relayed), False)
            emitted = len(relayed)
            created = int(time.time())

            async def frames():
                yield first
                async for c in gen:
                    yield c

            async for chunk in frames():
                full = list(chunk.output_token_ids)
                new_ids = full[emitted:] if len(full) > emitted else []
                emitted = max(emitted, len(full))
                n_out = len(full)
                delta = self._detok_push(detok, new_ids, chunk.finished)
                finished = chunk.finished or detok.stopped
                if detok.stopped and not chunk.finished:
                    self.engine.abort(rid)
                if delta or finished or new_ids:
                    reason = ("stop" if detok.stopped
                              else _map_reason(chunk.finish_reason))
                    sb = _stream_body(kind, rid, created, self.model_name,
                                      delta, reason if finished else None)
                    # The router's failover relay consumes these (and
                    # strips them before the client): the token ledger a
                    # SECOND failover would replay.
                    if new_ids:
                        sb["kgct_token_ids"] = new_ids
                    if want_lps and new_ids and not detok.stopped:
                        lps = list(chunk.new_logprobs or [])
                        sb["choices"][0]["logprobs"] = {
                            "tokens": [self.tokenizer.decode([t])
                                       for t in new_ids],
                            "token_logprobs": lps[-len(new_ids):],
                        }
                    await resp.write(_sse(sb))
                if finished:
                    complete = True
                    break
        except ValueError as e:
            complete = True
            if resp is None:
                self.migration.on_migrate("resume", "error")
                return _error(400, str(e))
            await resp.write(_sse({"error": {"message": str(e),
                                             "code": 400}}))
        except StreamMigratedError as e:
            # Migrated AGAIN mid-resume (nested drain): sever this relay
            # too — the router walks to the next rung.
            obs.tracer.emit("migrate", rid, side="resume",
                            outcome="re_migrated", peer=e.peer_url)
            raise
        finally:
            self._mid_stream_rids.discard(rid)
            self._resume_fallbacks.discard(rid)
            self._migrate_urls.pop(rid, None)
            if not self.engine.release_reservation(rid) and not complete:
                self.engine.abort(rid)
        self.metrics.on_request()
        self.metrics.on_finish(max(n_out - len(relayed), 0))
        await resp.write(b"data: [DONE]\n\n")
        await resp.write_eof()
        return resp

    async def _pull_handoff(self, prefill_url: str, rid: str, body: dict,
                            ids: list[int],
                            tier: Optional[str] = None) -> Optional[dict]:
        """Decode-replica half: pull the prefilled KV from ``prefill_url``
        (bounded read + wall bound, serving/handoff.py) and decode the
        blob. Returns None on ANY failure — including the deterministic
        chaos site ``kv_handoff_fail`` — and the caller degrades to local
        recompute, which is byte-identical, just slower. The fallback
        trigger lands in the trace ring AND the black-box flight recorder
        (the tracer mirrors every emit), so a degraded fleet leaves
        evidence."""
        obs = self.engine.engine.obs
        peer = prefill_url.rstrip("/")
        if self.peer_scores.quarantined(peer):
            # Quarantined peer: skip before the socket — local prefill
            # serves it, byte-identical, while the backoff window runs.
            self.disagg.on_handoff("import", "fallback", 0, 0.0)
            obs.tracer.emit("handoff", rid, side="import",
                            outcome="fallback", reason="quarantined",
                            peer=peer)
            return None
        t0 = time.perf_counter()
        try:
            if _inject_fault("kv_handoff_fail"):
                raise RuntimeError("KGCT_FAULT kv_handoff_fail: injected "
                                   "handoff failure")
            data = await fetch_handoff(
                self._client(), prefill_url, handoff_request_body(ids, body),
                rid, self._handoff_max_bytes, timeout_s=HANDOFF_TIMEOUT_S,
                qos_tier=tier)
            data = self._chaos_corrupt(data)
            state = decode_handoff(data,
                                   require_integrity=self.integrity_on)
            # Import-seam verify right before the state can reach the
            # engine's import (pops the integrity stash either way).
            verify_import_state(state)
        except (WireCorruptionError, ProtocolSkewError) as e:
            dt = time.perf_counter() - t0
            logger.warning("kv handoff pull from %s failed integrity "
                           "(%s); falling back to local prefill",
                           prefill_url, e, extra={"request_id": rid})
            self._wire_corruption("handoff", peer, rid, e)
            self.disagg.on_handoff("import", "fallback", 0, dt)
            obs.tracer.emit("handoff", rid, side="import",
                            outcome="fallback", error=str(e)[:200],
                            ms=round(dt * 1e3, 2))
            return None
        except Exception as e:
            dt = time.perf_counter() - t0
            logger.warning("kv handoff pull from %s failed (%s); falling "
                           "back to local prefill", prefill_url, e,
                           extra={"request_id": rid})
            self._peer_failure(peer)
            self.disagg.on_handoff("import", "fallback", 0, dt)
            obs.tracer.emit("handoff", rid, side="import",
                            outcome="fallback", error=str(e)[:200],
                            ms=round(dt * 1e3, 2))
            return None
        dt = time.perf_counter() - t0
        self.peer_scores.record_ok(peer)
        self.disagg.on_handoff("import", "ok", len(data), dt)
        obs.tracer.emit("handoff", rid, side="import", outcome="ok",
                        bytes=len(data), ms=round(dt * 1e3, 2))
        return state

    # -- fleet-wide prefix cache (global KV reuse) ---------------------------

    def _offer_spill(self, digest_hex: str, k_np, v_np) -> bool:
        """Eviction-hook sink (WORKER thread): enqueue one remote-spill
        candidate; never blocks, never raises. A displaced (oldest)
        entry is a counted drop."""
        if not self._spill_queue.offer(digest_hex, k_np, v_np):
            self.engine.engine.obs.on_fleet_spill("dropped")
        return True

    async def _drain_spills(self) -> None:
        """Async remote-spill pusher: rotate evicted pages across the
        sibling pool (--peer-pool) until one parks each page in its host
        tier. A peer with no room answers 507 and the rotation walks on;
        no peer taking it is a counted drop — the page was re-computable,
        this rung is pure opportunism."""
        eng = self.engine.engine
        idx = 0
        while True:
            item = self._spill_queue.pop()
            if item is None:
                await asyncio.sleep(0.2)
                continue
            digest_hex, k_np, v_np = item
            frame = encode_spill_frame(
                digest_hex, k_np, v_np, eng.model_config.name,
                eng.config.cache.page_size, integrity=self.integrity_on)
            frame = self._chaos_corrupt(frame)
            outcome = "dropped"
            for _ in range(len(self.peer_list)):
                url = self.peer_list[idx % len(self.peer_list)]
                idx += 1
                if self.peer_scores.quarantined(url):
                    continue
                try:
                    async with self._client().post(
                            f"{url}/internal/fleet_spill", data=frame,
                            headers={"Content-Type":
                                     "application/octet-stream"},
                            timeout_s=5) as resp:
                        if resp.status == 200:
                            outcome = "ok"
                            await resp.read()
                            self.peer_scores.record_ok(url)
                            break
                        await resp.read()
                except asyncio.CancelledError:
                    raise
                except Exception:
                    outcome = "error"
                    self._peer_failure(url)
            eng.obs.on_fleet_spill(outcome,
                                   len(frame) if outcome == "ok" else 0)
            eng.obs.tracer.emit("fleet_prefix", "", side="spill",
                                outcome=outcome, digest=digest_hex[:16])

    async def fetch_prefix(self, request: Request) -> StreamResponse:
        """Fleet-cache EXPORT half: serve the longest locally cached
        prefix of the posted prompt (live entries + host-tier second
        chances) as a streamed prefix frame (serving/handoff.py codec).
        404 when nothing matches or the fleet cache is off — the peer
        recomputes locally, byte-identical."""
        if not self.fleet_on:
            return _error(404, "fleet prefix cache is not enabled on this "
                               "replica")
        if self.drain_state.is_draining:
            return _overloaded(503, "server is draining; fetch elsewhere", 1)
        try:
            body = await request.json()
        except Exception:
            return _error(400, "invalid JSON body")
        ids = body.get("prompt_token_ids")
        if (not isinstance(ids, list) or len(ids) < 2
                or not all(isinstance(t, int) and not isinstance(t, bool)
                           for t in ids)):
            return _error(400, "prompt_token_ids must be a list of >= 2 "
                               "token ids")
        try:
            # What the puller already holds: only the DELTA beyond it is
            # exported (the span its roofline gate actually priced).
            have = max(int(body.get("have_tokens", 0)), 0)
        except (TypeError, ValueError):
            return _error(400, "have_tokens must be an integer")
        rid = request.get("kgct_request_id") or self.engine.next_request_id(
            "pfx")
        obs = self.engine.engine.obs
        t0 = time.perf_counter()
        try:
            state = await self.engine.run_in_worker(
                lambda e: e.export_prefix(ids, skip_tokens=have))
        except KeyError as e:
            return _error(404, str(e))
        resp = StreamResponse(headers={
            "Content-Type": "application/octet-stream",
            REQUEST_ID_HEADER: rid})
        await resp.prepare(request)
        n_bytes = 0
        exp_state, integ = self._chaos_stale(state)
        for part in encode_prefix_frames(exp_state, integrity=integ):
            await resp.write(bytes(part))
            n_bytes += len(part)
        await resp.write_eof()
        obs.tracer.emit(
            "fleet_prefix", rid, side="export",
            tokens=state["matched_tokens"], bytes=n_bytes,
            ms=round((time.perf_counter() - t0) * 1e3, 2))
        return resp

    async def fleet_spill(self, request: Request) -> Response:
        """Fleet-cache remote-spill RECEIVE half: park one peer-evicted
        prefix page in the local HOST tier, keyed by its chained digest
        (host memory only — device pages are spent only if a local lookup
        later second-chances it). 507 when the host tier is off/full so
        the pusher's rotation walks on."""
        if not self.fleet_on:
            return _error(404, "fleet prefix cache is not enabled on this "
                               "replica")
        # Bound the body BEFORE buffering: a peer page is at most one
        # K|V page pair plus framing — anything larger is not a spill.
        if (request.content_length is not None
                and request.content_length > self._spill_max_bytes):
            return _error(413, f"spill frame {request.content_length} bytes "
                               f"exceeds the local bound "
                               f"{self._spill_max_bytes}")
        data = await request.read()
        if len(data) > self._spill_max_bytes:
            return _error(413, f"spill frame {len(data)} bytes exceeds the "
                               f"local bound {self._spill_max_bytes}")
        rid = request.get("kgct_request_id") or ""
        try:
            digest_hex, header, k_np, v_np = decode_spill_frame(
                data, require_integrity=self.integrity_on)
        except ProtocolSkewError as e:
            self._wire_corruption("spill", None, rid, e)
            return _error(426, f"{e}; upgrade the peer or disable "
                               "integrity checks fleet-wide")
        except WireCorruptionError as e:
            self._wire_corruption("spill", None, rid, e)
            return _error(400, f"bad spill frame: {e}")
        except ValueError as e:
            return _error(400, f"bad spill frame: {e}")
        if header.get("model") != self.engine.engine.model_config.name:
            return _error(409, f"spill model {header.get('model')!r} != "
                               f"{self.engine.engine.model_config.name!r}")
        ok = await self.engine.run_in_worker(
            lambda e: e.accept_remote_spill(digest_hex, k_np, v_np))
        if not ok:
            return _error(507, "no host-tier room for the spilled page")
        self.engine.engine.obs.tracer.emit(
            "fleet_prefix", "", side="recv", digest=digest_hex[:16],
            bytes=len(data))
        return json_response({"parked": True})

    async def _pull_prefix(self, source_url: str, rid: str,
                           ids: list[int]) -> None:
        """Fleet-cache IMPORT half: on the router's PREFIX_SOURCE_HEADER
        hint, pull the ring owner's cached prefix and STREAM it into the
        local prefix cache (begin/chunk/commit worker ops — each chunk
        scatter interleaves with other requests' decode steps instead of
        blocking on the full blob). Gated by the anti-thrash roofline
        policy: what is already local, sub-page, or priced above a local
        recompute is skipped. ANY failure — including the deterministic
        chaos site ``kv_pull_fail`` — degrades to local recompute
        (outcome="recompute"), byte-identical, with the trigger in the
        trace ring and the flight recorder."""
        obs = self.engine.engine.obs
        t0 = time.perf_counter()
        handle = None
        try:
            if _inject_fault("kv_pull_fail"):
                raise RuntimeError(
                    "KGCT_FAULT kv_pull_fail: injected prefix pull failure")
            local = await self.engine.run_in_worker(
                lambda e: e.prefix_peek(ids))
            remaining = (len(ids) - 1) - local
            if remaining < self._pull_policy.min_tokens:
                obs.on_fleet_pull("skipped")
                obs.tracer.emit("fleet_prefix", rid, side="import",
                                outcome="skipped", reason="local_warm",
                                local_tokens=local)
                return
            if not self._pull_policy.pull_beats_recompute(remaining):
                # The roofline prices the transfer above a local
                # re-prefill: never fetch what is cheaper to recompute.
                obs.on_fleet_pull("skipped")
                obs.tracer.emit("fleet_prefix", rid, side="import",
                                outcome="skipped", reason="roofline",
                                tokens=remaining)
                return
            src = source_url.rstrip("/")
            if self.peer_scores.quarantined(src):
                # Owner sits in a quarantine window: never contact it —
                # local recompute serves the prefix byte-identically.
                obs.on_fleet_pull("recompute")
                obs.tracer.emit("fleet_prefix", rid, side="import",
                                outcome="recompute", reason="quarantined",
                                peer=src)
                return
            dec = PrefixStreamDecoder(require_integrity=self.integrity_on)
            n_bytes = 0
            async with self._client().post(
                    f"{src}/internal/fetch_prefix",
                    json={"prompt_token_ids": list(ids),
                          "have_tokens": local},
                    headers={REQUEST_ID_HEADER: rid},
                    timeout_s=PREFIX_PULL_TIMEOUT_S) as resp:
                if resp.status != 200:
                    snippet = (await resp.read(2048)).decode(
                        "utf-8", errors="replace")
                    raise RuntimeError(
                        f"prefix fetch {resp.status}: {snippet[:200]}")
                async for chunk in resp.iter_chunked(1 << 16):
                    n_bytes += len(chunk)
                    if n_bytes > self._handoff_max_bytes:
                        raise RuntimeError(
                            f"prefix stream exceeds the local bound "
                            f"{self._handoff_max_bytes}")
                    parts = dec.feed(self._chaos_corrupt(chunk))
                    if handle is None and dec.header is not None:
                        hdr = dict(dec.header)
                        handle = await self.engine.run_in_worker(
                            lambda e: e.begin_prefix_import(hdr))
                    for ck, cv in parts:
                        await self.engine.run_in_worker(
                            lambda e, h=handle, k=ck, v=cv:
                            e.import_prefix_chunk(h, k, v))
            if handle is None or not dec.done:
                raise RuntimeError("prefix stream truncated")
            tokens = await self.engine.run_in_worker(
                lambda e, h=handle: e.commit_prefix_import(h))
            handle = None
            dt = time.perf_counter() - t0
            self.peer_scores.record_ok(src)
            obs.on_fleet_pull("ok", n_bytes, dt)
            obs.tracer.emit("fleet_prefix", rid, side="import",
                            outcome="ok", tokens=tokens, bytes=n_bytes,
                            ms=round(dt * 1e3, 2))
        except (WireCorruptionError, ProtocolSkewError) as e:
            # Checksum/protocol detection: abort the import (pages freed,
            # KGCT010 order), attribute the peer, recompute locally.
            dt = time.perf_counter() - t0
            if handle is not None:
                self.engine.post_to_worker(
                    lambda e2, h=handle: e2.abort_prefix_import(h))
            logger.warning("fleet prefix pull from %s failed integrity "
                           "(%s); local recompute serves it", source_url,
                           e, extra={"request_id": rid})
            self._wire_corruption("prefix", source_url.rstrip("/"), rid, e)
            obs.on_fleet_pull("recompute", 0, dt)
            obs.tracer.emit("fleet_prefix", rid, side="import",
                            outcome="recompute", error=str(e)[:200],
                            ms=round(dt * 1e3, 2))
        except Exception as e:
            dt = time.perf_counter() - t0
            if handle is not None:
                self.engine.post_to_worker(
                    lambda e2, h=handle: e2.abort_prefix_import(h))
            logger.warning("fleet prefix pull from %s failed (%s); local "
                           "recompute serves it", source_url, e,
                           extra={"request_id": rid})
            self._peer_failure(source_url.rstrip("/"))
            obs.on_fleet_pull("recompute", 0, dt)
            obs.tracer.emit("fleet_prefix", rid, side="import",
                            outcome="recompute", error=str(e)[:200],
                            ms=round(dt * 1e3, 2))

    async def completions(self, request: Request):
        try:
            body = await request.json()
        except Exception:
            return _error(400, "invalid JSON body")
        ids, err = self._prompt_ids_of(body, "completion")
        if err is not None:
            return err
        return await self._run(request, body, ids, kind="completion")

    async def chat_completions(self, request: Request):
        try:
            body = await request.json()
        except Exception:
            return _error(400, "invalid JSON body")
        ids, err = self._prompt_ids_of(body, "chat.completion")
        if err is not None:
            return err
        return await self._run(request, body, ids, kind="chat.completion")

    # -- request execution ---------------------------------------------------

    async def _run(self, request: Request, body: dict, ids: list[int],
                   kind: str):
        # QoS tier resolution precedes the gate (the gate charges the shed
        # to the tier); the inflight pair brackets the WHOLE request
        # lifetime, streaming included.
        tier, terr = self._resolve_tier(request, body)
        if terr is not None:
            return terr
        gate = self._admission_gate(request, tier=tier)
        if gate is not None:
            return gate
        if tier is None:
            return await self._run_admitted(request, body, ids, kind, tier)
        self.admission.on_admit(tier)
        try:
            return await self._run_admitted(request, body, ids, kind, tier)
        finally:
            self.admission.on_release(tier)

    async def _run_admitted(self, request: Request, body: dict,
                            ids: list[int], kind: str, tier: Optional[str]):
        # Session/user passthrough (the router's affinity keys): a
        # non-scalar value would silently change the ROUTER's hashing
        # semantics per request, so it is a loud 400 here.
        for field in ("session_id", "user"):
            val = body.get(field)
            if val is not None and (isinstance(val, bool)
                                    or not isinstance(val, (str, int))):
                return _error(400, f"{field} must be a string or integer "
                                   "(routing affinity key)")
        n_lp, lp_err = _logprobs_requested(body)
        if lp_err is not None:
            return lp_err
        want_lps = n_lp >= 1
        if want_lps and kind != "completion":
            return _error(400, "logprobs are supported on /v1/completions "
                               "only")
        echo = bool(body.get("echo"))
        if echo and kind != "completion":
            return _error(400, "echo is supported on /v1/completions only")
        # Prompt-token logprobs are not computed (prefill samples only at
        # the last prompt position), so echo+logprobs reports null for
        # prompt tokens.
        echo_prefix = self.tokenizer.decode(ids) if echo else ""
        try:
            params = _sampling_params(body, self.tokenizer.eos_token_id,
                                      n_logprobs=n_lp)
        except (TypeError, ValueError) as e:
            return _error(400, str(e))
        if tier is not None:
            params = dataclasses.replace(params, qos_tier=tier)
        detok = IncrementalDetokenizer(self.tokenizer, stop=_stops(body))
        rid = request.get("kgct_request_id") or self.engine.next_request_id(
            "cmpl" if kind == "completion" else "chatcmpl")
        created = int(time.time())
        stream = bool(body.get("stream"))
        try:
            n = 1 if body.get("n") is None else int(body["n"])
            best_of = n if body.get("best_of") is None else int(body["best_of"])
        except (TypeError, ValueError):
            return _error(400, "n/best_of must be integers")
        if n < 1:
            return _error(400, "n must be >= 1")
        if n > 128:   # OpenAI's cap; bounds queue/memory blast radius
            return _error(400, "n must be <= 128")
        if best_of < n:
            return _error(400, "best_of must be >= n")
        if best_of > 128:
            return _error(400, "best_of must be <= 128")
        if best_of != n and kind != "completion":
            return _error(400, "best_of is supported on /v1/completions only")
        if n > 1 or best_of > 1:
            if stream:
                return _error(400, "n/best_of > 1 with stream is not "
                                   "supported")
            return await self._run_n(body, ids, params, kind, rid, created,
                                     n, want_lps, echo_prefix,
                                     best_of=best_of, n_lp=n_lp)
        # Disaggregated decode: the router names the prefill-pool replica
        # that should run this prompt's prefill (PREFILL_URL_HEADER); pull
        # the prefilled KV and import it as committed history. None (pull
        # failed / chaos kv_handoff_fail / role=prefill) keeps the plain
        # local-prefill path — byte-identical output either way.
        handoff = None
        pull_t0 = None
        prefill_url = request.headers.get(PREFILL_URL_HEADER)
        if (prefill_url and self.role != "prefill" and self._handoff_ok
                and prefill_url.startswith(("http://", "https://"))):
            if (self.prefill_pool is not None
                    and prefill_url.rstrip("/") not in self.prefill_pool):
                # Out-of-pool pull target: never fetch (SSRF guard) — serve
                # by local recompute and leave evidence, same degradation
                # as a failed pull.
                logger.warning("prefill url %s not in --prefill-pool; "
                               "serving by local prefill", prefill_url,
                               extra={"request_id": rid})
                self.disagg.on_handoff("import", "fallback", 0, 0.0)
                self.engine.engine.obs.tracer.emit(
                    "handoff", rid, side="import", outcome="fallback",
                    error="prefill url not in --prefill-pool")
            else:
                t0 = time.monotonic()
                handoff = await self._pull_handoff(prefill_url, rid, body,
                                                   ids, tier=tier)
                if handoff is not None:
                    # import_request turns this into the decode-side TTFT
                    # sample (remote prefill + transfer + import).
                    handoff["_ttft_t0"] = t0
                else:
                    # Failed pull: the wall time it burned (up to the
                    # handoff timeout) is client-observed TTFT — backdate
                    # the recompute admission so the histogram/SLO window
                    # see the degradation instead of a green post-pull
                    # arrival stamp.
                    pull_t0 = t0
        # Fleet-wide prefix cache: on affinity overflow/remap the router
        # names the ring owner whose cache holds this prompt's prefix
        # (PREFIX_SOURCE_HEADER, router-owned — client values stripped at
        # the proxy). Pull it into the LOCAL prefix cache before admission
        # so the prefill below reuses the pages instead of recomputing
        # them. Skipped when a full-sequence handoff already carries the
        # KV; the --peer-pool allowlist guards direct-to-pod traffic the
        # router's strip cannot cover (same SSRF story as the prefill
        # url).
        psrc = request.headers.get(PREFIX_SOURCE_HEADER)
        if (self.fleet_on and handoff is None and psrc
                and self.role != "prefill"
                and psrc.startswith(("http://", "https://"))):
            if (self.peer_pool is not None
                    and psrc.rstrip("/") not in self.peer_pool):
                logger.warning("prefix source %s not in --peer-pool; "
                               "serving by local prefill", psrc,
                               extra={"request_id": rid})
                self.engine.engine.obs.on_fleet_pull("recompute")
                self.engine.engine.obs.tracer.emit(
                    "fleet_prefix", rid, side="import", outcome="recompute",
                    error="prefix source not in --peer-pool")
            else:
                # The pull's wall time — success OR failure, up to the
                # pull timeout — is client-observed TTFT: backdate the
                # admission stamp so the histogram/SLO window see it
                # (the earlier disagg-pull stamp, when one exists,
                # already covers this span).
                t0p = time.monotonic()
                await self._pull_prefix(psrc, rid, ids)
                if pull_t0 is None:
                    pull_t0 = t0p
        self.metrics.on_request()

        rid = self._reserve_rid(request, rid)
        # Session survivability: the router names the peer a drain should
        # push this stream's KV to (MIGRATE_URL_HEADER, router-owned). A
        # registered stream also EMBEDS its token ids in each SSE frame
        # (kgct_token_ids, stripped by the router before the client) — the
        # ledger the router replays on mid-stream failover.
        migrate_url = request.headers.get(MIGRATE_URL_HEADER)
        embed_tokens = bool(
            stream and migrate_url and self._handoff_ok
            and self.role != "prefill"
            and migrate_url.startswith(("http://", "https://"))
            and (self.peer_pool is None
                 or migrate_url.rstrip("/") in self.peer_pool))
        if embed_tokens:
            self._migrate_urls[rid] = (migrate_url, list(ids), params)
        # ``complete`` guards the engine-side abort: any early handler exit
        # — CancelledError when the peer closes the connection,
        # ConnectionResetError mid-SSE-write, any bug — must stop the
        # request on the device, or an abandoned request keeps generating
        # until max_tokens.
        gen = self.engine.generate(rid, ids, params, handoff=handoff,
                                   arrival_t0=pull_t0)
        complete = False
        if not stream:
            try:
                (text, finish_reason, n_out, tok_ids, tok_lps,
                 tok_tops) = await self._collect(gen, detok, rid)
                complete = True
            except ValueError as e:
                complete = True      # engine already rejected/finished it
                self.metrics.on_finish(0)  # a 400 is still a delivered response
                return _error(400, str(e))
            finally:
                # Release FIRST: if the reservation was never consumed the
                # engine never saw the request, and an abort here would be
                # a stale poison pill for a later request reusing the id.
                if not self.engine.release_reservation(rid) and not complete:
                    self.engine.abort(rid)
            self.metrics.on_finish(n_out)
            if echo:
                text = echo_prefix + text
                if want_lps:
                    tok_ids = list(ids) + tok_ids
                    tok_lps = [None] * len(ids) + tok_lps
                    tok_tops = [None] * len(ids) + tok_tops
            return json_response(_response_envelope(
                kind, rid, created, self.model_name,
                [_choice(kind, 0, text, finish_reason, self.tokenizer,
                         tok_ids, tok_lps, want_lps, tok_tops, n_lp)],
                prompt_tokens=len(ids), completion_tokens=n_out))

        resp = StreamResponse(headers={
            "Content-Type": "text/event-stream",
            "Cache-Control": "no-cache",
            # Streaming commits headers at prepare(): the correlation id
            # must ride here — the middleware cannot amend them later.
            REQUEST_ID_HEADER: rid})
        n_out = 0
        try:
            # prepare() and the echo frame sit INSIDE the cleanup scope: a
            # client that disconnects right here would otherwise strand the
            # reserved id (and, once the generator started, the request).
            await resp.prepare(request)
            if echo:
                await resp.write(_sse(_stream_body(
                    kind, rid, created, self.model_name, echo_prefix, None)))
            async for chunk in gen:
                n_out = len(chunk.output_token_ids)
                delta = self._detok_push(detok, chunk.new_token_ids,
                                         chunk.finished)
                finished = chunk.finished or detok.stopped
                if detok.stopped and not chunk.finished:
                    self.engine.abort(rid)
                # Emit when there is text, a finish, or logprobs to carry —
                # the detokenizer may hold text back (partial UTF-8 / stop
                # candidates) while the chunk's token logprobs still need a
                # frame (empty-text chunks are valid in OpenAI streams). A
                # migration-registered stream also emits on bare tokens:
                # the router's failover ledger must cover every token the
                # detokenizer consumed, or a token-replay resume would
                # diverge from the relayed text.
                if delta or finished or (embed_tokens
                                         and chunk.new_token_ids) \
                        or (want_lps and chunk.new_token_ids
                            and not detok.stopped):
                    reason = ("stop" if detok.stopped
                              else _map_reason(chunk.finish_reason))
                    sb = _stream_body(
                        kind, rid, created, self.model_name, delta,
                        reason if finished else None)
                    if embed_tokens and chunk.new_token_ids:
                        sb["kgct_token_ids"] = list(chunk.new_token_ids)
                    if want_lps and not detok.stopped:
                        # Stop-string chunks are excluded: their trailing
                        # tokens are not part of the emitted text.
                        sb["choices"][0]["logprobs"] = {
                            "tokens": [self.tokenizer.decode([t])
                                       for t in chunk.new_token_ids],
                            "token_logprobs": list(chunk.new_logprobs),
                        }
                        if chunk.new_top_logprobs:
                            sb["choices"][0]["logprobs"]["top_logprobs"] = \
                                _format_tops(self.tokenizer,
                                             chunk.new_top_logprobs)
                    await resp.write(_sse(sb))
                if finished:
                    complete = True
                    break
        except ValueError as e:
            complete = True
            await resp.write(_sse({"error": {"message": str(e), "code": 400}}))
        except StreamMigratedError as e:
            # The drain driver pushed this sequence to a peer: abort the
            # client connection WITHOUT a terminal frame. The router's
            # relay sees an incomplete stream and re-dispatches to the
            # migration target, where the parked state resumes the stream
            # the client is still holding open.
            complete = True      # engine state is already retired
            self.engine.engine.obs.tracer.emit(
                "migrate", rid, side="push", outcome="relay_severed",
                peer=e.peer_url, tokens=n_out)
            raise
        finally:
            self._migrate_urls.pop(rid, None)
            # Release first (see the non-stream path): a reservation that
            # generate() never consumed means nothing reached the engine —
            # aborting would poison a later request reusing the same id.
            if not self.engine.release_reservation(rid) and not complete:
                self.engine.abort(rid)
        self.metrics.on_finish(n_out)
        await resp.write(b"data: [DONE]\n\n")
        await resp.write_eof()
        return resp

    async def _run_n(self, body, ids, params, kind, rid, created, n,
                     want_lps, echo_prefix="", best_of=None,
                     n_lp=0) -> Response:
        """OpenAI ``n`` > 1 / ``best_of``: best_of engine requests for one
        prompt, gathered concurrently; when best_of > n, choices are ranked
        by CUMULATIVE logprob (vLLM's selection rule) and the top n
        returned. Greedy sampling yields identical candidates — same as
        vLLM; use temperature > 0 for variety."""
        self.metrics.on_request()
        best_of = n if best_of is None else best_of
        # Ranking needs per-token logprobs even when the client didn't ask.
        run_params = (dataclasses.replace(params, logprobs=True)
                      if best_of > n and not params.logprobs else params)

        # Actual engine ids per child (post duplicate-suffix): the error
        # path must abort THESE.
        subs: list = [None] * best_of

        async def one(i):
            sub = f"{rid}-{i}"
            detok = IncrementalDetokenizer(self.tokenizer, stop=_stops(body))
            # Seeded fan-out: each candidate gets a derived sub-seed (choice
            # 0 keeps the base seed, matching n=1).
            p_i = run_params
            if params.seed is not None and i > 0:
                p_i = dataclasses.replace(
                    run_params, seed=(params.seed + i) & 0x7fffffff)
            base = sub
            while not self.engine.reserve_request_id(sub):
                sub = f"{base}+{self.engine.next_request_id('dup')}"
            subs[i] = sub
            gen = self.engine.generate(sub, list(ids), p_i)
            complete = False
            try:
                out = await self._collect(gen, detok, sub)
                complete = True
                return out
            finally:
                if not self.engine.release_reservation(sub) and not complete:
                    self.engine.abort(sub)

        # return_exceptions so one failing child never leaves siblings
        # running unobserved.
        results = await asyncio.gather(*(one(i) for i in range(best_of)),
                                       return_exceptions=True)
        errors = [r for r in results if isinstance(r, BaseException)]
        if errors:
            for i, r in enumerate(results):
                if not isinstance(r, BaseException) and subs[i] is not None:
                    self.engine.abort(subs[i])
            self.metrics.on_finish(0)
            if all(isinstance(e, ValueError) for e in errors):
                return _error(400, str(errors[0]))
            raise errors[0]
        # Usage counts ALL generated candidates (OpenAI bills every best_of
        # completion), not just the returned ones.
        discarded_out = 0
        if best_of > n:
            def cum_lp(res):
                lps = res[4]
                return sum(lps) if lps else float("-inf")
            results = sorted(results, key=cum_lp, reverse=True)
            discarded_out = sum(r[2] for r in results[n:])
            results = results[:n]
            if not params.logprobs:       # ranking-only logprobs: strip
                results = [(t, fr, no, ti, [], tt)
                           for t, fr, no, ti, _, tt in results]
        choices = []
        total_out = discarded_out
        for i, (text, finish_reason, n_out, tok_ids, tok_lps,
                tok_tops) in enumerate(results):
            total_out += n_out
            if echo_prefix:
                text = echo_prefix + text
                if want_lps:
                    tok_ids = list(ids) + tok_ids
                    tok_lps = [None] * len(ids) + tok_lps
                    tok_tops = [None] * len(ids) + tok_tops
            choices.append(_choice(kind, i, text, finish_reason,
                                   self.tokenizer, tok_ids, tok_lps,
                                   want_lps, tok_tops, n_lp))
        self.metrics.on_finish(total_out)
        return json_response(_response_envelope(
            kind, rid, created, self.model_name, choices,
            prompt_tokens=len(ids), completion_tokens=total_out))

    async def _collect(self, gen, detok: IncrementalDetokenizer, rid: str):
        text = []
        finish_reason = None
        n_out = 0
        tok_ids: list[int] = []
        tok_lps: list[float] = []
        tok_tops: list = []
        async for chunk in gen:
            n_out = len(chunk.output_token_ids)
            text.append(self._detok_push(detok, chunk.new_token_ids,
                                         chunk.finished))
            if detok.stopped:
                # The chunk containing the stop match is excluded from the
                # logprobs record: its trailing tokens are not represented
                # in the truncated text.
                if not chunk.finished:
                    self.engine.abort(rid)
                finish_reason = "stop"
                break
            tok_ids.extend(chunk.new_token_ids)
            tok_lps.extend(chunk.new_logprobs or [])
            tok_tops.extend(chunk.new_top_logprobs or [])
            if chunk.finished:
                finish_reason = _map_reason(chunk.finish_reason)
        return ("".join(text), finish_reason, n_out, tok_ids, tok_lps,
                tok_tops)


# -- OpenAI wire formats ----------------------------------------------------

def _map_reason(reason: Optional[str]) -> Optional[str]:
    return {"eos": "stop", "stop_token": "stop", "length": "length",
            "abort": "abort"}.get(reason or "", reason)


def _format_tops(tokenizer, tops) -> list:
    """[(id, lp) x N] per position -> OpenAI top_logprobs dicts
    ({token_str: lp}); None entries (echoed prompt positions) pass through.
    Distinct ids can decode to the same string — keep the BEST logprob per
    string."""
    out = []
    for t in tops:
        if t is None:
            out.append(None)
            continue
        d: dict[str, float] = {}
        for tid, lp in t:
            s = tokenizer.decode([tid])
            if s not in d or lp > d[s]:
                d[s] = lp
        out.append(d)
    return out


def _choice(kind, index, text, finish_reason, tokenizer, tok_ids, tok_lps,
            want_lps, tok_tops=None, n_lp=0) -> dict:
    choice: dict[str, Any] = {"index": index, "finish_reason": finish_reason}
    if kind == "completion":
        choice["text"] = text
        if want_lps:
            choice["logprobs"] = {
                "tokens": [tokenizer.decode([t]) for t in tok_ids],
                "token_logprobs": tok_lps,
            }
            if n_lp >= 1:
                choice["logprobs"]["top_logprobs"] = _format_tops(
                    tokenizer, tok_tops or [])
    else:
        choice["message"] = {"role": "assistant", "content": text}
    return choice


def _response_envelope(kind, rid, created, model, choices, *,
                       prompt_tokens, completion_tokens) -> dict:
    return {
        "id": rid, "object": kind, "created": created, "model": model,
        "choices": choices,
        "usage": {"prompt_tokens": prompt_tokens,
                  "completion_tokens": completion_tokens,
                  "total_tokens": prompt_tokens + completion_tokens}}


def _stream_body(kind, rid, created, model, delta, finish_reason) -> dict:
    choice: dict[str, Any] = {"index": 0, "finish_reason": finish_reason}
    if kind == "completion":
        choice["text"] = delta
        obj = "text_completion"
    else:
        choice["delta"] = {"content": delta} if delta else {}
        obj = "chat.completion.chunk"
    return {"id": rid, "object": obj, "created": created, "model": model,
            "choices": [choice]}


def _sse(obj: dict) -> bytes:
    return f"data: {json.dumps(obj)}\n\n".encode()


def _error(status: int, message: str) -> Response:
    return json_response(
        {"error": {"message": message, "type": "invalid_request_error",
                   "code": status}},
        status=status)


# -- entry point -------------------------------------------------------------

def build_server(config: EngineConfig, tokenizer_path: Optional[str] = None,
                 model_name: Optional[str] = None, params=None,
                 device: torch.device | str = "cuda", role: str = "both",
                 prefill_pool: Optional[list] = None,
                 peer_pool: Optional[list] = None,
                 fleet_prefix_cache: bool = False,
                 integrity_checks: bool = True,
                 draft_params=None, leader=None, groups=None) -> APIServer:
    """The server over a new engine on ``device`` (the card unless the
    caller asks for the CPU). ``leader``/``groups``: rank 0 of a
    multi-rank group (``serving/multihost.py``, ``parallel/mesh.py``)."""
    if role not in REPLICA_ROLES:
        raise ValueError(f"unknown replica role {role!r} "
                         f"(known: {', '.join(REPLICA_ROLES)})")
    tokenizer = load_tokenizer(tokenizer_path)
    engine = AsyncLLMEngine(config, params=params,
                            eos_token_id=tokenizer.eos_token_id,
                            device=device, draft_params=draft_params,
                            leader=leader, groups=groups)
    return APIServer(engine, tokenizer, model_name or config.model.name,
                     resilience=config.resilience, role=role,
                     prefill_pool=prefill_pool, peer_pool=peer_pool,
                     fleet_prefix_cache=fleet_prefix_cache,
                     integrity_checks=integrity_checks)


def _url_list(arg: Optional[str]) -> Optional[list[str]]:
    """A comma-separated CLI url list (None when unset)."""
    if not arg:
        return None
    return [u.strip() for u in arg.split(",") if u.strip()] or None


def build_parser():
    """The server CLI's argument parser (``main`` adds the checks that
    span flags)."""
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--model", required=True)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; fails at once without a card) or "
                   "cpu (the plain PyTorch path, for a look)")
    p.add_argument("--tokenizer", default=None,
                   help="local HF tokenizer dir; default: byte tokenizer")
    p.add_argument("--weights", default=None,
                   help="local safetensors dir; default: random init")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--max-model-len", type=int, default=None)
    p.add_argument("--tensor-parallel-size", type=int, default=1)
    p.add_argument("--pipeline-parallel-size", type=int, default=1)
    p.add_argument("--sequence-parallel-size", type=int, default=1)
    p.add_argument("--expert-parallel-size", type=int, default=1)
    p.add_argument("--hbm-utilization", "--gpu-memory-utilization",
                   dest="hbm_utilization", type=float, default=0.90,
                   help="fraction of free device memory given to the KV "
                   "page pool")
    p.add_argument("--max-num-seqs", type=int, default=64)
    p.add_argument("--swap-space-gb", "--swap-space", dest="swap_space_gb",
                   type=float, default=0.0,
                   help="host KV swap space in GB (vLLM swap-space parity); "
                   ">0 turns on the two-tier KV cache")
    p.add_argument("--dtype", default=None,
                   help="serving dtype override (bfloat16/float32; float16 "
                   "maps to bfloat16)")
    p.add_argument("--quantization", default=None, choices=["int8", "int4"],
                   help="weight-only quantization: int8 (W8A16, "
                   "per-output-channel) or int4 (W4A16, group-wise scales)")
    p.add_argument("--quant-group-size", type=int, default=None,
                   help="int4 only: input-dim rows per scale group "
                   "(default 128)")
    p.add_argument("--enable-prefix-caching", action="store_true")
    p.add_argument("--enable-mixed-batch", action="store_true",
                   help="accepted for back-compat: mixed batching is the "
                   "default; opt out with --disable-mixed-batch")
    p.add_argument("--disable-mixed-batch", action="store_true")
    p.add_argument("--decode-priority-token-budget", type=int, default=None)
    p.add_argument("--enable-spec-decode", action="store_true")
    p.add_argument("--num-speculative-tokens", type=int, default=None)
    p.add_argument("--spec-draft-model", default=None)
    p.add_argument("--spec-draft-weights", default=None)
    p.add_argument("--spec-adaptive-k", action="store_true")
    p.add_argument("--spec-k-max", type=int, default=None)
    p.add_argument("--role", choices=list(REPLICA_ROLES), default="both",
                   help="disaggregated prefill/decode serving: 'prefill' "
                   "dedicates this replica to running prompts and exporting "
                   "their KV via /internal/kv_handoff; 'decode' dedicates "
                   "it to importing prefilled KV and streaming decode; "
                   "'both' (default) serves colocated, byte-identical to "
                   "pre-disaggregation behavior. The router wires the "
                   "pools together (--prefill-replicas)")
    p.add_argument("--prefill-pool", default=None,
                   help="comma-separated prefill-replica base URLs this "
                   "replica may pull KV handoffs from; an x-kgct-prefill-url "
                   "naming any OTHER url degrades to local recompute (SSRF "
                   "guard for direct-to-pod traffic). Unset = any url "
                   "(single-tenant network)")
    p.add_argument("--peer-pool", default=None,
                   help="comma-separated sibling-replica base URLs the "
                   "SIGTERM drain may live-migrate running streams to; an "
                   "x-kgct-migrate-url naming any OTHER url keeps the "
                   "stream local, wait-it-out style (SSRF guard, mirror of "
                   "--prefill-pool). Unset = any url (single-tenant "
                   "network)")
    p.add_argument("--fleet-prefix-cache", action="store_true",
                   help="fleet-wide KV reuse (global prefix cache): serve "
                   "peers' prefix fetches on /internal/fetch_prefix, pull "
                   "the ring owner's cached prefix on the router's "
                   "x-kgct-prefix-source hint instead of recomputing it "
                   "(anti-thrash roofline gate: never fetch what is "
                   "cheaper to re-prefill; KGCT_FLEET_BW_GBPS / "
                   "KGCT_FLEET_FLOPS override the priced constants), and "
                   "remote-spill evicted prefix pages to --peer-pool "
                   "siblings' host tiers before dropping them. Requires "
                   "--enable-prefix-caching; off = byte-identical serving")
    p.add_argument("--no-integrity-checks", action="store_true",
                   help="disable the KV wire-plane integrity layer "
                   "(per-page CRC32 checksums + whole-frame digest "
                   "on every handoff/prefix/spill/migration frame, "
                   "verified at every import seam; default ON). Off = "
                   "wire bytes byte-identical to the pre-integrity "
                   "encoders — only for talking to peers that do not "
                   "speak the integrity dialect yet")
    p.add_argument("--drain-grace-s", type=float, default=None,
                   help="SIGTERM drain: max seconds to wait for in-flight "
                   "requests before exiting anyway (default 120)")
    p.add_argument("--qos-tiers", default=None,
                   help="multi-tenant QoS priority classes as JSON, or the "
                   "literal 'default'")
    p.add_argument("--qos-default-tier", default=None)
    p.add_argument("--enforce-eager", action="store_true",
                   help="run every decode window eagerly: no CUDA graph "
                   "capture, kgct_jit_compiles_total stays 0 (debug; "
                   "slower)")
    p.add_argument("--trust-remote-code", action="store_true",
                   help="accepted; local checkpoints never execute remote "
                   "code here")
    p.add_argument("--disable-custom-all-reduce", action="store_true",
                   help="accepted for reference-values parity; the port's "
                   "all-reduce is torch.distributed's (NCCL or gloo) and "
                   "has no custom path to disable")
    p.add_argument("--distributed", action="store_true",
                   help="this process is one rank of a multi-process group "
                   "(coordinator, world and rank from KGCT_COORDINATOR, "
                   "KGCT_NUM_PROCESSES, KGCT_PROCESS_ID; parallel/mesh.py)")
    return p


def main(argv: Optional[list[str]] = None) -> None:
    """CLI: python -m kubernetes_gpu_cluster_tpu_torch.serving.api_server
    --model tinyllama-1.1b --port 8000 [--tokenizer /models/TinyLlama]
    [--device cuda|cpu]

    Flag names are the JAX package's CLI, which mirrors the reference's
    vllmConfig/extraArgs surface, so rendered manifests carry over.
    ``--trust-remote-code`` and ``--disable-custom-all-reduce`` are
    accepted and change nothing here (local checkpoints only; the
    all-reduce is torch.distributed's). ``--enforce-eager`` turns off the
    decode window's CUDA graph capture (``engine/step_programs.py``), as
    the JAX package's turns off jit.

    tp, ep, pp or sp above 1: with ``--distributed`` this process is the
    first rank of pod ``KGCT_PROCESS_ID`` of the ``KGCT_NUM_PROCESSES``
    pods the deploy renderer starts (global rank 0 serves, the others
    follow); where the layout has more ranks than pods, it starts its
    pod's ``world / pods`` - 1 other ranks on ``cuda:1..``, global rank
    ``pod * local + k`` with control port ``KGCT_CONTROL_PORT + k``.
    Without ``--distributed`` rank 0 starts the other ranks itself on
    ``cuda:1..`` (or the CPU) and forms the group over localhost. With
    ``--weights`` each rank streams its own slices of the checkpoint. A
    layout the engine refuses (``engine.validate_layout``) is refused
    before any rank starts."""
    from ..config import (CacheConfig, ParallelConfig, SchedulerConfig,
                          get_model_config)
    from ..engine.engine import validate_layout
    from ..engine.qos import parse_qos_tiers

    p = build_parser()
    args = p.parse_args(argv)

    parallel = ParallelConfig(tp=args.tensor_parallel_size,
                              pp=args.pipeline_parallel_size,
                              sp=args.sequence_parallel_size,
                              ep=args.expert_parallel_size)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; the server runs on "
                           "the card (--device cpu runs the plain PyTorch "
                           "path)")
    model_cfg = get_model_config(args.model)
    if args.dtype:
        dtype = {"float16": "bfloat16", "half": "bfloat16",
                 "bf16": "bfloat16"}.get(args.dtype, args.dtype)
        model_cfg = model_cfg.replace(dtype=dtype)
    if args.quant_group_size is not None and args.quantization != "int4":
        p.error("--quant-group-size requires --quantization int4")
    if not args.enable_spec_decode:
        for flag, val in (("--num-speculative-tokens",
                           args.num_speculative_tokens),
                          ("--spec-draft-model", args.spec_draft_model),
                          ("--spec-k-max", args.spec_k_max),
                          ("--spec-adaptive-k", args.spec_adaptive_k
                           or None)):
            if val is not None:
                p.error(f"{flag} requires --enable-spec-decode")
    if args.spec_draft_weights and not args.spec_draft_model:
        p.error("--spec-draft-weights requires --spec-draft-model")
    if args.spec_k_max is not None and not args.spec_adaptive_k:
        p.error("--spec-k-max requires --spec-adaptive-k")
    if args.quantization:
        model_cfg = model_cfg.replace(quantization=args.quantization)
        if args.quant_group_size is not None:
            model_cfg = model_cfg.replace(
                quant_group_size=args.quant_group_size)
    try:
        qos_tiers = parse_qos_tiers(args.qos_tiers)
    except ValueError as e:
        p.error(str(e))
    if args.qos_default_tier is not None:
        if not qos_tiers:
            p.error("--qos-default-tier requires --qos-tiers")
        if args.qos_default_tier not in {t.name for t in qos_tiers}:
            p.error(f"--qos-default-tier {args.qos_default_tier!r} is not "
                    "a configured tier")
    if args.expert_parallel_size > 1 and not model_cfg.is_moe:
        # ep on a dense model replicates all work across the axis.
        p.error(f"--expert-parallel-size {args.expert_parallel_size} "
                f"requires an MoE model; {model_cfg.name} is dense")
    # Refuse a layout the engine refuses before any rank starts.
    validate_layout(EngineConfig(model=model_cfg, parallel=parallel),
                    dataclasses.asdict(parallel))
    follower, local_ranks = None, []
    if args.distributed:
        from .multihost import CONTROL_PORT, DirectiveFollower, ranks_per_pod
        world = parallel.world_size
        coord = os.environ.get("KGCT_COORDINATOR")
        if world > 1 and not coord:
            raise ValueError(
                f"--distributed at world size {world} needs "
                "KGCT_COORDINATOR, KGCT_NUM_PROCESSES and KGCT_PROCESS_ID "
                "(without --distributed one node starts its own ranks)")
        # A pod runs world / pods ranks, one a card: this process is the
        # pod's first, and starts the others.
        local = ranks_per_pod(world,
                              int(os.environ.get("KGCT_NUM_PROCESSES", "1")))
        rank = int(os.environ.get("KGCT_PROCESS_ID", "0")) * local
        ctrl = int(os.environ.get("KGCT_CONTROL_PORT", CONTROL_PORT))
        local_ranks = _start_ranks(argv, device, parallel, coord,
                                   [(rank + k, k, ctrl + k)
                                    for k in range(1, local)])
        if rank > 0:
            # Bound before the rendezvous blocks, so the leader's connect
            # finds the listener.
            follower = DirectiveFollower(port=ctrl)
            _exit_with_parent()
        try:
            initialize_distributed(num_processes=world, process_id=rank,
                                   device=device)
        except BaseException:
            _reap(local_ranks)
            raise
    elif parallel.world_size > 1:
        local_ranks = _start_local_ranks(argv, parallel, device)
    groups = mesh_from_config(parallel)
    config = EngineConfig(
        model=model_cfg,
        cache=CacheConfig(hbm_utilization=args.hbm_utilization,
                          swap_space_gb=args.swap_space_gb),
        scheduler=SchedulerConfig(
            max_num_seqs=args.max_num_seqs,
            enable_prefix_caching=args.enable_prefix_caching,
            mixed_batch_enabled=not args.disable_mixed_batch,
            decode_priority_token_budget=args.decode_priority_token_budget,
            spec_decode_enabled=args.enable_spec_decode,
            num_speculative_tokens=(args.num_speculative_tokens
                                    if args.num_speculative_tokens is not None
                                    else 4),
            spec_draft_model=args.spec_draft_model,
            spec_adaptive_k=args.spec_adaptive_k,
            spec_k_max=args.spec_k_max,
            qos_tiers=qos_tiers,
            qos_default_tier=args.qos_default_tier),
        parallel=parallel,
        resilience=(ResilienceConfig(drain_grace_s=args.drain_grace_s)
                    if args.drain_grace_s is not None
                    else ResilienceConfig()),
        max_model_len=args.max_model_len,
        enforce_eager=args.enforce_eager)
    params = None
    if args.weights:
        from ..engine.weights import load_weights
        # Under a layout of more than one rank the load streams: each rank
        # reads only its own byte ranges.
        params = load_weights(args.weights, config.model, device=device,
                              groups=groups)
    draft_params = None
    if args.spec_draft_weights:
        from ..engine.weights import load_weights
        # Loaded in the TARGET's serving dtype, the dtype of the draft
        # runner's KV pool.
        draft_params = load_weights(
            args.spec_draft_weights,
            get_model_config(args.spec_draft_model).replace(
                dtype=model_cfg.dtype), device=device)
    if follower is not None:
        try:
            _serve_follower(follower, config, args, params, device, groups,
                            draft_params)
        finally:
            _reap(local_ranks)
        return
    leader = None
    if groups is not None:
        from .multihost import DirectiveLeader, follower_addrs_from_env
        leader = DirectiveLeader(
            follower_addrs_from_env(groups.world_size),
            heartbeat_interval_s=config.resilience.heartbeat_interval_s)
    server = build_server(config, args.tokenizer, args.model, params=params,
                          device=device, role=args.role,
                          prefill_pool=_url_list(args.prefill_pool),
                          peer_pool=_url_list(args.peer_pool),
                          fleet_prefix_cache=args.fleet_prefix_cache,
                          integrity_checks=not args.no_integrity_checks,
                          draft_params=draft_params, leader=leader,
                          groups=groups)
    if leader is not None:
        # Connect now (an empty directive steps nobody): every follower
        # then hears heartbeats from the start and the stop at shutdown.
        leader.broadcast([], [])
    app = server.build_app()

    async def _arm_sigterm(app_):
        # k8s pod termination: SIGTERM -> begin_drain (stop admitting / flip
        # health, finish in-flight streams), then exit via SIGINT (run_app's
        # clean shutdown). Installed only on the CLI path — embedders keep
        # their own signal handling.
        import signal

        loop = asyncio.get_running_loop()
        loop.add_signal_handler(
            signal.SIGTERM,
            lambda: server.begin_drain(
                on_drained=lambda: os.kill(os.getpid(), signal.SIGINT)))

    app.on_startup.append(_arm_sigterm)
    try:
        run_app(app, host=args.host, port=args.port)
    finally:
        _reap(local_ranks)


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start_local_ranks(argv: Optional[list[str]], parallel,
                       device: torch.device) -> list:
    """One node, one container: start ranks 1..world-1 (``_start_ranks``)
    with a control port each, join the group over localhost as rank 0, and
    point the leader at them."""
    # The group never leaves this host: gloo binds the loopback.
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    world = parallel.world_size
    coord = f"127.0.0.1:{_free_port()}"
    ctrl = [_free_port() for _ in range(1, world)]
    procs = _start_ranks(argv, device, parallel, coord,
                         [(k, k, ctrl[k - 1]) for k in range(1, world)])
    os.environ["KGCT_FOLLOWER_ADDRS"] = ",".join(
        f"127.0.0.1:{c}" for c in ctrl)
    try:
        initialize_distributed(coord, world, 0, device=device)
    except BaseException:
        _reap(procs)
        raise
    return procs


def _start_ranks(argv: Optional[list[str]], device: torch.device,
                 parallel, coord: str, ranks: list) -> list:
    """Start each ``(global rank, k, control port)`` of ``ranks`` as this
    CLI with ``--distributed`` on ``cuda:<index+k>`` (or the CPU), with an
    ephemeral health port, in the group of ``parallel``'s ranks at
    ``coord``. They exit when the leader's channel closes or this process
    dies. A layout that needs a card this process does not see is refused
    (``SystemExit``) before any rank starts."""
    import subprocess
    import sys

    world = parallel.world_size
    if ranks and device.type == "cuda":
        first = device.index or 0
        seen = torch.cuda.device_count()
        last = first + max(k for _, k, _ in ranks)
        if last >= seen:
            sizes = dataclasses.asdict(parallel)
            layout = " x ".join(f"{a} {sizes[a]}" for a in ("tp", "pp", "sp",
                                                           "ep", "dp")
                                if a in ("tp", "pp") or sizes[a] > 1)
            raise SystemExit(
                f"refused: the layout {layout} (world {world}) would start "
                f"ranks {[r for r, _, _ in ranks]} on this pod on cards "
                f"cuda:{first + 1}..cuda:{last}, but it sees {seen} card(s) "
                f"(cuda:0..cuda:{seen - 1}); give the pod {last + 1} cards "
                "or lower the parallel sizes")
    argv = list(sys.argv[1:] if argv is None else argv)
    procs = []
    for rank, k, ctrl in ranks:
        dev = (f"cuda:{(device.index or 0) + k}" if device.type == "cuda"
               else "cpu")
        env = dict(os.environ, KGCT_COORDINATOR=coord,
                   KGCT_NUM_PROCESSES=str(world), KGCT_PROCESS_ID=str(rank),
                   KGCT_CONTROL_PORT=str(ctrl),
                   KGCT_PARENT_PID=str(os.getpid()))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", __spec__.name, *argv, "--distributed",
             "--device", dev, "--port", "0", "--host", "127.0.0.1"],
            env=env))
    if procs:
        logger.info("started ranks %s (pids %s); coordinator %s",
                    [r for r, _, _ in ranks], [q.pid for q in procs], coord)
    return procs


def _reap(procs: list, timeout_s: float = 30.0) -> None:
    """Wait for local ranks to exit after the leader's stop; kill any that
    do not within ``timeout_s``."""
    deadline = time.monotonic() + timeout_s
    for q in procs:
        try:
            q.wait(timeout=max(deadline - time.monotonic(), 0.1))
        except Exception:
            logger.warning("local rank pid %d did not exit; killing", q.pid)
            q.kill()
            q.wait()


def _exit_with_parent() -> None:
    """A local rank (``KGCT_PARENT_PID``) exits when the rank 0 that
    started it is gone, even before the directive channel is up."""
    ppid = int(os.environ.get("KGCT_PARENT_PID", "0"))
    if not ppid:
        return
    import threading

    def watch():
        while True:
            time.sleep(1.0)
            try:
                os.kill(ppid, 0)
            except OSError:
                logger.error("rank 0 (pid %d) is gone; exiting", ppid)
                os._exit(1)
    threading.Thread(target=watch, daemon=True,
                     name="kgct-parent-watch").start()


def _serve_follower(follower, config: EngineConfig, args, params,
                    device: torch.device, groups, draft_params) -> None:
    """Rank > 0: no API, the same engine stepping on rank 0's directives
    (``serving/multihost.py``), and ``/health`` tied to the loop's
    liveness for the pod's probes."""
    from ..engine import LLMEngine
    from ..resilience.heartbeat import LoopLiveness
    from .multihost import serve_follower_health
    liveness = LoopLiveness(
        timeout_s=max(config.resilience.liveness_timeout_s,
                      config.resilience.watchdog_timeout_s))
    health = serve_follower_health(args.port, host=args.host,
                                   liveness=liveness)
    tokenizer = load_tokenizer(args.tokenizer)
    engine = LLMEngine(config, params=params,
                       eos_token_id=tokenizer.eos_token_id, device=device,
                       draft_params=draft_params, groups=groups)
    try:
        follower.run(engine, liveness=liveness,
                     liveness_timeout_s=config.resilience.liveness_timeout_s)
    finally:
        health.shutdown()


if __name__ == "__main__":
    main()
