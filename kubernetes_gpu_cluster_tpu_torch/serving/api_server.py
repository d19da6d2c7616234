"""OpenAI-compatible HTTP server over AsyncLLMEngine: the JAX package's
``serving/api_server.py``, colocated serving, on ``serving/http.py``.

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
admissions stop with 503, ``/health`` flips, and in-flight streams finish
before exit. A step watchdog flips ``/health`` when device dispatch hangs.

Not served yet: the fleet half (the ``/internal/*`` routes, the KV pulls
named by ``x-kgct-prefill-url`` / ``x-kgct-prefix-source``, live migration
to ``x-kgct-migrate-url``, ``role`` prefill/decode, the pools and the fleet
prefix cache: ROADMAP A6) and multihost / parallel serving (A7). A request
carrying a fleet header is served by local prefill, as the JAX package
serves one whose pull target is outside its allowlist; the constructor and
the CLI refuse the rest.
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
from ..resilience import (AdmissionController, DrainState, ResilienceHub,
                          StepWatchdog)
from ..resilience.drain import drain_and_notify
from ..utils import get_logger
from .async_engine import AsyncLLMEngine
from .errors import (MIGRATE_URL_HEADER, PREFILL_URL_HEADER,
                     PREFIX_SOURCE_HEADER, QOS_TIER_HEADER, REQUEST_ID_HEADER,
                     valid_request_id)
from .errors import overloaded_error as _overloaded
from .http import (Application, Request, Response, StreamResponse,
                   json_response, run_app)
from .metrics import Metrics
from .tokenizer import (IncrementalDetokenizer, Tokenizer,
                        apply_chat_template, load_tokenizer)

logger = get_logger("serving.api")

# Per-request TTFT budget (milliseconds). Absent -> the config default;
# both absent -> admit unconditionally.
TTFT_BUDGET_HEADER = "x-kgct-ttft-budget-ms"

# Replica roles of the JAX package; this server serves "both" (colocated).
REPLICA_ROLES = ("prefill", "decode", "both")
FLEET_TODO = "the fleet plane is not ported yet (ROADMAP A6)"
PARALLEL_TODO = "multihost and parallel serving are not ported yet " \
                "(ROADMAP A7)"


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
    disaggregation series (sides "push", "recv", "resume"). Zeros until
    live migration is served (A6) — a fresh scrape is nan-free."""

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


def _refuse_fleet(role: str, prefill_pool, peer_pool,
                  fleet_prefix_cache: bool) -> None:
    if role not in REPLICA_ROLES:
        raise ValueError(f"unknown replica role {role!r} "
                         f"(known: {', '.join(REPLICA_ROLES)})")
    for what, val in ((f"role={role!r}", role != "both"),
                      ("prefill_pool", bool(prefill_pool)),
                      ("peer_pool", bool(peer_pool)),
                      ("fleet_prefix_cache", fleet_prefix_cache)):
        if val:
            raise ValueError(f"{what}: {FLEET_TODO}; this server serves "
                             "colocated (role 'both')")


class APIServer:
    def __init__(self, engine: AsyncLLMEngine, tokenizer: Tokenizer,
                 model_name: str,
                 resilience: Optional[ResilienceConfig] = None,
                 role: str = "both",
                 prefill_pool: Optional[list] = None,
                 peer_pool: Optional[list] = None,
                 fleet_prefix_cache: bool = False):
        _refuse_fleet(role, prefill_pool, peer_pool, fleet_prefix_cache)
        self.engine = engine
        self.tokenizer = tokenizer
        self.model_name = model_name
        self.metrics = Metrics(engine.engine)
        self.role = role
        self.disagg = DisaggStats(role)
        self.migration = MigrationStats()
        # The largest legitimate body is a token-id prompt at the model's
        # max length: a generous per-token byte budget plus slack.
        self.client_max_size = (
            32 * int(engine.engine.config.effective_max_len) + (1 << 20))
        self._profile_busy = False
        res = resilience or ResilienceConfig()
        self.res_config = res
        self.drain_state = DrainState()
        self._drain_task: Optional[asyncio.Task] = None
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

    # -- app wiring ----------------------------------------------------------

    def build_app(self) -> Application:
        app = Application(middleware=self._request_id_mw,
                          client_max_size=self.client_max_size)
        app.add_post("/v1/completions", self.completions)
        app.add_post("/v1/chat/completions", self.chat_completions)
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

    async def _on_cleanup(self, app: Application) -> None:
        self.engine.shutdown()
        self.watchdog.stop()

    # -- resilience gates ----------------------------------------------------

    def begin_drain(self, on_drained=None):
        """Start graceful drain (idempotent): stop admitting, flip /health,
        finish every in-flight stream, then fire ``on_drained``. Returns
        the drain task, or None if a drain was already running. Must be
        called on the server's event loop (the SIGTERM handler and tests
        both are)."""
        if not self.drain_state.start_drain():
            return None
        # Black-box capture of the pre-drain seconds: what was queued or
        # mid-stream when the SIGTERM landed outlives the pod in the dump.
        self.engine.engine.obs.flight.dump(
            "sigterm_drain", grace_s=self.res_config.drain_grace_s)
        self._drain_task = asyncio.get_running_loop().create_task(
            drain_and_notify(self.drain_state, self.engine,
                             grace_s=self.res_config.drain_grace_s,
                             on_drained=on_drained))
        return self._drain_task

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
            prof.start()
            try:
                await asyncio.sleep(seconds)
            finally:
                prof.stop()
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

    def _local_fleet_fallback(self, request: Request, rid: str) -> None:
        """A fleet header names a peer this replica cannot pull from or
        push to yet (A6): the request is served by local prefill, with the
        evidence the JAX package leaves for a pull target outside its
        allowlist (log, counter, trace span). Output is unchanged."""
        obs = self.engine.engine.obs
        for header in (PREFILL_URL_HEADER, PREFIX_SOURCE_HEADER,
                       MIGRATE_URL_HEADER):
            url = request.headers.get(header)
            if not url or not url.startswith(("http://", "https://")):
                continue
            logger.warning("%s %s: %s; serving by local prefill", header,
                           url, FLEET_TODO, extra={"request_id": rid})
            if header == PREFILL_URL_HEADER:
                self.disagg.on_handoff("import", "fallback", 0, 0.0)
                obs.tracer.emit("handoff", rid, side="import",
                                outcome="fallback", error=FLEET_TODO)
            elif header == PREFIX_SOURCE_HEADER:
                obs.on_fleet_pull("recompute")
                obs.tracer.emit("fleet_prefix", rid, side="import",
                                outcome="recompute", error=FLEET_TODO)
            else:
                obs.tracer.emit("migrate", rid, side="push",
                                outcome="fallback", error=FLEET_TODO)

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
        self._local_fleet_fallback(request, rid)
        self.metrics.on_request()

        rid = self._reserve_rid(request, rid)
        # ``complete`` guards the engine-side abort: any early handler exit
        # — CancelledError when the peer closes the connection,
        # ConnectionResetError mid-SSE-write, any bug — must stop the
        # request on the device, or an abandoned request keeps generating
        # until max_tokens.
        gen = self.engine.generate(rid, ids, params)
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
                # frame (empty-text chunks are valid in OpenAI streams).
                if delta or finished or (want_lps and chunk.new_token_ids
                                         and not detok.stopped):
                    reason = ("stop" if detok.stopped
                              else _map_reason(chunk.finish_reason))
                    sb = _stream_body(
                        kind, rid, created, self.model_name, delta,
                        reason if finished else None)
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
        finally:
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
                 draft_params=None) -> APIServer:
    """The server over a new engine on ``device`` (the card unless the
    caller asks for the CPU)."""
    _refuse_fleet(role, prefill_pool, peer_pool, fleet_prefix_cache)
    tokenizer = load_tokenizer(tokenizer_path)
    engine = AsyncLLMEngine(config, params=params,
                            eos_token_id=tokenizer.eos_token_id,
                            device=device, draft_params=draft_params)
    return APIServer(engine, tokenizer, model_name or config.model.name,
                     resilience=config.resilience)


def main(argv: Optional[list[str]] = None) -> None:
    """CLI: python -m kubernetes_gpu_cluster_tpu_torch.serving.api_server
    --model tinyllama-1.1b --port 8000 [--tokenizer /models/TinyLlama]
    [--device cuda|cpu]

    Flag names are the JAX package's CLI, which mirrors the reference's
    vllmConfig/extraArgs surface, so rendered manifests carry over. The
    fleet flags (``--role`` other than both, ``--prefill-pool``,
    ``--peer-pool``, ``--fleet-prefix-cache``) wait for ROADMAP A6;
    ``--distributed`` and any parallel size above 1 wait for A7: each
    raises ValueError. ``--trust-remote-code``,
    ``--disable-custom-all-reduce``, ``--enforce-eager`` and
    ``--no-integrity-checks`` are accepted and change nothing here (local
    checkpoints only; one card, no custom all-reduce; eager PyTorch; no KV
    wire in this server yet)."""
    import argparse

    from ..config import (CacheConfig, ParallelConfig, SchedulerConfig,
                          get_model_config)
    from ..engine.qos import parse_qos_tiers

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
                   help="only 'both' (colocated) is served yet (A6)")
    p.add_argument("--prefill-pool", default=None, help="refused (A6)")
    p.add_argument("--peer-pool", default=None, help="refused (A6)")
    p.add_argument("--fleet-prefix-cache", action="store_true",
                   help="refused (A6)")
    p.add_argument("--no-integrity-checks", action="store_true",
                   help="accepted; no KV wire in this server yet (A6)")
    p.add_argument("--drain-grace-s", type=float, default=None,
                   help="SIGTERM drain: max seconds to wait for in-flight "
                   "requests before exiting anyway (default 120)")
    p.add_argument("--qos-tiers", default=None,
                   help="multi-tenant QoS priority classes as JSON, or the "
                   "literal 'default'")
    p.add_argument("--qos-default-tier", default=None)
    p.add_argument("--enforce-eager", action="store_true",
                   help="accepted; eager PyTorch compiles no step programs")
    p.add_argument("--trust-remote-code", action="store_true",
                   help="accepted; local checkpoints never execute remote "
                   "code here")
    p.add_argument("--disable-custom-all-reduce", action="store_true",
                   help="accepted; one card has no all-reduce")
    p.add_argument("--distributed", action="store_true",
                   help="refused (A7)")
    args = p.parse_args(argv)

    _refuse_fleet(args.role, args.prefill_pool, args.peer_pool,
                  args.fleet_prefix_cache)
    sizes = (args.tensor_parallel_size, args.pipeline_parallel_size,
             args.sequence_parallel_size, args.expert_parallel_size)
    if args.distributed or any(s > 1 for s in sizes):
        raise ValueError(f"--distributed / parallel sizes {sizes}: "
                         f"{PARALLEL_TODO}")
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
        parallel=ParallelConfig(),
        resilience=(ResilienceConfig(drain_grace_s=args.drain_grace_s)
                    if args.drain_grace_s is not None
                    else ResilienceConfig()),
        max_model_len=args.max_model_len,
        enforce_eager=args.enforce_eager)
    params = None
    if args.weights:
        from ..engine.weights import load_weights
        params = load_weights(args.weights, config.model, device=device)
    draft_params = None
    if args.spec_draft_weights:
        from ..engine.weights import load_weights
        # Loaded in the TARGET's serving dtype, the dtype of the draft
        # runner's KV pool.
        draft_params = load_weights(
            args.spec_draft_weights,
            get_model_config(args.spec_draft_model).replace(
                dtype=model_cfg.dtype), device=device)
    server = build_server(config, args.tokenizer, args.model, params=params,
                          device=device, draft_params=draft_params)
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
    run_app(app, host=args.host, port=args.port)


if __name__ == "__main__":
    main()
