"""Request router: one front door over N data-parallel engine replicas.

The reference exposed its replicas behind ``vllm-router-service`` and
operators port-forwarded to it (``old_README.md:1174-1176, 1472-1476``);
replicas were plain Deployment pods spread by anti-affinity
(``values-01-minimal-example2.yaml:10, 23-49``). This router is the native
equivalent: a reverse proxy on the standard-library HTTP layer
(``serving/http.py``, server and client: the card's machine has no
aiohttp) that

- tracks replica health (probed immediately at startup, then periodic GET
  /health; unhealthy replicas leave the rotation and return on recovery —
  the k8s-native restart/rollout story of SURVEY §5.3 at the traffic layer),
- balances by one of two policies (``--routing-policy``):

  * ``least-inflight`` (default): least-outstanding-requests — better than
    round-robin under continuous batching (a replica stuck on long
    generations accumulates in-flight count and sheds new work), but it
    scatters a session's requests across replicas, destroying the engine-
    side prefix-cache hits that collapse warm TTFT;
  * ``prefix-affinity``: bounded-load consistent hashing (CHWBL) keyed on
    the request's prompt prefix — the first ``affinity_prefix_len`` tokens'
    bytes, or an explicit ``session_id``/``user`` field when the body
    carries one. The key hashes onto a replica ring with virtual nodes;
    the ring owner serves it unless admitting one more request would push
    it past ``ceil(balance_factor * (total_inflight + 1) / n_replicas)``,
    in which case the walk continues to the next under-bound replica — hot
    prefixes still spread, cold traffic never evicts a warm replica's
    cache. Unhealthy/benched/excluded replicas are skipped on the same
    walk, so membership churn remaps only the dead replica's keys
    (~K/N of K keys, the consistent-hashing contract) and every key's
    assignment is deterministic across router restarts (hashes come from
    :mod:`hashlib`, never the process-salted builtin ``hash``). When no
    affinity key can be derived (GET /v1/models, unparseable body) or
    every ring candidate is over-bound, the pick degrades to
    least-inflight over the same candidates — never a 5xx,

- streams responses through unbuffered (SSE passthrough),
- hardens every upstream call: per-attempt connect timeouts, a per-read
  stall timeout that circuit-breaks replicas whose in-flight streams hang,
  and bounded exponential-backoff retry of connect-phase failures (the only
  phase where nothing reached the upstream, so re-sending is safe),
- traces every request: the router mints ``x-kgct-request-id`` (honoring an
  inbound header), forwards it to the replica — whose api_server adopts it
  as the ENGINE request id, so the engine's lifecycle trace shares the id —
  and echoes it on every response, success or error. Its own span stream
  (pick with policy/owner attribution, connect retries, upstream TTFB,
  stream relay) lands in a request tracer mirrored into a black-box flight
  recorder; ``GET /debug/trace`` merges the router's spans with each
  healthy replica's ``/debug/trace`` (bounded per-replica fetches, same
  straggler discipline as the metrics scrape) into ONE Perfetto timeline
  with per-process tracks, and ``GET /debug/flightrecorder`` exposes the
  crash-capture ring.

Every pick path — first attempt, connect-phase retry-with-exclude, the
desperation rounds over benched replicas — flows through the single
``_pick`` seam (pinned by the KGCT011 lint rule), so both policies inherit
the circuit-breaking/retry machinery unchanged.

Chaos sites (resilience.faults): ``router_connect`` simulates a connect
failure on the picked replica, ``replica_hang`` a mid-stream read timeout,
``replica_down`` forces the health probe of replica index ``value`` to
fail (drain/death remap of ring-owned keys), ``replica_kill_midstream``
severs the upstream socket after N relayed chunks (mid-stream failover /
resume ladder).

Session survivability: on a migration-capable fleet (>1 replica) the
router names each SSE completion's drain-push target in
MIGRATE_URL_HEADER (the key's ring successor), parses the relay to keep
the replica-embedded token ledger (stripped before the client), and when
the upstream dies before ``[DONE]`` re-dispatches to ring successors via
``POST /internal/resume`` — parked-KV import where the dying replica
managed a push, token replay otherwise — splicing the resumed stream so
the client sees ONE uninterrupted response; bounded attempts end in a
clean truncated-stream error frame carrying the request id
(``kgct_failovers_total{outcome=}``, ``kgct_router_failover_seconds``).

In-cluster, replica discovery is the headless-Service DNS name; static URLs
work for local/dev. Deployment manifests are rendered by the
JAX package's ``deploy`` (router Deployment + kgct-router-service;
``prefix-affinity`` renders single-host models as StatefulSets so every
replica pod has a stable DNS name the ring can own).

The router does no tensor work: it needs no card and, without QoS tiers,
loads no ``torch`` (``config.qos`` is imported only when tiers are set).
Where this module differs from the JAX router it is in the transport:

- a client that leaves (the server sees end-of-file) cancels the handler;
  the ``finally`` blocks close the upstream connection, so the replica
  aborts its engine request, and release the in-flight slots, with no
  failure counted against the replica;
- the client opens one connection per request (aiohttp pools them);
- the CLI stops on SIGTERM as on SIGINT (``web.run_app`` does both).
"""

from __future__ import annotations

import asyncio
import contextlib
import bisect
import hashlib
import json
import math
import signal
import time
import uuid
from typing import Optional

from ..observability.flightrecorder import FlightRecorder
from ..observability.prometheus import Histogram
from ..observability.trace import RequestTracer, merge_perfetto
from ..resilience.faults import get_injector as _get_injector
from ..resilience.faults import inject as _inject_fault
from ..utils import get_logger
# The engine's shed/drain responses use the same envelope (serving.errors):
# a router-level 503 is handled by the identical client code path.
from .errors import (MIGRATE_URL_HEADER, PREFILL_URL_HEADER,
                     PREFIX_SOURCE_HEADER, QOS_TIER_HEADER,
                     REQUEST_ID_HEADER, RESUME_MODE_HEADER,
                     valid_request_id)
from .errors import overloaded_error as _proxy_error
from .fleet_cache import PeerScoreboard
from .http import (Application, ClientConnectorError, ClientError,
                   ClientPayloadError, ClientSession, Request, Response,
                   StreamResponse, json_response, run_app)

logger = get_logger("serving.router")

# Connect-PHASE failures: nothing reached the upstream, so failover/retry is
# provably safe. The client raises ClientConnectorError for a refused or
# unreachable peer and for an expired connect bound (the blackholed-node
# case, no RST ever comes back) — never for a read after the request went
# out; ConnectionRefusedError is what the router_connect chaos site raises.
CONNECT_PHASE_ERRORS: tuple = (ClientConnectorError, ConnectionRefusedError)

HOP_HEADERS = {"transfer-encoding", "content-length", "connection",
               "keep-alive", "host"}

# Virtual nodes per replica on the consistent-hash ring. 64 points keep the
# per-replica share of RAW key space within ~1.6x fair at small N (pinned by
# the balance property test) while the ring stays tiny (N*64 bisect points);
# the CHWBL load bound — not vnode count — is what bounds actual load skew.
RING_VNODES = 64

# Mid-stream failover: how many ring successors a broken SSE relay may be
# re-dispatched to (POST /internal/resume) before the client gets the
# truncated-stream error. Small on purpose — each attempt re-prefills in
# the worst (token-replay) case.
FAILOVER_ATTEMPTS = 2


class _SSERelay:
    """Incremental SSE frame parser for migration-capable stream relays.

    The replica embeds each frame's new token ids under ``kgct_token_ids``
    (opted in by the MIGRATE_URL_HEADER the router itself sets); this
    parser strips the field before the bytes reach the client and keeps
    the running token ledger — exactly what a mid-stream failover replays
    to a ring successor. Frames without the field pass through
    byte-identical; a partial frame at the moment of upstream death stays
    in the buffer and never reaches the client, so the ledger always
    matches the delivered text."""

    def __init__(self):
        self._buf = b""
        self.tokens: list[int] = []
        self.done = False          # saw the terminal [DONE] frame
        self.finished = False      # saw a finish_reason-stamped frame: the
                                   # completion is semantically complete
                                   # even if [DONE] never arrives
        self.frames = 0

    def reset_buffer(self) -> None:
        """Drop a dead upstream's partial frame before splicing a resumed
        stream in — stale bytes would corrupt the next upstream's framing.
        The token ledger survives: it covers only fully-relayed frames."""
        self._buf = b""

    def feed(self, chunk: bytes) -> bytes:
        self._buf += chunk
        out = []
        while b"\n\n" in self._buf:
            frame, self._buf = self._buf.split(b"\n\n", 1)
            out.append(self._render(frame))
        return b"".join(out)

    def _render(self, frame: bytes) -> bytes:
        data_lines = [l for l in frame.split(b"\n")
                      if l.startswith(b"data:")]
        payload = b"\n".join(l[5:].strip() for l in data_lines)
        if payload == b"[DONE]":
            self.done = True
            return frame + b"\n\n"
        try:
            obj = json.loads(payload)
        except ValueError:
            return frame + b"\n\n"
        self.frames += 1
        if isinstance(obj, dict):
            try:
                if obj["choices"][0].get("finish_reason"):
                    self.finished = True
            except (LookupError, AttributeError, TypeError):
                pass
        if isinstance(obj, dict) and "kgct_token_ids" in obj:
            toks = obj.pop("kgct_token_ids")
            if isinstance(toks, list):
                self.tokens.extend(int(t) for t in toks)
            return b"data: " + json.dumps(obj).encode() + b"\n\n"
        return frame + b"\n\n"


def _stable_hash(data: bytes) -> int:
    """Ring/key hash: process-stable and platform-stable. The builtin
    ``hash`` is salted per process (PYTHONHASHSEED), which would silently
    give every router restart a different ring — the exact nondeterminism
    the affinity contract forbids. blake2b is the fastest stdlib digest."""
    return int.from_bytes(hashlib.blake2b(data, digest_size=8).digest(),
                          "big")


class HashRing:
    """Consistent-hash ring over replica URLs with virtual nodes.

    Membership is fixed at construction (the rendered replica set); health
    churn is handled by the CALLER skipping dead entries while walking from
    the owner — equivalent to removing them from the ring (each dead
    replica's keys land on their ring successors; everyone else's keys do
    not move), without rebuild races. Identical URL lists produce identical
    rings in any process (see :func:`_stable_hash`)."""

    def __init__(self, urls: list[str], vnodes: int = RING_VNODES):
        points: list[tuple[int, str]] = []
        for url in urls:
            for v in range(vnodes):
                points.append((_stable_hash(f"{url}#{v}".encode()), url))
        points.sort()
        self._points = [p for p, _ in points]
        self._urls = [u for _, u in points]

    def owner(self, key: bytes) -> str:
        """The ring owner of ``key`` (ignores health — the metrics notion
        of 'where this key lives when everything is up')."""
        return self._urls[self._index(key)]

    def walk(self, key: bytes):
        """Yield member URLs in ring order starting at ``key``'s owner,
        each member once — the deterministic failover/overflow order."""
        start = self._index(key)
        seen: set[str] = set()
        n = len(self._urls)
        for i in range(n):
            url = self._urls[(start + i) % n]
            if url not in seen:
                seen.add(url)
                yield url

    def _index(self, key: bytes) -> int:
        i = bisect.bisect_right(self._points, _stable_hash(key))
        return i % len(self._points)


class Replica:
    def __init__(self, url: str):
        self.url = url.rstrip("/")
        self.healthy = True
        self.inflight = 0
        # Per-tier in-flight as the replica itself reports it on /health
        # (the QoS admission ledger), refreshed by every successful probe.
        # Router-attributed inflight above misses direct-to-pod and
        # other-router traffic; this is the replica's own ground truth,
        # and the tier-aware pick tie-break reads it.
        self.tier_inflight: dict = {}
        self.consecutive_failures = 0
        # Traffic-failure bench expiry: a replica broken by proxy failures
        # (connect/stall) may still answer /health 200 — its wedge detector
        # (engine watchdog) is much slower than the router's. Probe success
        # must not restore it before this cooldown, or traffic bounces
        # straight back onto the wedged replica.
        self.benched_until = 0.0


class Router:
    def __init__(self, replica_urls: list[str],
                 health_interval_s: float = 5.0,
                 fail_threshold: int = 2,
                 connect_timeout_s: float = 5.0,
                 stall_timeout_s: float = 60.0,
                 response_timeout_s: float = 300.0,
                 metrics_timeout_s: float = 2.0,
                 connect_retries: int = 2,
                 retry_backoff_s: float = 0.25,
                 bench_cooldown_s: float = 30.0,
                 routing_policy: str = "least-inflight",
                 affinity_prefix_len: int = 32,
                 balance_factor: float = 1.5,
                 ring_vnodes: int = RING_VNODES,
                 trace_timeout_s: float = 5.0,
                 prefill_urls: Optional[list[str]] = None,
                 failover_attempts: int = FAILOVER_ATTEMPTS,
                 qos_tiers: tuple = (),
                 qos_default_tier: Optional[str] = None):
        if routing_policy not in ("least-inflight", "prefix-affinity"):
            raise ValueError(f"unknown routing_policy {routing_policy!r} "
                             "(known: least-inflight, prefix-affinity)")
        if balance_factor < 1.0:
            # c < 1 would bound every replica below the fair share and the
            # walk could never place anything once traffic flows.
            raise ValueError(f"balance_factor {balance_factor} must be >= 1")
        self.replicas = [Replica(u) for u in replica_urls]
        self.routing_policy = routing_policy
        self.affinity_prefix_len = affinity_prefix_len
        self.balance_factor = balance_factor
        self.ring = HashRing([r.url for r in self.replicas],
                             vnodes=ring_vnodes)
        # Disaggregated prefill/decode: a second, phase-dedicated pool.
        # Completion requests are proxied to the MAIN pool (role "decode"
        # when this pool exists, "both" otherwise) with an
        # x-kgct-prefill-url header naming the prefill-pool replica picked
        # by PREFIX-affinity on its own ring — prefill replicas are keyed
        # by prompt prefix (cache locality), decode replicas by session.
        # The decode replica pulls the prefilled KV itself; the router
        # never carries KV bytes.
        self.prefill_replicas = [Replica(u) for u in (prefill_urls or [])]
        self.prefill_ring = (HashRing([r.url for r in self.prefill_replicas],
                                      vnodes=ring_vnodes)
                             if self.prefill_replicas else None)
        # Affinity accounting (rendered on /metrics): a pick is a "hit" when
        # the key landed on its ring owner, an "overflow" (labeled by the
        # owner that was over-bound) when the bounded-load walk moved past
        # it, and a "remap" when the owner was out of rotation entirely.
        self.affinity_requests_total = 0
        self.affinity_hits_total = 0
        self.ring_remaps_total = 0
        self.affinity_overflow_total: dict[str, int] = {
            r.url: 0 for r in self.replicas}
        self.health_interval_s = health_interval_s
        self.fail_threshold = fail_threshold
        self.connect_timeout_s = connect_timeout_s
        # Max seconds between CHUNKS once a response is streaming before the
        # replica is declared stalled (generous: an overloaded engine can
        # pause seconds between tokens; a wedged one goes silent forever).
        self.stall_timeout_s = stall_timeout_s
        # Max seconds to FIRST response bytes (headers). Deliberately much
        # larger than stall_timeout_s: a non-streaming completion sends
        # nothing until the whole generation finishes, and a slow-but-
        # correct generation must not 502 or count toward fail_threshold.
        self.response_timeout_s = response_timeout_s
        self.metrics_timeout_s = metrics_timeout_s
        # Connect-phase failures retry the whole replica set up to this many
        # extra rounds with exponential backoff — rides out the blip where
        # every replica is briefly restarting.
        self.connect_retries = connect_retries
        self.retry_backoff_s = retry_backoff_s
        self.bench_cooldown_s = bench_cooldown_s
        self.retries_total = 0
        self.scrape_errors_total = 0
        # Mid-stream failover accounting: outcome "import" (the successor
        # resumed from a parked migration push), "recompute" (token-replay
        # re-prefill), "failed" (every rung exhausted — the client got the
        # truncated-stream error). Pre-seeded so a fresh scrape renders
        # zeros, never absent series.
        self.failover_attempts = failover_attempts
        self.failovers_total: dict[str, int] = {
            "import": 0, "recompute": 0, "failed": 0}
        self.failover_latency = Histogram(
            "kgct_router_failover_seconds",
            "upstream death to resumed-stream first byte")
        # Fleet tracing: the router's own span stream (pick / connect_retry
        # / ttfb / relay per request id) mirrored into the black-box flight
        # recorder; /debug/trace merges it with replica traces. Bounded
        # per-replica trace fetches (trace_timeout_s) reuse the metrics-
        # scrape straggler discipline: skipped and counted, never hung on.
        self.flight = FlightRecorder()
        self.flight.set_snapshot_source(self._flight_snapshot)
        # enabled=None: the tracer resolves the KGCT_TRACE kill switch
        # itself (one definition, shared with the engine's Observability).
        self.tracer = RequestTracer(capacity=4096, recorder=self.flight)
        self.trace_timeout_s = trace_timeout_s
        self.trace_scrape_errors_total = 0
        # Classification of the LAST _pick (affinity hit/overflow/remap or
        # least-inflight fallback), read by proxy() for the "pick" span —
        # produced inside the seam so the span always matches the counters.
        self._pick_info: dict = {}
        # Tied-least-inflight tie-break: a plain counter starting at 0, so
        # the choice is a pure function of (config, pick sequence) — two
        # routers replaying the same request sequence pick identically, and
        # chaos replays reproduce (the old shared itertools.count iterator
        # had the same values but no seam to assert or reset around).
        self._pick_seq = 0
        # Multi-tenant QoS: the router resolves each request's tier with
        # the SAME order as the replica (config/qos.resolve_tier_name —
        # imported lazily so a tier-less router stays as light as before),
        # propagates the resolution upstream in QOS_TIER_HEADER, and keeps
        # a per-tier in-flight ledger for /health + /metrics (bounded
        # label set: configured tier names only).
        self.qos_tiers = tuple(qos_tiers or ())
        self.qos_default_tier = qos_default_tier
        self.tier_inflight: dict[str, int] = {
            t.name: 0 for t in self.qos_tiers}
        # Tier-aware interactive picks (ROADMAP 3c): priorities for the
        # batch-saturation tie-break in _pick — a higher-priority (more
        # interactive) request prefers, among equally-loaded candidates,
        # the replica whose /health ledger shows the LEAST lower-priority
        # in-flight work (its seats are cheapest to reclaim: the engine's
        # priority preemption evicts batch work, never peers).
        self._tier_priority = {t.name: t.priority for t in self.qos_tiers}
        self._resolve_tier_name = self._tenant_key_of = None
        if self.qos_tiers:
            from ..config.qos import resolve_tier_name, tenant_key_of
            self._resolve_tier_name = resolve_tier_name
            self._tenant_key_of = tenant_key_of
        # Peer reputation over the proxy walk (the router's own instance
        # of the KV wire plane's scoreboard): repeated traffic failures
        # decay a replica's score past the bench machinery's view; a
        # quarantined replica leaves _pick/_prefix_source/_ring_successor
        # until its window lapses, and the first healthy probe after the
        # window is the recovery probe. Quarantine entries render as
        # kgct_peer_quarantines_total{peer} — pre-seeded with every
        # configured replica so the label set is bounded and a fresh
        # scrape shows zeros.
        self.peer_scores = PeerScoreboard()
        for r in self.replicas + self.prefill_replicas:
            self.peer_scores.quarantines.setdefault(r.url, 0)
        self._session: Optional[ClientSession] = None
        self._health_task: Optional[asyncio.Task] = None

    # -- app wiring ----------------------------------------------------------

    def build_app(self) -> Application:
        app = Application()
        app.add_get("/health", self.health)
        app.add_get("/v1/models", self.proxy)
        app.add_post("/v1/completions", self.proxy)
        app.add_post("/v1/chat/completions", self.proxy)
        app.add_get("/metrics", self.metrics)
        app.add_get("/debug/trace", self.debug_trace)
        app.add_get("/debug/flightrecorder", self.debug_flightrecorder)
        app.on_startup.append(self._on_startup)
        app.on_cleanup.append(self._on_cleanup)
        return app

    async def _on_startup(self, app: Application) -> None:
        # No wall bound on the proxy and resume calls (timeout_s=None):
        # phase-specific deadlines are applied at the call sites
        # (response_timeout_s for headers, stall_timeout_s between stream
        # chunks) — a blanket bound would cut long streams and 502
        # legitimately slow non-streaming generations.
        self._session = ClientSession(
            connect_timeout_s=self.connect_timeout_s)
        # Cold-start probe: without it, a replica that is down RIGHT NOW
        # still receives traffic for up to fail_threshold x interval before
        # the periodic loop notices. One failed startup probe removes it
        # immediately; the loop restores it on recovery.
        await asyncio.gather(
            *(self._check(r, startup=True)
              for r in self.replicas + self.prefill_replicas),
            return_exceptions=True)
        self._health_task = asyncio.create_task(self._health_loop())

    async def _on_cleanup(self, app: Application) -> None:
        if self._health_task:
            self._health_task.cancel()
        if self._session:
            await self._session.close()

    # -- health --------------------------------------------------------------

    async def _health_loop(self) -> None:
        while True:
            await asyncio.sleep(self.health_interval_s)
            await asyncio.gather(
                *(self._check(r)
                  for r in self.replicas + self.prefill_replicas),
                return_exceptions=True)
            # Flight-recorder fleet snapshot (per-replica inflight/health)
            # rides the existing periodic loop — no extra timer.
            self.flight.maybe_snapshot()

    def _flight_snapshot(self) -> dict:
        """O(1) state reader for the flight recorder: the router's view of
        fleet load at this instant (attribute reads only)."""
        return {
            "inflight": {r.url: r.inflight for r, _ in self._pools()},
            "healthy": [r.url for r, _ in self._pools() if r.healthy],
            "retries_total": self.retries_total,
        }

    async def _check(self, replica: Replica, startup: bool = False) -> None:
        try:
            async with self._session.get(
                    f"{replica.url}/health", timeout_s=5) as resp:
                ok = resp.status == 200
                if ok and self.qos_tiers:
                    # Scrape the replica's own per-tier in-flight ledger
                    # off the SAME probe (no extra request): the
                    # tier-aware pick tie-break reads it. Best-effort — a
                    # replica without the field (older build / QoS off)
                    # just keeps an empty dict.
                    try:
                        body = await resp.json()
                        tiers = body.get("qos_tiers")
                        replica.tier_inflight = (
                            {str(k): int(v) for k, v in tiers.items()}
                            if isinstance(tiers, dict) else {})
                    except Exception:
                        pass
        except Exception:
            ok = False
        # Chaos site replica_down: force the probe of replica index
        # ``value`` to fail — the deterministic drain/death simulation the
        # ring-remap chaos test replays (requests owned by the downed
        # replica must move to its ring successor and move back on
        # recovery). The rule's fire budget (after/times/p) is consumed
        # ONLY by the targeted replica's probes: a plain fault_value() here
        # would let every OTHER replica's probe burn the budget first and
        # silently never down the intended one.
        injector = _get_injector()
        if injector is not None:
            rule = injector.rules.get("replica_down")
            if (rule is not None and replica in self.replicas
                    and self.replicas.index(replica) == int(rule.value)
                    and rule.should_fire()):
                logger.warning("KGCT_FAULT replica_down: probe of %s "
                               "forced down", replica.url)
                ok = False
        if ok:
            if time.monotonic() < replica.benched_until:
                # Benched by TRAFFIC failures: a 200 probe proves only that
                # /health answers, not that proxied streams stopped
                # stalling (the engine's own wedge detector is slower than
                # ours) — sit out the cooldown before trusting it again.
                return
            if not self.peer_scores.quarantined(replica.url):
                # Probe-based recovery: the first healthy probe AFTER a
                # lapsed quarantine window restores the replica's score
                # (inside the window this branch is unreachable for score
                # purposes — quarantined() still gates the pick walk).
                self.peer_scores.record_ok(replica.url)
            replica.consecutive_failures = 0
            if not replica.healthy:
                logger.info("replica %s back in rotation", replica.url)
            replica.healthy = True
        else:
            replica.consecutive_failures += 1
            # At startup a single failure is disqualifying (no traffic
            # history argues for the replica); in steady state the threshold
            # rides out transient blips.
            if (replica.healthy
                    and (startup or replica.consecutive_failures
                         >= self.fail_threshold)):
                logger.warning("replica %s marked unhealthy%s", replica.url,
                               " (startup probe)" if startup else "")
                replica.healthy = False

    def _pools(self) -> list[tuple[Replica, str]]:
        """Every replica the router owns, with its pool role: the main
        pool serves decode streams ("decode" when a prefill pool exists,
        the pre-disaggregation "both" otherwise), the prefill pool serves
        KV-handoff exports. One scrape separates the pools by the role
        label."""
        main_role = "decode" if self.prefill_replicas else "both"
        return ([(r, main_role) for r in self.replicas]
                + [(r, "prefill") for r in self.prefill_replicas])

    async def health(self, request: Request) -> Response:
        healthy = [r.url for r in self.replicas if r.healthy]
        status = 200 if healthy else 503
        body = {"status": "ok" if healthy else "no healthy replicas",
                "replicas": {r.url: {"healthy": r.healthy,
                                     "inflight": r.inflight,
                                     "role": role}
                             for r, role in self._pools()}}
        if self.qos_tiers:
            # Per-tier in-flight (fleet view): which tenant class is
            # loading the pool right now; absent when QoS is off.
            body["qos_tiers"] = dict(self.tier_inflight)
        return json_response(body, status=status)

    async def metrics(self, request: Request) -> Response:
        # Per-replica gauges carry the POOL role (prefill|decode|both) so
        # one scrape separates prefill-pool from decode-pool health under
        # disaggregated serving; a non-disaggregated fleet renders the
        # pre-existing "both" everywhere.
        pools = self._pools()
        lines = ["# TYPE kgct_router_replica_healthy gauge"]
        lines += [f'kgct_router_replica_healthy{{replica="{r.url}",'
                  f'role="{role}"}} {int(r.healthy)}' for r, role in pools]
        lines.append("# TYPE kgct_router_replica_inflight gauge")
        lines += [f'kgct_router_replica_inflight{{replica="{r.url}",'
                  f'role="{role}"}} {r.inflight}' for r, role in pools]
        if self.tier_inflight:
            # Multi-tenant QoS: per-tier in-flight through this router —
            # bounded label set (configured tier names), zeros from the
            # first scrape, absent entirely when QoS is off.
            lines.append("# TYPE kgct_router_tier_inflight gauge")
            lines += [f'kgct_router_tier_inflight{{tier="{n}"}} '
                      f"{self.tier_inflight[n]}"
                      for n in sorted(self.tier_inflight)]
        lines += ["# TYPE kgct_router_retries_total counter",
                  f"kgct_router_retries_total {self.retries_total}"]
        lines.append("# TYPE kgct_failovers_total counter")
        lines += [f'kgct_failovers_total{{outcome="{oc}"}} {n}'
                  for oc, n in sorted(self.failovers_total.items())]
        lines += self.failover_latency.render()
        # Routing-policy surface: which policy is live (info-style gauge)
        # plus the affinity accounting. All zeros-safe — a fresh scrape of a
        # least-inflight router renders every series with 0, never nan/absent
        # (dashboards need no existence check).
        reqs = self.affinity_requests_total
        lines += [
            "# TYPE kgct_router_policy gauge",
            f'kgct_router_policy{{policy="{self.routing_policy}"}} 1',
            "# TYPE kgct_router_affinity_requests_total counter",
            f"kgct_router_affinity_requests_total {reqs}",
            "# TYPE kgct_router_affinity_hits_total counter",
            f"kgct_router_affinity_hits_total {self.affinity_hits_total}",
            "# TYPE kgct_router_affinity_hit_ratio gauge",
            "kgct_router_affinity_hit_ratio "
            f"{self.affinity_hits_total / reqs if reqs else 0.0}",
            "# TYPE kgct_router_ring_remaps_total counter",
            f"kgct_router_ring_remaps_total {self.ring_remaps_total}",
            "# TYPE kgct_router_affinity_overflow_total counter",
        ]
        lines += [f'kgct_router_affinity_overflow_total{{replica="{r.url}"}} '
                  f"{self.affinity_overflow_total.get(r.url, 0)}"
                  for r in self.replicas]
        # Aggregate each healthy replica's engine metrics behind the single
        # front door (one scrape target for the whole DP group), labelled by
        # replica so series do not collide. Each per-replica fetch is bounded
        # (metrics_timeout_s): one stalled replica must not hang the whole
        # scrape — stragglers are skipped and counted instead.
        scraped = [r for r, _ in pools if r.healthy]
        fetched = await asyncio.gather(
            *(self._fetch_metrics(r) for r in scraped),
            return_exceptions=True)
        self.scrape_errors_total += sum(
            1 for res in fetched if isinstance(res, BaseException))
        lines += ["# TYPE kgct_router_metrics_scrape_errors_total counter",
                  "kgct_router_metrics_scrape_errors_total "
                  f"{self.scrape_errors_total}",
                  "# TYPE kgct_router_trace_scrape_errors_total counter",
                  "kgct_router_trace_scrape_errors_total "
                  f"{self.trace_scrape_errors_total}"]
        # Fleet locality readout: fold each replica's scraped prefix-cache
        # hit ratio and swapped-sequence count into router-OWNED labeled
        # gauges, so "is affinity concentrating locality" is one scrape of
        # one target. Zeros/absent-safe: every replica gets a sample — 0.0
        # when it is unhealthy, was skipped as a straggler, or its engine
        # predates the series — a fresh scrape is nan-free by construction.
        locality = {r.url: {"kgct_prefix_cache_hit_ratio": 0.0,
                            "kgct_num_swapped": 0.0}
                    for r, _ in pools}
        for replica, res in zip(scraped, fetched):
            if isinstance(res, BaseException):
                continue
            for family, is_type, line in res:
                if is_type or family not in ("kgct_prefix_cache_hit_ratio",
                                             "kgct_num_swapped"):
                    continue
                base = line.partition("{")[0]
                if base not in locality[replica.url]:
                    continue    # histogram-style child of another family
                try:
                    locality[replica.url][base] = float(line.rpartition(
                        " ")[2])
                except ValueError:
                    pass        # malformed upstream sample: keep the zero
        for name in ("kgct_prefix_cache_hit_ratio", "kgct_num_swapped"):
            lines.append(f"# TYPE kgct_router_replica_{name.removeprefix('kgct_')} gauge")
            lines += [
                f'kgct_router_replica_{name.removeprefix("kgct_")}'
                f'{{replica="{r.url}",role="{role}"}} '
                f'{locality[r.url][name]}'
                for r, role in pools]
        # Regroup by metric family: the text exposition format requires ONE
        # TYPE line per family with ALL its samples contiguous — appending
        # replicas' expositions sequentially interleaves families and strict
        # parsers (promtool/OpenMetrics) reject the whole scrape.
        families: dict[str, dict] = {}
        for res in fetched:
            if isinstance(res, BaseException):
                continue
            for family, is_type, line in res:
                fam = families.setdefault(family, {"type": None, "samples": []})
                if is_type:
                    if fam["type"] is None:
                        fam["type"] = line
                else:
                    fam["samples"].append(line)
        # Peer quarantine entries: the router's OWN scoreboard (label set
        # bounded to configured replicas, zeros from the first scrape)
        # shares a family name with each engine's replica-side board — one
        # TYPE line, all samples contiguous, scraped samples relabelled.
        scraped_quar = families.pop("kgct_peer_quarantines_total", None)
        lines.append("# TYPE kgct_peer_quarantines_total counter")
        lines += [f'kgct_peer_quarantines_total{{peer="{peer}"}} '
                  f"{self.peer_scores.quarantines[peer]}"
                  for peer in sorted(self.peer_scores.quarantines)]
        if scraped_quar is not None:
            lines.extend(scraped_quar["samples"])
        for fam in families.values():
            if fam["type"] is not None:
                lines.append(fam["type"])
            lines.extend(fam["samples"])
        return Response(text="\n".join(lines) + "\n",
                        content_type="text/plain")

    async def _fetch_metrics(self, replica: Replica):
        """Returns (family, is_type, line) triples with samples relabelled by
        replica. Family attribution follows the exposition's own ordering —
        a TYPE line opens a family and subsequent samples whose base name is
        the family (or family + ``_suffix``, the summary/histogram
        ``_sum``/``_count``/``_bucket`` children) belong to it."""
        async with self._session.get(
                f"{replica.url}/metrics",
                timeout_s=self.metrics_timeout_s) as resp:
            text = await resp.text()
        label = f'replica="{replica.url}"'
        out = []
        current = None
        for line in text.splitlines():
            if not line or line.startswith("#"):
                if line.startswith("# TYPE"):
                    parts = line.split()
                    current = parts[2] if len(parts) > 2 else line
                    out.append((current, True, line))
                continue
            name, _, rest = line.partition(" ")
            base = name.partition("{")[0]
            family = (current if current and
                      (base == current or base.startswith(current + "_"))
                      else base)
            if "{" in name:
                labels = name.partition("{")[2]
                out.append((family, False, f"{base}{{{label},{labels} {rest}"))
            else:
                out.append((family, False, f"{base}{{{label}}} {rest}"))
        return out

    # -- fleet tracing -------------------------------------------------------

    async def debug_trace(self, request: Request) -> Response:
        """ONE Perfetto timeline for the whole fleet: the router's own span
        stream (pid 1) merged with each healthy replica's ``/debug/trace``
        (one pid per replica), re-based onto a common clock via the
        ``kgctT0Unix`` anchors. A request that crossed router -> replica ->
        engine step phases renders as correlated spans across the process
        tracks, keyed by the router-minted request id. Each per-replica
        fetch is bounded (``trace_timeout_s``) — a stalled replica is
        skipped and counted in kgct_router_trace_scrape_errors_total, same
        discipline as the metrics scrape."""
        docs = [("kgct-router", self.tracer.export_perfetto())]
        scraped = [r for r, _ in self._pools() if r.healthy]
        fetched = await asyncio.gather(
            *(self._fetch_trace(r) for r in scraped),
            return_exceptions=True)
        for replica, res in zip(scraped, fetched):
            if isinstance(res, BaseException) or not isinstance(res, dict):
                self.trace_scrape_errors_total += 1
                continue
            docs.append((f"kgct-engine {replica.url}", res))
        return json_response(merge_perfetto(docs))

    async def _fetch_trace(self, replica: Replica) -> dict:
        async with self._session.get(
                f"{replica.url}/debug/trace",
                timeout_s=self.trace_timeout_s) as resp:
            return await resp.json()

    async def debug_flightrecorder(self, request: Request) -> Response:
        """The router's black-box ring: recent spans + periodic fleet
        snapshots (per-replica inflight/health)."""
        return json_response(self.flight.export())

    # -- proxying ------------------------------------------------------------

    def _pick(self, exclude: Optional[set] = None,
              include_unhealthy: bool = False,
              affinity_key: Optional[bytes] = None,
              pool: Optional[list] = None,
              ring: Optional[HashRing] = None,
              pick_tier: Optional[str] = None) -> Optional[Replica]:
        """The ONE replica-selection seam (every proxy attempt, including
        retry-with-exclude, desperation rounds, and the prefill-pool pick
        of disaggregated serving, calls here — KGCT011).

        ``pick_tier`` (the request's RESOLVED QoS tier) engages the
        tier-aware tie-break on the least-inflight fallback: for a pick of
        a non-lowest tier, candidates tied on total inflight are further
        narrowed to those whose /health-scraped ledger shows the least
        strictly-lower-priority in-flight work — a batch-saturated replica
        is deprioritized for interactive picks while equally-loaded
        interactive-only replicas keep the legacy rotation. Tier None (QoS
        off, or a lowest-tier pick) is byte-identical to the legacy
        tie-break.

        ``affinity_key`` engages the prefix-affinity policy: walk the ring
        from the key's owner, skipping out-of-rotation replicas, and take
        the first whose load stays inside the CHWBL bound
        ``ceil(balance_factor * (total_inflight + 1) / n_candidates)``.
        All-over-bound (a bound < 1 is impossible, so this means real
        saturation) falls through to least-inflight over the same
        candidates — the policy degrades, it never refuses.

        ``pool``/``ring`` select a phase-dedicated pool instead of the main
        one (the disaggregated PREFILL pool). A non-main pool walks its
        ring whenever a key exists REGARDLESS of the configured policy —
        prefill replicas are keyed by prompt prefix by construction — and
        its picks stay out of the affinity counters (which account the
        client-facing pool)."""
        main = pool is None
        replicas = self.replicas if pool is None else pool
        ring = self.ring if ring is None else ring
        healthy = [r for r in replicas
                   if (r.healthy or include_unhealthy)
                   and (include_unhealthy
                        or not self.peer_scores.quarantined(r.url))
                   and (not exclude or r.url not in exclude)]
        self._pick_info = {"policy": self.routing_policy, "pick": "none"}
        if not healthy:
            return None
        if (affinity_key is not None
                and (self.routing_policy == "prefix-affinity" or not main)):
            candidates = {r.url: r for r in healthy}
            bound = math.ceil(
                self.balance_factor
                * (sum(r.inflight for r in healthy) + 1) / len(healthy))
            owner_url = ring.owner(affinity_key)
            if main:
                self.affinity_requests_total += 1
                if owner_url not in candidates:
                    # Owner unhealthy/benched/excluded: its keys remap to
                    # ring successors until it returns (deterministic, and
                    # only ITS keys move).
                    self.ring_remaps_total += 1
            for url in ring.walk(affinity_key):
                replica = candidates.get(url)
                if replica is None:
                    continue
                if replica.inflight + 1 <= bound:
                    if url == owner_url:
                        if main:
                            self.affinity_hits_total += 1
                        self._pick_info["pick"] = "affinity_hit"
                    elif owner_url in candidates:
                        # Owner was available but over-bound: the hot-key
                        # spillover the balance factor exists to allow.
                        if main:
                            self.affinity_overflow_total[owner_url] = (
                                self.affinity_overflow_total.get(
                                    owner_url, 0) + 1)
                        self._pick_info["pick"] = "affinity_overflow"
                        self._pick_info["owner"] = owner_url
                    else:
                        self._pick_info["pick"] = "affinity_remap"
                        self._pick_info["owner"] = owner_url
                    return replica
            # Every candidate over-bound: saturation, not a routing failure.
        least = min(r.inflight for r in healthy)
        tied = [r for r in healthy if r.inflight == least]
        if pick_tier is not None and len(tied) > 1:
            tied = self._tier_tie_break(tied, pick_tier)
        seq = self._pick_seq
        self._pick_seq += 1
        self._pick_info["pick"] = "least_inflight"
        return tied[seq % len(tied)]

    def _tier_tie_break(self, tied: list, pick_tier: str) -> list:
        """Among total-inflight-tied candidates, keep those with the least
        strictly-lower-priority in-flight work (the replicas' own /health
        ledgers). Only engages for non-lowest-tier picks — a batch pick
        has no lower tier to avoid, and must keep the legacy rotation."""
        prio = self._tier_priority.get(pick_tier)
        if prio is None:
            return tied
        lower = [name for name, p in self._tier_priority.items()
                 if p < prio]
        if not lower:
            return tied
        load = {r.url: sum(int(r.tier_inflight.get(name, 0))
                           for name in lower) for r in tied}
        floor = min(load.values())
        kept = [r for r in tied if load[r.url] == floor]
        if len(kept) < len(tied):
            self._pick_info["tier_deprioritized"] = len(tied) - len(kept)
        return kept

    def _affinity_key(self, body: bytes, force: bool = False) -> Optional[bytes]:
        """Derive the routing key from an already-buffered request body —
        the proxy reads the full body before forwarding anyway (it may
        re-send it on connect-phase failover), so the peek adds no latency
        and never touches the response streaming path.

        Precedence: explicit stickiness (``session_id``, then OpenAI's
        ``user``) beats the prompt prefix — a session's later turns carry a
        GROWING prompt, and only the explicit id keeps them on the replica
        whose cache holds the earlier turns. Prompt prefix: the first
        ``affinity_prefix_len`` ids of a token-array prompt, or the first
        ``4 * affinity_prefix_len`` UTF-8 bytes of a text prompt / chat
        messages serialization (~4 bytes per token, so both spellings key
        on a comparable prefix window). None (no key derivable) routes
        least-inflight.

        ``force`` derives the key regardless of the configured policy —
        the disaggregated PREFILL pool is always prefix-keyed, even when
        the client-facing pool balances least-inflight."""
        if self.routing_policy != "prefix-affinity" and not force:
            return None
        return self._affinity_key_from_obj(self._parse_json_dict(body))

    @staticmethod
    def _parse_json_dict(body: bytes) -> Optional[dict]:
        """Parse an already-buffered request body into the JSON object
        every routing peek keys off — parsed ONCE per request in proxy()
        and shared, so a long-prompt body is never scanned twice on the
        single-threaded event loop. None for empty/unparseable/non-object
        bodies (the replica's fast 400 to give, not the router's)."""
        if not body:
            return None
        try:
            obj = json.loads(body)
        except (ValueError, UnicodeDecodeError):
            return None
        return obj if isinstance(obj, dict) else None

    def _affinity_key_from_obj(self, obj: Optional[dict]) -> Optional[bytes]:
        if obj is None:
            return None
        for field in ("session_id", "user"):
            val = obj.get(field)
            if isinstance(val, (str, int)) and not isinstance(val, bool) \
                    and val != "":
                return f"sticky:{field}:{val}".encode()
        text_window = 4 * self.affinity_prefix_len
        prompt = obj.get("prompt")
        if isinstance(prompt, str):
            return b"text:" + prompt.encode("utf-8")[:text_window]
        if isinstance(prompt, list) and prompt:
            if len(prompt) == 1 and isinstance(prompt[0], str):
                return b"text:" + prompt[0].encode("utf-8")[:text_window]
            if all(isinstance(t, int) for t in
                   prompt[:self.affinity_prefix_len]):
                ids = ",".join(str(t)
                               for t in prompt[:self.affinity_prefix_len])
                return f"tokens:{ids}".encode()
        messages = obj.get("messages")
        if isinstance(messages, list) and messages:
            try:
                ser = json.dumps(messages, sort_keys=True)
            except (TypeError, ValueError):
                return None
            return b"chat:" + ser.encode("utf-8")[:text_window]
        return None

    @staticmethod
    def _handoff_eligible(obj: Optional[dict]) -> bool:
        """Whether this request can consume a KV handoff on the decode
        side. ``n``/``best_of`` > 1 requests fan out through the replica's
        ``_run_n`` BEFORE its handoff block — no pull ever happens — so a
        prefill pick would hold a phantom pull slot for the request's
        whole lifetime and skew the prefill ring's bounded-load math.
        Anything not positively multi-sequence (including bodies
        ``_parse_json_dict`` rejected — the replica's fast 400 to give)
        stays eligible: same behavior as today, and a slot held across a
        400 is noise."""
        if obj is None:
            return True
        try:
            n = 1 if obj.get("n") is None else int(obj["n"])
            best_of = n if obj.get("best_of") is None else int(obj["best_of"])
        except (TypeError, ValueError):
            return True
        return n <= 1 and best_of <= 1

    async def proxy(self, request: Request) -> StreamResponse:
        """Reverse-proxy with failover.

        Only CONNECT-phase failures (replica down/unreachable) fail over to
        the next healthy replica — a request the upstream already received
        may be mid-generation there, and re-sending it would silently double
        device work under exactly the overload that causes resets. When
        every healthy replica fails the connect phase, the whole set is
        retried up to ``connect_retries`` more rounds with exponential
        backoff. Upstream errors after the body was delivered return 502;
        after streaming to the client started, the stream is terminated
        (truncation is the signal) and the stall/death circuit-breaks the
        replica. Client-side disconnects never count against the replica:
        the server cancels this handler, whose ``finally`` blocks close
        the upstream connection and release every in-flight slot.

        Correlation id: an inbound ``x-kgct-request-id`` is honored (header
        contract: bounded charset/length, else a fresh id is minted), sent
        upstream — the replica adopts it as its engine request id — and
        echoed on EVERY response including 429/502/503, so a failed request
        in a client log joins the router spans, the replica trace, and the
        JSON log records on one id."""
        body = await request.read()
        rid = valid_request_id(request.headers.get(REQUEST_ID_HEADER))
        if rid is None:
            rid = "req-" + uuid.uuid4().hex[:20]
        # Parse the body ONCE: the main-pool affinity key and both
        # prefill-pool peeks below share the object (configs needing
        # neither never parse at all).
        disagg_post = bool(self.prefill_replicas
                           and request.method == "POST"
                           and request.path.endswith("/completions"))
        # Session survivability needs the parsed body too (stream flag +
        # the resume re-dispatch payload) whenever the fleet has a peer a
        # stream could fail over to. The byte-level pre-filter keeps the
        # common non-streaming request off the json.loads hot path: only
        # streams fail over, and a body without the key cannot be one.
        survivable_post = bool(len(self.replicas) > 1
                               and request.method == "POST"
                               and request.path.endswith("/completions")
                               and b'"stream"' in body)
        # QoS tier resolution needs the tenant key (session_id/user) from
        # the body — same single parse as every other peek.
        qos_post = bool(self.qos_tiers
                        and request.method == "POST"
                        and request.path.endswith("/completions"))
        obj = self._parse_json_dict(body) \
            if (self.routing_policy == "prefix-affinity" or disagg_post
                or survivable_post or qos_post) \
            else None
        tier = qos_hdr = None
        if qos_post:
            tier, qos_hdr = self._qos_resolve(request, obj)
        akey = self._affinity_key_from_obj(obj) \
            if self.routing_policy == "prefix-affinity" else None
        self.tracer.emit("arrival", rid, path=request.path,
                         policy=self.routing_policy, bytes=len(body))
        # Disaggregated serving: pick the prefill-pool replica ONCE per
        # request (prefix-affinity on the prefill ring — always keyed,
        # whatever the main policy) and name it in the forwarded header;
        # the decode replica pulls the KV itself. No healthy prefill
        # replica -> no header -> the decode replica prefills locally.
        pr = None
        if disagg_post and self._handoff_eligible(obj):
            pkey = akey if self.routing_policy == "prefix-affinity" \
                else self._affinity_key_from_obj(obj)
            pr = self._pick(affinity_key=pkey, pool=self.prefill_replicas,
                            ring=self.prefill_ring)
            pf_info = dict(self._pick_info)
            if pr is not None:
                self.tracer.emit("pick", rid, replica=pr.url,
                                 pool="prefill", **pf_info)
        # Per-tier in-flight ledger (QoS): brackets the whole proxied
        # lifetime, streaming included — the fleet-level view of which
        # tenant class is loading the pool.
        if tier is not None:
            self.tier_inflight[tier] += 1
        try:
            if pr is None:
                return await self._forward(request, body, rid, akey, None,
                                           obj=obj, qos_hdr=qos_hdr,
                                           tier=tier)
            # The handoff pull slot is outstanding on this prefill replica
            # for the request's lifetime — without the count the prefill
            # pool's bounded-load overflow could never trigger (every
            # prefill Replica would read inflight 0 forever) and a hot
            # prefix would pin 100% of handoffs to one replica, each
            # holding a bounded pull slot, while the rest of the pool
            # idled. The request span over-estimates the pull window
            # (decode rides along), which only makes spillover MORE eager
            # under pile-up — the safe direction.
            pr.inflight += 1
            try:
                return await self._forward(request, body, rid, akey, pr.url,
                                           obj=obj, qos_hdr=qos_hdr,
                                           tier=tier)
            finally:
                pr.inflight -= 1
        finally:
            if tier is not None:
                self.tier_inflight[tier] -= 1

    def _qos_resolve(self, request: Request, obj: Optional[dict]
                     ) -> tuple[Optional[str], Optional[str]]:
        """(resolved tier, header value to forward) — the router-side half
        of the one resolution order (config/qos.resolve_tier_name): valid
        inbound header > tenant-key user pin > default. An INVALID inbound
        header resolves nothing and is forwarded untouched — the replica
        owns body/header validation and 400s loudly; the router must not
        silently re-class a typo'd tier."""
        tier, err = self._resolve_tier_name(
            self.qos_tiers, self.qos_default_tier,
            header=request.headers.get(QOS_TIER_HEADER),
            tenant_key=self._tenant_key_of(obj))
        if err is not None:
            return None, None
        return tier, tier

    def _prefix_source(self, pick_info: dict,
                       chosen_url: str) -> Optional[str]:
        """The PREFIX_SOURCE_HEADER value for a pick that missed its
        affinity owner, or None. Only a LIVE owner is worth naming: an
        over-bound owner (overflow) is healthy by construction; a
        remapped owner may merely be excluded by this request's retry
        walk — but one that is down or benched would cost the chosen
        replica a doomed connect before its pull degrades, worse than
        just recomputing."""
        if pick_info.get("pick") not in ("affinity_overflow",
                                         "affinity_remap"):
            return None
        owner_url = pick_info.get("owner")
        if not owner_url or owner_url == chosen_url:
            return None
        for r in self.replicas:
            if r.url == owner_url:
                if (r.healthy and time.monotonic() >= r.benched_until
                        and not self.peer_scores.quarantined(r.url)):
                    return owner_url
                return None
        return None

    def _ring_successor(self, key: bytes, exclude: set) -> Optional[str]:
        """First healthy main-pool replica on the ring walk from ``key``
        that is not in ``exclude`` — the deterministic migrate-push /
        failover target. The draining replica pushes a stream's KV to this
        URL (the router names it in MIGRATE_URL_HEADER at dispatch), and
        the failover re-dispatch walks the SAME ring, so the resume lands
        where the parked state lives."""
        byurl = {r.url: r for r in self.replicas}
        for url in self.ring.walk(key):
            replica = byurl.get(url)
            if replica is not None and replica.healthy \
                    and not self.peer_scores.quarantined(url) \
                    and url not in exclude:
                return url
        return None

    async def _forward(self, request: Request, body: bytes, rid: str,
                       akey: Optional[bytes],
                       prefill_hdr: Optional[str],
                       obj: Optional[dict] = None,
                       qos_hdr: Optional[str] = None,
                       tier: Optional[str] = None) -> StreamResponse:
        """The failover forwarding loop of :meth:`proxy`, split out so the
        prefill-slot accounting brackets it in one try/finally whatever
        path it returns through. ``obj`` (the parsed body) enables
        MID-STREAM failover for SSE completions: the relay parses frames
        (stripping the replica's kgct_token_ids ledger), and an upstream
        that dies before [DONE] is transparently re-dispatched to a ring
        successor via /internal/resume with the relayed tokens as forced
        context — the client sees one uninterrupted stream."""
        tried: set[str] = set()
        last_err: Optional[Exception] = None
        connect_failed = False
        rounds = 0
        # Failover key: the affinity key when one exists (the same walk
        # the pick used), else a request-id-derived key — deterministic
        # either way, so push target and failover target agree.
        mig_key = akey if akey is not None else f"failover:{rid}".encode()
        failover_ok = bool(len(self.replicas) > 1 and isinstance(obj, dict)
                           and obj.get("stream")
                           and request.method == "POST"
                           and request.path.endswith("/completions"))
        while True:
            # Retry rounds (rounds > 0) ignore the healthy flag: the connect
            # failures that triggered the retry are exactly what benched the
            # replicas (fail_threshold), and a retry restricted to healthy
            # ones would find nothing and give up — defeating its purpose of
            # riding out a restart blip. Nothing reached any upstream, so a
            # desperation probe of benched replicas is safe.
            replica = self._pick(exclude=tried,
                                 include_unhealthy=rounds > 0,
                                 affinity_key=akey, pick_tier=tier)
            # Consume the pick classification SYNCHRONOUSLY (no await may
            # sit between the _pick call and this copy): _pick overwrites
            # the shared attribute on its next call, and in an async server
            # a deferred read would attribute one request's affinity
            # hit/overflow/remap to another request's span.
            pick_info = dict(self._pick_info)
            if replica is None:
                # Every candidate this round failed at connect: nothing was
                # sent anywhere, so a bounded backed-off re-probe of the
                # full set is safe (replicas restart in seconds under k8s).
                if connect_failed and rounds < self.connect_retries and tried:
                    await asyncio.sleep(
                        self.retry_backoff_s * (2 ** rounds))
                    rounds += 1
                    tried.clear()
                    connect_failed = False
                    continue
                break
            tried.add(replica.url)
            self.tracer.emit("pick", rid, replica=replica.url,
                             attempt=len(tried), round=rounds, **pick_info)
            replica.inflight += 1
            try:
                try:
                    if _inject_fault("router_connect"):
                        raise ConnectionRefusedError(
                            "KGCT_FAULT router_connect")
                    stripped = {REQUEST_ID_HEADER, PREFILL_URL_HEADER,
                                MIGRATE_URL_HEADER, PREFIX_SOURCE_HEADER}
                    if qos_hdr is not None:
                        # Propagate the ROUTER-resolved tier: both layers
                        # then attribute this request identically (an
                        # unresolvable inbound header passes through for
                        # the replica's loud 400 instead).
                        stripped.add(QOS_TIER_HEADER)
                    fwd_headers = {
                        k: v for k, v in request.headers.items()
                        if k.lower() not in HOP_HEADERS
                        and k.lower() not in stripped}
                    # The replica adopts this as its engine request id, so
                    # its lifecycle trace correlates with the router spans.
                    fwd_headers[REQUEST_ID_HEADER] = rid
                    if qos_hdr is not None:
                        fwd_headers[QOS_TIER_HEADER] = qos_hdr
                    if prefill_hdr is not None:
                        # Router-owned (client values stripped above): the
                        # decode replica pulls prefilled KV from here.
                        fwd_headers[PREFILL_URL_HEADER] = prefill_hdr
                    psrc = self._prefix_source(pick_info, replica.url)
                    if psrc is not None:
                        # Fleet-wide prefix cache: the pick could not land
                        # on the affinity owner (over-bound or out of this
                        # round's rotation) — name the owner so the chosen
                        # replica can PULL its cached prefix instead of
                        # recomputing it (/internal/fetch_prefix; the
                        # replica's roofline gate prices the pull and any
                        # failure degrades to local recompute). Router-
                        # owned, like the prefill url: client values are
                        # stripped above.
                        fwd_headers[PREFIX_SOURCE_HEADER] = psrc
                    mig_url = None
                    if failover_ok:
                        # Name the drain-push target (ring successor of the
                        # serving replica): a SIGTERM on the upstream
                        # live-migrates this stream's KV there, and our own
                        # failover walk below re-dispatches to the same
                        # place. Header presence also opts the replica into
                        # embedding the per-frame token ledger.
                        mig_url = self._ring_successor(mig_key,
                                                       {replica.url})
                        if mig_url is not None:
                            fwd_headers[MIGRATE_URL_HEADER] = mig_url
                    t_attempt = time.monotonic()
                    upstream_cm = self._session.request(
                        request.method, f"{replica.url}{request.path_qs}",
                        data=body if body else None, headers=fwd_headers,
                        timeout_s=None)
                    # Headers deadline: a replica that accepted the request
                    # and then never responds at all is wedged — but the
                    # bound is the generous response_timeout_s, because a
                    # non-streaming completion legitimately sends nothing
                    # until the whole generation finishes.
                    upstream = await asyncio.wait_for(
                        upstream_cm.__aenter__(), self.response_timeout_s)
                    self.tracer.emit(
                        "ttfb", rid, replica=replica.url,
                        status=upstream.status,
                        ms=round((time.monotonic() - t_attempt) * 1e3, 2))
                except CONNECT_PHASE_ERRORS as e:
                    # TCP connect failed or timed out: nothing reached the
                    # upstream — safe to fail over.
                    last_err = e
                    connect_failed = True
                    self.retries_total += 1
                    self.tracer.emit("connect_retry", rid,
                                     replica=replica.url, error=str(e))
                    self._count_failure(replica, e, request_id=rid)
                    continue
                except (ClientError, asyncio.TimeoutError) as e:
                    # Request sent (at least partially) but no response —
                    # including a replica that accepted the body then went
                    # silent past stall_timeout_s: the upstream may already
                    # be processing it — do NOT re-send.
                    last_err = e
                    self._count_failure(replica, e, request_id=rid)
                    break
                relayed = 0
                try:
                    resp = StreamResponse(status=upstream.status)
                    for k, v in upstream.headers.items():
                        if k.lower() not in HOP_HEADERS:
                            resp.headers[k] = v
                    # Prefer the replica's echoed id (already copied above):
                    # its engine may have SUFFIXED a duplicate (rid+dup-N),
                    # and the header must name the id the engine trace and
                    # response body actually use. A non-kgct upstream that
                    # echoed nothing gets our mint.
                    if REQUEST_ID_HEADER not in resp.headers:
                        resp.headers[REQUEST_ID_HEADER] = rid
                    await resp.prepare(request)
                    # Parse-mode relay: a migration-capable SSE stream is
                    # framed so the token ledger can be kept (and stripped)
                    # and truncation-before-[DONE] detected; everything
                    # else relays raw chunks, byte-identical to before.
                    relay = None
                    if (mig_url is not None and upstream.status == 200
                            and upstream.headers.get(
                                "Content-Type", "").startswith(
                                "text/event-stream")):
                        relay = _SSERelay()
                    while True:
                        try:
                            if _inject_fault("replica_hang"):
                                raise asyncio.TimeoutError(
                                    "KGCT_FAULT replica_hang")
                            if relay is not None and _inject_fault(
                                    "replica_kill_midstream"):
                                # Chaos: the upstream socket is severed
                                # after N relayed chunks (rule param
                                # ``after``) — the deterministic
                                # mid-stream death the failover exists
                                # for.
                                raise ClientPayloadError(
                                    "KGCT_FAULT replica_kill_midstream: "
                                    "upstream socket severed")
                            # Per-chunk stall deadline: once streaming, a
                            # healthy engine emits tokens continuously —
                            # stall_timeout_s of silence means the replica
                            # hung mid-generation.
                            chunk = await asyncio.wait_for(
                                upstream.readany(), self.stall_timeout_s)
                        except (ClientError, asyncio.TimeoutError) as e:
                            # Upstream died or stalled mid-stream:
                            # circuit-break the replica. A migration-
                            # capable stream re-dispatches to a ring
                            # successor (the resume ladder); otherwise the
                            # committed client stream is terminated
                            # (truncation is the signal).
                            self._count_failure(replica, e, request_id=rid)
                            if relay is not None and not relay.done:
                                upstream.close()
                                await self._failover_midstream(
                                    request, resp, rid, obj, relay,
                                    mig_key, {replica.url}, err=e)
                                return resp
                            self.tracer.emit("abort", rid,
                                             reason="upstream_stall",
                                             error=str(e), bytes=relayed)
                            with contextlib.suppress(Exception):
                                await resp.write_eof()
                            return resp
                        if not chunk:
                            if relay is not None and not relay.done:
                                # EOF before [DONE]: a drain severed the
                                # relay after pushing the stream's KV (or
                                # the replica died cleanly) — same resume
                                # ladder as an errored read.
                                err = RuntimeError(
                                    "upstream stream ended before [DONE]")
                                self._count_failure(replica, err,
                                                    request_id=rid)
                                upstream.close()
                                await self._failover_midstream(
                                    request, resp, rid, obj, relay,
                                    mig_key, {replica.url}, err=err)
                                return resp
                            break
                        out = chunk if relay is None else relay.feed(chunk)
                        try:
                            if out:
                                await resp.write(out)
                                relayed += len(out)
                        except ConnectionError:
                            # CLIENT went away — not the replica's fault; no
                            # failure accounting.
                            self.tracer.emit("abort", rid,
                                             reason="client_disconnect",
                                             bytes=relayed)
                            return resp
                    await resp.write_eof()
                    self.tracer.emit("relay", rid, bytes=relayed)
                    self.tracer.emit("finish", rid, status=upstream.status,
                                     replica=replica.url)
                    return resp
                except asyncio.CancelledError:
                    # The CLIENT went away (the server cancels the handler
                    # when its connection closes): closing the upstream
                    # below makes the replica abort its engine request; no
                    # failure accounting.
                    self.tracer.emit("abort", rid,
                                     reason="client_disconnect",
                                     bytes=relayed)
                    raise
                finally:
                    await upstream_cm.__aexit__(None, None, None)
            finally:
                replica.inflight -= 1
        if last_err is not None:
            self.tracer.emit("abort", rid, reason="upstream_error",
                             error=str(last_err))
            logger.warning("proxy failed after %d replicas: %s", len(tried),
                           last_err, extra={"request_id": rid})
            resp = _proxy_error(502, f"upstream error: {last_err}",
                                retry_after_s=1)
            resp.headers[REQUEST_ID_HEADER] = rid
            return resp
        self.tracer.emit("abort", rid, reason="no_healthy_replicas")
        logger.warning("no healthy replicas for request",
                       extra={"request_id": rid})
        resp = _proxy_error(
            503, "no healthy replicas; retry shortly",
            retry_after_s=self._retry_after_s())
        resp.headers[REQUEST_ID_HEADER] = rid
        return resp

    def _retry_after_s(self) -> int:
        """Retry-After for a no-healthy 503: the soonest instant any
        replica can return to rotation — the minimum remaining
        bench/quarantine window across the pool — so a well-behaved
        client backs off exactly as long as the shed will last (the
        PR-2 admission-shed contract). Replicas that are merely
        probe-down fall back to the health interval."""
        now = time.monotonic()
        waits = []
        for r in self.replicas:
            wait = max(r.benched_until - now,
                       self.peer_scores.retry_after_s(r.url))
            # A merely probe-down replica (no active window) can return
            # on the next health tick.
            waits.append(wait if wait > 0 else self.health_interval_s)
        soonest = min(waits) if waits else self.health_interval_s
        return max(int(math.ceil(soonest)), 1)

    async def _failover_midstream(self, request: Request,
                                  resp: StreamResponse, rid: str,
                                  obj: dict, relay: _SSERelay,
                                  key: bytes, exclude: set,
                                  err: Optional[Exception] = None) -> bool:
        """Transparent mid-stream failover: re-dispatch a broken SSE relay
        to ring successors via ``POST /internal/resume`` (original body +
        the relayed-token ledger) and splice the resumed stream onto the
        already-committed client response. Bounded attempts; every rung
        exhausted ends the stream with a CLEAN truncated-stream error
        frame carrying the request id — degraded, attributed, never a
        hang. Returns True when the client-visible stream completed."""
        t0 = time.monotonic()
        exclude = set(exclude)
        if relay.finished:
            # The upstream died in the gap between its final
            # finish_reason-stamped frame and the [DONE] trailer: the
            # client already holds a complete completion — close it
            # cleanly instead of re-dispatching (every resume would 400
            # with nothing left to generate) and appending a spurious
            # truncation error to a finished stream.
            self.tracer.emit("failover", rid, outcome="already_complete",
                             tokens=len(relay.tokens))
            with contextlib.suppress(Exception):
                await resp.write(b"data: [DONE]\n\n")
                await resp.write_eof()
            return True
        kind = ("chat.completion" if "chat" in request.path
                else "completion")
        self.tracer.emit("failover", rid, error=str(err)[:200] if err
                         else "", relayed_tokens=len(relay.tokens))
        attempts = 0
        while attempts < self.failover_attempts:
            target_url = self._ring_successor(key, exclude)
            if target_url is None:
                break
            attempts += 1
            exclude.add(target_url)
            target = next(r for r in self.replicas if r.url == target_url)
            headers = {REQUEST_ID_HEADER: rid}
            if self.qos_tiers:
                # A header-classed stream keeps its QoS class across the
                # failover hop (the resume handler can only re-derive the
                # user-pin/default rungs from the replayed body).
                _, qos_hdr = self._qos_resolve(request, obj)
                if qos_hdr is not None:
                    headers[QOS_TIER_HEADER] = qos_hdr
            nxt = self._ring_successor(key, exclude)
            if nxt is not None:
                # The resumed stream is itself survivable: name ITS
                # drain-push target so a second drain walks on.
                headers[MIGRATE_URL_HEADER] = nxt
            payload = {"body": obj, "kind": kind,
                       "relayed_token_ids": list(relay.tokens)}
            relay.reset_buffer()
            target.inflight += 1
            try:
                resume_cm = self._session.post(
                    f"{target_url}/internal/resume", json=payload,
                    headers=headers, timeout_s=None)
                upstream = await asyncio.wait_for(
                    resume_cm.__aenter__(), self.response_timeout_s)
                try:
                    if upstream.status != 200:
                        snippet = (await upstream.read(2048)
                                   ).decode("utf-8", errors="replace")
                        if (upstream.status == 400
                                and "nothing to resume" in snippet):
                            # The successor's engine confirms the replayed
                            # history already satisfies a stop condition
                            # (a finish the relay could not see): the
                            # stream is complete, not failed.
                            self.tracer.emit("failover", rid,
                                             replica=target_url,
                                             outcome="already_complete",
                                             tokens=len(relay.tokens))
                            with contextlib.suppress(Exception):
                                await resp.write(b"data: [DONE]\n\n")
                                await resp.write_eof()
                            return True
                        self.tracer.emit(
                            "failover", rid, replica=target_url,
                            attempt=attempts,
                            error=f"resume {upstream.status}: "
                                  f"{snippet[:120]}")
                        continue
                    mode = upstream.headers.get(RESUME_MODE_HEADER,
                                                "recompute")
                    self.failover_latency.observe(time.monotonic() - t0)
                    while True:
                        try:
                            chunk = await asyncio.wait_for(
                                upstream.readany(), self.stall_timeout_s)
                        except (ClientError, asyncio.TimeoutError) as e2:
                            # The successor died too: walk on.
                            self._count_failure(target, e2,
                                                request_id=rid)
                            self.tracer.emit("failover", rid,
                                             replica=target_url,
                                             attempt=attempts,
                                             error=str(e2)[:200])
                            relay.reset_buffer()
                            break
                        if not chunk:
                            break
                        out = relay.feed(chunk)
                        try:
                            if out:
                                await resp.write(out)
                        except ConnectionError:
                            self.tracer.emit("abort", rid,
                                             reason="client_disconnect")
                            return True     # client gone; stop here
                    if relay.done:
                        outcome = ("import" if mode == "import"
                                   else "recompute")
                        self.failovers_total[outcome] = (
                            self.failovers_total.get(outcome, 0) + 1)
                        self.tracer.emit("failover", rid,
                                         replica=target_url,
                                         attempt=attempts, outcome=outcome,
                                         tokens=len(relay.tokens))
                        self.flight.dump("midstream_failover",
                                         request_id=rid, outcome=outcome,
                                         replica=target_url,
                                         attempts=attempts)
                        with contextlib.suppress(Exception):
                            await resp.write_eof()
                        return True
                finally:
                    with contextlib.suppress(Exception):
                        await resume_cm.__aexit__(None, None, None)
            except (ClientError, asyncio.TimeoutError) as e2:
                self._count_failure(target, e2, request_id=rid)
                self.tracer.emit("failover", rid, replica=target_url,
                                 attempt=attempts, error=str(e2)[:200])
                continue
            finally:
                target.inflight -= 1
        # Resume impossible: close the ladder LOUDLY — an explicit error
        # frame with the request id, then a clean stream end (a silent
        # truncation would read as a finished completion).
        self.failovers_total["failed"] = (
            self.failovers_total.get("failed", 0) + 1)
        self.tracer.emit("failover", rid, outcome="failed",
                         attempts=attempts, tokens=len(relay.tokens))
        self.flight.dump("midstream_failover", request_id=rid,
                         outcome="failed", attempts=attempts)
        logger.warning("mid-stream failover failed after %d attempt(s); "
                       "truncating the stream", attempts,
                       extra={"request_id": rid})
        err_body = {"error": {
            "message": ("stream truncated: the serving replica died "
                        "mid-stream and resume failed after "
                        f"{attempts} attempt(s)"),
            "type": "upstream_error", "code": 502, "request_id": rid}}
        with contextlib.suppress(Exception):
            await resp.write(b"data: " + json.dumps(err_body).encode()
                             + b"\n\n")
            await resp.write(b"data: [DONE]\n\n")
            await resp.write_eof()
        return False

    def _count_failure(self, replica: Replica, err: Exception,
                       request_id: str = "") -> None:
        replica.consecutive_failures += 1
        if self.peer_scores.record_timeout(replica.url):
            # Quarantine ENTRY (repeat offender): counted once per window
            # and black-boxed — the replica leaves the pick walk until
            # the window lapses and a healthy probe recovers it.
            logger.warning("replica %s quarantined for >= %.0fs "
                           "(repeated failures: %s)", replica.url,
                           self.peer_scores.quarantine_s, err,
                           extra=({"request_id": request_id}
                                  if request_id else None))
            self.flight.dump("peer_quarantine", peer=replica.url,
                             request_id=request_id, error=str(err)[:200])
        if replica.consecutive_failures >= self.fail_threshold:
            replica.healthy = False
            replica.benched_until = time.monotonic() + self.bench_cooldown_s
            logger.warning("replica %s marked unhealthy for >= %.0fs (%s)",
                           replica.url, self.bench_cooldown_s, err,
                           extra=({"request_id": request_id}
                                  if request_id else None))




def main(argv: Optional[list[str]] = None) -> None:
    """CLI: python -m kubernetes_gpu_cluster_tpu_torch.serving.router
    --replicas http://pod-0:8000,http://pod-1:8000 --port 8080

    Serves until SIGINT or SIGTERM (a pod's termination), then closes the
    listener and its health loop."""
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--replicas", required=True,
                   help="comma-separated replica base URLs (the client-"
                   "facing pool: role 'both', or 'decode' when "
                   "--prefill-replicas names a prefill pool)")
    p.add_argument("--prefill-replicas", default=None,
                   help="disaggregated prefill/decode: comma-separated "
                   "base URLs of the PREFILL pool (replicas started with "
                   "--role prefill). Completions are proxied to the main "
                   "pool with an x-kgct-prefill-url header naming the "
                   "prefix-affine prefill replica to pull KV from; absent "
                   "or unhealthy prefill replicas degrade to colocated "
                   "local prefill")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--routing-policy", default="least-inflight",
                   choices=["least-inflight", "prefix-affinity"],
                   help="least-inflight: fewest outstanding requests wins "
                   "(the pre-affinity behavior, default). prefix-affinity: "
                   "bounded-load consistent hashing on the prompt prefix / "
                   "session_id so repeat traffic lands on the replica whose "
                   "prefix cache is warm")
    p.add_argument("--affinity-prefix-len", type=int, default=32,
                   help="prefix-affinity: tokens of prompt prefix hashed "
                   "into the routing key (token-array prompts use this many "
                   "ids; text prompts use 4x this many UTF-8 bytes)")
    p.add_argument("--balance-factor", type=float, default=1.5,
                   help="prefix-affinity: CHWBL load bound — a ring owner "
                   "above ceil(factor * mean inflight) spills the request "
                   "to its ring successor (1.0 = strict fair share; larger "
                   "= stickier)")
    p.add_argument("--qos-tiers", default=None,
                   help="multi-tenant QoS tier config (same JSON as the "
                   "engine's --qos-tiers, or 'default'): the router "
                   "resolves each request's tier (header > session_id/"
                   "user pin > default), propagates it upstream in "
                   "x-kgct-qos-tier, and exposes per-tier inflight on "
                   "/health and /metrics. Unset = tier-less routing, "
                   "byte-identical to before")
    p.add_argument("--qos-default-tier", default=None,
                   help="tier applied to requests that name none; "
                   "default: the first configured tier")
    args = p.parse_args(argv)
    qos_tiers: tuple = ()
    if args.qos_tiers:
        # Lazy import: a tier-less router never loads the config package.
        from ..config.qos import parse_qos_tiers
        try:
            qos_tiers = parse_qos_tiers(args.qos_tiers)
        except ValueError as e:
            p.error(str(e))
        if (args.qos_default_tier is not None
                and args.qos_default_tier not in {t.name
                                                  for t in qos_tiers}):
            p.error(f"--qos-default-tier {args.qos_default_tier!r} is not "
                    "a configured tier")
    elif args.qos_default_tier is not None:
        p.error("--qos-default-tier requires --qos-tiers")
    router = Router(args.replicas.split(","),
                    routing_policy=args.routing_policy,
                    affinity_prefix_len=args.affinity_prefix_len,
                    balance_factor=args.balance_factor,
                    prefill_urls=(args.prefill_replicas.split(",")
                                  if args.prefill_replicas else None),
                    qos_tiers=qos_tiers,
                    qos_default_tier=args.qos_default_tier)
    run_app(router.build_app(), host=args.host, port=args.port,
            signals=(signal.SIGINT, signal.SIGTERM))


if __name__ == "__main__":
    main()
