"""Multi-rank serving: step-directive replication from rank 0.

The JAX package's ``serving/multihost.py`` over the port's engine. Under
tensor, expert, pipeline or sequence parallelism every rank (one process
per card, joined by ``torch.distributed``, ``parallel/mesh.py``) must run
the SAME engine-step sequence — each step's forward enters all-reduces,
stage-to-stage sends or ring hops, and a rank that steps alone hangs the
process group. The leader's directives go to every other rank of the
world, every stage's and every sp rank's alike. But only rank 0 receives client traffic
(the Service pins to pod-index 0 on a multi-node deployment; on one node
rank 0 is the container's server). The reference solved this with Ray:
vLLM's rank 0 shipped work to its workers (old_README.md:1615-1625). Here:

- The engine's host-side scheduler is DETERMINISTIC given the sequence of
  (admissions, aborts) applied at each step boundary, so lockstep needs
  only that event stream — not tensors, not tokens.
- Rank 0 (leader) broadcasts one DIRECTIVE per worker-loop iteration —
  ``{"adds": [(rid, token_ids, sampling_params)], "aborts": [rid]}`` as one
  NDJSON line over a persistent TCP connection to every follower — BEFORE
  taking its own step, then steps; device collectives do the actual
  synchronization (a lagging follower simply makes the leader's collective
  wait).
- Followers (rank > 0) run no HTTP server: they accept the leader's
  connection, and for each directive apply the events and take exactly one
  engine step. Same config + same seed => identical scheduling, identical
  step programs, lockstep collectives.

Failure model: a dead follower breaks the process group anyway
(collectives hang until the group's timeout), so directive-connection
errors trigger a CLEAN
group abort — every queued/running request is aborted and its pages
released before the rank exits or detaches — and the StatefulSet restarts
the group, matching the reference's reset-first recovery story (SURVEY
§5.3). Liveness is symmetric:

- leader -> follower HEARTBEATS (``{"hb": 1}`` lines on the directive
  channel, resilience-config cadence) keep an idle group's followers able
  to distinguish "no work" from "dead leader";
- a follower whose channel is silent past ``liveness_timeout_s`` declares
  the leader dead, group-aborts, and flips its health endpoint
  (``LoopLiveness``) so kubelet restarts the rank;
- a leader whose heartbeat send fails surfaces the error on the next
  ``broadcast`` — the serving loop group-aborts there.

A stop directive that finds requests still in flight on a follower (the
leader detached after a failed broadcast) group-aborts them and flips the
health endpoint like a closed channel; an idle follower stops cleanly.

Chaos site (resilience.faults): ``broadcast_fail`` makes the next leader
broadcast raise, exercising the whole group-abort path without killing a
real rank.
"""

from __future__ import annotations

import dataclasses
import json
import socket
import threading
import time
from typing import Optional

from ..engine import LLMEngine, SamplingParams
from ..resilience.faults import inject as _inject_fault
from ..resilience.heartbeat import LoopLiveness
from ..utils import get_logger

logger = get_logger("serving.multihost")

# Directive channel port (the process-group coordinator uses 8476; the
# deploy renderer exposes both on the headless Service).
CONTROL_PORT = 8477


def _encode(adds, aborts, stop=False, hb=False) -> bytes:
    if hb:
        return b'{"hb": 1}\n'
    payload = {
        "adds": [(rid, ids, dataclasses.asdict(params))
                 for rid, ids, params in adds],
        "aborts": list(aborts),
    }
    if stop:
        payload["stop"] = True
    return (json.dumps(payload) + "\n").encode()


class DirectiveLeader:
    """Rank 0's side: persistent connections to every follower, one
    broadcast per engine-loop iteration. Connections are made lazily with
    retries — followers bind their listener during process startup, which
    may complete after the leader's first request arrives. Once connected, a
    daemon thread heartbeats the channel so idle followers can tell a quiet
    leader from a dead one; a heartbeat send failure is surfaced on the next
    ``broadcast`` (the serving loop's group-abort path)."""

    def __init__(self, addrs: list[str], connect_timeout_s: float = 60.0,
                 heartbeat_interval_s: float = 2.0):
        self.addrs = addrs
        self.timeout = connect_timeout_s
        self.heartbeat_interval_s = heartbeat_interval_s
        self._socks: Optional[list[socket.socket]] = None
        # One lock over all sends: broadcast (engine worker thread) and
        # heartbeats (hb thread) must never interleave partial NDJSON frames.
        self._lock = threading.Lock()
        self._hb_thread: Optional[threading.Thread] = None
        self._hb_stop = threading.Event()
        self._hb_error: Optional[Exception] = None

    def _connect(self) -> list[socket.socket]:
        socks = []
        for addr in self.addrs:
            host, _, port = addr.rpartition(":")
            deadline = time.monotonic() + self.timeout
            while True:
                try:
                    s = socket.create_connection((host, int(port)), timeout=5)
                    s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                    socks.append(s)
                    logger.info("directive channel up: %s", addr)
                    break
                except OSError as e:
                    if time.monotonic() > deadline:
                        raise RuntimeError(
                            f"follower {addr} unreachable: {e}") from e
                    time.sleep(0.5)
        return socks

    def _heartbeat_loop(self) -> None:
        line = _encode([], [], hb=True)
        while not self._hb_stop.wait(self.heartbeat_interval_s):
            with self._lock:
                if self._socks is None:
                    continue
                try:
                    for s in self._socks:
                        s.sendall(line)
                except OSError as e:
                    # Remember and keep quiet: the next broadcast raises it
                    # on the serving thread, which owns group-abort.
                    self._hb_error = e
                    logger.warning("heartbeat send failed (follower dead?): "
                                   "%s", e)

    def broadcast(self, adds, aborts) -> None:
        if _inject_fault("broadcast_fail"):
            raise ConnectionError("KGCT_FAULT broadcast_fail")
        if self._hb_error is not None:
            err, self._hb_error = self._hb_error, None
            raise ConnectionError(
                f"directive channel lost (heartbeat): {err}") from err
        with self._lock:
            if self._socks is None:
                self._socks = self._connect()
            line = _encode(adds, aborts)
            for s in self._socks:
                s.sendall(line)
        if (self._hb_thread is None and self.heartbeat_interval_s > 0):
            self._hb_thread = threading.Thread(
                target=self._heartbeat_loop, daemon=True,
                name="kgct-directive-heartbeat")
            self._hb_thread.start()

    def close(self) -> None:
        self._hb_stop.set()
        with self._lock:
            if self._socks is None:
                return
            for s in self._socks:
                try:
                    s.sendall(_encode([], [], stop=True))
                    s.close()
                except OSError:
                    pass
            self._socks = None


class DirectiveFollower:
    """Rank > 0's side: apply each directive and take exactly one step when
    the leader does. Bind early (before ``init_process_group`` blocks on
    the rendezvous) so the leader's lazy connect finds the listener."""

    def __init__(self, port: int = CONTROL_PORT, host: str = "0.0.0.0"):
        self._srv = socket.create_server((host, port))

    @property
    def port(self) -> int:
        return self._srv.getsockname()[1]

    def run(self, engine: LLMEngine,
            liveness: Optional[LoopLiveness] = None,
            liveness_timeout_s: Optional[float] = None) -> None:
        conn, peer = self._srv.accept()
        logger.info("leader connected from %s", peer)
        # The silence deadline is armed only after the FIRST line arrives:
        # the leader connects followers serially (up to connect_timeout_s
        # EACH) and broadcasts only once every rank is up, so an early-
        # accepted follower may legitimately hear nothing for minutes during
        # staggered startup. Once directives/heartbeats flow, silence past
        # liveness_timeout_s declares the leader dead — without that, a
        # crashed rank 0 leaves the follower in recv() forever with
        # in-flight pages held.
        first_line_seen = False
        buf = b""
        with conn:
            while True:
                while b"\n" not in buf:
                    try:
                        data = conn.recv(1 << 16)
                    except socket.timeout:
                        logger.error(
                            "leader silent for %.1fs (no directives or "
                            "heartbeats): declaring leader dead, "
                            "group-aborting", liveness_timeout_s)
                        n = group_abort(engine)
                        if liveness is not None:
                            liveness.mark_dead(
                                "leader heartbeat lost; "
                                f"{n} requests group-aborted")
                        return
                    if not data:
                        logger.warning("leader connection closed; "
                                       "group-aborting and exiting")
                        n = group_abort(engine)
                        if liveness is not None and n:
                            liveness.mark_dead(
                                f"leader gone mid-flight; {n} requests "
                                "group-aborted")
                        return
                    buf += data
                line, _, buf = buf.partition(b"\n")
                if not first_line_seen:
                    first_line_seen = True
                    if liveness_timeout_s:
                        conn.settimeout(liveness_timeout_s)
                d = json.loads(line)
                if liveness is not None:
                    liveness.beat()
                if d.get("hb"):
                    continue    # liveness only; no step mirrors no work
                if d.get("stop"):
                    if engine.has_unfinished_requests():
                        logger.warning("stop directive with work in "
                                       "flight; group-aborting")
                        n = group_abort(engine)
                        if liveness is not None and n:
                            liveness.mark_dead(
                                f"leader stopped mid-flight; {n} requests "
                                "group-aborted")
                        return
                    logger.info("stop directive; follower exiting")
                    return
                for rid in d["aborts"]:
                    engine.abort_request(rid)
                for rid, ids, params in d["adds"]:
                    try:
                        engine.add_request(rid, ids,
                                           SamplingParams(**params))
                    except ValueError as e:
                        # The leader rejected the same request the same way
                        # (identical config) and did not schedule it.
                        logger.info("request %s rejected in lockstep: %s",
                                    rid, e)
                # Mirror the leader loop exactly: one step iff there is work.
                if engine.has_unfinished_requests():
                    engine.step()
                    if liveness is not None:
                        # A completed step is proof of life — the beat on
                        # line receipt is stale after a long first step
                        # (kernel builds, a long prefill).
                        liveness.beat()


def group_abort(engine: LLMEngine) -> int:
    """Cleanly abort every queued/running request on this rank and drain the
    in-flight window so its deferred page releases happen — the rank exits
    (or detaches) with no leaked device state, and waiters see explicit
    aborts instead of a silent hang. Returns the number of aborted
    requests."""
    # Swapped sequences included: left behind they would be restored by the
    # drain loop's schedule calls and keep generating on a dead group.
    # getattr: follower protocol tests drive this with duck-typed engines
    # that predate the two-tier cache.
    seqs = (list(engine.scheduler.waiting) + list(engine.scheduler.running)
            + list(getattr(engine.scheduler, "swapped", ())))
    # Black-box dump BEFORE the abort flood: the flight recorder's ring
    # still holds the directives/steps that led to the group failure, and
    # the rank is about to exit or restart. getattr keeps duck-typed test
    # engines working.
    obs = getattr(engine, "obs", None)
    flight = getattr(obs, "flight", None)
    if flight is not None:
        flight.dump("group_abort", requests=len(seqs))
    for seq in seqs:
        try:
            engine.abort_request(seq.request_id)
        except Exception:
            logger.exception("group-abort: abort_request(%s) failed",
                             seq.request_id)
    # Everything is aborted, so remaining steps only drain the speculative
    # in-flight window (deferred KV page releases), no new device work.
    try:
        while engine.has_unfinished_requests():
            engine.step()
    except Exception:
        logger.exception("group-abort: drain step failed (pages may leak "
                         "until restart)")
    if seqs:
        logger.warning("group-aborted %d in-flight requests", len(seqs))
    return len(seqs)


def serve_follower_health(port: int, host: str = "0.0.0.0",
                          liveness: Optional[LoopLiveness] = None):
    """Minimal /health endpoint on the engine port for rank > 0 pods: the
    StatefulSet's pod template (shared by all ranks) carries httpGet
    readiness/liveness probes, and a follower with no listener would be
    killed by kubelet ~3 min after start, crash-looping the whole process
    group. Runs on a daemon thread; everything but /health is 404.

    With ``liveness``, the 200 is TIED TO ACTUAL LOOP LIVENESS (beaten by
    directives/heartbeats in ``DirectiveFollower.run``): a dead or silent
    loop turns the probe 503 so kubelet restarts the rank instead of keeping
    a zombie alive. Returns the HTTP server (tests read its bound port)."""
    import http.server
    import threading

    class Health(http.server.BaseHTTPRequestHandler):
        def do_GET(self):  # noqa: N802 (stdlib naming)
            if self.path != "/health":
                self.send_response(404)
                self.send_header("Content-Type", "application/json")
                self.end_headers()
                self.wfile.write(b"{}")
                return
            alive = liveness.alive() if liveness is not None else True
            self.send_response(200 if alive else 503)
            self.send_header("Content-Type", "application/json")
            self.end_headers()
            if alive:
                self.wfile.write(b'{"status": "follower"}')
            else:
                reason = liveness.reason.replace('"', "'")
                self.wfile.write(
                    json.dumps({"status": "follower loop dead",
                                "reason": reason}).encode())

        def log_message(self, *a):  # quiet
            pass

    srv = http.server.ThreadingHTTPServer((host, port), Health)
    threading.Thread(target=srv.serve_forever, daemon=True,
                     name="kgct-follower-health").start()
    return srv


def follower_addrs_from_env() -> list[str]:
    """The follower directive endpoints for rank 0.

    KGCT_FOLLOWER_ADDRS (comma-separated host:port) when set — tests and
    custom topologies; otherwise derived from the StatefulSet DNS pattern in
    KGCT_COORDINATOR (…-0.<svc>:<port> -> …-{k}.<svc>:CONTROL_PORT) for
    k in 1..KGCT_NUM_PROCESSES-1, matching deploy/render.py's layout."""
    import os

    explicit = os.environ.get("KGCT_FOLLOWER_ADDRS")
    if explicit:
        return [a for a in explicit.split(",") if a]
    coord = os.environ.get("KGCT_COORDINATOR", "")
    n = int(os.environ.get("KGCT_NUM_PROCESSES", "1"))
    if n <= 1:
        return []
    if "-0." not in coord:
        # Broadcasting to nobody would hang the whole group silently at the
        # first collective — refuse the misconfiguration instead.
        raise RuntimeError(
            f"cannot derive follower addresses: KGCT_COORDINATOR={coord!r} "
            "does not follow the StatefulSet '<name>-0.<svc>:<port>' "
            "pattern; set KGCT_FOLLOWER_ADDRS explicitly")
    host = coord.rpartition(":")[0]
    # Followers bind KGCT_CONTROL_PORT when set; a StatefulSet template
    # shares env across ranks, so derive dial addresses from the same
    # override or the leader would dial the default port forever.
    port = int(os.environ.get("KGCT_CONTROL_PORT", CONTROL_PORT))
    return [f"{host.replace('-0.', f'-{k}.', 1)}:{port}"
            for k in range(1, n)]
