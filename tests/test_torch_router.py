"""The port's router (``serving/router.py`` on ``serving/http.py``), over
real sockets on the CPU.

Every router here is the port's unless a case holds it against the JAX
package's (``kubernetes_gpu_cluster_tpu.serving.router``, aiohttp). Stub
replicas run on the port's ``http.Application``; engine replicas are
debug-tiny fp32 servers of either package on one weight set; test requests
go through the port's ``ClientSession``.

- The reference's router cases, re-pointed at the port, each under its
  reference class and test name: every class of ``test_router_ring.py``
  but ``TestRouterBenchPhase`` (it runs the root ``bench.py``);
  ``test_fleet_soak.py`` (``slow`` there and here);
  ``test_migration.py``'s ``TestSSERelay``, ``TestRouterMidstreamFailover``
  and ``TestLiveMigrationServing``; ``test_disagg.py``'s
  ``TestDisaggServing`` role-split case (its bench case runs ``bench.py``);
  ``test_wire_integrity.py::TestRouterQuarantine``;
  ``test_qos.py::TestRouterQoS``; ``test_chaos.py::TestRouterChaos``;
  ``test_serving.py``'s ``TestRouter`` and ``TestRouterFailover``. The
  engine-backed cases are parametrised over router and replica packages:
  the ``port-router-port-replicas`` case is the reference's, the others
  are the mixed fleet.
- Parity with the JAX router on the same inputs: the ring's owners and
  walks, the affinity keys, the pick sequence under a scripted fleet
  state, and the ``/metrics`` series.
- The mixed fleet on one weight set: the port's router in front of JAX
  replicas and the JAX router in front of the port's, serving the JAX
  colocated server's greedy tokens through a prefix-affinity session, a
  disaggregated request, and streams severed mid-way (``import`` by drain,
  ``recompute`` by ``replica_kill_midstream``).
- What the transport changes: a refused or blackholed connect is retried
  on the next replica, a replica that took the body and went silent is
  not (one request upstream), a stream outlives the client's default wall
  bound, a body cut short ends the client's stream, and a client that
  leaves mid-stream aborts the replica's engine request without counting
  against the replica.
- The module imports neither ``torch`` nor ``jax`` without tiers; the CLI
  takes the JAX CLI's flags, serves a stream and exits 0 on SIGTERM.
"""

import asyncio
import contextlib
import json
import os
import random
import signal
import socket
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path
from unittest import mock

import jax
import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestServer

from kubernetes_gpu_cluster_tpu.config import CacheConfig as JCache
from kubernetes_gpu_cluster_tpu.config import EngineConfig as JEngineConfig
from kubernetes_gpu_cluster_tpu.config import SchedulerConfig as JSched
from kubernetes_gpu_cluster_tpu.config import get_model_config as jax_model
from kubernetes_gpu_cluster_tpu.config.qos import \
    parse_qos_tiers as jax_parse_qos_tiers
# The JAX engine before its models: each imports the other.
from kubernetes_gpu_cluster_tpu.engine import LLMEngine  # noqa: F401
from kubernetes_gpu_cluster_tpu.models import llama as JM
from kubernetes_gpu_cluster_tpu.resilience import DrainState as JDrainState
from kubernetes_gpu_cluster_tpu.resilience.faults import \
    configure_faults as jax_configure_faults
from kubernetes_gpu_cluster_tpu.serving import router as JR
from kubernetes_gpu_cluster_tpu.serving.api_server import \
    build_server as jax_build_server
from kubernetes_gpu_cluster_tpu_torch.config import (CacheConfig,
                                                     EngineConfig,
                                                     SchedulerConfig,
                                                     get_model_config)
from kubernetes_gpu_cluster_tpu_torch.config.qos import parse_qos_tiers
from kubernetes_gpu_cluster_tpu_torch.models import llama as TM
from kubernetes_gpu_cluster_tpu_torch.observability.trace import \
    RequestTracer
from kubernetes_gpu_cluster_tpu_torch.resilience import (DrainState,
                                                         configure_faults)
from kubernetes_gpu_cluster_tpu_torch.serving import router as R
from kubernetes_gpu_cluster_tpu_torch.serving.api_server import build_server
from kubernetes_gpu_cluster_tpu_torch.serving.errors import (
    MIGRATE_URL_HEADER, PREFILL_URL_HEADER, PREFIX_SOURCE_HEADER,
    REQUEST_ID_HEADER, RESUME_MODE_HEADER)
from kubernetes_gpu_cluster_tpu_torch.serving.fleet_cache import \
    PEER_QUARANTINE_S
from kubernetes_gpu_cluster_tpu_torch.serving.http import (
    Application, ClientSession, Response, Server, StreamResponse,
    StreamSevered, json_response)
from kubernetes_gpu_cluster_tpu_torch.serving.router import (HashRing,
                                                             Router,
                                                             _SSERelay)
from test_serving import _assert_valid_exposition

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def _module_flight_dir(tmp_path_factory):
    """Flight-recorder dumps made while the module fleet starts or stops
    land in a directory of this run, never in the recorder's default."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("KGCT_FLIGHT_DIR", str(tmp_path_factory.mktemp("flight")))
        yield


@pytest.fixture(autouse=True)
def _flight_dir(monkeypatch, tmp_path):
    """Each case's dumps (a mid-stream failover, a quarantine), the JAX
    router's included, land in its own ``tmp_path``."""
    monkeypatch.setenv("KGCT_FLIGHT_DIR", str(tmp_path))


@pytest.fixture(autouse=True)
def _clean_faults():
    configure_faults(None)
    jax_configure_faults(None)
    yield
    configure_faults(None)
    jax_configure_faults(None)


URLS = [f"http://replica-{i}:8000" for i in range(4)]
KEYS = [f"session-{i}".encode() for i in range(400)]


# -- the port's stand-ins for aiohttp's test server and client --------------

class _Reply:
    def __init__(self, status, headers, body: bytes):
        self.status, self.headers, self.body = status, headers, body

    def json(self):
        return json.loads(self.body)

    def text(self) -> str:
        return self.body.decode()


class _Client:
    """What the reference reads from aiohttp's ``TestClient``, on the port's
    client: each call returns the status, headers and whole body."""

    def __init__(self, base: str):
        self.base = base
        self.sess = ClientSession()

    async def request(self, method, path, json=None, headers=None):
        async with self.sess.request(method, self.base + path, json=json,
                                     headers=headers, timeout_s=60) as r:
            body = bytes(await r.read())
        return _Reply(r.status, r.headers, body)

    async def post(self, path, json=None, headers=None):
        return await self.request("POST", path, json, headers)

    async def get(self, path, headers=None):
        return await self.request("GET", path, None, headers)


async def _serve_app(stack: list, app) -> str:
    server = Server(app)
    await server.start("127.0.0.1", 0)
    stack.append(server)
    return f"http://127.0.0.1:{server.port}"


async def _close(stack: list) -> None:
    for server in reversed(stack):
        await server.close()


async def _start_router(stack: list, router) -> _Client:
    return _Client(await _serve_app(stack, router.build_app()))


def _health_app() -> Application:
    app = Application()

    async def health(request):
        return json_response({"status": "ok"})

    app.add_get("/health", health)
    return app


def _router(policy="prefix-affinity", urls=URLS, **kw):
    # Never started: _pick / _affinity_key are pure and need no session.
    return Router(list(urls), routing_policy=policy, **kw)


# -- test_router_ring.py ---------------------------------------------------

class TestHashRing:
    def test_deterministic_across_instances(self):
        a, b = HashRing(URLS), HashRing(URLS)
        assert [a.owner(k) for k in KEYS] == [b.owner(k) for k in KEYS]

    def test_vnode_balance_within_bound(self):
        counts = Counter(HashRing(URLS).owner(k) for k in KEYS)
        assert set(counts) == set(URLS), "some replica owns no keys"
        fair = len(KEYS) / len(URLS)
        assert max(counts.values()) <= 1.6 * fair, counts

    def test_single_removal_remaps_at_most_2k_over_n(self):
        full = HashRing(URLS)
        shrunk = HashRing(URLS[:-1])
        moved = sum(1 for k in KEYS if full.owner(k) != shrunk.owner(k))
        assert moved <= 2 * len(KEYS) / len(URLS), moved
        survivors_moved = [
            k for k in KEYS
            if full.owner(k) != URLS[-1] and full.owner(k) != shrunk.owner(k)]
        assert survivors_moved == []

    def test_walk_skip_equals_membership_removal(self):
        full = HashRing(URLS)
        shrunk = HashRing(URLS[:-1])
        for k in KEYS[:100]:
            walked = next(u for u in full.walk(k) if u != URLS[-1])
            assert walked == shrunk.owner(k)

    def test_walk_yields_every_member_once(self):
        walk = list(HashRing(URLS).walk(b"any-key"))
        assert sorted(walk) == sorted(URLS)
        assert walk[0] == HashRing(URLS).owner(b"any-key")


class TestPickPolicy:
    def test_identical_configs_identical_assignments(self):
        r1, r2 = _router(), _router()
        assert ([r1._pick(affinity_key=k).url for k in KEYS]
                == [r2._pick(affinity_key=k).url for k in KEYS])

    def test_session_stickiness(self):
        router = _router()
        first = router._pick(affinity_key=b"sticky")
        for _ in range(5):
            assert router._pick(affinity_key=b"sticky") is first
        assert router.affinity_hits_total == 6
        assert router.affinity_requests_total == 6

    def test_bounded_load_overflow_walks_to_ring_successor(self):
        router = _router(balance_factor=1.0)
        key = b"hot-prefix"
        owner_url = router.ring.owner(key)
        owner = next(r for r in router.replicas if r.url == owner_url)
        owner.inflight = 8      # others idle: bound = ceil(9/4) = 3
        picked = router._pick(affinity_key=key)
        successor = next(u for u in router.ring.walk(key)
                         if u != owner_url)
        assert picked.url == successor
        assert router.affinity_overflow_total[owner_url] == 1
        assert router.affinity_hits_total == 0
        owner.inflight = 0
        assert router._pick(affinity_key=key).url == owner_url

    def test_unhealthy_owner_remaps_and_recovers(self):
        router = _router()
        key = b"some-session"
        owner_url = router.ring.owner(key)
        owner = next(r for r in router.replicas if r.url == owner_url)
        owner.healthy = False
        picked = router._pick(affinity_key=key)
        assert picked.url == next(u for u in router.ring.walk(key)
                                  if u != owner_url)
        assert router.ring_remaps_total == 1
        owner.healthy = True
        assert router._pick(affinity_key=key).url == owner_url

    def test_retry_exclude_flows_through_pick_seam(self):
        router = _router()
        key = b"retry-me"
        first = router._pick(affinity_key=key)
        second = router._pick(affinity_key=key, exclude={first.url})
        assert second is not None and second.url != first.url
        assert second.url == next(u for u in router.ring.walk(key)
                                  if u != first.url)
        third = router._pick(affinity_key=key,
                             exclude={first.url, second.url})
        assert third.url == next(u for u in router.ring.walk(key)
                                 if u not in (first.url, second.url))

    def test_walk_always_places_when_candidates_exist(self):
        rng = random.Random(7)
        router = _router(balance_factor=1.0)
        for _ in range(200):
            for r in router.replicas:
                r.inflight = rng.randrange(0, 30)
            assert router._pick(affinity_key=b"k") is not None

    def test_no_key_falls_back_to_least_inflight(self):
        router = _router()
        router.replicas[2].inflight = 0
        for r in router.replicas[:2]:
            r.inflight = 5
        router.replicas[3].inflight = 5
        assert router._pick(affinity_key=None) is router.replicas[2]
        assert router.affinity_requests_total == 0

    def test_least_inflight_byte_identical_to_pre_affinity_router(self):
        import itertools

        router = _router(policy="least-inflight")
        legacy_rr = itertools.count()

        def legacy_pick(replicas, exclude=None, include_unhealthy=False):
            healthy = [r for r in replicas
                       if (r.healthy or include_unhealthy)
                       and (not exclude or r.url not in exclude)]
            if not healthy:
                return None
            least = min(r.inflight for r in healthy)
            tied = [r for r in healthy if r.inflight == least]
            return tied[next(legacy_rr) % len(tied)]

        script = [
            dict(loads=[0, 0, 0, 0]),
            dict(loads=[0, 0, 0, 0]),
            dict(loads=[2, 0, 1, 0]),
            dict(loads=[2, 0, 1, 0], exclude={URLS[1]}),
            dict(loads=[1, 1, 1, 1], unhealthy={URLS[0]}),
            dict(loads=[3, 3, 3, 3], unhealthy={URLS[0]},
                 include_unhealthy=True),
            dict(loads=[0, 5, 0, 5]),
            dict(loads=[0, 5, 0, 5]),
            dict(loads=[0, 5, 0, 5], exclude={URLS[0], URLS[2]}),
        ]
        for step in script:
            for r, load in zip(router.replicas, step["loads"]):
                r.inflight = load
                r.healthy = r.url not in step.get("unhealthy", ())
            expect = legacy_pick(router.replicas,
                                 exclude=step.get("exclude"),
                                 include_unhealthy=step.get(
                                     "include_unhealthy", False))
            got = router._pick(exclude=step.get("exclude"),
                               include_unhealthy=step.get(
                                   "include_unhealthy", False))
            assert got is expect, step

    def test_unknown_policy_rejected(self):
        with pytest.raises(ValueError, match="routing_policy"):
            Router(URLS, routing_policy="round-robin")
        with pytest.raises(ValueError, match="balance_factor"):
            Router(URLS, routing_policy="prefix-affinity",
                   balance_factor=0.5)


class TestAffinityKey:
    def test_session_id_beats_user_beats_prompt(self):
        router = _router()
        body = (b'{"prompt": "abc", "user": "u1", "session_id": "s1"}')
        assert router._affinity_key(body) == b"sticky:session_id:s1"
        body = b'{"prompt": "abc", "user": "u1"}'
        assert router._affinity_key(body) == b"sticky:user:u1"

    def test_prompt_prefix_windows(self):
        router = _router(affinity_prefix_len=4)
        assert router._affinity_key(
            b'{"prompt": [5, 6, 7, 8, 9, 10]}') == b"tokens:5,6,7,8"
        key = router._affinity_key(b'{"prompt": "abcdefghijklmnopqrstuvwx"}')
        assert key == b"text:abcdefghijklmnop"
        k1 = router._affinity_key(
            b'{"messages": [{"role": "user", "content": "hi"}]}')
        assert k1 is not None and k1.startswith(b"chat:")

    def test_unparseable_or_keyless_bodies_yield_none(self):
        router = _router()
        assert router._affinity_key(b"") is None
        assert router._affinity_key(b"not json") is None
        assert router._affinity_key(b'[1, 2]') is None
        assert router._affinity_key(b'{"n": 1}') is None
        assert router._affinity_key(b'{"session_id": true, "n": 1}') is None

    def test_least_inflight_policy_never_peeks(self):
        router = _router(policy="least-inflight")
        assert router._affinity_key(b'{"session_id": "s"}') is None


async def _recording_replica(stack: list, extra_metrics=""):
    """``test_router_ring.py``'s stand-in replica on the port's server:
    records each completion (body, forwarded request id, headers), streams
    an SSE body, and exports a lifecycle span per served id on
    ``/debug/trace``."""
    served = []
    tracer = RequestTracer()

    async def health(request):
        return json_response({"status": "ok"})

    async def metrics(request):
        return Response(
            text="# TYPE kgct_requests_total counter\n"
                 f"kgct_requests_total {len(served)}\n" + extra_metrics,
            content_type="text/plain")

    async def completions(request):
        rid = request.headers.get(REQUEST_ID_HEADER, "")
        served.append({"body": await request.json(), "request_id": rid,
                       "headers": {k.lower(): v
                                   for k, v in request.headers.items()}})
        if rid:
            tracer.emit("arrival", rid, prompt_tokens=1)
            tracer.emit("first_token", rid, ttft_ms=1.0)
            tracer.emit("finish", rid, outcome="finished")
        resp = StreamResponse(headers={"Content-Type": "text/event-stream"})
        await resp.prepare(request)
        await resp.write(b'data: {"text": "tok"}\n\n')
        await resp.write(b"data: [DONE]\n\n")
        await resp.write_eof()
        return resp

    async def debug_trace(request):
        return json_response(tracer.export_perfetto())

    app = Application()
    app.add_get("/health", health)
    app.add_get("/metrics", metrics)
    app.add_get("/debug/trace", debug_trace)
    app.add_post("/v1/completions", completions)
    return await _serve_app(stack, app), served


class TestStreamedStickiness:
    def test_session_requests_stream_through_one_replica(self):
        async def scenario():
            stack = []
            try:
                a_url, a_served = await _recording_replica(stack)
                b_url, b_served = await _recording_replica(stack)
                router = Router([a_url, b_url], health_interval_s=9999,
                                routing_policy="prefix-affinity")
                client = await _start_router(stack, router)
                for i in range(4):
                    r = await client.post(
                        "/v1/completions",
                        json={"prompt": f"turn {i} of this conversation",
                              "session_id": "conv-42", "stream": True})
                    assert r.status == 200
                    assert b"[DONE]" in r.body
                assert sorted([len(a_served), len(b_served)]) == [0, 4]
                assert router.affinity_hits_total == 4
                for i in range(2):
                    await client.post(
                        "/v1/completions",
                        json={"prompt": "x", "session_id": "conv-43"})
                assert (len(a_served), len(b_served)) in (
                    (6, 0), (0, 6), (4, 2), (2, 4))
            finally:
                await _close(stack)
        asyncio.run(scenario())


@pytest.mark.chaos
class TestReplicaDownRemap:
    def test_downed_replica_keys_remap_then_return(self):
        async def scenario():
            stack = []
            try:
                a_url, _ = await _recording_replica(stack)
                b_url, _ = await _recording_replica(stack)
                router = Router([a_url, b_url], health_interval_s=9999,
                                routing_policy="prefix-affinity")
                await _start_router(stack, router)
                key = b"sticky:session_id:chaos"
                owner_url = router.ring.owner(key)
                own_idx = [r.url for r in router.replicas].index(owner_url)
                other_url = [u for u in (a_url, b_url) if u != owner_url][0]
                other_key = next(
                    k for k in (f"probe-{i}".encode() for i in range(64))
                    if router.ring.owner(k) == other_url)
                assert router._pick(affinity_key=key).url == owner_url

                configure_faults(f"replica_down:value={own_idx}")
                for r in router.replicas:
                    await router._check(r, startup=True)
                assert not router.replicas[own_idx].healthy
                assert router._pick(affinity_key=key).url == other_url
                assert router.ring_remaps_total == 1
                assert router._pick(affinity_key=other_key).url == other_url

                configure_faults(None)
                for r in router.replicas:
                    await router._check(r)
                assert router.replicas[own_idx].healthy
                assert router._pick(affinity_key=key).url == owner_url

                router.replicas[own_idx].benched_until = 0.0
                configure_faults(f"replica_down:value={own_idx},times=1")
                for r in router.replicas:
                    if r is not router.replicas[own_idx]:
                        await router._check(r)
                assert all(r.healthy for r in router.replicas)
                await router._check(router.replicas[own_idx], startup=True)
                assert not router.replicas[own_idx].healthy
            finally:
                await _close(stack)
        asyncio.run(scenario())


class TestRouterMetricsAggregation:
    def test_replica_locality_gauges_zero_and_absent_safe(self):
        async def scenario():
            stack = []
            try:
                a_url, _ = await _recording_replica(stack, extra_metrics=(
                    "# TYPE kgct_prefix_cache_hit_ratio gauge\n"
                    "kgct_prefix_cache_hit_ratio 0.75\n"
                    "# TYPE kgct_num_swapped gauge\n"
                    "kgct_num_swapped 2\n"))
                b_url, _ = await _recording_replica(stack)
                router = Router([a_url, b_url], health_interval_s=9999)
                client = await _start_router(stack, router)
                text = (await client.get("/metrics")).text()
                _assert_valid_exposition(text)

                def val(name, url):
                    [line] = [ln for ln in text.splitlines()
                              if ln.startswith(f'{name}{{replica="{url}"')]
                    return float(line.rpartition(" ")[2])

                assert val("kgct_router_replica_prefix_cache_hit_ratio",
                           a_url) == 0.75
                assert val("kgct_router_replica_prefix_cache_hit_ratio",
                           b_url) == 0.0
                assert val("kgct_router_replica_num_swapped", a_url) == 2.0
                assert val("kgct_router_replica_num_swapped", b_url) == 0.0
                assert (f'kgct_router_replica_healthy{{replica="{a_url}",'
                        'role="both"} 1') in text
                assert "kgct_router_affinity_hit_ratio 0.0" in text
                assert "kgct_router_ring_remaps_total 0" in text
                assert val("kgct_router_affinity_overflow_total",
                           a_url) == 0.0
                assert ('kgct_router_policy{policy="least-inflight"} 1'
                        in text)
                assert "kgct_router_trace_scrape_errors_total 0" in text
            finally:
                await _close(stack)
        asyncio.run(scenario())


class TestRouterRequestId:
    def test_id_minted_forwarded_and_echoed(self):
        async def scenario():
            stack = []
            try:
                a_url, a_served = await _recording_replica(stack)
                router = Router([a_url], health_interval_s=9999)
                client = await _start_router(stack, router)
                r = await client.post("/v1/completions",
                                      json={"prompt": "x"})
                assert r.status == 200
                minted = r.headers[REQUEST_ID_HEADER]
                assert minted.startswith("req-")
                assert a_served[0]["request_id"] == minted
                r2 = await client.post(
                    "/v1/completions", json={"prompt": "y"},
                    headers={REQUEST_ID_HEADER: "req-client-42"})
                assert r2.headers[REQUEST_ID_HEADER] == "req-client-42"
                assert a_served[1]["request_id"] == "req-client-42"
                r3 = await client.post(
                    "/v1/completions", json={"prompt": "z"},
                    headers={REQUEST_ID_HEADER: "bad id"})
                assert r3.headers[REQUEST_ID_HEADER].startswith("req-")
            finally:
                await _close(stack)
        asyncio.run(scenario())

    def test_error_responses_carry_id(self):
        async def scenario():
            stack = []
            try:
                router = Router(["http://127.0.0.1:1"],
                                health_interval_s=9999, connect_retries=0)
                client = await _start_router(stack, router)
                r = await client.post(
                    "/v1/completions", json={"prompt": "x"},
                    headers={REQUEST_ID_HEADER: "req-err-1"})
                assert r.status in (502, 503)
                assert r.headers[REQUEST_ID_HEADER] == "req-err-1"
                r2 = await client.post("/v1/completions",
                                       json={"prompt": "x"})
                assert r2.status in (502, 503)
                assert r2.headers[REQUEST_ID_HEADER].startswith("req-")
            finally:
                await _close(stack)
        asyncio.run(scenario())


class TestMergedFleetTrace:
    def test_debug_trace_merges_router_and_replica_spans(self):
        async def scenario():
            stack = []
            try:
                a_url, _ = await _recording_replica(stack)
                b_url, _ = await _recording_replica(stack)
                router = Router([a_url, b_url], health_interval_s=9999)
                client = await _start_router(stack, router)
                for rid in ("req-merge-a", "req-merge-b"):
                    r = await client.post(
                        "/v1/completions", json={"prompt": rid},
                        headers={REQUEST_ID_HEADER: rid})
                    assert r.status == 200
                r = await client.get("/debug/trace")
                assert r.status == 200
                return a_url, b_url, r.json()
            finally:
                await _close(stack)
        a_url, b_url, doc = asyncio.run(scenario())
        evs = doc["traceEvents"]
        labels = {e["pid"]: e["args"]["name"] for e in evs
                  if e.get("name") == "process_name"}
        assert labels[1] == "kgct-router"
        assert {f"kgct-engine {a_url}", f"kgct-engine {b_url}"} == {
            labels[2], labels[3]}
        by_pid = {}
        for e in evs:
            if e.get("cat") == "request" and e.get("id"):
                by_pid.setdefault(e["pid"], set()).add(e["id"])
        assert by_pid[1] == {"req-merge-a", "req-merge-b"}
        assert by_pid[2] | by_pid[3] == {"req-merge-a", "req-merge-b"}
        picks = [e for e in evs if e.get("name") == "pick"]
        assert picks and all(e["pid"] == 1 for e in picks)
        assert {e["args"]["replica"] for e in picks} == {a_url, b_url}
        assert all(e["ts"] >= 0 for e in evs if "ts" in e)
        json.dumps(doc)

    def test_replica_without_trace_endpoint_is_skipped_and_counted(self):
        async def scenario():
            stack = []
            try:
                url = await _serve_app(stack, _health_app())
                router = Router([url], health_interval_s=9999)
                client = await _start_router(stack, router)
                r = await client.get("/debug/trace")
                assert r.status == 200
                assert router.trace_scrape_errors_total == 1
                labels = [e["args"]["name"] for e in r.json()["traceEvents"]
                          if e.get("name") == "process_name"]
                assert labels == ["kgct-router"]
            finally:
                await _close(stack)
        asyncio.run(scenario())

    def test_flightrecorder_endpoint_exports_spans_and_snapshots(self):
        async def scenario():
            stack = []
            try:
                a_url, _ = await _recording_replica(stack)
                router = Router([a_url], health_interval_s=9999)
                client = await _start_router(stack, router)
                await client.post("/v1/completions", json={"prompt": "x"})
                router.flight.maybe_snapshot()   # the health loop's call
                r = await client.get("/debug/flightrecorder")
                assert r.status == 200
                return a_url, r.json()
            finally:
                await _close(stack)
        a_url, doc = asyncio.run(scenario())
        kinds = {e["kind"] for e in doc["events"]}
        assert {"arrival", "pick", "finish", "snapshot"} <= kinds
        snap = next(e for e in doc["events"] if e["kind"] == "snapshot")
        assert a_url in snap["inflight"]
        assert snap["healthy"] == [a_url]


@pytest.mark.chaos
class TestRemapContractSoak:
    """Engine-free: stub replicas, the router's real probes and pick
    seam (``slow`` in the reference; a second here)."""

    def test_churn_cycles_remap_only_owned_keys_and_recover(self):
        N, K, CYCLES = 6, 96, 4

        async def scenario():
            stack = []
            try:
                urls = [(await _recording_replica(stack))[0]
                        for _ in range(N)]
                router = Router(urls, health_interval_s=9999,
                                routing_policy="prefix-affinity")
                await _start_router(stack, router)
                keys = [f"soak-session-{i}".encode() for i in range(K)]

                def owners():
                    return {k: router._pick(affinity_key=k).url
                            for k in keys}

                baseline = owners()
                by_owner: dict = {}
                for k, u in baseline.items():
                    by_owner.setdefault(u, []).append(k)
                assert len(by_owner) == N
                assert max(len(v) for v in by_owner.values()) <= 3 * K // N

                for cycle in range(CYCLES):
                    down = cycle % N
                    down_url = urls[down]
                    configure_faults(f"replica_down:value={down}")
                    for r in router.replicas:
                        await router._check(r, startup=True)
                    assert not router.replicas[down].healthy
                    churned = owners()
                    moved = {k for k in keys if churned[k] != baseline[k]}
                    assert moved == set(by_owner[down_url]), \
                        f"cycle {cycle}: non-owned keys remapped"
                    assert 0 < len(moved) <= 3 * K // N
                    for k in moved:
                        want = next(u for u in router.ring.walk(k)
                                    if u != down_url)
                        assert churned[k] == want
                    configure_faults(None)
                    router.replicas[down].benched_until = 0.0
                    for r in router.replicas:
                        await router._check(r)
                    assert router.replicas[down].healthy
                    assert owners() == baseline, \
                        f"cycle {cycle}: owners did not return on recovery"
            finally:
                configure_faults(None)
                await _close(stack)
        asyncio.run(scenario())


def _spy_requests(router, seen: list, what):
    """Record ``what(kw)`` of every upstream request the router makes."""
    orig = router._session.request

    def spy(method, url, **kw):
        seen.append(what(kw))
        return orig(method, url, **kw)
    router._session.request = spy


class TestDisaggRouting:
    PF_URLS = [f"http://prefill-{i}:8000" for i in range(2)]

    def test_prefill_pick_is_prefix_affine_even_under_least_inflight(self):
        router = Router(list(URLS), routing_policy="least-inflight",
                        prefill_urls=list(self.PF_URLS))
        key = b"text:some prompt prefix"
        owner = router.prefill_ring.owner(key)
        for _ in range(5):
            picked = router._pick(affinity_key=key,
                                  pool=router.prefill_replicas,
                                  ring=router.prefill_ring)
            assert picked.url == owner
        assert router.affinity_requests_total == 0
        dead = next(r for r in router.prefill_replicas if r.url == owner)
        dead.healthy = False
        picked = router._pick(affinity_key=key,
                              pool=router.prefill_replicas,
                              ring=router.prefill_ring)
        assert picked.url == next(u for u in router.prefill_ring.walk(key)
                                  if u != owner)
        assert router.ring_remaps_total == 0

    def test_prefill_pool_bounded_load_spills_off_a_hot_owner(self):
        router = Router(list(URLS), routing_policy="least-inflight",
                        prefill_urls=list(self.PF_URLS))
        key = b"text:some prompt prefix"
        owner_url = router.prefill_ring.owner(key)
        owner = next(r for r in router.prefill_replicas
                     if r.url == owner_url)
        owner.inflight = 10
        picked = router._pick(affinity_key=key,
                              pool=router.prefill_replicas,
                              ring=router.prefill_ring)
        assert picked.url != owner_url
        assert router._pick_info["pick"] == "affinity_overflow"

    def test_proxy_accounts_the_prefill_pull_slot(self):
        async def scenario():
            stack = []
            try:
                pf_url, _ = await _recording_replica(stack)
                dc_url, _ = await _recording_replica(stack)
                router = Router([dc_url], health_interval_s=9999,
                                prefill_urls=[pf_url])
                client = await _start_router(stack, router)
                pf = router.prefill_replicas[0]
                seen = []
                _spy_requests(router, seen, lambda kw: pf.inflight)
                r = await client.post("/v1/completions",
                                      json={"prompt": "x"})
                assert r.status == 200
                assert seen[-1] == 1   # held while forwarding downstream
                await asyncio.sleep(0.05)
                assert pf.inflight == 0            # drained at completion
            finally:
                await _close(stack)
        asyncio.run(scenario())

    def test_header_forwarded_and_client_value_stripped(self):
        async def scenario():
            stack = []
            try:
                pf_url, _ = await _recording_replica(stack)
                dc_url, _ = await _recording_replica(stack)
                router = Router([dc_url], health_interval_s=9999,
                                prefill_urls=[pf_url])
                client = await _start_router(stack, router)
                seen = []
                _spy_requests(router, seen,
                              lambda kw: kw.get("headers") or {})
                r = await client.post(
                    "/v1/completions", json={"prompt": "x"},
                    headers={PREFILL_URL_HEADER: "http://evil:1"})
                assert r.status == 200
                assert seen[-1][PREFILL_URL_HEADER] == pf_url
                await client.get("/v1/models")
                assert PREFILL_URL_HEADER not in (seen[-1] or {})
                picks = [e for e in router.tracer.events()
                         if e.kind == "pick"
                         and e.args.get("pool") == "prefill"]
                assert picks and picks[0].args["replica"] == pf_url
            finally:
                await _close(stack)
        asyncio.run(scenario())

    def test_metrics_and_health_separate_pools_by_role(self):
        async def scenario():
            stack = []
            try:
                pf_url, _ = await _recording_replica(stack)
                dc_url, _ = await _recording_replica(stack)
                router = Router([dc_url], health_interval_s=9999,
                                prefill_urls=[pf_url])
                client = await _start_router(stack, router)
                text = (await client.get("/metrics")).text()
                _assert_valid_exposition(text)
                assert (f'kgct_router_replica_healthy{{replica="{dc_url}",'
                        'role="decode"} 1') in text
                assert (f'kgct_router_replica_healthy{{replica="{pf_url}",'
                        'role="prefill"} 1') in text
                assert (f'kgct_router_replica_prefix_cache_hit_ratio'
                        f'{{replica="{pf_url}",role="prefill"}} 0.0') \
                    in text
                body = (await client.get("/health")).json()
                assert body["replicas"][pf_url]["role"] == "prefill"
                assert body["replicas"][dc_url]["role"] == "decode"
            finally:
                await _close(stack)
        asyncio.run(scenario())

    def test_no_healthy_prefill_pool_degrades_to_no_header(self):
        async def scenario():
            stack = []
            try:
                dc_url, _ = await _recording_replica(stack)
                router = Router([dc_url], health_interval_s=9999,
                                prefill_urls=["http://127.0.0.1:1"])
                client = await _start_router(stack, router)
                seen = []
                _spy_requests(router, seen,
                              lambda kw: kw.get("headers") or {})
                r = await client.post("/v1/completions",
                                      json={"prompt": "x"})
                assert r.status == 200
                assert PREFILL_URL_HEADER not in seen[-1]
            finally:
                await _close(stack)
        asyncio.run(scenario())

    def test_multi_sequence_requests_skip_the_prefill_pick(self):
        def ok(body):
            return Router._handoff_eligible(Router._parse_json_dict(body))
        assert not ok(b'{"prompt": "x", "n": 2}')
        assert not ok(b'{"prompt": "x", "best_of": 3}')
        assert ok(b'{"prompt": "x"}')
        assert ok(b'{"prompt": "x", "n": 1}')
        assert ok(b'{"prompt": "x", "n": 1, "best_of": 1}')
        assert ok(b'{"prompt": "x", "n": "zzz"}')
        assert ok(b'not json at all')
        assert ok(b'[1, 2, 3]')

    def test_flight_snapshot_covers_both_pools(self):
        router = Router(list(URLS), routing_policy="least-inflight",
                        prefill_urls=list(self.PF_URLS))
        router.prefill_replicas[0].inflight = 3
        router.prefill_replicas[1].healthy = False
        snap = router._flight_snapshot()
        for url in (*URLS, *self.PF_URLS):
            assert url in snap["inflight"]
        assert snap["inflight"][self.PF_URLS[0]] == 3
        assert self.PF_URLS[0] in snap["healthy"]
        assert self.PF_URLS[1] not in snap["healthy"]


class TestTierAwarePicks:
    def _router(self, n=3):
        return _router(policy="least-inflight",
                       urls=[f"http://r{i}:8000" for i in range(n)],
                       qos_tiers=parse_qos_tiers("default"))

    def test_interactive_pick_avoids_batch_saturated_replica(self):
        router = self._router()
        router.replicas[0].tier_inflight = {"interactive": 0, "batch": 5}
        urls = {router._pick(pick_tier="interactive").url
                for _ in range(6)}
        assert urls == {"http://r1:8000", "http://r2:8000"}
        assert router._pick_info.get("tier_deprioritized") == 1

    def test_batch_pick_keeps_legacy_rotation(self):
        router = self._router()
        router.replicas[0].tier_inflight = {"batch": 5}
        urls = {router._pick(pick_tier="batch").url for _ in range(3)}
        assert urls == {r.url for r in router.replicas}

    def test_tier_none_byte_identical_rotation(self):
        router = self._router()
        router.replicas[0].tier_inflight = {"batch": 99}
        urls = {router._pick().url for _ in range(3)}
        assert urls == {r.url for r in router.replicas}

    def test_total_inflight_stays_primary(self):
        router = self._router()
        router.replicas[0].tier_inflight = {"batch": 9}
        router.replicas[1].inflight = 1
        router.replicas[2].inflight = 1
        assert router._pick(pick_tier="interactive").url == "http://r0:8000"

    def test_health_probe_scrapes_the_ledger(self):
        async def run():
            stack = []
            app = Application()

            async def health(request):
                return json_response(
                    {"status": "ok", "qos_tiers": {"batch": 7,
                                                   "interactive": 1}})
            app.add_get("/health", health)
            try:
                url = await _serve_app(stack, app)
                router = Router([url], health_interval_s=9999,
                                qos_tiers=parse_qos_tiers("default"))
                router._session = ClientSession()
                await router._check(router.replicas[0], startup=True)
                assert router.replicas[0].tier_inflight == {
                    "batch": 7, "interactive": 1}
            finally:
                await _close(stack)
        asyncio.run(run())


class TestPrefixSourceHint:
    def _owner_and_other(self, router, key):
        owner_url = router.ring.owner(key)
        owner = next(r for r in router.replicas if r.url == owner_url)
        other = next(r for r in router.replicas if r.url != owner_url)
        return owner, other

    def test_overflow_pick_names_the_owner(self):
        router = _router(urls=URLS[:2], balance_factor=1.0)
        key = b"hot-prefix"
        owner, other = self._owner_and_other(router, key)
        owner.inflight = 5
        picked = router._pick(affinity_key=key)
        assert picked.url == other.url
        assert router._pick_info["pick"] == "affinity_overflow"
        assert router._prefix_source(dict(router._pick_info),
                                     picked.url) == owner.url

    def test_affinity_hit_carries_no_hint(self):
        router = _router(urls=URLS[:2])
        picked = router._pick(affinity_key=b"cold-prefix")
        assert router._pick_info["pick"] == "affinity_hit"
        assert router._prefix_source(dict(router._pick_info),
                                     picked.url) is None

    def test_downed_owner_is_not_named(self):
        router = _router(urls=URLS[:2])
        key = b"hot-prefix-2"
        owner, other = self._owner_and_other(router, key)
        owner.healthy = False
        picked = router._pick(affinity_key=key)
        assert picked.url == other.url
        assert router._pick_info["pick"] == "affinity_remap"
        assert router._prefix_source(dict(router._pick_info),
                                     picked.url) is None

    def test_excluded_healthy_owner_is_named(self):
        router = _router(urls=URLS[:2])
        key = b"hot-prefix-3"
        owner, other = self._owner_and_other(router, key)
        picked = router._pick(affinity_key=key, exclude={owner.url})
        assert picked.url == other.url
        assert router._pick_info["pick"] == "affinity_remap"
        assert router._prefix_source(dict(router._pick_info),
                                     picked.url) == owner.url

    def test_overflowed_pick_forwards_the_hint_upstream(self):
        async def scenario():
            stack = []
            try:
                a_url, a_served = await _recording_replica(stack)
                b_url, b_served = await _recording_replica(stack)
                router = Router([a_url, b_url], health_interval_s=9999,
                                routing_policy="prefix-affinity",
                                balance_factor=1.0)
                client = await _start_router(stack, router)
                body = {"prompt": "shared prefix body", "stream": False}
                r = await client.post(
                    "/v1/completions", json=body,
                    headers={PREFIX_SOURCE_HEADER: "http://evil:1"})
                assert r.status == 200
                served = (a_served + b_served)[-1]
                assert PREFIX_SOURCE_HEADER not in served["headers"]
                owner_url = router.ring.owner(
                    router._affinity_key_from_obj(body))
                owner = next(rep for rep in router.replicas
                             if rep.url == owner_url)
                other_served = b_served if owner_url == a_url else a_served
                owner.inflight = 5
                r = await client.post("/v1/completions", json=body)
                assert r.status == 200
                assert other_served[-1]["headers"].get(
                    PREFIX_SOURCE_HEADER) == owner_url
            finally:
                await _close(stack)
        asyncio.run(scenario())


# -- test_migration.py: the SSE relay and the failover ladder ---------------

class TestSSERelay:
    def _frame(self, text, toks=None, **extra):
        obj = {"choices": [{"text": text}], **extra}
        if toks is not None:
            obj["kgct_token_ids"] = toks
        return b"data: " + json.dumps(obj).encode() + b"\n\n"

    def test_ledger_kept_and_stripped(self):
        relay = _SSERelay()
        out = relay.feed(self._frame("a", [1, 2]) + self._frame("b", [3]))
        assert relay.tokens == [1, 2, 3]
        assert b"kgct_token_ids" not in out
        assert b'"text": "a"' in out and b'"text": "b"' in out
        assert not relay.done
        out = relay.feed(b"data: [DONE]\n\n")
        assert relay.done and b"[DONE]" in out

    def test_partial_frame_buffered_and_resettable(self):
        relay = _SSERelay()
        whole = self._frame("a", [5])
        assert relay.feed(whole[:10]) == b""
        relay.reset_buffer()
        assert relay.tokens == []
        out = relay.feed(self._frame("a", [5]))
        assert relay.tokens == [5] and b'"text": "a"' in out

    def test_frames_without_ledger_pass_through_byte_identical(self):
        relay = _SSERelay()
        plain = self._frame("x")
        assert relay.feed(plain) == plain
        weird = b"data: not json\n\n"
        assert relay.feed(weird) == weird
        assert relay.tokens == []


TOKENS = [11, 22, 33, 44, 55, 66]


async def _stub_replica(stack: list, resumes: list, resume_status=200,
                        chunk_gap_s=0.03) -> str:
    """``test_migration.py``'s survivable stand-in replica on the port's
    server: a frame per token with the ledger, ``/internal/resume``
    continuing after the relayed prefix (or failing with
    ``resume_status``)."""
    def frame(i):
        return (b"data: " + json.dumps(
            {"choices": [{"text": f"t{i} "}],
             "kgct_token_ids": [TOKENS[i]]}).encode() + b"\n\n")

    async def health(request):
        return json_response({"status": "ok"})

    async def metrics(request):
        return Response(text="", content_type="text/plain")

    async def completions(request):
        assert request.headers.get(MIGRATE_URL_HEADER), \
            "router must name the drain-push target on survivable streams"
        resp = StreamResponse(headers={"Content-Type": "text/event-stream"})
        await resp.prepare(request)
        for i in range(len(TOKENS)):
            await resp.write(frame(i))
            await asyncio.sleep(chunk_gap_s)
        await resp.write(b"data: [DONE]\n\n")
        return resp

    async def resume(request):
        envelope = await request.json()
        resumes.append({"path": request.path,
                        "rid": request.headers.get(REQUEST_ID_HEADER),
                        "envelope": envelope})
        if resume_status != 200:
            return json_response({"error": {"message": "no seat"}},
                                 status=resume_status)
        relayed = envelope["relayed_token_ids"]
        assert envelope["body"]["prompt"] == "survive me"
        resp = StreamResponse(headers={"Content-Type": "text/event-stream",
                                       RESUME_MODE_HEADER: "import"})
        await resp.prepare(request)
        for i in range(len(relayed), len(TOKENS)):
            await resp.write(frame(i))
        await resp.write(b"data: [DONE]\n\n")
        return resp

    app = Application()
    app.add_get("/health", health)
    app.add_get("/metrics", metrics)
    app.add_post("/v1/completions", completions)
    app.add_post("/internal/resume", resume)
    return await _serve_app(stack, app)


def _client_frames(body: bytes):
    """(data payloads, [DONE] seen) of a client-received SSE byte stream."""
    payloads, done = [], False
    for part in body.split(b"\n\n"):
        for line in part.split(b"\n"):
            if not line.startswith(b"data:"):
                continue
            payload = line[5:].strip()
            if payload == b"[DONE]":
                done = True
            elif payload:
                payloads.append(json.loads(payload))
    return payloads, done


@pytest.mark.chaos
class TestRouterMidstreamFailover:
    def test_kill_midstream_splices_one_complete_stream(self, tmp_path):
        async def scenario():
            stack, resumes = [], []
            try:
                u1 = await _stub_replica(stack, resumes)
                u2 = await _stub_replica(stack, resumes)
                router = Router([u1, u2], health_interval_s=9999,
                                fail_threshold=99)
                client = await _start_router(stack, router)
                configure_faults("replica_kill_midstream:after=2,times=1")
                r = await client.post(
                    "/v1/completions",
                    json={"prompt": "survive me", "max_tokens": 6,
                          "stream": True})
                assert r.status == 200
                payloads, done = _client_frames(r.body)
                assert done, "client stream must end in [DONE]"
                texts = [p["choices"][0]["text"] for p in payloads]
                assert texts == [f"t{i} " for i in range(6)], texts
                assert b"kgct_token_ids" not in r.body
                assert len(resumes) == 1
                assert resumes[0]["envelope"]["relayed_token_ids"] == \
                    TOKENS[:2]
                assert resumes[0]["envelope"]["kind"] == "completion"
                assert router.failovers_total["import"] == 1
                assert router.failovers_total["failed"] == 0
                kinds = [e["kind"] for e in router.flight.export()["events"]]
                assert "failover" in kinds
                assert list(tmp_path.glob("flight-midstream_failover-*")), \
                    "failover must trigger a flight dump"
                text = (await client.get("/metrics")).text()
                assert 'kgct_failovers_total{outcome="import"} 1' in text
                assert 'kgct_failovers_total{outcome="failed"} 0' in text
                assert "kgct_router_failover_seconds" in text
            finally:
                await _close(stack)
        asyncio.run(scenario())

    def test_exhausted_ladder_truncates_with_attributed_error(
            self, tmp_path):
        async def scenario():
            stack, resumes = [], []
            try:
                u1 = await _stub_replica(stack, resumes, resume_status=500)
                u2 = await _stub_replica(stack, resumes, resume_status=500)
                router = Router([u1, u2], health_interval_s=9999,
                                fail_threshold=99)
                client = await _start_router(stack, router)
                configure_faults("replica_kill_midstream:after=2,times=1")
                r = await client.post(
                    "/v1/completions",
                    json={"prompt": "survive me", "stream": True},
                    headers={REQUEST_ID_HEADER: "req-truncated1"})
                payloads, done = _client_frames(r.body)
                assert done, "even the bottom rung ends in a clean [DONE]"
                errors = [p for p in payloads if "error" in p]
                assert len(errors) == 1
                err = errors[0]["error"]
                assert "truncated" in err["message"]
                assert err["request_id"] == "req-truncated1"
                assert router.failovers_total["failed"] == 1
                assert len(resumes) == 1
                dumps = [json.loads(p.read_text()) for p in
                         tmp_path.glob("flight-midstream_failover-*")]
                assert any(d["reason"] == "midstream_failover"
                           and d["info"].get("outcome") == "failed"
                           for d in dumps)
            finally:
                await _close(stack)
        asyncio.run(scenario())

    def test_non_survivable_streams_relay_untouched(self):
        async def scenario():
            stack, seen = [], {}
            app = _health_app()

            async def completions(request):
                seen["migrate_url"] = request.headers.get(MIGRATE_URL_HEADER)
                resp = StreamResponse()
                await resp.prepare(request)
                await resp.write(b"data: {\"kgct_token_ids\": [9]}\n\n")
                await resp.write(b"data: [DONE]\n\n")
                return resp

            app.add_post("/v1/completions", completions)
            try:
                url = await _serve_app(stack, app)
                router = Router([url], health_interval_s=9999)
                client = await _start_router(stack, router)
                r = await client.post("/v1/completions",
                                      json={"prompt": "x", "stream": True})
                assert seen["migrate_url"] is None
                assert b"kgct_token_ids" in r.body
            finally:
                await _close(stack)
        asyncio.run(scenario())


# -- test_fleet_soak.py ------------------------------------------------------

FULL_TEXT = [f"t{i} " for i in range(len(TOKENS))]


async def _soak_replica(stack: list, chunk_gap_s=0.02):
    """``test_fleet_soak.py``'s survivable stand-in on the port's server:
    (url, completions served, resumes)."""
    served, resumes = [], []

    def frame(i):
        return (b"data: " + json.dumps(
            {"choices": [{"text": f"t{i} "}],
             "kgct_token_ids": [TOKENS[i]]}).encode() + b"\n\n")

    async def metrics(request):
        return Response(text="", content_type="text/plain")

    async def completions(request):
        served.append(await request.json())
        resp = StreamResponse(headers={"Content-Type": "text/event-stream"})
        await resp.prepare(request)
        for i in range(len(TOKENS)):
            await resp.write(frame(i))
            await asyncio.sleep(chunk_gap_s)
        await resp.write(b"data: [DONE]\n\n")
        return resp

    async def resume(request):
        envelope = await request.json()
        resumes.append({"rid": request.headers.get(REQUEST_ID_HEADER),
                        "envelope": envelope})
        resp = StreamResponse(headers={"Content-Type": "text/event-stream",
                                       RESUME_MODE_HEADER: "import"})
        await resp.prepare(request)
        for i in range(len(envelope["relayed_token_ids"]), len(TOKENS)):
            await resp.write(frame(i))
        await resp.write(b"data: [DONE]\n\n")
        return resp

    app = _health_app()
    app.add_get("/metrics", metrics)
    app.add_post("/v1/completions", completions)
    app.add_post("/internal/resume", resume)
    return await _serve_app(stack, app), served, resumes


@pytest.mark.slow
@pytest.mark.chaos
class TestFleetChaosSoak:
    """``test_fleet_soak.py::TestFleetChaosSoak``, ``slow`` as there (~6 s
    alone; its exact relayed prefix needs each 20 ms-apart frame read on
    its own, which a loaded host does not promise): sustained streams
    through the router while ``replica_kill_midstream`` severs them,
    ``replica_down`` cycles the replicas and the failure seam drives
    quarantine round trips — no client stream dropped."""

    def test_sustained_traffic_survives_membership_churn(self):
        N = 3

        async def scenario():
            stack = []
            try:
                stubs = [await _soak_replica(stack) for _ in range(N)]
                urls = [u for u, _, _ in stubs]
                served = {u: sv for u, sv, _ in stubs}
                resumes = [rs for _, _, rs in stubs]
                router = Router(urls, health_interval_s=9999,
                                fail_threshold=99,
                                routing_policy="prefix-affinity")
                client = await _start_router(stack, router)
                streams = kills = 0

                async def stream(session):
                    nonlocal streams
                    streams += 1
                    r = await client.post(
                        "/v1/completions",
                        json={"prompt": f"soak {session}",
                              "session_id": session, "max_tokens": 6,
                              "stream": True})
                    assert r.status == 200
                    payloads, done = _client_frames(r.body)
                    assert not any("error" in p for p in payloads)
                    texts = [p["choices"][0]["text"] for p in payloads]
                    assert done and texts == FULL_TEXT, (session, texts)

                for rnd in range(9):
                    if rnd % 3 == 0:
                        configure_faults(
                            "replica_kill_midstream:after=2,times=1")
                        kills += 1
                    for j in range(3):
                        await stream(f"p1-{rnd}-{j}")
                    configure_faults(None)
                assert router.failovers_total["import"] == kills
                assert router.failovers_total["failed"] == 0
                all_resumes = [r for rs in resumes for r in rs]
                assert len(all_resumes) == kills
                assert all(r["envelope"]["relayed_token_ids"] == TOKENS[:2]
                           for r in all_resumes)

                keys = [f"soak-key-{i}".encode() for i in range(30)]

                def owners():
                    return {k: router._pick(affinity_key=k).url
                            for k in keys}

                baseline = owners()
                by_owner: dict = {}
                for k, u in baseline.items():
                    by_owner.setdefault(u, []).append(k)
                for cycle in range(N):
                    down_url = urls[cycle]
                    before = {u: len(served[u]) for u in urls}
                    configure_faults(f"replica_down:value={cycle}")
                    for r in router.replicas:
                        await router._check(r, startup=True)
                    configure_faults(None)
                    assert not router.replicas[cycle].healthy
                    churned = owners()
                    moved = {k for k in keys if churned[k] != baseline[k]}
                    assert moved == set(by_owner[down_url]), \
                        f"cycle {cycle}: non-owned keys remapped"
                    assert len(moved) <= 2 * len(keys) // N
                    for k in moved:
                        assert churned[k] == next(
                            u for u in router.ring.walk(k) if u != down_url)
                    for j in range(3):
                        await stream(f"p2-{cycle}-{j}")
                    assert len(served[down_url]) == before[down_url]
                    router.replicas[cycle].benched_until = 0.0
                    for r in router.replicas:
                        await router._check(r)
                    assert router.replicas[cycle].healthy
                    assert owners() == baseline, \
                        f"cycle {cycle}: owners did not return"

                victim = router.replicas[0]
                for trip in (1, 2):
                    for _ in range(3):
                        router._count_failure(
                            victim, RuntimeError("soak: injected timeout"))
                    assert router.peer_scores.quarantined(victim.url)
                    assert (router.peer_scores.quarantines[victim.url]
                            == trip)
                    await router._check(victim)
                    assert router.peer_scores.quarantined(victim.url)
                    picked = {router._pick(affinity_key=k).url
                              for k in keys}
                    assert victim.url not in picked
                    before = len(served[victim.url])
                    for j in range(3):
                        await stream(f"p3-{trip}-{j}")
                    assert len(served[victim.url]) == before
                    assert router._retry_after_s() >= 1
                    router.peer_scores._until[victim.url] = 0.0
                    await router._check(victim)
                    assert not router.peer_scores.quarantined(victim.url)
                    assert (router.peer_scores.score(victim.url)
                            >= router.peer_scores.threshold)
                    assert owners() == baseline
                text = (await client.get("/metrics")).text()
                assert (f'kgct_peer_quarantines_total{{peer="{victim.url}"}}'
                        f" 2") in text
                quarantine_dumps = [e for e in
                                    router.flight.export()["events"]
                                    if e.get("kind") == "peer_quarantine"]
                assert len(quarantine_dumps) == 2
                assert streams == 9 * 3 + N * 3 + 2 * 3
                assert all(len(served[u]) > 0 for u in urls)
            finally:
                configure_faults(None)
                await _close(stack)
        asyncio.run(scenario())


# -- test_wire_integrity.py / test_qos.py: engine-free router state ---------

class TestRouterQuarantine:
    def _router(self):
        return Router(["http://a:1", "http://b:2"], health_interval_s=5.0)

    def test_pick_excludes_quarantined_until_desperation(self):
        r = self._router()
        r.peer_scores.record_corruption("http://a:1")
        for _ in range(4):
            assert r._pick().url == "http://b:2"
        urls = {r._pick(include_unhealthy=True).url for _ in range(8)}
        assert "http://a:1" in urls

    def test_retry_after_reflects_soonest_return(self):
        r = self._router()
        assert r._retry_after_s() == 5
        r.peer_scores.record_corruption("http://a:1")
        r.peer_scores.record_corruption("http://b:2")
        assert 1 <= r._retry_after_s() <= int(PEER_QUARANTINE_S) + 1
        assert r._retry_after_s() > 5

    def test_quarantine_counter_preseeded_in_metrics(self):
        r = self._router()
        text = asyncio.run(r.metrics(None)).body.decode()
        assert 'kgct_peer_quarantines_total{peer="http://a:1"} 0' in text
        r.peer_scores.record_corruption("http://a:1")
        assert ('kgct_peer_quarantines_total{peer="http://a:1"} 1'
                in asyncio.run(r.metrics(None)).body.decode())


class TestRouterQoS:
    def _router(self):
        return Router(["http://a", "http://b"],
                      qos_tiers=parse_qos_tiers(
                          '{"vip": {"priority": 5, "users": ["alice"]}, '
                          '"std": {}}'))

    def test_resolution_and_propagation(self):
        class Req:
            def __init__(self, headers):
                self.headers = headers
        r = self._router()
        assert r._qos_resolve(Req({"x-kgct-qos-tier": "std"}),
                              {"user": "alice"}) == ("std", "std")
        assert r._qos_resolve(Req({}), {"user": "alice"}) == ("vip", "vip")
        assert r._qos_resolve(Req({}), {"user": "bob"}) == ("vip", "vip")
        assert r._qos_resolve(Req({"x-kgct-qos-tier": "nope"}),
                              None) == (None, None)

    def test_tier_inflight_metrics_zero_safe(self):
        r = self._router()
        assert r.tier_inflight == {"vip": 0, "std": 0}
        assert Router(["http://a"]).tier_inflight == {}


# -- test_chaos.py::TestRouterChaos ----------------------------------------

async def _mini_replica(stack: list, response_delay_s=0.0,
                        metrics_delay_s=0.0, stream_stall_s=0.0,
                        sever_after_first=False):
    """``test_chaos.py``'s stand-in replica on the port's server.
    ``response_delay_s`` holds the head back (wedged before responding);
    ``stream_stall_s`` sends one chunk then goes silent;
    ``sever_after_first`` sends one chunk then closes the connection
    without the terminating chunk. Returns (url, completions received)."""
    received = []

    async def metrics(request):
        if metrics_delay_s:
            await asyncio.sleep(metrics_delay_s)
        return Response(
            text="# TYPE kgct_requests_total counter\nkgct_requests_total 1\n",
            content_type="text/plain")

    async def completions(request):
        received.append(request.body)
        if response_delay_s:
            await asyncio.sleep(response_delay_s)
        if stream_stall_s or sever_after_first:
            resp = StreamResponse()
            await resp.prepare(request)
            await resp.write(b"data: first\n\n")
            if sever_after_first:
                raise StreamSevered("severed after the first chunk")
            await asyncio.sleep(stream_stall_s)   # then silence
            return resp
        return json_response({"object": "completion", "ok": True})

    app = _health_app()
    app.add_get("/metrics", metrics)
    app.add_post("/v1/completions", completions)
    return await _serve_app(stack, app), received


class TestRouterChaos:
    def test_connect_fault_retried_with_backoff(self):
        async def scenario():
            stack = []
            try:
                url, _ = await _mini_replica(stack)
                router = Router([url], health_interval_s=9999,
                                connect_retries=2, retry_backoff_s=0.01)
                client = await _start_router(stack, router)
                configure_faults("router_connect:times=1")
                r = await client.post("/v1/completions", json={"prompt": "x"})
                assert r.status == 200
                assert r.json()["ok"] is True
                assert router.retries_total >= 1
            finally:
                await _close(stack)
        asyncio.run(scenario())

    def test_injected_hang_circuit_breaks_then_recovers(self):
        async def scenario():
            stack = []
            try:
                url, _ = await _mini_replica(stack)
                router = Router([url], health_interval_s=9999,
                                fail_threshold=1)
                client = await _start_router(stack, router)
                configure_faults("replica_hang:times=1")
                await client.post("/v1/completions", json={"prompt": "x"})
                assert not router.replicas[0].healthy
                r2 = await client.post("/v1/completions",
                                       json={"prompt": "x"})
                assert r2.status == 503
                assert r2.json()["error"]["type"] == "overloaded_error"
                assert int(r2.headers["Retry-After"]) >= 1
                assert router.replicas[0].benched_until > time.monotonic()
                await router._check(router.replicas[0])
                assert not router.replicas[0].healthy
                router.replicas[0].benched_until = 0.0
                await router._check(router.replicas[0])
                assert router.replicas[0].healthy
                r3 = await client.post("/v1/completions",
                                       json={"prompt": "x"})
                assert r3.status == 200
            finally:
                await _close(stack)
        asyncio.run(scenario())

    def test_wedged_replica_no_response_rebalances(self):
        async def scenario():
            stack = []
            try:
                stall_url, _ = await _mini_replica(stack,
                                                   response_delay_s=30.0)
                live_url, _ = await _mini_replica(stack)
                router = Router([stall_url, live_url],
                                health_interval_s=9999, fail_threshold=1,
                                response_timeout_s=0.3)
                client = await _start_router(stack, router)
                r = await client.post("/v1/completions", json={"prompt": "x"})
                assert r.status == 502
                assert not router.replicas[0].healthy
                for _ in range(3):
                    r = await client.post("/v1/completions",
                                          json={"prompt": "x"})
                    assert r.status == 200
            finally:
                await _close(stack)
        asyncio.run(scenario())

    def test_midstream_stall_circuit_breaks_and_rebalances(self):
        async def scenario():
            stack = []
            try:
                stall_url, _ = await _mini_replica(stack,
                                                   stream_stall_s=30.0)
                live_url, _ = await _mini_replica(stack)
                router = Router([stall_url, live_url],
                                health_interval_s=9999, fail_threshold=1,
                                stall_timeout_s=0.3)
                client = await _start_router(stack, router)
                r = await client.post("/v1/completions", json={"prompt": "x"})
                assert b"first" in r.body
                assert not router.replicas[0].healthy
                r2 = await client.post("/v1/completions",
                                       json={"prompt": "x"})
                assert r2.status == 200
                assert r2.json()["ok"] is True
            finally:
                await _close(stack)
        asyncio.run(scenario())

    def test_retry_rounds_reach_benched_replica(self):
        async def scenario():
            stack = []
            try:
                url, _ = await _mini_replica(stack)
                router = Router([url], health_interval_s=9999,
                                fail_threshold=1, connect_retries=2,
                                retry_backoff_s=0.01)
                client = await _start_router(stack, router)
                configure_faults("router_connect:times=1")
                r = await client.post("/v1/completions", json={"prompt": "x"})
                assert r.status == 200
                assert router.retries_total >= 1
            finally:
                await _close(stack)
        asyncio.run(scenario())

    def test_metrics_scrape_skips_stragglers(self):
        async def scenario():
            stack = []
            try:
                slow_url, _ = await _mini_replica(stack,
                                                  metrics_delay_s=30.0)
                fast_url, _ = await _mini_replica(stack)
                router = Router([slow_url, fast_url],
                                health_interval_s=9999,
                                metrics_timeout_s=0.2)
                client = await _start_router(stack, router)
                t0 = time.monotonic()
                text = (await client.get("/metrics")).text()
                assert time.monotonic() - t0 < 2.0, \
                    "one stalled replica must not hang the scrape"
                _assert_valid_exposition(text)
                assert f'kgct_requests_total{{replica="{fast_url}"' in text
                assert not any(
                    line.startswith("kgct_requests_total") and slow_url in line
                    for line in text.splitlines())
                errs = [ln for ln in text.splitlines() if ln.startswith(
                    "kgct_router_metrics_scrape_errors_total")]
                assert errs and int(errs[0].split()[-1]) == 1
            finally:
                await _close(stack)
        asyncio.run(scenario())

    def test_cold_start_probe_removes_dead_replica_immediately(self):
        async def scenario():
            stack = []
            try:
                url, _ = await _mini_replica(stack)
                router = Router(["http://127.0.0.1:1", url],
                                health_interval_s=9999)
                client = await _start_router(stack, router)
                assert router.replicas[0].healthy is False
                assert router.replicas[1].healthy is True
                r = await client.post("/v1/completions", json={"prompt": "x"})
                assert r.status == 200
            finally:
                await _close(stack)
        asyncio.run(scenario())


# -- test_serving.py::TestRouterFailover -----------------------------------

class TestRouterFailover:
    def test_failover_to_next_replica_before_streaming(self):
        """An upstream that refuses the connection is retried on the next
        healthy replica; the client sees a single successful response."""
        async def scenario():
            stack = []
            app = _health_app()

            async def ok(request):
                return json_response({"from": "live"})
            app.add_post("/v1/completions", ok)
            try:
                live = await _serve_app(stack, app)
                router = Router(["http://127.0.0.1:1", live],
                                health_interval_s=9999)
                client = await _start_router(stack, router)
                # A replica that PASSED its probes and died just before
                # the request: back in rotation.
                router.replicas[0].healthy = True
                router.replicas[0].consecutive_failures = 0
                r = await client.post("/v1/completions",
                                      json={"prompt": "x"})
                assert r.status == 200
                assert r.json()["from"] == "live"
            finally:
                await _close(stack)
        asyncio.run(scenario())


# -- what the transport changes ---------------------------------------------

@contextlib.contextmanager
def _blackhole():
    """A loopback listener whose accept queue is full: a connect to it gets
    no answer at all, as from a node that drops the SYN."""
    ls = socket.socket()
    ls.bind(("127.0.0.1", 0))
    ls.listen(0)
    filler = socket.create_connection(ls.getsockname(), timeout=5)
    try:
        yield f"http://127.0.0.1:{ls.getsockname()[1]}"
    finally:
        filler.close()
        ls.close()


class TestConnectPhase:
    @pytest.mark.parametrize("dead", ["refused", "blackholed"])
    def test_connect_failure_is_retried_on_the_next_replica(self, dead):
        """Nothing reached the first replica (refused, or no answer within
        ``connect_timeout_s``): the request goes to the next one, counted
        as a retry, and the live replica sees it once."""
        async def scenario():
            stack = []
            with contextlib.ExitStack() as holes:
                try:
                    first = ("http://127.0.0.1:1" if dead == "refused"
                             else holes.enter_context(_blackhole()))
                    live, received = await _mini_replica(stack)
                    router = Router([first, live], health_interval_s=9999,
                                    connect_timeout_s=0.2)
                    client = await _start_router(stack, router)
                    assert not router.replicas[0].healthy   # startup probe
                    router.replicas[0].healthy = True
                    router.replicas[0].consecutive_failures = 0
                    t0 = time.monotonic()
                    r = await client.post("/v1/completions",
                                          json={"prompt": "x"})
                    took = time.monotonic() - t0
                    assert r.status == 200 and r.json()["ok"] is True
                    assert router.retries_total == 1
                    assert len(received) == 1
                    assert took < 2.0
                    spans = [e for e in router.tracer.events()
                             if e.kind == "connect_retry"]
                    assert [e.args["replica"] for e in spans] == [first]
                finally:
                    await _close(stack)
        asyncio.run(scenario())

    def test_silent_replica_after_the_body_is_not_retried(self):
        """A replica that took the request and never answers may already be
        generating: 502 after ``response_timeout_s``, never a second send —
        exactly one request arrived upstream, across both replicas."""
        async def scenario():
            stack = []
            try:
                silent, got_silent = await _mini_replica(
                    stack, response_delay_s=30.0)
                live, got_live = await _mini_replica(stack)
                router = Router([silent, live], health_interval_s=9999,
                                response_timeout_s=0.3)
                client = await _start_router(stack, router)
                r = await client.post("/v1/completions",
                                      json={"prompt": "once"})
                assert r.status == 502
                assert r.json()["error"]["message"].startswith(
                    "upstream error")
                assert len(got_silent) + len(got_live) == 1
                assert got_silent == [b'{"prompt": "once"}']
                assert router.retries_total == 0
                assert router.replicas[0].consecutive_failures == 1
            finally:
                await _close(stack)
        asyncio.run(scenario())

    def test_stream_outlives_a_bounded_clients_wall_bound(self):
        """The router's proxy call has no wall bound (the client's default
        is 300 s), only the session's connect bound: a stream longer than a
        bounded call's bound (0.3 s here) is cut from that call and relayed
        whole by the router."""
        async def scenario():
            stack = []
            app = _health_app()

            async def trickle(request):
                resp = StreamResponse(
                    headers={"Content-Type": "text/event-stream"})
                await resp.prepare(request)
                for i in range(4):
                    await resp.write(b"data: {\"i\": %d}\n\n" % i)
                    await asyncio.sleep(0.25)
                await resp.write(b"data: [DONE]\n\n")
                return resp
            app.add_post("/v1/completions", trickle)
            try:
                url = await _serve_app(stack, app)
                router = Router([url], health_interval_s=9999,
                                connect_timeout_s=2.5)
                client = await _start_router(stack, router)
                assert router._session.connect_timeout_s == 2.5
                bounds = []
                _spy_requests(router, bounds, lambda kw: kw["timeout_s"])
                with pytest.raises(asyncio.TimeoutError):
                    async with ClientSession().post(
                            f"{url}/v1/completions", json={},
                            timeout_s=0.3) as r:
                        await r.read()
                r = await client.post("/v1/completions", json={
                    "prompt": "x", "stream": True})
                payloads, done = _client_frames(r.body)
                assert done and payloads == [{"i": i} for i in range(4)]
                assert bounds == [None]
                assert router.replicas[0].consecutive_failures == 0
            finally:
                await _close(stack)
        asyncio.run(scenario())

    def test_upstream_body_cut_short_ends_the_client_stream(self):
        """A replica whose chunked body ends without its last chunk: the
        relay reads ``ClientPayloadError``, ends the client's stream after
        what arrived and counts the failure against the replica."""
        async def scenario():
            stack = []
            try:
                url, _ = await _mini_replica(stack, sever_after_first=True)
                router = Router([url], health_interval_s=9999)
                client = await _start_router(stack, router)
                r = await client.post("/v1/completions",
                                      json={"prompt": "x"})
                assert r.status == 200 and r.body == b"data: first\n\n"
                assert router.replicas[0].consecutive_failures == 1
                aborts = [e.args for e in router.tracer.events()
                          if e.kind == "abort"]
                assert aborts and aborts[-1]["reason"] == "upstream_stall"
            finally:
                await _close(stack)
        asyncio.run(scenario())


# -- parity with the JAX router on the same inputs --------------------------

def test_hash_ring_owner_and_walk_equal_the_jax_ring():
    rng = np.random.default_rng(0)
    urls = [f"http://10.0.{rng.integers(256)}.{i}:8000" for i in range(4)]
    keys = [rng.bytes(int(rng.integers(1, 64))) for _ in range(500)]
    port, ref = HashRing(urls), JR.HashRing(urls)
    assert [port.owner(k) for k in keys] == [ref.owner(k) for k in keys]
    assert [list(port.walk(k)) for k in keys] == \
        [list(ref.walk(k)) for k in keys]
    assert all(R._stable_hash(k) == JR._stable_hash(k) for k in keys)


AFFINITY_BODIES = {
    "text": b'{"prompt": "the quick brown fox jumps over the lazy dog"}',
    "text-utf8": '{"prompt": "été — 日本語 '
                 'です ' + "x" * 200 + '"}',
    "text-in-list": b'{"prompt": ["a single string prompt"]}',
    "tokens": json.dumps({"prompt": list(range(100, 160))}).encode(),
    "tokens-short": b'{"prompt": [5, 6, 7]}',
    "tokens-mixed": b'{"prompt": [1, "a", 3]}',
    "chat": json.dumps({"messages": [
        {"role": "system", "content": "be brief " * 30},
        {"role": "user", "content": "hi"}]}).encode(),
    "session": b'{"prompt": "abc", "user": "u1", "session_id": "s1"}',
    "session-int": b'{"prompt": "abc", "session_id": 42}',
    "user": b'{"prompt": [1, 2], "user": "alice"}',
    "bool-session": b'{"session_id": true, "prompt": "p"}',
    "empty-session": b'{"session_id": "", "prompt": "p"}',
    "unparseable": b'{"prompt": ',
    "not-an-object": b"[1, 2, 3]",
    "empty": b"",
}


@pytest.mark.parametrize("name", sorted(AFFINITY_BODIES))
def test_affinity_key_equals_the_jax_routers(name):
    body = AFFINITY_BODIES[name]
    body = body.encode() if isinstance(body, str) else body
    for policy in ("prefix-affinity", "least-inflight"):
        for plen in (4, 32):
            port = Router(URLS, routing_policy=policy,
                          affinity_prefix_len=plen)
            ref = JR.Router(URLS, routing_policy=policy,
                            affinity_prefix_len=plen)
            for force in (False, True):
                assert port._affinity_key(body, force=force) == \
                    ref._affinity_key(body, force=force), (policy, plen)
            obj = Router._parse_json_dict(body)
            assert obj == JR.Router._parse_json_dict(body)
            assert Router._handoff_eligible(obj) == \
                JR.Router._handoff_eligible(obj)


@pytest.mark.parametrize("policy", ["least-inflight", "prefix-affinity"])
@pytest.mark.parametrize("tiers", [False, True], ids=["no-qos", "qos"])
def test_pick_sequence_equals_the_jax_routers(policy, tiers):
    """Both routers walk the same scripted fleet state (inflight, health,
    quarantine, per-tier ledgers, exclusions, desperation rounds, keys,
    tiers, the prefill pool): the same choices, pick classifications and
    counters, step by step."""
    pf = ["http://pf-0:8000", "http://pf-1:8000"]
    kw = dict(routing_policy=policy, balance_factor=1.25, prefill_urls=pf)
    port = Router(URLS, **kw, **({"qos_tiers": parse_qos_tiers(
        "default")} if tiers else {}))
    ref = JR.Router(URLS, **kw, **({"qos_tiers": jax_parse_qos_tiers(
        "default")} if tiers else {}))
    rng = np.random.default_rng(1)
    for step in range(300):
        loads = rng.integers(0, 4, len(URLS))
        healthy = rng.random(len(URLS)) > 0.2
        batch = rng.integers(0, 3, len(URLS))
        quarantine = URLS[int(rng.integers(len(URLS)))] \
            if rng.random() < 0.1 else None
        for router in (port, ref):
            for r, load, ok, b in zip(router.replicas, loads, healthy,
                                      batch):
                r.inflight, r.healthy = int(load), bool(ok)
                r.tier_inflight = {"batch": int(b)}
            if quarantine and not router.peer_scores.quarantined(quarantine):
                router.peer_scores.record_corruption(quarantine)
        args = {}
        if rng.random() < 0.7:
            args["affinity_key"] = f"key-{rng.integers(40)}".encode()
        if rng.random() < 0.3:
            args["exclude"] = {URLS[int(rng.integers(len(URLS)))]}
        if rng.random() < 0.15:
            args["include_unhealthy"] = True
        if tiers and rng.random() < 0.8:
            args["pick_tier"] = ("interactive", "batch")[
                int(rng.integers(2))]
        prefill = rng.random() < 0.2
        picks = []
        for router in (port, ref):
            extra = ({"pool": router.prefill_replicas,
                      "ring": router.prefill_ring} if prefill else {})
            got = router._pick(**args, **extra)
            picks.append((got.url if got else None, dict(router._pick_info)))
        assert picks[0] == picks[1], (step, args, prefill)
    for attr in ("affinity_requests_total", "affinity_hits_total",
                 "ring_remaps_total", "affinity_overflow_total",
                 "_pick_seq"):
        assert getattr(port, attr) == getattr(ref, attr), attr


async def _jax_router_url(stack_jax: list, router) -> str:
    ts = TestServer(router.build_app(), host="127.0.0.1")
    await ts.start_server()
    stack_jax.append(ts)
    return str(ts.make_url("")).rstrip("/")


def _series(text: str) -> tuple[set, set]:
    """(families named by TYPE lines, sample series without values)."""
    families = {ln.split()[2] for ln in text.splitlines()
                if ln.startswith("# TYPE")}
    series = {ln.rpartition(" ")[0] for ln in text.splitlines()
              if ln and not ln.startswith("#")}
    return families, series


@pytest.mark.parametrize("disagg", [False, True],
                         ids=["colocated", "disaggregated"])
def test_metrics_series_equal_the_jax_routers(disagg):
    """The same fleet of stand-in replicas behind both routers, one
    request each through them: the same metric families and series."""
    async def scenario():
        stack, stack_jax = [], []
        try:
            extra = ("# TYPE kgct_prefix_cache_hit_ratio gauge\n"
                     "kgct_prefix_cache_hit_ratio 0.5\n"
                     "# TYPE kgct_ttft_seconds histogram\n"
                     'kgct_ttft_seconds_bucket{le="+Inf"} 1\n'
                     "kgct_ttft_seconds_sum 0.1\n"
                     "kgct_ttft_seconds_count 1\n")
            urls = [(await _recording_replica(stack, extra))[0]
                    for _ in range(3)]
            main, pf = (urls[:2], urls[2:]) if disagg else (urls, None)
            kw = dict(health_interval_s=9999, prefill_urls=pf,
                      routing_policy="prefix-affinity")
            port_c = await _start_router(stack, Router(list(main), **kw))
            jax_c = _Client(await _jax_router_url(
                stack_jax, JR.Router(list(main), **kw)))
            texts = []
            for client in (port_c, jax_c):
                r = await client.post("/v1/completions", json={
                    "prompt": "same", "session_id": "s"})
                assert r.status == 200
                texts.append((await client.get("/metrics")).text())
            return texts
        finally:
            for ts in stack_jax:
                await ts.close()
            await _close(stack)
    port_text, jax_text = asyncio.run(scenario())
    _assert_valid_exposition(port_text)
    assert _series(port_text) == _series(jax_text)


# -- the module and its CLI --------------------------------------------------

def test_router_import_loads_neither_torch_nor_jax():
    """A router pod needs no card: without tiers the module, a Router and
    its app load neither ``torch`` nor ``jax`` (nor aiohttp or the JAX
    package)."""
    code = (
        "import sys\n"
        "from kubernetes_gpu_cluster_tpu_torch.serving.router import Router\n"
        "Router(['http://a:1', 'http://b:2'], routing_policy="
        "'prefix-affinity', prefill_urls=['http://c:3']).build_app()\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('torch', 'jax', 'jaxlib', 'aiohttp', 'numpy', "
        "'kubernetes_gpu_cluster_tpu')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _cli_flags(main) -> set:
    import io
    out = io.StringIO()
    with contextlib.redirect_stdout(out), pytest.raises(SystemExit):
        main(["--help"])
    return {w.rstrip(",") for w in out.getvalue().split()
            if w.startswith("--")}


def test_cli_help_lists_the_jax_clis_flags():
    flags = _cli_flags(R.main)
    assert flags == _cli_flags(JR.main)
    assert {"--replicas", "--prefill-replicas", "--routing-policy",
            "--affinity-prefix-len", "--balance-factor", "--qos-tiers",
            "--qos-default-tier", "--host", "--port"} <= flags


@pytest.mark.parametrize("argv,check", [
    ([], lambda r: r.routing_policy == "least-inflight"
     and [x.url for x in r.replicas] == ["http://a:1", "http://b:2"]
     and not r.prefill_replicas and r.qos_tiers == ()),
    (["--routing-policy", "prefix-affinity", "--affinity-prefix-len", "8",
      "--balance-factor", "2.0"],
     lambda r: (r.routing_policy, r.affinity_prefix_len, r.balance_factor)
     == ("prefix-affinity", 8, 2.0)),
    (["--prefill-replicas", "http://p:1,http://p:2/"],
     lambda r: [x.url for x in r.prefill_replicas]
     == ["http://p:1", "http://p:2"]),
    (["--qos-tiers", "default", "--qos-default-tier", "batch"],
     lambda r: [t.name for t in r.qos_tiers] == ["interactive", "batch"]
     and r.qos_default_tier == "batch"),
], ids=["defaults", "affinity", "prefill-pool", "qos"])
def test_cli_flags_build_the_router(argv, check):
    """Each flag reaches the Router the CLI serves; ``run_app`` gets SIGINT
    and SIGTERM."""
    seen = {}

    def serve(app, host, port, signals=()):
        seen.update(router=app._routes["/health"]["GET"].__self__,
                    host=host, port=port, signals=set(signals))

    with mock.patch.object(R, "run_app", serve):
        R.main(["--replicas", "http://a:1,http://b:2", "--port", "9", *argv])
    assert check(seen["router"])
    assert (seen["host"], seen["port"]) == ("0.0.0.0", 9)
    assert seen["signals"] == {signal.SIGINT, signal.SIGTERM}


@pytest.mark.parametrize("argv,match", [
    (["--qos-default-tier", "batch"], "requires --qos-tiers"),
    (["--qos-tiers", "default", "--qos-default-tier", "nope"],
     "not a configured tier"),
    (["--routing-policy", "round-robin"], "invalid choice"),
])
def test_cli_rejects_what_the_jax_cli_rejects(argv, match, capsys):
    for main in (R.main, JR.main):
        with pytest.raises(SystemExit):
            main(["--replicas", "http://a:1", *argv])
        assert match in capsys.readouterr().err


def test_cli_serves_a_stream_and_exits_0_on_sigterm():
    """``python -m ...serving.router`` in a subprocess in front of a
    stand-in replica: one streamed completion through it, then SIGTERM
    stops it cleanly."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]

    async def scenario():
        stack = []
        try:
            url, served = await _recording_replica(stack)
            proc = subprocess.Popen(
                [sys.executable, "-m",
                 "kubernetes_gpu_cluster_tpu_torch.serving.router",
                 "--replicas", url, "--host", "127.0.0.1",
                 "--port", str(port)],
                cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                env=dict(os.environ, PYTHONPATH=str(REPO)))
            try:
                client = _Client(f"http://127.0.0.1:{port}")
                for _ in range(200):
                    with contextlib.suppress(OSError):
                        if (await client.get("/health")).status == 200:
                            break
                    await asyncio.sleep(0.05)
                r = await client.post("/v1/completions", json={
                    "prompt": "via the cli", "stream": True})
                assert r.status == 200 and b"[DONE]" in r.body
                assert len(served) == 1
                proc.send_signal(signal.SIGTERM)
                out, _ = await asyncio.to_thread(proc.communicate,
                                                 timeout=30)
                return proc.returncode, out.decode()
            finally:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        finally:
            await _close(stack)
    rc, out = asyncio.run(scenario())
    assert rc == 0, out


# -- engine replicas: the port's and the JAX package's, one weight set -------

SCHED = dict(max_num_seqs=4, max_prefill_tokens=128, decode_buckets=(1, 2),
             prefill_buckets=(32, 64, 128), decode_window=4,
             mixed_batch_enabled=False, enable_prefix_caching=True)
REPLICAS = (("a", "both"), ("b", "both"), ("p", "prefill"),
            ("d", "decode"))
# (router package, replica package): the first is the reference's topology,
# the others the mixed fleet.
COMBOS = [("port", "port"), ("port", "jax"), ("jax", "port")]
COMBO_IDS = [f"{r}-router-{p}-replicas" for r, p in COMBOS]
# +100 on the 94 ids the byte tokenizer decodes to printable ASCII: the
# greedy pick stays the model's among them, and the text holds one
# character per token, so equal text is equal tokens.
ASCII = {str(t): 100 for t in range(36, 130)}


@pytest.fixture(scope="module")
def fleet():
    """Two ``both`` replicas, a ``prefill`` and a ``decode`` one of each
    package, on one debug-tiny fp32 weight set and one loop."""
    cfg = jax_model("debug-tiny")
    jp = JM.init_params(cfg, jax.random.key(5))
    tp = TM.params_from_numpy(jax.tree.map(np.asarray, jp),
                              get_model_config("debug-tiny"), "cpu")
    loop = asyncio.new_event_loop()
    stack, jax_servers = [], []
    out = {"loop": loop, "refs": {}}
    for name, role in REPLICAS:
        api = build_server(
            EngineConfig(model=get_model_config("debug-tiny"),
                         cache=CacheConfig(page_size=16, num_pages=96),
                         scheduler=SchedulerConfig(**SCHED)),
            params=tp, device="cpu", model_name="debug-tiny", role=role)
        url = loop.run_until_complete(_serve_app(stack, api.build_app()))
        out[("port", name)] = (api, url)
        japi = jax_build_server(
            JEngineConfig(model=cfg, cache=JCache(page_size=16,
                                                  num_pages=96),
                          scheduler=JSched(**SCHED)),
            params=jp, model_name="debug-tiny", role=role)
        jts = TestServer(japi.build_app(), host="127.0.0.1", loop=loop)
        loop.run_until_complete(jts.start_server())
        jax_servers.append(jts)
        out[("jax", name)] = (japi, str(jts.make_url("")).rstrip("/"))
    yield out
    for jts in jax_servers:
        loop.run_until_complete(jts.close())
    loop.run_until_complete(_close(stack))
    loop.close()


@contextlib.asynccontextmanager
async def _routed(fleet, kind: str, replicas: str, names, prefill=(), **kw):
    """A router of package ``kind`` over the ``replicas`` package's servers
    ``names`` (and prefill pool ``prefill``): (router, client)."""
    urls = [fleet[(replicas, n)][1] for n in names]
    pf = [fleet[(replicas, n)][1] for n in prefill] or None
    kw = dict(health_interval_s=9999, prefill_urls=pf, **kw)
    stack, jax_stack = [], []
    try:
        if kind == "port":
            router = Router(urls, **kw)
            client = await _start_router(stack, router)
        else:
            router = JR.Router(urls, **kw)
            client = _Client(await _jax_router_url(jax_stack, router))
        yield router, client
    finally:
        for ts in jax_stack:
            await ts.close()
        await _close(stack)


def _faults(kind: str):
    return configure_faults if kind == "port" else jax_configure_faults


def _body(seed: int, n_prompt: int, max_tokens: int, **kw) -> dict:
    prompt = np.random.default_rng(seed).integers(3, 500, n_prompt).tolist()
    return {"prompt": prompt, "max_tokens": max_tokens, "temperature": 0.0,
            "logit_bias": ASCII, **kw}


async def _stream(client: _Client, body: dict, on_first=None,
                  path="/v1/completions") -> bytes:
    """A streamed request read to its end; ``on_first`` is called once,
    right after the first whole frame arrived."""
    raw, called = b"", False
    async with client.sess.post(client.base + path,
                                json=dict(body, stream=True),
                                timeout_s=60) as r:
        assert r.status == 200, await r.text()
        while (piece := await r.readany()):
            raw += piece
            if on_first is not None and not called and b"\n\n" in raw:
                called = True
                on_first()
    return raw


def _stream_text(raw: bytes) -> tuple[str, bool, list]:
    payloads, done = _client_frames(raw)
    assert not any("error" in p for p in payloads), payloads
    return ("".join(p["choices"][0]["text"] for p in payloads), done,
            payloads)


def _reference(fleet, body: dict) -> dict:
    """The JAX colocated server's stream of ``body`` (replica ``a`` of the
    JAX package, asked directly): its text and normalized frames."""
    key = json.dumps(body, sort_keys=True)
    if key not in fleet["refs"]:
        client = _Client(fleet[("jax", "a")][1])
        raw = fleet["loop"].run_until_complete(_stream(client, body))
        text, done, frames = _stream_text(raw)
        assert done and len(text) == body["max_tokens"]
        fleet["refs"][key] = {"text": text, "frames": _norm(frames)}
    return fleet["refs"][key]


def _norm(frames: list) -> list:
    return [{k: v for k, v in f.items() if k not in ("id", "created")}
            for f in frames]


def _reset_drain(api, kind: str) -> None:
    """A drained test server serves again (a real pod would exit)."""
    api.drain_state = DrainState() if kind == "port" else JDrainState()
    api.hub.drain = api.drain_state


def _flight_kinds(api) -> list:
    return [e["kind"] for e in api.engine.engine.obs.flight.export()
            ["events"]]


@pytest.mark.parametrize("combo", COMBOS, ids=COMBO_IDS)
class TestLiveMigrationServing:
    """``test_migration.py::TestLiveMigrationServing`` (``slow`` in the
    reference; a few seconds here): two colocated replicas behind the
    router; a stream outlives its replica through drain migration (parked
    KV, ``import``) and through a mid-stream kill (token replay,
    ``recompute``), equal to the JAX colocated server's run."""

    def test_drain_migrates_stream_to_peer_import(self, fleet, combo):
        rk, pk = combo
        body = _body(31 + COMBOS.index(combo), 40, 48)
        ref = _reference(fleet, body)
        apis = [fleet[(pk, n)][0] for n in "ab"]
        before = [dict(a.migration.migrations) for a in apis]

        async def go():
            async with _routed(fleet, rk, pk, "ab") as (router, client):
                drains = []

                def on_first():
                    src = next(a for a in apis
                               if a.engine.engine.has_unfinished_requests())
                    drains.append((src, src.begin_drain()))
                raw = await _stream(client, body, on_first=on_first)
                src, task = drains[0]
                await asyncio.wait_for(task, timeout=30)
                return raw, src, dict(router.failovers_total)
        raw, src, failovers = fleet["loop"].run_until_complete(go())
        _reset_drain(src, pk)
        dst = next(a for a in apis if a is not src)
        text, done, _ = _stream_text(raw)
        assert done and text == ref["text"]
        assert failovers == {"import": 1, "recompute": 0, "failed": 0}
        i_src, i_dst = apis.index(src), apis.index(dst)
        assert src.migration.migrations[("push", "ok")] == \
            before[i_src].get(("push", "ok"), 0) + 1
        assert dst.migration.migrations[("recv", "ok")] == \
            before[i_dst].get(("recv", "ok"), 0) + 1
        assert "migrate" in _flight_kinds(src)
        assert "migrate" in _flight_kinds(dst)

    def test_kill_midstream_recomputes_on_successor(self, fleet, combo):
        rk, pk = combo
        body = _body(41 + COMBOS.index(combo), 40, 24)
        ref = _reference(fleet, body)

        async def go():
            async with _routed(fleet, rk, pk, "ab") as (router, client):
                _faults(rk)("replica_kill_midstream:after=2,times=1")
                try:
                    raw = await _stream(client, body)
                finally:
                    _faults(rk)(None)
                return raw, dict(router.failovers_total)
        raw, failovers = fleet["loop"].run_until_complete(go())
        text, done, _ = _stream_text(raw)
        assert done and text == ref["text"]
        assert failovers == {"import": 0, "recompute": 1, "failed": 0}


@pytest.mark.parametrize("combo", COMBOS, ids=COMBO_IDS)
class TestDisaggServing:
    """``test_disagg.py::TestDisaggServing`` (``slow`` in the reference):
    a prefill and a decode replica behind the router give the colocated
    server's greedy tokens (the JAX package's) and seeded tokens (the
    decode replica's package), with the handoff counted and traced on both
    sides."""

    def test_role_split_pools_byte_identical_to_colocated(self, fleet,
                                                          combo):
        rk, pk = combo
        greedy = _body(5, 40, 8)
        seeded = dict(greedy, temperature=0.9, top_k=30, seed=11)
        pf_api, pf_url = fleet[(pk, "p")]
        dc_api, dc_url = fleet[(pk, "d")]
        colo = _Client(fleet[(pk, "a")][1])
        ex0 = pf_api.disagg.handoffs.get(("export", "ok"), 0)
        im0 = dc_api.disagg.handoffs.get(("import", "ok"), 0)

        async def text_of(client, body):
            r = await client.post("/v1/completions", json=body)
            assert r.status == 200, r.text()
            return r.json()["choices"][0]["text"]

        async def go():
            ref_s = await text_of(colo, seeded)
            async with _routed(fleet, rk, pk, "d", prefill="p") as (_, c):
                return (await text_of(c, greedy), await text_of(c, seeded),
                        ref_s, await c.get("/metrics"))
        got_g, got_s, ref_s, metrics = fleet["loop"].run_until_complete(go())
        assert got_g == _reference(fleet, greedy)["text"]
        assert got_s == ref_s and len(got_s) == 8
        assert pf_api.disagg.handoffs[("export", "ok")] == ex0 + 2
        assert dc_api.disagg.handoffs[("import", "ok")] == im0 + 2
        text = metrics.text()
        _assert_valid_exposition(text)
        assert f'kgct_engine_role{{replica="{dc_url}",role="decode"}} 1' \
            in text
        assert f'kgct_engine_role{{replica="{pf_url}",role="prefill"}} 1' \
            in text
        assert "handoff" in _flight_kinds(dc_api)
        assert "handoff" in _flight_kinds(pf_api)


@pytest.mark.parametrize("combo", COMBOS, ids=COMBO_IDS)
def test_prefix_affinity_session_sticks_to_one_warm_replica(fleet, combo):
    """Three streamed turns of one session (``session_id``), sharing a
    64-token prefix: one replica serves them all (affinity hits 3), its
    prefix cache hits on the warm turns, and every turn's frames equal the
    JAX colocated server's."""
    rk, pk = combo
    prefix = _body(61 + COMBOS.index(combo), 64, 8)["prompt"]
    turns = [dict(_body(70 + i, 8, 8), prompt=prefix + _body(
        70 + i, 8, 8)["prompt"], session_id=f"conv-{rk}-{pk}")
        for i in range(3)]
    refs = [_reference(fleet, dict(t, session_id=None)) for t in turns]
    apis = {fleet[(pk, n)][1]: fleet[(pk, n)][0] for n in "ab"}
    hits0 = {u: a.engine.engine.scheduler.prefix_cache.hits
             for u, a in apis.items()}

    async def go():
        async with _routed(fleet, rk, pk, "ab",
                           routing_policy="prefix-affinity") as (router, c):
            raws = [await _stream(c, t) for t in turns]
            picks = {e.args["replica"] for e in router.tracer.events()
                     if e.kind == "pick"}
            return raws, picks, router.affinity_hits_total
    raws, picks, hits = fleet["loop"].run_until_complete(go())
    assert hits == 3 and len(picks) == 1
    [owner] = picks
    assert apis[owner].engine.engine.scheduler.prefix_cache.hits \
        >= hits0[owner] + 2
    for raw, ref in zip(raws, refs):
        text, done, frames = _stream_text(raw)
        assert done and text == ref["text"]
        assert _norm(frames) == ref["frames"]


@pytest.mark.parametrize("replicas", ["port", "jax"])
def test_client_leaving_midstream_aborts_the_replica_request(
        fleet, replicas, monkeypatch):
    """The client closes after the first frame: the port's router closes
    the upstream connection, the replica aborts its engine request long
    before its 300 tokens, the in-flight slot is released and nothing is
    counted against the replica."""
    api, url = fleet[(replicas, "a")]
    produced = {}
    inner = api.engine.generate

    async def generate(rid, ids, params, **kw):
        async for chunk in inner(rid, ids, params, **kw):
            produced[rid] = len(chunk.output_token_ids)
            yield chunk
    monkeypatch.setattr(api.engine, "generate", generate)
    body = _body(91, 20, 300)

    async def go():
        async with _routed(fleet, "port", replicas, "a") as (router, c):
            async with c.sess.post(c.base + "/v1/completions",
                                   json=dict(body, stream=True),
                                   headers={REQUEST_ID_HEADER: "req-leave"},
                                   timeout_s=60) as r:
                assert r.status == 200
                assert b"data: " in await r.readany()
            eng = api.engine.engine
            for _ in range(400):
                if not eng.has_unfinished_requests() \
                        and router.replicas[0].inflight == 0:
                    break
                await asyncio.sleep(0.025)
            rep = router.replicas[0]
            aborts = [e.args.get("reason") for e in router.tracer.events()
                      if e.kind == "abort"]
            return (eng.has_unfinished_requests(), rep.inflight,
                    rep.consecutive_failures, rep.healthy,
                    router.peer_scores.score(rep.url), aborts)
    busy, inflight, failures, healthy, score, aborts = \
        fleet["loop"].run_until_complete(go())
    assert not busy and inflight == 0
    assert 0 < produced["req-leave"] < 300
    assert (failures, healthy, score) == (0, True, 1.0)
    assert aborts == ["client_disconnect"]


class TestRouter:
    """``test_serving.py::TestRouter`` against the port's server."""

    def test_routes_and_failover(self, fleet):
        real = fleet[("port", "a")][1]

        async def go():
            stack = []
            try:
                router = Router([real, "http://127.0.0.1:1"],
                                health_interval_s=0.1)
                client = await _start_router(stack, router)
                await asyncio.sleep(0.35)   # health loop marks dead replica
                body = (await client.get("/health")).json()
                assert body["replicas"][real]["healthy"] is True
                assert body["replicas"]["http://127.0.0.1:1"]["healthy"] \
                    is False
                r = await client.post("/v1/completions", json={
                    "prompt": "via router", "max_tokens": 4,
                    "temperature": 0.0})
                assert r.status == 200
                assert r.json()["choices"][0]["text"] is not None
                text = (await client.get("/metrics")).text()
                assert "kgct_router_replica_healthy" in text
                _assert_valid_exposition(text)
            finally:
                await _close(stack)
        fleet["loop"].run_until_complete(go())
