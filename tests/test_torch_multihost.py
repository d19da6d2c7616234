"""The port's ``serving/multihost.py`` under chaos, on the CPU:
``tests/test_chaos.py``'s ``TestMultihostLeader`` and
``TestMultihostFollower`` re-pointed at the port.

- Leader: the port's server (``serving/http.py``) over an
  ``AsyncLLMEngine`` whose ``DirectiveLeader`` broadcasts to a fake
  follower (a TCP sink); ``broadcast_fail`` mid-generation fails the
  in-flight request, group-aborts it (the flight recorder dumps the
  trigger), detaches the leader, and the single-device rank serves on.
- Follower: a closed or silent leader channel group-aborts the follower's
  requests and flips its liveness-tied ``/health`` to 503; heartbeats keep
  an idle follower alive; a stop directive with requests still in flight
  (a leader that detached after a failed broadcast) group-aborts them too,
  while an idle one stops cleanly.
- The follower address contract of ``follower_addrs_from_env`` and the
  port's handoff gates under a leader.
- The server's start-time refusal: a layout whose ranks need more cards
  than the pod sees exits before any rank starts or weight loads; a
  layout that fits, the CPU and one ``--distributed`` rank a pod go on.
"""

from __future__ import annotations

import asyncio
import dataclasses
import subprocess
import json
import socket
import threading
import time
import types
import urllib.error
import urllib.request

import pytest
import torch

from kubernetes_gpu_cluster_tpu_torch.engine import SamplingParams
from kubernetes_gpu_cluster_tpu_torch.resilience import (LoopLiveness,
                                                         configure_faults)
from kubernetes_gpu_cluster_tpu_torch.serving import api_server
from kubernetes_gpu_cluster_tpu_torch.serving.api_server import build_server
from kubernetes_gpu_cluster_tpu_torch.serving.multihost import (
    CONTROL_PORT, DirectiveFollower, DirectiveLeader, follower_addrs_from_env,
    serve_follower_health)
from test_torch_api_server import port_config, start_port_server
from test_torch_resilience import _complete

torch.set_num_threads(2)

pytestmark = pytest.mark.chaos


@pytest.fixture(autouse=True)
def _clear_faults():
    configure_faults(None)
    yield
    configure_faults(None)


@pytest.fixture(scope="module")
def leader_client():
    """The port's API server whose engine broadcasts step directives to a
    fake follower (a TCP sink): the leader path without a second engine."""
    srv = socket.create_server(("127.0.0.1", 0))
    port = srv.getsockname()[1]
    stop = threading.Event()

    def _sink():
        srv.settimeout(10)
        try:
            conn, _ = srv.accept()
        except OSError:
            return
        conn.settimeout(0.1)
        with conn:
            while not stop.is_set():
                try:
                    if not conn.recv(1 << 16):
                        return
                except socket.timeout:
                    continue
                except OSError:
                    return

    t = threading.Thread(target=_sink, daemon=True)
    t.start()
    leader = DirectiveLeader([f"127.0.0.1:{port}"], heartbeat_interval_s=0)
    server = build_server(port_config(), model_name="debug-tiny",
                          device="cpu", leader=leader)
    loop, client, stop_server = start_port_server(server)
    yield loop, client, server
    stop.set()
    stop_server()
    srv.close()


class TestMultihostLeader:
    def test_handoff_routes_refused_under_a_leader(self, leader_client):
        """KV handoff, migration pushes and resumes are off under a leader
        (an import on rank 0 alone would leave the followers behind)."""
        loop, client, server = leader_client
        assert server.engine.leader is not None
        assert server._handoff_ok is False

        async def go():
            r = await client.post("/internal/kv_handoff",
                                  json={"prompt": "hi", "max_tokens": 1})
            assert r.status == 404
            r = await client.post("/internal/resume", json={})
            assert r.status == 404
            # A direct caller's handoff arguments raise rather than being
            # dropped (a dropped resume would replay relayed tokens).
            sp = SamplingParams(max_tokens=1, temperature=0.0)
            for kw in (dict(handoff={}), dict(hold_kv=True),
                       dict(arrival_t0=0.0), dict(resume_outputs=[5])):
                with pytest.raises(ValueError, match="multihost leader"):
                    async for _ in server.engine.generate(
                            f"direct-{next(iter(kw))}", [1, 2, 3], sp, **kw):
                        pass
            assert not server.engine.engine.has_unfinished_requests()
        loop.run_until_complete(go())

    def test_broadcast_fail_group_aborts_and_leader_stays_serveable(
            self, leader_client, monkeypatch, tmp_path):
        loop, client, server = leader_client
        monkeypatch.setenv("KGCT_FLIGHT_DIR", str(tmp_path))

        async def go():
            # Healthy lockstep first: broadcasts reach the fake follower.
            r = await _complete(client)
            assert r.status == 200
            assert server.engine.leader is not None
            # Kill the "rank": the 3rd broadcast of the next request (add,
            # then steps) raises — mid-generation, with work in flight.
            configure_faults("broadcast_fail:after=2,times=1")
            r2 = await _complete(client, max_tokens=32)
            assert r2.status >= 500     # in-flight waiter failed loudly
            # Group-abort left no orphaned device work behind...
            eng = server.engine.engine
            deadline = time.monotonic() + 5
            while eng.has_unfinished_requests() and \
                    time.monotonic() < deadline:
                await asyncio.sleep(0.02)
            assert not eng.has_unfinished_requests()
            # ...the broken channel is detached, and a single-device rank
            # serves on.
            assert server.engine.leader is None
            r3 = await _complete(client)
            assert r3.status == 200
            # The group-abort auto-dumped the flight recorder with the
            # triggering event and the in-flight work it found.
            [dump] = sorted(tmp_path.glob("flight-group_abort-*.json"))
            doc = json.loads(dump.read_text())
            assert doc["reason"] == "group_abort"
            trigger = [e for e in doc["events"]
                       if e["kind"] == "group_abort"]
            assert trigger and trigger[-1]["requests"] >= 1
            assert any(e["kind"] == "arrival" for e in doc["events"])
        loop.run_until_complete(go())


class _RecordingEngine:
    """Duck-typed LLMEngine for follower-side protocol tests."""

    def __init__(self):
        self.added, self.aborted = [], []
        self.steps = 0
        self.scheduler = types.SimpleNamespace(waiting=[], running=[])

    def add_request(self, rid, ids, params):
        self.added.append(rid)
        self.scheduler.running.append(
            types.SimpleNamespace(request_id=rid))

    def abort_request(self, rid):
        self.aborted.append(rid)
        self.scheduler.running = [
            s for s in self.scheduler.running if s.request_id != rid]
        return True

    def has_unfinished_requests(self):
        return bool(self.scheduler.running or self.scheduler.waiting)

    def step(self):
        self.steps += 1
        return []


def _directive(adds=(), aborts=(), stop=False):
    payload = {"adds": [[rid, ids, dataclasses.asdict(params)]
                        for rid, ids, params in adds],
               "aborts": list(aborts)}
    if stop:
        payload["stop"] = True
    return (json.dumps(payload) + "\n").encode()


def _health_status(hport: int) -> int:
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{hport}/health", timeout=2) as r:
            return r.status
    except urllib.error.HTTPError as e:
        return e.code


def _start_follower(liveness, timeout_s):
    follower = DirectiveFollower(port=0, host="127.0.0.1")
    engine = _RecordingEngine()
    t = threading.Thread(
        target=follower.run,
        kwargs=dict(engine=engine, liveness=liveness,
                    liveness_timeout_s=timeout_s),
        daemon=True)
    t.start()
    return follower, engine, t


class TestMultihostFollower:
    def test_leader_close_group_aborts_and_health_flips(self):
        liveness = LoopLiveness(timeout_s=30)
        health = serve_follower_health(0, host="127.0.0.1",
                                       liveness=liveness)
        hport = health.server_address[1]
        follower, engine, t = _start_follower(liveness, 5.0)
        conn = socket.create_connection(("127.0.0.1", follower.port),
                                        timeout=2)
        conn.sendall(_directive(
            adds=[("r1", [1, 2, 3], SamplingParams(max_tokens=4))]))
        deadline = time.monotonic() + 2
        while "r1" not in engine.added and time.monotonic() < deadline:
            time.sleep(0.01)
        assert engine.added == ["r1"] and engine.steps == 1
        assert _health_status(hport) == 200
        # Leader dies mid-flight: the follower group-aborts r1, exits its
        # loop, and its health endpoint goes 503 for kubelet to restart it.
        conn.close()
        t.join(timeout=2)
        assert not t.is_alive()
        assert engine.aborted == ["r1"]
        assert not engine.has_unfinished_requests()
        assert _health_status(hport) == 503
        health.shutdown()

    def test_leader_silence_past_liveness_timeout_aborts(self):
        liveness = LoopLiveness(timeout_s=30)
        follower, engine, t = _start_follower(liveness, 0.2)
        conn = socket.create_connection(("127.0.0.1", follower.port),
                                        timeout=2)
        conn.sendall(_directive(
            adds=[("r1", [1], SamplingParams(max_tokens=4))]))
        # Keep the socket open but silent: no directives, no heartbeats.
        t.join(timeout=2)
        assert not t.is_alive(), "follower must declare a silent leader dead"
        assert engine.aborted == ["r1"]
        assert not liveness.alive()
        conn.close()

    def test_heartbeats_keep_idle_follower_alive(self):
        liveness = LoopLiveness(timeout_s=30)
        follower, engine, t = _start_follower(liveness, 0.3)
        leader = DirectiveLeader([f"127.0.0.1:{follower.port}"],
                                 heartbeat_interval_s=0.05)
        # First broadcast connects and starts the heartbeat thread.
        leader.broadcast([], [])
        # Idle for > liveness timeout: heartbeats alone keep it alive.
        time.sleep(0.6)
        assert t.is_alive()
        assert liveness.alive()
        assert engine.aborted == []
        leader.close()                    # stop directive: clean exit
        t.join(timeout=2)
        assert not t.is_alive()
        assert engine.aborted == []
        assert liveness.alive()

    def test_stop_with_work_in_flight_group_aborts(self):
        """A leader that detached after a failed broadcast sends stop while
        the follower still runs its requests: they are group-aborted and
        the health turns 503, as for a closed channel."""
        liveness = LoopLiveness(timeout_s=30)
        follower, engine, t = _start_follower(liveness, 5.0)
        conn = socket.create_connection(("127.0.0.1", follower.port),
                                        timeout=2)
        conn.sendall(_directive(
            adds=[("r1", [1, 2], SamplingParams(max_tokens=8)),
                  ("r2", [3], SamplingParams(max_tokens=8))]))
        conn.sendall(_directive(stop=True))
        t.join(timeout=2)
        assert not t.is_alive()
        assert sorted(engine.aborted) == ["r1", "r2"]
        assert not liveness.alive()
        assert "mid-flight" in liveness.reason
        conn.close()


class TestFollowerAddrs:
    def test_explicit_list_wins(self, monkeypatch):
        monkeypatch.setenv("KGCT_FOLLOWER_ADDRS", "a:1,b:2,")
        assert follower_addrs_from_env() == ["a:1", "b:2"]

    def test_statefulset_pattern(self, monkeypatch):
        monkeypatch.delenv("KGCT_FOLLOWER_ADDRS", raising=False)
        monkeypatch.delenv("KGCT_CONTROL_PORT", raising=False)
        monkeypatch.setenv("KGCT_COORDINATOR", "kgct-0.kgct-svc:8476")
        monkeypatch.setenv("KGCT_NUM_PROCESSES", "3")
        assert follower_addrs_from_env() == [
            f"kgct-1.kgct-svc:{CONTROL_PORT}",
            f"kgct-2.kgct-svc:{CONTROL_PORT}"]
        monkeypatch.setenv("KGCT_COORDINATOR", "10.0.0.1:8476")
        with pytest.raises(RuntimeError, match="KGCT_FOLLOWER_ADDRS"):
            follower_addrs_from_env()


class _Reached(Exception):
    """Raised where the server would join its group or build its engine:
    the start got past the refusal."""


class TestCardRefusal:
    """``_start_ranks`` refuses a layout whose ranks need more cards than
    ``torch.cuda.device_count()`` shows, before any child starts (no
    ``subprocess.Popen``) and before the engine or a weight exists."""

    @pytest.fixture
    def cards(self, monkeypatch):
        started = []

        def popen(cmd, **kw):
            started.append(cmd)
            return types.SimpleNamespace(pid=0, wait=lambda timeout=None: 0,
                                         kill=lambda: None)

        def reached(*a, **k):
            raise _Reached
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(subprocess, "Popen", popen)
        monkeypatch.setattr(api_server, "initialize_distributed", reached)
        monkeypatch.setattr(api_server, "build_server", reached)
        monkeypatch.setenv("GLOO_SOCKET_IFNAME", "lo")
        for k in ("KGCT_COORDINATOR", "KGCT_NUM_PROCESSES",
                  "KGCT_PROCESS_ID", "KGCT_CONTROL_PORT"):
            monkeypatch.delenv(k, raising=False)

        def with_cards(n):
            monkeypatch.setattr(torch.cuda, "device_count", lambda: n)
            return started
        return with_cards

    @pytest.mark.parametrize("n_cards,flags,pods,refusal", [
        (1, ["--tensor-parallel-size", "2"], None,
         "tp 2 x pp 1 (world 2) would start ranks [1] on this pod on cards "
         "cuda:1..cuda:1, but it sees 1 card(s)"),
        (2, ["--tensor-parallel-size", "2", "--pipeline-parallel-size", "2",
             "--distributed"], "1",
         "tp 2 x pp 2 (world 4) would start ranks [1, 2, 3] on this pod on "
         "cards cuda:1..cuda:3, but it sees 2 card(s)"),
    ], ids=["tp2-one-card", "multihost-pp2xtp2-two-cards"])
    def test_layout_beyond_the_cards_is_refused_before_any_rank(
            self, cards, monkeypatch, n_cards, flags, pods, refusal):
        started = cards(n_cards)
        if pods:
            monkeypatch.setenv("KGCT_COORDINATOR", "127.0.0.1:1")
            monkeypatch.setenv("KGCT_NUM_PROCESSES", pods)
        with pytest.raises(SystemExit) as exc:
            api_server.main(["--model", "debug-tiny", "--device", "cuda",
                             *flags])
        assert refusal in str(exc.value.code)
        assert started == []

    @pytest.mark.parametrize("n_cards,device,flags,pods,n_started", [
        (1, "cuda", [], None, 0),
        (1, "cpu", ["--tensor-parallel-size", "2"], None, 1),
        (1, "cuda", ["--tensor-parallel-size", "2", "--distributed"], "2", 0),
        (2, "cuda", ["--tensor-parallel-size", "2"], None, 1),
    ], ids=["tp1-cuda", "tp2-cpu", "one-distributed-rank-a-pod",
            "tp2-two-cards"])
    def test_layouts_that_fit_go_on(self, cards, monkeypatch, n_cards,
                                    device, flags, pods, n_started):
        started = cards(n_cards)
        if pods:
            monkeypatch.setenv("KGCT_COORDINATOR", "127.0.0.1:1")
            monkeypatch.setenv("KGCT_NUM_PROCESSES", pods)
        with pytest.raises(_Reached):
            api_server.main(["--model", "debug-tiny", "--device", device,
                             *flags])
        assert len(started) == n_started
        for cmd in started:
            # The rank's own --device follows the parent's argv.
            at = len(cmd) - cmd[::-1].index("--device")
            assert cmd[at] == ("cpu" if device == "cpu" else "cuda:1")
