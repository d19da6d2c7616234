"""The resilience pieces of the port (``resilience/``), held to the JAX
package's own cases re-pointed at the port's copies: admission-control
estimates and shedding, the histogram quantile it reads, the step watchdog,
drain transitions, loop liveness and the hub's exposition
(``tests/test_resilience.py``); per-tier admission
(``tests/test_qos.py::TestTierAdmission``); and the server-level chaos cases
of ``tests/test_chaos.py`` (``TestAdmissionShedding``, ``TestWatchdog``, and
``TestGracefulDrain``'s drain and SIGTERM cases) on the port's server on the
CPU. The live-migration drain cases are in ``tests/test_torch_fleet.py``.
Also the ``KGCT_FAULT`` grammar (``TestFaultGrammar``) against the port's
``resilience/faults.py``.
"""

import asyncio
import json
import math
import os
import signal
import time
import types

import pytest
import torch

from kubernetes_gpu_cluster_tpu_torch.config import (CacheConfig,
                                                     EngineConfig, QoSTier,
                                                     SchedulerConfig,
                                                     get_model_config)
from kubernetes_gpu_cluster_tpu_torch.engine import LLMEngine
from kubernetes_gpu_cluster_tpu_torch.observability.prometheus import \
    Histogram
from kubernetes_gpu_cluster_tpu_torch.resilience import (AdmissionController,
                                                         DrainState,
                                                         FaultInjector,
                                                         LoopLiveness,
                                                         ResilienceHub,
                                                         StepWatchdog,
                                                         configure_faults,
                                                         inject)
from kubernetes_gpu_cluster_tpu_torch.resilience.drain import (
    DRAINED, DRAINING, SERVING, drain_and_notify, install_sigterm_drain)
from kubernetes_gpu_cluster_tpu_torch.resilience.faults import fault_value
from kubernetes_gpu_cluster_tpu_torch.serving.api_server import (
    TTFT_BUDGET_HEADER, build_server)
from test_serving import _assert_valid_exposition
from test_torch_api_server import port_config, start_port_server

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _clear_faults():
    configure_faults(None)
    yield
    configure_faults(None)


class TestFaultGrammar:
    def test_multi_rule_spec(self):
        inj = FaultInjector("replica_hang:p=1;step_stall:after=10,delay=0.5")
        assert set(inj.rules) == {"replica_hang", "step_stall"}
        assert inj.rules["step_stall"].after == 10
        assert inj.rules["step_stall"].delay == 0.5

    def test_bad_param_rejected(self):
        with pytest.raises(ValueError, match="bad param"):
            FaultInjector("step_stall:bogus=1")
        with pytest.raises(ValueError, match="empty site"):
            FaultInjector(":p=1")
        with pytest.raises(ValueError, match="outside"):
            FaultInjector("x:p=2")
        with pytest.raises(ValueError, match="duplicate"):
            FaultInjector("x:p=1;x:p=1")

    def test_after_and_times(self):
        inj = FaultInjector("site:after=2,times=2")
        rule = inj.rules["site"]
        fires = [rule.should_fire() for _ in range(6)]
        # Skips the first 2 checks, fires exactly twice, then exhausted.
        assert fires == [False, False, True, True, False, False]

    def test_probability_deterministic_per_seed(self):
        a = FaultInjector("s:p=0.5,seed=7").rules["s"]
        b = FaultInjector("s:p=0.5,seed=7").rules["s"]
        seq_a = [a.should_fire() for _ in range(32)]
        seq_b = [b.should_fire() for _ in range(32)]
        assert seq_a == seq_b                      # same seed, same sequence
        assert any(seq_a) and not all(seq_a)       # actually probabilistic

    def test_inject_unarmed_is_free(self):
        configure_faults(None)
        assert inject("anything") is False
        assert fault_value("anything") is None

    def test_configure_and_value(self):
        configure_faults("queue_wait_est:value=12.5")
        assert fault_value("queue_wait_est") == 12.5
        configure_faults(None)
        assert fault_value("queue_wait_est") is None


class _FakeObs:
    def __init__(self):
        self.queue_wait = Histogram("kgct_queue_wait_seconds")
        self.step_duration = Histogram("kgct_step_seconds")


class _FakeScheduler:
    def __init__(self, depth=0):
        self.waiting = [object()] * depth


class _FakeEngine:
    def __init__(self, depth=0):
        self.obs = _FakeObs()
        self.scheduler = _FakeScheduler(depth)


class TestAdmissionController:
    def test_no_budget_admits_everything(self):
        adm = AdmissionController(_FakeEngine(depth=100))
        assert adm.check(None) is None
        assert adm.shed_total == 0

    def test_empty_queue_estimates_zero(self):
        eng = _FakeEngine(depth=0)
        eng.obs.queue_wait.observe(30.0)    # history says "slow"...
        adm = AdmissionController(eng, default_budget_ms=100)
        # ...but nothing is queued now: the next schedule admits immediately.
        assert adm.estimate_queue_wait_s() == 0.0
        assert adm.check(None) is None

    def test_sheds_when_history_blows_budget(self):
        eng = _FakeEngine(depth=4)
        for _ in range(10):
            eng.obs.queue_wait.observe(8.0)
        adm = AdmissionController(eng, default_budget_ms=1000)
        retry = adm.check(None)
        assert retry is not None
        assert 1 <= retry <= 60
        assert adm.shed_total == 1
        # An explicit generous budget is admitted.
        assert adm.check(60_000) is None

    def test_depth_term_leads_lagging_histogram(self):
        eng = _FakeEngine(depth=50)
        for _ in range(10):
            eng.obs.step_duration.observe(0.2)   # 50 deep x 0.2 s/step = 10 s
        adm = AdmissionController(eng, default_budget_ms=2000)
        assert adm.check(None) is not None
        assert adm.last_estimate_s >= 5.0

    def test_fault_forced_estimate(self):
        configure_faults("queue_wait_est:value=30")
        adm = AdmissionController(_FakeEngine(depth=0),
                                  default_budget_ms=1000)
        retry = adm.check(None)
        assert retry == 30
        assert adm.last_estimate_s == 30.0

    def test_windowed_quantile_forgets_old_overload(self):
        """A past overload episode must stop inflating the estimate once it
        leaves the sliding window — the lifetime histogram never decays, so
        the controller differences bucket counts against a rotating
        snapshot (and a recovered server stops shedding)."""
        eng = _FakeEngine(depth=2)
        for _ in range(50):
            eng.obs.queue_wait.observe(8.0)      # the bad old days
        adm = AdmissionController(eng, default_budget_ms=1000,
                                  window_s=0.01)
        assert adm.check(None) is not None       # history in first window
        # Rotate past the episode: two rotations age it out entirely.
        time.sleep(0.02)
        adm.estimate_queue_wait_s()
        time.sleep(0.02)
        adm.estimate_queue_wait_s()
        # Fresh window holds only fast waits now.
        eng.obs.queue_wait.observe(0.01)
        assert adm.check(None) is None
        # New slow observations inside the current window count again.
        for _ in range(50):
            eng.obs.queue_wait.observe(8.0)
        assert adm.check(None) is not None


class TestHistogramQuantile:
    def test_empty_is_zero(self):
        assert Histogram("h").quantile(0.9) == 0.0

    def test_interpolates_within_bucket(self):
        h = Histogram("h", buckets=(1.0, 2.0, 4.0))
        for _ in range(100):
            h.observe(1.5)      # all in the (1, 2] bucket
        q = h.quantile(0.5)
        assert 1.0 < q <= 2.0

    def test_merges_labelsets_and_clamps_tail(self):
        h = Histogram("h", buckets=(1.0, 2.0), labels=("outcome",))
        h.observe(0.5, ("finished",))
        h.observe(100.0, ("aborted",))     # above last finite bound
        assert h.quantile(0.99) == 2.0     # clamps to last finite bucket
        assert h.count == 2 and h.sum == pytest.approx(100.5)

    def test_monotone_in_q(self):
        h = Histogram("h", buckets=(0.1, 1.0, 10.0))
        for v in (0.05, 0.5, 0.5, 5.0):
            h.observe(v)
        qs = [h.quantile(q) for q in (0.1, 0.5, 0.9)]
        assert qs == sorted(qs)


class TestStepWatchdog:
    def test_trip_and_recover(self):
        trips = []
        wd = StepWatchdog(timeout_s=0.01, on_trip=lambda: trips.append(1))
        wd.arm()
        time.sleep(0.03)
        assert wd._check_once() is True
        assert not wd.healthy and wd.trips == 1 and trips == [1]
        # Same hung step does not double-count.
        assert wd._check_once() is False
        assert wd.trips == 1
        # The step finally completes: health recovers.
        wd.disarm()
        assert wd.healthy

    def test_no_trip_when_disarmed_or_fast(self):
        wd = StepWatchdog(timeout_s=0.05)
        assert wd._check_once() is False        # never armed
        wd.arm()
        assert wd._check_once() is False        # within deadline
        wd.disarm()
        assert wd.healthy and wd.trips == 0

    def test_watcher_thread_lifecycle(self):
        wd = StepWatchdog(timeout_s=0.02)
        wd.start()
        wd.start()      # idempotent
        wd.arm()
        deadline = time.monotonic() + 1.0
        while wd.healthy and time.monotonic() < deadline:
            time.sleep(0.005)
        assert not wd.healthy and wd.trips >= 1
        wd.disarm()
        wd.stop()


class TestDrain:
    def test_state_machine(self):
        d = DrainState()
        assert d.state == SERVING and d.gauge_value == 0
        assert not d.is_draining
        assert d.start_drain() is True
        assert d.start_drain() is False          # idempotent under SIGTERM x2
        assert d.state == DRAINING and d.gauge_value == 1 and d.is_draining
        d.mark_drained()
        assert d.state == DRAINED and d.gauge_value == 2

    def test_mark_drained_requires_draining(self):
        d = DrainState()
        d.mark_drained()
        assert d.state == SERVING    # no-op outside a drain

    def test_drain_and_notify_waits_for_idle(self):
        class _Eng:
            def __init__(self):
                self.calls = 0

            def has_unfinished_requests(self):
                self.calls += 1
                return self.calls < 3     # busy twice, then idle

        class _Async:
            def __init__(self):
                self.engine = _Eng()

        d = DrainState()
        d.start_drain()
        fired = []
        asyncio.run(drain_and_notify(d, _Async(), grace_s=5.0,
                                     on_drained=lambda: fired.append(1),
                                     poll_s=0.01))
        assert d.state == DRAINED and fired == [1]

    def test_drain_grace_lapses(self):
        class _Async:
            class engine:            # noqa: N801 - attribute shim
                @staticmethod
                def has_unfinished_requests():
                    return True      # never goes idle

        d = DrainState()
        d.start_drain()
        t0 = time.monotonic()
        asyncio.run(drain_and_notify(d, _Async(), grace_s=0.05, poll_s=0.01))
        assert d.state == DRAINED
        assert time.monotonic() - t0 < 1.0


class TestLoopLiveness:
    def test_starting_state_is_alive_indefinitely(self):
        # Before the first beat the loop is STARTING (a follower waits for
        # the leader's lazy connect, possibly minutes): never report dead.
        lv = LoopLiveness(timeout_s=0.05)
        time.sleep(0.08)
        assert lv.alive() and lv.reason == ""

    def test_beats_and_timeout(self):
        lv = LoopLiveness(timeout_s=0.05)
        lv.beat()
        assert lv.alive() and lv.reason == ""
        time.sleep(0.08)
        assert not lv.alive()
        assert "no heartbeat" in lv.reason
        lv.beat()
        assert lv.alive()

    def test_mark_dead_is_terminal(self):
        lv = LoopLiveness(timeout_s=10)
        lv.mark_dead("leader gone")
        assert not lv.alive() and lv.reason == "leader gone"
        lv.beat()
        assert not lv.alive()       # dead is dead until restart


class TestResilienceHub:
    def test_prometheus_lines(self):
        adm = AdmissionController(_FakeEngine())
        adm.shed_total = 3
        wd = StepWatchdog()
        wd.trips = 2
        drain = DrainState()
        drain.start_drain()
        lines = ResilienceHub(adm, wd, drain).render_prometheus()
        text = "\n".join(lines)
        assert "kgct_requests_shed_total 3" in text
        assert "kgct_watchdog_trips_total 2" in text
        assert "kgct_drain_state 1" in text
        # Every sample is a finite number (scrape-clean).
        for line in lines:
            if not line.startswith("#"):
                assert math.isfinite(float(line.rsplit(" ", 1)[1]))


# -- per-tier admission (tests/test_qos.py::TestTierAdmission) -------------

@pytest.fixture(scope="module")
def qos_engine():
    tiers = (QoSTier("interactive", weight=4.0, priority=10),
             QoSTier("batch", weight=1.0, priority=0))
    return LLMEngine(EngineConfig(
        model=get_model_config("debug-tiny"),
        cache=CacheConfig(page_size=4, num_pages=128),
        scheduler=SchedulerConfig(max_num_seqs=4, max_prefill_tokens=16,
                                  decode_buckets=(1, 2, 4, 8),
                                  prefill_buckets=(16, 32, 64),
                                  decode_window=2, mixed_batch_enabled=False,
                                  qos_tiers=tiers)),
        eos_token_id=None, device="cpu")


class TestTierAdmission:
    def _admission(self, engine):
        adm = AdmissionController(engine)
        adm.configure_tiers(
            (QoSTier("interactive", weight=4, priority=10,
                     max_concurrent=8),
             QoSTier("batch", weight=1, priority=0, max_concurrent=2)),
            "interactive")
        return adm

    def test_max_concurrent_sheds_only_its_tier(self, qos_engine):
        adm = self._admission(qos_engine)
        adm.on_admit("batch")
        adm.on_admit("batch")
        assert adm.check(None, tier="batch") is not None    # at budget
        assert adm.check(None, tier="interactive") is None  # untouched
        assert adm.shed_by_tier == {"interactive": 0, "batch": 1}
        adm.on_release("batch")
        assert adm.check(None, tier="batch") is None        # budget freed

    def test_tier_ttft_budget_applies_without_header(self, qos_engine):
        adm = AdmissionController(qos_engine)
        adm.configure_tiers(
            (QoSTier("strict", ttft_budget_ms=100.0),), "strict")
        configure_faults("queue_wait_est:value=30")
        try:
            # tier budget (100 ms) < forced 30 s estimate -> shed, and the
            # shed is attributed to the tier
            ra = adm.check(None, tier="strict")
            assert ra is not None and ra >= 1
            assert adm.shed_by_tier["strict"] == 1
            # an explicit per-request budget still wins over the tier's
            assert adm.check(120000.0, tier="strict") is None
        finally:
            configure_faults(None)

    @pytest.mark.chaos
    def test_tenant_flood_isolated_to_batch_tier(self, qos_engine):
        """The tenant_flood chaos site inflates the LOWEST-priority tier's
        offered load past its budget: every batch check sheds, the
        interactive tier's shed count stays 0, and the hub's per-tier
        series carries the attribution."""
        adm = self._admission(qos_engine)
        configure_faults("tenant_flood:value=8")
        try:
            for _ in range(5):
                assert adm.check(None, tier="batch") is not None
                assert adm.check(None, tier="interactive") is None
        finally:
            configure_faults(None)
        assert adm.shed_by_tier == {"interactive": 0, "batch": 5}
        wd = StepWatchdog(timeout_s=1000)
        lines = ResilienceHub(adm, wd, DrainState()).render_prometheus()
        text = "\n".join(lines)
        assert 'kgct_requests_shed_total{tier="batch"} 5' in text
        assert 'kgct_requests_shed_total{tier="interactive"} 0' in text
        assert "kgct_requests_shed_total 5" in text


# -- the server under chaos (tests/test_chaos.py) --------------------------

@pytest.fixture(scope="module")
def chaos_client():
    """One engine + server for the module; watchdog tight enough to catch an
    injected 0.6 s stall within the test's polling window."""
    server = build_server(port_config(watchdog_timeout_s=0.1), device="cpu",
                          model_name="debug-tiny")
    loop, client, stop = start_port_server(server)
    yield loop, client, server
    stop()


async def _complete(client, timeout_budget_ms=None, **body):
    body.setdefault("prompt", "hello")
    body.setdefault("max_tokens", 4)
    body.setdefault("temperature", 0.0)
    headers = {}
    if timeout_budget_ms is not None:
        headers[TTFT_BUDGET_HEADER] = str(timeout_budget_ms)
    return await client.post("/v1/completions", json=body, headers=headers)


@pytest.mark.chaos
class TestAdmissionShedding:
    def test_shed_429_with_retry_after(self, chaos_client):
        loop, client, server = chaos_client

        async def go():
            configure_faults("queue_wait_est:value=30")
            # Budget below the (forced) 30 s estimate: shed, not queued.
            t0 = time.monotonic()
            r = await _complete(client, timeout_budget_ms=1000)
            elapsed = time.monotonic() - t0
            assert r.status == 429
            assert elapsed < 1.0, "shed must be immediate, not queued"
            assert int(r.headers["Retry-After"]) >= 30
            err = (await r.json())["error"]
            assert err["type"] == "overloaded_error" and err["code"] == 429
            # Unbudgeted traffic is untouched (default budget is None).
            r2 = await _complete(client)
            assert r2.status == 200
            # Generous budget admits through the same estimate.
            r3 = await _complete(client, timeout_budget_ms=60_000)
            assert r3.status == 200
            configure_faults(None)
            assert server.admission.shed_total >= 1
        loop.run_until_complete(go())

    def test_invalid_budget_header_400(self, chaos_client):
        loop, client, _ = chaos_client

        async def go():
            r = await _complete(client, timeout_budget_ms="soon")
            assert r.status == 400
            r = await _complete(client, timeout_budget_ms=-5)
            assert r.status == 400
        loop.run_until_complete(go())

    def test_shed_counter_in_metrics(self, chaos_client):
        loop, client, _ = chaos_client

        async def go():
            r = await client.get("/metrics")
            text = await r.text()
            _assert_valid_exposition(text)
            shed = [l for l in text.splitlines()
                    if l.startswith("kgct_requests_shed_total")]
            assert shed and int(shed[0].split()[-1]) >= 1
            assert "kgct_watchdog_trips_total" in text
            assert "kgct_drain_state 0" in text
        loop.run_until_complete(go())


@pytest.mark.chaos
class TestWatchdog:
    def test_injected_stall_trips_health_then_recovers(self, chaos_client):
        loop, client, server = chaos_client

        async def go():
            configure_faults("step_stall:delay=0.6,times=1")
            task = asyncio.get_running_loop().create_task(
                _complete(client, max_tokens=2))
            # During the stalled step the watchdog (timeout 0.1 s) must flip
            # /health to 503.
            saw_503 = False
            for _ in range(40):
                r = await client.get("/health")
                if r.status == 503:
                    body = await r.json()
                    assert "watchdog" in body["status"]
                    saw_503 = True
                    break
                await asyncio.sleep(0.02)
            assert saw_503, "watchdog never tripped during injected stall"
            assert server.watchdog.trips >= 1
            # The stall ends; the request completes and health self-heals.
            r = await task
            assert r.status == 200
            for _ in range(40):
                r = await client.get("/health")
                if r.status == 200:
                    return
                await asyncio.sleep(0.02)
            raise AssertionError("health did not recover after stall ended")
        loop.run_until_complete(go())

    def test_watchdog_trip_dumps_flight_recorder(self, chaos_client,
                                                 monkeypatch, tmp_path):
        """A watchdog trip auto-dumps the black-box flight recorder: the
        file holds the triggering event plus the ring of events/snapshots
        that preceded the hang (the crash-capture contract)."""
        loop, client, server = chaos_client
        monkeypatch.setenv("KGCT_FLIGHT_DIR", str(tmp_path))

        async def go():
            configure_faults("step_stall:delay=0.6,times=1")
            task = asyncio.get_running_loop().create_task(
                _complete(client, max_tokens=2))
            dump = None
            for _ in range(80):
                dumps = sorted(tmp_path.glob("flight-watchdog_trip-*.json"))
                if dumps:
                    dump = dumps[0]
                    break
                await asyncio.sleep(0.025)
            r = await task
            assert r.status == 200
            assert dump is not None, "watchdog trip produced no dump"
            doc = json.loads(dump.read_text())
            assert doc["reason"] == "watchdog_trip"
            kinds = [e["kind"] for e in doc["events"]]
            assert "watchdog_trip" in kinds          # the trigger itself
            # The preceding seconds: lifecycle events and at least one
            # periodic state snapshot (queue depths / KV occupancy) from
            # the module's earlier traffic.
            assert "snapshot" in kinds
            snap = next(e for e in doc["events"] if e["kind"] == "snapshot")
            assert {"waiting", "running", "kv_pages_free"} <= set(snap)
            # Health recovers (the stall was transient).
            for _ in range(40):
                if (await client.get("/health")).status == 200:
                    return
                await asyncio.sleep(0.02)
            raise AssertionError("health did not recover after stall ended")
        loop.run_until_complete(go())


@pytest.mark.chaos
class TestGracefulDrain:
    def test_drain_finishes_inflight_and_rejects_new(self, chaos_client,
                                                     monkeypatch, tmp_path):
        loop, client, server = chaos_client
        monkeypatch.setenv("KGCT_FLIGHT_DIR", str(tmp_path))

        async def go():
            r = await client.post("/v1/completions", json={
                "prompt": "drain me", "max_tokens": 24, "temperature": 0.0,
                "stream": True})
            assert r.status == 200
            it = r.content.__aiter__()
            await it.__anext__()               # stream demonstrably started
            drained = []
            task = server.begin_drain(on_drained=lambda: drained.append(1))
            assert task is not None
            assert server.begin_drain() is None     # idempotent
            # Drain start auto-dumped the flight recorder (what was queued
            # or mid-stream when the SIGTERM landed outlives the pod).
            [dump] = sorted(tmp_path.glob("flight-sigterm_drain-*.json"))
            assert json.loads(dump.read_text())["reason"] == "sigterm_drain"
            # New admissions are rejected with the OpenAI envelope...
            r2 = await _complete(client)
            assert r2.status == 503
            err = (await r2.json())["error"]
            assert err["type"] == "overloaded_error"
            assert "Retry-After" in r2.headers
            # ...and /health flips so k8s takes the pod out of rotation.
            rh = await client.get("/health")
            assert rh.status == 503
            # The in-flight stream keeps going to [DONE].
            saw_done = False
            async for line in r.content:
                if line.decode().strip() == "data: [DONE]":
                    saw_done = True
            assert saw_done, "drain truncated an in-flight stream"
            await asyncio.wait_for(task, timeout=5)
            assert drained == [1]
            assert server.drain_state.gauge_value == 2
            rm = await client.get("/metrics")
            assert "kgct_drain_state 2" in await rm.text()
        loop.run_until_complete(go())
        # Reset for any later use of the module server: a real pod exits
        # after drain; the test server lives on.
        server.drain_state = DrainState()
        server.hub.drain = server.drain_state

    def test_sigterm_handler_drives_drain(self):
        import os
        import signal

        class _Eng:
            def has_unfinished_requests(self):
                return False

        shim = types.SimpleNamespace(engine=_Eng())

        async def scenario():
            loop = asyncio.get_running_loop()
            drain = DrainState()
            fired = []
            uninstall = install_sigterm_drain(
                loop, drain, shim, grace_s=1.0,
                on_drained=lambda: fired.append(1))
            try:
                os.kill(os.getpid(), signal.SIGTERM)
                deadline = time.monotonic() + 2.0
                while drain.gauge_value != 2 and time.monotonic() < deadline:
                    await asyncio.sleep(0.01)
                assert drain.gauge_value == 2 and fired == [1]
                # Repeat SIGTERM during/after drain is harmless.
                os.kill(os.getpid(), signal.SIGTERM)
                await asyncio.sleep(0.02)
            finally:
                uninstall()

        asyncio.run(scenario())
