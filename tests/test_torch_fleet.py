"""The fleet plane's replica side of the port, over real sockets on the CPU.

Every server here is the port's (``serving/api_server.py`` on
``serving/http.py``) or, in the mixed fleet, the JAX package's on aiohttp;
peer calls go through each package's own client, test requests through the
port's ``ClientSession``. Debug-tiny engines, fp32.

- The JAX package's replica-side HTTP cases, re-pointed at the port:
  ``test_fleet_cache.py``'s ``TestFleetHTTP`` and
  ``TestFleetOffByteIdentical``; ``test_wire_integrity.py``'s
  ``TestWireChaosHTTP`` and ``TestIntegrityOffByteIdentical``;
  ``test_chaos.py``'s ``TestResumeAndRecv`` and ``TestGracefulDrain``'s two
  live-migration cases; ``test_serving.py``'s ``TestKVHandoffOnWarmServer``;
  ``test_qos.py``'s ``TestKVHandoffTierGate``.
- A mixed fleet on one weight set: a JAX prefill replica with a port decode
  replica and the reverse, integrity on and off, each serving the JAX
  colocated server's greedy tokens; a drain push port -> JAX and
  JAX -> port, parked and resumed in ``import`` mode with the uninterrupted
  tokens; and the port's ``/metrics`` families equal to the JAX server's
  under every role.
- Each fleet option of ``build_server`` and each fleet flag of the CLI
  reaching a working server.
"""

import asyncio
import dataclasses
import json
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
# The JAX engine before its models: each imports the other.
from kubernetes_gpu_cluster_tpu.engine import LLMEngine  # noqa: F401
from kubernetes_gpu_cluster_tpu.models import llama as JM
from kubernetes_gpu_cluster_tpu.resilience.faults import \
    configure_faults as jax_configure_faults
from kubernetes_gpu_cluster_tpu.serving.api_server import \
    build_server as jax_build_server
from kubernetes_gpu_cluster_tpu_torch.config import (CacheConfig,
                                                     EngineConfig, QoSTier,
                                                     SchedulerConfig,
                                                     get_model_config)
from kubernetes_gpu_cluster_tpu_torch.models import llama as TM
from kubernetes_gpu_cluster_tpu_torch.resilience import (DrainState,
                                                         configure_faults)
from kubernetes_gpu_cluster_tpu_torch.serving import api_server as A
from kubernetes_gpu_cluster_tpu_torch.serving.api_server import build_server
from kubernetes_gpu_cluster_tpu_torch.serving.errors import (
    MIGRATE_URL_HEADER, PREFILL_URL_HEADER, PREFIX_SOURCE_HEADER,
    QOS_TIER_HEADER, REQUEST_ID_HEADER, RESUME_MODE_HEADER)
from kubernetes_gpu_cluster_tpu_torch.serving.fleet_cache import (
    PEER_QUARANTINE_THRESHOLD, PullPolicy, build_pull_policy)
from kubernetes_gpu_cluster_tpu_torch.serving.handoff import (
    PrefixStreamDecoder, decode_handoff, encode_handoff, encode_spill_frame)
from kubernetes_gpu_cluster_tpu_torch.serving.http import (ClientError,
                                                           ClientSession,
                                                           Server)
from test_serving import _assert_valid_exposition

torch.set_num_threads(2)

DEAD_PEER = "http://127.0.0.1:1"      # connection refused at once


@pytest.fixture(autouse=True)
def _clean_faults():
    configure_faults(None)
    jax_configure_faults(None)
    yield
    configure_faults(None)
    jax_configure_faults(None)


def _fleet_config():
    """``test_fleet_cache.py`` / ``test_wire_integrity.py``'s engine."""
    return EngineConfig(
        model=get_model_config("debug-tiny"),
        cache=CacheConfig(page_size=16, num_pages=96),
        scheduler=SchedulerConfig(max_num_seqs=4, max_prefill_tokens=128,
                                  decode_buckets=(1, 2),
                                  prefill_buckets=(32, 64, 128),
                                  decode_window=4, mixed_batch_enabled=False,
                                  enable_prefix_caching=True))


SERVING_SCHED = dict(max_num_seqs=4, max_prefill_tokens=256,
                     decode_buckets=(1, 2, 4), prefill_buckets=(128, 256),
                     decode_window=4)


def _serving_config():
    """``test_serving.py`` / ``test_chaos.py``'s engine."""
    return EngineConfig(model=get_model_config("debug-tiny"),
                        cache=CacheConfig(page_size=16, num_pages=128),
                        scheduler=SchedulerConfig(**SERVING_SCHED))


async def _serve(stack: list, cfg=None, **kw):
    """A port server on a free port of 127.0.0.1: (APIServer, base url)."""
    api = build_server(cfg or _fleet_config(), None, "debug-tiny",
                       device="cpu", **kw)
    server = Server(api.build_app())
    await server.start("127.0.0.1", 0)
    stack.append(server)
    return api, f"http://127.0.0.1:{server.port}"


async def _close(stack: list) -> None:
    for server in reversed(stack):
        await server.close()


async def _comp(sess, base, body, headers=None) -> str:
    async with sess.post(f"{base}/v1/completions", json=body,
                         headers=headers or {}) as resp:
        assert resp.status == 200, await resp.text()
        return (await resp.json())["choices"][0]["text"]


async def _stream(sess, url, body, headers=None, on_first=None) -> dict:
    """An SSE request read to its end or its severing: the data frames, the
    token ledger they carry (``kgct_token_ids``), the text, whether
    ``[DONE]`` came and whether the connection was cut mid-body.
    ``on_first`` is called once, right after the first frame arrived."""
    raw, severed, called = b"", False, False
    async with sess.post(url, json=body, headers=headers or {}) as resp:
        assert resp.status == 200, await resp.text()
        out = {"headers": dict(resp.headers)}
        try:
            async for piece in resp.iter_chunked(1 << 16):
                raw += piece
                if on_first is not None and not called \
                        and b"data: " in raw:
                    called = True
                    on_first()
        except ClientError:
            severed = True
    lines = [ln[len("data: "):] for ln in raw.decode().splitlines()
             if ln.startswith("data: ")]
    done = bool(lines) and lines[-1] == "[DONE]"
    frames = [json.loads(ln) for ln in lines if ln != "[DONE]"]
    out.update(frames=frames, done=done, severed=severed,
               ids=[t for f in frames for t in f.get("kgct_token_ids", [])],
               text="".join(f["choices"][0].get("text", "")
                            for f in frames if "choices" in f))
    return out


def _reset_drain(api) -> None:
    """A drained test server serves again (a real pod would exit)."""
    api.drain_state = DrainState()
    api.hub.drain = api.drain_state


def _prompt(seed, n=80):
    return np.random.default_rng(seed).integers(1, 200, n).tolist()


# -- test_fleet_cache.py ---------------------------------------------------

class TestFleetHTTP:
    """ONE two-server scenario: pull-on-hint is byte-identical and counted;
    the roofline gate skips; an out-of-pool hint and the kv_pull_fail
    chaos site both degrade to local recompute with the trigger in the
    trace ring and the flight recorder."""

    def test_pull_skip_allowlist_and_chaos(self):
        async def scenario():
            stack = []
            try:
                sa, ua = await _serve(stack, fleet_prefix_cache=True)
                sb, ub = await _serve(stack, fleet_prefix_cache=True,
                                      peer_pool=[ua])
                assert sa.fleet_on and sb.fleet_on
                pulls = sb.engine.engine.obs.fleet_pulls
                prompt = _prompt(7)
                body = {"prompt": prompt, "max_tokens": 6,
                        "temperature": 0.0}
                sess = ClientSession()

                async def comp(base, js, hint=None):
                    return await _comp(sess, base, js,
                                       {PREFIX_SOURCE_HEADER: hint}
                                       if hint else None)

                ref = await comp(ua, body)
                got = await comp(ub, body, hint=ua)
                assert got == ref
                assert pulls["ok"] == 1
                assert sb.engine.engine.scheduler.prefix_cache.hits >= 1
                await comp(ub, dict(body, prompt=prompt[:64] + [9, 9]),
                           hint=ua)
                assert pulls["skipped"] == 1 and pulls["ok"] == 1
                sb._pull_policy = PullPolicy(
                    link_bytes_per_s=1.0, flops_per_s=1e15,
                    kv_bytes_per_token=1e6, flops_per_token=1.0,
                    min_tokens=16)
                p2 = _prompt(8)
                await comp(ua, dict(body, prompt=p2))
                await comp(ub, dict(body, prompt=p2), hint=ua)
                assert pulls["skipped"] == 2 and pulls["ok"] == 1
                sb._pull_policy = build_pull_policy(
                    sb.engine.engine.model_config, 16, 4, "cpu")
                p3 = _prompt(9)
                ref3 = await comp(ua, dict(body, prompt=p3))
                got3 = await comp(ub, dict(body, prompt=p3),
                                  hint="http://169.254.0.1:1")
                assert got3 == ref3 and pulls["recompute"] == 1
                configure_faults("kv_pull_fail")
                p4 = _prompt(10)
                ref4 = await comp(ua, dict(body, prompt=p4))
                got4 = await comp(ub, dict(body, prompt=p4), hint=ua)
                configure_faults(None)
                assert got4 == ref4 and pulls["recompute"] == 2
                events = [e for e in sb.engine.engine.obs.tracer.events()
                          if e.kind == "fleet_prefix"]
                assert any(e.args.get("outcome") == "recompute"
                           and "kv_pull_fail" in e.args.get("error", "")
                           for e in events)
                flight = sb.engine.engine.obs.flight.export()["events"]
                assert any(e.get("kind") == "fleet_prefix"
                           and e.get("outcome") == "recompute"
                           for e in flight)
                async with sess.get(f"{ub}/metrics") as resp:
                    text = await resp.text()
                assert ('kgct_fleet_prefix_pulls_total'
                        '{outcome="ok"} 1') in text
                assert ('kgct_fleet_prefix_pulls_total'
                        '{outcome="recompute"} 2') in text
                assert ('kgct_fleet_prefix_pulls_total'
                        '{outcome="skipped"} 2') in text
                assert ('kgct_fleet_prefix_spills_total'
                        '{outcome="ok"} 0') in text
            finally:
                await _close(stack)

        asyncio.run(scenario())

    def test_remote_spill_lands_in_the_peer_host_tier(self):
        """The eviction ladder's remote rung over the wire: an owner with
        no host tier and a peer pool spills its evicted prefix pages
        through ``/internal/fleet_spill`` into the peer's host tier,
        counted ``ok``; the peer serves the prompt from them with the
        owner's tokens."""
        async def scenario():
            stack = []
            try:
                sb_cfg = dataclasses.replace(
                    _fleet_config(), cache=CacheConfig(
                        page_size=16, num_pages=96, swap_space_gb=0.001))
                sb, ub = await _serve(stack, sb_cfg,
                                      fleet_prefix_cache=True)
                sa, ua = await _serve(stack, fleet_prefix_cache=True,
                                      peer_pool=[ub])
                assert sa._spill_queue is not None
                sess = ClientSession()
                body = {"prompt": _prompt(11), "max_tokens": 6,
                        "temperature": 0.0}
                ref = await _comp(sess, ua, body)
                pc = sa.engine.engine.scheduler.prefix_cache
                await sa.engine.run_in_worker(
                    lambda e: e.scheduler.prefix_cache.evict(len(pc)))
                spills = sa.engine.engine.obs.fleet_spills
                for _ in range(100):
                    if spills.get("ok", 0) >= 4:
                        break
                    await asyncio.sleep(0.05)
                assert spills["ok"] >= 4
                assert sb.engine.engine.prefix_peek(body["prompt"]) == 64
                host0 = sb.engine.engine.scheduler.prefix_cache.host_hits
                assert await _comp(sess, ub, body) == ref
                assert sb.engine.engine.scheduler.prefix_cache.host_hits \
                    >= host0 + 4
                async with sess.get(f"{ua}/metrics") as resp:
                    text = await resp.text()
                assert 'kgct_fleet_prefix_spills_total{outcome="ok"}' in text
            finally:
                await _close(stack)

        asyncio.run(scenario())


class TestFleetOffByteIdentical:
    def test_flag_off_ignores_hint_and_renders_zeros(self):
        async def scenario():
            stack = []
            try:
                srv, url = await _serve(stack)
                assert not srv.fleet_on
                sess = ClientSession()
                prompt = list(range(1, 40))
                async with sess.post(
                        f"{url}/v1/completions",
                        json={"prompt": prompt, "max_tokens": 2,
                              "temperature": 0.0},
                        headers={PREFIX_SOURCE_HEADER:
                                 "http://169.254.0.1:1"}) as resp:
                    assert resp.status == 200
                    await resp.read()
                async with sess.post(
                        f"{url}/internal/fetch_prefix",
                        json={"prompt_token_ids": prompt}) as resp:
                    assert resp.status == 404
                async with sess.post(f"{url}/internal/fleet_spill",
                                     data=b"x") as resp:
                    assert resp.status == 404
                async with sess.get(f"{url}/metrics") as resp:
                    text = await resp.text()
                for oc in ("ok", "recompute", "skipped"):
                    assert (f'kgct_fleet_prefix_pulls_total'
                            f'{{outcome="{oc}"}} 0') in text
            finally:
                await _close(stack)

        asyncio.run(scenario())


# -- test_wire_integrity.py ------------------------------------------------

def _mig_state(**extra):
    k = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 5, 16, 64)).astype(np.float32))
    st = {"model": "debug-tiny", "page_size": 16, "dtype": "float32",
          "matched_tokens": 80, "prompt_token_ids": list(range(80)),
          "k": k, "v": k + 1}
    st.update(extra)
    return st


class TestWireChaosHTTP:
    """kv_wire_corrupt on a fleet pull (greedy and seeded), a handoff pull
    and the receive seams: the client output equals recompute, the
    corruption is attributed (metrics + flight), the peer is quarantined
    and recovers by probe; 426 skew, 400 corrupt, 413 oversized bodies."""

    def test_corrupt_quarantine_recover_and_receive_seams(self):
        async def scenario():
            stack = []
            try:
                sa, ua = await _serve(stack, fleet_prefix_cache=True)
                sb, ub = await _serve(stack, fleet_prefix_cache=True,
                                      peer_pool=[ua], prefill_pool=[ua])
                assert sa.integrity_on and sb.integrity_on
                obs = sb.engine.engine.obs
                pulls = obs.fleet_pulls
                sess = ClientSession()

                async def comp(base, js, headers=None):
                    return await _comp(sess, base, js, headers)

                def probe_peer():
                    assert sb.peer_scores.quarantined(ua)
                    sb.peer_scores._until[ua] = 0.0
                    assert not sb.peer_scores.quarantined(ua)

                b1 = {"prompt": _prompt(7), "max_tokens": 6,
                      "temperature": 0.0}
                ref1 = await comp(ua, b1)
                configure_faults("kv_wire_corrupt:times=1")
                got1 = await comp(ub, b1, {PREFIX_SOURCE_HEADER: ua})
                configure_faults(None)
                assert got1 == ref1
                assert pulls["recompute"] == 1 and pulls["ok"] == 0
                assert obs.wire_corruptions[("prefix", "corrupt")] == 1
                flight = obs.flight.export()["events"]
                assert any(e.get("kind") == "wire_corruption"
                           and e.get("path") == "prefix"
                           and e.get("peer") == ua for e in flight)
                assert any(e.get("kind") == "peer_quarantine"
                           and e.get("peer") == ua for e in flight)
                assert sb.peer_scores.quarantined(ua)
                b2 = {"prompt": _prompt(8), "max_tokens": 6,
                      "temperature": 0.0}
                ref2 = await comp(ua, b2)
                got2 = await comp(ub, b2, {PREFIX_SOURCE_HEADER: ua})
                assert got2 == ref2 and pulls["recompute"] == 2
                assert any(e.args.get("reason") == "quarantined"
                           for e in obs.tracer.events()
                           if e.kind == "fleet_prefix")

                probe_peer()
                b3 = {"prompt": _prompt(9), "max_tokens": 6,
                      "temperature": 0.0}
                ref3 = await comp(ua, b3)
                got3 = await comp(ub, b3, {PREFIX_SOURCE_HEADER: ua})
                assert got3 == ref3 and pulls["ok"] == 1
                assert (sb.peer_scores.score(ua)
                        >= PEER_QUARANTINE_THRESHOLD)
                assert not sb.peer_scores.quarantined(ua)
                assert sb.peer_scores.quarantines[ua] == 1

                b4 = {"prompt": _prompt(10), "max_tokens": 6,
                      "temperature": 0.8, "seed": 11}
                ref4 = await comp(ua, b4)
                configure_faults("kv_wire_corrupt:times=1")
                got4 = await comp(ub, b4, {PREFIX_SOURCE_HEADER: ua})
                configure_faults(None)
                assert got4 == ref4
                assert obs.wire_corruptions[("prefix", "corrupt")] == 2
                assert sb.peer_scores.quarantines[ua] == 2
                probe_peer()
                b5 = {"prompt": _prompt(11), "max_tokens": 6,
                      "temperature": 0.0}
                await comp(ua, b5)
                await comp(ub, b5, {PREFIX_SOURCE_HEADER: ua})
                assert pulls["ok"] == 2

                b6 = {"prompt": _prompt(12), "max_tokens": 6,
                      "temperature": 0.0}
                ref6 = await comp(ua, b6)
                configure_faults("kv_wire_corrupt:times=1")
                got6 = await comp(ub, b6, {PREFILL_URL_HEADER: ua})
                configure_faults(None)
                assert got6 == ref6
                assert obs.wire_corruptions[("handoff", "corrupt")] == 1
                assert sb.peer_scores.quarantines[ua] == 3
                hand = [e for e in obs.tracer.events()
                        if e.kind == "handoff"
                        and e.args.get("side") == "integrity"]
                assert any(e.args.get("path") == "handoff"
                           and e.args.get("peer") == ua for e in hand)

                probe_peer()
                sb.peer_scores.record_ok(ua)
                b7 = {"prompt": _prompt(13), "max_tokens": 6,
                      "temperature": 0.0}
                ref7 = await comp(ua, b7)
                configure_faults("peer_stale_frame:value=1,times=1")
                got7 = await comp(ub, b7, {PREFIX_SOURCE_HEADER: ua})
                configure_faults(None)
                assert got7 == ref7
                assert obs.wire_corruptions[("prefix", "skew")] == 1
                assert sb.peer_scores.quarantines[ua] == 4

                mig = _mig_state(mid_stream=True, output_token_ids=[1, 2])
                blob = bytearray(encode_handoff(mig, integrity=True))
                blob[-1] ^= 0xFF
                hdr = {"Content-Type": "application/octet-stream",
                       REQUEST_ID_HEADER: "mig-corrupt-1"}
                async with sess.post(f"{ub}/internal/kv_handoff",
                                     data=bytes(blob),
                                     headers=hdr) as resp:
                    assert resp.status == 400
                    assert "bad migration blob" in await resp.text()
                assert obs.wire_corruptions[("migrate", "corrupt")] == 1
                plain = bytes(encode_handoff(mig))
                async with sess.post(f"{ub}/internal/kv_handoff",
                                     data=plain,
                                     headers=dict(hdr, **{
                                         REQUEST_ID_HEADER: "mig-skew-1"})
                                     ) as resp:
                    assert resp.status == 426
                    assert "upgrade the peer" in await resp.text()
                assert obs.wire_corruptions[("migrate", "skew")] == 1

                pk = torch.from_numpy(np.random.default_rng(2)
                                      .standard_normal((2, 1, 16, 64))
                                      .astype(np.float32))
                shdr = {"Content-Type": "application/octet-stream"}
                plain_spill = encode_spill_frame(
                    "cd" * 32, pk, pk + 1, "debug-tiny", 16)
                async with sess.post(f"{ub}/internal/fleet_spill",
                                     data=plain_spill,
                                     headers=shdr) as resp:
                    assert resp.status == 426
                bad_spill = bytearray(encode_spill_frame(
                    "cd" * 32, pk, pk + 1, "debug-tiny", 16,
                    integrity=True))
                bad_spill[-1] ^= 0xFF
                async with sess.post(f"{ub}/internal/fleet_spill",
                                     data=bytes(bad_spill),
                                     headers=shdr) as resp:
                    assert resp.status == 400
                    assert "bad spill frame" in await resp.text()
                assert obs.wire_corruptions[("spill", "skew")] == 1
                assert obs.wire_corruptions[("spill", "corrupt")] == 1
                async with sess.post(
                        f"{ub}/internal/fleet_spill",
                        data=b"\0" * (sb._spill_max_bytes + 1),
                        headers=shdr) as resp:
                    assert resp.status == 413
                async with sess.post(
                        f"{ub}/internal/resume",
                        data=b"\0" * (sb._resume_max_bytes + 1),
                        headers={REQUEST_ID_HEADER: "resume-big-1"}
                        ) as resp:
                    assert resp.status == 413

                async with sess.get(f"{ub}/metrics") as resp:
                    text = await resp.text()
                for path, oc, n in (("prefix", "corrupt", 2),
                                    ("handoff", "corrupt", 1),
                                    ("migrate", "corrupt", 1),
                                    ("migrate", "skew", 1),
                                    ("spill", "corrupt", 1),
                                    ("spill", "skew", 1),
                                    ("resume", "corrupt", 0)):
                    assert (f'kgct_kv_wire_corruptions_total'
                            f'{{path="{path}",outcome="{oc}"}} {n}') in text
                assert (f'kgct_peer_quarantines_total{{peer="{ua}"}} 4'
                        in text)
                async with sess.get(f"{ua}/metrics") as resp:
                    atext = await resp.text()
                assert ('kgct_kv_wire_corruptions_total'
                        '{path="prefix",outcome="corrupt"} 0') in atext
            finally:
                await _close(stack)

        asyncio.run(scenario())

    def test_oversize_push_refused_by_the_transport(self):
        """A push whose Content-Length is over the application's bound
        (the handoff bound plus 1 MiB) is answered 413 by the transport
        before a byte of the body is read: the port reads bodies in full
        before the handler runs, so this is where the bound holds."""
        async def scenario():
            stack = []
            try:
                sb, ub = await _serve(stack)
                assert sb.client_max_size == \
                    sb._handoff_max_bytes + (1 << 20)
                reader, writer = await asyncio.open_connection(
                    "127.0.0.1", int(ub.rsplit(":", 1)[1]))
                writer.write(
                    ("POST /internal/kv_handoff HTTP/1.1\r\nHost: x\r\n"
                     "Content-Type: application/octet-stream\r\n"
                     f"{REQUEST_ID_HEADER}: big-1\r\n"
                     f"Content-Length: {sb.client_max_size + 1}\r\n\r\n")
                    .encode())
                await writer.drain()
                status = await asyncio.wait_for(reader.readline(), 10)
                writer.close()
                assert status.split()[1] == b"413"
                assert sb.migration.migrations == {}
                # Under the transport's bound but over the handler's own:
                # the handler's Content-Length check answers 413 (counted).
                sb._handoff_max_bytes = 1000
                sess = ClientSession()
                async with sess.post(
                        f"{ub}/internal/kv_handoff", data=b"\0" * 2000,
                        headers={REQUEST_ID_HEADER: "big-2"}) as resp:
                    assert resp.status == 413
                assert sb.migration.migrations[("recv", "error")] == 1
            finally:
                await _close(stack)

        asyncio.run(scenario())


class TestIntegrityOffByteIdentical:
    def test_off_serves_pre_integrity_frames_and_interops(self):
        async def scenario():
            stack = []
            try:
                sa, ua = await _serve(stack, fleet_prefix_cache=True,
                                      integrity_checks=False)
                sb, ub = await _serve(stack, fleet_prefix_cache=True,
                                      peer_pool=[ua],
                                      integrity_checks=False)
                assert not sa.integrity_on and not sb.integrity_on
                prompt = np.random.default_rng(21).integers(
                    1, 200, 80).tolist()
                body = {"prompt": prompt, "max_tokens": 6,
                        "temperature": 0.0}
                sess = ClientSession()
                ref = await _comp(sess, ua, body)
                got = await _comp(sess, ub, body,
                                  {PREFIX_SOURCE_HEADER: ua})
                assert got == ref
                assert sb.engine.engine.obs.fleet_pulls["ok"] == 1
                async with sess.post(
                        f"{ua}/internal/fetch_prefix",
                        json={"prompt_token_ids": prompt,
                              "have_tokens": 0}) as resp:
                    assert resp.status == 200
                    stream = await resp.read()
                dec = PrefixStreamDecoder()
                dec.feed(stream)
                assert dec.header is not None
                assert "page_crc" not in dec.header
                assert "frame_crc" not in dec.header
            finally:
                await _close(stack)

        asyncio.run(scenario())


# -- the warm module servers -----------------------------------------------

@pytest.fixture(scope="module")
def warm():
    """Two warm role="both" servers on one loop: "chaos" carries
    ``test_chaos.py``'s cases, "serving" ``test_serving.py``'s, each on a
    server of its own as in those modules."""
    loop = asyncio.new_event_loop()
    stack = []
    out = {"loop": loop}
    for name in ("chaos", "serving"):
        api, url = loop.run_until_complete(_serve(stack, _serving_config()))
        out[name] = (api, url)
    out["sess"] = ClientSession()
    yield out
    loop.run_until_complete(_close(stack))
    loop.close()


class TestGracefulDrain:
    def test_migrate_fail_degrades_to_wait_it_out(self, warm):
        loop, sess = warm["loop"], warm["sess"]
        server, url = warm["chaos"]

        async def go():
            configure_faults("migrate_fail")
            task = []
            r = await _stream(
                sess, f"{url}/v1/completions",
                {"prompt": "migrate me", "max_tokens": 16,
                 "temperature": 0.0, "stream": True},
                {MIGRATE_URL_HEADER: DEAD_PEER},
                on_first=lambda: task.append(server.begin_drain()))
            assert task[0] is not None
            assert r["done"] and not r["severed"]
            assert not any("error" in f for f in r["frames"]), \
                "migrate_fail must degrade to wait-it-out, not truncate"
            await asyncio.wait_for(task[0], timeout=10)
            assert server.migration.migrations.get(
                ("push", "fallback"), 0) >= 1
            assert server.migration.migrations.get(("push", "ok"), 0) == 0
            events = server.engine.engine.obs.flight.export()["events"]
            assert any(e["kind"] == "migrate"
                       and e.get("outcome") == "fallback" for e in events)
            async with sess.get(f"{url}/metrics") as rm:
                text = await rm.text()
            assert 'kgct_migrations_total{side="push",outcome="fallback"}' \
                in text
        loop.run_until_complete(go())
        _reset_drain(server)

    def test_push_failure_reimports_locally(self, warm):
        loop, sess = warm["loop"], warm["sess"]
        server, url = warm["chaos"]
        body = {"prompt": "push me somewhere", "max_tokens": 16,
                "temperature": 0.0}

        async def go():
            ref = await _comp(sess, url, body)
            task = []
            r = await _stream(
                sess, f"{url}/v1/completions", dict(body, stream=True),
                {MIGRATE_URL_HEADER: DEAD_PEER},
                on_first=lambda: task.append(server.begin_drain()))
            await asyncio.wait_for(task[0], timeout=10)
            assert r["done"] and not r["severed"]
            assert not any("error" in f for f in r["frames"])
            assert r["text"] == ref, \
                "local re-import must resume byte-identically"
            assert server.migration.migrations.get(
                ("push", "fallback"), 0) >= 1
        loop.run_until_complete(go())
        _reset_drain(server)


class TestResumeAndRecv:
    def test_resume_token_replay_emits_only_new_tokens(self, warm):
        loop, sess = warm["loop"], warm["sess"]
        server, url = warm["chaos"]
        body = {"prompt": "resume this stream", "max_tokens": 12,
                "temperature": 0.0}

        async def go():
            r = await _stream(sess, f"{url}/v1/completions",
                              dict(body, stream=True),
                              {MIGRATE_URL_HEADER: DEAD_PEER})
            toks, full = r["ids"], r["text"]
            assert len(toks) == 12, "ledger must cover every token"
            cut, prefix = 0, ""
            for f in r["frames"]:
                if cut >= 5:
                    break
                cut += len(f.get("kgct_token_ids", []))
                prefix += f["choices"][0]["text"]
            resumed = await _stream(
                sess, f"{url}/internal/resume",
                {"body": body, "kind": "completion",
                 "relayed_token_ids": toks[:cut]},
                {REQUEST_ID_HEADER: "resume-replay-1"})
            assert resumed["headers"][RESUME_MODE_HEADER] == "recompute"
            assert resumed["done"]
            assert not any("error" in f for f in resumed["frames"])
            assert resumed["text"] == full[len(prefix):]
            assert resumed["ids"] == toks[cut:]
            assert server.migration.migrations.get(
                ("resume", "fallback"), 0) >= 1
            events = server.engine.engine.obs.flight.export()["events"]
            assert any(e["kind"] == "migrate"
                       and e.get("side") == "resume" for e in events)
        loop.run_until_complete(go())

    def test_resume_rejects_malformed_envelopes(self, warm):
        loop, sess = warm["loop"], warm["sess"]
        _, url = warm["chaos"]

        async def go():
            hdr = {REQUEST_ID_HEADER: "resume-bad-1"}
            for kw in (dict(data=b"not json"),
                       dict(json={"body": "nope", "relayed_token_ids": []}),
                       dict(json={"body": {"prompt": "x"},
                                  "relayed_token_ids": [1, "two"]}),
                       dict(json={"body": {"prompt": "x"},
                                  "relayed_token_ids": [],
                                  "kind": "mystery"})):
                async with sess.post(f"{url}/internal/resume", headers=hdr,
                                     **kw) as r:
                    assert r.status == 400
        loop.run_until_complete(go())

    def test_recv_validates_before_parking(self, warm):
        loop, sess = warm["loop"], warm["sess"]
        server, url = warm["chaos"]

        def blob(model="debug-tiny", mid_stream=True):
            k = torch.zeros((1, 2, 4, 4), dtype=torch.float32)
            state = {"model": model, "page_size": 16, "dtype": "float32",
                     "prompt_token_ids": [1, 2, 3],
                     "output_token_ids": [7], "output_logprobs": [-0.5],
                     "output_top_logprobs": [], "k": k, "v": k}
            if mid_stream:
                state["mid_stream"] = True
            return bytes(encode_handoff(state, integrity=True))

        async def post(data):
            async with sess.post(
                    f"{url}/internal/kv_handoff", data=data,
                    headers={"Content-Type": "application/octet-stream",
                             REQUEST_ID_HEADER: "park-1"}) as r:
                return r.status, await r.read()

        async def go():
            errs0 = server.migration.migrations.get(("recv", "error"), 0)
            assert (await post(blob(model="llama-3-8b")))[0] == 409
            assert (await post(blob(mid_stream=False)))[0] == 400
            assert (await post(b"KVGARBAGE"))[0] == 400
            assert server.migration.migrations.get(
                ("recv", "error"), 0) == errs0 + 3
            assert len(server.migrate_store) == 0
            status, body = await post(blob())
            assert status == 200 and json.loads(body)["parked"] is True
            assert server.migrate_store.pop("park-1") is not None
            assert server.migrate_store.pop("park-1") is None
        loop.run_until_complete(go())


class TestKVHandoffOnWarmServer:
    def test_kv_handoff_export_endpoint(self, warm):
        loop, sess = warm["loop"], warm["sess"]
        _, url = warm["serving"]

        async def go():
            async with sess.post(f"{url}/internal/kv_handoff", json={
                    "prompt_token_ids": list(range(2, 40)),
                    "temperature": 0.0}) as r:
                assert r.status == 200
                assert r.headers["Content-Type"] == \
                    "application/octet-stream"
                state = decode_handoff(await r.read())
            assert state["model"] == "debug-tiny"
            assert len(state["output_token_ids"]) == 1
            assert state["k"].shape[1] > 0
            for ids in ([], ["x"]):
                async with sess.post(f"{url}/internal/kv_handoff",
                                     json={"prompt_token_ids": ids}) as r:
                    assert r.status == 400
        loop.run_until_complete(go())

    def test_export_failure_counts_outcome_error(self, warm):
        loop, sess = warm["loop"], warm["sess"]
        server, url = warm["serving"]

        async def go():
            before = server.disagg.handoffs.get(("export", "error"), 0)
            async with sess.post(f"{url}/internal/kv_handoff", json={
                    "prompt_token_ids": list(range(2, 10)),
                    "temperature": 0.0,
                    "logit_bias": {"999999": 5}}) as r:
                assert r.status == 400
            assert server.disagg.handoffs[("export", "error")] == before + 1
        loop.run_until_complete(go())

    def test_handoff_pull_failure_falls_back_to_local_recompute(self, warm):
        loop, sess = warm["loop"], warm["sess"]
        server, url = warm["serving"]
        body = {"prompt": "fall back please", "max_tokens": 4,
                "temperature": 0.0}

        async def go():
            ref = await _comp(sess, url, body)
            configure_faults("kv_handoff_fail")
            try:
                got = await _comp(sess, url, body,
                                  {PREFILL_URL_HEADER: "http://127.0.0.1:9"})
                assert got == ref
            finally:
                configure_faults(None)
            got = await _comp(sess, url, body,
                              {PREFILL_URL_HEADER: "http://127.0.0.1:9"})
            assert got == ref
            flight = server.engine.engine.obs.flight.export()
            falls = [e for e in flight["events"]
                     if e["kind"] == "handoff"
                     and e.get("outcome") == "fallback"]
            assert len(falls) >= 2
            assert any("kv_handoff_fail" in (e.get("error") or "")
                       for e in falls)
            async with sess.get(f"{url}/metrics") as r:
                text = await r.text()
            _assert_valid_exposition(text)
            assert ('kgct_disagg_handoffs_total{side="import",'
                    'outcome="fallback"} 2') in text
            assert 'kgct_engine_role{role="both"} 1' in text
        loop.run_until_complete(go())

    def test_prefill_pool_allowlist_gates_the_pull(self, warm):
        loop, sess = warm["loop"], warm["sess"]
        server, url = warm["serving"]
        body = {"prompt": "allowlist me", "max_tokens": 4,
                "temperature": 0.0}
        assert server.prefill_pool is None
        server.prefill_pool = frozenset({"http://127.0.0.1:9"})

        def rejects():
            flight = server.engine.engine.obs.flight.export()
            return [e for e in flight["events"]
                    if e["kind"] == "handoff"
                    and "not in --prefill-pool" in (e.get("error") or "")]

        async def go():
            ref = await _comp(sess, url, body)
            got = await _comp(sess, url, body,
                              {PREFILL_URL_HEADER: "http://evil.example:80"})
            assert got == ref and len(rejects()) == 1
            got = await _comp(sess, url, body,
                              {PREFILL_URL_HEADER: "http://127.0.0.1:9/"})
            assert got == ref and len(rejects()) == 1
        try:
            loop.run_until_complete(go())
        finally:
            server.prefill_pool = None

    def test_engine_side_import_fallback_reports_to_metrics(self, warm):
        server, _ = warm["serving"]
        assert server.engine.on_import_fallback is not None
        before = server.disagg.handoffs.get(("import", "fallback"), 0)
        server.engine.on_import_fallback()
        assert server.disagg.handoffs[("import", "fallback")] == before + 1


# -- test_qos.py -----------------------------------------------------------

class TestKVHandoffTierGate:
    def test_handoff_gate_attributes_to_forwarded_tier(self):
        tiers = (QoSTier("interactive", weight=4, priority=10),
                 QoSTier("batch", weight=1, priority=0, max_concurrent=2))
        cfg = EngineConfig(
            model=get_model_config("debug-tiny"),
            cache=CacheConfig(page_size=4, num_pages=64),
            scheduler=SchedulerConfig(
                max_num_seqs=4, max_prefill_tokens=64,
                decode_buckets=(1, 2, 4, 8), prefill_buckets=(16, 32, 64),
                decode_window=1, mixed_batch_enabled=False,
                qos_tiers=tiers))

        async def scenario():
            stack = []
            try:
                server, url = await _serve(stack, cfg)
                sess = ClientSession()
                configure_faults("tenant_flood:value=8")
                async with sess.post(f"{url}/internal/kv_handoff",
                                     json={"prompt_token_ids": [1, 2, 3]},
                                     headers={QOS_TIER_HEADER: "batch"}
                                     ) as r:
                    assert r.status == 429
                assert server.admission.shed_by_tier == {
                    "interactive": 0, "batch": 1}
                async with sess.post(
                        f"{url}/internal/kv_handoff",
                        json={"prompt_token_ids": [1, 2, 3]},
                        headers={QOS_TIER_HEADER: "interactive"}) as r:
                    assert r.status == 200
            finally:
                configure_faults(None)
                await _close(stack)

        asyncio.run(scenario())


# -- the mixed fleet: JAX and port replicas on one weight set --------------

ROLES = ("prefill", "decode", "both")


@pytest.fixture(scope="module")
def mixed():
    """One JAX server and one port server per role, on one debug-tiny fp32
    weight set, on one loop."""
    cfg = jax_model("debug-tiny")
    jp = JM.init_params(cfg, jax.random.key(5))
    tp = TM.params_from_numpy(jax.tree.map(np.asarray, jp),
                              get_model_config("debug-tiny"), "cpu")
    loop = asyncio.new_event_loop()
    stack, jax_servers = [], []
    out = {"loop": loop, "sess": ClientSession()}
    jcfg = JEngineConfig(model=cfg, cache=JCache(page_size=16,
                                                 num_pages=128),
                         scheduler=JSched(**SERVING_SCHED))
    for role in ROLES:
        api = build_server(_serving_config(), params=tp, device="cpu",
                           model_name="debug-tiny", role=role)
        server = Server(api.build_app())
        loop.run_until_complete(server.start("127.0.0.1", 0))
        stack.append(server)
        out[("port", role)] = (api, f"http://127.0.0.1:{server.port}")
        japi = jax_build_server(jcfg, params=jp, model_name="debug-tiny",
                                role=role)
        jts = TestServer(japi.build_app(), host="127.0.0.1", loop=loop)
        loop.run_until_complete(jts.start_server())
        jax_servers.append(jts)
        out[("jax", role)] = (japi, str(jts.make_url("")).rstrip("/"))
    yield out
    for jts in jax_servers:
        loop.run_until_complete(jts.close())
    loop.run_until_complete(_close(stack))
    loop.close()


def _ledger_run(mixed, base, body, headers=None) -> dict:
    """A greedy stream whose frames carry the token ledger (a migrate-url
    header toward a dead peer registers it; nothing drains)."""
    return mixed["loop"].run_until_complete(_stream(
        mixed["sess"], f"{base}/v1/completions", dict(body, stream=True),
        {MIGRATE_URL_HEADER: DEAD_PEER, **(headers or {})}))


MIXED_BODY = {"prompt": _prompt(41, 60), "max_tokens": 10,
              "temperature": 0.0}


@pytest.mark.parametrize("integ", [True, False], ids=["crc", "plain"])
@pytest.mark.parametrize("pre,dec", [("jax", "port"), ("port", "jax")],
                         ids=["jax-prefill-port-decode",
                              "port-prefill-jax-decode"])
def test_mixed_fleet_disaggregated_request(mixed, pre, dec, integ):
    """A greedy request through a prefill replica of one package and a
    decode replica of the other gives the JAX colocated server's tokens,
    the handoff counted ok on both sides and nothing falling back."""
    p_api, p_url = mixed[(pre, "prefill")]
    d_api, d_url = mixed[(dec, "decode")]
    _, ref_url = mixed[("jax", "both")]
    for api in (p_api, d_api):
        api.integrity_on = integ
    try:
        ref = _ledger_run(mixed, ref_url, MIXED_BODY)
        exp0 = p_api.disagg.handoffs.get(("export", "ok"), 0)
        imp0 = d_api.disagg.handoffs.get(("import", "ok"), 0)
        fb0 = d_api.disagg.handoffs.get(("import", "fallback"), 0)
        got = _ledger_run(mixed, d_url, MIXED_BODY,
                          {PREFILL_URL_HEADER: p_url})
    finally:
        for api in (p_api, d_api):
            api.integrity_on = True
    assert got["done"] and got["ids"] == ref["ids"] and len(ref["ids"]) == 10
    assert got["text"] == ref["text"]
    assert p_api.disagg.handoffs[("export", "ok")] == exp0 + 1
    assert d_api.disagg.handoffs[("import", "ok")] == imp0 + 1
    assert d_api.disagg.handoffs.get(("import", "fallback"), 0) == fb0


@pytest.mark.parametrize("src,dst", [("port", "jax"), ("jax", "port")],
                         ids=["port-to-jax", "jax-to-port"])
def test_mixed_fleet_drain_push_resumes_by_import(mixed, src, dst):
    """A stream on a replica of one package, drained with a migrate url
    naming a decode replica of the other: the stream is severed with no
    ``[DONE]``, the peer parks the pushed state, and the router's resume
    there imports it and emits only the tokens the client had not seen;
    relayed plus resumed equal the uninterrupted run."""
    loop, sess = mixed["loop"], mixed["sess"]
    s_api, s_url = mixed[(src, "both")]
    d_api, d_url = mixed[(dst, "decode")]
    body = {"prompt": _prompt(44, 50), "max_tokens": 64,
            "temperature": 0.0}
    rid = f"mix-mig-{src}"
    ref = _ledger_run(mixed, mixed[("jax", "both")][1], body)
    recv0 = d_api.migration.migrations.get(("recv", "ok"), 0)

    async def go():
        task = []
        cut = await _stream(
            sess, f"{s_url}/v1/completions", dict(body, stream=True),
            {MIGRATE_URL_HEADER: d_url, REQUEST_ID_HEADER: rid},
            on_first=lambda: task.append(s_api.begin_drain()))
        await asyncio.wait_for(task[0], timeout=30)
        resumed = await _stream(
            sess, f"{d_url}/internal/resume",
            {"body": body, "kind": "completion",
             "relayed_token_ids": cut["ids"]}, {REQUEST_ID_HEADER: rid})
        return cut, resumed
    try:
        cut, resumed = loop.run_until_complete(go())
    finally:
        _reset_drain(s_api)
    assert not cut["done"] and cut["severed"]
    assert d_api.migration.migrations[("recv", "ok")] == recv0 + 1
    assert resumed["headers"][RESUME_MODE_HEADER] == "import"
    assert resumed["done"]
    assert cut["ids"] + resumed["ids"] == ref["ids"]
    assert len(ref["ids"]) == 64 and 0 < len(cut["ids"]) < 64


@pytest.mark.parametrize("role", ROLES)
def test_metrics_families_equal_jax_under_every_role(mixed, role):
    loop, sess = mixed["loop"], mixed["sess"]

    async def families(url):
        async with sess.get(f"{url}/metrics") as r:
            text = await r.text()
        _assert_valid_exposition(text)
        return {ln.split()[2] for ln in text.splitlines()
                if ln.startswith("# TYPE")}, text

    got, text = loop.run_until_complete(families(mixed[("port", role)][1]))
    want, _ = loop.run_until_complete(families(mixed[("jax", role)][1]))
    assert got == want
    assert f'kgct_engine_role{{role="{role}"}} 1' in text


# -- each fleet option and CLI flag reaches a working server ---------------

def _check_server(api, role="both"):
    """Serve ``api`` briefly: /health names the role, a completion is
    200, and the fleet routes answer."""
    async def go():
        stack = []
        server = Server(api.build_app())
        await server.start("127.0.0.1", 0)
        stack.append(server)
        url = f"http://127.0.0.1:{server.port}"
        sess = ClientSession()
        try:
            async with sess.get(f"{url}/health") as r:
                assert r.status == 200 and (await r.json())["role"] == role
            await _comp(sess, url, {"prompt": [5, 6, 7], "max_tokens": 3,
                                    "temperature": 0.0})
            async with sess.post(f"{url}/internal/kv_handoff",
                                 json={"prompt_token_ids": [5, 6, 7]}) as r:
                assert r.status == (404 if role == "decode" else 200)
            async with sess.post(f"{url}/internal/fetch_prefix",
                                 json={"prompt_token_ids": [5, 6, 7]}) as r:
                assert r.status == 404      # nothing cached / fleet off
        finally:
            await _close(stack)
    asyncio.run(go())


@pytest.mark.parametrize("kw", [
    dict(role="prefill"), dict(role="decode"),
    dict(prefill_pool=["http://a:1"]), dict(peer_pool=["http://b:2"]),
    dict(fleet_prefix_cache=True), dict(integrity_checks=False)],
    ids=["role-prefill", "role-decode", "prefill-pool", "peer-pool",
         "fleet-prefix-cache", "integrity-off"])
def test_fleet_option_serves(kw):
    cfg = _fleet_config() if kw.get("fleet_prefix_cache") else \
        _serving_config()
    api = build_server(cfg, device="cpu", **kw)
    assert api.fleet_on == bool(kw.get("fleet_prefix_cache"))
    assert api.integrity_on == kw.get("integrity_checks", True)
    if "peer_pool" in kw:
        assert api.peer_pool == frozenset(kw["peer_pool"])
    if "prefill_pool" in kw:
        assert api.prefill_pool == frozenset(kw["prefill_pool"])
    _check_server(api, kw.get("role", "both"))


def test_unknown_role_refused():
    with pytest.raises(ValueError, match="unknown replica role"):
        build_server(_serving_config(), device="cpu", role="router")


@pytest.mark.parametrize("argv,check", [
    (["--role", "decode"], lambda a: a.role == "decode"),
    (["--role", "prefill"], lambda a: a.role == "prefill"),
    (["--prefill-pool", "http://a:1, http://b:2/"],
     lambda a: a.prefill_pool == {"http://a:1", "http://b:2"}),
    (["--peer-pool", "http://a:1,http://b:2"],
     lambda a: a.peer_list == ("http://a:1", "http://b:2")),
    (["--enable-prefix-caching", "--fleet-prefix-cache"],
     lambda a: a.fleet_on),
    (["--no-integrity-checks"], lambda a: not a.integrity_on),
], ids=["role-decode", "role-prefill", "prefill-pool", "peer-pool",
        "fleet-prefix-cache", "no-integrity-checks"])
def test_cli_fleet_flag_serves(argv, check):
    seen = {}
    inner = A.build_server

    def spy(*a, **kw):
        seen["api"] = inner(*a, **kw)
        return seen["api"]

    def serve(app, host, port):
        api = seen["api"]
        assert app is not None and check(api)
        _check_server(api, api.role)

    with mock.patch.object(A, "build_server", spy), \
            mock.patch.object(A, "run_app", serve):
        A.main(["--model", "debug-tiny", "--device", "cpu", *argv])
    assert "api" in seen
