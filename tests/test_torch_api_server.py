"""The port's OpenAI server against the JAX package's, request by request,
on the CPU, and the JAX package's server cases re-pointed at the port.

One debug-tiny fp32 weight set (drawn by the JAX package, converted with
``params_from_numpy``) serves under both servers: the JAX server on
aiohttp, the port's on ``serving/http.py``, both with the byte tokenizer,
both on real sockets. One aiohttp ``ClientSession`` (the fleet router's
client library) drives both, so it also reads the port's framing.

Each entry of ``TABLE`` goes to both servers. Equal: the status, the
``Content-Type`` / ``Retry-After`` / echoed inbound request-id headers, and
the JSON body or the list of SSE frames after minted ids and ``created``
are normalized; greedy text and finish reasons exactly, logprobs within
1e-4 (fp32). Seeded sampled entries are not bit-identical across the
packages (ROADMAP parity contract): their shapes and counts are compared,
and the same seed twice on the port gives the same text. ``/metrics`` is
compared by its set of ``# TYPE`` families.

The re-pointed classes (``test_serving.py``) run on the same port server.
"""

import asyncio
import json
import math
import re
import threading
import time

import aiohttp
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
from kubernetes_gpu_cluster_tpu.serving.api_server import \
    build_server as jax_build_server
from kubernetes_gpu_cluster_tpu_torch.config import (CacheConfig,
                                                     EngineConfig,
                                                     ResilienceConfig,
                                                     SchedulerConfig,
                                                     get_model_config)
from kubernetes_gpu_cluster_tpu_torch.models import llama as TM
from kubernetes_gpu_cluster_tpu_torch.serving.api_server import build_server
from kubernetes_gpu_cluster_tpu_torch.serving.errors import (
    MIGRATE_URL_HEADER, PREFILL_URL_HEADER, PREFIX_SOURCE_HEADER,
    REQUEST_ID_HEADER)
from kubernetes_gpu_cluster_tpu_torch.serving.http import Server
from kubernetes_gpu_cluster_tpu_torch.serving.tokenizer import (
    ByteTokenizer, IncrementalDetokenizer)
from test_serving import _assert_valid_exposition

torch.set_num_threads(2)

CACHE = dict(page_size=16, num_pages=128)
SCHED = dict(max_num_seqs=4, max_prefill_tokens=256, decode_buckets=(1, 2, 4),
             prefill_buckets=(128, 256), decode_window=4)
LP_ATOL = 1e-4
DEAD_PEER = "http://127.0.0.1:1"      # connection refused at once


def port_config(**res):
    return EngineConfig(model=get_model_config("debug-tiny"),
                        cache=CacheConfig(**CACHE),
                        scheduler=SchedulerConfig(**SCHED),
                        resilience=ResilienceConfig(**res))


class Client:
    """The part of aiohttp's TestClient the reference's cases use, over a
    real socket to ``base``."""

    def __init__(self, base: str, session: aiohttp.ClientSession):
        self.base = base
        self.session = session

    def get(self, path, **kw):
        return self.session.get(self.base + path, **kw)

    def post(self, path, **kw):
        return self.session.post(self.base + path, **kw)


def start_port_server(server):
    """(loop, Client, stop) for ``server`` on the port's HTTP layer on a
    free port of 127.0.0.1."""
    loop = asyncio.new_event_loop()
    http_server = Server(server.build_app())
    loop.run_until_complete(http_server.start("127.0.0.1", 0))

    async def session():
        return aiohttp.ClientSession()
    sess = loop.run_until_complete(session())
    client = Client(f"http://127.0.0.1:{http_server.port}", sess)

    def stop():
        loop.run_until_complete(sess.close())
        loop.run_until_complete(http_server.close())
        loop.close()
    return loop, client, stop


@pytest.fixture(scope="module")
def servers():
    """(loop, port client, JAX client, port APIServer) on one weight set."""
    cfg = jax_model("debug-tiny")
    jp = JM.init_params(cfg, jax.random.key(5))
    tp = TM.params_from_numpy(jax.tree.map(np.asarray, jp),
                              get_model_config("debug-tiny"), "cpu")
    port = build_server(port_config(), params=tp, device="cpu",
                        model_name="debug-tiny")
    loop, client, stop = start_port_server(port)
    jcfg = JEngineConfig(model=cfg, cache=JCache(**CACHE),
                         scheduler=JSched(**SCHED))
    jserver = jax_build_server(jcfg, params=jp, model_name="debug-tiny")
    jts = TestServer(jserver.build_app(), host="127.0.0.1", loop=loop)
    loop.run_until_complete(jts.start_server())
    jclient = Client(str(jts.make_url("")).rstrip("/"), client.session)
    yield loop, client, jclient, port
    loop.run_until_complete(jts.close())
    stop()


# -- the request table ------------------------------------------------------

def _entry(name, path="/v1/completions", body=None, headers=None,
           method="POST", seeded=False, data=None):
    return pytest.param(dict(path=path, body=body, headers=headers or {},
                             method=method, seeded=seeded, data=data),
                        id=name)


G = {"temperature": 0.0}
CHAT = {"messages": [{"role": "user", "content": "hi there"}],
        "max_tokens": 6, **G}
TABLE = [
    _entry("completion", body={"prompt": "hello world", "max_tokens": 8, **G}),
    _entry("completion-stream", body={"prompt": "hello world",
                                      "max_tokens": 8, "stream": True, **G}),
    _entry("chat", "/v1/chat/completions", body=CHAT),
    _entry("chat-stream", "/v1/chat/completions",
           body={**CHAT, "stream": True}),
    _entry("token-ids", body={"prompt": [5, 6, 7], "max_tokens": 6, **G}),
    _entry("token-ids-out-of-range", body={
        "prompt": [-1, 5, 512, 9999, 7], "max_tokens": 6, **G}),
    _entry("single-string-list", body={"prompt": ["abc"], "max_tokens": 4,
                                       **G}),
    _entry("echo", body={"prompt": "hi", "max_tokens": 3, "echo": True, **G}),
    _entry("echo-logprobs", body={"prompt": [1, 5, 9], "max_tokens": 2,
                                  "echo": True, "logprobs": 2, **G}),
    _entry("echo-stream", body={"prompt": "hi", "max_tokens": 3,
                                "echo": True, "stream": True, **G}),
    _entry("stop-string", body={"prompt": "stop me", "max_tokens": 24,
                                "stop": "@STOP@", **G}),
    _entry("stop-string-stream", body={"prompt": "stop me", "max_tokens": 24,
                                       "stop": ["zz", "@STOP@"],
                                       "stream": True, **G}),
    *[_entry(f"logprobs-{n}", body={"prompt": [1, 5, 9], "max_tokens": 4,
                                    "logprobs": n, **G}) for n in range(4)],
    _entry("logprobs-true", body={"prompt": [2, 3], "max_tokens": 3,
                                  "logprobs": True, **G}),
    _entry("logprobs-stream", body={"prompt": [1, 5, 9], "max_tokens": 4,
                                    "logprobs": 2, "stream": True, **G}),
    _entry("logit-bias", body={"prompt": [3, 1], "max_tokens": 3,
                               "logit_bias": {"70": 100}, "logprobs": 1, **G}),
    _entry("penalties", body={"prompt": [3, 1, 3, 1], "max_tokens": 8,
                              "presence_penalty": 1.0,
                              "frequency_penalty": 0.5, **G}),
    _entry("n-2-greedy", body={"prompt": [2, 8, 4], "max_tokens": 4, "n": 2,
                               **G}),
    _entry("n-2-seeded", body={"prompt": [2, 8, 4], "max_tokens": 4, "n": 2,
                               "temperature": 1.0, "seed": 11},
           seeded=True),
    _entry("best-of-3-seeded", body={"prompt": [2, 8], "max_tokens": 4,
                                     "best_of": 3, "temperature": 1.0,
                                     "seed": 9}, seeded=True),
    _entry("seeded-top-p-k", body={"prompt": [4, 4], "max_tokens": 6,
                                   "temperature": 0.8, "top_p": 0.9,
                                   "top_k": 20, "seed": 3, "logprobs": 1},
           seeded=True),
    *[_entry(f"affinity-{k}-{type(v).__name__}",
             body={"prompt": "hi", "max_tokens": 2, k: v, **G})
      for k in ("session_id", "user")
      for v in ("conv-1", 7, None, True, {"a": 1}, ["a"])],
    # Every 400 of _run_admitted, in its order.
    _entry("400-logprobs-type", body={"prompt": "x", "logprobs": "2"}),
    _entry("400-logprobs-range", body={"prompt": "x", "logprobs": 9}),
    _entry("400-logprobs-chat", "/v1/chat/completions",
           body={**CHAT, "logprobs": 1}),
    _entry("400-echo-chat", "/v1/chat/completions",
           body={**CHAT, "echo": True}),
    _entry("400-penalty", body={"prompt": "x", "presence_penalty": 9.0}),
    _entry("400-temperature-type", body={"prompt": "x",
                                         "temperature": "hot"}),
    _entry("400-n-type", body={"prompt": "x", "n": "two"}),
    _entry("400-n-zero", body={"prompt": "x", "n": 0}),
    _entry("400-n-cap", body={"prompt": "x", "n": 129}),
    _entry("400-best-of-below-n", body={"prompt": "x", "n": 3,
                                        "best_of": 2}),
    _entry("400-best-of-cap", body={"prompt": "x", "best_of": 129}),
    _entry("400-best-of-chat", "/v1/chat/completions",
           body={**CHAT, "best_of": 2}),
    _entry("400-n-stream", body={"prompt": "x", "n": 2, "stream": True}),
    _entry("400-logit-bias-range", body={"prompt": "x", "max_tokens": 2,
                                         "logit_bias": {"600": 1.0}, **G}),
    _entry("400-prompt-too-long", body={"prompt": [3] * 600,
                                        "max_tokens": 2, **G}),
    _entry("400-bad-json", data=b"not json"),
    _entry("400-missing-prompt", body={"max_tokens": 4}),
    _entry("400-missing-messages", "/v1/chat/completions",
           body={"max_tokens": 4}),
    _entry("400-batched-prompts", body={"prompt": ["a", "b"]}),
    *[_entry(f"ttft-budget-{n}", body={"prompt": "x", "max_tokens": 2, **G},
             headers={"x-kgct-ttft-budget-ms": v})
      for n, v in (("invalid", "soon"), ("nan", "nan"), ("zero", "0"),
                   ("negative", "-5"), ("inf", "inf"), ("tiny", "0.001"))],
    _entry("inbound-request-id", body={"prompt": "id me", "max_tokens": 3,
                                       **G},
           headers={REQUEST_ID_HEADER: "req-parity-1"}),
    _entry("inbound-request-id-stream",
           body={"prompt": "id me", "max_tokens": 3, "stream": True, **G},
           headers={REQUEST_ID_HEADER: "req-parity-2"}),
    _entry("inbound-request-id-400", body={"max_tokens": 3},
           headers={REQUEST_ID_HEADER: "req-parity-3"}),
    _entry("invalid-request-id", body={"prompt": "id me", "max_tokens": 3,
                                       **G},
           headers={REQUEST_ID_HEADER: "bad id with spaces"}),
    _entry("prefill-url", body={"prompt": "pull me", "max_tokens": 5, **G},
           headers={PREFILL_URL_HEADER: DEAD_PEER}),
    _entry("prefix-source", body={"prompt": "pull me", "max_tokens": 5, **G},
           headers={PREFIX_SOURCE_HEADER: DEAD_PEER}),
    _entry("migrate-url-stream", body={"prompt": "keep me", "max_tokens": 6,
                                       "stream": True, **G},
           headers={MIGRATE_URL_HEADER: DEAD_PEER}),
    _entry("health", "/health", method="GET"),
    _entry("models", "/v1/models", method="GET"),
    _entry("metrics", "/metrics", method="GET"),
    _entry("trace", "/debug/trace", method="GET"),
    _entry("flightrecorder", "/debug/flightrecorder", method="GET"),
    _entry("404", "/v1/nope", method="GET"),
]

_MINTED = re.compile(r"^(cmpl|chatcmpl)-\d+")


def _norm_obj(obj):
    """Minted ids and ``created`` normalized; the migration ledger the JAX
    server embeds in SSE frames (``kgct_token_ids``, stripped by the router
    before the client) dropped."""
    if isinstance(obj, dict):
        out = {}
        for k, v in obj.items():
            if k == "created":
                v = "<created>"
            elif k == "id" and isinstance(v, str):
                v = _MINTED.sub(r"\1-<n>", v)
            elif k == "kgct_token_ids":
                continue
            out[k] = _norm_obj(v)
        return out
    if isinstance(obj, list):
        return [_norm_obj(v) for v in obj]
    return obj


def _frames(raw: str) -> list:
    out = []
    for line in raw.splitlines():
        if line.startswith("data: "):
            payload = line[len("data: "):]
            out.append(payload if payload == "[DONE]"
                       else _norm_obj(json.loads(payload)))
    # A frame that carries only the migration ledger (no text, no finish,
    # no logprobs) exists only on the JAX server's registered streams.
    return [f for f in out if not (
        isinstance(f, dict) and "choices" in f
        and not f["choices"][0].get("text")
        and not f["choices"][0].get("delta")
        and f["choices"][0].get("finish_reason") is None
        and "logprobs" not in f["choices"][0])]


def _close(a, b, path="$"):
    """Exact equality except floats, within LP_ATOL."""
    if isinstance(a, float) or isinstance(b, float):
        assert isinstance(a, (int, float)) and isinstance(b, (int, float)), \
            (path, a, b)
        assert math.isclose(a, b, rel_tol=0, abs_tol=LP_ATOL), (path, a, b)
        return
    assert type(a) is type(b), (path, a, b)
    if isinstance(a, dict):
        assert set(a) == set(b), (path, sorted(a), sorted(b))
        for k in a:
            _close(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), (path, len(a), len(b))
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, f"{path}[{i}]")
    else:
        assert a == b, (path, a, b)


def _shape(obj):
    """Seeded sampled bodies: keys, choice count and indexes, usage prompt
    tokens, finish reasons."""
    return {"keys": sorted(obj),
            "choices": [(c["index"], sorted(c)) for c in obj["choices"]],
            "prompt_tokens": obj["usage"]["prompt_tokens"],
            "finish": {c["finish_reason"] for c in obj["choices"]} <= {
                "length", "stop"}}


async def _send(client: Client, e: dict):
    kw = {"headers": e["headers"]}
    if e["data"] is not None:
        kw["data"] = e["data"]
    elif e["body"] is not None:
        kw["json"] = e["body"]
    call = client.get if e["method"] == "GET" else client.post
    async with call(e["path"], **kw) as r:
        return r.status, dict(r.headers), await r.text()


def _families(text: str) -> set:
    return {line.split()[2] for line in text.splitlines()
            if line.startswith("# TYPE")}


@pytest.mark.parametrize("e", TABLE)
def test_request_matches_jax_server(servers, e):
    loop, client, jclient, _ = servers
    want = loop.run_until_complete(_send(jclient, e))
    got = loop.run_until_complete(_send(client, e))
    assert got[0] == want[0], (got, want)
    for h in ("Content-Type", "Retry-After"):
        assert got[1].get(h) == want[1].get(h), h
    rid_in = e["headers"].get(REQUEST_ID_HEADER)
    if rid_in and " " not in rid_in:
        assert got[1][REQUEST_ID_HEADER] == want[1][REQUEST_ID_HEADER] \
            == rid_in
    elif e["path"].startswith("/v1/") and got[0] != 404:
        assert _MINTED.sub(r"\1", got[1][REQUEST_ID_HEADER]) == \
            _MINTED.sub(r"\1", want[1][REQUEST_ID_HEADER])
    ctype = want[1].get("Content-Type", "")
    if e["path"] == "/metrics":
        _assert_valid_exposition(got[2])
        assert _families(got[2]) == _families(want[2])
    elif e["path"].startswith("/debug/"):
        assert set(json.loads(got[2])) == set(json.loads(want[2]))
    elif ctype.startswith("text/event-stream"):
        g, w = _frames(got[2]), _frames(want[2])
        assert g[-1] == w[-1] == "[DONE]"
        _close(g, w)
    elif ctype.startswith("application/json"):
        g, w = _norm_obj(json.loads(got[2])), _norm_obj(json.loads(want[2]))
        if e["seeded"]:
            assert _shape(g) == _shape(w)
        else:
            _close(g, w)
    else:
        assert got[2] == want[2]


def test_stop_string_parity_on_a_generated_string(servers):
    """A stop string taken from the greedy text itself, so the stop path
    really fires: text cut before it, finish "stop", the same on both."""
    loop, client, jclient, _ = servers
    body = {"prompt": [9, 40, 77], "max_tokens": 16, "temperature": 0.0}

    async def text_of(c, b):
        async with c.post("/v1/completions", json=b) as r:
            return (await r.json())["choices"][0]
    full = loop.run_until_complete(text_of(jclient, body))["text"]
    stop = next(full[i:i + 2] for i in range(3, len(full) - 1)
                if full[i:i + 2].strip("�"))
    for stream in (False, True):
        e = dict(path="/v1/completions", headers={}, method="POST",
                 seeded=False, data=None,
                 body={**body, "stop": [stop], "stream": stream})
        want = loop.run_until_complete(_send(jclient, e))
        got = loop.run_until_complete(_send(client, e))
        if stream:
            g, w = _frames(got[2]), _frames(want[2])
            assert g == w
            assert g[-2]["choices"][0]["finish_reason"] == "stop"
        else:
            g = json.loads(got[2])["choices"][0]
            assert g == json.loads(want[2])["choices"][0]
            assert g["finish_reason"] == "stop" and stop not in g["text"]
            assert full.startswith(g["text"])


def test_same_seed_twice_gives_the_same_text_on_the_port(servers):
    loop, client, _, _ = servers
    body = {"prompt": [2, 8, 4], "max_tokens": 8, "temperature": 1.0,
            "seed": 1234, "n": 2}

    async def go():
        outs = []
        for _ in range(2):
            async with client.post("/v1/completions", json=body) as r:
                outs.append([c["text"] for c in (await r.json())["choices"]])
        return outs
    a, b = loop.run_until_complete(go())
    assert a == b


def test_profile_capture_and_single_flight_guard(servers, tmp_path,
                                                 monkeypatch):
    """``POST /debug/profile`` writes a Chrome trace under the temp
    directory and returns the JAX server's keys; a second capture while
    one runs gets 409."""
    import tempfile
    loop, client, _, _ = servers
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))

    async def go():
        first = asyncio.ensure_future(
            client.post("/debug/profile?seconds=0.5"))
        await asyncio.sleep(0.2)
        async with client.post("/debug/profile?seconds=0.1") as busy:
            busy_status = busy.status
        r = await first
        body = await r.json()
        r.release()
        return r.status, body, busy_status
    status, body, busy = loop.run_until_complete(go())
    assert (status, busy) == (200, 409)
    assert set(body) == {"trace_dir", "seconds"} and body["seconds"] == 0.5
    [trace] = list((tmp_path / "kgct-profile").glob("trace-*.json"))
    assert "traceEvents" in json.loads(trace.read_text())


# -- the JAX package's server cases, re-pointed at the port ----------------

@pytest.fixture(scope="module")
def api_client(servers):
    loop, client, _, port = servers
    return loop, client


class TestByteTokenizer:
    def test_roundtrip(self):
        tok = ByteTokenizer()
        text = "hello, TPU! héllo é世界"
        ids = tok.encode(text)
        assert ids[0] == tok.BOS
        assert tok.decode(ids) == text

    def test_specials_skipped(self):
        tok = ByteTokenizer()
        assert tok.decode([tok.BOS, ord("h") + 3, tok.EOS]) == "h"


class TestIncrementalDetokenizer:
    def test_streams_deltas(self):
        tok = ByteTokenizer(add_bos=False)
        d = IncrementalDetokenizer(tok)
        out = d.push(tok.encode("hel")) + d.push(tok.encode("lo"))
        out += d.push([], final=True)
        assert out == "hello"

    def test_stop_string_across_pushes(self):
        tok = ByteTokenizer(add_bos=False)
        d = IncrementalDetokenizer(tok, stop=["END"])
        a = d.push(tok.encode("abcE"))
        assert "E" not in a          # held back: could start "END"
        b = d.push(tok.encode("NDxyz"))
        assert d.stopped
        assert a + b == "abc"

    def test_stop_string_not_matched_releases_holdback(self):
        tok = ByteTokenizer(add_bos=False)
        d = IncrementalDetokenizer(tok, stop=["END"])
        a = d.push(tok.encode("abcEN"))
        b = d.push(tok.encode("Q"), final=True)
        assert not d.stopped
        assert a + b == "abcENQ"

    def test_partial_utf8_held_back(self):
        tok = ByteTokenizer(add_bos=False)
        d = IncrementalDetokenizer(tok)
        raw = "é".encode("utf-8")
        a = d.push([raw[0] + 3])
        b = d.push([raw[1] + 3], final=True)
        assert a + b == "é"


class TestAPIServer:
    def test_health_and_models(self, api_client):
        loop, client = api_client

        async def go():
            r = await client.get("/health")
            assert r.status == 200
            assert (await r.json())["status"] == "ok"
            r = await client.get("/v1/models")
            data = await r.json()
            assert data["data"][0]["id"] == "debug-tiny"
        loop.run_until_complete(go())

    def test_completion_non_streaming(self, api_client):
        loop, client = api_client

        async def go():
            r = await client.post("/v1/completions", json={
                "prompt": "hello world", "max_tokens": 8, "temperature": 0.0})
            assert r.status == 200
            data = await r.json()
            assert data["object"] == "completion"
            assert data["usage"]["completion_tokens"] > 0
            assert isinstance(data["choices"][0]["text"], str)
            assert data["choices"][0]["finish_reason"] in ("stop", "length")
            return data
        d1 = loop.run_until_complete(go())
        d2 = loop.run_until_complete(go())
        # greedy determinism through the whole HTTP+engine stack
        assert d1["choices"][0]["text"] == d2["choices"][0]["text"]

    def test_completion_streaming_sse(self, api_client):
        loop, client = api_client

        async def go():
            r = await client.post("/v1/completions", json={
                "prompt": "stream me", "max_tokens": 8, "temperature": 0.0,
                "stream": True})
            assert r.status == 200
            assert r.headers["Content-Type"].startswith("text/event-stream")
            events = []
            async for line in r.content:
                line = line.decode().strip()
                if line.startswith("data: "):
                    payload = line[len("data: "):]
                    if payload == "[DONE]":
                        break
                    events.append(json.loads(payload))
            assert events, "no SSE events"
            assert events[-1]["choices"][0]["finish_reason"] in ("stop",
                                                                "length")
            return "".join(e["choices"][0].get("text", "") for e in events)
        text = loop.run_until_complete(go())

        async def non_stream():
            r = await client.post("/v1/completions", json={
                "prompt": "stream me", "max_tokens": 8, "temperature": 0.0})
            return (await r.json())["choices"][0]["text"]
        assert text == loop.run_until_complete(non_stream())

    def test_chat_completion(self, api_client):
        loop, client = api_client

        async def go():
            r = await client.post("/v1/chat/completions", json={
                "messages": [{"role": "user", "content": "hi"}],
                "max_tokens": 6, "temperature": 0.0})
            assert r.status == 200
            data = await r.json()
            assert data["object"] == "chat.completion"
            assert "content" in data["choices"][0]["message"]
        loop.run_until_complete(go())

    def test_token_ids_prompt_and_errors(self, api_client):
        loop, client = api_client

        async def go():
            r = await client.post("/v1/completions", json={
                "prompt": [5, 6, 7], "max_tokens": 4, "temperature": 0.0})
            assert r.status == 200
            r = await client.post("/v1/completions", json={"max_tokens": 4})
            assert r.status == 400
            r = await client.post("/v1/completions", data=b"not json")
            assert r.status == 400
        loop.run_until_complete(go())

    def test_metrics_endpoint(self, api_client):
        loop, client = api_client

        async def go():
            r = await client.get("/metrics")
            assert r.status == 200
            text = await r.text()
            assert "kgct_tokens_generated_total" in text
            assert "kgct_kv_pages_free" in text
            return text
        text = loop.run_until_complete(go())
        gen = [line for line in text.splitlines()
               if line.startswith("kgct_tokens_generated_total")]
        assert int(gen[0].split()[-1]) > 0   # previous tests generated tokens
        _assert_valid_exposition(text)
        for fam in ("kgct_ttft_seconds", "kgct_tpot_seconds",
                    "kgct_queue_wait_seconds", "kgct_step_seconds",
                    "kgct_request_e2e_seconds", "kgct_batch_size_per_step"):
            assert f"# TYPE {fam} histogram" in text, fam
            assert f"{fam}_bucket" in text, f"{fam}: no observations"
        assert 'le="+Inf"' in text
        assert "kgct_step_phase_seconds_total" in text

    def test_prefix_cache_metrics_on_fresh_scrape(self, api_client):
        loop, client = api_client

        async def go():
            r = await client.get("/metrics")
            return await r.text()
        text = loop.run_until_complete(go())
        for name, typ in (("kgct_prefix_cache_hit_ratio", "gauge"),
                          ("kgct_prefix_cache_hits_total", "counter"),
                          ("kgct_prefix_cache_misses_total", "counter")):
            assert f"# TYPE {name} {typ}" in text, name
            [line] = [ln for ln in text.splitlines()
                      if ln.startswith(name + " ")]
            value = float(line.split()[-1])
            assert value == value and value >= 0.0, line


class TestFleetTelemetry:
    """``test_serving.py::TestFleetTelemetry`` on the port's server: the
    device/SLO gauges present and nan-free, and ``kgct_jit_compiles_total``
    counting the decode programs the module's traffic built (keyed around
    the eager window on the CPU, captured graphs on the card)."""

    def test_new_gauges_present_and_nan_free(self, api_client):
        loop, client = api_client

        async def go():
            r = await client.post("/v1/completions", json={
                "prompt": "telemetry", "max_tokens": 6, "temperature": 0.0})
            assert r.status == 200
            r = await client.get("/metrics")
            return await r.text()
        text = loop.run_until_complete(go())
        _assert_valid_exposition(text)

        def val(prefix):
            [line] = [ln for ln in text.splitlines() if ln.startswith(prefix)]
            return float(line.rpartition(" ")[2])

        assert val("kgct_hbm_bytes_limit ") >= 0
        assert val("kgct_hbm_bytes_in_use ") >= 0
        assert val("kgct_jit_compiles_total ") > 0
        assert "# TYPE kgct_step_phase_mean_seconds gauge" in text
        assert val('kgct_step_phase_mean_seconds{phase="device_dispatch"}'
                   ) > 0
        att = val("kgct_slo_ttft_attainment_ratio ")
        assert 0.0 <= att <= 1.0
        assert val("kgct_slo_ttft_budget_ms ") > 0
        assert val("kgct_slo_goodput_tokens_per_sec ") >= 0

    def test_flightrecorder_endpoint(self, api_client):
        loop, client = api_client

        async def go():
            r = await client.get("/debug/flightrecorder")
            assert r.status == 200
            return await r.json()
        doc = loop.run_until_complete(go())
        assert doc["enabled"] is True
        kinds = {e["kind"] for e in doc["events"]}
        assert "arrival" in kinds and "snapshot" in kinds


class TestObservability:
    def test_debug_trace_perfetto_export(self, api_client):
        loop, client = api_client

        async def go():
            r = await client.post("/v1/completions", json={
                "prompt": "trace me", "max_tokens": 4, "temperature": 0.0})
            assert r.status == 200
            r = await client.get("/debug/trace")
            assert r.status == 200
            return await r.json()
        doc = loop.run_until_complete(go())
        evs = doc["traceEvents"]
        assert isinstance(evs, list) and evs
        assert any(e.get("ph") == "M" for e in evs)
        reqs = [e for e in evs if e.get("cat") == "request"]
        opens = {e["id"] for e in reqs if e["ph"] == "b"}
        closes = {e["id"] for e in reqs if e["ph"] == "e"}
        assert opens and opens & closes, "no complete request span"
        names = {e["name"] for e in reqs if e["ph"] == "n"}
        assert {"queued", "scheduled", "first_token"} <= names
        slices = [e for e in evs if e.get("ph") == "X"]
        assert {"schedule", "device_dispatch"} <= {s["name"] for s in slices}
        assert all(s["ts"] >= 0 and s["dur"] >= 0 for s in slices)
        json.dumps(doc)

    def test_trace_clear_param(self, api_client):
        loop, client = api_client

        async def go():
            r = await client.get("/debug/trace?clear=1")
            assert r.status == 200
            r2 = await client.get("/debug/trace")
            return await r2.json()
        doc = loop.run_until_complete(go())
        assert not [e for e in doc["traceEvents"]
                    if e.get("cat") == "request"]

    def test_phase_attribution_bookkeeping(self, servers):
        loop, client, _, server = servers

        async def go():
            r = await client.post("/v1/completions", json={
                "prompt": "phases", "max_tokens": 4, "temperature": 0.0})
            assert r.status == 200
        loop.run_until_complete(go())
        obs = server.engine.engine.obs
        assert obs.phases.steps_recorded > 0
        for phase in ("schedule", "host_prep", "device_dispatch",
                      "device_fetch", "postproc", "detokenize"):
            assert obs.phases.totals[phase] > 0.0, f"{phase} never recorded"
        b = obs.phases.breakdown()
        assert b["device_dispatch"]["count"] > 0
        assert b["device_dispatch"]["mean_ms"] >= 0
        d = obs.ttft_decomposition()
        assert d["samples"] > 0
        assert all(k in d for k in ("queue_ms", "prefill_ms",
                                    "first_fetch_ms"))


class TestRequestIdPropagation:
    def test_inbound_id_adopted_and_traced(self, api_client):
        loop, client = api_client
        rid = "req-test-correlate-1"

        async def go():
            r = await client.post(
                "/v1/completions",
                json={"prompt": "trace my id", "max_tokens": 4,
                      "temperature": 0.0},
                headers={REQUEST_ID_HEADER: rid})
            assert r.status == 200
            assert r.headers[REQUEST_ID_HEADER] == rid
            data = await r.json()
            assert data["id"] == rid
            rt = await client.get("/debug/trace")
            return await rt.json()
        doc = loop.run_until_complete(go())
        spans = [e for e in doc["traceEvents"]
                 if e.get("cat") == "request" and e.get("id") == rid]
        assert {e["ph"] for e in spans} >= {"b", "e"}, \
            "engine lifecycle trace does not carry the inbound id"

    def test_minted_id_on_success_and_errors(self, api_client):
        loop, client = api_client

        async def go():
            r = await client.post("/v1/completions", json={
                "prompt": "mint me", "max_tokens": 2, "temperature": 0.0})
            assert r.headers[REQUEST_ID_HEADER].startswith("cmpl-")
            assert (await r.json())["id"] == r.headers[REQUEST_ID_HEADER]
            r400 = await client.post("/v1/completions",
                                     json={"max_tokens": 2})
            assert r400.status == 400
            assert REQUEST_ID_HEADER in r400.headers
            rbad = await client.post(
                "/v1/completions",
                json={"prompt": "x", "max_tokens": 2, "temperature": 0.0},
                headers={REQUEST_ID_HEADER: "bad id with spaces"})
            assert rbad.headers[REQUEST_ID_HEADER] != "bad id with spaces"
            rs = await client.post("/v1/completions", json={
                "prompt": "s", "max_tokens": 2, "temperature": 0.0,
                "stream": True}, headers={REQUEST_ID_HEADER: "req-sse-7"})
            assert rs.headers[REQUEST_ID_HEADER] == "req-sse-7"
            await rs.read()
        loop.run_until_complete(go())

    def test_tracing_and_recorder_off_byte_identical(self, servers):
        loop, client, _, server = servers
        obs = server.engine.engine.obs
        body = {"prompt": "identical under observation", "max_tokens": 6,
                "temperature": 0.0}

        async def one():
            r = await client.post("/v1/completions", json=body)
            assert r.status == 200
            return (await r.json())["choices"][0]["text"]
        text_on = loop.run_until_complete(one())
        obs.tracer.enabled = False
        obs.flight.enabled = False
        try:
            text_off = loop.run_until_complete(one())
        finally:
            obs.tracer.enabled = True
            obs.flight.enabled = True
        assert text_on == text_off


class TestLogprobsAPI:
    def test_completions_logprobs(self, api_client):
        loop, client = api_client

        async def go():
            r = await client.post("/v1/completions", json={
                "prompt": [1, 5, 9], "max_tokens": 4, "temperature": 0.0,
                "logprobs": 1})
            assert r.status == 200
            body = await r.json()
            lp = body["choices"][0]["logprobs"]
            assert len(lp["token_logprobs"]) == len(lp["tokens"]) == 4
            assert all(isinstance(x, float) and x <= 0.0
                       for x in lp["token_logprobs"])
            r2 = await client.post("/v1/completions", json={
                "prompt": [1, 5, 9], "max_tokens": 4, "temperature": 0.0,
                "logprobs": 1})
            lp2 = (await r2.json())["choices"][0]["logprobs"]
            assert lp2["token_logprobs"] == lp["token_logprobs"]
            r3 = await client.post("/v1/completions", json={
                "prompt": [1, 5, 9], "max_tokens": 2, "logprobs": 5})
            assert r3.status == 200
            assert "top_logprobs" in (await r3.json())["choices"][0][
                "logprobs"]
            r4 = await client.post("/v1/completions", json={
                "prompt": [1, 5, 9], "max_tokens": 2, "temperature": 0.0})
            assert "logprobs" not in (await r4.json())["choices"][0]
        loop.run_until_complete(go())

    def test_streaming_logprobs_and_chat_rejection(self, api_client):
        loop, client = api_client

        async def go():
            r = await client.post("/v1/completions", json={
                "prompt": [1, 5, 9], "max_tokens": 4, "temperature": 0.0,
                "logprobs": 1, "stream": True})
            assert r.status == 200
            lps = []
            async for line in r.content:
                line = line.decode().strip()
                if line.startswith("data: ") and line != "data: [DONE]":
                    ev = json.loads(line[len("data: "):])
                    lp = ev["choices"][0].get("logprobs")
                    if lp:
                        assert len(lp["tokens"]) == len(lp["token_logprobs"])
                        lps.extend(lp["token_logprobs"])
                if line == "data: [DONE]":
                    break
            assert len(lps) == 4 and all(x <= 0 for x in lps)
            r = await client.post("/v1/chat/completions", json={
                "messages": [{"role": "user", "content": "hi"}],
                "max_tokens": 2, "logprobs": 1})
            assert r.status == 400
        loop.run_until_complete(go())


class TestSamplingTailAPI:
    def test_echo_completions(self, api_client):
        loop, client = api_client

        async def go():
            r = await client.post("/v1/completions", json={
                "prompt": "hi", "max_tokens": 3, "temperature": 0.0,
                "echo": True})
            assert r.status == 200
            body = await r.json()
            assert body["choices"][0]["text"].startswith("hi")
            r2 = await client.post("/v1/completions", json={
                "prompt": [1, 5, 9], "max_tokens": 2, "temperature": 0.0,
                "echo": True, "logprobs": 1})
            lp = (await r2.json())["choices"][0]["logprobs"]
            assert len(lp["token_logprobs"]) == 3 + 2
            assert lp["token_logprobs"][:3] == [None, None, None]
            assert all(x <= 0 for x in lp["token_logprobs"][3:])
            r3 = await client.post("/v1/chat/completions", json={
                "messages": [{"role": "user", "content": "x"}],
                "max_tokens": 2, "echo": True})
            assert r3.status == 400
        loop.run_until_complete(go())

    def test_echo_streaming_first_frame_is_prompt(self, api_client):
        loop, client = api_client

        async def go():
            r = await client.post("/v1/completions", json={
                "prompt": "hi", "max_tokens": 2, "temperature": 0.0,
                "echo": True, "stream": True})
            assert r.status == 200
            first = None
            async for line in r.content:
                line = line.decode().strip()
                if line == "data: [DONE]":
                    break
                if line.startswith("data: ") and first is None:
                    first = json.loads(line[len("data: "):])
            assert first["choices"][0]["text"] == "hi"
        loop.run_until_complete(go())

    def test_seed_reproducible_over_api(self, api_client):
        loop, client = api_client

        async def go():
            req = {"prompt": [2, 8, 4], "max_tokens": 6, "temperature": 1.0,
                   "seed": 1234, "logprobs": 1}
            a = (await (await client.post("/v1/completions",
                                          json=req)).json())
            b = (await (await client.post("/v1/completions",
                                          json=req)).json())
            la = a["choices"][0]["logprobs"]["token_logprobs"]
            lb = b["choices"][0]["logprobs"]["token_logprobs"]
            assert la == lb
        loop.run_until_complete(go())

    def test_logprobs_alternatives_over_api(self, api_client):
        loop, client = api_client

        async def go():
            r = await client.post("/v1/completions", json={
                "prompt": [1, 5, 9], "max_tokens": 3, "temperature": 0.0,
                "logprobs": 3})
            assert r.status == 200
            lp = (await r.json())["choices"][0]["logprobs"]
            assert len(lp["top_logprobs"]) == 3
            for chosen_lp, tops in zip(lp["token_logprobs"],
                                       lp["top_logprobs"]):
                assert 1 <= len(tops) <= 3
                assert max(tops.values()) >= chosen_lp - 1e-5
            r2 = await client.post("/v1/completions", json={
                "prompt": [1, 5], "max_tokens": 2, "logprobs": 9})
            assert r2.status == 400
            r3 = await client.post("/v1/completions", json={
                "prompt": [1, 5], "max_tokens": 2, "temperature": 0.0,
                "logprobs": 2, "echo": True})
            lp3 = (await r3.json())["choices"][0]["logprobs"]
            assert lp3["top_logprobs"][:2] == [None, None]
            assert len(lp3["top_logprobs"]) == 4
        loop.run_until_complete(go())

    def test_logit_bias_and_best_of(self, api_client):
        loop, client = api_client

        async def go():
            r = await client.post("/v1/completions", json={
                "prompt": [3, 1], "max_tokens": 3, "temperature": 0.0,
                "logit_bias": {"70": 100}, "logprobs": 1})
            assert r.status == 200
            # token id 70 maps to byte 'C' in the byte tokenizer (70-3=67)
            body = await r.json()
            assert body["choices"][0]["text"] == "CCC"
            r2 = await client.post("/v1/completions", json={
                "prompt": [3, 1], "max_tokens": 2, "logit_bias": {"5": 200}})
            assert r2.status == 400
            r3 = await client.post("/v1/completions", json={
                "prompt": [2, 8], "max_tokens": 4, "temperature": 1.0,
                "seed": 9, "best_of": 3})
            assert r3.status == 200
            assert len((await r3.json())["choices"]) == 1
            r4 = await client.post("/v1/completions", json={
                "prompt": [2, 8], "max_tokens": 2, "n": 3, "best_of": 2})
            assert r4.status == 400
        loop.run_until_complete(go())

    def test_penalties_accepted_and_validated(self, api_client):
        loop, client = api_client

        async def go():
            r = await client.post("/v1/completions", json={
                "prompt": [3, 1], "max_tokens": 4, "temperature": 0.5,
                "presence_penalty": 1.0, "frequency_penalty": 0.5})
            assert r.status == 200
            assert len((await r.json())["choices"]) == 1
            r2 = await client.post("/v1/completions", json={
                "prompt": [3, 1], "max_tokens": 2, "presence_penalty": 9.0})
            assert r2.status == 400
            msg = (await r2.json())["error"]["message"]
            assert "presence_penalty" in msg
        loop.run_until_complete(go())


class TestClientDisconnectAborts:
    """A client that goes away must not leave device work running: every
    handler exit path calls engine.abort. Requests here ask for FAR more
    tokens than the poll deadline allows, so a missing abort fails the
    test instead of passing slowly."""

    async def _wait_engine_idle(self, eng, deadline_s=8.0):
        deadline = time.monotonic() + deadline_s
        while eng.has_unfinished_requests():
            assert time.monotonic() < deadline, (
                "engine still has unfinished requests after client "
                "disconnect — abort path leaked device work")
            await asyncio.sleep(0.02)

    def test_streaming_disconnect_aborts_engine_request(self, servers):
        loop, client, _, server = servers

        async def go():
            eng = server.engine.engine
            r = await client.post("/v1/completions", json={
                "prompt": "run forever", "max_tokens": 400,
                "temperature": 0.0, "stream": True})
            assert r.status == 200
            async for line in r.content:
                if line.decode().strip().startswith("data: "):
                    break       # first token delivered: request is live
            assert eng.has_unfinished_requests()
            r.close()           # client vanishes mid-stream
            await self._wait_engine_idle(eng)
            r2 = await client.post("/v1/completions", json={
                "prompt": "still alive", "max_tokens": 4,
                "temperature": 0.0})
            assert r2.status == 200
        loop.run_until_complete(go())

    def test_n_gt_1_disconnect_aborts_all_subrequests(self, servers):
        loop, client, _, server = servers

        async def go():
            eng = server.engine.engine
            with pytest.raises(asyncio.TimeoutError):
                await client.post("/v1/completions", json={
                    "prompt": [2, 8, 4], "max_tokens": 400,
                    "temperature": 1.0, "seed": 3, "n": 2},
                    timeout=aiohttp.ClientTimeout(total=0.5))
            await self._wait_engine_idle(eng)
        loop.run_until_complete(go())

    def test_best_of_disconnect_aborts_all_candidates(self, servers):
        loop, client, _, server = servers

        async def go():
            eng = server.engine.engine
            with pytest.raises(asyncio.TimeoutError):
                await client.post("/v1/completions", json={
                    "prompt": [2, 8], "max_tokens": 400,
                    "temperature": 1.0, "seed": 7, "best_of": 3},
                    timeout=aiohttp.ClientTimeout(total=0.5))
            await self._wait_engine_idle(eng)
            r = await client.post("/v1/completions", json={
                "prompt": [2, 8], "max_tokens": 4, "temperature": 0.0})
            assert r.status == 200
        loop.run_until_complete(go())


@pytest.mark.parametrize("extra", [{}, {"n": 2, "seed": 3},
                                   {"best_of": 3, "seed": 7}],
                         ids=["plain", "n-2", "best-of-3"])
def test_client_timeout_aborts_before_max_tokens(servers, monkeypatch,
                                                  extra):
    """A non-streamed request whose client gives up after 0.5 s is
    aborted by the peer's close (the handler is cancelled while it awaits
    the engine): every engine request stops short of its 400 tokens."""
    loop, client, _, server = servers
    produced = {}
    inner = server.engine.generate

    async def generate(rid, ids, params, **kw):
        async for chunk in inner(rid, ids, params, **kw):
            produced[rid] = len(chunk.output_token_ids)
            yield chunk
    monkeypatch.setattr(server.engine, "generate", generate)

    async def go():
        # EOS (the byte tokenizer's id 2) biased away: each request has
        # 400 tokens of work, far more than the client waits for.
        with pytest.raises(asyncio.TimeoutError):
            await client.post("/v1/completions", json={
                "prompt": [2, 8, 4], "max_tokens": 400, "temperature": 1.0,
                "logit_bias": {"2": -100}, **extra},
                timeout=aiohttp.ClientTimeout(total=0.5))
        deadline = time.monotonic() + 8
        while server.engine.engine.has_unfinished_requests():
            assert time.monotonic() < deadline
            await asyncio.sleep(0.02)
    loop.run_until_complete(go())
    assert len(produced) == (1 if not extra else 2 if "n" in extra else 3)
    assert all(n < 400 for n in produced.values()), produced


class TestSessionAffinityPassthrough:
    def test_session_id_and_user_accepted_and_validated(self, api_client):
        loop, client = api_client

        async def go():
            r = await client.post("/v1/completions", json={
                "prompt": "hi", "max_tokens": 2, "temperature": 0.0,
                "session_id": "conv-1", "user": "u-9"})
            assert r.status == 200
            r2 = await client.post("/v1/completions", json={
                "prompt": "hi", "max_tokens": 2,
                "session_id": {"nested": "object"}})
            assert r2.status == 400
            assert "session_id" in (await r2.json())["error"]["message"]
            r3 = await client.post("/v1/completions", json={
                "prompt": "hi", "max_tokens": 2, "user": ["a", "b"]})
            assert r3.status == 400
        loop.run_until_complete(go())


class TestMultipleCompletions:
    def test_n_choices(self, api_client):
        loop, client = api_client

        async def go():
            r = await client.post("/v1/completions", json={
                "prompt": [2, 8, 4], "max_tokens": 4, "temperature": 0.0,
                "n": 2})
            assert r.status == 200
            body = await r.json()
            assert [c["index"] for c in body["choices"]] == [0, 1]
            assert body["choices"][0]["text"] == body["choices"][1]["text"]
            assert body["usage"]["completion_tokens"] == 8
            r = await client.post("/v1/completions", json={
                "prompt": [2, 8], "max_tokens": 2, "n": 2, "stream": True})
            assert r.status == 400
            r = await client.post("/v1/completions", json={
                "prompt": [2, 8], "max_tokens": 2, "n": 0})
            assert r.status == 400
        loop.run_until_complete(go())


class TestWorkerOpShutdownGuard:
    """An op enqueued after the worker thread's final wakeup can never
    drain — run_in_worker must fail the awaiter NOW and post_to_worker must
    drop loudly instead of enqueueing into the void. Engine-free."""

    def _dead_engine(self):
        from kubernetes_gpu_cluster_tpu_torch.serving.async_engine import (
            AsyncLLMEngine)
        eng = AsyncLLMEngine.__new__(AsyncLLMEngine)
        eng._cv = threading.Condition()
        eng._ops = []
        eng._shutdown = True
        eng._thread = threading.Thread()   # never started
        return eng

    def test_run_in_worker_fails_fast_after_shutdown(self):
        eng = self._dead_engine()

        async def go():
            with pytest.raises(RuntimeError, match="shut down"):
                await eng.run_in_worker(lambda e: 1)
        asyncio.run(go())
        assert eng._ops == []

    def test_post_to_worker_drops_after_shutdown(self):
        eng = self._dead_engine()
        eng.post_to_worker(lambda e: 1)
        assert eng._ops == []


# -- what the port refuses -------------------------------------------------

@pytest.mark.parametrize("argv,exc,match", [
    (["--distributed", "--tensor-parallel-size", "2"], ValueError,
     "KGCT_COORDINATOR"),
    (["--tensor-parallel-size", "8"], ValueError, "not divisible by tp=8"),
    (["--pipeline-parallel-size", "4"], ValueError, "not divisible by pp"),
    (["--pipeline-parallel-size", "2", "--sequence-parallel-size", "2"],
     ValueError, "sp and pp cannot combine"),
    (["--expert-parallel-size", "2"], SystemExit, None)])
def test_cli_refuses_fleet_and_parallel_flags(argv, exc, match, capsys):
    """What the CLI refuses, before any rank starts: pp that does not
    divide the layers (debug-tiny has 2); sp and pp together; tp that does
    not divide the heads; ep on a dense model; ``--distributed`` across
    ranks without the ``KGCT_*`` rendezvous. tp, ep, pp and sp serve
    (``tests/test_torch_distributed.py``), as do the fleet flags
    (``tests/test_torch_fleet.py``)."""
    from kubernetes_gpu_cluster_tpu_torch.serving.api_server import main
    with pytest.raises(exc, match=match):
        main(["--model", "debug-tiny", "--device", "cpu", *argv])
    if exc is SystemExit:
        assert "requires an MoE model" in capsys.readouterr().err


def test_cli_without_a_card_fails_at_once():
    from kubernetes_gpu_cluster_tpu_torch.serving.api_server import main
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--model", "debug-tiny"])
