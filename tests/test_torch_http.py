"""The port's HTTP/1.1 layer (``serving/http.py``) alone, over real sockets:
keep-alive, routing errors, body limits, chunked bodies, 100-continue,
malformed input, handler cancellation on client disconnect, and chunked SSE
framing as aiohttp's client and ``http.client`` read it."""

import asyncio
import contextlib
import http.client
import json
import socket

import aiohttp
import pytest

from kubernetes_gpu_cluster_tpu_torch.serving.http import (
    Application, Response, Server, StreamResponse, json_response)


@contextlib.asynccontextmanager
async def serving(app):
    server = Server(app)
    await server.start("127.0.0.1", 0)
    try:
        yield server.port
    finally:
        await server.close()


def _echo_app(**kw):
    app = Application(**kw)
    conns = []

    async def echo(request):
        conns.append(id(request._conn))
        return json_response({"method": request.method,
                              "path": request.path,
                              "query": request.query,
                              "n": len(request.body),
                              "ua": request.headers.get("user-agent")})

    async def sse(request):
        resp = StreamResponse(headers={"Content-Type": "text/event-stream"})
        await resp.prepare(request)
        for i in range(3):
            await resp.write(f"data: {json.dumps({'i': i})}\n\n".encode())
        await resp.write(b"data: [DONE]\n\n")
        await resp.write_eof()
        return resp

    app.add_get("/echo", echo)
    app.add_post("/echo", echo)
    app.add_get("/sse", sse)
    return app, conns


def _raw(port, data: bytes) -> bytes:
    """Send ``data`` on a fresh socket and read until the server closes."""
    with socket.create_connection(("127.0.0.1", port), timeout=10) as s:
        s.sendall(data)
        out = b""
        while True:
            chunk = s.recv(65536)
            if not chunk:
                return out
            out += chunk


def test_keep_alive_serves_requests_on_one_connection():
    app, conns = _echo_app()

    async def go():
        async with serving(app) as port:
            def client():
                c = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
                outs = []
                for i in range(3):
                    c.request("GET", f"/echo?i={i}&x=")
                    r = c.getresponse()
                    outs.append((r.status, json.loads(r.read())))
                c.close()
                return outs
            return await asyncio.to_thread(client)
    outs = asyncio.run(go())
    assert [s for s, _ in outs] == [200, 200, 200]
    assert [o["query"] for _, o in outs] == [{"i": str(i), "x": ""}
                                             for i in range(3)]
    assert len(set(conns)) == 1, "the three requests used three connections"


def test_routing_errors_and_body_limit():
    app, _ = _echo_app(client_max_size=1000)

    async def go():
        async with serving(app) as port:
            async with aiohttp.ClientSession() as s:
                r404 = await s.get(f"http://127.0.0.1:{port}/nope")
                r405 = await s.delete(f"http://127.0.0.1:{port}/echo")
                r200 = await s.post(f"http://127.0.0.1:{port}/echo",
                                    data=b"x" * 1000)
                out = (r404.status, r405.status, r405.headers.get("Allow"),
                       r200.status, (await r200.json())["n"])
            # Oversize Content-Length: 413 before any body byte is read.
            big = await asyncio.to_thread(
                _raw, port, b"POST /echo HTTP/1.1\r\nHost: x\r\n"
                b"Content-Length: 1001\r\n\r\n")
            return out, big
    out, big = asyncio.run(go())
    assert out == (404, 405, "GET,POST", 200, 1000)
    assert big.startswith(b"HTTP/1.1 413 ")
    assert b"Connection: close" in big


def test_chunked_body_and_expect_continue():
    app, _ = _echo_app()

    async def go():
        async with serving(app) as port:
            def chunked():
                c = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
                c.request("POST", "/echo", body=iter([b"ab", b"cde", b"f"]),
                          encode_chunked=True,
                          headers={"Transfer-Encoding": "chunked"})
                r = c.getresponse()
                return r.status, json.loads(r.read())["n"]

            def expect_continue():
                with socket.create_connection(("127.0.0.1", port),
                                              timeout=10) as s:
                    s.sendall(b"POST /echo HTTP/1.1\r\nHost: x\r\n"
                              b"Expect: 100-continue\r\n"
                              b"Content-Length: 4\r\n\r\n")
                    interim = s.recv(1024)
                    s.sendall(b"abcd")
                    f = s.makefile("rb")
                    status = f.readline()
                    return interim, status
            return (await asyncio.to_thread(chunked),
                    await asyncio.to_thread(expect_continue))
    chunked, (interim, status) = asyncio.run(go())
    assert chunked == (200, 6)
    assert interim == b"HTTP/1.1 100 Continue\r\n\r\n"
    assert status.startswith(b"HTTP/1.1 200 ")


@pytest.mark.parametrize("request_bytes", [
    b"GET /" + b"a" * 9000 + b" HTTP/1.1\r\n\r\n",
    b"GET /echo HTTP/1.1\r\nX-Long: " + b"b" * 9000 + b"\r\n\r\n",
], ids=["request-line", "header-line"])
def test_over_long_line_answered_431_when_it_arrives_whole(request_bytes):
    """A line over MAX_LINE is refused even when its newline came in the
    same read (the bound is checked on the line found, not only while one
    is incomplete)."""
    app, _ = _echo_app()

    async def go():
        async with serving(app) as port:
            return await asyncio.to_thread(_raw, port, request_bytes)
    out = asyncio.run(go())
    assert out.startswith(b"HTTP/1.1 431 "), out[:80]


@pytest.mark.parametrize("request_bytes", [
    b"GARBAGE\r\n\r\n",
    b"GET /echo\r\n\r\n",
    b"GET /echo HTTP/1.1\r\nno colon here\r\n\r\n",
    b"POST /echo HTTP/1.1\r\nContent-Length: ten\r\n\r\n",
], ids=["no-spaces", "no-version", "bad-header", "bad-length"])
def test_malformed_request_answered_400(request_bytes):
    app, _ = _echo_app()

    async def go():
        async with serving(app) as port:
            return await asyncio.to_thread(_raw, port, request_bytes)
    out = asyncio.run(go())
    assert out.startswith(b"HTTP/1.1 400 "), out


@pytest.mark.parametrize("streamed", [False, True], ids=["plain", "stream"])
def test_peer_close_cancels_the_handler(streamed):
    """A peer that closes before the response is complete cancels the
    handler, so its ``finally`` runs: while it awaits (plain) and after its
    first chunk went out (stream)."""
    app = Application()
    state = {"entered": asyncio.Event(), "finally": False,
             "cancelled": False}

    async def hang(request):
        try:
            if streamed:
                resp = StreamResponse()
                await resp.prepare(request)
                await resp.write(b"data: first\n\n")
            state["entered"].set()
            await asyncio.Event().wait()
        except asyncio.CancelledError:
            state["cancelled"] = True
            raise
        finally:
            state["finally"] = True
        return Response(text="never")

    app.add_get("/hang", hang)

    async def go():
        async with serving(app) as port:
            reader, writer = await asyncio.open_connection("127.0.0.1", port)
            writer.write(b"GET /hang HTTP/1.1\r\nHost: x\r\n\r\n")
            await writer.drain()
            await asyncio.wait_for(state["entered"].wait(), 10)
            if streamed:
                head = await reader.readuntil(b"first\n\n\r\n")
                assert b"Transfer-Encoding: chunked" in head
            writer.close()
            for _ in range(500):
                if state["finally"]:
                    break
                await asyncio.sleep(0.01)
            # Cancelled by the close itself, not by the server's shutdown.
            ran = state["cancelled"] and state["finally"]
            # The server keeps serving new connections.
            async with aiohttp.ClientSession() as s:
                r = await s.get(f"http://127.0.0.1:{port}/missing")
                return ran, r.status
    assert asyncio.run(go()) == (True, 404)


def test_sse_framing_read_by_aiohttp_and_http_client():
    app, _ = _echo_app()

    def frames(lines):
        out = []
        for line in lines:
            line = line.strip()
            if line.startswith("data: "):
                out.append(line[len("data: "):])
        return out

    async def go():
        async with serving(app) as port:
            async with aiohttp.ClientSession() as s:
                r = await s.get(f"http://127.0.0.1:{port}/sse")
                assert r.headers["Content-Type"] == "text/event-stream"
                a = frames([ln.decode() async for ln in r.content])

            def with_http_client():
                c = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
                c.request("GET", "/sse")
                r = c.getresponse()
                lines = r.read().decode().splitlines()
                # The connection stays usable after the chunked body.
                c.request("GET", "/echo")
                r2 = c.getresponse()
                r2.read()
                return lines, r2.status
            lines, status2 = await asyncio.to_thread(with_http_client)
            return a, frames(lines), status2
    a, b, status2 = asyncio.run(go())
    want = [json.dumps({"i": i}) for i in range(3)] + ["[DONE]"]
    assert a == b == want
    assert status2 == 200
