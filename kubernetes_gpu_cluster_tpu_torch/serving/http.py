"""A minimal HTTP/1.1 server on asyncio streams: the port's counterpart of
the part of aiohttp's ``web`` that the JAX package's server uses.

The card's machine has no aiohttp, so the port serves the same routes,
JSON bodies and SSE streams through this module, which needs only the
standard library:

- ``Request``: method, path, query, case-insensitive headers, the body
  (read in full before the handler runs, bounded by the application's
  ``client_max_size``: an oversize ``Content-Length`` is answered 413
  before a byte of the body is read), ``json()``, and a per-request stash
  (``request["kgct_request_id"]``);
- ``Response`` / ``json_response``: a body sent with ``Content-Length``
  (``json.dumps`` bodies, ``application/json; charset=utf-8``, as aiohttp);
- ``StreamResponse``: ``prepare()`` commits the status and headers,
  ``write()`` sends one chunk (``Transfer-Encoding: chunked``), and
  ``write_eof()`` ends the body;
- ``Application``: a route table (404 for an unknown path, 405 with
  ``Allow`` for a known path under another method), one middleware, and
  startup / cleanup hooks;
- ``Server``: the listener. Connections are kept alive across requests;
  chunked request bodies and ``Expect: 100-continue`` are understood.

Client disconnect: while a handler runs, its connection is watched for
end-of-file. When the peer closes before the response is complete, the
handler's task is cancelled, so its ``finally`` blocks run (the API
server aborts the engine request there) whether it was awaiting the
engine or writing a stream.

The client half (``ClientSession``) is the part of aiohttp's
``ClientSession`` the fleet plane uses for its peer calls: ``post`` /
``get`` as async context managers over ``http://`` or ``https://``, one
connection per request, a request body sent with ``Content-Length``, a
response body read by ``Content-Length``, by chunked transfer coding or to
end of file, and one wall bound over the whole exchange (aiohttp's
``ClientTimeout(total=...)``), which raises ``asyncio.TimeoutError``.
"""

from __future__ import annotations

import asyncio
import contextlib
import json
import signal
import ssl
from collections.abc import MutableMapping
from http import HTTPStatus
from typing import Any, Awaitable, Callable, Iterator, Optional
from urllib.parse import parse_qsl, urlsplit

from ..utils import get_logger

logger = get_logger("serving.http")

Handler = Callable[["Request"], Awaitable["Response"]]

DEFAULT_MAX_BODY = 1 << 20          # aiohttp's default client_max_size
MAX_LINE = 8190                     # request line / one header line
MAX_HEADERS = 100
_READ_SIZE = 1 << 16


class StreamSevered(Exception):
    """Raised by a handler whose committed response must end WITHOUT its
    terminating chunk: the connection closes, and the truncated body is
    the peer's signal (a migrated stream's relay reads it as its failover
    cue). Not a handler failure: nothing is logged as one."""


class BadRequest(Exception):
    """The request cannot be parsed (answered, then the connection
    closes)."""

    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status


class Headers(MutableMapping):
    """Case-insensitive header map that keeps each name's first spelling."""

    def __init__(self, items=()):
        self._d: dict[str, tuple[str, str]] = {}
        for k, v in (items.items() if hasattr(items, "items") else items):
            self[k] = v

    def __getitem__(self, key: str) -> str:
        return self._d[key.lower()][1]

    def __setitem__(self, key: str, value) -> None:
        old = self._d.get(key.lower())
        self._d[key.lower()] = (old[0] if old else key, str(value))

    def __delitem__(self, key: str) -> None:
        del self._d[key.lower()]

    def __iter__(self) -> Iterator[str]:
        return (name for name, _ in self._d.values())

    def __len__(self) -> int:
        return len(self._d)


def _media_type(headers: Headers) -> str:
    """The Content-Type without parameters (aiohttp's default when the
    header is absent)."""
    ctype = headers.get("Content-Type", "application/octet-stream")
    return ctype.split(";")[0].strip().lower()


def _content_length(headers: Headers) -> Optional[int]:
    length = headers.get("Content-Length")
    return int(length) if length is not None and length.isdigit() else None


class Request:
    def __init__(self, method: str, target: str, version: str,
                 headers: Headers, body: bytes, conn: "_Connection"):
        self.method = method
        parts = urlsplit(target)
        self.path = parts.path
        self.query = dict(parse_qsl(parts.query, keep_blank_values=True))
        self.version = version
        self.headers = headers
        self.body = body
        self._conn = conn
        self._stash: dict[str, Any] = {}

    async def json(self) -> Any:
        return json.loads(self.body)

    async def read(self) -> bytes:
        return self.body

    @property
    def content_type(self) -> str:
        return _media_type(self.headers)

    @property
    def content_length(self) -> Optional[int]:
        return _content_length(self.headers)

    def __getitem__(self, key: str) -> Any:
        return self._stash[key]

    def __setitem__(self, key: str, value: Any) -> None:
        self._stash[key] = value

    def get(self, key: str, default: Any = None) -> Any:
        return self._stash.get(key, default)


def _status_line(status: int) -> bytes:
    try:
        reason = HTTPStatus(status).phrase
    except ValueError:
        reason = ""
    return f"HTTP/1.1 {status} {reason}\r\n".encode("latin-1")


def _head(status: int, headers: Headers) -> bytes:
    lines = [_status_line(status)]
    lines += [f"{k}: {v}\r\n".encode("latin-1") for k, v in headers.items()]
    lines.append(b"\r\n")
    return b"".join(lines)


class Response:
    """A complete response, sent with ``Content-Length``."""

    prepared = False

    def __init__(self, *, body: bytes = b"", text: Optional[str] = None,
                 status: int = 200, headers=None,
                 content_type: Optional[str] = None):
        self.status = status
        self.headers = Headers(headers or ())
        if text is not None:
            body = text.encode("utf-8")
            content_type = f"{content_type or 'text/plain'}; charset=utf-8"
        if content_type is not None:
            self.headers["Content-Type"] = content_type
        elif "Content-Type" not in self.headers:
            self.headers["Content-Type"] = "application/octet-stream"
        self.body = body

    async def _send(self, conn: "_Connection", keep_alive: bool) -> None:
        self.headers["Content-Length"] = str(len(self.body))
        if not keep_alive:
            self.headers["Connection"] = "close"
        # Two writes: a KV frame body is hundreds of MB, never copied
        # into a joined buffer.
        conn.writer.write(_head(self.status, self.headers))
        await conn.write(self.body)


def json_response(data: Any, *, status: int = 200, headers=None) -> Response:
    return Response(text=json.dumps(data), status=status, headers=headers,
                    content_type="application/json")


class StreamResponse:
    """A response whose body is written piece by piece, each ``write`` one
    chunk of a ``Transfer-Encoding: chunked`` body."""

    def __init__(self, *, status: int = 200, headers=None):
        self.status = status
        self.headers = Headers(headers or ())
        self.prepared = False
        self._eof = False
        self._conn: Optional[_Connection] = None

    async def prepare(self, request: Request) -> None:
        if self.prepared:
            return
        self._conn = request._conn
        self.headers["Transfer-Encoding"] = "chunked"
        self.prepared = True
        self._conn.committed = True
        await self._conn.write(_head(self.status, self.headers))

    async def write(self, data: bytes) -> None:
        if not self.prepared or self._eof:
            raise RuntimeError("write() outside prepare() ... write_eof()")
        if data:
            await self._conn.write(b"%x\r\n%s\r\n" % (len(data), data))

    async def write_eof(self) -> None:
        if self.prepared and not self._eof:
            self._eof = True
            await self._conn.write(b"0\r\n\r\n")


class Application:
    """Routes, one middleware ``(request, handler) -> response`` wrapped
    around every routed handler, and startup / cleanup hooks, each called
    with the application."""

    def __init__(self, middleware: Optional[Callable] = None,
                 client_max_size: int = DEFAULT_MAX_BODY):
        self.middleware = middleware
        self.client_max_size = client_max_size
        self._routes: dict[str, dict[str, Handler]] = {}
        self.on_startup: list[Callable] = []
        self.on_cleanup: list[Callable] = []

    def add_route(self, method: str, path: str, handler: Handler) -> None:
        self._routes.setdefault(path, {})[method.upper()] = handler

    def add_get(self, path: str, handler: Handler) -> None:
        self.add_route("GET", path, handler)

    def add_post(self, path: str, handler: Handler) -> None:
        self.add_route("POST", path, handler)

    async def handle(self, request: Request):
        methods = self._routes.get(request.path)
        if methods is None:
            return Response(text="404: Not Found", status=404)
        handler = methods.get(request.method)
        if handler is None:
            return Response(text="405: Method Not Allowed", status=405,
                            headers={"Allow": ",".join(sorted(methods))})
        if self.middleware is None:
            return await handler(request)
        return await self.middleware(request, handler)


class _Connection:
    """One client connection: a read buffer over the stream (so the
    disconnect watch can read ahead without losing a pipelined request)
    and the writer."""

    def __init__(self, reader: asyncio.StreamReader,
                 writer: asyncio.StreamWriter):
        self.reader = reader
        self.writer = writer
        self.buf = bytearray()
        # True once the current request's status line has been sent.
        self.committed = False

    async def _fill(self) -> bool:
        data = await self.reader.read(_READ_SIZE)
        self.buf += data
        return bool(data)

    async def readline(self) -> Optional[bytes]:
        """One CRLF-terminated line without its terminator; None at a clean
        end of stream before any byte of it."""
        while True:
            i = self.buf.find(b"\n", 0, MAX_LINE + 2)
            if i >= 0:
                line = bytes(self.buf[:i])
                del self.buf[:i + 1]
                return line.rstrip(b"\r")
            if len(self.buf) > MAX_LINE:
                raise BadRequest(431, "header line too long")
            if not await self._fill():
                if self.buf:
                    raise asyncio.IncompleteReadError(bytes(self.buf), None)
                return None

    async def readexactly(self, n: int) -> bytes:
        while len(self.buf) < n:
            if not await self._fill():
                raise asyncio.IncompleteReadError(bytes(self.buf), n)
        data = bytes(self.buf[:n])
        del self.buf[:n]
        return data

    async def wait_closed_by_peer(self, cap: int) -> None:
        """Return when the peer closes its side. Read-ahead (a pipelined
        request) stays in the buffer; past ``cap`` bytes of it the watch
        stops reading and never returns."""
        while len(self.buf) <= cap:
            if not await self._fill():
                return
        await asyncio.Event().wait()

    async def write(self, data: bytes) -> None:
        self.writer.write(data)
        await self.writer.drain()


async def _read_request(conn: _Connection, max_body: int
                        ) -> Optional[Request]:
    line = await conn.readline()
    while line == b"":             # tolerate CRLFs between requests
        line = await conn.readline()
    if line is None:
        return None
    try:
        method, target, version = line.decode("latin-1").split(" ")
    except ValueError:
        raise BadRequest(400, "malformed request line") from None
    if not version.startswith("HTTP/1.") or not method.isalpha() \
            or not target.startswith("/"):
        raise BadRequest(400, "malformed request line")
    headers = Headers()
    while True:
        hl = await conn.readline()
        if hl is None:
            raise asyncio.IncompleteReadError(b"", None)
        if not hl:
            break
        if len(headers) >= MAX_HEADERS:
            raise BadRequest(431, "too many headers")
        name, sep, value = hl.decode("latin-1").partition(":")
        if not sep or not name or name != name.strip():
            raise BadRequest(400, "malformed header line")
        headers[name] = value.strip()
    chunked = "chunked" in headers.get("Transfer-Encoding", "").lower()
    length = headers.get("Content-Length")
    if length is not None and not chunked:
        if not length.isdigit():
            raise BadRequest(400, "invalid Content-Length")
        if int(length) > max_body:
            raise BadRequest(413, f"request body exceeds {max_body} bytes")
    if headers.get("Expect", "").lower() == "100-continue":
        await conn.write(b"HTTP/1.1 100 Continue\r\n\r\n")
    if chunked:
        body = bytearray()
        while True:
            size_line = await conn.readline()
            if size_line is None:
                raise asyncio.IncompleteReadError(bytes(body), None)
            try:
                size = int(size_line.split(b";")[0].strip(), 16)
            except ValueError:
                raise BadRequest(400, "malformed chunk size") from None
            if size == 0:
                while await conn.readline():      # trailers
                    pass
                break
            if len(body) + size > max_body:
                raise BadRequest(413, f"request body exceeds {max_body} "
                                      "bytes")
            body += await conn.readexactly(size)
            await conn.readexactly(2)             # the chunk's CRLF
        body = bytes(body)
    else:
        body = await conn.readexactly(int(length or 0))
    return Request(method, target, version, headers, body, conn)


def _keep_alive(request: Request) -> bool:
    conn = request.headers.get("Connection", "").lower()
    if request.version == "HTTP/1.0":
        return conn == "keep-alive"
    return conn != "close"


class Server:
    """Serves an ``Application`` on ``host:port`` (port 0: any free port,
    read back from ``port`` after ``start``)."""

    def __init__(self, app: Application):
        self.app = app
        self.port: Optional[int] = None
        self._server: Optional[asyncio.Server] = None
        self._conns: set[asyncio.Task] = set()

    async def start(self, host: str = "127.0.0.1", port: int = 0) -> None:
        for hook in self.app.on_startup:
            await hook(self.app)
        self._server = await asyncio.start_server(self._serve, host, port)
        self.port = self._server.sockets[0].getsockname()[1]
        logger.info("serving on http://%s:%d", host, self.port)

    async def close(self) -> None:
        server, self._server = self._server, None
        if server is None:
            return
        server.close()
        for task in list(self._conns):
            task.cancel()
        if self._conns:
            await asyncio.gather(*self._conns, return_exceptions=True)
        await server.wait_closed()
        for hook in self.app.on_cleanup:
            await hook(self.app)

    async def _serve(self, reader: asyncio.StreamReader,
                     writer: asyncio.StreamWriter) -> None:
        task = asyncio.current_task()
        self._conns.add(task)
        conn = _Connection(reader, writer)
        try:
            while True:
                try:
                    request = await _read_request(
                        conn, self.app.client_max_size)
                except BadRequest as e:
                    await Response(text=f"{e.status}: {e}",
                                   status=e.status)._send(conn, False)
                    return
                if request is None:
                    return
                keep_alive = _keep_alive(request)
                conn.committed = False
                resp = await self._respond(conn, request)
                if resp is None:          # the peer went away
                    return
                if resp.prepared:
                    await resp.write_eof()
                else:
                    await resp._send(conn, keep_alive)
                if not keep_alive:
                    return
        except (ConnectionError, asyncio.IncompleteReadError):
            pass
        finally:
            self._conns.discard(task)
            writer.close()
            with contextlib.suppress(Exception):
                await writer.wait_closed()

    async def _respond(self, conn: _Connection, request: Request):
        """Run the handler while watching the connection; None when the
        peer closed first (the handler was cancelled)."""
        handler = asyncio.ensure_future(self._call(request))
        watch = asyncio.ensure_future(
            conn.wait_closed_by_peer(self.app.client_max_size))
        try:
            await asyncio.wait({handler, watch},
                               return_when=asyncio.FIRST_COMPLETED)
        finally:
            if not handler.done():
                handler.cancel()
            watch.cancel()
            await asyncio.gather(handler, watch, return_exceptions=True)
        if handler.cancelled():
            return None
        return handler.result()

    async def _call(self, request: Request):
        try:
            return await self.app.handle(request)
        except (ConnectionError, asyncio.CancelledError):
            raise
        except Exception as e:
            if isinstance(e, StreamSevered) and request._conn.committed:
                logger.info("%s %s: %s; connection closed", request.method,
                            request.path, e)
                raise ConnectionAbortedError(str(e)) from None
            logger.exception("handler failed: %s %s", request.method,
                             request.path)
            if request._conn.committed:
                # Headers are out: the truncated body is the only signal
                # left, so the connection closes.
                raise ConnectionAbortedError("handler failed mid-response")
            return Response(text="500: Internal Server Error", status=500)


# -- client -----------------------------------------------------------------

DEFAULT_TIMEOUT_S = 300.0           # aiohttp's default total bound
_CLIENT_READ_SIZE = 1 << 20          # a KV frame is hundreds of MB


class ClientError(ConnectionError):
    """A response that cannot be parsed, or a peer that broke the framing
    (a line over ``MAX_LINE``, a malformed chunk size, too many
    headers)."""


class ClientResponse:
    """One response: ``status``, case-insensitive ``headers``, and its body,
    read under the request's wall bound with ``read(n)`` (at most ``n``
    bytes, fewer only at the end of the body) or ``iter_chunked(size)``."""

    def __init__(self, reader: asyncio.StreamReader,
                 writer: asyncio.StreamWriter, deadline: float):
        self._reader = reader
        self._writer = writer
        self._deadline = deadline
        self._buf = bytearray()
        self._at_eof = False          # the stream has no more bytes
        self._done = False            # the body has no more bytes
        self._mode = "eof"            # "length" | "chunked" | "eof"
        self._left = 0                # of the body ("length") or the chunk
        self.status = 0
        self.reason = ""
        self.headers = Headers()

    @property
    def content_type(self) -> str:
        return _media_type(self.headers)

    @property
    def content_length(self) -> Optional[int]:
        return _content_length(self.headers)

    async def _io(self, aw):
        """``aw`` under what is left of the wall bound."""
        async with asyncio.timeout_at(self._deadline):
            return await aw

    async def _fill(self) -> bool:
        if self._at_eof:
            return False
        data = await self._io(self._reader.read(_CLIENT_READ_SIZE))
        if not data:
            self._at_eof = True
            return False
        self._buf += data
        return True

    async def _readline(self, what: str) -> bytes:
        while True:
            i = self._buf.find(b"\n", 0, MAX_LINE + 2)
            if i >= 0:
                line = bytes(self._buf[:i])
                del self._buf[:i + 1]
                return line.rstrip(b"\r")
            if len(self._buf) > MAX_LINE:
                raise ClientError(f"{what} over {MAX_LINE} bytes")
            if not await self._fill():
                raise ClientError(f"connection closed inside a {what}")

    async def _start(self, method: str) -> None:
        while True:
            line = await self._readline("status line")
            parts = line.decode("latin-1").split(" ", 2)
            if len(parts) < 2 or not parts[0].startswith("HTTP/1.") \
                    or not parts[1].isdigit():
                raise ClientError(f"malformed status line {line[:80]!r}")
            self.status = int(parts[1])
            self.reason = parts[2] if len(parts) > 2 else ""
            self.headers = Headers()
            while (hl := await self._readline("header line")):
                if len(self.headers) >= MAX_HEADERS:
                    raise ClientError("too many response headers")
                name, sep, value = hl.decode("latin-1").partition(":")
                if not sep or not name.strip():
                    raise ClientError(f"malformed header line {hl[:80]!r}")
                self.headers[name.strip()] = value.strip()
            if self.status >= 200:
                break                   # 1xx: the real response follows
        if method == "HEAD" or self.status in (204, 304):
            self._done = True
        elif "chunked" in self.headers.get("Transfer-Encoding", "").lower():
            self._mode = "chunked"
        elif self.content_length is not None:
            self._mode, self._left = "length", self.content_length
            self._done = self._left == 0

    async def _next_piece(self, n: int) -> bytes:
        """Up to ``n`` bytes of the body (b"" at its end): whatever has
        arrived, across chunk boundaries, waiting only when nothing has."""
        out = bytearray()
        while len(out) < n and not self._done:
            if self._mode == "chunked" and self._left == 0:
                if out and b"\n" not in self._buf:
                    break                   # the next chunk is not here yet
                size_line = await self._readline("chunk-size line")
                try:
                    size = int(size_line.split(b";")[0].strip(), 16)
                except ValueError:
                    raise ClientError("malformed chunk size") from None
                if size == 0:
                    while await self._readline("trailer line"):
                        pass
                    self._done = True
                    break
                self._left = size
            if not self._buf:
                if out:
                    break
                if not await self._fill():
                    if self._mode != "eof":
                        raise ClientError("connection closed inside the "
                                          "body")
                    self._done = True
                continue
            take = len(self._buf) if self._mode == "eof" else self._left
            take = min(take, n - len(out), len(self._buf))
            out += self._buf[:take]
            del self._buf[:take]
            if self._mode != "eof":
                self._left -= take
                if self._left == 0:
                    if self._mode == "length":
                        self._done = True
                    else:
                        while len(self._buf) < 2:        # the chunk's CRLF
                            if not await self._fill():
                                raise ClientError("truncated chunk")
                        del self._buf[:2]
        return bytes(out)

    async def read(self, n: int = -1) -> bytearray:
        """The body up to ``n`` bytes (all of it for ``n < 0``)."""
        out = bytearray()
        while n < 0 or len(out) < n:
            piece = await self._next_piece(
                _CLIENT_READ_SIZE if n < 0 else min(n - len(out), 1 << 24))
            if not piece:
                break
            out += piece
        return out

    async def iter_chunked(self, size: int):
        """The body in pieces of at most ``size`` bytes, as they arrive."""
        while (piece := await self._next_piece(size)):
            yield piece

    async def text(self) -> str:
        return (await self.read()).decode("utf-8", errors="replace")

    async def json(self) -> Any:
        return json.loads(await self.read())

    def close(self) -> None:
        self._writer.close()


class _RequestContext:
    def __init__(self, session: "ClientSession", method: str, url: str,
                 body: bytes, headers: Headers, timeout_s: float):
        self._session = session
        self._args = (method, url, body, headers, timeout_s)
        self._resp: Optional[ClientResponse] = None

    async def __aenter__(self) -> ClientResponse:
        self._resp = await self._session._request(*self._args)
        return self._resp

    async def __aexit__(self, *exc) -> None:
        self._session._close(self._resp)


class ClientSession:
    """``post`` / ``get`` as async context managers, one connection per
    request. ``timeout_s`` bounds the whole exchange: connect, the request,
    and every read of the response inside the ``async with``."""

    def __init__(self):
        self._open: set[ClientResponse] = set()

    def post(self, url: str, *, json: Any = None, data=None, headers=None,
             timeout_s: float = DEFAULT_TIMEOUT_S) -> _RequestContext:
        return self._context("POST", url, json, data, headers, timeout_s)

    def get(self, url: str, *, headers=None,
            timeout_s: float = DEFAULT_TIMEOUT_S) -> _RequestContext:
        return self._context("GET", url, None, None, headers, timeout_s)

    def _context(self, method, url, json_body, data, headers, timeout_s):
        hdrs = Headers(headers or ())
        if json_body is not None:
            body = json.dumps(json_body).encode()
            hdrs.setdefault("Content-Type", "application/json")
        else:
            body = b"" if data is None else data
            if data is not None:
                hdrs.setdefault("Content-Type", "application/octet-stream")
        return _RequestContext(self, method, url, body, hdrs, timeout_s)

    async def _request(self, method, url, body, headers: Headers,
                       timeout_s: float) -> ClientResponse:
        parts = urlsplit(url)
        if parts.scheme not in ("http", "https") or not parts.hostname:
            raise ValueError(f"unsupported url {url!r}")
        tls = parts.scheme == "https"
        port = parts.port or (443 if tls else 80)
        loop = asyncio.get_running_loop()
        deadline = loop.time() + timeout_s
        async with asyncio.timeout_at(deadline):
            reader, writer = await asyncio.open_connection(
                parts.hostname, port, limit=_CLIENT_READ_SIZE,
                ssl=ssl.create_default_context() if tls else None,
                server_hostname=parts.hostname if tls else None)
        resp = ClientResponse(reader, writer, deadline)
        self._open.add(resp)
        try:
            target = parts.path or "/"
            if parts.query:
                target += "?" + parts.query
            head = Headers({"Host": parts.netloc})
            head.update(headers)
            head["Content-Length"] = str(len(body))
            head["Connection"] = "close"
            lines = [f"{method} {target} HTTP/1.1\r\n"]
            lines += [f"{k}: {v}\r\n" for k, v in head.items()]
            writer.write(("".join(lines) + "\r\n").encode("latin-1"))
            if body:
                writer.write(body)
            await resp._io(writer.drain())
            await resp._start(method)
        except BaseException:
            self._close(resp)
            raise
        return resp

    def _close(self, resp: Optional[ClientResponse]) -> None:
        if resp is not None:
            self._open.discard(resp)
            resp.close()

    async def close(self) -> None:
        for resp in list(self._open):
            self._close(resp)


def run_app(app: Application, host: str, port: int) -> None:
    """Serve until SIGINT, then close the listener (in-flight handlers are
    cancelled) and run the cleanup hooks."""

    async def _main() -> None:
        stop = asyncio.Event()
        loop = asyncio.get_running_loop()
        loop.add_signal_handler(signal.SIGINT, stop.set)
        server = Server(app)
        await server.start(host, port)
        try:
            await stop.wait()
        finally:
            loop.remove_signal_handler(signal.SIGINT)
            await server.close()

    asyncio.run(_main())
