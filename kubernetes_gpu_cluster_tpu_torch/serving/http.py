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
"""

from __future__ import annotations

import asyncio
import contextlib
import json
import signal
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
        await conn.write(_head(self.status, self.headers) + self.body)


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
            i = self.buf.find(b"\n")
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
        except Exception:
            logger.exception("handler failed: %s %s", request.method,
                             request.path)
            if request._conn.committed:
                # Headers are out: the truncated body is the only signal
                # left, so the connection closes.
                raise ConnectionAbortedError("handler failed mid-response")
            return Response(text="500: Internal Server Error", status=500)


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
