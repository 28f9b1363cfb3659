"""HTTP/1.1 on asyncio streams: the server under the port's ``app`` and
``api`` and the server and client under its ``dispatcher``, with nothing
outside the standard library (the GPU machine has no aiohttp).

Each name is the aiohttp name that the JAX package's serve modules call
(``web.json_response``, ``web.StreamResponse``, ``web.HTTPUnauthorized``,
``web.ClientSession`` …), so a handler here reads line for line as its
counterpart in ``chatterbox_tpu/serve/``, and gives the same status and
body. Only what those modules use is here.

Server:
- the request line and headers of HTTP/1.1 and 1.0, names case-insensitive;
  a target, header name or header value over 8190 bytes is answered 400,
  with aiohttp's text;
- bodies by ``Content-Length`` or ``Transfer-Encoding: chunked``;
  ``read()`` and ``json()`` refuse one over 1 MiB (aiohttp's ``client_max_size``)
  with 413, ``multipart()`` reads ``multipart/form-data`` whole and is not
  held to it (aiohttp's ``multipart()`` streams past the limit);
- ``query`` keeps the first value of a repeated key (aiohttp's
  ``dict(request.query)``), ``+`` and ``%20`` decode to a space, an empty
  value is kept;
- ``Response``, ``json_response``, ``FileResponse``; ``StreamResponse``
  with no length is chunked on HTTP/1.1 and ends the connection on 1.0;
  keep-alive, ``Connection: close``;
- routes with ``{name}`` segments, a static directory (a path that
  resolves outside it is 404), middlewares, 404 and 405 as aiohttp gives
  them; a GET route of a ``RouteTableDef`` also answers HEAD;
- ``run_app`` stops on SIGINT or SIGTERM: it stops accepting, cancels the
  open handlers, runs ``on_cleanup`` and returns.

A handler learns that its client has gone when a write raises
``ConnectionResetError``; it is not cancelled (aiohttp's default). The
connection closes when the client's side ends, as in aiohttp, so that write
is the next one.

Client (``ClientSession``): one connection per request, a body by
``Content-Length``, chunked or to the connection's end, a total and a
per-read timeout; ``ClientError`` for a failed connection or body.
"""
from __future__ import annotations

import asyncio
import email.parser
import email.utils
import json
import logging
import mimetypes
import re
import signal
import sys
import urllib.parse
from collections.abc import Mapping, MutableMapping
from http import HTTPStatus
from pathlib import Path
from typing import Awaitable, Callable, Dict, Iterator, List, NamedTuple, Optional, Tuple

log = logging.getLogger("chatterbox_tpu_torch.web")

MAX_FIELD = 8190               # aiohttp's max_line_size and max_field_size
CLIENT_MAX_SIZE = 1024 ** 2    # aiohttp's client_max_size
_HEAD_LIMIT = 1 << 16          # a head line past this is refused unread
SERVER_SOFTWARE = "Python/{0[0]}.{0[1]} chatterbox-tpu-torch".format(sys.version_info)

Handler = Callable[["Request"], Awaitable["StreamResponse"]]


class Headers(MutableMapping):
    """Header names looked up without regard to case; each is written as it
    was first set. One value per name."""

    def __init__(self, items=None):
        self._d: Dict[str, Tuple[str, str]] = {}
        if items:
            for k, v in (items.items() if isinstance(items, Mapping) else items):
                self[k] = v

    def __getitem__(self, name: str) -> str:
        return self._d[name.lower()][1]

    def __setitem__(self, name: str, value) -> None:
        old = self._d.get(name.lower())
        self._d[name.lower()] = (old[0] if old else name, str(value))

    def __delitem__(self, name: str) -> None:
        del self._d[name.lower()]

    def __iter__(self) -> Iterator[str]:
        return (name for name, _ in self._d.values())

    def __len__(self) -> int:
        return len(self._d)


class _BadMessage(Exception):
    """A request head that cannot be parsed: answered 400 with this text."""


def _tokens(value: Optional[str]) -> set:
    return {t.strip().lower() for t in (value or "").split(",")}


async def _read_head(reader: asyncio.StreamReader) -> List[bytes]:
    """The lines of a message head up to its blank line, CRLF removed; []
    at a clean end of stream before the first byte."""
    lines: List[bytes] = []
    while True:
        try:
            line = await reader.readuntil(b"\n")
        except asyncio.IncompleteReadError as exc:
            if not lines and not exc.partial:
                return []
            raise _BadMessage("Unexpected end of message head") from None
        except asyncio.LimitOverrunError:
            what = "Status line" if not lines else "Header line"
            raise _BadMessage(f"Got more than {MAX_FIELD} bytes when reading {what} is too long.")
        line = line.rstrip(b"\r\n")
        if not line:
            if lines:
                return lines
            continue   # blank lines before a request line are skipped
        lines.append(line)


def _parse_headers(lines: List[bytes]) -> Headers:
    headers = Headers()
    for raw in lines:
        name, sep, value = raw.decode("latin-1").partition(":")
        if not sep or not name or name != name.strip():
            raise _BadMessage(f"Invalid header: {raw[:100]!r}")
        value = value.strip(" \t")
        if len(name) > MAX_FIELD:
            raise _BadMessage(f"Got more than {MAX_FIELD} bytes ({len(name)}) when reading "
                              "Header name is too long.")
        if len(value) > MAX_FIELD:
            raise _BadMessage(f"Got more than {MAX_FIELD} bytes ({len(value)}) when reading "
                              "Header value is too long.")
        if name not in headers:
            headers[name] = value
    return headers


def _framing(headers: Headers) -> Tuple[Optional[int], bool]:
    """(Content-Length, chunked) of a message; ValueError if malformed."""
    if "chunked" in _tokens(headers.get("Transfer-Encoding")):
        return None, True
    length = headers.get("Content-Length")
    if length is None:
        return None, False
    if not length.isdigit():
        raise ValueError(f"Invalid Content-Length: {length!r}")
    return int(length), False


class StreamReader:
    """A message body on a connection: ``length`` bytes, chunked, or (length
    None, not chunked) everything to the connection's end. ``error`` makes
    the exception for a malformed or cut body; ``io`` wraps each read (the
    client's timeouts)."""

    def __init__(self, reader: asyncio.StreamReader, length: Optional[int], chunked: bool,
                 error: Callable[[str], Exception], io=None):
        self._reader, self._chunked, self._error = reader, chunked, error
        self._io = io or (lambda aw: aw)
        self._left = 0 if chunked else length   # None: to the end
        self._eof = length == 0 and not chunked

    def at_eof(self) -> bool:
        return self._eof

    async def _line(self) -> bytes:
        try:
            return await self._io(self._reader.readuntil(b"\n"))
        except (asyncio.IncompleteReadError, asyncio.LimitOverrunError):
            raise self._error("Not enough data for satisfy transfer length header.") from None

    async def readany(self, n: int = 1 << 16) -> bytes:
        """Up to ``n`` bytes of the body as they come; b"" at its end."""
        if self._eof:
            return b""
        if self._chunked and self._left == 0:
            size = (await self._line()).split(b";")[0].strip()
            try:
                self._left = int(size, 16)
            except ValueError:
                raise self._error(f"Invalid chunk size: {size[:32]!r}") from None
            if self._left == 0:    # the last chunk; trailers are read and dropped
                while (await self._line()).strip():
                    pass
                self._eof = True
                return b""
        data = await self._io(self._reader.read(n if self._left is None else min(n, self._left)))
        if self._left is None:
            self._eof = not data
            return data
        if not data:
            raise self._error("Not enough data for satisfy transfer length header.")
        self._left -= len(data)
        if self._left == 0:
            if self._chunked and (await self._line()).strip():
                raise self._error("Expected CRLF after chunk data")
            self._eof = not self._chunked
        return data

    async def iter_chunked(self, n: int):
        while True:
            data = await self.readany(n)
            if not data:
                return
            yield data

    async def read(self) -> bytes:
        body = bytearray()
        async for data in self.iter_chunked(1 << 16):
            body.extend(data)
        return bytes(body)


# ------------------------------------------------------------------ responses
class StreamResponse:
    def __init__(self, *, status: int = 200, headers=None):
        self.status = status
        self.reason = HTTPStatus(status).phrase
        self.headers = Headers(headers)
        self.prepared = False
        self._writer: Optional[asyncio.StreamWriter] = None
        self._chunked = self._head_only = self._eof = False

    async def prepare(self, request: "Request") -> None:
        """Send the status line and headers. With no Content-Length the body
        is chunked on HTTP/1.1; on 1.0 the connection's end ends it."""
        if self.prepared:
            return
        self.prepared = True
        conn, version = request._conn, request.version
        if "Content-Length" not in self.headers:
            if version >= (1, 1):
                self.headers["Transfer-Encoding"] = "chunked"
                self._chunked = True
            else:
                conn.keep_alive = False
        self.headers.setdefault("Date", email.utils.formatdate(usegmt=True))
        self.headers.setdefault("Server", SERVER_SOFTWARE)
        if version >= (1, 1) and not conn.keep_alive:
            self.headers["Connection"] = "close"
        elif version < (1, 1) and conn.keep_alive:
            self.headers["Connection"] = "keep-alive"
        self._head_only = request.method == "HEAD"
        head = f"HTTP/{version[0]}.{version[1]} {self.status} {self.reason}\r\n" + "".join(
            f"{k}: {v}\r\n" for k, v in self.headers.items()) + "\r\n"
        self._writer = conn.writer
        conn.head_sent = True
        await self._send(head.encode("latin-1"))

    async def _send(self, data: bytes) -> None:
        if self._writer.is_closing():
            raise ConnectionResetError("Cannot write to closing transport")
        self._writer.write(data)
        await self._writer.drain()

    async def write(self, data: bytes) -> None:
        if self._writer is None:
            raise RuntimeError("write() before prepare()")
        if self._eof:
            raise RuntimeError("write() after write_eof()")
        if not data or self._head_only:
            return
        await self._send(b"%x\r\n%b\r\n" % (len(data), data) if self._chunked else data)

    async def write_eof(self) -> None:
        if self._eof:
            return
        self._eof = True
        if self._chunked and not self._head_only:
            await self._send(b"0\r\n\r\n")


class Response(StreamResponse):
    """A whole body: ``text`` (sent as ``content_type; charset=utf-8``,
    text/plain by default) or ``body`` bytes."""

    def __init__(self, *, body: Optional[bytes] = None, status: int = 200,
                 text: Optional[str] = None, headers=None, content_type: Optional[str] = None):
        super().__init__(status=status, headers=headers)
        if text is not None:
            self.body = text.encode("utf-8")
            self.headers["Content-Type"] = f"{content_type or 'text/plain'}; charset=utf-8"
        else:
            self.body = body or b""
            if content_type:
                self.headers["Content-Type"] = content_type

    async def _send_whole(self, request: "Request") -> None:
        self.headers["Content-Length"] = str(len(self.body))
        await self.prepare(request)
        await self.write(self.body)
        await self.write_eof()


def json_response(data, *, status: int = 200, headers=None) -> Response:
    return Response(text=json.dumps(data), status=status, headers=headers,
                    content_type="application/json")


class FileResponse(Response):
    """A file's bytes, typed by its suffix (``mimetypes``)."""

    def __init__(self, path, status: int = 200):
        path = Path(path)
        ctype = mimetypes.guess_type(str(path))[0] or "application/octet-stream"
        super().__init__(body=path.read_bytes(), status=status, content_type=ctype)


class HTTPException(Response, Exception):
    """A response that a handler raises or returns; its body is
    "<status>: <reason>" unless ``text`` is given."""

    status_code = 500

    def __init__(self, *, headers=None, text: Optional[str] = None,
                 content_type: Optional[str] = None):
        if text is None:
            text = f"{self.status_code}: {HTTPStatus(self.status_code).phrase}"
        Response.__init__(self, status=self.status_code, text=text, headers=headers,
                          content_type=content_type)
        Exception.__init__(self, text)


class HTTPBadRequest(HTTPException):
    status_code = 400


class HTTPUnauthorized(HTTPException):
    status_code = 401


class HTTPForbidden(HTTPException):
    status_code = 403


class HTTPNotFound(HTTPException):
    status_code = 404


class HTTPMethodNotAllowed(HTTPException):
    status_code = 405

    def __init__(self, method: str, allowed_methods, **kwargs):
        super().__init__(**kwargs)
        self.headers["Allow"] = ",".join(sorted(allowed_methods))


class HTTPRequestEntityTooLarge(HTTPException):
    status_code = 413

    def __init__(self, max_size: int, actual_size: int, **kwargs):
        super().__init__(text=f"Maximum request body size {max_size} exceeded, "
                              f"actual body size {actual_size}", **kwargs)


# ------------------------------------------------------------------- requests
class BodyPartReader:
    """One field of a multipart/form-data body."""

    def __init__(self, head: bytes, data: bytes):
        msg = email.parser.BytesHeaderParser().parsebytes(head + b"\r\n\r\n")
        name = msg.get_param("name", header="content-disposition")
        self.name = email.utils.collapse_rfc2231_value(name) if name is not None else None
        self.filename = msg.get_filename()
        self._data, self._pos = data, 0

    async def read_chunk(self, size: int = 8192) -> bytes:
        piece = self._data[self._pos:self._pos + size]
        self._pos += len(piece)
        return piece

    async def read(self) -> bytes:
        return await self.read_chunk(len(self._data))


class MultipartReader:
    """The fields of a multipart/form-data body, in order (``next()`` gives
    None after the last). The body is read whole at the first ``next()``."""

    def __init__(self, headers: Headers, content: StreamReader):
        ctype = email.parser.HeaderParser().parsestr(
            f"Content-Type: {headers.get('Content-Type', '')}\r\n\r\n")
        self._boundary = ctype.get_param("boundary")
        if ctype.get_content_type() != "multipart/form-data" or not self._boundary:
            raise ValueError(f"Invalid multipart Content-Type: {headers.get('Content-Type')!r}")
        self._content = content
        self._parts: Optional[List[BodyPartReader]] = None

    async def next(self) -> Optional[BodyPartReader]:
        if self._parts is None:
            self._parts = _split_multipart(await self._content.read(), self._boundary.encode())
        return self._parts.pop(0) if self._parts else None


def _split_multipart(data: bytes, boundary: bytes) -> List[BodyPartReader]:
    delim = b"--" + boundary
    pos = data.find(delim)
    if pos < 0:
        raise ValueError("multipart body without its boundary")
    pos += len(delim)
    parts = []
    while data[pos:pos + 2] != b"--":
        start = data.find(b"\n", pos) + 1    # past the delimiter's line
        end = data.find(b"\r\n" + delim, start)
        if start == 0 or end < 0:
            raise ValueError("multipart body not closed by its boundary")
        part = data[start:end]
        if part.startswith(b"\r\n"):    # a part with no headers
            head, content = b"", part[2:]
        else:
            head, sep, content = part.partition(b"\r\n\r\n")
            if not sep:
                raise ValueError("multipart part without the blank line after its headers")
        parts.append(BodyPartReader(head, content))
        pos = end + 2 + len(delim)
    return parts


class _Protocol(asyncio.StreamReaderProtocol):
    """A connection's stream protocol that closes the connection when the
    client's side ends, as aiohttp's does: a handler still streaming then
    learns of it at its next write."""

    def eof_received(self) -> bool:
        super().eof_received()
        return False


class _Connection:
    def __init__(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        self.reader, self.writer = reader, writer
        self.keep_alive = True
        self.head_sent = False    # of the response to the current request


class Request:
    """One request: ``method``, ``path`` (percent-decoded), ``rel_url``
    (the target as sent), ``query``, ``headers``, ``match_info``, ``app``,
    ``transport``; the body through ``read``, ``json``, ``multipart``."""

    def __init__(self, app: "Application", conn: _Connection, method: str, target: str,
                 version: Tuple[int, int], headers: Headers, content: StreamReader):
        self.app, self._conn = app, conn
        self.method, self.version, self.headers, self.content = method, version, headers, content
        self.rel_url = target
        raw_path, _, qs = target.partition("?")
        self.path = urllib.parse.unquote(raw_path)
        self.query: Dict[str, str] = {}
        for k, v in urllib.parse.parse_qsl(qs, keep_blank_values=True):
            self.query.setdefault(k, v)
        self.match_info: Dict[str, str] = {}
        self.transport = conn.writer.transport
        self._read_bytes: Optional[bytes] = None

    @property
    def can_read_body(self) -> bool:
        return not self.content.at_eof()

    async def read(self) -> bytes:
        if self._read_bytes is None:
            body = bytearray()
            while True:
                data = await self.content.readany()
                body.extend(data)
                if len(body) > CLIENT_MAX_SIZE:
                    raise HTTPRequestEntityTooLarge(max_size=CLIENT_MAX_SIZE, actual_size=len(body))
                if not data:
                    break
            self._read_bytes = bytes(body)
        return self._read_bytes

    async def text(self) -> str:
        return (await self.read()).decode("utf-8")

    async def json(self):
        return json.loads(await self.text())

    async def multipart(self) -> MultipartReader:
        return MultipartReader(self.headers, self.content)


# -------------------------------------------------------------------- routing
class Route(NamedTuple):
    method: str          # "*" for any
    path: str            # as registered
    pattern: "re.Pattern"
    handler: Handler
    allow_head: bool


def _pattern(path: str) -> "re.Pattern":
    """``/voices/{voice_id}`` → a regex with a named group per segment."""
    out, pos = [], 0
    for m in re.finditer(r"\{(\w+)\}", path):
        out.append(re.escape(path[pos:m.start()]) + f"(?P<{m.group(1)}>[^{{}}/]+)")
        pos = m.end()
    return re.compile("^" + "".join(out) + re.escape(path[pos:]) + "$")


class Router:
    def __init__(self):
        self._routes: List[Route] = []

    def add_route(self, method: str, path: str, handler: Handler, *,
                  allow_head: bool = False) -> None:
        self._routes.append(Route(method.upper(), path, _pattern(path), handler, allow_head))

    def add_static(self, prefix: str, directory) -> None:
        """GET (and HEAD) ``prefix/<file>`` from ``directory``; a path that
        resolves outside it is 404, a directory 403, a missing file an empty
        404."""
        root = Path(directory).resolve(strict=True)

        async def static(request: Request) -> StreamResponse:
            rel = Path(request.match_info["filename"])
            if rel.anchor:
                raise HTTPForbidden()
            path = (root / rel).resolve()
            if not path.is_relative_to(root):
                raise HTTPNotFound()
            if path.is_dir():
                raise HTTPForbidden()
            if not path.is_file():   # aiohttp's FileResponse: 404 with an empty body
                return StreamResponse(status=404, headers={"Content-Type": "application/octet-stream"})
            return FileResponse(path)

        path = prefix.rstrip("/") + "/{filename}"
        pattern = re.compile("^" + re.escape(prefix.rstrip("/")) + "/(?P<filename>.*)$")
        self._routes.append(Route("GET", path, pattern, static, True))

    def routes(self) -> List[Route]:
        return list(self._routes)

    def resolve(self, method: str, path: str) -> Tuple[Handler, Dict[str, str]]:
        """The handler for ``method`` on ``path`` and its segments; 405 when
        the path has routes but none for the method, else 404."""
        allowed = set()
        for r in self._routes:
            m = r.pattern.match(path)
            if m is None:
                continue
            if r.method in ("*", method) or (method == "HEAD" and r.allow_head):
                return r.handler, m.groupdict()
            allowed.update((r.method, "HEAD") if r.allow_head else (r.method,))
        if allowed:
            raise HTTPMethodNotAllowed(method, allowed)
        raise HTTPNotFound()


class RouteTableDef(list):
    """Routes collected by decorators, for ``Application.add_routes``."""

    def route(self, method: str, path: str):
        def register(handler: Handler) -> Handler:
            self.append((method, path, handler))
            return handler
        return register

    def get(self, path: str):
        return self.route("GET", path)

    def post(self, path: str):
        return self.route("POST", path)

    def delete(self, path: str):
        return self.route("DELETE", path)


def middleware(fn):
    """Marks ``async fn(request, handler)`` as a middleware (as aiohttp's
    decorator does; the mark is not needed here)."""
    return fn


class Application(dict):
    """The app: its state by key (``app["engine"]``), routes, middlewares
    (the first listed is the outermost), and startup and cleanup hooks."""

    def __init__(self, *, middlewares=()):
        super().__init__()
        self.router = Router()
        self.middlewares = list(middlewares)
        self.on_startup: List[Callable[["Application"], Awaitable[None]]] = []
        self.on_cleanup: List[Callable[["Application"], Awaitable[None]]] = []

    def add_routes(self, routes: RouteTableDef) -> None:
        for method, path, handler in routes:
            self.router.add_route(method, path, handler, allow_head=method == "GET")

    def _handler(self) -> Handler:
        async def dispatch(request: Request) -> StreamResponse:
            handler, request.match_info = self.router.resolve(request.method, request.path)
            return await handler(request)

        handler = dispatch
        for mw in reversed(self.middlewares):
            handler = (lambda mw, inner: lambda request: mw(request, inner))(mw, handler)
        return handler


# --------------------------------------------------------------------- server
class AppServer:
    """``app`` listening on one socket: ``start`` runs ``on_startup`` and then
    binds (``port`` 0 takes a free one); ``close`` stops accepting, cancels
    the open connections and their handlers, then runs ``on_cleanup``."""

    def __init__(self, app: Application):
        self.app = app
        self.port: Optional[int] = None
        self._server: Optional[asyncio.Server] = None
        self._conns: Dict[asyncio.Task, _Connection] = {}
        self._started = False

    async def start(self, host: str, port: int) -> None:
        for hook in self.app.on_startup:
            await hook(self.app)
        self._started = True
        self._handler = self.app._handler()
        self._server = await asyncio.get_running_loop().create_server(
            lambda: _Protocol(asyncio.StreamReader(limit=_HEAD_LIMIT), self._serve), host, port)
        self.port = self._server.sockets[0].getsockname()[1]

    async def close(self) -> None:
        if self._server is not None:
            self._server.close()
        for task, conn in list(self._conns.items()):
            task.cancel()
            conn.writer.close()
        await asyncio.gather(*self._conns, return_exceptions=True)
        if self._server is not None:
            await self._server.wait_closed()
        if self._started:
            self._started = False
            for hook in self.app.on_cleanup:
                await hook(self.app)

    async def _serve(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter) -> None:
        task = asyncio.current_task()
        conn = _Connection(reader, writer)
        self._conns[task] = conn
        try:
            while conn.keep_alive and not task.cancelling():
                try:
                    request = await self._read_request(conn)
                except _BadMessage as exc:
                    await self._bad_message(conn, str(exc))
                    break
                if request is None:
                    break
                await self._respond(request)
        except (ConnectionError, asyncio.IncompleteReadError):
            pass
        finally:
            self._conns.pop(task, None)
            writer.close()

    async def _read_request(self, conn: _Connection) -> Optional[Request]:
        lines = await _read_head(conn.reader)
        if not lines:
            return None
        parts = lines[0].decode("latin-1").split(" ")
        m = re.fullmatch(r"HTTP/(\d)\.(\d)", parts[-1])
        if len(parts) != 3 or m is None or not parts[0].isalpha():
            raise _BadMessage(f"Bad request line: {lines[0][:100]!r}")
        method, target = parts[0].upper(), parts[1]
        if len(target) > MAX_FIELD:
            raise _BadMessage(f"Got more than {MAX_FIELD} bytes ({len(target)}) when reading "
                              "Status line is too long.")
        version = (int(m.group(1)), int(m.group(2)))
        headers = _parse_headers(lines[1:])
        try:
            length, chunked = _framing(headers)
        except ValueError as exc:
            raise _BadMessage(str(exc)) from None
        connection = _tokens(headers.get("Connection"))
        conn.keep_alive = ("close" not in connection if version >= (1, 1)
                           else "keep-alive" in connection)
        content = StreamReader(conn.reader, length or 0, chunked,
                               lambda msg: HTTPBadRequest(text=msg))
        return Request(self.app, conn, method, target, version, headers, content)

    async def _respond(self, request: Request) -> None:
        request._conn.head_sent = False
        try:
            response = await self._handler(request)
        except HTTPException as exc:
            response = exc
        except ConnectionError:
            request._conn.keep_alive = False
            raise
        except Exception:
            log.exception("Error handling request %s %s", request.method, request.path)
            if request._conn.writer.is_closing():
                raise ConnectionResetError("the client has gone") from None
            request._conn.keep_alive = False
            if request._conn.head_sent:   # too late for a 500: end the connection
                return
            response = Response(status=500, text="500 Internal Server Error\n\n"
                                                 "Server got itself in trouble")
        if not response.prepared:
            if isinstance(response, Response):
                await response._send_whole(request)
            else:
                await response.prepare(request)
        await response.write_eof()
        if request._conn.keep_alive and not request.content.at_eof():
            # the handler left some of the body: read it to reach the next
            # request, up to the size a handler could have read
            try:
                await asyncio.wait_for(request.read(), 10)
            except (HTTPException, asyncio.TimeoutError):
                request._conn.keep_alive = False

    @staticmethod
    async def _bad_message(conn: _Connection, text: str) -> None:
        response = Response(status=400, text=text)
        response.headers["Content-Length"] = str(len(response.body))
        head = (f"HTTP/1.0 400 Bad Request\r\n" + "".join(
            f"{k}: {v}\r\n" for k, v in response.headers.items()) +
            f"Date: {email.utils.formatdate(usegmt=True)}\r\nServer: {SERVER_SOFTWARE}\r\n\r\n")
        conn.writer.write(head.encode("latin-1") + response.body)
        await conn.writer.drain()


def run_app(app: Application, *, host: str = "0.0.0.0", port: int = 8080) -> None:
    """Serve ``app`` until SIGINT or SIGTERM, then close it (see
    ``AppServer.close``) and return."""

    async def serve() -> None:
        loop = asyncio.get_running_loop()
        stop = asyncio.Event()
        for sig in (signal.SIGINT, signal.SIGTERM):
            loop.add_signal_handler(sig, stop.set)
        server = AppServer(app)
        try:
            await server.start(host, port)
            print(f"======== Running on http://{host}:{server.port} ========", flush=True)
            await stop.wait()
            log.info("Stopping: no new connections; cancelling open requests")
        finally:
            await server.close()

    asyncio.run(serve())


# --------------------------------------------------------------------- client
class ClientError(Exception):
    """A request that failed: no connection, a malformed or cut answer, or a
    read past ``sock_read``."""


class ClientTimeout(NamedTuple):
    total: Optional[float] = None       # the whole request, body included
    sock_read: Optional[float] = None   # each read from the socket


class ClientResponse:
    def __init__(self, status: int, headers: Headers, content: StreamReader,
                 writer: asyncio.StreamWriter):
        self.status, self.headers, self.content = status, headers, content
        self._writer = writer

    async def read(self) -> bytes:
        return await self.content.read()

    def close(self) -> None:
        self._writer.close()


class _RequestContext:
    def __init__(self, coro):
        self._coro = coro
        self._response: Optional[ClientResponse] = None

    async def __aenter__(self) -> ClientResponse:
        self._response = await self._coro
        return self._response

    async def __aexit__(self, *exc) -> None:
        self._response.close()


class ClientSession:
    """Requests over a fresh connection each (``Connection: close``); the
    answer's body is read from ``response.content`` inside ``async with``."""

    def request(self, method: str, url: str, *, headers=None, data: Optional[bytes] = None,
                timeout: ClientTimeout = ClientTimeout()) -> _RequestContext:
        return _RequestContext(self._request(method, url, headers, data, timeout))

    def get(self, url: str, **kwargs) -> _RequestContext:
        return self.request("GET", url, **kwargs)

    async def close(self) -> None:
        """Nothing is pooled, so nothing to close."""

    @staticmethod
    async def _request(method: str, url: str, headers, data: Optional[bytes],
                       timeout: ClientTimeout) -> ClientResponse:
        parts = urllib.parse.urlsplit(url)
        if parts.scheme != "http" or not parts.hostname:
            raise ClientError(f"not an http:// URL: {url}")
        host, port = parts.hostname, parts.port or 80
        target = (parts.path or "/") + (f"?{parts.query}" if parts.query else "")
        loop = asyncio.get_running_loop()
        deadline = None if timeout.total is None else loop.time() + timeout.total

        async def io(aw):
            """``aw`` within the read timeout and the request's deadline."""
            wait = timeout.sock_read
            if deadline is not None:
                left = deadline - loop.time()
                if wait is None or left < wait:
                    try:
                        return await asyncio.wait_for(aw, max(left, 0))
                    except asyncio.TimeoutError:
                        raise asyncio.TimeoutError(f"{method} {url}: over {timeout.total} s") from None
            try:
                return await asyncio.wait_for(aw, wait)
            except asyncio.TimeoutError:
                raise ClientError(f"Timeout on reading data from socket ({url})") from None

        try:
            reader, writer = await io(asyncio.open_connection(host, port))
        except OSError as exc:
            raise ClientError(f"Cannot connect to host {host}:{port} [{exc}]") from exc
        try:
            out = Headers(headers)
            out["Host"] = parts.netloc
            if data is not None:
                out["Content-Length"] = str(len(data))
            out["Connection"] = "close"
            head = f"{method} {target} HTTP/1.1\r\n" + "".join(
                f"{k}: {v}\r\n" for k, v in out.items()) + "\r\n"
            writer.write(head.encode("latin-1") + (data or b""))
            await io(writer.drain())
            lines = await io(_read_head(reader))
            m = re.match(rb"HTTP/\d\.\d (\d{3})(?: |$)", lines[0] if lines else b"")
            if m is None:
                raise ClientError(f"bad status line from {url}: {lines[:1]!r}")
            status = int(m.group(1))
            resp_headers = _parse_headers(lines[1:])
            length, chunked = _framing(resp_headers)
            if method == "HEAD" or status in (204, 304) or status < 200:
                length, chunked = 0, False
            content = StreamReader(reader, length, chunked, ClientError, io)
            return ClientResponse(status, resp_headers, content, writer)
        except (OSError, _BadMessage, ValueError) as exc:
            writer.close()
            raise ClientError(f"{method} {url}: {exc}") from exc
        except BaseException:
            writer.close()
            raise
