"""The port's HTTP layer (``chatterbox_tpu_torch/serve/web.py``) on the wire,
held case by case against the JAX server on aiohttp.

Each wire case goes over a real socket to both servers, built by their own
``create_app`` over the same stub engine (or by their own
``create_dispatcher_app`` over the same aiohttp backends), and compares what
comes back: the status line, the headers that carry meaning (not Date,
Server or the random request id) and the body. A few cases the JAX server
answers with something that depends on how its parser reads the socket;
each says so where it compares less.

The first three tests boot the real entry points (``python -m
chatterbox_tpu_torch.serve.app`` at ``EngineConfig.tiny_ref()`` on the CPU,
and ``python -m chatterbox_tpu_torch.serve.dispatcher`` in front of it) in
child processes where ``import aiohttp`` fails, stream through both, and
stop both with SIGINT; they run in file order on one module-wide pair of
children.
"""
import asyncio
import json
import os
import re
import signal
import socket
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
from aiohttp import ClientSession
from aiohttp import web as aweb
from aiohttp.test_utils import TestServer

import torch_port_helpers  # noqa: F401  (caps torch's threads)

from chatterbox_tpu.config import reset_config_cache
from chatterbox_tpu_torch.audio.pcm import write_wav

REPO = Path(__file__).resolve().parent.parent
KEY = "http-key"
H = {"X-API-Key": KEY}
ENV = ("API_KEY", "VOICES_DIR", "PRELOADED_VOICES_DIR")
# the headers compared between the two servers
WIRE = ("content-type", "content-length", "transfer-encoding", "connection", "allow",
        "access-control-allow-origin", "access-control-allow-headers",
        "access-control-allow-methods")
# the entry point as ``python -m`` runs it, with aiohttp made unimportable
BLOCKED_BOOT = ("import runpy, sys; sys.modules['aiohttp'] = None; "
                "runpy.run_module(sys.argv.pop(1), run_name='__main__', alter_sys=True)")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# -------------------------------------------------------------- raw sockets
async def exchange(port: int, data: bytes, timeout: float = 10.0) -> bytes:
    """Send ``data`` and read until the server closes the connection."""
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    try:
        writer.write(data)
        await writer.drain()
        return await asyncio.wait_for(reader.read(-1), timeout)
    finally:
        writer.close()


def parse_responses(raw: bytes) -> list:
    """Every response in ``raw`` → [(status line, {header: value}, body
    chunks)]: one chunk per chunk on the wire when chunked, else the body
    by Content-Length or to the end."""
    out = []
    while raw:
        head, sep, raw = raw.partition(b"\r\n\r\n")
        assert sep, head
        lines = head.decode("latin-1").split("\r\n")
        headers = {k.strip().lower(): v.strip() for k, v in (ln.split(":", 1) for ln in lines[1:])}
        if headers.get("transfer-encoding") == "chunked":
            chunks = []
            while True:
                size, _, raw = raw.partition(b"\r\n")
                n = int(size, 16)
                if n == 0:
                    assert raw[:2] == b"\r\n", raw[:20]
                    raw = raw[2:]
                    break
                chunks.append(raw[:n])
                assert raw[n:n + 2] == b"\r\n"
                raw = raw[n + 2:]
        elif "content-length" in headers:
            n = int(headers["content-length"])
            chunks, raw = [raw[:n]], raw[n:]
        else:
            chunks, raw = [raw], b""
        out.append((lines[0], headers, chunks))
    return out


def wire(response) -> tuple:
    status, headers, chunks = response
    return status, {k: headers[k] for k in WIRE if k in headers}, chunks


def request(method: str, target: str, headers=(), body: bytes = b"", version: str = "1.1",
            close: bool = True) -> bytes:
    lines = [f"{method} {target} HTTP/{version}", "Host: 127.0.0.1", *headers]
    if body and not any(h.lower().startswith("transfer-encoding") for h in headers):
        lines.append(f"Content-Length: {len(body)}")
    if close and version == "1.1":
        lines.append("Connection: close")
    return ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1") + body


def multipart(fields, boundary: str = "b0undary") -> tuple:
    """[(name, filename or None, bytes)] → (body, its Content-Type)."""
    body = b""
    for name, filename, data in fields:
        disposition = f'form-data; name="{name}"' + (f'; filename="{filename}"' if filename else "")
        body += (f"--{boundary}\r\nContent-Disposition: {disposition}\r\n"
                 "Content-Type: application/octet-stream\r\n\r\n").encode() + data + b"\r\n"
    return body + f"--{boundary}--\r\n".encode(), f"multipart/form-data; boundary={boundary}"


# ------------------------------------------------- both servers, one stub each
class StubEngine:
    """What both apps touch: ready at once; ``stream`` yields the request's
    text, "|" and its voice id as JSON, or, for the text "endless", 4 KiB
    pieces until the handler stops asking."""

    sr = 24000

    def __init__(self):
        self.voice_cache = {}
        self.tokens = []      # each stream's CancellationToken
        self.pieces = 0       # pieces yielded by "endless" streams

    def get_initialization_status(self):
        return {"state": "ready", "progress": "Model ready", "error": None}

    def shutdown(self):
        pass

    def prepare_conditionals(self, path):
        pass

    def clear_voice_cache(self, voice_id):
        self.voice_cache.pop(voice_id, None)

    async def stream(self, text, cancellation_token=None, **kwargs):
        self.tokens.append(cancellation_token)
        if text == "endless":
            while True:
                self.pieces += 1
                yield b"x" * 4096
                await asyncio.sleep(0.005)
        for piece in (text.encode(), b"|", json.dumps(kwargs["voice_id"]).encode()):
            yield piece


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """The port's app on ``web.AppServer`` and the JAX app on aiohttp's
    server, each over its own StubEngine and voice directories, on one event
    loop: ``run(coro)`` drives it."""
    tmp = tmp_path_factory.mktemp("torch_http")
    saved = {k: os.environ.get(k) for k in ENV}
    os.environ["API_KEY"] = KEY
    from chatterbox_tpu.serve.app import create_app as jax_create_app
    from chatterbox_tpu_torch.serve import web
    from chatterbox_tpu_torch.serve.app import create_app

    loop = asyncio.new_event_loop()

    def make(name, factory):
        os.environ.update(VOICES_DIR=str(tmp / name / "voices"),
                          PRELOADED_VOICES_DIR=str(tmp / name / "preloaded"))
        reset_config_cache()
        engine = StubEngine()
        return engine, factory(engine, warm_voices=False)

    async def start():
        port_engine, port_app = make("port", create_app)
        port_server = web.AppServer(port_app)
        await port_server.start("127.0.0.1", 0)
        jax_engine, jax_app = make("jax", jax_create_app)
        jax_server = TestServer(jax_app, host="127.0.0.1")
        await jax_server.start_server()
        return SimpleNamespace(port=SimpleNamespace(server=port_server, app=port_app,
                                                    engine=port_engine, port=port_server.port,
                                                    voices=tmp / "port" / "voices"),
                               jax=SimpleNamespace(server=jax_server, app=jax_app,
                                                   engine=jax_engine, port=jax_server.port,
                                                   voices=tmp / "jax" / "voices"))

    servers = loop.run_until_complete(start())
    servers.run = loop.run_until_complete
    yield servers
    loop.run_until_complete(servers.port.server.close())
    loop.run_until_complete(servers.jax.server.close())
    loop.close()
    for k, v in saved.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    reset_config_cache()


def both(pair, data: bytes) -> tuple:
    """``data`` sent to each server → (the JAX server's responses, the
    port's), each parsed."""
    async def go():
        return await asyncio.gather(exchange(pair.jax.port, data), exchange(pair.port.port, data))

    jax_raw, port_raw = pair.run(go())
    return parse_responses(jax_raw), parse_responses(port_raw)


# ------------------------------------------------ the entry points, aiohttp blocked
@pytest.fixture(scope="module")
def children(tmp_path_factory):
    """The server (tiny_ref on the CPU) and the dispatcher in front of it,
    each a child process in which ``import aiohttp`` fails."""
    tmp = tmp_path_factory.mktemp("torch_http_children")
    port, dport = free_port(), free_port()
    env = {**os.environ, "API_KEY": KEY, "HOST": "127.0.0.1", "PORT": str(port),
           "CHATTERBOX_FORCE_CPU": "1", "CHATTERBOX_TINY_MODEL": "1",
           "CHATTERBOX_S3GEN_ARCH": "ref", "CHATTERBOX_MAX_NEW_TOKENS": "12",
           "MODEL_PATH": str(tmp / "models"), "VOICES_DIR": str(tmp / "voices"),
           "PRELOADED_VOICES_DIR": str(tmp / "preloaded"), "OMP_NUM_THREADS": "2",
           "PYTHONPATH": str(REPO)}
    env.pop("MAX_DECODE_SLOTS", None)
    logs = {name: open(tmp / f"{name}.log", "w+") for name in ("server", "dispatcher")}
    procs = {"server": subprocess.Popen(
        [sys.executable, "-c", BLOCKED_BOOT, "chatterbox_tpu_torch.serve.app"],
        env=env, cwd=tmp, stdout=logs["server"], stderr=subprocess.STDOUT)}
    try:
        wait_for(port, "/health", procs["server"], 180)
        procs["dispatcher"] = subprocess.Popen(
            [sys.executable, "-c", BLOCKED_BOOT, "chatterbox_tpu_torch.serve.dispatcher",
             "--backends", f"http://127.0.0.1:{port}", "--host", "127.0.0.1",
             "--port", str(dport)],
            env=env, cwd=tmp, stdout=logs["dispatcher"], stderr=subprocess.STDOUT)
        wait_for(dport, "/dispatcher-status", procs["dispatcher"], 60)
        yield SimpleNamespace(port=port, dport=dport, procs=procs, logs=logs, tmp=tmp)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait(30)
        for f in logs.values():
            f.close()


def wait_for(port: int, path: str, proc, timeout: float) -> None:
    import http.client

    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        assert proc.poll() is None, f"the child exited {proc.returncode}"
        try:
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=5)
            conn.request("GET", path)
            if conn.getresponse().status == 200:
                return
        except OSError:
            time.sleep(0.25)
        finally:
            conn.close()
    raise AssertionError(f"no answer on :{port}{path} after {timeout} s")


def fetch(port: int, method: str, target: str, body: bytes = b"", headers=()) -> tuple:
    """One request with a raw socket → (status line, headers, body)."""
    status, hdrs, chunks = parse_responses(asyncio.run(
        exchange(port, request(method, target, (f"X-API-Key: {KEY}", *headers), body),
                 timeout=120)))[0]
    return status, hdrs, b"".join(chunks)


def test_server_streams_with_aiohttp_blocked(children):
    """The entry point boots where aiohttp cannot be imported, and streams a
    WAV as chunks."""
    assert children.procs["server"].poll() is None
    status, headers, body = fetch(children.port, "GET", "/tts/generate?text=Hello+world.&format=wav")
    assert status == "HTTP/1.1 200 OK" and headers["transfer-encoding"] == "chunked"
    assert headers["content-type"].startswith("audio/wav") and headers["x-request-id"]
    assert body[:4] == b"RIFF" and body[8:12] == b"WAVE" and len(body) > 44


def test_dispatcher_proxies_with_aiohttp_blocked(children):
    """The dispatcher's entry point, also without aiohttp: a stream, a
    broadcast upload, a listing and a delete reach the server through its
    client."""
    status, headers, body = fetch(children.dport, "GET", "/tts/generate?text=Hi+there.&format=wav")
    assert status == "HTTP/1.1 200 OK" and body[:4] == b"RIFF" and headers["x-request-id"]
    wav = children.tmp / "probe.wav"
    t = np.arange(24000) / 24000
    write_wav(str(wav), (0.2 * np.sin(2 * np.pi * 200 * t)).astype(np.float32), 24000)
    body, ctype = multipart([("file", "child.wav", wav.read_bytes())])
    status, _, answer = fetch(children.dport, "POST", "/voices", body, (f"Content-Type: {ctype}",))
    assert status == "HTTP/1.1 201 Created", answer
    assert json.loads(fetch(children.dport, "GET", "/voices")[2]) == ["child.wav"]
    assert fetch(children.dport, "DELETE", "/voices/child.wav")[0] == "HTTP/1.1 200 OK"
    status = json.loads(fetch(children.dport, "GET", "/dispatcher-status")[2])
    assert status == {"backends": [{"url": f"http://127.0.0.1:{children.port}",
                                    "healthy": True, "active": 0}]}


def test_sigint_stops_both_children_with_exit_0(children):
    """SIGINT: each child stops accepting, runs on_cleanup (the server's
    shuts its engine down) and exits 0."""
    for name in ("dispatcher", "server"):
        proc = children.procs[name]
        proc.send_signal(signal.SIGINT)
        assert proc.wait(30) == 0, name
    children.logs["server"].seek(0)
    log = children.logs["server"].read()
    assert "Engine shutdown: releasing device buffers." in log
    assert log.index("Stopping") < log.index("Engine shutdown")


# ------------------------------------------------------------- wire cases
def test_chunked_stream_framing(pair):
    """A stream with no length is chunked on HTTP/1.1, one chunk per
    write, and ends with the zero chunk."""
    jax, port = both(pair, request("GET", f"/tts/generate?text=hello&format=raw_pcm&api_key={KEY}"))
    assert [wire(r) for r in port] == [wire(r) for r in jax]
    assert port[0][2] == [b"hello", b"|", b"null"] and port[0][1]["transfer-encoding"] == "chunked"


def test_keep_alive_serves_two_requests_on_one_connection(pair):
    data = (request("GET", "/health", close=False)
            + request("GET", f"/voices?api_key={KEY}", close=True))
    jax, port = both(pair, data)
    assert len(port) == 2 and [wire(r) for r in port] == [wire(r) for r in jax]
    assert "connection" not in port[0][1] and port[1][1]["connection"] == "close"


def test_http_1_0_stream_ends_with_the_connection(pair):
    """HTTP/1.0: the status line says 1.0; a stream with no length is not
    chunked and ends when the server closes; a length-bound answer keeps
    its Content-Length."""
    for data in (request("GET", f"/tts/generate?text=hi&format=raw_pcm&api_key={KEY}", version="1.0"),
                 request("GET", "/health", version="1.0")):
        jax, port = both(pair, data)
        assert [wire(r) for r in port] == [wire(r) for r in jax]
        assert port[0][0].startswith("HTTP/1.0 200")
    assert both(pair, request("GET", f"/tts/generate?text=hi&format=raw_pcm&api_key={KEY}",
                              version="1.0"))[1][0][2] == [b"hi|null"]


def test_chunked_request_body(pair):
    payload = json.dumps({"text": "chunked body", "format": "raw_pcm"}).encode()
    pieces = [payload[:5], payload[5:23], payload[23:]]
    body = b"".join(b"%x\r\n%b\r\n" % (len(p), p) for p in pieces) + b"0\r\n\r\n"
    data = request("POST", "/tts/generate", ("Transfer-Encoding: chunked", f"X-API-Key: {KEY}",
                                             "Content-Type: application/json"), body)
    jax, port = both(pair, data)
    assert [wire(r) for r in port] == [wire(r) for r in jax]
    assert b"".join(port[0][2]) == b'chunked body|null'


def test_json_body_over_1_mib_is_413(pair):
    """read()/json() hold the body to client_max_size (1 MiB). The size the
    message reports is where the read crossed it, which depends on how each
    server reads the socket: the text is compared up to it."""
    body = json.dumps({"text": "a" * (1 << 20)}).encode()
    data = request("POST", "/tts/generate", (f"X-API-Key: {KEY}", "Content-Type: application/json"),
                   body)
    jax, port = both(pair, data)
    prefix = b"Maximum request body size 1048576 exceeded, actual body size "
    for r in (jax[0], port[0]):
        assert r[0] == "HTTP/1.1 413 Request Entity Too Large" and r[2][0].startswith(prefix)
    headers = [{k: v for k, v in wire(r)[1].items() if k != "content-length"} for r in (jax[0], port[0])]
    assert headers[0] == headers[1]


def test_voice_upload_over_1_mib_is_accepted(pair):
    """multipart() is not held to client_max_size, as in aiohttp: a 1.5 MiB
    voice upload is stored whole by both servers."""
    content = bytes(range(256)) * (6 << 10)
    body, ctype = multipart([("file", "big.wav", content)])
    data = request("POST", "/voices", (f"X-API-Key: {KEY}", f"Content-Type: {ctype}"), body)
    jax, port = both(pair, data)
    assert [wire(r) for r in port] == [wire(r) for r in jax]
    assert port[0][0] == "HTTP/1.1 201 Created"
    assert (pair.port.voices / "big.wav").read_bytes() == content == \
        (pair.jax.voices / "big.wav").read_bytes()
    for side in (pair.port, pair.jax):
        (side.voices / "big.wav").unlink()


@pytest.mark.parametrize("where", ["target", "header_value", "header_name"])
def test_line_over_8190_bytes_is_400(pair, where):
    """A target, header value or header name over 8190 bytes: 400 with the
    JAX server's status line and text, the connection closed."""
    long = "a" * 9000
    if where == "target":
        data = request("GET", "/" + long)
    elif where == "header_value":
        data = request("GET", "/health", (f"X-Long: {long}",))
    else:
        data = request("GET", "/health", (f"X-{long}: 1",))
    jax, port = both(pair, data)
    if where == "header_name":
        # aiohttp counts a header name where its parser crossed the limit,
        # which depends on how the socket was read: the count is masked
        for r in (jax, port):
            r[0][2][0] = re.sub(rb"\(\d+\)", b"(n)", r[0][2][0])
            r[0][1].pop("content-length")
    assert [wire(r) for r in port] == [wire(r) for r in jax]
    assert port[0][0] == "HTTP/1.0 400 Bad Request"


def test_query_duplicate_empty_and_plus_keys(pair):
    """dict(request.query): the first of a repeated key, an empty value
    kept, '+' and '%20' as spaces, percent-encoded names."""
    for target in (f"/tts/generate?te%78t=a+b%20c&text=second&voice_id=&format=raw_pcm&api_key={KEY}",
                   f"/tts/generate?text=x&api_key=wrong&api_key={KEY}",
                   f"/tts/generate?text=x&api_key={KEY}&api_key=wrong&format=raw_pcm",
                   f"/tts/generate?text=&text=x&api_key={KEY}",
                   f"/tts/generate?text=caf%C3%A9&format=raw_pcm&&api_key={KEY}"):
        jax, port = both(pair, request("GET", target))
        assert [wire(r) for r in port] == [wire(r) for r in jax], target
    assert b"".join(both(pair, request("GET", (
        f"/tts/generate?te%78t=a+b%20c&text=second&voice_id=&format=raw_pcm&api_key={KEY}")))[1][0][2]) \
        == b'a b c|""'


@pytest.mark.parametrize("fields", [
    [("other", None, b"x")],
    [("other", None, b"x"), ("file", "mp.wav", b"RIFF...."), ("more", None, b"y")],
    [],
], ids=["missing", "extra", "empty"])
def test_multipart_fields(pair, fields):
    """Upload: no 'file' field is 400; fields around it are skipped."""
    body, ctype = multipart(fields)
    data = request("POST", "/voices", (f"X-API-Key: {KEY}", f"Content-Type: {ctype}"), body)
    jax, port = both(pair, data)
    assert [wire(r) for r in port] == [wire(r) for r in jax]
    for side in (pair.port, pair.jax):
        (side.voices / "mp.wav").unlink(missing_ok=True)


def test_static_files_and_traversal(pair):
    """/static/ serves the repo's static/ directory; a path that resolves
    outside it is 404, the directory itself 403."""
    for target in ("/static/script.js", "/static/../README.md", "/static/%2e%2e/README.md",
                   "/static/..%2fREADME.md", "/static/../../etc/passwd", "/static/",
                   "/static/nope.js", "/"):
        jax, port = both(pair, request("GET", target))
        assert [wire(r) for r in port] == [wire(r) for r in jax], target
        assert (port[0][0] == "HTTP/1.1 200 OK") == (target in ("/static/script.js", "/")), target


def test_cors_preflight(pair):
    """OPTIONS answers 200 with the CORS headers on any path, without
    reaching a handler; other answers carry them too."""
    for data in (request("OPTIONS", "/tts/generate", ("Origin: https://a.example",
                                                      "Access-Control-Request-Method: POST")),
                 request("OPTIONS", "/no/such/path"),
                 request("GET", "/voices", ("Origin: https://a.example",)),
                 request("PUT", "/voices"), request("GET", "/no/such/path")):
        jax, port = both(pair, data)
        assert [wire(r) for r in port] == [wire(r) for r in jax], data
        assert port[0][1]["access-control-allow-origin"] == "*"


@pytest.mark.parametrize("how", ["close", "reset"])
@pytest.mark.parametrize("side", ["port", "jax"])
def test_client_disconnect_cancels_the_request(pair, side, how):
    """A client that goes mid-stream, closing its socket or resetting it:
    the next write raises ConnectionResetError, the handler cancels the
    engine's token and active_requests drains; the stream stops."""
    srv = getattr(pair, side)

    async def go():
        reader, writer = await asyncio.open_connection("127.0.0.1", srv.port)
        writer.write(request("GET", f"/tts/generate?text=endless&format=raw_pcm&api_key={KEY}"))
        await writer.drain()
        await reader.readuntil(b"\r\n\r\n")
        await reader.readexactly(4096)
        assert len(srv.app["active_requests"]) == 1
        token = srv.engine.tokens[-1]
        if how == "close":
            writer.close()
        else:
            writer.transport.abort()
        t0 = time.monotonic()
        while srv.app["active_requests"] and time.monotonic() - t0 < 10:
            await asyncio.sleep(0.01)
        pieces = srv.engine.pieces
        await asyncio.sleep(0.2)
        return token, pieces

    token, pieces = pair.run(go())
    assert not srv.app["active_requests"] and token.is_cancelled()
    assert srv.engine.pieces == pieces
    jax, port = both(pair, request("GET", "/health"))   # the server still answers
    assert port[0][0] == jax[0][0] == "HTTP/1.1 200 OK"


# ------------------------------------------------------------- the dispatcher
def backend_app(name: str, record: list) -> aweb.Application:
    """An aiohttp backend: a stream of three pieces written apart, an
    upload and a delete that record what reached them, a health check."""
    app = aweb.Application()

    async def tts(request):
        record.append((name, request.method, str(request.rel_url), await request.read()))
        resp = aweb.StreamResponse(headers={"Content-Type": "audio/wav", "X-Backend": name})
        await resp.prepare(request)
        for piece in (b"RIFF", b"-" * 10000, name.encode()):
            await resp.write(piece)
            await asyncio.sleep(0.01)
        await resp.write_eof()
        return resp

    async def control(request):
        body = await request.read()
        record.append((name, request.method, str(request.rel_url), body))
        return aweb.json_response({"backend": name, "n": len(body),
                                   "key": request.headers.get("X-API-Key")},
                                  status=201 if request.method == "POST" else 200)

    app.router.add_route("*", "/tts/generate", tts)
    app.router.add_route("*", "/voices", control)
    app.router.add_route("*", "/voices/{voice_id}", control)
    async def health(request):
        return aweb.json_response({"status": "ok"})

    app.router.add_get("/health", health)
    return app


async def start_dispatchers(backends: list):
    """(the port's dispatcher, the JAX one), each on its own server → their
    ports and a closer."""
    from chatterbox_tpu.serve import dispatcher as jdisp
    from chatterbox_tpu_torch.serve import dispatcher as tdisp
    from chatterbox_tpu_torch.serve import web

    port_server = web.AppServer(tdisp.create_dispatcher_app(backends))
    await port_server.start("127.0.0.1", 0)
    jax_server = TestServer(jdisp.create_dispatcher_app(backends), host="127.0.0.1")
    await jax_server.start_server()

    async def close():
        await port_server.close()
        await jax_server.close()

    return {"port": port_server.port, "jax": jax_server.port}, close


async def start_backends(names, record):
    servers = [TestServer(backend_app(n, record), host="127.0.0.1") for n in names]
    for s in servers:
        await s.start_server()
    return servers


async def until_health(port: int, want: list) -> None:
    async with ClientSession() as session:
        t0 = time.monotonic()
        while time.monotonic() - t0 < 10:
            async with session.get(f"http://127.0.0.1:{port}/dispatcher-status") as r:
                if [b["healthy"] for b in (await r.json())["backends"]] == want:
                    return
            await asyncio.sleep(0.05)
    raise AssertionError(f"health never became {want}")


def test_dispatcher_streams_through_its_client():
    """A chunked stream proxied through each dispatcher arrives whole, with
    the backend's headers (not the hop-by-hop ones) and its pieces."""
    async def go():
        record = []
        (b1,) = await start_backends(["b1"], record)
        ports, close = await start_dispatchers([f"http://127.0.0.1:{b1.port}"])
        try:
            out = {}
            for side, port in ports.items():
                raw = await exchange(port, request(
                    "POST", f"/tts/generate?api_key={KEY}", ("Content-Type: application/json",),
                    b'{"text": "hi"}'))
                (status, headers, chunks), = parse_responses(raw)
                out[side] = (status, headers["x-backend"], headers["content-type"],
                             headers["transfer-encoding"], b"".join(chunks))
            return out, record
        finally:
            await close()
            await b1.close()

    out, record = asyncio.run(go())
    assert out["port"] == out["jax"]
    assert out["port"][4] == b"RIFF" + b"-" * 10000 + b"b1"
    assert [r[1:] for r in record] == [("POST", f"/tts/generate?api_key={KEY}", b'{"text": "hi"}')] * 2


def test_dispatcher_broadcasts_to_every_backend():
    """Voice upload and delete reach every backend, with the key and body;
    the first success is the reply."""
    async def go():
        out = {}
        for side in ("port", "jax"):
            record = []
            servers = await start_backends(["b1", "b2"], record)
            ports, close = await start_dispatchers(
                [f"http://127.0.0.1:{s.port}" for s in servers])
            try:
                got = []
                async with ClientSession(headers=H) as session:
                    base = f"http://127.0.0.1:{ports[side]}"
                    async with session.post(base + "/voices", data=b"v" * 5000) as r:
                        got.append((r.status, await r.json()))
                    async with session.delete(base + "/voices/a.wav") as r:
                        got.append((r.status, await r.json()))
                out[side] = (got, sorted((r[0], r[1], r[2], len(r[3])) for r in record))
            finally:
                await close()
                for s in servers:
                    await s.close()
        return out

    out = asyncio.run(go())
    assert out["port"] == out["jax"]
    got, record = out["port"]
    assert got == [(201, {"backend": "b1", "n": 5000, "key": KEY}),
                   (200, {"backend": "b1", "n": 0, "key": KEY})]
    assert record == [("b1", "DELETE", "/voices/a.wav", 0), ("b1", "POST", "/voices", 5000),
                      ("b2", "DELETE", "/voices/a.wav", 0), ("b2", "POST", "/voices", 5000)]


def test_dispatcher_fails_over_from_a_dead_backend():
    """A backend that refuses connections: alone it gives 502 and is marked
    unhealthy; beside a live one, the health check marks it and every
    stream goes to the live one."""
    async def go():
        record = []
        (alive,) = await start_backends(["alive"], record)
        dead = f"http://127.0.0.1:{free_port()}"
        out = {}
        ports, close = await start_dispatchers([dead])
        try:
            for side, port in ports.items():
                (status, _, chunks), = parse_responses(await exchange(
                    port, request("GET", f"/tts/generate?text=x&api_key={KEY}")))
                (_, _, health), = parse_responses(await exchange(
                    port, request("GET", "/dispatcher-status")))
                out[side] = [(status, b"".join(chunks), json.loads(b"".join(health)))]
        finally:
            await close()
        ports, close = await start_dispatchers([dead, f"http://127.0.0.1:{alive.port}"])
        try:
            for side, port in ports.items():
                await until_health(port, [False, True])
                for _ in range(3):
                    (status, headers, chunks), = parse_responses(await exchange(
                        port, request("GET", f"/tts/generate?text=x&api_key={KEY}")))
                    out[side].append((status, headers["x-backend"], b"".join(chunks)[:4]))
        finally:
            await close()
            await alive.close()
        return out

    out = asyncio.run(go())
    assert out["port"] == out["jax"]
    status, body, health = out["port"][0]
    assert status == "HTTP/1.1 502 Bad Gateway" and json.loads(body) == {"error": "backend unavailable"}
    assert [b["healthy"] for b in health["backends"]] == [False]
    assert out["port"][1:] == [("HTTP/1.1 200 OK", "alive", b"RIFF")] * 3
