"""Multi-host dispatcher: scale-out across hosts (a copy of
``chatterbox_tpu/serve/dispatcher.py``, so a torch deployment needs nothing
of the JAX package).

A thin HTTP dispatcher in front of N servers (one per host, each owning its
GPU): jobs fair-queue by least-active-requests, results stream straight
through, and the control plane (voice upload/delete) fans out to every
backend so conditioning caches stay coherent.

Run:  python -m chatterbox_tpu_torch.serve.dispatcher \
          --backends http://host1:8000,http://host2:8000 [--port 8080]

Auth passes through to the backends (the dispatcher itself forwards the
X-API-Key header / api_key query untouched).
"""
from __future__ import annotations

import argparse
import asyncio
import itertools
from typing import Dict, List

from ..logging_config import configure_logging, log
from . import web

HOP_HEADERS = {"host", "content-length", "transfer-encoding", "connection"}


class Backend:
    def __init__(self, url: str):
        self.url = url.rstrip("/")
        self.healthy = True
        self.active = 0

    def __repr__(self) -> str:  # pragma: no cover
        return f"Backend({self.url}, healthy={self.healthy}, active={self.active})"


class Dispatcher:
    def __init__(self, backends: List[str]):
        self.backends = [Backend(b) for b in backends]
        self._rr = itertools.count()

    def pick(self) -> Backend:
        healthy = [b for b in self.backends if b.healthy]
        pool = healthy or self.backends
        # least-active with round-robin tie-break (ZMQ PUSH fair-queue analog);
        # tie-break indexes within the POOL so unhealthy gaps can't collide
        n = next(self._rr)
        return sorted(
            pool, key=lambda b: (b.active, (n + pool.index(b)) % len(pool))
        )[0]

    async def health_loop(self, session: web.ClientSession) -> None:
        while True:
            for b in self.backends:
                try:
                    async with session.get(b.url + "/health", timeout=web.ClientTimeout(total=3)) as r:
                        b.healthy = r.status == 200
                except Exception:
                    b.healthy = False
            await asyncio.sleep(5)


def create_dispatcher_app(backends: List[str]) -> web.Application:
    dispatcher = Dispatcher(backends)
    app = web.Application()
    app["dispatcher"] = dispatcher

    async def on_startup(app):
        app["session"] = web.ClientSession()
        app["health_task"] = asyncio.ensure_future(
            dispatcher.health_loop(app["session"])
        )

    async def on_cleanup(app):
        app["health_task"].cancel()
        await app["session"].close()

    app.on_startup.append(on_startup)
    app.on_cleanup.append(on_cleanup)

    def _fwd_headers(request: web.Request) -> Dict[str, str]:
        return {k: v for k, v in request.headers.items() if k.lower() not in HOP_HEADERS}

    async def proxy_stream(request: web.Request) -> web.StreamResponse:
        """Forward to ONE backend, streaming the body through (job+result
        channels)."""
        backend = dispatcher.pick()
        backend.active += 1
        session: web.ClientSession = request.app["session"]
        url = backend.url + str(request.rel_url)
        response = None
        try:
            body = await request.read() if request.can_read_body else None
            async with session.request(
                request.method, url, headers=_fwd_headers(request), data=body,
                timeout=web.ClientTimeout(total=None, sock_read=300),
            ) as upstream:
                response = web.StreamResponse(status=upstream.status)
                for k, v in upstream.headers.items():
                    if k.lower() not in HOP_HEADERS:
                        response.headers[k] = v
                await response.prepare(request)
                async for chunk in upstream.content.iter_chunked(8192):
                    await response.write(chunk)
                await response.write_eof()
                return response
        except web.ClientError as exc:
            backend.healthy = False
            log.warning("backend %s failed: %s", backend.url, exc)
            if response is not None and response.prepared:
                # headers already sent: terminate the stream so the client
                # sees a broken transfer instead of a silent truncation
                await response.write_eof()
                request.transport and request.transport.close()
                return response
            return web.json_response({"error": "backend unavailable"}, status=502)
        finally:
            backend.active -= 1

    async def broadcast(request: web.Request) -> web.Response:
        """Fan a control-plane request out to ALL backends (broadcast
        channel: voice upload/delete keeps every cache coherent)."""
        session: web.ClientSession = request.app["session"]
        body = await request.read() if request.can_read_body else None
        results = []
        for b in dispatcher.backends:
            try:
                async with session.request(
                    request.method, b.url + str(request.rel_url),
                    headers=_fwd_headers(request), data=body,
                    timeout=web.ClientTimeout(total=60),
                ) as r:
                    results.append((b.url, r.status, await r.read()))
            except web.ClientError as exc:
                b.healthy = False
                results.append((b.url, 502, str(exc).encode()))
        # the first successful backend response defines the reply
        ok = [r for r in results if r[1] < 400]
        status = ok[0][1] if ok else results[0][1]
        payload = ok[0][2] if ok else results[0][2]
        return web.Response(
            body=payload, status=status, content_type="application/json"
        )

    async def status(request: web.Request) -> web.Response:
        return web.json_response(
            {
                "backends": [
                    {"url": b.url, "healthy": b.healthy, "active": b.active}
                    for b in dispatcher.backends
                ]
            }
        )

    app.router.add_route("*", "/tts/generate", proxy_stream)
    app.router.add_route("GET", "/voices", proxy_stream)
    app.router.add_route("POST", "/voices", broadcast)
    app.router.add_route("DELETE", "/voices/{voice_id}", broadcast)
    app.router.add_route("GET", "/system-status", proxy_stream)
    app.router.add_route("GET", "/", proxy_stream)
    app.router.add_route("GET", "/health", status)
    app.router.add_route("GET", "/dispatcher-status", status)
    return app


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--backends", required=True, help="comma-separated backend URLs")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=8080)
    args = ap.parse_args()
    configure_logging(tag="DISPATCHER")
    app = create_dispatcher_app([b.strip() for b in args.backends.split(",") if b.strip()])
    web.run_app(app, host=args.host, port=args.port)


if __name__ == "__main__":
    main()
