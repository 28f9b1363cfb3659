"""Application factory: wires the engine, voice manager and routes (torch
counterpart of ``chatterbox_tpu/serve/app.py``).

One process owns the engine (the models in device memory). Startup
initialises the engine and warms the voice-conditioning cache for every
stored voice; a supervisor rebuilds the engine if it lands in ERROR.

Run:  API_KEY=... MODEL_PATH=<model dir> python -m chatterbox_tpu_torch.serve.app

The engine runs on the GPU; ``CHATTERBOX_FORCE_CPU=1`` asks for the CPU.
Without it and without CUDA the engine refuses to start.
"""
from __future__ import annotations

import asyncio
import os
import time
import uuid
from typing import Optional

from ..logging_config import configure_logging, log
from ..runtime.engine import TTSEngine
from ..settings import get_settings
from . import web
from .api import register_api_routes
from .voice_manager import VoiceManager


@web.middleware
async def request_context_middleware(request: web.Request, handler):
    """Request id and duration logging; the polled paths are not logged."""
    request_id = str(uuid.uuid4())
    request.request_id = request_id
    start = time.time()
    try:
        return await handler(request)
    finally:
        if request.path not in ("/health", "/system-status"):
            log.info("[%s] %s %s took %.4fs", request_id, request.method, request.path,
                     time.time() - start)


@web.middleware
async def cors_middleware(request: web.Request, handler):
    if request.method == "OPTIONS":
        response = web.Response()
    else:
        try:
            response = await handler(request)
        except web.HTTPException as exc:
            response = exc
    origins = get_settings().CORS_ORIGINS
    origin = request.headers.get("Origin")
    allow = "*" if "*" in origins else (origin if origin in origins else None)
    if allow:
        response.headers["Access-Control-Allow-Origin"] = allow
        response.headers["Access-Control-Allow-Headers"] = "X-API-Key, Content-Type"
        response.headers["Access-Control-Allow-Methods"] = "GET, POST, DELETE, OPTIONS"
    if isinstance(response, web.HTTPException):
        raise response
    return response


def _engine_device() -> Optional[str]:
    """The device the server's engine asks for: the CPU with
    CHATTERBOX_FORCE_CPU=1, else the engine's default (the GPU)."""
    return "cpu" if os.environ.get("CHATTERBOX_FORCE_CPU") == "1" else None


def create_app(engine: Optional[TTSEngine] = None, warm_voices: bool = True) -> web.Application:
    settings = get_settings()
    if not settings.API_KEY:
        raise RuntimeError("API_KEY must be set (environment variable or .env).")
    app = web.Application(middlewares=[cors_middleware, request_context_middleware])
    app["engine"] = engine or TTSEngine(device=_engine_device())
    app["voice_manager"] = VoiceManager()
    app["active_requests"] = {}
    app["background_tasks"] = set()

    async def supervisor(app: web.Application) -> None:
        """Supervised engine restart: if the engine lands in ERROR, rebuild
        and re-initialise it in place."""
        while True:
            await asyncio.sleep(10)
            eng: TTSEngine = app["engine"]
            if eng.get_initialization_status()["state"] == "error":
                log.warning("Engine in ERROR state — restarting")
                try:
                    eng.shutdown()  # free device memory BEFORE loading the replacement
                    new_engine = TTSEngine(eng.cfg, seed=eng.seed, device=eng.device)
                    await new_engine.ainit()
                    app["engine"] = new_engine
                    log.info("Engine restarted successfully")
                except Exception:
                    log.exception("Engine restart failed; retrying in 10s")

    async def warm(eng: TTSEngine) -> None:
        vm = app["voice_manager"]
        for vid in vm.list_voices():
            try:
                await asyncio.to_thread(eng.prepare_conditionals, vm.get_voice_path(vid))
            except Exception:
                log.exception("Warm-up failed for voice %s", vid)
        log.info("Voice cache warm-up complete (%d voices)", len(eng.voice_cache))

    async def on_startup(app: web.Application) -> None:
        eng: TTSEngine = app["engine"]
        if eng.get_initialization_status()["state"] == "not_started":
            await eng.ainit()
        app["supervisor_task"] = asyncio.ensure_future(supervisor(app))
        if warm_voices:
            app["warm_task"] = asyncio.ensure_future(warm(eng))

    async def on_cleanup(app: web.Application) -> None:
        tasks = [app[k] for k in ("supervisor_task", "warm_task") if k in app]
        tasks += list(app["background_tasks"])
        for task in tasks:
            task.cancel()
        await asyncio.gather(*tasks, return_exceptions=True)
        for token in list(app["active_requests"].values()):
            token.cancel()
        app["engine"].shutdown()

    app.on_startup.append(on_startup)
    app.on_cleanup.append(on_cleanup)
    register_api_routes(app)
    return app


def main() -> None:
    settings = get_settings()
    configure_logging(settings.LOG_LEVEL, tag="SERVER")
    web.run_app(create_app(), host=settings.HOST, port=settings.PORT)


if __name__ == "__main__":
    main()
