"""HTTP API routes (aiohttp; torch counterpart of ``chatterbox_tpu/serve/api.py``).

The JAX package's surface, endpoint for endpoint and parameter for
parameter:

  GET  /                      web console (the repo's static/)
  GET|POST /tts/generate      streaming synthesis (auth)
  POST /voices                voice upload, 409 on duplicate (auth)
  GET  /voices                list voice ids (auth)
  DELETE /voices/{voice_id}   delete user voice, 404 if absent (auth)
  GET  /health                liveness (no auth)
  GET  /system-status         CPU/RAM + GPU telemetry, metrics, which kernels are on,
                              tensor parallelism (auth)
  POST /profile/start|stop    a torch.profiler Chrome trace into ?dir= (auth)

Auth: ``X-API-Key`` header OR ``api_key`` query parameter. Requests are
parsed without pydantic by ``parse_tts_request``, with the coercions of the
JAX package's request model, so the same bad input gets the same 400.
"""
from __future__ import annotations

import asyncio
import dataclasses
import math
import os
import re
import tempfile
import time
import uuid
from pathlib import Path
from typing import Mapping, Optional

import torch
from aiohttp import web

from ..audio.encoding import AudioEncoder, FfmpegUnavailableError
from ..logging_config import log
from ..ops.decode_attention import pallas_enabled
from ..ops.flash_mha import flash_enabled
from ..runtime.cancellation import CancellationToken
from ..runtime.metrics import metrics
from ..settings import get_settings, get_tts_config
from .telemetry import cpu_status, gpu_status

STATIC_DIR = Path(__file__).resolve().parent.parent.parent / "static"

SUPPORTED_FORMATS = ("wav", "raw_pcm", "fmp4", "mp3", "webm")

# an integer as text: ASCII digits, single underscores between them, an
# optional all-zero fraction (what the JAX package's request model accepts)
_INT_TEXT = re.compile(r"[+-]?[0-9]+(?:_[0-9]+)*(?:\.0+)?")


@dataclasses.dataclass(frozen=True)
class TTSRequest:
    text: str
    voice_id: Optional[str]
    format: Optional[str]
    cfg_guidance_weight: float
    synthesis_temperature: float
    text_processing_chunk_size: int
    audio_tokens_per_slice: int
    remove_trailing_milliseconds: int
    remove_leading_milliseconds: int
    chunk_overlap_strategy: str
    crossfade_duration_milliseconds: int


def _as_str(v, optional: bool):
    if v is None and optional:
        return None
    if isinstance(v, str):
        return v
    raise ValueError(f"not a string: {v!r}")


def _as_float(v) -> float:
    if isinstance(v, (bool, int, float)):
        return float(v)
    if isinstance(v, str) and v.isascii():
        return float(v.strip())
    raise ValueError(f"not a number: {v!r}")


def _as_int(v) -> int:
    if isinstance(v, (bool, int)):
        return int(v)
    if isinstance(v, float) and math.isfinite(v) and v.is_integer() and abs(v) < 2**63:
        return int(v)
    if isinstance(v, str) and v.isascii() and _INT_TEXT.fullmatch(v.strip()):
        return int(v.strip().split(".")[0])
    raise ValueError(f"not an integer: {v!r}")


def parse_tts_request(values: Mapping) -> TTSRequest:
    """A request's parameters (query or JSON body) → TTSRequest, each absent
    one from the ``TTS_*`` defaults; unknown keys are ignored. Raises
    ValueError for a value of the wrong type."""
    cfg = get_tts_config()
    defaults = {"text": "", "voice_id": None, "format": "wav",
                **{f.name: getattr(cfg, f.name.upper()) for f in dataclasses.fields(TTSRequest)
                   if hasattr(cfg, f.name.upper())}}
    out = {}
    for f in dataclasses.fields(TTSRequest):
        v = values.get(f.name, defaults[f.name])
        if f.type in ("str", "Optional[str]"):
            out[f.name] = _as_str(v, f.type == "Optional[str]")
        else:
            out[f.name] = _as_float(v) if f.type == "float" else _as_int(v)
    return TTSRequest(**out)


def check_api_key(request: web.Request) -> None:
    key = request.headers.get("X-API-Key") or request.query.get("api_key")
    expected = get_settings().API_KEY
    if not key or key != expected:
        raise web.HTTPUnauthorized(
            text='{"detail": "Invalid or missing API Key"}', content_type="application/json"
        )


def register_api_routes(app: web.Application) -> None:
    routes = web.RouteTableDef()

    @routes.get("/")
    async def read_root(request: web.Request) -> web.StreamResponse:
        index = STATIC_DIR / "index.html"
        if index.exists():
            return web.FileResponse(index)
        return web.Response(text="chatterbox-tpu", content_type="text/plain")

    @routes.route("*", "/tts/generate")
    async def tts_generate(request: web.Request) -> web.StreamResponse:
        if request.method not in ("GET", "POST"):
            raise web.HTTPMethodNotAllowed(request.method, ["GET", "POST"])
        check_api_key(request)
        if request.method == "POST":
            try:
                body = await request.json()
                if not isinstance(body, dict):
                    raise ValueError("the body is not a JSON object")
                tts_request = parse_tts_request(body)
            except ValueError:
                return web.json_response({"error": "Invalid JSON body"}, status=400)
        else:
            try:
                tts_request = parse_tts_request(dict(request.query))
            except ValueError:
                return web.json_response({"error": "Invalid query parameters"}, status=400)

        if not tts_request.text:
            return web.json_response({"error": "Text is required"}, status=400)
        fmt = (tts_request.format or "wav").lower()
        if fmt not in SUPPORTED_FORMATS:
            return web.json_response(
                {
                    "detail": f"Invalid audio format: '{tts_request.format}'. "
                    f"Supported formats are: wav, raw_pcm, fmp4, mp3, webm"
                },
                status=400,
            )
        engine = request.app["engine"]
        if tts_request.voice_id and not request.app["voice_manager"].voice_exists(
            tts_request.voice_id
        ):
            return web.json_response(
                {"detail": f"Voice '{tts_request.voice_id}' not found."}, status=404
            )

        # fail BEFORE headers go out: once response.prepare() runs, any error
        # turns into an HTTP 200 with an aborted body
        status = engine.get_initialization_status()
        if status.get("state") != "ready":
            return web.json_response(
                {"detail": f"TTS engine is not ready (state: {status.get('state')})."},
                status=503,
            )

        request_id = getattr(request, "request_id", None) or str(uuid.uuid4())
        token = CancellationToken()
        media_type = AudioEncoder(fmt, engine.sr).get_mime_type()
        response = web.StreamResponse(
            status=200, headers={"Content-Type": media_type, "X-Request-ID": request_id}
        )
        await response.prepare(request)
        active = request.app["active_requests"]
        active[request_id] = token
        try:
            async for chunk in engine.stream(
                text=tts_request.text,
                output_format=fmt,
                voice_id=tts_request.voice_id,
                cfg_guidance_weight=tts_request.cfg_guidance_weight,
                synthesis_temperature=tts_request.synthesis_temperature,
                text_processing_chunk_size=tts_request.text_processing_chunk_size,
                audio_tokens_per_slice=tts_request.audio_tokens_per_slice,
                remove_trailing_milliseconds=tts_request.remove_trailing_milliseconds,
                remove_leading_milliseconds=tts_request.remove_leading_milliseconds,
                chunk_overlap_strategy=tts_request.chunk_overlap_strategy,
                crossfade_duration_milliseconds=tts_request.crossfade_duration_milliseconds,
                request_id=request_id,
                cancellation_token=token,
            ):
                if chunk:
                    await response.write(chunk)
        except FfmpegUnavailableError as exc:
            log.warning("[%s] %s", request_id, exc)
        except (ConnectionResetError, asyncio.CancelledError):
            log.info("[%s] client disconnected; cancelling", request_id)
        finally:
            token.cancel()
            active.pop(request_id, None)
        await response.write_eof()
        return response

    @routes.post("/voices")
    async def upload_voice(request: web.Request) -> web.Response:
        check_api_key(request)
        reader = await request.multipart()
        field = await reader.next()
        while field is not None and field.name != "file":
            field = await reader.next()
        if field is None:
            return web.json_response({"error": "file field required"}, status=400)
        filename = field.filename or "voice.wav"
        contents = bytearray()
        while True:
            piece = await field.read_chunk()
            if not piece:
                break
            contents.extend(piece)
        vm = request.app["voice_manager"]
        engine = request.app["engine"]
        try:
            vm.save_voice(filename, bytes(contents))
        except FileExistsError as exc:
            # still warm the cache: on shared storage a broadcast upload can
            # land as a duplicate here while this node's cache is cold
            path = vm.get_voice_path(filename)
            if path and filename not in engine.voice_cache:
                _warm(request.app, engine, path)
            return web.json_response({"detail": str(exc)}, status=409)
        except ValueError as exc:
            return web.json_response({"detail": str(exc)}, status=400)
        _warm(request.app, engine, vm.get_voice_path(filename))
        return web.json_response(
            {"voice_id": filename, "message": "Voice uploaded and cache warming initiated."},
            status=201,
        )

    @routes.get("/voices")
    async def list_voices(request: web.Request) -> web.Response:
        check_api_key(request)
        return web.json_response(request.app["voice_manager"].list_voices())

    @routes.delete("/voices/{voice_id}")
    async def delete_voice(request: web.Request) -> web.Response:
        check_api_key(request)
        voice_id = request.match_info["voice_id"]
        try:
            request.app["voice_manager"].delete_voice(voice_id)
        except FileNotFoundError:
            return web.json_response({"detail": f"Voice '{voice_id}' not found."}, status=404)
        request.app["engine"].clear_voice_cache(voice_id)
        return web.json_response({"message": f"Voice '{voice_id}' deleted successfully."})

    @routes.get("/health")
    async def health(request: web.Request) -> web.Response:
        return web.json_response({"status": "ok", "message": "Server is running."})

    @routes.get("/system-status")
    async def system_status(request: web.Request) -> web.Response:
        check_api_key(request)
        engine = request.app["engine"]
        return web.json_response(
            {
                "cpu": cpu_status(),
                "tpus": [],  # the JAX server's key, kept for client compatibility
                "gpus": gpu_status(),
                "engine": engine.get_initialization_status(),
                "active_requests": len(request.app["active_requests"]),
                "metrics": metrics.snapshot(),
                # the port's own key: each kernel's environment switch, and
                # whether it leaves the kernel on (off, the kernel's CUDA
                # calls raise: the port has no plain route on the card)
                "kernels": {
                    "decode_attention": {"env": "CHATTERBOX_PALLAS", "on": pallas_enabled()},
                    "flash_mha": {"env": "CHATTERBOX_FLASH", "on": flash_enabled()},
                },
                # tensor parallelism (CHATTERBOX_TP): ranks, devices, backend
                "tp": engine.tp_status(),
            }
        )

    @routes.post("/profile/start")
    async def profile_start(request: web.Request) -> web.Response:
        """Start a torch.profiler trace (CPU, and CUDA where there is a GPU);
        /profile/stop writes it to ``dir`` as a Chrome trace."""
        check_api_key(request)
        trace_dir = request.query.get("dir", os.path.join(tempfile.gettempdir(), "chatterbox-trace"))
        if request.app.get("profiling"):
            return web.json_response({"error": "profiling already active"}, status=409)
        activities = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=activities)
        prof.start()
        request.app["profiling"] = (trace_dir, prof)
        return web.json_response({"message": "profiling started", "dir": trace_dir})

    @routes.post("/profile/stop")
    async def profile_stop(request: web.Request) -> web.Response:
        check_api_key(request)
        if not request.app.get("profiling"):
            return web.json_response({"error": "profiling not active"}, status=409)
        trace_dir, prof = request.app.pop("profiling")
        trace = Path(trace_dir) / f"trace-{time.strftime('%Y%m%d-%H%M%S')}-{os.getpid()}.json"

        prof.stop()  # on the thread that started it, as the profiler requires
        trace.parent.mkdir(parents=True, exist_ok=True)
        await asyncio.to_thread(prof.export_chrome_trace, str(trace))
        return web.json_response({"message": "profiling stopped", "dir": trace_dir,
                                  "trace": str(trace)})

    app.add_routes(routes)
    if STATIC_DIR.exists():
        app.router.add_static("/static", STATIC_DIR)


def _warm(app: web.Application, engine, path: str) -> None:
    """Clone an uploaded voice in the background; the task is kept until it
    ends and a failure is logged."""
    task = asyncio.ensure_future(asyncio.to_thread(engine.prepare_conditionals, path))
    tasks = app["background_tasks"]
    tasks.add(task)

    def finished(t: asyncio.Future) -> None:
        tasks.discard(t)
        if not t.cancelled() and t.exception() is not None:
            log.error("Warming voice %s failed", path, exc_info=t.exception())

    task.add_done_callback(finished)
