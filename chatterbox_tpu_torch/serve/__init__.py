"""Serving layer of the port: the voice store, which the engine uses; the
HTTP server (``app``, ``api``, ``telemetry``) and the multi-host
``dispatcher``, both on ``web``, an HTTP/1.1 server and client built on the
standard library's asyncio streams (no aiohttp), imported only to serve."""
from .voice_manager import VoiceManager

__all__ = ["VoiceManager"]
