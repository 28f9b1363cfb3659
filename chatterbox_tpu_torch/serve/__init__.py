"""Serving layer of the port: the voice store, which the engine uses, and
the aiohttp server (``app``, ``api``, ``telemetry``) and multi-host
``dispatcher``, which import aiohttp and are imported only to serve."""
from .voice_manager import VoiceManager

__all__ = ["VoiceManager"]
