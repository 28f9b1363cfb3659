"""Serving helpers of the port (the voice store)."""
from .voice_manager import VoiceManager

__all__ = ["VoiceManager"]
