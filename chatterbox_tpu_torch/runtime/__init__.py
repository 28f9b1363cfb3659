from .cancellation import CancellationToken
from .engine import Conditionals, EngineConfig, InitializationState, TTSEngine

__all__ = ["CancellationToken", "Conditionals", "EngineConfig", "InitializationState", "TTSEngine"]
