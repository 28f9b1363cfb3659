from .model import VoiceEncoderConfig, init_voice_encoder_params, voice_embed

__all__ = ["VoiceEncoderConfig", "init_voice_encoder_params", "voice_embed"]
