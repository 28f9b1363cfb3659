"""Streaming container encoders: wav / raw_pcm passthrough, mp3 / fmp4 / webm
via an FFmpeg subprocess (a copy of ``chatterbox_tpu.audio.encoding``).

Same format surface and FFmpeg argv contracts as the reference encoder
(reference src/audio_encoding.py:12-17, 182-255): AAC fMP4 with 500 ms
fragments for MSE playback, MP3 at 128k, Opus WebM with 50 ms clusters. The
subprocess plumbing here uses asyncio pipes natively (no thread executors —
the host has few cores and the event loop must stay free for the TTS
pipeline). Encoding is inherently host-side work; the TPU never sees it.

When the ffmpeg binary is unavailable, wav/raw_pcm still work and the
compressed formats raise ``FfmpegUnavailableError`` at encode start.
"""
from __future__ import annotations

import asyncio
import shutil
from enum import Enum
from typing import AsyncGenerator, Dict, List, Optional

from ..logging_config import log
from .pcm import make_wav_header


class AudioFormat(Enum):
    WAV = "wav"
    RAW_PCM = "raw_pcm"
    FMP4 = "fmp4"
    MP3 = "mp3"
    WEBM = "webm"


class FfmpegUnavailableError(RuntimeError):
    pass


MIME_TYPES: Dict[AudioFormat, str] = {
    AudioFormat.WAV: "audio/wav",
    AudioFormat.RAW_PCM: "audio/pcm",
    AudioFormat.FMP4: "audio/mp4",
    AudioFormat.MP3: "audio/mpeg",
    AudioFormat.WEBM: "audio/webm",
}

FILE_EXTENSIONS: Dict[AudioFormat, str] = {
    AudioFormat.WAV: ".wav",
    AudioFormat.RAW_PCM: ".pcm",
    AudioFormat.FMP4: ".mp4",
    AudioFormat.MP3: ".mp3",
    AudioFormat.WEBM: ".webm",
}


class AudioEncoder:
    """Encode a stream of raw PCM chunks into the requested container format.

    Each pushed PCM chunk is processed immediately; output bytes are yielded
    as soon as the encoder produces them (true streaming).
    """

    READ_SIZE = 4096

    def __init__(
        self,
        output_format: str,
        sample_rate: int,
        channels: int = 1,
        bit_depth: int = 16,
        log_prefix: str = "",
        **kwargs,
    ):
        self.output_format = AudioFormat(str(output_format).lower())
        self.sample_rate = int(sample_rate)
        self.channels = int(channels)
        self.bit_depth = int(bit_depth)
        self.log_prefix = log_prefix
        self.kwargs = kwargs
        if self.bit_depth not in (8, 16, 24, 32):
            raise ValueError(f"Unsupported bit depth: {self.bit_depth}")
        if self.channels not in (1, 2):
            raise ValueError(f"Unsupported channel count: {self.channels}")
        self._proc: Optional[asyncio.subprocess.Process] = None

    # ---------------------------------------------------------------- helpers
    def get_mime_type(self) -> str:
        return MIME_TYPES.get(self.output_format, "application/octet-stream")

    def get_file_extension(self) -> str:
        return FILE_EXTENSIONS.get(self.output_format, ".bin")

    def ffmpeg_argv(self) -> List[str]:
        """FFmpeg command line for the compressed formats (argv contract kept
        from the reference so deployments behave identically)."""
        sample_fmt = f"s{self.bit_depth}le"
        head = [
            "ffmpeg",
            "-f", sample_fmt,
            "-ar", str(self.sample_rate),
            "-ac", str(self.channels),
            "-i", "pipe:0",
        ]
        if self.output_format == AudioFormat.FMP4:
            codec = [
                "-c:a", "aac",
                "-b:a", self.kwargs.get("bitrate", "64k"),
                "-f", "mp4",
                "-movflags", "frag_keyframe+empty_moov+default_base_moof+dash",
                "-frag_duration", str(self.kwargs.get("fragment_duration", 500000)),
                "-flush_packets", "1",
                "-reset_timestamps", "1",
                "-avoid_negative_ts", "make_zero",
            ]
        elif self.output_format == AudioFormat.MP3:
            codec = [
                "-c:a", "libmp3lame",
                "-b:a", self.kwargs.get("bitrate", "128k"),
                "-f", "mp3",
                "-flush_packets", "1",
            ]
        elif self.output_format == AudioFormat.WEBM:
            codec = [
                "-c:a", "libopus",
                "-b:a", self.kwargs.get("bitrate", "64k"),
                "-f", "webm",
                "-cluster_size_limit", "2k",
                "-cluster_time_limit", "50",
                "-flush_packets", "1",
            ]
        else:
            raise ValueError(f"{self.output_format} does not use ffmpeg")
        return head + codec + ["pipe:1", "-loglevel", "error"]

    # ---------------------------------------------------------------- encode
    async def encode(
        self, pcm_generator: AsyncGenerator[bytes, None]
    ) -> AsyncGenerator[bytes, None]:
        if self.output_format == AudioFormat.RAW_PCM:
            async for chunk in pcm_generator:
                yield chunk
            return

        if self.output_format == AudioFormat.WAV:
            yield make_wav_header(self.sample_rate, self.channels, self.bit_depth)
            async for chunk in pcm_generator:
                yield chunk
            return

        async for chunk in self._encode_via_ffmpeg(pcm_generator):
            yield chunk

    async def _encode_via_ffmpeg(
        self, pcm_generator: AsyncGenerator[bytes, None]
    ) -> AsyncGenerator[bytes, None]:
        if shutil.which("ffmpeg") is None:
            raise FfmpegUnavailableError(
                f"ffmpeg binary not found; cannot encode {self.output_format.value}"
            )
        argv = self.ffmpeg_argv()
        # stderr → DEVNULL: ffmpeg's banner/progress would fill an undrained
        # pipe (~64 KB) on long encodes and deadlock the whole stream. (The
        # argv places -loglevel after the output, where ffmpeg ignores it —
        # kept for reference-argv parity, so stderr is NOT quiet.)
        self._proc = await asyncio.create_subprocess_exec(
            *argv,
            stdin=asyncio.subprocess.PIPE,
            stdout=asyncio.subprocess.PIPE,
            stderr=asyncio.subprocess.DEVNULL,
        )

        async def feed() -> None:
            try:
                async for pcm_chunk in pcm_generator:
                    self._proc.stdin.write(pcm_chunk)
                    await self._proc.stdin.drain()
            except (BrokenPipeError, ConnectionResetError):
                pass
            except Exception as exc:  # pragma: no cover - defensive
                log.error("%sffmpeg writer error: %s", self.log_prefix, exc)
            finally:
                try:
                    self._proc.stdin.close()
                except Exception:
                    pass

        writer = asyncio.ensure_future(feed())
        try:
            while True:
                chunk = await self._proc.stdout.read(self.READ_SIZE)
                if not chunk:
                    break
                yield chunk
            await writer
        finally:
            writer.cancel()
            await self._cleanup()

    async def _cleanup(self) -> None:
        proc = self._proc
        if proc is None:
            return
        try:
            if proc.returncode is None:
                proc.terminate()
                try:
                    await asyncio.wait_for(proc.wait(), timeout=1.0)
                except asyncio.TimeoutError:
                    proc.kill()
                    await proc.wait()
        except ProcessLookupError:
            pass
        self._proc = None
