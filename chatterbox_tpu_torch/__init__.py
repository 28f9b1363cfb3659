"""chatterbox_tpu_torch — the PyTorch + CUDA port of ``chatterbox_tpu``.

The JAX package ``chatterbox_tpu`` is the reference; this package mirrors its
module paths so each counterpart is found by name, and computes the same
functions (held against it by ``tests/test_torch_*.py``). It imports torch and
never jax. Every TPU kernel of the JAX package is a CUDA C++ kernel for Hopper
here (``csrc/``), built with nvcc at first use and bound with ctypes
(``ops/_build.py``); each has its plain PyTorch version beside it, which a
wrapper takes only for a tensor on the CPU.

Package layout:
  text/, audio/  host-side chunking, PCM/WAV, crossfade, container encoders
  models/        T3 (speech-token decoder), S3Gen ref (token → waveform, and
                 its voice embedding: front ends, S3TokenizerV2, CAMPPlus)
                 and the VoiceEncoder
  ops/           core numerics, spectra, sampling, the three kernels and
                 their nvcc build
  runtime/       the streaming engine (voice cloning included), the batched T3
                 decoder, the S3Gen micro-batcher, serving metrics; loading
                 a model directory (safetensors reader and writer, the
                 reference and native checkpoint formats, the manifest)
  serve/         the voice store; the aiohttp server and the multi-host
                 dispatcher (``python -m chatterbox_tpu_torch.serve.app``)
  data/          the full-size checkpoint key manifest
  settings.py    environment settings (same variable names as the JAX package)
  convert.py     JAX-layout parameter pytrees ↔ the port's layouts
"""

__version__ = "0.1.0"
