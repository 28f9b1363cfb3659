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
  models/        T3 (speech-token decoder) and S3Gen ref (token → waveform)
  ops/           core numerics, sampling, the three kernels and their nvcc build
  runtime/       the streaming engine, the batched T3 decoder, the S3Gen
                 micro-batcher, serving metrics, conds.pt loading
  settings.py    environment settings (same variable names as the JAX package)
  convert.py     JAX-layout parameter pytrees → the port's layouts
"""

__version__ = "0.1.0"
