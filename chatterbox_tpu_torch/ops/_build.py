"""Build the port's CUDA kernels at first use and bind them with ctypes.

Every ``csrc/*.cu`` compiles to an object file in its own nvcc process, all
started together, and one more nvcc call links the objects into one shared
library with a plain C interface (no PyTorch headers: seconds to build, not
minutes):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler -fPIC \
         -Xptxas -v -c -o build/<hash>.<pid>/<name>.o csrc/<name>.cu  # one per source
    nvcc -gencode arch=compute_90a,code=sm_90a -shared \
         -o build/libchatterbox_kernels_<hash>.so build/<hash>.<pid>/*.o

The library lands in ``build/`` beside ``csrc/`` (listed in .gitignore), named
by a hash of the sources and flags so an edited source rebuilds. Pointers and
the stream pass as ``c_void_p``; each C launcher returns ``cudaGetLastError()``
after its launch, and ``check`` raises on a non-zero code. nvcc is looked up
as ``$CUDA_HOME/bin/nvcc``, then on ``PATH``, then ``/usr/local/cuda/bin``.
ptxas's register and spill report (``-Xptxas -v``, which does not change the
generated code) is kept in ``build_info["log"]``.

``refuse_knob`` is what a wrapper raises when an operator's environment
variable (``CHATTERBOX_PALLAS``, ``CHATTERBOX_FLASH``) asks for a kernel's
plain version on the card: the port serves CUDA tensors through its kernels
only.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
FLAGS = [*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signature of each launcher (all return int = cudaError_t)
_SIGNATURES = {
    # q, k, v, k_new, v_new, k_scale, v_scale, start, pos, out, scratch,
    # B, H, Hk, S, Dh, q_dtype, cache_dtype, scale, stream
    "decode_attention_launch": [_P] * 11 + [_I] * 7 + [_F, _P],
    # () → cache rows per slice of decode_attention_launch
    "decode_attention_slice_rows": [],
    # q, k, v, valid, out, B, H, Tq, Tk, Dh, dtype, scale, stream
    "flash_mha_launch": [_P] * 5 + [_I] * 6 + [_F, _P],
    # q, k_own, v_own, k_prompt, v_prompt, k_ring, v_ring, valid, out,
    # B2, Bp, H, Tq, P, W, Dh, q_dtype, ctx_dtype, scale, stream
    "flash_mha_context_launch": [_P] * 9 + [_I] * 9 + [_F, _P],
    # q, k, v, k_new, v_new, start, pos, out, scratch, B, H, Hk, S, Dh, dtype, scale, stream
    "decode_attention_pipelined_launch": [_P] * 9 + [_I] * 6 + [_F, _P],
    # () → cache rows per slice of decode_attention_pipelined_launch
    "decode_attention_pipelined_slice_rows": [],
    # () → ring stages of decode_attention_pipelined_launch
    "decode_attention_pipelined_stages": [],
    # Dh, dtype → cache rows per ring stage
    "decode_attention_pipelined_tile_rows": [_I, _I],
}

# dtype codes shared with csrc/*.cu
DTYPE_F32, DTYPE_BF16, DTYPE_I8 = 0, 1, 2

_lock = threading.Lock()
_lib = None
build_info: dict = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([str(Path(home) / "bin" / "nvcc")] if home else []) + [
        shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc",
    ]:
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels cannot be built")


def build() -> Path:
    """Compile ``csrc/*.cu`` into the shared library unless it exists."""
    sources = sorted(SRC_DIR.glob("*.cu"))
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for src in sorted(SRC_DIR.glob("*.cu*")):
        h.update(src.name.encode() + src.read_bytes())
    digest = h.hexdigest()[:16]
    out = BUILD_DIR / f"libchatterbox_kernels_{digest}.so"
    if out.exists():
        build_info.update(path=str(out), seconds=0.0, cached=True)
        return out
    obj_dir = BUILD_DIR / f"{digest}.{os.getpid()}"
    obj_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    compiles = []
    for src in sources:
        cmd = [nvcc, *FLAGS, "-c", "-o", str(obj_dir / f"{src.stem}.o"), str(src)]
        compiles.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                               stderr=subprocess.PIPE, text=True)))
    logs, failed = [], []
    for cmd, proc in compiles:
        _, err = proc.communicate()
        logs.append(err)
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{err[-8000:]}")
    if failed:
        raise RuntimeError("\n".join(failed))
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    objects = [str(obj_dir / f"{src.stem}.o") for src in sources]
    link = [nvcc, *ARCH, "-shared", "-o", str(tmp), *objects]
    proc = subprocess.run(link, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({proc.returncode}): {' '.join(link)}\n"
                           f"{proc.stderr[-8000:]}")
    seconds = time.perf_counter() - t0
    os.replace(tmp, out)
    shutil.rmtree(obj_dir, ignore_errors=True)
    build_info.update(path=str(out), seconds=seconds, cached=False,
                      command="\n".join([" ".join(c) for c, _ in compiles] + [" ".join(link)]),
                      log="".join(logs) + proc.stderr)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def check(err: int, what: str) -> None:
    """Raise if a launcher reported a CUDA error (refused launch etc.)."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {err}")


def refuse_knob(knob: str, kernel: str) -> RuntimeError:
    """The error for a CUDA call while ``knob`` turns ``kernel`` off."""
    return RuntimeError(
        f"{knob}={os.environ.get(knob)!r} turns {kernel} off, but the port runs CUDA tensors "
        f"through its kernels only: unset {knob} or set it to \"1\" (serve_bench "
        "--plain-attention measures the plain versions)")
