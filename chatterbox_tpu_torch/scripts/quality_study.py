"""Quality study of the serving knobs (the counterpart of
``scripts/quality_study.py``).

Synthesizes the same fixed-seed request under the default configuration and
under each knob variant, then reports MCD / LSD (``audio/quality.py``) of
each variant against the default output.

    python -m chatterbox_tpu_torch.scripts.quality_study [--tiny] [--text "..."] [--out study.json] [--only a,b]

Each variant runs in a fresh child process (``python -m
chatterbox_tpu_torch.scripts.run_variant``): the knobs are read when the
engine is built. The child is ``run_child``, which writes ``<name>.wav``
and a sidecar ``<name>.json`` (the request's ``request_stats``, K1's
launches per cache body and K2's per form, the kernels run as their plain
versions) into the study's directory, a ``quality_study_*`` directory under
the temporary directory that is kept, so ``quality_salvage`` can score a run
that was cut. With ``--tiny`` the children run ``EngineConfig.tiny_ref()``
on the CPU; without it ``EngineConfig.full()`` (ref arch) on the CUDA
device, and with none a child fails, naming it: there is no CPU fallback.
Random weights unless MODEL_PATH holds a checkpoint.

``CHATTERBOX_PALLAS`` / ``CHATTERBOX_FLASH`` at anything but "1" become the
swap of ``common.kernel_swap``: K1's / K2's plain version at its call site
(``reference_exact`` runs K1's plain version with K2 on, as the JAX package
turns off its Pallas decode kernel only). The JAX study's
``CHATTERBOX_PRECOMPILE=0`` has no counterpart: the port has no precompile
plan, and eager PyTorch compiles nothing.
"""
from __future__ import annotations

import argparse
import asyncio
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

from ..audio.pcm import read_wav
from ..audio.quality import log_spectral_distance, mel_cepstral_distortion
from ..ops import decode_attention, flash_mha
from ..runtime.cancellation import CancellationToken
from ..runtime.engine import TTSEngine
from . import common

TEXT = (
    "The quick brown fox jumps over the lazy dog while the orchestra plays "
    "a long and winding melody."
)
REQUEST_ID = "quality-study"   # seeds the request's sampling
# random-weight decode never emits EOS: each chunk decodes up to this cap
# unless CHATTERBOX_MAX_NEW_TOKENS says otherwise
DEFAULT_NEW_TOKENS = "250"

# The JAX study's variants: names, order and environments (the knobs are the
# JAX package's, read by the port under the same names). STUDY_SLICE sets
# the request's audio_tokens_per_slice.
VARIANTS = [
    ("default", {}),
    ("cfm_steps_8", {"CHATTERBOX_CFM_STEPS": "8"}),
    ("cfm_steps_6", {"CHATTERBOX_CFM_STEPS": "6"}),
    ("overlap_window_105", {"CHATTERBOX_OVERLAP_WINDOW_TOKENS": "105"}),
    ("overlap_window_70", {"CHATTERBOX_OVERLAP_WINDOW_TOKENS": "70"}),
    ("flow_prompt_125", {"CHATTERBOX_FLOW_PROMPT_TOKENS": "125"}),
    ("cfm8_overlap105", {"CHATTERBOX_CFM_STEPS": "8",
                         "CHATTERBOX_OVERLAP_WINDOW_TOKENS": "105"}),
    ("kv_native", {"CHATTERBOX_KV": "native"}),
    ("slice_70", {"STUDY_SLICE": "70"}),
    ("slice70_cfm8", {"STUDY_SLICE": "70", "CHATTERBOX_CFM_STEPS": "8"}),
    ("slice70_cfm8_window140", {"STUDY_SLICE": "70", "CHATTERBOX_CFM_STEPS": "8",
                                "CHATTERBOX_OVERLAP_WINDOW_TOKENS": "140"}),
    ("prompt_cache_step", {"CHATTERBOX_CFM_PROMPT_CACHE": "step"}),
    ("prompt_cache_static", {"CHATTERBOX_CFM_PROMPT_CACHE": "static"}),
    ("pcache_step_slice70", {"CHATTERBOX_CFM_PROMPT_CACHE": "step",
                             "STUDY_SLICE": "70"}),
    ("pcache_step_cfm8", {"CHATTERBOX_CFM_PROMPT_CACHE": "step",
                          "CHATTERBOX_CFM_STEPS": "8"}),
    ("flow_bf16", {"CHATTERBOX_FLOW_BF16": "1"}),
    ("pcache_step_bf16", {"CHATTERBOX_CFM_PROMPT_CACHE": "step",
                          "CHATTERBOX_FLOW_BF16": "1"}),
    ("cfm_stream_off", {"CHATTERBOX_CFM_STREAM": "0"}),
    ("reference_resolve", {"CHATTERBOX_CFM_STREAM": "0",
                           "CHATTERBOX_CFM_PROMPT_CACHE": "0"}),
    ("stream_window_256", {"CHATTERBOX_STREAM_WINDOW": "256"}),
    # every serving default reverted at once: native KV, no CFM prompt
    # cache, no streaming CFM, K1's plain version (kernel_swap)
    ("reference_exact", {"CHATTERBOX_KV": "native",
                         "KV_CACHE_DTYPE": "native",
                         "CHATTERBOX_CFM_PROMPT_CACHE": "0",
                         "CHATTERBOX_CFM_STREAM": "0",
                         "CHATTERBOX_PALLAS": "0"}),
    ("progressive", {"CHATTERBOX_PROGRESSIVE_SLICES": "1"}),
    # meaningful with CHATTERBOX_MAX_NEW_TOKENS=1000: a 1000-token chunk is
    # ~2000 mel frames, past every ring size but 2048
    ("stream_window_2048", {"CHATTERBOX_STREAM_WINDOW": "2048"}),
]

# The tiny config's check that each knob reaches the output through the
# same plumbing (production values never bind on it).
TINY_VARIANTS = [
    ("default", {}),
    ("cfm_steps_4", {"CHATTERBOX_CFM_STEPS": "4"}),
    ("overlap_window_16", {"CHATTERBOX_OVERLAP_WINDOW_TOKENS": "16"}),
    ("flow_prompt_4", {"CHATTERBOX_FLOW_PROMPT_TOKENS": "4"}),
    ("kv_int8", {"KV_CACHE_DTYPE": "int8"}),
    ("prompt_cache_step", {"CHATTERBOX_CFM_PROMPT_CACHE": "step"}),
]


def request_args(slice_tokens: int) -> dict:
    """``engine.stream``'s arguments besides text, voice, request id and
    token: the JAX study's."""
    return dict(output_format="wav", cfg_guidance_weight=0.5, synthesis_temperature=0.8,
                text_processing_chunk_size=150, audio_tokens_per_slice=slice_tokens,
                remove_trailing_milliseconds=0, remove_leading_milliseconds=0,
                chunk_overlap_strategy="full", crossfade_duration_milliseconds=30)


def _launches() -> dict:
    return {"decode_attention": dict(decode_attention.launches),
            "flash_mha": dict(flash_mha.launches)}


def _reset_launches() -> None:
    decode_attention.reset_launches()
    flash_mha.reset_launches()


async def synthesize(text: str, request_id: str = REQUEST_ID, voice_id=None,
                     slice_tokens: int = 35) -> tuple:
    """One request through a fresh ``TTSEngine()`` (its config from the
    environment; the CPU when CHATTERBOX_FORCE_CPU=1, else the CUDA device)
    → (WAV bytes, its record): the request's ``request_stats``, the rate
    and samples per token ``check_wav`` needs, the device, ainit's wall, and
    the kernels' launches during ainit and during the request. The caller
    applies the knobs' swap around it."""
    device = "cpu" if os.environ.get("CHATTERBOX_FORCE_CPU") == "1" else None
    engine = TTSEngine(device=device)
    _reset_launches()
    t0 = time.perf_counter()
    await engine.ainit()
    record = {"device": common.device_name(engine.device),
              "ainit_s": round(time.perf_counter() - t0, 3),
              "load_s": engine.load_report.get("seconds"), "launches_ainit": _launches()}
    _reset_launches()
    data = b""
    async for chunk in engine.stream(text=text, voice_id=voice_id, request_id=request_id,
                                     cancellation_token=CancellationToken(),
                                     **request_args(slice_tokens)):
        data += chunk
    record.update(launches=_launches(), request_stats=engine.request_stats[request_id],
                  sample_rate=engine.sr, samples_per_token=engine.cfg.gen.samples_per_token,
                  max_new_tokens=engine.cfg.max_new_tokens)
    engine.shutdown()
    return data, record


def run_child(out_wav: Path) -> dict:
    """A variant's child, in the environment its knobs were set in: the
    study's request (STUDY_TEXT, STUDY_SLICE) into ``out_wav``, its record
    into the sidecar beside it (``<name>.json``) → the record."""
    plain = common.kernel_swap(os.environ)
    with common.plain_attention(plain):
        data, record = asyncio.run(synthesize(os.environ.get("STUDY_TEXT", TEXT),
                                              slice_tokens=int(os.environ.get("STUDY_SLICE", "35"))))
    record["plain"] = list(plain)
    out_wav.write_bytes(data)
    out_wav.with_suffix(".json").write_text(json.dumps(record, indent=1))
    return record


def variant_env(env_extra: dict, text: str, tiny: bool) -> dict:
    """The environment of a variant's child: this one's, the variant's
    knobs, the study's text, the ref arch, the decode cap, this checkout on
    the module path; with ``tiny`` the tiny config on the CPU."""
    env = dict(os.environ)
    env.update(env_extra)
    env.update(STUDY_TEXT=text, CHATTERBOX_S3GEN_ARCH="ref",
               PYTHONPATH=os.pathsep.join(filter(None, (str(common.REPO),
                                                        env.get("PYTHONPATH")))))
    env.setdefault("CHATTERBOX_MAX_NEW_TOKENS", DEFAULT_NEW_TOKENS)
    if tiny:
        env.update(CHATTERBOX_TINY_MODEL="1", CHATTERBOX_FORCE_CPU="1")
    return env


def score(wav_dir: Path, text_chars: int, tiny: bool, names=None) -> dict:
    """MCD / LSD / seconds of each variant's WAV in ``wav_dir`` (``names``,
    else every ``*.wav``) against ``default.wav`` → the report, rounded as
    the JAX study rounds it."""
    ref, sr = read_wav(str(wav_dir / "default.wav"))
    report = {"text_chars": text_chars, "tiny": tiny,
              "default_audio_s": round(len(ref) / sr, 2), "variants": {}}
    if names is None:
        names = sorted(p.stem for p in wav_dir.glob("*.wav"))
    for name in names:
        if name == "default":
            continue
        hyp, _ = read_wav(str(wav_dir / f"{name}.wav"))
        report["variants"][name] = {
            "mcd_db": round(mel_cepstral_distortion(ref, hyp, sr), 3),
            "lsd_db": round(log_spectral_distance(ref, hyp, sr), 3),
            "audio_s": round(len(hyp) / sr, 2),
        }
    return report


def merge_into(out: Path, report: dict) -> dict:
    """Write ``report`` to ``out``, merged with the variants already there
    when the comparison baseline (text length, tiny, default's seconds) is
    the same → what was written."""
    if out.exists():
        try:
            prev = json.loads(out.read_text())
            if (prev.get("text_chars") == report["text_chars"]
                    and prev.get("tiny") == report["tiny"]
                    and prev.get("default_audio_s") == report["default_audio_s"]):
                report = {**report, "variants": {**prev["variants"], **report["variants"]}}
        except (OSError, ValueError, KeyError):
            pass
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=1))
    return report


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--text", default=TEXT)
    ap.add_argument("--out", default=None, help="write the JSON report here too")
    ap.add_argument("--only", default=None,
                    help="comma-separated variant names to run (default is "
                         "always included as the comparison baseline)")
    args = ap.parse_args(argv)
    out = common.check_out_path(args.out) if args.out else None

    tmp = Path(tempfile.mkdtemp(prefix="quality_study_"))
    sys.stderr.write(f"study directory {tmp}\n")
    variants = TINY_VARIANTS if args.tiny else VARIANTS
    if args.only:
        keep = {v.strip() for v in args.only.split(",")} | {"default"}
        variants = [v for v in variants if v[0] in keep]
    done = []
    for name, env_extra in variants:
        sys.stderr.write(f"synthesizing variant {name}...\n")
        proc = subprocess.run(
            [sys.executable, "-m", "chatterbox_tpu_torch.scripts.run_variant", str(tmp), name],
            env=variant_env(env_extra, args.text, args.tiny), capture_output=True, text=True)
        if proc.returncode != 0:
            sys.stderr.write(f"{name} FAILED:\n{proc.stderr[-2000:]}\n")
            continue
        done.append(name)

    if "default" not in done:
        sys.stderr.write("default variant failed; no report\n")
        sys.exit(1)
    report = score(tmp, len(args.text), args.tiny, done)
    print(json.dumps(report, indent=1))
    if out is not None:
        merge_into(out, report)


if __name__ == "__main__":
    main()
