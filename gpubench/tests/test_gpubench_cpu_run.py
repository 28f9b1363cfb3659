"""The whole run on the CPU at the port's tiny size, the look for a card
skipped: a sound run is correct; the control (the reference in float8 put in
the program's place) and each fault planted in the timed path make it
incorrect."""
import asyncio
import json
from pathlib import Path

import numpy as np
import pytest

from gpubench import manifest, run

ROOT = Path(__file__).resolve().parents[2]
SEED = 2**31 + 4321


def tiny_cell(clients=4, config_file="tiny_ref.json"):
    config = json.loads((ROOT / "gpubench/tests" / config_file).read_text())
    config["check"]["requests"] = clients
    return {"workload": {"name": "tiny", "chips": 1}, "config": config,
            "traffic": {"loop": "closed", "clients": clients, "start_stagger_s": 0.0, "warmup_s": 1.0,
                        "text_chars": {"median": 200, "sigma": 0.4, "min": 100, "max": 400},
                        "pool": 16, "greedy_every": 2, "max_new_tokens": 24, "overlap": "full"},
            "end_to_end": [{"name": "audio_s_per_s", "unit": "s/s"},
                           {"name": "ttfa_p50_ms", "unit": "ms"}, {"name": "setup_s", "unit": "s"}],
            "per_layer": [], "root": manifest.ROOT}


def go(config_file="tiny_ref.json", **kw):
    return asyncio.run(run.run_cell(tiny_cell(config_file=config_file), SEED, 8.0, False, "cpu",
                                    **kw))


@pytest.mark.parametrize("config_file", ["tiny_ref.json", "tiny_dit.json"])
def test_sound_run_is_correct_and_the_control_is_not(config_file):
    result, checks, notes = go(config_file, control=True)
    assert result["correct"], (checks, notes)
    assert result["attempted"] > 0 and result["failed"] == 0
    assert set(result["metrics"]) == {"audio_s_per_s", "ttfa_p50_ms", "setup_s"}
    assert any(s["greedy"] for s in notes["sample"])
    limits = json.loads((ROOT / "gpubench/tests" / config_file).read_text())["limits"]
    assert any(v > limits[k] for k, v in notes["control"].items() if k in limits), notes["control"]


def _token_altered(monkeypatch):
    from chatterbox_tpu_torch.runtime.scheduler import BatchedT3Decoder

    orig = BatchedT3Decoder.run_slice

    def run_slice(self, n_steps, s_view):
        tokens, done = orig(self, n_steps, s_view)
        tokens = np.array(tokens)
        tokens[:, -1] = (tokens[:, -1] + 1) % self.cfg.num_speech_codes
        return tokens, done
    monkeypatch.setattr(BatchedT3Decoder, "run_slice", run_slice)


def _s3gen(monkeypatch, change):
    from chatterbox_tpu_torch.runtime.s3gen_scheduler import S3GenScheduler

    orig = S3GenScheduler._run_batch
    seen = []

    def run_batch(self, jobs):
        tails, starts, states, rstates = orig(self, jobs)
        seen.append(len(jobs))
        return change(jobs, tails, starts, states, rstates)
    monkeypatch.setattr(S3GenScheduler, "_run_batch", run_batch)
    return seen


def _answer_altered(monkeypatch):
    _s3gen(monkeypatch, lambda jobs, t, s, st, rs: (t * 0.5, s, st, rs))


def _state_unchanged(monkeypatch):
    _s3gen(monkeypatch, lambda jobs, t, s, st, rs: (
        t, s, st, None if rs is None else [j.rstate for j in jobs]))


def _half_batch(monkeypatch):
    """Every other job of a batch left out: it returns its neighbour's audio."""
    def half(jobs, t, s, st, rs):
        t = np.array(t)
        n = len(jobs) // 2
        t[1:2 * n:2] = t[0:2 * n:2]
        return t, s, st, rs
    return _s3gen(monkeypatch, half)


@pytest.mark.parametrize("fault", [_token_altered, _answer_altered, _state_unchanged, _half_batch])
def test_fault_makes_the_run_incorrect(fault, monkeypatch):
    seen = fault(monkeypatch)
    result, checks, notes = go()
    assert not result["correct"], (checks, notes)
    if seen is not None:
        assert max(seen) >= 2   # the batch held more than one job
