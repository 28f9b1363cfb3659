"""The yardstick's arithmetic on fixed inputs, the traffic's determinism and
the manifest's names."""
import json
import math
import re
import shutil
import sys
import types
from pathlib import Path

import pytest
import torch

from gpubench import manifest, roofline, run, stats, traffic
from gpubench.reference import chatterbox_ref

ROOT = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def mixes():
    return {p.stem: json.loads(p.read_text()) for p in (ROOT / "gpubench" / "traffic").glob("*.json")}


@pytest.mark.parametrize("name", sorted(mixes()))
def test_traffic_same_for_same_seed(name):
    mix = mixes()[name]
    kw = dict(count=40) if mix["loop"] == "closed" else dict(warmup_s=10, seconds=30)
    a = traffic.requests(mix, 2**31 + 11, **kw)
    b = traffic.requests(mix, 2**31 + 11, **kw)
    c = traffic.requests(mix, 5, **kw)
    assert a == b
    assert [r.text for r in a] != [r.text for r in c]
    assert all(mix["text_chars"]["min"] - 5 <= len(r.text) <= mix["text_chars"]["max"] for r in a)
    assert sum(r.greedy for r in a) == math.ceil(len(a) / mix["greedy_every"])


def test_traffic_same_work_every_seed():
    mix = mixes()["open-short"]
    due = [[r.due_s for r in traffic.requests(mix, s, warmup_s=10, seconds=30)] for s in (1, 2)]
    assert len(due[0]) == len(due[1]) == round(10 * mix["rate_per_s"]) + round(30 * mix["rate_per_s"])
    assert sum(10 <= t < 40 for t in due[0]) == sum(10 <= t < 40 for t in due[1])
    assert sorted(traffic._lengths(mix)) == sorted(traffic._lengths(mix))
    assert all(0 <= t < 40 for t in due[0]) and due[0] == sorted(due[0])


def test_percentile_counts():
    assert stats.percentile(list(range(1, 101)), 0.95) == (95, 100, 5)
    assert stats.percentile([3.0, 1.0, 2.0], 0.5) == (2.0, 3, 1)
    assert stats.median([4, 1, 3, 2]) == 2.5
    assert stats.percentile([1.0, math.inf], 0.95)[0] == math.inf


def test_window_rate_and_union():
    arrivals = [(0.5, 100), (1.0, 48000), (2.5, 48000), (3.0, 7)]
    assert stats.bytes_in_window(arrivals, 1.0, 3.0) == 96000
    assert stats.interval_union([(0, 10), (5, 20), (30, 40), (40, 41)]) == 31
    assert stats.interval_union([]) == 0
    assert stats.audio_rate(arrivals, 1.0, 3.0, 24000) == 1.0


def test_audio_rate_reader_counts_every_stream_in_the_window():
    read = manifest.metric_reader("audio_s_per_s.closed")
    ctx = {"arrivals": [(0.5, 100), (1.0, 48000), (2.5, 48000), (3.0, 7)],
           "t_open": 1.0, "t_close": 3.0, "sr": 24000}
    assert read(ctx) == 1.0
    assert read(dict(ctx, arrivals=[])) is None


def test_bounds():
    # 32 lanes, 16 heads of 64, int8 cache, 1000 rows in all
    ms, by = roofline.decode_bound((32, 16, 64), 2, torch.bfloat16, torch.int8, 1000, 16, True)
    moved = 2 * 1000 * 16 * 64 * 1 + 2 * 1000 * 16 * 4 + (2 * 32 * 16 * 64 + 2 * 32 * 16 * 64) * 2 + 8 * 32
    assert by == "bytes" and ms == pytest.approx(moved / 3.35e12 * 1e3)
    valid = torch.zeros((4, 10 + 6 + 3), dtype=torch.bool)
    valid[:, :8] = True      # prompt: 8 valid keys on every lane
    valid[:2, 10:12] = True  # ring: 2 on the first two lanes
    valid[:, 16:] = True     # own: 3
    ms, by = roofline.ctx_bound((4, 2, 3, 64), 4, torch.float32, 2, 10, 6, 2, valid)
    kv = 2 * 2 * 64
    moved = 2 * 4 * 2 * 3 * 64 * 4 + kv * 12 * 4 + kv * (2 * 8 + 4) * 2 + valid.numel()
    ops = 4.0 * 64 * 2 * 3 * int(valid.sum())
    assert ms == pytest.approx(max(moved / 3.35e12, ops / 495e12) * 1e3)


def test_flops():
    sz = chatterbox_ref.sizes(json.loads((ROOT / "gpubench/tests/tiny_ref.json").read_text()), 20)

    class Shapes:
        device = torch.device("cpu")

        def dense(self, shape, scale=None):
            return torch.empty(shape, device="meta")
        zeros = ones = dense

    raw = chatterbox_ref.param_trees(sz, Shapes())
    rates = roofline.flop_rates(raw)
    t3 = sz.t3
    D, F, L, V = t3.hidden_size, t3.intermediate_size, t3.num_layers, t3.speech_vocab_size
    assert rates["t3_token"] == 2.0 * (L * (4 * D * D + 3 * D * F) + D * V)
    assert chatterbox_ref.job_positions(sz, 5, 3) == (sz.s3.max_prompt_tokens + 5, 6)
    total = roofline.window_flops(rates, 10, 4, [(7, 6)], 3)
    assert total == (rates["t3_token"] * 14 + rates["enc_token"] * 7 + rates["est_frame"] * 2 * 3 * 6)


def test_manifest_names_units_and_files():
    man = manifest.load(ROOT)
    assert set(man) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in man[group]]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names), names
    for m in man["end_to_end"] + man["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for c in man["configs"]:
        assert all(NAME.match(k) for k in c["reduced"])
        assert (ROOT / c["file"]).is_file()
    for w in man["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        cell = manifest.cell(w["name"], ROOT, man)
        assert cell["end_to_end"] and cell["per_layer"]
        assert any(m["name"] == "setup_s" for m in cell["end_to_end"])
        for m in cell["per_layer"]:
            assert callable(manifest.metric_reader(m["name"]))
            assert m["moves"] in {e["name"] for e in cell["end_to_end"]}


def test_files_found_by_name(tmp_path):
    """A configuration, a mix and a metric added as files, with a workloads
    entry, are found with no existing file edited."""
    shutil.copytree(ROOT / "gpubench", tmp_path / "gpubench")
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    g = tmp_path / "gpubench"
    (g / "configs" / "ref2.json").write_text((g / "configs" / "ref.json").read_text())
    mix = json.loads((g / "traffic" / "closed16.json").read_text())
    (g / "traffic" / "closed8.json").write_text(json.dumps(dict(mix, clients=8)))
    (g / "metrics" / "answers.closed8.py").write_text("def read(ctx):\n    return 42.0\n")
    man = json.loads((tmp_path / "BENCHMARK.json").read_text())
    man["configs"].append(dict(man["configs"][0], name="ref2", file="gpubench/configs/ref2.json"))
    man["workloads"].append({"name": "ref2-closed8", "config": "ref2", "traffic": "closed8", "chips": 1,
                             "why": "test"})
    man["per_layer"].append({"name": "answers.closed8", "unit": "1", "better": "higher",
                             "source": "program_counter", "layer": "engine", "moves": "setup_s",
                             "workloads": ["ref2-closed8"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))
    cell = manifest.cell("ref2-closed8", tmp_path)
    assert cell["traffic"]["clients"] == 8 and cell["config"]["name"] == "ref"
    assert [m["name"] for m in cell["per_layer"]] == ["answers.closed8"]
    assert manifest.metric_reader("answers.closed8", g)({}) == 42.0


def test_forbidden_modules(monkeypatch):
    assert "chatterbox_tpu" not in run.forbidden_modules() or "chatterbox_tpu" in sys.modules
    monkeypatch.setitem(sys.modules, "chatterbox_tpu_torch_probe", types.ModuleType("x"))
    assert "chatterbox_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "chatterbox_tpu.probe", types.ModuleType("x"))
    assert "chatterbox_tpu" in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib", types.ModuleType("x"))
    assert {"chatterbox_tpu", "jaxlib"} <= set(run.forbidden_modules())


def test_reference_imports_nothing_of_the_program():
    for path in (ROOT / "gpubench").rglob("*.py"):
        if "tests" in path.parts or path.name == "run.py":
            continue
        src = path.read_text()
        for bad in ("chatterbox_tpu", "jax"):
            assert not re.search(rf"^\s*(import|from)\s+{bad}\b", src, re.M), (path, bad)


def test_chooser_keeps_only_the_sample():
    """The candidates are the first longest text, the first longest greedy
    one, and flagged ones sent after the window opened; a request that
    stops being one is dropped, and the sample is at most ``n``."""
    kept = set()
    ch = run.Chooser(3, 2**31 + 5, kept.add, kept.discard)
    reqs = traffic.requests(mixes()["closed16"], 2**31 + 5, count=48)
    recs = [run.Record(r, f"req{r.index}", {}, 0.0) for r in reqs]
    for rec in recs[:16]:
        ch.offer(rec)
    assert not ch.flagged
    ch.window_open = True
    for rec in recs[16:]:
        ch.offer(rec)
    longest = max(recs, key=lambda r: len(r.req.text))
    greedy = max((r for r in recs if r.req.greedy), key=lambda r: len(r.req.text))
    assert ch.longest is longest and ch.greedy is greedy
    assert all(r.req.index >= 16 and ch.flag(r.req.index) for r in ch.flagged)
    assert len(ch.flagged) == 3
    assert kept == {r.rid for r in ch.candidates()}
    sample = ch.sample()
    assert sample[0] is longest and len(sample) == 3
    assert run.chunk_seed_base("req0") == run.chunk_seed_base("req0") != run.chunk_seed_base("req1")


def test_closed_mix_same_lengths_every_seed():
    """Each block of ``pool`` requests of a closed mix holds the pool's
    lengths (to a word), whatever the seed."""
    mix = mixes()["closed16"]
    want = sorted(traffic._lengths(mix))
    n = mix["pool"]
    for seed in (3, 2**31 + 77):
        reqs = traffic.requests(mix, seed, count=3 * n)
        for b in range(3):
            got = sorted(len(r.text) for r in reqs[b * n:(b + 1) * n])
            assert all(w - 16 <= g <= w for g, w in zip(got, want)), (got, want)
