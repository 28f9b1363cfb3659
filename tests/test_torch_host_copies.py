"""The port's copies of the JAX package's jax-free host modules, held to
their originals on the same inputs.

``chatterbox_tpu_torch`` keeps its own text frontend, fallback tokenizer,
PCM/WAV helpers, crossfade, container encoder, serving metrics, voice store
and multi-host dispatcher, so that
the port (and the GPU smoke run) imports nothing of ``chatterbox_tpu``. These tests keep the
two copies from drifting apart: text and bytes must be identical, and the
crossfade mix agrees to float32 rounding (the original may take its C++
audiokit path, which computes the same curves in a different order).
"""
import asyncio

import numpy as np
import pytest

from chatterbox_tpu.audio import crossfade as jxf
from chatterbox_tpu.audio import encoding as jenc
from chatterbox_tpu.audio import pcm as jpcm
from chatterbox_tpu.models import tokenizer as jtok
from chatterbox_tpu.runtime import metrics as jmetrics
from chatterbox_tpu.text import processing as jproc
from chatterbox_tpu.text import segmenter as jseg
from chatterbox_tpu_torch.audio import crossfade as txf
from chatterbox_tpu_torch.audio import encoding as tenc
from chatterbox_tpu_torch.audio import pcm as tpcm
from chatterbox_tpu_torch.models import tokenizer as ttok
from chatterbox_tpu_torch.runtime import metrics as tmetrics
from chatterbox_tpu_torch.text import processing as tproc
from chatterbox_tpu_torch.text import segmenter as tseg

CROSSFADE_TOL = 1e-6  # float32 mix of values in [-1, 1]

CORPUS = [
    "",
    "   ",
    "Hello world",
    "Hello from the port. This request runs on one graphics card.",
    "Dr. Smith met Mr. Jones at 3 p.m. on Jan. 5th, e.g. near the U.S. border! Did they talk?",
    "The quick brown fox jumps over the lazy dog, while the patient engineer watches the "
    "kernels compile. Streaming speech should start quickly and keep ahead of playback. "
    "A second text chunk begins somewhere around here.",
    "It costs $3.50... or maybe 4.75?! Nobody knows; “quotes” and — dashes — too.",
    "one two three four five six seven eight nine ten " * 30,
    "Line one\nLine two\n\nNew paragraph\twith a tab.   Extra   spaces here",
    "averyveryverylongwordwithoutanyspacesatallthatkeepsgoingandgoingandgoingpastthelimit" * 4,
]


@pytest.mark.parametrize("max_length", [None, 40, 150, 300])
@pytest.mark.parametrize("i", range(len(CORPUS)))
def test_text_chunking_matches(i, max_length):
    assert tproc.split_text_into_chunks(CORPUS[i], max_length) == \
        jproc.split_text_into_chunks(CORPUS[i], max_length)


@pytest.mark.parametrize("i", range(len(CORPUS)))
def test_sentence_segmentation_matches(i):
    assert tseg.segment_sentences(CORPUS[i]) == jseg.segment_sentences(CORPUS[i])


@pytest.mark.parametrize("i", range(len(CORPUS)))
def test_fallback_tokenizer_ids_match(i):
    want = jtok.TextTokenizer(None).text_to_tokens(CORPUS[i])
    got = ttok.TextTokenizer(None).text_to_tokens(CORPUS[i])
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_pcm16_bytes_and_wav_header_match(monkeypatch):
    """The copy is the original's numpy path byte for byte. The original
    takes its C++ audiokit when that is built, which rounds where numpy
    truncates; its own contract (tests/test_native.py) allows that one LSB."""
    from chatterbox_tpu import native

    rng = np.random.default_rng(0)
    audio = (rng.standard_normal(4099) * 0.7).astype(np.float32)  # some samples clip
    audio[:3] = [1.0, -1.0, 0.0]
    got = tpcm.float_to_pcm16(audio)
    lsb = np.abs(np.frombuffer(got, "<i2").astype(np.int32)
                 - np.frombuffer(jpcm.float_to_pcm16(audio), "<i2").astype(np.int32))
    assert lsb.max() <= 1
    monkeypatch.setattr(native, "float_to_pcm16", lambda audio: None)
    assert got == jpcm.float_to_pcm16(audio)
    for args in [(24000,), (24000, 1, 16, 1234), (16000, 2, 24), (44100, 1, 8, 0)]:
        assert tpcm.make_wav_header(*args) == jpcm.make_wav_header(*args)


@pytest.mark.parametrize("fade_len", [0, 1, 720])
def test_crossfade_stitcher_matches(fade_len):
    rng = np.random.default_rng(fade_len + 1)
    sizes = [5, 1500, 700, 0, 3000, 719, 721]
    chunks = [rng.uniform(-1, 1, n).astype(np.float32) for n in sizes]
    t, j = txf.CrossfadeStitcher(fade_len), jxf.CrossfadeStitcher(fade_len)
    for c in chunks:
        np.testing.assert_allclose(t.push(c.copy()), j.push(c.copy()), atol=CROSSFADE_TOL)
    np.testing.assert_allclose(t.flush(), j.flush(), atol=CROSSFADE_TOL)
    if fade_len:
        for got, want in zip(txf.equal_power_curves(fade_len), jxf.equal_power_curves(fade_len)):
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("ms", [0, 7, 250])
def test_trims_match(ms):
    audio = np.linspace(-1, 1, 9000, dtype=np.float32)
    np.testing.assert_array_equal(txf.trim_leading(audio, ms, 24000), jxf.trim_leading(audio, ms, 24000))
    np.testing.assert_array_equal(txf.trim_trailing(audio, ms, 24000), jxf.trim_trailing(audio, ms, 24000))


@pytest.mark.parametrize("fmt", ["wav", "raw_pcm", "fmp4", "mp3", "webm"])
def test_audio_encoder_matches(fmt):
    t = tenc.AudioEncoder(fmt, 24000, bitrate="96k")
    j = jenc.AudioEncoder(fmt, 24000, bitrate="96k")
    assert (t.get_mime_type(), t.get_file_extension()) == (j.get_mime_type(), j.get_file_extension())
    if fmt in ("wav", "raw_pcm"):
        chunks = [b"\x01\x02" * 10, b"", b"\x7f\x80" * 3]

        async def drain(enc):
            async def gen():
                for c in chunks:
                    yield c
            return [b async for b in enc.encode(gen())]

        assert asyncio.run(drain(t)) == asyncio.run(drain(j))
    else:
        assert t.ffmpeg_argv() == j.ffmpeg_argv()


def test_metrics_snapshots_match():
    """The same events into both registries give the same snapshot (uptime
    aside), percentiles past the window included."""
    t, j = tmetrics.Metrics(), jmetrics.Metrics()
    for m in (t, j):
        ev = np.random.default_rng(9)
        for i in range(700):  # more than the 512-sample percentile window
            m.record_request(None if i % 7 == 0 else float(ev.uniform(0.1, 3.0)),
                             float(ev.uniform(1.0, 9.0)), failed=i % 11 == 0, cancelled=i % 13 == 0)
            m.record_tokens(int(ev.integers(0, 40)))
            m.record_stage(("t3_decode_device", "t3_prefill_device", "s3gen_device")[i % 3],
                           float(ev.uniform(0.0, 0.5)), items=int(ev.integers(1, 17)))
    ts, js = t.snapshot(), j.snapshot()
    ts.pop("uptime_s")
    js.pop("uptime_s")
    assert ts == js


def _voice_store_trace(vm, user, pre):
    """One sequence of voice-store calls → what each returned or raised."""
    (pre / "shared.wav").write_bytes(b"preloaded")
    (pre / "only-pre.wav").write_bytes(b"preloaded")
    out = []

    def call(fn, *args):
        try:
            out.append(("ok", fn(*args)))
        except (FileExistsError, FileNotFoundError, ValueError) as exc:
            out.append((type(exc).__name__, None))

    call(vm.save_voice, "shared.wav", b"user")        # a preloaded name: duplicate
    call(vm.save_voice, "mine.wav", b"user")
    call(vm.save_voice, "mine.wav", b"again")         # duplicate
    call(vm.save_voice, "../escape.wav", b"x")        # a path: refused
    (user / "shared.wav").write_bytes(b"user")         # a user file shadows a preloaded one
    for vid in ("mine.wav", "shared.wav", "only-pre.wav", "nope.wav", "../mine.wav", "", "/x"):
        out.append(("path", vm.get_voice_path(vid)))
    out.append(("list", vm.list_voices()))
    call(vm.delete_voice, "only-pre.wav")             # preloaded voices cannot be deleted
    call(vm.delete_voice, "../voices/mine.wav")
    call(vm.delete_voice, "mine.wav")
    out.append(("list", vm.list_voices()))
    return [(k, v.replace(str(user), "U").replace(str(pre), "P") if isinstance(v, str) else v)
            for k, v in out]


def test_voice_manager_matches(tmp_path):
    """The port's voice store and the JAX package's give the same answers:
    user voices shadow preloaded ones, duplicates raise FileExistsError,
    paths are refused, only user voices can be deleted."""
    from chatterbox_tpu.serve.voice_manager import VoiceManager as JVM
    from chatterbox_tpu_torch.serve.voice_manager import VoiceManager as TVM

    traces = []
    for name, cls in (("t", TVM), ("j", JVM)):
        user, pre = tmp_path / name / "voices", tmp_path / name / "preloaded"
        traces.append(_voice_store_trace(cls(str(user), str(pre)), user, pre))
    assert traces[0] == traces[1]
    assert ("FileExistsError", None) in traces[0] and ("path", "U/shared.wav") in traces[0]


def test_dispatcher_matches():
    """The port's dispatcher is the JAX package's: the same routes, the same
    backend picks under load and failures, and the same answers proxied
    and broadcast from backends."""
    from aiohttp import ClientSession, web
    from aiohttp.test_utils import TestServer

    from chatterbox_tpu.serve import dispatcher as jdisp
    from chatterbox_tpu_torch.serve import dispatcher as tdisp
    from chatterbox_tpu_torch.serve import web as tweb

    # the port's route table against aiohttp's router under the JAX dispatcher
    backends = ["http://a:1", "http://b:2"]
    assert sorted((r.method, r.path) for r in tdisp.create_dispatcher_app(backends).router.routes()) \
        == sorted((r.method, r.resource.canonical)
                  for r in jdisp.create_dispatcher_app(backends).router.routes())

    def picks(mod):
        d = mod.Dispatcher(["http://a", "http://b", "http://c", "http://d"])
        out = []
        for i in range(24):
            b = d.pick()
            out.append(b.url)
            b.active += i % 3 == 0
            if i == 7:
                d.backends[1].healthy = False
            if i == 15:
                d.backends[3].active = 9
                d.backends[1].healthy = True
            if i % 5 == 4:
                d.backends[i % 4].active = max(0, d.backends[i % 4].active - 1)
        return out

    assert picks(tdisp) == picks(jdisp)

    async def backend(request: web.Request) -> web.StreamResponse:
        body = await request.read()
        return web.json_response({"path": str(request.rel_url), "method": request.method,
                                  "key": request.headers.get("X-API-Key"), "n": len(body)},
                                 status=201 if request.method == "POST" else 200)

    async def run():
        app = web.Application()
        app.router.add_route("*", "/{tail:.*}", backend)
        server = TestServer(app)
        await server.start_server()
        url = str(server.make_url("")).rstrip("/")
        answers = []
        for mod in (tdisp, jdisp):
            app = mod.create_dispatcher_app([url, url])
            if mod is tdisp:   # the port's dispatcher on its own HTTP layer
                dispatcher = tweb.AppServer(app)
                await dispatcher.start("127.0.0.1", 0)
                base = f"http://127.0.0.1:{dispatcher.port}"
            else:
                dispatcher = TestServer(app)
                await dispatcher.start_server()
                base = str(dispatcher.make_url("")).rstrip("/")
            client = ClientSession(base_url=base)
            got = []
            for method, path, data in (("get", "/tts/generate?text=hi", None),
                                       ("post", "/tts/generate", b'{"text": "hi"}'),
                                       ("post", "/voices", b"x" * 100),
                                       ("delete", "/voices/a.wav", None),
                                       ("get", "/voices", None)):
                r = await getattr(client, method)(path, data=data, headers={"X-API-Key": "k"})
                got.append((r.status, await r.json()))
            r = await client.get("/dispatcher-status")
            got.append((r.status, [b["healthy"] for b in (await r.json())["backends"]]))
            await client.close()
            await dispatcher.close()
            answers.append(got)
        await server.close()
        return answers

    tgot, jgot = asyncio.run(run())
    assert tgot == jgot and tgot[0][0] == 200
