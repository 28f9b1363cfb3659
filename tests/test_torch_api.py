"""The port's HTTP server (``chatterbox_tpu_torch.serve``), probe for probe
as tests/test_api.py holds the JAX server: one module-wide app from the
factory with no engine passed in (CHATTERBOX_FORCE_CPU=1 and
CHATTERBOX_TINY_MODEL=1, so EngineConfig.tiny_ref() on the CPU), served by
the port's own HTTP layer (``serve/web.py``) on a real socket and driven by
aiohttp's client, an independent implementation. Beside that, the same bad
requests get the same answers from both servers (the JAX one over a stub
engine), the request parser coerces as the JAX package's pydantic model
does, and the settings are the JAX package's."""
import asyncio
import dataclasses
import os
from types import SimpleNamespace

import numpy as np
import pytest
from aiohttp import ClientSession, FormData
from aiohttp.test_utils import TestClient, TestServer

import torch_port_helpers  # noqa: F401  (caps torch's threads)

from chatterbox_tpu.config import AppConfig, TTSConfig, reset_config_cache
from chatterbox_tpu_torch.audio.pcm import write_wav

KEY = "test-key-123"
H = {"X-API-Key": KEY}
ENV = ("API_KEY", "VOICES_DIR", "PRELOADED_VOICES_DIR", "MODEL_PATH", "CHATTERBOX_FORCE_CPU",
       "CHATTERBOX_TINY_MODEL", "MAX_DECODE_SLOTS")


def _set_env(tmp) -> dict:
    saved = {k: os.environ.get(k) for k in ENV}
    os.environ.update(API_KEY=KEY, VOICES_DIR=str(tmp / "voices"),
                      PRELOADED_VOICES_DIR=str(tmp / "preloaded"), MODEL_PATH=str(tmp / "models"),
                      CHATTERBOX_FORCE_CPU="1", CHATTERBOX_TINY_MODEL="1")
    os.environ.pop("MAX_DECODE_SLOTS", None)
    reset_config_cache()
    return saved


def _restore_env(saved: dict) -> None:
    for k, v in saved.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    reset_config_cache()


class PortClient:
    """aiohttp's client against the port's server on 127.0.0.1: ``get``,
    ``post``, ``put``, ``delete`` take a path, as aiohttp's TestClient's do;
    ``server.app`` is the app."""

    def __init__(self, server, session: ClientSession):
        self.server, self._session = server, session

    @classmethod
    async def start(cls, app) -> "PortClient":
        from chatterbox_tpu_torch.serve import web

        server = web.AppServer(app)
        await server.start("127.0.0.1", 0)
        return cls(server, ClientSession(base_url=f"http://127.0.0.1:{server.port}"))

    def __getattr__(self, method: str):
        async def call(path: str, **kwargs):
            return await self._session.request(method.upper(), path, **kwargs)
        return call

    async def close(self) -> None:
        await self._session.close()
        await self.server.close()


@pytest.fixture(scope="module")
def api(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_api")
    saved = _set_env(tmp)
    from chatterbox_tpu_torch.serve.app import create_app

    loop = asyncio.new_event_loop()

    async def start():
        return await PortClient.start(create_app(warm_voices=False))

    client = loop.run_until_complete(start())
    sr = 24000
    t = np.arange(sr // 2) / sr
    wav_path = tmp / "probe.wav"
    write_wav(str(wav_path), (0.2 * np.sin(2 * np.pi * 200 * t)).astype(np.float32), sr)
    yield SimpleNamespace(client=client, run=loop.run_until_complete, wav_path=wav_path, tmp=tmp)
    loop.run_until_complete(client.close())
    loop.close()
    _restore_env(saved)


def _upload(api, name: str):
    form = FormData()
    form.add_field("file", open(api.wav_path, "rb"), filename=name)
    return api.run(api.client.post("/voices", data=form, headers=H))


def test_engine_is_the_tiny_model_on_the_cpu(api):
    engine = api.client.server.app["engine"]
    assert str(engine.device) == "cpu" and engine.cfg.t3.num_layers == 2
    assert engine.get_initialization_status()["state"] == "ready"


def test_health_requires_no_auth(api):
    r = api.run(api.client.get("/health"))
    assert r.status == 200
    assert api.run(r.json())["status"] == "ok"


def test_auth_rejects_missing_and_wrong_key(api):
    assert api.run(api.client.get("/voices")).status == 401
    assert api.run(api.client.get("/voices", headers={"X-API-Key": "wrong"})).status == 401


def test_auth_accepts_query_param(api):
    assert api.run(api.client.get(f"/voices?api_key={KEY}")).status == 200


def test_voice_upload_list_delete(api):
    r = _upload(api, "crud.wav")
    assert r.status == 201, api.run(r.text())
    assert api.run(r.json())["voice_id"] == "crud.wav"
    r = api.run(api.client.get("/voices", headers=H))
    assert "crud.wav" in api.run(r.json())
    assert api.run(api.client.delete("/voices/crud.wav", headers=H)).status == 200
    assert api.run(api.client.delete("/voices/crud.wav", headers=H)).status == 404


def test_voice_duplicate_upload_409(api):
    assert _upload(api, "dup.wav").status == 201
    assert _upload(api, "dup.wav").status == 409
    api.run(api.client.delete("/voices/dup.wav", headers=H))


def test_tts_missing_text_400(api):
    assert api.run(api.client.get("/tts/generate", headers=H)).status == 400


def test_tts_bad_format_400(api):
    assert api.run(api.client.get("/tts/generate?text=hi&format=ogg", headers=H)).status == 400


def test_tts_unknown_voice_404(api):
    assert api.run(api.client.get("/tts/generate?text=hi&voice_id=ghost.wav", headers=H)).status == 404


def test_tts_unauthenticated_401(api):
    assert api.run(api.client.get("/tts/generate?text=hi")).status == 401


def test_tts_get_streams_wav(api):
    async def go():
        r = await api.client.get(
            "/tts/generate?text=Hello+world&format=wav&audio_tokens_per_slice=8", headers=H)
        return r, await r.read()

    r, body = api.run(go())
    assert r.status == 200
    assert r.headers["Content-Type"].startswith("audio/wav")
    assert "X-Request-ID" in r.headers
    assert body[:4] == b"RIFF" and len(body) > 44


def test_tts_post_json_with_cloned_voice(api):
    assert _upload(api, "clone.wav").status == 201

    async def go():
        r = await api.client.post(
            "/tts/generate",
            json={"text": "Voice clone test.", "voice_id": "clone.wav", "format": "raw_pcm",
                  "audio_tokens_per_slice": 8},
            headers=H)
        return r, await r.read()

    r, body = api.run(go())
    assert r.status == 200 and len(body) > 0
    assert "clone.wav" in api.client.server.app["engine"].voice_cache
    api.run(api.client.delete("/voices/clone.wav", headers=H))
    assert "clone.wav" not in api.client.server.app["engine"].voice_cache


def test_concurrent_requests_share_decode_slice(api):
    """A default-config server batches: concurrent requests share the
    decoder's slices (CONCURRENT_REQUESTS_PER_WORKER=0 follows
    MAX_DECODE_SLOTS)."""
    engine = api.client.server.app["engine"]
    assert engine.decoder is not None and engine.tts_semaphore._value >= 2
    engine.decoder.max_active_seen = 0

    async def go():
        async def one(i):
            r = await api.client.get(
                f"/tts/generate?text=One+two+three+four+five.+Six+seven+{i}.&format=raw_pcm"
                "&audio_tokens_per_slice=8", headers=H)
            return r.status, len(await r.read())

        return await asyncio.gather(*[one(i) for i in range(3)])

    assert all(status == 200 and n > 0 for status, n in api.run(go()))
    assert engine.decoder.max_active_seen >= 2


def test_system_status(api):
    r = api.run(api.client.get("/system-status", headers=H))
    assert r.status == 200
    status = api.run(r.json())
    assert status["tpus"] == [] and status["gpus"] == []   # no CUDA here
    assert status["engine"]["state"] == "ready" and status["metrics"]["requests"]["total"] >= 1
    assert status["kernels"] == {"decode_attention": {"env": "CHATTERBOX_PALLAS", "on": True},
                                 "flash_mha": {"env": "CHATTERBOX_FLASH", "on": True}}
    assert status["tp"] == {"size": 1, "devices": None}


def test_root_serves_console(api):
    r = api.run(api.client.get("/"))
    assert r.status == 200 and "html" in r.headers["Content-Type"]
    assert api.run(api.client.get("/static/script.js")).status == 200


def test_profile_writes_a_chrome_trace(api):
    trace_dir = api.tmp / "trace"
    assert api.run(api.client.post("/profile/stop", headers=H)).status == 409
    r = api.run(api.client.post(f"/profile/start?dir={trace_dir}", headers=H))
    assert r.status == 200
    assert api.run(api.client.post("/profile/start", headers=H)).status == 409
    r = api.run(api.client.post("/profile/stop", headers=H))
    body = api.run(r.json())
    assert r.status == 200 and body["dir"] == str(trace_dir)
    assert os.path.getsize(body["trace"]) > 0


# ------------------------------------------------------ against the JAX app
class _StubEngine:
    """What the JAX app touches before it reaches synthesis."""

    sr = 24000
    voice_cache: dict = {}

    def get_initialization_status(self):
        return {"state": "ready", "progress": "Model ready", "error": None}

    def shutdown(self):
        pass


BAD_REQUESTS = [
    ("get", "/tts/generate", {}, None),
    ("get", "/tts/generate?text=hi", None, None),
    ("get", "/tts/generate?api_key=wrong&text=hi", None, None),
    ("get", "/tts/generate?text=hi&format=ogg", {}, None),
    ("get", "/tts/generate?text=&format=wav", {}, None),
    ("get", "/tts/generate?text=hi&cfg_guidance_weight=abc", {}, None),
    ("get", "/tts/generate?text=hi&audio_tokens_per_slice=3.5", {}, None),
    ("get", "/tts/generate?text=hi&voice_id=ghost.wav", {}, None),
    ("post", "/tts/generate", {}, b"not json"),
    ("post", "/tts/generate", {}, {"text": 5}),
    ("post", "/tts/generate", {}, {"text": "hi", "synthesis_temperature": "hot"}),
    ("post", "/tts/generate", {}, {"text": "hi", "format": "flac"}),
    ("post", "/tts/generate", {}, {"voice_id": "x.wav"}),
    ("delete", "/voices/ghost.wav", {}, None),
    ("get", "/voices", None, None),
    ("put", "/tts/generate", {}, None),
]


def test_bad_requests_get_the_jax_servers_answers(api, tmp_path):
    """Each bad request gets the JAX server's status and body: missing or
    wrong keys, missing text, bad formats and types, unknown voices."""
    from chatterbox_tpu.serve.app import create_app as jax_create_app

    async def ask(client, method, path, headers, body):
        kw = {"headers": H if headers is not None else {}}
        if isinstance(body, dict):
            kw["json"] = body
        elif body is not None:
            kw["data"] = body
        r = await getattr(client, method)(path, **kw)
        return r.status, await r.text()

    async def go():
        jclient = TestClient(TestServer(jax_create_app(_StubEngine(), warm_voices=False)))
        await jclient.start_server()
        try:
            out = []
            for req in BAD_REQUESTS:
                out.append((req, await ask(jclient, *req), await ask(api.client, *req)))
            return out
        finally:
            await jclient.close()

    for req, want, got in api.run(go()):
        assert got == want, req
        assert want[0] >= 400, req


def test_system_status_keys_match_jax(api):
    from chatterbox_tpu.serve.app import create_app as jax_create_app

    async def go():
        jclient = TestClient(TestServer(jax_create_app(_StubEngine(), warm_voices=False)))
        await jclient.start_server()
        try:
            want = await (await jclient.get("/system-status", headers=H)).json()
        finally:
            await jclient.close()
        got = await (await api.client.get("/system-status", headers=H)).json()
        return want, got

    want, got = api.run(go())
    # every key of the JAX server's, and the port's "kernels" and "tp"
    assert set(got) == set(want) | {"kernels", "tp"}
    for k in ("cpu", "engine", "metrics"):
        assert set(got[k]) == set(want[k]), k


# --------------------------------------------------------- request parser
PARAMS = [
    {}, {"text": "hi"}, {"text": 5}, {"text": None}, {"text": True}, {"text": ["a"]},
    {"voice_id": None}, {"voice_id": 3}, {"format": None}, {"format": "MP3"},
    {"cfg_guidance_weight": "0.25"}, {"cfg_guidance_weight": " 1.5 "}, {"cfg_guidance_weight": True},
    {"cfg_guidance_weight": "nan"}, {"cfg_guidance_weight": "inf"}, {"cfg_guidance_weight": "1e3"},
    {"cfg_guidance_weight": "1_000"}, {"cfg_guidance_weight": ".5"}, {"cfg_guidance_weight": "0x10"},
    {"cfg_guidance_weight": "true"}, {"cfg_guidance_weight": ""}, {"cfg_guidance_weight": None},
    {"cfg_guidance_weight": "１"}, {"synthesis_temperature": 2}, {"synthesis_temperature": [1]},
    {"audio_tokens_per_slice": "35"}, {"audio_tokens_per_slice": " +35 "},
    {"audio_tokens_per_slice": "35.0"}, {"audio_tokens_per_slice": "35."},
    {"audio_tokens_per_slice": "35.5"}, {"audio_tokens_per_slice": 35.0},
    {"audio_tokens_per_slice": 35.5}, {"audio_tokens_per_slice": True},
    {"audio_tokens_per_slice": "1e2"}, {"audio_tokens_per_slice": "1_000"},
    {"audio_tokens_per_slice": "1__0"}, {"audio_tokens_per_slice": "_1"},
    {"audio_tokens_per_slice": "00012"}, {"audio_tokens_per_slice": "-0.0"},
    {"audio_tokens_per_slice": "٣"}, {"audio_tokens_per_slice": float("inf")},
    {"audio_tokens_per_slice": 2.0 ** 64}, {"audio_tokens_per_slice": None},
    {"text_processing_chunk_size": "-7"}, {"chunk_overlap_strategy": "zero"},
    {"chunk_overlap_strategy": 1}, {"crossfade_duration_milliseconds": "\t7\n"},
    {"remove_leading_milliseconds": "", "text": "x"}, {"unknown_key": 1, "text": "x"},
]


@pytest.mark.parametrize("i", range(len(PARAMS)))
def test_request_parser_coerces_like_jax_model(i):
    """parse_tts_request accepts what the JAX package's pydantic request
    model accepts, with the same values, and refuses what it refuses."""
    from pydantic import ValidationError

    from chatterbox_tpu.serve.api import make_tts_request_model
    from chatterbox_tpu_torch.serve.api import parse_tts_request

    try:
        want = make_tts_request_model()(**PARAMS[i]).model_dump()
    except ValidationError:
        want = None
    try:
        got = vars(parse_tts_request(PARAMS[i]))
    except ValueError:
        got = None
    if want is None or got is None:
        assert got is want is None, (got, want)
    else:
        assert got.keys() == want.keys()
        for k in want:
            assert got[k] == want[k] or (got[k] != got[k] and want[k] != want[k]), k
            assert type(got[k]) is type(want[k]), k


# ----------------------------------------------------------------- settings
ENV_CASES = [
    {},
    {"HOST": "127.0.0.1", "port": "9000", "DEBUG": "yes", "API_KEY": "k", "LOG_LEVEL": "debug",
     "CORS_ORIGINS": '["https://a.example", "https://b.example"]', "WORKERS_PER_DEVICE": "2",
     "TTS_CFG_GUIDANCE_WEIGHT": "0.3", "tts_audio_tokens_per_slice": "50",
     "TTS_CHUNK_OVERLAP_STRATEGY": "zero"},
    {"CORS_ORIGINS": "https://a.example, https://b.example", "DEBUG": "0",
     "MAX_DECODE_SLOTS": "1", "TTS_SYNTHESIS_TEMPERATURE": "0.0"},
]


@pytest.mark.parametrize("i", range(len(ENV_CASES)))
def test_settings_match_jax_config(i, tmp_path, monkeypatch):
    """The port's settings equal the JAX package's config, field for field,
    with values from a .env file in the working directory and the process
    environment over it."""
    from chatterbox_tpu_torch import settings

    for k in list(os.environ):
        if k.upper() in {f.upper() for f in AppConfig.model_fields} | {
                "TTS_" + f.upper() for f in TTSConfig.model_fields}:
            monkeypatch.delenv(k)
    case = ENV_CASES[i]
    env_file = {k: v for j, (k, v) in enumerate(case.items()) if j % 2 == 0}
    (tmp_path / ".env").write_text(
        "# settings\n" + "".join(f"{k}='{v}'\n" for k, v in env_file.items()) + "PORT=1234\n")
    for k, v in case.items():
        if k not in env_file:
            monkeypatch.setenv(k, v)
    monkeypatch.chdir(tmp_path)
    for port_cls, port_get, jax_cls in ((settings.AppSettings, settings.get_settings, AppConfig),
                                        (settings.TTSSettings, settings.get_tts_config, TTSConfig)):
        want = jax_cls.from_env().model_dump()
        want.pop("ENV_PREFIX")
        assert dataclasses.asdict(port_get()) == want
        assert dataclasses.asdict(port_cls()) == {
            k: f.default for k, f in jax_cls.model_fields.items() if k != "ENV_PREFIX"}


def test_server_refuses_the_cpu_unless_asked(tmp_path, monkeypatch):
    """Without CUDA and without CHATTERBOX_FORCE_CPU=1 the factory's engine
    refuses to start."""
    import torch

    from chatterbox_tpu_torch.serve.app import create_app

    monkeypatch.setenv("API_KEY", KEY)
    monkeypatch.setenv("VOICES_DIR", str(tmp_path / "v"))
    monkeypatch.setenv("PRELOADED_VOICES_DIR", str(tmp_path / "p"))
    monkeypatch.delenv("CHATTERBOX_FORCE_CPU", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_app(warm_voices=False)
    monkeypatch.delenv("API_KEY")
    with pytest.raises(RuntimeError, match="API_KEY must be set"):
        create_app(warm_voices=False)
