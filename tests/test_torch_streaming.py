"""The port's streaming service (``ttasr_torch/streaming/``,
``ttasr_torch/api/streaming_ws.py``, ``ttasr_torch/text/filters.py``) on
the CPU, against the JAX package.

- ``filter_text``, ``filter_segments``, the language codes and the
  ``streaming/utils`` helpers on fixed inputs.
- The VAD plugins (simple, energy, pyannote) on ``chip_smoke.synth_speech``.
- The overload policy of ``SilenceAtEndOfChunk`` (merge the backlog, shed
  transients while behind, flush a merged backlog with no further message),
  ordered by ``asyncio`` events and the strategy's own tasks: orders and
  counts only, no durations.
- ``TorchWhisperASR.transcribe`` (the engine's seek loop) and its
  ``_transcribe_batched`` (one priority request through the shared
  ``BatchServer``) against ``JaxWhisperASR``'s on the same audio at
  temperature 0 (``TTASR_STREAM_TEMPERATURES=0``): equal result dicts.
- One WebSocket session end to end on each package's ``create_app``, the
  service's own background init finding the f32 ``micro64-test`` engines
  through the registries: the same frames give the same transcript
  messages, and on the port the task API and the stream share one engine
  and one ``BatchServer``.
"""

import asyncio
import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ttasr.api import app as j_app
from ttasr.api import config as j_config
from ttasr.api import file_tasks as j_ft
from ttasr.engine import registry as j_registry
from ttasr.engine import serving as j_serving
from ttasr.engine.transcriber import WhisperEngine as JEngine
from ttasr.models.whisper import model as jm
from ttasr.models.whisper.config import PRESETS as J_PRESETS
from ttasr.streaming import client as j_client
from ttasr.streaming import utils as j_utils
from ttasr.streaming.asr.jax_whisper_asr import JaxWhisperASR
from ttasr.streaming.vad.vad_factory import VADFactory as JVADFactory
from ttasr.text import filters as j_filters
from ttasr.text.tokenizer import build_byte_fallback_tokenizer
from ttasr_torch.api import app as t_app
from ttasr_torch.api import config as t_config
from ttasr_torch.api import file_tasks as t_ft
from ttasr_torch.engine import registry as t_registry
from ttasr_torch.engine import serving as t_serving
from ttasr_torch.engine.transcriber import WhisperEngine as TEngine
from ttasr_torch.models.whisper.config import PRESETS as T_PRESETS
from ttasr_torch.models.whisper.load import params_from_jax
from ttasr_torch.streaming import client as t_client
from ttasr_torch.streaming import utils as t_utils
from ttasr_torch.streaming.asr.asr_factory import ASRFactory
from ttasr_torch.streaming.asr.torch_whisper_asr import TorchWhisperASR
from ttasr_torch.streaming.vad.vad_factory import VADFactory as TVADFactory
from ttasr_torch.text import filters as t_filters

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOK = build_byte_fallback_tokenizer()
NAME = "micro64-test"
SR = 16000


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_for_streaming", os.path.join(REPO_ROOT, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


SYNTH = _chip_smoke().synth_speech


def _pcm16(audio) -> bytes:
    return (np.clip(audio, -1, 1) * 32767).astype("<i2").tobytes()


def _speech(seconds, seed):
    return SYNTH(np.random.default_rng(seed), seconds)[0]


# -- plain copies against their originals ------------------------------------

TEXTS = ["今天天氣很好", "字幕by 某人", "請不吝點贊 訂閱 轉發 打賞支持明鏡與點點欄目",
         "Amara.org 社群提供的字幕", "", "  ", "hello world", "喜歡請訂閱我們"]


def test_filters_match_jax():
    assert t_filters.IGNORE_TEXT == j_filters.IGNORE_TEXT
    assert t_filters.language_codes == j_filters.language_codes
    for text in TEXTS + t_filters.IGNORE_TEXT:
        assert t_filters.filter_text(text) == j_filters.filter_text(text), text
    assert t_filters.filter_text("字幕by") is None

    class Seg:
        def __init__(self, text):
            self.text = text

    segments = [{"text": t} for t in TEXTS] + [Seg(t) for t in TEXTS]
    got, want = t_filters.filter_segments(segments), j_filters.filter_segments(segments)
    assert [id(s) for s in got] == [id(s) for s in want] and 0 < len(got) < len(segments)


def test_streaming_utils_match_jax(tmp_path):
    for t in (0.0, 0.0004, 1.2345, 59.9996, 3599.9995, 3725.25):
        assert t_utils.srt_format_timestamp(t) == j_utils.srt_format_timestamp(t)
    subs = [{"startTime": 0.0, "endTime": 1.5, "text": "今天"},
            {"startTime": 1.5, "endTime": 61.25, "text": "天氣很好"}]
    assert t_utils.list_to_srt_text(subs) == j_utils.list_to_srt_text(subs)
    assert t_utils.list_to_plain_text(subs) == j_utils.list_to_plain_text(subs)
    items = [dict(s, final=False) for s in subs]
    assert t_utils.transfer_streaming_format(items) == j_utils.transfer_streaming_format(items)
    assert t_utils.transfer_streaming_format([]) is j_utils.transfer_streaming_format([])
    offline = {"segments": [{"start": 0.0, "end": 1.0, "text": "字幕by 某人"},
                            {"start": 1.0, "end": 2.0, "text": "你好"}]}
    assert t_utils.transfer_offline_format(offline) == j_utils.transfer_offline_format(offline)
    assert t_utils.ignore_text == j_utils.ignore_text
    for pkg, mod in (("jax", j_utils), ("torch", t_utils)):
        for i, raw in enumerate((json.dumps(subs, ensure_ascii=False), repr(subs))):
            path = tmp_path / pkg / f"t{i}.json"
            path.parent.mkdir(exist_ok=True)
            path.write_text(raw, encoding="utf-8")
            end, srt, txt = mod.convert_transcript_to_subtitles(str(path))
            assert end == 61.25
    for i in range(2):
        for ext in (".srt", ".txt"):
            assert ((tmp_path / "torch" / f"t{i}{ext}").read_bytes()
                    == (tmp_path / "jax" / f"t{i}{ext}").read_bytes())
    got = t_utils.create_today_folders(str(tmp_path / "torch"), "job")
    want = j_utils.create_today_folders(str(tmp_path / "jax"), "job")
    assert os.path.relpath(got, tmp_path / "torch") == os.path.relpath(want, tmp_path / "jax")
    assert os.path.isdir(got)


@pytest.mark.parametrize("kind", ["simple", "energy", "pyannote"])
def test_vad_plugins_match_jax(kind):
    audio = np.concatenate([_speech(4.0, 0), np.zeros(SR * 2, np.float32),
                            _speech(3.0, 1)])
    results = []
    for factory, client_mod in ((TVADFactory, t_client), (JVADFactory, j_client)):
        vad = factory.create_vad_pipeline(kind, min_duration=0.1)
        client = client_mod.Client("t", SR, 2, "job", 0.0)
        client.scratch_buffer.extend(_pcm16(audio))
        results.append(asyncio.run(vad.detect_activity(client)))
    got, want = results
    assert got == want
    assert len(want) >= (1 if kind == "simple" else 2), want


# -- the overload policy, ordered by events ----------------------------------


class GatedASR:
    """Each call records the scratch size it saw, hands the test a gate
    through ``entered`` and returns once the test opens it."""

    def __init__(self, gated=True):
        self.gated = gated
        self.calls = []
        self.active = self.max_active = 0
        self.entered = asyncio.Queue()

    async def transcribe(self, client):
        self.active += 1
        self.max_active = max(self.max_active, self.active)
        self.calls.append(len(client.scratch_buffer))
        if self.gated:
            gate = asyncio.Event()
            await self.entered.put(gate)
            await gate.wait()
        self.active -= 1
        return {"text": "字", "duration": len(client.scratch_buffer) / (2.0 * SR)}


class PassVAD:
    async def detect_activity(self, client):
        # one segment ending early: the gate passes once scratch exceeds 2 s
        return [{"start": 0.0, "end": 0.1}]


class LateVAD:
    async def detect_activity(self, client):
        return [{"start": 0.0, "end": 10.0}]  # the silence gate never passes


class QueueWS:
    def __init__(self):
        self.sent = []
        self.queue = asyncio.Queue()

    async def send_str(self, text):
        self.sent.append(text)
        await self.queue.put(text)

    async def next(self):
        return await asyncio.wait_for(self.queue.get(), 60)


async def _gate(asr):
    return await asyncio.wait_for(asr.entered.get(), 60)


async def _settle():
    """Wait for every task the strategy started (none of them gated)."""
    others = [t for t in asyncio.all_tasks() if t is not asyncio.current_task()]
    await asyncio.wait_for(asyncio.gather(*others), 60)


def _pcm_seconds(seconds):
    return np.zeros(int(SR * seconds), "<i2").tobytes()


def _client(transient=False):
    client = t_client.Client("t", SR, 2, "job", 0.0)
    client.connection_id = "conn"
    client.update_config({"processing_args": {
        "chunk_length_seconds": 1.0, "chunk_offset_seconds": 0.1,
        "enable_transient": transient}})
    return client


@pytest.fixture()
def no_buffering_env(monkeypatch):
    monkeypatch.delenv("BUFFERING_CHUNK_LENGTH_SECONDS", raising=False)
    monkeypatch.delenv("BUFFERING_CHUNK_OFFSET_SECONDS", raising=False)


def test_backlog_merges_instead_of_reentrant_decode(no_buffering_env):
    async def run():
        client = _client()
        strat = client.buffering_strategy
        asr, vad, ws = GatedASR(), PassVAD(), QueueWS()
        client.append_audio_data(_pcm_seconds(2.2))
        strat.process_audio(ws, vad, asr)
        first = await _gate(asr)
        # two chunks arrive while decode 1 runs: both merge, none re-enters
        for _ in range(2):
            client.append_audio_data(_pcm_seconds(1.2))
            strat.process_audio(ws, vad, asr)
        assert (strat.behind, strat.overload_merges, asr.active) == (True, 2, 1)
        first.set()
        await ws.next()  # decode 1 done; its end starts the merged decode
        second = await _gate(asr)
        assert asr.calls[1] >= int(2.4 * 2 * SR)  # the merged span, one decode
        client.append_audio_data(_pcm_seconds(0.05))
        strat.process_audio(ws, vad, asr)  # under a chunk: nothing to start
        second.set()
        await ws.next()
        await _settle()
        assert len(asr.calls) == 2 and asr.max_active == 1
        assert strat.behind is False and len(ws.sent) == 2
        assert all(json.loads(m)["result"][0]["final"] == 1 for m in ws.sent)

    asyncio.run(run())


def test_transients_shed_while_behind(no_buffering_env):
    async def run():
        asr = GatedASR(gated=False)
        sent = []
        for behind in (False, True):
            client = _client(transient=True)
            strat = client.buffering_strategy
            strat.behind = behind
            ws = QueueWS()
            client.append_audio_data(_pcm_seconds(1.2))
            strat.process_audio(ws, LateVAD(), asr)
            await _settle()
            sent.append([json.loads(m)["result"][0]["final"] for m in ws.sent])
            assert len(client.scratch_buffer) == int(1.2 * 2 * SR)  # kept for the final
        assert sent == [[0], []]  # a transient when healthy, shed while behind
        assert len(asr.calls) == 1

    asyncio.run(run())


def test_backlog_flushes_without_further_messages(no_buffering_env):
    async def run():
        client = _client()
        strat = client.buffering_strategy
        asr, vad, ws = GatedASR(), PassVAD(), QueueWS()
        client.append_audio_data(_pcm_seconds(2.2))
        strat.process_audio(ws, vad, asr)
        first = await _gate(asr)
        client.append_audio_data(_pcm_seconds(2.5))  # the client's last audio
        strat.process_audio(ws, vad, asr)
        assert strat.behind is True
        first.set()
        # no process_audio call from here on: the decode's end starts the next
        second = await _gate(asr)
        assert asr.calls[1] >= int(2.5 * 2 * SR)
        second.set()
        await ws.next()
        await ws.next()
        await _settle()
        assert len(asr.calls) == 2 and asr.max_active == 1 and len(ws.sent) == 2

    asyncio.run(run())


# -- the ASR plugin against the JAX plugin, one real engine each ---------------


@pytest.fixture(scope="module")
def engines_f32():
    jcfg = J_PRESETS[NAME]
    jp = jm.init_params(jcfg, seed=0, dtype=jnp.float32)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), dtype=torch.float32)
    je = JEngine(NAME, compute_type="float32", params=jp, config=jcfg, tokenizer=TOK)
    te = TEngine(NAME, compute_type="float32", params=tp, config=T_PRESETS[NAME],
                 tokenizer=TOK, device="cpu")
    return je, te


def _asr_client(client_mod, audio):
    client = client_mod.Client("t", SR, 2, "job", 1.5)
    client.scratch_buffer.extend(_pcm16(audio))
    return client


def test_asr_plugin_matches_jax(engines_f32, monkeypatch):
    je, te = engines_f32
    monkeypatch.setenv("TTASR_STREAM_TEMPERATURES", "0")
    jasr = JaxWhisperASR(model_size=NAME, compute_type="float32", engine=je)
    tasr = ASRFactory.create_asr_pipeline("torch_whisper", model_size=NAME,
                                          compute_type="float32", engine=te)
    assert isinstance(tasr, TorchWhisperASR) and tasr.device == "cpu"
    assert tasr.default_transcribe_kwargs == jasr.default_transcribe_kwargs
    for seconds in (1.5, 6.0, 16.0, 31.0):
        assert tasr._token_budget(seconds) == jasr._token_budget(seconds)
    audio = _speech(3.0, 5)

    async def run(asr, engine, serving, client_mod):
        plain = await asr.transcribe(_asr_client(client_mod, audio))
        asr.server = await serving.shared_server(engine, slots=4, beam_size=5)
        try:
            batched = await asr.transcribe(_asr_client(client_mod, audio))
        finally:
            await asr.server.stop()
            asr.server = None
        return plain, batched

    want = asyncio.run(run(jasr, je, j_serving, j_client))
    got = asyncio.run(run(tasr, te, t_serving, t_client))
    assert got == want
    for result in got:
        assert result is not None and result["final"] is True and result["text"]
        assert result["duration"] == 3.0


def _ws_env(monkeypatch, tmp_path, engines):
    je, te = engines
    monkeypatch.setenv("ASR_API_AUTH_DB", str(tmp_path / "auth.db"))
    monkeypatch.setenv("FASTAPI_SKIP_INIT", "0")
    monkeypatch.setenv("FASTAPI_WARMUP", "0")
    monkeypatch.setenv("FASTAPI_ASR_MODEL_SIZE", NAME)
    monkeypatch.setenv("TTASR_MODEL_PATH", NAME)
    monkeypatch.setenv("TTASR_MODEL_COMPUTE_TYPE", "float32")
    monkeypatch.setenv("TTASR_VAD_TYPE", "simple")
    for key in ("TTASR_STREAM_TEMPERATURES", "TTASR_STREAM_TOKEN_CAP",
                "TTASR_BATCH_SLOTS", "BUFFERING_CHUNK_LENGTH_SECONDS",
                "BUFFERING_CHUNK_OFFSET_SECONDS"):
        monkeypatch.delenv(key, raising=False)
    for config in (j_config, t_config):
        monkeypatch.setattr(config, "MODEL_COMPUTE_TYPE", "float32")
    monkeypatch.setattr(t_config, "MODEL_DEVICE", "cpu")
    monkeypatch.setitem(j_registry._ENGINES, (NAME, "float32", None), je)
    monkeypatch.setitem(t_registry._ENGINES, (NAME, "float32", None, "cpu"), te)
    for ft in (j_ft, t_ft):
        monkeypatch.setattr(ft, "whisper_engine", None)


SPANS = (_speech(3.0, 20), _speech(3.0, 21))
FRAME = SR // 4  # 0.25 s frames


def _stream_session(app_module, ft, serving):
    """One session: wait for 180, set a 2.9 s chunk, send two 3 s spans in
    0.25 s frames, each after the previous span's transcript arrived.
    Returns the transcript results and what the port shares."""
    async def run():
        from aiohttp.test_utils import TestClient, TestServer

        app = app_module.create_app()
        client = TestClient(TestServer(app))
        await client.start_server()
        try:
            ws = await client.ws_connect("/stream/ws/stt?token=tester")

            async def receive():
                return json.loads((await asyncio.wait_for(ws.receive(), 120)).data)

            assert (await receive())["code"] == 100
            ready = await receive()
            assert ready["code"] == 180 and ready["message"] == "服務已就緒", ready
            await ws.send_str(json.dumps({"type": "config", "data": {"processing_args": {
                "chunk_length_seconds": 2.9, "chunk_offset_seconds": 0.1}}}))
            assert (await receive())["code"] == 200
            results = []
            for span in SPANS:
                pcm = _pcm16(span)
                for i in range(0, len(pcm), 2 * FRAME):
                    await ws.send_bytes(pcm[i:i + 2 * FRAME])
                msg = await receive()
                assert msg["code"] == 200 and msg["message"] == "轉譯成功", msg
                results.append(msg["result"])
            await ws.close()
            service = app["streaming_service"]
            health = await (await client.get("/stream/health")).json()
            assert ft.load_model()
            shared = await serving.shared_server(ft.whisper_engine, slots=4)
            return results, dict(
                health=health, same_engine=ft.whisper_engine is service.asr_pipeline.engine,
                same_server=shared is service.batch_server is service.asr_pipeline.server)
        finally:
            await client.close()

    return asyncio.run(run())


def test_ws_session_matches_jax_app(engines_f32, tmp_path, monkeypatch):
    _ws_env(monkeypatch, tmp_path, engines_f32)
    want, _ = _stream_session(j_app, j_ft, j_serving)
    got, port = _stream_session(t_app, t_ft, t_serving)
    assert got == want
    assert [r[0]["startTime"] for r in got] == [0.0, 3.0]
    assert all(r[0]["transcript"] and r[0]["final"] == 1 for r in got)
    assert port["same_engine"] and port["same_server"]
    assert port["health"]["asr_pipeline"] == "ready"
    assert port["health"]["asr_device"] == "cpu"
