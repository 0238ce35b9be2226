"""The port's HTTP service (``ttasr_torch/api/``) on the CPU.

- The routes of ``tests/test_api.py`` on the port's ``create_app`` through
  the dummy-engine seam (``load_model`` swapped for a fake engine): health,
  login/logout and bad credentials, remember-me, the task lifecycle, user
  management, the WebSocket handshake, streamed uploads.
- Against the JAX package: the two ``create_app`` route tables, JWTs made
  by one package verified by the other (HS256/384/512), password hashes
  made by one verified by the other, ``resolve_type_param`` and the status
  codes.
- The device: without CUDA, ``load_model``, ``TorchWhisperASR`` and
  ``python -m ttasr_torch.api.app`` raise unless ``TTASR_MODEL_DEVICE=cpu``.
- One real engine: the same two WAVs uploaded at once to the JAX app and to
  the port's app, f32 ``micro64-test`` on both sides with the weights moved
  by ``params_from_jax``, the task worker's kwargs at temperature 0: TXT and
  SRT byte for byte, and the port's uploads packed into one shared
  ``BatchServer`` sweep.  Both engines are found through the packages' own
  ``registry.get_engine`` from ``TTASR_MODEL_PATH``.
"""

import asyncio
import io
import os
import subprocess
import sys
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tools.train_vad import synth_speech
from ttasr.api import app as j_app
from ttasr.api import file_tasks as j_ft
from ttasr.api import jwt as j_jwt
from ttasr.api import passwords as j_pw
from ttasr.engine import registry as j_registry
from ttasr.engine.transcriber import WhisperEngine as JEngine
from ttasr.models.whisper import model as jm
from ttasr.models.whisper.config import PRESETS as J_PRESETS
from ttasr.text.tokenizer import build_byte_fallback_tokenizer
from ttasr_torch.api import app as t_app
from ttasr_torch.api import config as t_config
from ttasr_torch.api import file_tasks as t_ft
from ttasr_torch.api import jwt as t_jwt
from ttasr_torch.api import passwords as t_pw
from ttasr_torch.engine import registry as t_registry
from ttasr_torch.engine import serving as t_serving
from ttasr_torch.engine.results import Segment, TranscriptionInfo
from ttasr_torch.engine.transcriber import WhisperEngine as TEngine
from ttasr_torch.models.whisper.config import PRESETS as T_PRESETS
from ttasr_torch.models.whisper.load import params_from_jax
from ttasr_torch.streaming.asr.torch_whisper_asr import TorchWhisperASR

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOK = build_byte_fallback_tokenizer()
NAME = "micro64-test"
ADMIN = {"username": "admin", "password": "admin@0935"}


def _auth_env(monkeypatch, tmp_path):
    monkeypatch.setenv("ASR_API_AUTH_DB", str(tmp_path / "auth_test.db"))
    monkeypatch.setenv("ASR_API_JWT_SECRET", "TEST_SECRET")
    monkeypatch.setenv("ASR_API_JWT_ALGORITHM", "HS256")
    monkeypatch.setenv("ASR_API_BOOTSTRAP_ADMIN_USERNAME", ADMIN["username"])
    monkeypatch.setenv("ASR_API_BOOTSTRAP_ADMIN_PASSWORD", ADMIN["password"])
    monkeypatch.setenv("ASR_API_BOOTSTRAP_ADMIN_NICKNAME", "ADMIN")
    monkeypatch.setenv("ASR_API_RESET_ADMIN_ON_STARTUP", "1")
    monkeypatch.setenv("FASTAPI_SKIP_INIT", "1")


@pytest.fixture()
def api_env(tmp_path, monkeypatch):
    _auth_env(monkeypatch, tmp_path)
    monkeypatch.setattr(t_ft, "BASE_DIR", tmp_path)
    monkeypatch.setattr(t_ft, "whisper_engine", None)

    class FakeEngine:
        def transcribe(self, audio, **kwargs):
            segs = [
                Segment(id=0, seek=0, start=0.0, end=1.2345, text="這是單元測試",
                        tokens=[1], avg_logprob=-0.1, compression_ratio=1.0,
                        no_speech_prob=0.0),
            ]
            return segs, TranscriptionInfo("zh", 1.0, 1.0, 1.0)

    def _fake_load_model():
        t_ft.whisper_engine = FakeEngine()
        return True

    monkeypatch.setattr(t_ft, "load_model", _fake_load_model)
    return tmp_path


def _wav_bytes(pcm, sr=16000):
    buf = io.BytesIO()
    with wave.open(buf, "wb") as wf:
        wf.setnchannels(1)
        wf.setsampwidth(2)
        wf.setframerate(sr)
        wf.writeframes(np.asarray(pcm, "<i2").tobytes())
    return buf.getvalue()


def _sine_wav(duration=0.2, sr=16000):
    t = np.arange(int(sr * duration)) / sr
    return _wav_bytes((0.1 * np.sin(2 * np.pi * 440 * t) * 32767).astype("<i2"), sr)


def _run(coro):
    return asyncio.run(coro)


async def _client(app_module=t_app):
    from aiohttp.test_utils import TestClient, TestServer

    client = TestClient(TestServer(app_module.create_app()))
    await client.start_server()
    return client


async def _login(client, remember=1):
    resp = await client.post("/api/v1/login", json=dict(ADMIN, rememberMe=remember))
    assert resp.status == 200, await resp.text()
    data = await resp.json()
    assert data["code"] == 200
    return data["token"]


async def _wait_done(client, task_id, headers, polls=50, every=0.05):
    for _ in range(polls):
        r = await client.post(f"/api/v1/subtitle/tasks/{task_id}", headers=headers)
        data = (await r.json())["data"][0]
        if data["status"] == 22:
            assert data["progress"] == 100
            return
        assert data["status"] != 4, "task failed"
        await asyncio.sleep(every)
    pytest.fail(f"task {task_id} never completed")


# -- the routes, through the dummy-engine seam ------------------------------


def test_health_endpoints(api_env):
    async def run():
        client = await _client()
        try:
            r = await client.get("/api/health")
            assert r.status == 200
            data = await r.json()
            assert data["status"] == "healthy" and "timestamp" in data
            r = await client.get("/api/v1/health")
            assert (await r.json())["status"] == "ok"
            r = await client.get("/stream/health")
            assert (await r.json())["status"] == "healthy"
        finally:
            await client.close()
    _run(run())


def test_login_logout_and_bad_credentials(api_env):
    async def run():
        client = await _client()
        try:
            token = await _login(client)
            r = await client.post("/api/v1/logout",
                                  headers={"Authorization": f"Bearer {token}"})
            data = await r.json()
            assert r.status == 200 and data["username"] == "admin"
            r = await client.post("/api/v1/login",
                                  json={"username": "admin", "password": "wrong"})
            assert r.status == 401
            r = await client.post("/api/v1/logout")
            assert r.status == 401
        finally:
            await client.close()
    _run(run())


def test_remember_me_expiration(api_env):
    async def run():
        client = await _client()
        try:
            for remember, ttl in ((0, 86400), (1, 34560000)):
                r = await client.post("/api/v1/login",
                                      json=dict(ADMIN, rememberMe=remember))
                assert (await r.json())["expiration"] == ttl
        finally:
            await client.close()
    _run(run())


def test_task_lifecycle(api_env):
    async def run():
        import aiohttp

        client = await _client()
        try:
            token = await _login(client)
            headers = {"Authorization": f"Bearer {token}"}

            form = aiohttp.FormData()
            form.add_field("audio", _sine_wav(), filename="t.wav", content_type="audio/wav")
            r = await client.post("/api/v1/subtitle/tasks", data=form)
            assert r.status == 401

            form = aiohttp.FormData()
            form.add_field("audio", b"x", filename="t.exe")
            r = await client.post("/api/v1/subtitle/tasks", data=form, headers=headers)
            assert r.status == 400

            form = aiohttp.FormData()
            form.add_field("audio", _sine_wav(), filename="t.wav", content_type="audio/wav")
            form.add_field("reference_text", "這是單元測試")
            r = await client.post("/api/v1/subtitle/tasks", data=form, headers=headers)
            assert r.status == 200, await r.text()
            task_id = (await r.json())["id"]
            await _wait_done(client, task_id, headers)

            r = await client.get(f"/api/v1/subtitle/tasks/{task_id}/subtitle-types",
                                 headers=headers)
            assert set((await r.json())["data"][0]["types"]) == {"TXT", "SRT", "DIA"}
            r = await client.get(f"/api/v1/subtitle/tasks/{task_id}/subtitle-link?type=SRT",
                                 headers=headers)
            link = (await r.json())["data"][0]
            assert link["type"] == "SRT" and "subtitle?type=SRT" in link["url"]
            r = await client.get(f"/api/v1/subtitle/tasks/{task_id}/subtitle?type=TXT",
                                 headers=headers)
            assert r.status == 200 and (await r.text()) == "這是單元測試"
            r = await client.get(f"/api/v1/subtitle/tasks/{task_id}/subtitle?type=2",
                                 headers=headers)
            srt = await r.text()
            assert "00:00:00,000 --> 00:00:01,234" in srt and "這是單元測試" in srt
            cer = list(api_env.glob("audio_files/tasks/*/*_cer.txt"))
            assert len(cer) == 1 and "CER: 0.0000" in cer[0].read_text(encoding="utf-8")

            r = await client.post("/api/v1/subtitle/tasks/99999", headers=headers)
            assert r.status == 404
        finally:
            await client.close()
    _run(run())


def test_user_management(api_env):
    async def run():
        client = await _client()
        try:
            headers = {"Authorization": f"Bearer {await _login(client)}"}
            alice = {"username": "alice", "nickname": "Alice", "role": "user",
                     "password": "pw123", "expiredTime": "2099-01-01T00:00:00Z"}
            r = await client.post("/api/v1/user", json=alice, headers=headers)
            assert r.status == 200, await r.text()
            r = await client.post("/api/v1/user", json=alice, headers=headers)
            assert r.status == 409
            r = await client.post("/api/v1/login",
                                  json={"username": "alice", "password": "pw123"})
            assert r.status == 200
            alice_auth = {"Authorization": f"Bearer {(await r.json())['token']}"}
            r = await client.post("/api/v1/user", headers=alice_auth, json=dict(
                alice, username="bob"))
            assert r.status == 403
            r = await client.put("/api/v1/user/password?username=alice&newPassword=pw456",
                                 headers=alice_auth)
            assert r.status == 200
            r = await client.put("/api/v1/user/password?username=admin&newPassword=hax",
                                 headers=alice_auth)
            assert r.status == 403
            r = await client.post("/api/v1/login",
                                  json={"username": "alice", "password": "pw456"})
            assert r.status == 200
        finally:
            await client.close()
    _run(run())


def test_streaming_ws_handshake_and_audio(api_env):
    async def run():
        import base64
        import json

        client = await _client()
        try:
            ws = await client.ws_connect("/ws/v1/transcript")
            assert json.loads((await ws.receive()).data)["code"] == 400
            await ws.close()

            ws = await client.ws_connect("/stream/ws/stt?token=tester")
            msg = json.loads((await ws.receive()).data)
            assert msg["code"] == 100 and msg["message"] == "服務準備中"
            await ws.send_bytes(b"\x00\x01" * 800)
            msg = json.loads((await ws.receive()).data)
            assert msg["code"] == 200 and "not initialized" in msg["description"]
            assert msg["data"]["buffer_bytes"] == 1600
            await ws.send_str(json.dumps({"type": "config", "data": {
                "language": "zh", "sampleRate": 8000,
                "processing_args": {"chunk_length_seconds": 1.0,
                                    "chunk_offset_seconds": 0.1}}}))
            msg = json.loads((await ws.receive()).data)
            assert msg["code"] == 200 and "config" in msg["description"]
            await ws.send_str(json.dumps({"audio": base64.b64encode(b"\x00\x01").decode()}))
            assert json.loads((await ws.receive()).data)["code"] == 200
            await ws.close()
        finally:
            await client.close()
    _run(run())


def test_upload_streams_to_disk_constant_memory(api_env):
    async def run():
        import tracemalloc

        import aiohttp

        client = await _client()
        try:
            headers = {"Authorization": f"Bearer {await _login(client)}"}
            big = _sine_wav() + b"\x00" * (32 * 1024 * 1024)
            tracemalloc.start()
            tracemalloc.reset_peak()
            form = aiohttp.FormData()
            form.add_field("audio", big, filename="big.wav", content_type="audio/wav")
            r = await client.post("/api/v1/subtitle/tasks", data=form, headers=headers)
            _, peak = tracemalloc.get_traced_memory()
            tracemalloc.stop()
            assert r.status == 200, await r.text()
            sizes = [p.stat().st_size
                     for p in api_env.glob("audio_files/tasks/*/input.wav")]
            assert len(big) in sizes
            assert peak < len(big) // 2, f"peak {peak} for {len(big)} upload"
        finally:
            await client.close()
    _run(run())


def test_process_audio_file_helper(api_env):
    from ttasr_torch.audio.io import write_wav

    t_ft.load_model()
    path = str(api_env / "x.wav")
    write_wav(path, 0.1 * np.sin(np.linspace(0, 100, 3200)).astype(np.float32))
    out = t_ft.process_audio_file(path, reference_text="這是單元測試")
    assert out["success"] is True and out["asr_result"] == "這是單元測試"
    assert out["cer_result"]["cer_rate"] == 0.0 and out["processing_time"] >= 0


# -- against the JAX package ------------------------------------------------


def _routes(app_module):
    return sorted((r.method, r.resource.canonical)
                  for r in app_module.create_app().router.routes())


def test_create_app_routes_match_jax():
    got, want = _routes(t_app), _routes(j_app)
    assert got == want
    assert ("GET", "/stream/ws/stt") in got and ("GET", "/ws/v1/transcript") in got


@pytest.mark.parametrize("alg", ["HS256", "HS384", "HS512"])
def test_jwt_tokens_cross_verify(alg, monkeypatch):
    monkeypatch.setenv("ASR_API_JWT_SECRET", "CROSS_SECRET")
    monkeypatch.setenv("ASR_API_JWT_ALGORITHM", alg)
    claims = {"sub": "u", "role": "admin", "nick": "管理員"}
    for make, read in ((t_jwt, j_jwt), (j_jwt, t_jwt)):
        token = make.generate_jwt_token(claims, 60)
        assert read.verify_jwt_token(token) == make.verify_jwt_token(token)
        assert read.verify_jwt_token(token)["sub"] == "u"
        for bad in (token + "x", "not.a.token", make.generate_jwt_token(claims, -10)):
            with pytest.raises(read.AuthError) as got:
                read.verify_jwt_token(bad)
            with pytest.raises(make.AuthError) as want:
                make.verify_jwt_token(bad)
            assert (got.value.detail, got.value.status) == (want.value.detail,
                                                           want.value.status)
    header = "Bearer abc.def.ghi"
    assert (t_jwt.get_bearer_token_from_authorization_header(header)
            == j_jwt.get_bearer_token_from_authorization_header(header))


def test_password_hashes_cross_verify():
    fixed = dict(rounds=1000, salt=bytes(range(16)))
    assert t_pw.hash_password("abc", **fixed) == j_pw.hash_password("abc", **fixed)
    for make, read in ((t_pw, j_pw), (j_pw, t_pw)):
        h = make.hash_password("secret@123")
        assert h.startswith("$pbkdf2-sha256$29000$")
        assert read.verify_password("secret@123", h)
        assert not read.verify_password("wrong", h)
    assert not t_pw.verify_password("x", "$bcrypt$whatever")


def test_type_param_and_status_codes_match_jax():
    for value in (None, "1", "txt", " TEXT ", "2", "srt", "3", "Dia", "9", ""):
        assert t_ft.resolve_type_param(value) == j_ft.resolve_type_param(value), value
    names = [n for n in vars(j_ft) if n.startswith("STATUS_")]
    assert len(names) == 15
    assert {n: getattr(t_ft, n) for n in names} == {n: getattr(j_ft, n) for n in names}
    assert t_ft.ALLOWED_EXTENSIONS == j_ft.ALLOWED_EXTENSIONS
    assert t_ft.TRANSCRIBE_KWARGS == j_ft.TRANSCRIBE_KWARGS


# -- the device ---------------------------------------------------------------


def test_without_cuda_the_service_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(t_ft, "whisper_engine", None)
    assert t_config.MODEL_DEVICE == "cuda"  # the default, read at import
    with pytest.raises(RuntimeError, match="CUDA"):
        t_ft.load_model()
    assert t_ft.whisper_engine is None
    with pytest.raises(RuntimeError, match="CUDA"):
        TorchWhisperASR(model_size=NAME, compute_type="float32")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", TTASR_API_PORT="0")
    env.pop("TTASR_MODEL_DEVICE", None)
    proc = subprocess.run([sys.executable, "-m", "ttasr_torch.api.app"], cwd=REPO_ROOT,
                          env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and "CUDA" in proc.stderr, proc.stderr[-2000:]


# -- one real engine: the JAX app and the port's app on the same uploads ------


@pytest.fixture(scope="module")
def engines_f32():
    jcfg = J_PRESETS[NAME]
    jp = jm.init_params(jcfg, seed=0, dtype=jnp.float32)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), dtype=torch.float32)
    je = JEngine(NAME, compute_type="float32", params=jp, config=jcfg, tokenizer=TOK)
    te = TEngine(NAME, compute_type="float32", params=tp, config=T_PRESETS[NAME],
                 tokenizer=TOK, device="cpu")
    return je, te


def _speech_wav(seconds, seed):
    audio = synth_speech(np.random.default_rng(seed), seconds)[0]
    return _wav_bytes((np.clip(audio, -1, 1) * 32767).astype("<i2"))


def _engine_env(monkeypatch, tmp_path, engines):
    """Both packages' registries hold the test engines under the key their
    ``get_engine`` computes from ``TTASR_MODEL_PATH`` and the compute type,
    so the apps' own ``load_model`` finds them."""
    je, te = engines
    _auth_env(monkeypatch, tmp_path)
    monkeypatch.setenv("TTASR_MODEL_PATH", NAME)
    monkeypatch.setenv("TTASR_MODEL_COMPUTE_TYPE", "float32")
    monkeypatch.setattr(t_config, "MODEL_DEVICE", "cpu")
    monkeypatch.setitem(j_registry._ENGINES, (NAME, "float32", None), je)
    monkeypatch.setitem(t_registry._ENGINES, (NAME, "float32", None, "cpu"), te)
    for ft in (j_ft, t_ft):
        monkeypatch.setattr(ft, "whisper_engine", None)
        monkeypatch.setattr(ft, "BASE_DIR", tmp_path / ft.__name__)
        monkeypatch.setattr(ft, "TRANSCRIBE_KWARGS",
                            dict(ft.TRANSCRIBE_KWARGS, temperatures=(0.0,),
                                 max_new_tokens=24))


def _upload_all(app_module, clips):
    """Every clip uploaded at once; returns {name: (TXT, SRT)}."""
    async def run():
        import aiohttp

        client = await _client(app_module)
        try:
            headers = {"Authorization": f"Bearer {await _login(client)}"}

            async def one(name, data):
                form = aiohttp.FormData()
                form.add_field("audio", data, filename=name, content_type="audio/wav")
                r = await client.post("/api/v1/subtitle/tasks", data=form, headers=headers)
                assert r.status == 200, await r.text()
                return (await r.json())["id"]

            ids = await asyncio.gather(*[one(n, d) for n, d in clips.items()])
            out = {}
            for name, task_id in zip(clips, ids):
                await _wait_done(client, task_id, headers, polls=1200, every=0.1)
                files = []
                for kind in ("TXT", "SRT"):
                    r = await client.get(
                        f"/api/v1/subtitle/tasks/{task_id}/subtitle?type={kind}",
                        headers=headers)
                    assert r.status == 200
                    files.append(await r.read())
                out[name] = tuple(files)
            return out
        finally:
            await client.close()
    return _run(run())


def test_uploads_match_jax_app(engines_f32, tmp_path, monkeypatch):
    _engine_env(monkeypatch, tmp_path, engines_f32)
    monkeypatch.setenv("TTASR_TASK_BATCH_SLOTS", "4")
    monkeypatch.setenv("TTASR_TASK_BATCH_LINGER_MS", "300")
    rows = []
    real = t_serving.BatchServer._decode_batch

    def counted(self, batch):
        rows.append(len(batch))
        return real(self, batch)

    monkeypatch.setattr(t_serving.BatchServer, "_decode_batch", counted)
    clips = {f"clip{i}.wav": _speech_wav(3.0, 40 + i) for i in range(2)}
    want = _upload_all(j_app, clips)
    got = _upload_all(t_app, clips)
    assert t_ft.whisper_engine is engines_f32[1]
    assert got == want
    assert all(txt and srt.startswith(b"1\r\n") for txt, srt in got.values()), got
    assert max(rows) > 1, rows  # the two uploads shared a sweep
