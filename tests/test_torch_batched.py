"""The port's batched single-file path (``ttasr_torch/engine/batched.py``)
and the batch CLI's served modes, against the JAX package on the CPU.

- ``build_speech_chunks`` equal to the JAX function on the cases of
  ``tests/test_batched.py`` and on VAD timestamps of synthesized speech.
- ``transcribe_batched_with_server`` on ~40 s of synthesized speech at
  temperature 0 with the quality gates off, f32 ``micro64-test`` engines on
  both sides (weights shared through ``params_from_jax``): equal tokens,
  text, seek, start and end, ``avg_logprob`` within rel 1e-4,
  ``no_speech_prob`` within rel 1e-3.
- ``BatchedInferencePipeline``: two VAD-separated bursts with
  ``chunk_length=4`` against the JAX pipeline, the server reused across
  calls, ``transcribe`` called from inside a running event loop, and
  ``close()``.
- ``process_audio_folder(concurrency=2)`` and ``(batched=True)`` of both
  CLIs on the same two WAVs give the same per-file text.
"""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tools.train_vad import synth_speech
from ttasr.audio.io import write_wav
from ttasr.audio.vad import VadOptions, get_speech_timestamps
from ttasr.cli import asr as j_cli
from ttasr.engine import batched as j_batched
from ttasr.engine import serving as j_serving
from ttasr.engine import transcriber as j_tr
from ttasr.models.whisper import model as jm
from ttasr.models.whisper.config import PRESETS as J_PRESETS
from ttasr.ops.mel import N_SAMPLES, SAMPLE_RATE
from ttasr.text.tokenizer import build_byte_fallback_tokenizer
from ttasr_torch.cli import asr as t_cli
from ttasr_torch.engine import batched as t_batched
from ttasr_torch.engine import serving as t_serving
from ttasr_torch.engine import transcriber as t_tr
from ttasr_torch.models.whisper.config import PRESETS as T_PRESETS
from ttasr_torch.models.whisper.load import params_from_jax

TOK = build_byte_fallback_tokenizer()
NAME = "micro64-test"

# quality gates off: random weights fail them on every window, and the
# ladder's sampled rungs draw from two different RNGs
GATES_OFF = dict(temperature=(0.0,), compression_ratio_threshold=None,
                 log_prob_threshold=None, no_speech_threshold=None)


@pytest.fixture(scope="module")
def engines_f32():
    jcfg = J_PRESETS[NAME]
    jp = jm.init_params(jcfg, seed=0, dtype=jnp.float32)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), dtype=torch.float32)
    je = j_tr.WhisperEngine(NAME, compute_type="float32", params=jp,
                            config=jcfg, tokenizer=TOK)
    te = t_tr.WhisperEngine(NAME, compute_type="float32", params=tp,
                            config=T_PRESETS[NAME], tokenizer=TOK, device="cpu")
    return je, te


def _speech(seconds, seed):
    return synth_speech(np.random.default_rng(seed), seconds)[0]


@pytest.fixture(scope="module")
def speech40():
    return np.concatenate([_speech(20.0, seed) for seed in (0, 1)])


def _two_bursts():
    """~1.8 s of speech, ~3 s of silence, ~1.8 s of speech: two VAD
    segments that cannot merge into one 4 s chunk."""
    a = np.zeros(int(8.0 * SAMPLE_RATE), np.float32)
    b1, b2 = _speech(1.8, 5), _speech(1.8, 6)
    a[int(0.5 * SAMPLE_RATE): int(0.5 * SAMPLE_RATE) + len(b1)] = b1
    a[int(5.3 * SAMPLE_RATE): int(5.3 * SAMPLE_RATE) + len(b2)] = b2
    return a


def _hold_segments(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g.id, g.seek, g.tokens, g.text) == (w.id, w.seek, w.tokens, w.text)
        assert (g.start, g.end, g.temperature) == (w.start, w.end, w.temperature)
        assert g.avg_logprob == pytest.approx(w.avg_logprob, rel=1e-4)
        assert g.no_speech_prob == pytest.approx(w.no_speech_prob, rel=1e-3, abs=1e-8)
        assert g.compression_ratio == w.compression_ratio


CHUNK_CASES = [
    ([{"start": 0, "end": 16000}, {"start": 32000, "end": 64000},
      {"start": 80000, "end": 120000}], 200000, N_SAMPLES),
    ([{"start": 0, "end": 160000}, {"start": 400000, "end": 560000}], 600000,
     N_SAMPLES),
    ([{"start": 0, "end": 70 * SAMPLE_RATE}], 70 * SAMPLE_RATE, N_SAMPLES),
    ([], 16000, N_SAMPLES),
    ([{"start": 0, "end": 70 * SAMPLE_RATE}], 70 * SAMPLE_RATE, 4 * SAMPLE_RATE),
]


@pytest.mark.parametrize("case", range(len(CHUNK_CASES) + 1))
def test_build_speech_chunks_matches_jax(case, speech40):
    if case < len(CHUNK_CASES):
        ts, total, max_samples = CHUNK_CASES[case]
    else:
        ts = get_speech_timestamps(speech40, VadOptions())
        total, max_samples = len(speech40), 6 * SAMPLE_RATE
    want = j_batched.build_speech_chunks(ts, total, max_samples=max_samples)
    got = t_batched.build_speech_chunks(ts, total, max_samples=max_samples)
    assert got == want
    assert len(want) == [1, 2, 3, 0, 18, 7][case]


def test_transcribe_batched_with_server_matches_jax(engines_f32, speech40):
    je, te = engines_f32
    kw = dict(language="zh", beam_size=5, initial_prompt="", **GATES_OFF)

    def run(serving, batched, engine):
        async def go():
            server = serving.BatchServer(engine, slots=4, beam_size=5)
            await server.start()
            try:
                return await batched.transcribe_batched_with_server(
                    engine, server, speech40, **kw)
            finally:
                await server.stop()

        return asyncio.run(go())

    want, want_info = run(j_serving, j_batched, je)
    got, got_info = run(t_serving, t_batched, te)
    assert got_info.__dict__ == want_info.__dict__
    assert len({s.seek for s in want}) > 1  # 2+ chunks
    _hold_segments(got, want)


def test_pipeline_reuses_its_server_inside_a_running_loop(engines_f32):
    je, te = engines_f32
    audio = _two_bursts()
    kw = dict(language="zh", beam_size=1, max_new_tokens=6, chunk_length=4,
              **GATES_OFF)
    want, _ = j_batched.BatchedInferencePipeline(je, batch_size=2).transcribe(
        audio, **kw)
    pipe = t_batched.BatchedInferencePipeline(te, batch_size=2)
    try:
        first, info = pipe.transcribe(audio, **kw)
        server = pipe._server
        assert server is not None and not server._stop
        served = server.stats["served"]

        async def inside_loop():
            return pipe.transcribe(audio, **kw)

        again, _ = asyncio.run(inside_loop())
        assert pipe._server is server and server.stats["served"] > served
    finally:
        pipe.close()
    assert pipe._server is None and server._stop
    _hold_segments(first, want)
    _hold_segments(again, want)
    assert info.duration == pytest.approx(8.0, abs=0.01)
    seeks = sorted({s.seek for s in first})
    assert len(seeks) == 2 and seeks[0] < 200 < 300 < seeks[1]


def _zero_temperature(module, attr, monkeypatch):
    """The ladder at T = 0 only, whatever the CLI passes: sampled rungs
    draw from two different RNGs."""
    parse = getattr(module, attr)
    monkeypatch.setattr(module, attr,
                        lambda kwargs: parse(dict(kwargs, temperature=(0.0,))))


@pytest.mark.parametrize("mode", [{"concurrency": 2}, {"batched": True}],
                         ids=["concurrency", "batched"])
def test_cli_modes_match_jax(engines_f32, tmp_path, monkeypatch, mode):
    je, te = engines_f32
    for module in (j_tr, t_tr, t_batched):
        _zero_temperature(module, "_parse_transcribe_kwargs", monkeypatch)
    audio_dir = tmp_path / "audio"
    audio_dir.mkdir()
    for seed, seconds in ((8, 12.0), (9, 7.0)):
        write_wav(str(audio_dir / f"s{seed}.wav"), _speech(seconds, seed), 16000)
    results = {}
    for name, cli, engine in (("jax", j_cli, je), ("port", t_cli, te)):
        out_dir = tmp_path / name
        out_dir.mkdir()
        results[name] = cli.process_audio_folder(
            str(audio_dir), engine=engine, results_json_dir=str(out_dir), **mode)
        assert (out_dir / "asr_comparison_results.json").exists()
    want, got = (results[k]["detailed_results"] for k in ("jax", "port"))
    assert [e["audio_file"] for e in got] == ["s8.wav", "s9.wav"]
    assert all("error" not in e for e in got)
    assert [e["asr_result"] for e in got] == [e["asr_result"] for e in want]
    assert any(e["asr_result"] for e in want)


def test_cli_reports_a_failed_served_file(engines_f32, tmp_path, monkeypatch):
    """A file whose served decode raised is that file's error entry; no
    file falls back to the sequential loop."""
    _, te = engines_f32
    audio_dir = tmp_path / "audio"
    audio_dir.mkdir()
    for seed in (10, 11):
        write_wav(str(audio_dir / f"s{seed}.wav"), _speech(3.0, seed), 16000)

    async def failing(audio, server, **kwargs):
        if str(audio).endswith("s10.wav"):
            raise RuntimeError("decode failed on the card")
        return await t_tr.WhisperEngine.transcribe_with_server(
            te, audio, server, **kwargs)

    monkeypatch.setattr(te, "transcribe_with_server", failing)
    monkeypatch.setattr(te, "transcribe", lambda *a, **k: pytest.fail("sequential"))
    _zero_temperature(t_tr, "_parse_transcribe_kwargs", monkeypatch)
    result = t_cli.process_audio_folder(str(audio_dir), engine=te,
                                        results_json_dir=str(tmp_path),
                                        concurrency=2)
    entries = {e["audio_file"]: e for e in result["detailed_results"]}
    assert entries["s10.wav"]["error"] == "decode failed on the card"
    assert "error" not in entries["s11.wav"]
