"""The port's serving layer (``ttasr_torch/engine/serving.py`` and the
engine's server path) against the JAX package, on the CPU: f32
``micro64-test`` engines on both sides with the weights shared through
``params_from_jax``, at temperature 0: the port's ``BatchServer`` against
the JAX ``BatchServer`` on the same requests (beam and greedy, 2 and 4
slots, and the short-window bucket S = 256), and ``transcribe_with_server``
on ~40 s of synthesized speech, held as ``test_transcribe_matches_jax_f32``
holds ``transcribe``: equal tokens, text, seek, start and end,
``avg_logprob`` within rel 1e-4, ``no_speech_prob`` within rel 1e-3.

The int8 engine against itself, the counting, the scheduler on a stub
engine and the registry are in ``test_torch_serving_scheduler.py``.
"""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ttasr.engine import serving as j_serving
from ttasr.engine.transcriber import WhisperEngine as JEngine
from ttasr.models.whisper import model as jm
from ttasr.models.whisper.config import PRESETS as J_PRESETS
from ttasr_torch.engine import serving as t_serving
from ttasr_torch.engine.transcriber import WhisperEngine as TEngine
from ttasr_torch.models.whisper.config import PRESETS as T_PRESETS
from ttasr_torch.models.whisper.load import params_from_jax

from torch_serving_helpers import (  # noqa: F401 (one_torch_thread: autouse)
    NAME,
    PROMPT,
    SAMPLE_LEN,
    TOK,
    one_torch_thread,
    serve,
    speech,
)



@pytest.fixture(scope="module")
def engines_f32():
    jcfg = J_PRESETS[NAME]
    jp = jm.init_params(jcfg, seed=0, dtype=jnp.float32)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), dtype=torch.float32)
    je = JEngine(NAME, compute_type="float32", params=jp, config=jcfg,
                 tokenizer=TOK)
    te = TEngine(NAME, compute_type="float32", params=tp,
                 config=T_PRESETS[NAME], tokenizer=TOK, device="cpu")
    return je, te


@pytest.fixture(scope="module")
def speech40():
    return np.concatenate([speech(20.0, seed) for seed in (0, 1)])


def _hold_result(got, want):
    assert got.tokens == want.tokens
    assert got.temperature == want.temperature
    assert got.avg_logprob == pytest.approx(want.avg_logprob, rel=1e-4)
    assert got.no_speech_prob == pytest.approx(want.no_speech_prob, rel=1e-3,
                                               abs=1e-8)


def _hold_segments(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g.id, g.seek, g.tokens, g.text) == (w.id, w.seek, w.tokens, w.text)
        assert (g.start, g.end, g.temperature) == (w.start, w.end, w.temperature)
        assert g.avg_logprob == pytest.approx(w.avg_logprob, rel=1e-4)
        assert g.no_speech_prob == pytest.approx(w.no_speech_prob, rel=1e-3, abs=1e-8)
        assert g.compression_ratio == w.compression_ratio


@pytest.mark.parametrize("beam_size,slots", [(5, 2), (5, 4), (1, 2), (1, 4)])
def test_server_matches_jax_server(engines_f32, beam_size, slots):
    je, te = engines_f32
    requests = [(speech(s, seed), PROMPT, {})
                for s, seed in ((8.0, 2), (12.0, 3), (5.0, 4))]
    kw = dict(slots=slots, beam_size=beam_size, sample_len=SAMPLE_LEN,
              linger_ms=50)
    want = serve(j_serving.BatchServer, je, requests, **kw)
    got = serve(t_serving.BatchServer, te, requests, **kw)
    for g, w in zip(got, want):
        _hold_result(g, w)
    assert any(len(w.tokens) > 1 for w in want)


def test_short_window_matches_jax_server(engines_f32):
    """``short_window=True``: a 2 s request encodes the 5.12 s prefix
    window (S = 256) on both sides, greedy and beam 2."""
    je, te = engines_f32
    audio = speech(2.0, 7)
    assert t_serving.window_bucket(len(audio)) == j_serving.window_bucket(len(audio)) == 81920
    assert t_serving.WINDOW_BUCKETS == j_serving.WINDOW_BUCKETS
    requests = [(audio, PROMPT, dict(short_window=True)),
                (audio, PROMPT, dict(short_window=True, beam_size=2))]
    kw = dict(slots=2, beam_size=1, sample_len=SAMPLE_LEN, linger_ms=5)
    want = serve(j_serving.BatchServer, je, requests, **kw)
    got = serve(t_serving.BatchServer, te, requests, **kw)
    for g, w in zip(got, want):
        _hold_result(g, w)
    enc = te.encode_windows(np.zeros((1, 81920), np.float32), window_samples=81920)
    assert enc.shape[1] == 256


def test_transcribe_with_server_matches_jax(engines_f32, speech40):
    je, te = engines_f32
    kw = dict(language="zh", beam_size=5, vad_filter=True,
              condition_on_previous_text=True, initial_prompt="",
              temperature=(0.0,))

    def run(serving, engine):
        async def go():
            server = serving.BatchServer(engine, slots=2, beam_size=5)
            await server.start()
            try:
                return await engine.transcribe_with_server(speech40, server, **kw)
            finally:
                await server.stop()

        return asyncio.run(go())

    want, want_info = run(j_serving, je)
    got, got_info = run(t_serving, te)
    assert got_info.__dict__ == want_info.__dict__
    assert len(want) > 1 and len({s.seek for s in want}) > 1  # 2+ windows
    _hold_segments(got, want)
    # the served path equals the port's sequential seek loop
    seq, _ = te.transcribe(speech40, **kw)
    assert [(s.seek, s.tokens, s.start, s.end) for s in seq] == \
        [(s.seek, s.tokens, s.start, s.end) for s in got]
