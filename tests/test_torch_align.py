"""Word timestamps in the port (``ttasr_torch/models/whisper/align.py`` and
the engine's three routes) against the JAX package on the CPU.

- ``decode_with_cross_attn``: the hidden states and the (L, B, H, T, S)
  cross-attention probabilities within 1e-5 of the JAX pass, on f32 and
  on int8 (``quantize_params`` + ``fuse_qkv``) ``micro64-test`` weights
  moved by ``params_from_jax``.
- The host half (z-norm, median filter, head mean, ``dtw_path``, jumps)
  bit for bit against the JAX ``align_tokens`` fed the same probabilities;
  ``merge_tokens_to_words`` on CJK and latin pieces.
- ``align_tokens`` end to end: word texts exact, times within one frame
  (0.02 s) per word.  On random weights the cross-attention is near
  uniform, so per-head z-normalisation magnifies last-bit differences of
  the two passes and a near-tie can move a DTW step by a frame.
- ``transcribe(word_timestamps=True)`` through ``transcribe``,
  ``transcribe_with_server`` and ``BatchedInferencePipeline`` at T = 0,
  ``vad_filter=False`` (the batched path's chunks come from the VAD):
  the same segments and word texts as the JAX engine, times within
  0.02 s; the batched path aligns once per chunk at its absolute offset.
- On the two served routes the alignment runs off the event loop: while
  a served group holds the engine's device lock, a coroutine on the same
  loop still runs.
"""

import asyncio
import functools
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tools.train_vad import synth_speech
from ttasr.engine import batched as j_batched
from ttasr.engine import serving as j_serving
from ttasr.engine import transcriber as j_tr
from ttasr.models.whisper import align as ja
from ttasr.models.whisper import model as jm
from ttasr.models.whisper.config import PRESETS as J_PRESETS
from ttasr.ops.quant import fuse_qkv, quantize_params
from ttasr.text.tokenizer import build_byte_fallback_tokenizer
from ttasr_torch.engine import batched as t_batched
from ttasr_torch.engine import serving as t_serving
from ttasr_torch.engine import transcriber as t_tr
from ttasr_torch.models.whisper import align as ta
from ttasr_torch.models.whisper.config import PRESETS as T_PRESETS
from ttasr_torch.models.whisper.load import params_from_jax

TOK = build_byte_fallback_tokenizer()
NAME = "micro64-test"
FRAME = 0.02   # one DTW frame: the time tolerance of a word
QK_TOL = 1e-5  # f32 passes in two frameworks
GATES_OFF = dict(temperature=(0.0,), compression_ratio_threshold=None,
                 log_prob_threshold=None, no_speech_threshold=None)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The micro model's eager ops run faster on one thread (about 2x for
    the warm-up here), and the suite runs several workers to a machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _speech(seconds, seed):
    return synth_speech(np.random.default_rng(seed), seconds)[0]


@functools.lru_cache(maxsize=None)
def _params(kind):
    jp = jm.init_params(J_PRESETS[NAME], seed=0, dtype=jnp.float32)
    if kind == "int8":
        jp = fuse_qkv(quantize_params(jp))
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), dtype=torch.float32)


@functools.lru_cache(maxsize=None)
def _window():
    """One window's encoder states (from the JAX f32 engine's weights) and
    a text of 40 tokens: bytes of mixed zh/en speech text."""
    rng = np.random.default_rng(7)
    enc = (rng.standard_normal((1, 1500, J_PRESETS[NAME].d_model)) * 0.5
           ).astype(np.float32)
    text = TOK.encode(" 今天 the weather 很好, we go 夜市")[:40]
    return enc, text


@functools.lru_cache(maxsize=None)
def _jax_qk(kind):
    jp, _ = _params(kind)
    enc, text = _window()
    tokens = (TOK.sot_sequence("zh", "transcribe", predict_timestamps=False)
              + list(text) + [TOK.eot])
    run = jax.jit(lambda p, t, e: ja.decode_with_cross_attn(p, J_PRESETS[NAME], t, e))
    x, qk = run(jp, np.asarray([tokens], np.int32), enc)
    return tokens, np.asarray(x), np.asarray(qk)


@pytest.mark.parametrize("kind", ["f32", "int8"])
def test_decode_with_cross_attn_matches_jax(kind):
    _, tp = _params(kind)
    enc, _ = _window()
    tokens, jx, jqk = _jax_qk(kind)
    x, qk = ta.decode_with_cross_attn(tp, T_PRESETS[NAME],
                                      torch.tensor([tokens]), torch.from_numpy(enc))
    cfg = T_PRESETS[NAME]
    assert qk.shape == (cfg.decoder_layers, 1, cfg.decoder_heads, len(tokens), 1500)
    assert qk.dtype == torch.float32
    np.testing.assert_allclose(qk.numpy(), jqk, rtol=0, atol=QK_TOL)
    np.testing.assert_allclose(x.numpy(), jx, rtol=QK_TOL, atol=QK_TOL)
    # rows are distributions, and the causal prefix sees no later token
    np.testing.assert_allclose(qk.sum(-1).numpy(), 1.0, atol=1e-5)
    if kind == "int8":
        assert "wqkv" in tp["decoder"]["blocks"][0]


def test_host_half_bit_for_bit(monkeypatch):
    """The JAX ``align_tokens`` with its pass replaced by a fixed array (in
    one of its pad buckets, pad rows included) against the port's
    ``token_timings`` on the same probabilities."""
    enc, text = _window()
    tokens, _, qk = _jax_qk("f32")
    width = 64
    padded = np.concatenate(
        [qk, np.full(qk.shape[:3] + (width - qk.shape[3], qk.shape[4]), 0.5, np.float32)],
        axis=3)
    monkeypatch.setattr(ja, "_jitted_decode_qk",
                        lambda cfg: (lambda p, t, e: (None, padded)))
    for medfilt in (7, 1):
        want = ja.align_tokens(None, None, TOK, text, enc, medfilt_width=medfilt)
        n = qk.shape[0]
        got = ta.token_timings(TOK, text, qk[n // 2:, 0], medfilt_width=medfilt)
        assert got == [ta.TokenTiming(**vars(t)) for t in want]
        assert ta.merge_tokens_to_words(TOK, got) == ja.merge_tokens_to_words(TOK, want)
    rng = np.random.default_rng(3)
    cost = rng.standard_normal((17, 40)).astype(np.float32)
    for got, want in zip(ta.dtw_path(cost), ja.dtw_path(cost)):
        np.testing.assert_array_equal(got, want)
    x = rng.standard_normal((3, 5, 30)).astype(np.float32)
    np.testing.assert_array_equal(ta._median_filter(x, 7), ja._median_filter(x, 7))


class _PieceTokenizer:
    """Decodes ids through a fixed table of pieces."""

    PIECES = {1: "今", 2: "天", 3: " hel", 4: "lo", 5: " world", 6: "好",
              7: "!", 8: " ", 9: " a"}

    def decode(self, ids):
        return "".join(self.PIECES[i] for i in ids)


def test_merge_tokens_to_words_cjk_and_latin():
    tok = _PieceTokenizer()
    timings = [ta.TokenTiming(t, 0.1 * i, 0.1 * i + 0.1, 1.0)
               for i, t in enumerate([3, 4, 1, 2, 5, 7, 8, 6, 9])]
    got = ta.merge_tokens_to_words(tok, timings)
    want = ja.merge_tokens_to_words(
        tok, [ja.TokenTiming(**vars(t)) for t in timings])
    assert got == want
    assert [w["word"] for w in got] == [" hello", "今", "天", " world!", "好", " a"]
    assert got[0] == {"word": " hello", "start": 0.0, "end": 0.2}


def _hold_words(got_words, want_words):
    assert [w.word for w in got_words] == [w.word for w in want_words]
    for g, w in zip(got_words, want_words):
        assert abs(g.start - w.start) <= FRAME + 1e-9, (g, w)
        assert abs(g.end - w.end) <= FRAME + 1e-9, (g, w)


def test_align_tokens_end_to_end_matches_jax():
    jp, tp = _params("f32")
    enc, text = _window()
    want = ja.merge_tokens_to_words(TOK, ja.align_tokens(jp, J_PRESETS[NAME], TOK, text, enc))
    got = ta.merge_tokens_to_words(TOK, ta.align_tokens(
        tp, T_PRESETS[NAME], TOK, text, torch.from_numpy(enc)))
    assert len(want) >= 3
    assert [w["word"] for w in got] == [w["word"] for w in want]
    for g, w in zip(got, want):
        assert abs(g["start"] - w["start"]) <= FRAME + 1e-9
        assert abs(g["end"] - w["end"]) <= FRAME + 1e-9


@pytest.fixture(scope="module")
def engines_f32():
    jp, tp = _params("f32")
    je = j_tr.WhisperEngine(NAME, compute_type="float32", params=jp,
                            config=J_PRESETS[NAME], tokenizer=TOK)
    te = t_tr.WhisperEngine(NAME, compute_type="float32", params=tp,
                            config=T_PRESETS[NAME], tokenizer=TOK, device="cpu")
    return je, te


def _two_bursts():
    """~1.8 s of speech, ~3 s of silence, ~1.8 s of speech: two VAD chunks
    at ``chunk_length=4``."""
    a = np.zeros(16000 * 8, np.float32)
    b1, b2 = _speech(1.8, 5), _speech(1.8, 6)
    a[8000: 8000 + len(b1)] = b1
    a[84800: 84800 + len(b2)] = b2
    return a


def _served(serving, engine, audio, kw):
    async def go():
        server = serving.BatchServer(engine, slots=1, beam_size=5)
        await server.start()
        try:
            return await engine.transcribe_with_server(audio, server, **kw)
        finally:
            await server.stop()

    return asyncio.run(go())


@pytest.mark.parametrize("route", ["transcribe", "server", "batched"])
def test_transcribe_word_timestamps_match_jax(engines_f32, route):
    je, te = engines_f32
    kw = dict(language="zh", beam_size=5, word_timestamps=True,
              max_new_tokens=40, **GATES_OFF)
    if route == "transcribe":
        audio = _speech(12.0, 3)
        want, _ = je.transcribe(audio, vad_filter=False, **kw)
        got, _ = te.transcribe(audio, vad_filter=False, **kw)
    elif route == "server":
        audio = _speech(12.0, 3)
        want, _ = _served(j_serving, je, audio, dict(kw, vad_filter=False))
        got, _ = _served(t_serving, te, audio, dict(kw, vad_filter=False))
    else:
        audio = _two_bursts()
        # one slot: the JAX side reuses the batch-1 programs it compiled
        want, _ = j_batched.BatchedInferencePipeline(je, batch_size=1).transcribe(
            audio, chunk_length=4, **kw)
        pipe = t_batched.BatchedInferencePipeline(te, batch_size=1)
        try:
            got, _ = pipe.transcribe(audio, chunk_length=4, **kw)
        finally:
            pipe.close()
    assert any(s.words for s in want)  # random weights: few words in segments
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g.seek, g.tokens, g.text, g.start, g.end) == (
            w.seek, w.tokens, w.text, w.start, w.end)
        assert g.words is not None
        _hold_words(g.words, w.words)
        for word in g.words:
            assert 0 <= word.start <= word.end
            if route != "batched":  # there the segment's end is clipped
                assert g.start - 0.01 <= (word.start + word.end) / 2 <= g.end + 0.5


def test_batched_aligns_each_chunk_at_its_offset(engines_f32):
    """The port's counterpart of ``tests/test_batched.py``'s word test: one
    aligner call per chunk, with that chunk's encoder row and ABSOLUTE
    time offset; the words land after their chunk's start."""
    _, te = engines_f32
    calls = []
    orig = te._align_window_words

    def spy(text_tokens, enc, time_offset):
        calls.append((len(text_tokens), tuple(enc.shape), time_offset))
        return orig(text_tokens, enc, time_offset)

    te._align_window_words = spy
    pipe = t_batched.BatchedInferencePipeline(te, batch_size=2)
    try:
        segs, _ = pipe.transcribe(_two_bursts(), language="zh", beam_size=1,
                                  max_new_tokens=6, word_timestamps=True,
                                  chunk_length=4, **GATES_OFF)
    finally:
        pipe.close()
        del te._align_window_words
    assert segs and all(s.words is not None for s in segs)
    assert len(calls) == 2, calls
    assert all(n > 0 and shape == (1, 1500, T_PRESETS[NAME].d_model)
               for n, shape, _ in calls), calls
    offsets = sorted(c[2] for c in calls)
    assert offsets[0] < 2.0 and offsets[1] > 3.0, offsets
    for s in segs:
        assert all(w.start >= s.seek * 0.01 for w in s.words)


@pytest.mark.parametrize("route", ["server", "batched"])
def test_served_alignment_leaves_the_loop_free(engines_f32, route):
    """A file's words are due while a served group holds the engine's
    device lock (a thread here, as ``BatchServer._decode_batch`` holds it
    for a whole encode and decode): the alignment waits for the lock off
    the event loop, so another coroutine on the loop runs meanwhile and
    is the one that lets the group go."""
    _, te = engines_f32
    orig = te._align_window_words
    entered, held, release = threading.Event(), threading.Event(), threading.Event()
    let_go_by_loop = []

    def align(*args):
        entered.set()
        assert held.wait(10)
        return orig(*args)  # blocks on the device lock until the group lets go

    def group():
        if not entered.wait(30):
            return
        with te._device_lock:
            held.set()
            let_go_by_loop.append(release.wait(5))

    async def other_file():
        for _ in range(30000):  # bounded: the file may align no window
            if held.is_set():
                break
            await asyncio.sleep(0.001)
        for _ in range(20):  # loop turns while the lock is held
            await asyncio.sleep(0)
        release.set()

    kw = dict(language="zh", beam_size=1, max_new_tokens=6, word_timestamps=True,
              **GATES_OFF)

    async def go():
        server = t_serving.BatchServer(te, slots=1, beam_size=1)
        await server.start()
        try:
            if route == "server":
                work = te.transcribe_with_server(_two_bursts(), server, vad_filter=False, **kw)
            else:
                work = t_batched.transcribe_batched_with_server(
                    te, server, _two_bursts(), chunk_length=4, **kw)
            (segs, _), _ = await asyncio.gather(work, other_file())
        finally:
            await server.stop()
        return segs

    holder = threading.Thread(target=group)
    holder.start()
    te._align_window_words = align
    try:
        segs = asyncio.run(go())
    finally:
        del te._align_window_words
        release.set()
        holder.join(30)
    assert not holder.is_alive()
    assert entered.is_set() and held.is_set()
    assert let_go_by_loop == [True]  # not the holder's 5 s timeout
    assert segs and all(s.words is not None for s in segs)
