"""The port's ``WhisperEngine`` against the JAX engine on the CPU.

- float32, temperature 0: identical segments (tokens, text, times) from
  ``transcribe`` on ~40 s of synthesized speech with VAD, beam 5 and prompt
  carry across windows (``micro64-test`` weights shared through
  ``params_from_jax``), and the same detected language.
- bfloat16: encoder states and decode-step logits held to the bound the
  JAX package recorded for bf16 reassociation (PERF_NOTES "TPU numeric
  parity": step logits within 1.4 % relative, argmax agreement).
- best-of sampling picks one of its candidates; word timestamps equal
  the JAX engine's.

The CLI and the device checks are in ``tests/test_torch_engine_cli.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tools.train_vad import synth_speech
from ttasr.engine.transcriber import WhisperEngine as JEngine
from ttasr.models.whisper import decode as jd
from ttasr.models.whisper import model as jm
from ttasr.models.whisper.config import PRESETS as J_PRESETS
from ttasr.text.tokenizer import build_byte_fallback_tokenizer
from ttasr_torch.engine.transcriber import WhisperEngine as TEngine
from ttasr_torch.models.whisper import decode as td
from ttasr_torch.models.whisper.config import PRESETS as T_PRESETS
from ttasr_torch.models.whisper.load import params_from_jax

TOK = build_byte_fallback_tokenizer()
NAME = "micro64-test"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The micro model's eager ops run faster on one thread, and the suite
    runs several workers to a machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _engines(dtype_name):
    jdtype = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype_name]
    tdtype = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype_name]
    jcfg = J_PRESETS[NAME]
    jp = jm.init_params(jcfg, seed=0, dtype=jdtype)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), dtype=tdtype)
    je = JEngine(NAME, compute_type=dtype_name, params=jp, config=jcfg,
                 tokenizer=TOK)
    te = TEngine(NAME, compute_type=dtype_name, params=tp,
                 config=T_PRESETS[NAME], tokenizer=TOK, device="cpu")
    return je, te


@pytest.fixture(scope="module")
def engines_f32():
    return _engines("float32")


@pytest.fixture(scope="module")
def speech40():
    parts = [synth_speech(np.random.default_rng(seed), 20.0)[0] for seed in (0, 1)]
    return np.concatenate(parts)


def test_transcribe_matches_jax_f32(engines_f32, speech40):
    je, te = engines_f32
    kw = dict(language="zh", beam_size=5, vad_filter=True,
              condition_on_previous_text=True, initial_prompt="",
              temperature=(0.0,))
    want, want_info = je.transcribe(speech40, **kw)
    got, got_info = te.transcribe(speech40, **kw)
    assert got_info.__dict__ == want_info.__dict__
    assert len(want) > 1 and len({s.seek for s in want}) > 1  # 2+ windows
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g.id, g.seek, g.tokens, g.text) == (w.id, w.seek, w.tokens, w.text)
        assert (g.start, g.end, g.temperature) == (w.start, w.end, w.temperature)
        assert g.avg_logprob == pytest.approx(w.avg_logprob, rel=1e-4)
        assert g.no_speech_prob == pytest.approx(w.no_speech_prob, rel=1e-3, abs=1e-8)
        assert g.compression_ratio == w.compression_ratio
    assert te.decode_stats["beam_decodes"] >= 2
    assert te.decode_stats["nonfinite_logits"] == 0



def test_detect_language_matches_jax(engines_f32, speech40):
    je, te = engines_f32
    lang_j, prob_j, ranked_j = je.detect_language(speech40[:16000 * 5])
    lang_t, prob_t, ranked_t = te.detect_language(speech40[:16000 * 5])
    assert lang_t == lang_j
    assert prob_t == pytest.approx(prob_j, rel=1e-4)
    assert [k for k, _ in ranked_t[:5]] == [k for k, _ in ranked_j[:5]]



def test_bf16_encoder_and_step_logits_within_bound(speech40):
    je, te = _engines("bfloat16")
    window = speech40[:16000 * 30]
    enc_j = je.encode_windows(window[None])
    enc_t = te.encode_windows(window[None])
    ej = np.asarray(enc_j, np.float32)
    et = enc_t.float().numpy()
    assert np.abs(et - ej).max() <= 2e-2 * np.abs(ej).max()

    prompt, pad = jd.pad_prompts([jd.build_prompt(TOK)], TOK.eot)
    forced = [TOK.timestamp_begin, 200, 201, 202, TOK.timestamp_begin + 50]
    jcache = jm.init_cache(je.params, je.cfg, enc_j, max_len=prompt.shape[1] + 8)
    hj, jcache = jd._prefill(je.params, je.cfg, prompt, pad, jcache)
    tcache = td.init_cache(te.params, te.cfg, enc_t, max_len=prompt.shape[1] + 8)
    tp_, tpad = (torch.from_numpy(x).long() for x in (prompt, pad))
    ht, tcache = td._prefill(te.params, te.cfg, tp_, tpad, tcache)
    steps = [(np.asarray(jd._logits_at(je.params, hj[:, -1]), np.float32),
              td._logits_at(te.params, ht[:, -1]).numpy())]
    for i, tok in enumerate(forced):
        slot = prompt.shape[1] + i
        lj, jcache = jd._step(je.params, je.cfg, np.array([[tok]], np.int32),
                              slot, pad, jcache)
        lt, tcache = td._step(te.params, te.cfg, torch.tensor([[tok]]), slot,
                              tpad, tcache)
        steps.append((np.asarray(lj, np.float32), lt.numpy()))
    for lj, lt in steps:
        assert np.abs(lt - lj).max() <= 1.4e-2 * np.abs(lj).max()
        assert lt.argmax(-1) == lj.argmax(-1)



def test_word_timestamps_raise(engines_f32, speech40):
    """Word timestamps run and match the JAX engine's: the same segments
    and word texts, times within one DTW frame (0.02 s; the alignment's
    own tests are in ``tests/test_torch_align.py``)."""
    je, te = engines_f32
    kw = dict(language="zh", beam_size=5, vad_filter=False, word_timestamps=True,
              temperature=(0.0,), max_new_tokens=24, compression_ratio_threshold=None,
              log_prob_threshold=None, no_speech_threshold=None)
    want, _ = je.transcribe(speech40[:16000 * 10], **kw)
    got, _ = te.transcribe(speech40[:16000 * 10], **kw)
    assert len(got) == len(want) and any(w.words for w in want)
    for g, w in zip(got, want):
        assert (g.seek, g.tokens, g.start, g.end) == (w.seek, w.tokens, w.start, w.end)
        assert [x.word for x in g.words] == [x.word for x in w.words]
        for gx, wx in zip(g.words, w.words):
            assert abs(gx.start - wx.start) <= 0.02 + 1e-9
            assert abs(gx.end - wx.end) <= 0.02 + 1e-9



def test_best_of_sampling_picks_a_candidate(engines_f32, speech40):
    _, te = engines_f32
    from ttasr_torch.engine.transcriber import TranscribeOptions

    enc = te.encode_windows(speech40[None, :16000 * 10])
    opts = TranscribeOptions(best_of=3, max_new_tokens=6)
    before = dict(te.decode_stats)
    tokens, avg_logprob, no_speech = te._decode_window(
        enc, [TOK.sot], opts, temperature=0.7)
    assert te.decode_stats["greedy_decodes"] == before["greedy_decodes"] + 1
    assert len(tokens) <= 6 and np.isfinite(avg_logprob)
    assert 0.0 <= no_speech <= 1.0
