"""The port's decoding against the JAX package at T=0, token for token.

Weights: the ``micro64-test`` preset, shared through ``params_from_jax``.
Two windows with prompts of different pad decode together, with
``sample_len`` > 32 so the cache crosses a growth bucket.  Logit rules are
checked on random logits with random timestamp state.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ttasr.models.whisper import decode as jd
from ttasr.models.whisper import model as jm
from ttasr.models.whisper.config import PRESETS as J_PRESETS
from ttasr.models.whisper.config import WhisperConfig as JConfig
from ttasr.text.tokenizer import build_byte_fallback_tokenizer
from ttasr_torch.models.whisper import decode as td
from ttasr_torch.models.whisper import model as tm
from ttasr_torch.models.whisper.config import PRESETS as T_PRESETS
from ttasr_torch.models.whisper.config import WhisperConfig as TConfig
from ttasr_torch.models.whisper.load import params_from_jax

TOK = build_byte_fallback_tokenizer()


@pytest.fixture(scope="module")
def setup():
    jcfg = J_PRESETS["micro64-test"]
    jp = jm.init_params(jcfg, seed=0)
    tp = params_from_jax(jax.tree.map(np.asarray, jp))
    rng = np.random.default_rng(0)
    mel = (rng.standard_normal((2, 80, 3000)) * 0.5).astype(np.float32)
    enc = np.array(jm.encode(jp, jcfg, mel))
    jti = jd.TokenizerInfo.from_tokenizer(TOK, n_vocab=jcfg.vocab_size)
    tti = td.TokenizerInfo.from_tokenizer(TOK, n_vocab=jcfg.vocab_size)
    # two prompts of different pad: a bare sot sequence and a carried one
    prompts = [jd.build_prompt(TOK),
               jd.build_prompt(TOK, previous_tokens=list(range(40, 70)))]
    prompt, pad = jd.pad_prompts(prompts, TOK.eot)
    assert pad[0] != pad[1]
    return jp, jcfg, tp, T_PRESETS["micro64-test"], enc, jti, tti, prompt, pad


def _np(out):
    return {k: np.asarray(v) for k, v in out.items()
            if k in ("tokens", "lengths", "sum_logprob", "no_speech_prob")}


def _assert_same(jo, to):
    jo, to = _np(jo), _np({k: v for k, v in to.items()})
    for b in range(jo["lengths"].shape[0]):
        n = int(jo["lengths"][b])
        assert int(to["lengths"][b]) == n
        assert list(to["tokens"][b, :n]) == list(jo["tokens"][b, :n]), b
    np.testing.assert_allclose(to["sum_logprob"], jo["sum_logprob"], rtol=1e-4)
    np.testing.assert_allclose(to["no_speech_prob"], jo["no_speech_prob"],
                               rtol=1e-4, atol=1e-7)


@pytest.mark.parametrize("beam_size", [2, 5])
def test_beam_decode_matches_jax(setup, beam_size):
    jp, jcfg, tp, tcfg, enc, jti, tti, prompt, pad = setup
    kw = dict(sample_len=48, beam_size=beam_size)
    jo = jd.beam_decode(jp, jcfg, enc, prompt, pad, jax.random.PRNGKey(0),
                        opts=jd.DecodingOptions(**kw), ti=jti)
    to = td.beam_decode(tp, tcfg, torch.from_numpy(enc), prompt, pad,
                        opts=td.DecodingOptions(**kw), ti=tti)
    assert to["steps"] > 32 and to["logits_finite"]
    _assert_same(jo, to)


@pytest.mark.parametrize("without_timestamps", [False, True])
def test_greedy_decode_matches_jax(setup, without_timestamps):
    jp, jcfg, tp, tcfg, enc, jti, tti, prompt, pad = setup
    kw = dict(sample_len=48, without_timestamps=without_timestamps)
    jo = jd.greedy_decode(jp, jcfg, enc, prompt, pad, jax.random.PRNGKey(0),
                          opts=jd.DecodingOptions(**kw), ti=jti)
    to = td.greedy_decode(tp, tcfg, torch.from_numpy(enc), prompt, pad,
                          opts=td.DecodingOptions(**kw), ti=tti)
    assert to["steps"] > 32 and to["logits_finite"]
    _assert_same(jo, to)


def test_prefill_hidden_matches_jax(setup):
    jp, jcfg, tp, tcfg, enc, jti, tti, prompt, pad = setup
    jcache = jm.init_cache(jp, jcfg, enc, max_len=prompt.shape[1] + 8)
    want, jcache = jd._prefill(jp, jcfg, prompt, pad, jcache)
    tcache = tm.init_cache(tp, tcfg, torch.from_numpy(enc),
                           max_len=prompt.shape[1] + 8)
    got, tcache = td._prefill(tp, tcfg, torch.from_numpy(prompt).long(),
                              torch.from_numpy(pad).long(), tcache)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    token = np.array([[TOK.sot], [300]], np.int32)
    slot = prompt.shape[1]
    want_l, _ = jd._step(jp, jcfg, token, slot, pad, jcache)
    got_l, _ = td._step(tp, tcfg, torch.from_numpy(token).long(), slot,
                        torch.from_numpy(pad).long(), tcache)
    scale = np.abs(np.asarray(want_l)).max()
    assert np.abs(got_l.numpy() - np.asarray(want_l)).max() < 1e-4 * scale


@pytest.mark.parametrize("without_timestamps", [False, True])
@pytest.mark.parametrize("suppress_blank", [True, False])
def test_apply_rules_logprobs_matches_jax(without_timestamps, suppress_blank):
    ti_j = jd.TokenizerInfo.from_tokenizer(TOK, n_vocab=TOK.vocab_size + 7)
    ti_t = td.TokenizerInfo.from_tokenizer(TOK, n_vocab=TOK.vocab_size + 7)
    kw = dict(without_timestamps=without_timestamps,
              suppress_blank=suppress_blank, max_initial_timestamp=0.5)
    jo, to = jd.DecodingOptions(**kw), td.DecodingOptions(**kw)
    rng = np.random.default_rng(11)
    n, v, ts0 = 64, ti_j.n_vocab, ti_j.timestamp_begin
    logits = (rng.standard_normal((n, v)) * 3).astype(np.float32)
    logits[::4, ts0:] += 6.0  # rows where the timestamp mass dominates
    n_sampled = rng.integers(0, 4, n).astype(np.int32)
    pick = lambda: np.where(rng.random(n) < 0.5,  # noqa: E731
                            rng.integers(ts0, ts0 + 1500, n),
                            rng.integers(0, 256, n)).astype(np.int32)
    last, penult = pick(), pick()
    max_ts = np.where(rng.random(n) < 0.7, rng.integers(ts0, ts0 + 1500, n),
                      0).astype(np.int32)
    want = np.asarray(jd._apply_rules_logprobs(
        jnp.asarray(logits), ti=ti_j, opts=jo,
        static_mask=jnp.asarray(jd._static_suppress_mask(ti_j)),
        n_sampled=jnp.asarray(n_sampled), last_tok=jnp.asarray(last),
        penult_tok=jnp.asarray(penult), max_ts_tok=jnp.asarray(max_ts)))
    t = lambda a: torch.from_numpy(a).long()  # noqa: E731
    got = td._apply_rules_logprobs(
        torch.from_numpy(logits), ti=ti_t, opts=to,
        static_mask=torch.from_numpy(td._static_suppress_mask(ti_t)),
        n_sampled=t(n_sampled), last_tok=t(last), penult_tok=t(penult),
        max_ts_tok=t(max_ts)).numpy()
    banned_j, banned_t = want < -1e30, got < -1e30
    np.testing.assert_array_equal(banned_t, banned_j)
    np.testing.assert_allclose(got[~banned_j], want[~banned_j],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def test_pad_vocab_ids_suppressed():
    """A head wider than the tokenizer's id space: the padding ids are
    banned by the static mask and never emitted (same setup as the JAX
    test_decode.py::test_pad_vocab_ids_suppressed)."""
    n_vocab = TOK.vocab_size + 512
    ti = td.TokenizerInfo.from_tokenizer(TOK, n_vocab=n_vocab)
    assert ti.pad_vocab_begin == max(TOK.vocab_size, TOK.timestamp_begin + 1501)
    mask = td._static_suppress_mask(ti)
    assert (mask[ti.pad_vocab_begin:] < -1e30).all()
    assert mask[ti.timestamp_begin] == 0.0
    jcfg = JConfig(name="t", vocab_size=n_vocab, num_mel_bins=80, d_model=64,
                   encoder_layers=2, encoder_heads=4, decoder_layers=2,
                   decoder_heads=4, ffn_dim=128, max_source_positions=32)
    jp = jm.init_params(jcfg, seed=0)
    tp = params_from_jax(jax.tree.map(np.asarray, jp))
    tcfg = TConfig(**dataclasses.asdict(jcfg))
    enc = np.random.default_rng(0).standard_normal(
        (2, 32, 64)).astype(np.float32)
    prompt, pad = td.pad_prompts([[ti.sot]] * 2, ti.eot, width=16)
    opts = dict(beam_size=3, sample_len=12)
    to = td.beam_decode(tp, tcfg, torch.from_numpy(enc), prompt, pad,
                        opts=td.DecodingOptions(**opts), ti=ti)
    for row, n in zip(to["tokens"].numpy(), to["lengths"].numpy()):
        assert (row[:n] < ti.pad_vocab_begin).all(), row[:n]
    jti = jd.TokenizerInfo.from_tokenizer(TOK, n_vocab=n_vocab)
    jo = jd.beam_decode(jp, jcfg, enc, prompt, pad, jax.random.PRNGKey(0),
                        opts=jd.DecodingOptions(**opts), ti=jti)
    _assert_same(jo, to)


def test_sampling_is_seeded_and_in_vocab(setup):
    _, _, tp, tcfg, enc, _, tti, prompt, pad = setup
    opts = td.DecodingOptions(sample_len=12)

    def run(seed):
        gen = torch.Generator().manual_seed(seed)
        return td.greedy_decode(tp, tcfg, torch.from_numpy(enc), prompt, pad,
                                gen, 0.7, opts=opts, ti=tti)

    a, b = run(1), run(1)
    torch.testing.assert_close(a["tokens"], b["tokens"], rtol=0, atol=0)
    assert (a["tokens"] < tti.n_vocab).all()
    with pytest.raises(ValueError):
        td.greedy_decode(tp, tcfg, torch.from_numpy(enc), prompt, pad, None,
                         0.7, opts=opts, ti=tti)


def test_unported_options_raise(setup):
    _, _, tp, tcfg, enc, _, tti, prompt, pad = setup
    for flag in ("kv_int8", "cross_kv_int8", "unfused_rules"):
        opts = td.DecodingOptions(sample_len=4, **{flag: True})
        with pytest.raises(NotImplementedError):
            td.beam_decode(tp, tcfg, torch.from_numpy(enc), prompt, pad,
                           opts=opts, ti=tti)
