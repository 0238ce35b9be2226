"""The two-stage logit-rules path (``TTASR_UNFUSED_RULES``, or
``DecodingOptions.unfused_rules``) in the port against the JAX package.

``_apply_rules`` on random logits and rule states that reach every branch;
``greedy_decode`` and ``beam_decode`` on the ``micro64-test`` preset with
the variable set for both packages, token for token, the port's
``_apply_rules`` spied as called once per step; values that disable the
variable leave the one-pass path.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ttasr.models.whisper import decode as jd
from ttasr.models.whisper import model as jm
from ttasr.models.whisper.config import PRESETS as J_PRESETS
from ttasr.text.tokenizer import build_byte_fallback_tokenizer
from ttasr_torch.models.whisper import decode as td
from ttasr_torch.models.whisper.config import PRESETS as T_PRESETS
from ttasr_torch.models.whisper.load import params_from_jax

TOK = build_byte_fallback_tokenizer()
NAME = "micro64-test"


@pytest.fixture(scope="module")
def setup():
    jcfg = J_PRESETS[NAME]
    jp = jm.init_params(jcfg, seed=0)
    tp = params_from_jax(jax.tree.map(np.asarray, jp))
    rng = np.random.default_rng(3)
    mel = (rng.standard_normal((2, 80, 3000)) * 0.5).astype(np.float32)
    enc = np.array(jm.encode(jp, jcfg, mel))
    prompts = [jd.build_prompt(TOK),
               jd.build_prompt(TOK, previous_tokens=list(range(40, 70)))]
    prompt, pad = jd.pad_prompts(prompts, TOK.eot)
    return dict(jp=jp, jcfg=jcfg, tp=tp, tcfg=T_PRESETS[NAME], enc=enc,
                prompt=prompt, pad=pad,
                jti=jd.TokenizerInfo.from_tokenizer(TOK, n_vocab=jcfg.vocab_size),
                tti=td.TokenizerInfo.from_tokenizer(TOK, n_vocab=jcfg.vocab_size))


def _rule_state(rng, n, ts0):
    """Per-row decode state covering every rule: rows with nothing sampled
    (suppress-blank, the first-token bound), one token, and two or more
    with every mix of timestamp and text for the last two."""
    n_sampled = rng.integers(0, 4, n).astype(np.int32)

    def pick():
        return np.where(rng.random(n) < 0.5, rng.integers(ts0, ts0 + 1500, n),
                        rng.integers(0, 256, n)).astype(np.int32)

    last, penult = pick(), pick()
    max_ts = np.where(rng.random(n) < 0.7, rng.integers(ts0, ts0 + 1500, n),
                      0).astype(np.int32)
    return n_sampled, last, penult, max_ts


@pytest.mark.parametrize("without_timestamps", [False, True])
@pytest.mark.parametrize("suppress_blank", [True, False])
def test_apply_rules_matches_jax(without_timestamps, suppress_blank):
    ti_j = jd.TokenizerInfo.from_tokenizer(TOK, n_vocab=TOK.vocab_size + 7)
    ti_t = td.TokenizerInfo.from_tokenizer(TOK, n_vocab=TOK.vocab_size + 7)
    kw = dict(without_timestamps=without_timestamps,
              suppress_blank=suppress_blank, max_initial_timestamp=0.5)
    rng = np.random.default_rng(17)
    n, v, ts0 = 96, ti_j.n_vocab, ti_j.timestamp_begin
    logits = (rng.standard_normal((n, v)) * 3).astype(np.float32)
    logits[::4, ts0:] += 6.0  # rows where the timestamp mass dominates
    n_sampled, last, penult, max_ts = _rule_state(rng, n, ts0)
    want = np.asarray(jd._apply_rules(
        jnp.asarray(logits), ti=ti_j, opts=jd.DecodingOptions(**kw),
        static_mask=jnp.asarray(jd._static_suppress_mask(ti_j)),
        n_sampled=jnp.asarray(n_sampled), last_tok=jnp.asarray(last),
        penult_tok=jnp.asarray(penult), max_ts_tok=jnp.asarray(max_ts)))
    t = lambda a: torch.from_numpy(a).long()  # noqa: E731
    got = td._apply_rules(
        torch.from_numpy(logits), ti=ti_t, opts=td.DecodingOptions(**kw),
        static_mask=torch.from_numpy(td._static_suppress_mask(ti_t)),
        n_sampled=t(n_sampled), last_tok=t(last), penult_tok=t(penult),
        max_ts_tok=t(max_ts)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    banned = want < -1e30
    if not without_timestamps:
        # each branch banned something: the first-token bound (every text
        # token), the probability-mass rule (every text token after the
        # first), the pairing rules (every timestamp, or all text)
        active = n_sampled > 0
        all_text = banned[:, :ts0].all(-1)
        all_ts = banned[:, ts0:].all(-1)
        assert all_text[~active].all()
        assert (all_text & active).any() and (all_ts & active).any()
        # monotonicity: where timestamps stay open, those below the last
        # one are banned
        mono = np.flatnonzero(active & (max_ts > ts0) & ~all_ts)
        assert len(mono)
        for r in mono:
            assert banned[r, ts0:max_ts[r]].all() and not banned[r, ts0:].all()


def _decode(s, fn, package, **kw):
    opts = dict(sample_len=48, **kw)
    if package == "jax":
        run = jd.beam_decode if fn == "beam" else jd.greedy_decode
        return run(s["jp"], s["jcfg"], s["enc"], s["prompt"], s["pad"],
                   jax.random.PRNGKey(0), opts=jd.DecodingOptions(**opts),
                   ti=s["jti"])
    run = td.beam_decode if fn == "beam" else td.greedy_decode
    return run(s["tp"], s["tcfg"], torch.from_numpy(s["enc"]), s["prompt"],
               s["pad"], opts=td.DecodingOptions(**opts), ti=s["tti"])


def _spy(monkeypatch):
    calls = {"two_stage": 0, "one_pass": 0}
    two, one = td._apply_rules, td._apply_rules_logprobs

    def two_stage(*a, **k):
        calls["two_stage"] += 1
        return two(*a, **k)

    def one_pass(*a, **k):
        calls["one_pass"] += 1
        return one(*a, **k)

    monkeypatch.setattr(td, "_apply_rules", two_stage)
    monkeypatch.setattr(td, "_apply_rules_logprobs", one_pass)
    return calls


@pytest.mark.parametrize("fn,kw", [("beam", dict(beam_size=5)),
                                   ("greedy", dict(beam_size=1))])
def test_env_unfused_rules_decode_matches_jax(setup, monkeypatch, fn, kw):
    monkeypatch.setenv("TTASR_UNFUSED_RULES", "1")
    jo = _decode(setup, fn, "jax", **kw)
    calls = _spy(monkeypatch)
    to = _decode(setup, fn, "torch", **kw)
    assert to["logits_finite"] and to["steps"] > 32
    assert calls == {"two_stage": to["steps"], "one_pass": 0}
    for row in range(2):
        n = int(np.asarray(jo["lengths"])[row])
        assert int(to["lengths"][row]) == n
        assert to["tokens"][row, :n].tolist() == np.asarray(jo["tokens"])[row, :n].tolist()
    np.testing.assert_allclose(to["sum_logprob"].numpy(),
                               np.asarray(jo["sum_logprob"]), rtol=1e-4)


@pytest.mark.parametrize("value", ["0", "false", "", "no"])
def test_env_values_that_disable_keep_the_one_pass_path(setup, monkeypatch, value):
    monkeypatch.setenv("TTASR_UNFUSED_RULES", value)
    assert not td._env_unfused_rules()
    calls = _spy(monkeypatch)
    to = _decode(setup, "beam", "torch", beam_size=2)
    assert calls == {"two_stage": 0, "one_pass": to["steps"]}


def test_opts_unfused_rules_runs_the_two_stage_path(setup, monkeypatch):
    monkeypatch.delenv("TTASR_UNFUSED_RULES", raising=False)
    assert not td._env_unfused_rules()
    calls = _spy(monkeypatch)
    two = _decode(setup, "greedy", "torch", beam_size=1, unfused_rules=True)
    assert calls == {"two_stage": two["steps"], "one_pass": 0}
    one = _decode(setup, "greedy", "torch", beam_size=1)
    assert calls["one_pass"] == one["steps"]
    # the two paths differ only by the probability-mass rule's arithmetic
    assert two["tokens"].tolist() == one["tokens"].tolist()


def test_env_truthiness_matches_jax(monkeypatch):
    for value in ("1", "true", "YES", " yes ", "on", "0", "false", "No", "", " "):
        monkeypatch.setenv("TTASR_UNFUSED_RULES", value)
        assert td._env_unfused_rules() == jd._env_unfused_rules(), value
    monkeypatch.delenv("TTASR_UNFUSED_RULES")
    assert not td._env_unfused_rules() and not jd._env_unfused_rules()
