"""The int8 serving decode on the CPU against the JAX package, token for
token at T=0.

Weights: ``micro64-test`` (d 128, 2 heads of 64, 2+2 layers), quantized and
fused by the JAX package and carried across with ``params_from_jax``.  With
every int8/int4 flag on, both packages run the flat fused path: B1 ->
B2 (beam, through the ancestry map) or B10 (greedy) -> B3 -> B4 per layer,
the JAX kernels in interpret mode and the port's through their plain
versions.  ``sample_len=40`` crosses the 32-token growth bucket, so the
cache and the ancestry map grow once.  The engine test holds the port's
``WhisperEngine(compute_type="int8", encoder_act_int8=False)`` against the
JAX engine with the same f32 parameters, segment for segment.
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
from ttasr.ops.quant import fuse_qkv, quantize_params
from ttasr.text.tokenizer import build_byte_fallback_tokenizer
from ttasr_torch.engine.transcriber import WhisperEngine as TEngine
from ttasr_torch.models.whisper import decode as td
from ttasr_torch.models.whisper import model as tm
from ttasr_torch.models.whisper.config import PRESETS as T_PRESETS
from ttasr_torch.models.whisper.load import params_from_jax

TOK = build_byte_fallback_tokenizer()
NAME = "micro64-test"
INT8 = dict(kv_int8=True, cross_kv_int8=True, cross_kv_int4=True, kv_int4=True)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The micro model's eager ops run faster on one thread, and the suite
    runs several workers to a machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    jcfg = J_PRESETS[NAME]
    jp = fuse_qkv(quantize_params(jm.init_params(jcfg, seed=0)))
    tp = params_from_jax(jax.tree.map(np.asarray, jp))
    mel = (np.random.default_rng(0).standard_normal((2, 80, 3000)) * 0.5
           ).astype(np.float32)
    enc = np.array(jm.encode(jp, jcfg, mel))
    prompts = [jd.build_prompt(TOK),
               jd.build_prompt(TOK, previous_tokens=list(range(40, 70)))]
    prompt, pad = jd.pad_prompts(prompts, TOK.eot)
    assert pad[0] != pad[1]
    return dict(jp=jp, jcfg=jcfg, tp=tp, tcfg=T_PRESETS[NAME], enc=enc,
                prompt=prompt, pad=pad,
                jti=jd.TokenizerInfo.from_tokenizer(TOK, n_vocab=jcfg.vocab_size),
                tti=td.TokenizerInfo.from_tokenizer(TOK, n_vocab=jcfg.vocab_size))


class _Calls:
    """Counts the kernel wrappers the port's decode calls (the launch
    counters count only CUDA launches)."""

    NAMES = ("qkv_int8_fused", "self_attn_step_indirect_int8",
             "self_attn_step_int8", "attnout_ln_q_cross_int8",
             "mlp_with_crossout_int8")

    def __init__(self, monkeypatch):
        self.n = dict.fromkeys(self.NAMES, 0)
        for name in self.NAMES:
            fn = getattr(td, name)

            def counted(*a, _fn=fn, _name=name, **kw):
                self.n[_name] += 1
                return _fn(*a, **kw)

            monkeypatch.setattr(td, name, counted)


def _decode(s, kind, monkeypatch, **kw):
    opts = dict(sample_len=40, **INT8, **kw)
    jfn, tfn = ((jd.beam_decode, td.beam_decode) if kind == "beam"
                else (jd.greedy_decode, td.greedy_decode))
    jo = jfn(s["jp"], s["jcfg"], s["enc"], s["prompt"], s["pad"],
             jax.random.PRNGKey(0), opts=jd.DecodingOptions(**opts), ti=s["jti"])
    calls = _Calls(monkeypatch)
    to = tfn(s["tp"], s["tcfg"], torch.from_numpy(s["enc"]), s["prompt"],
             s["pad"], opts=td.DecodingOptions(**opts), ti=s["tti"])
    assert to["steps"] > 32 and to["logits_finite"]
    for b in range(2):
        n = int(jo["lengths"][b])
        assert int(to["lengths"][b]) == n
        assert list(to["tokens"][b, :n].numpy()) == list(np.asarray(jo["tokens"])[b, :n]), b
    np.testing.assert_allclose(to["sum_logprob"].numpy(),
                               np.asarray(jo["sum_logprob"]), rtol=1e-4)
    np.testing.assert_allclose(to["no_speech_prob"].numpy(),
                               np.asarray(jo["no_speech_prob"]), rtol=1e-4,
                               atol=1e-7)
    return to, calls.n


@pytest.mark.parametrize("beam_size", [3, 5])
def test_int8_beam_decode_matches_jax(setup, monkeypatch, beam_size):
    to, n = _decode(setup, "beam", monkeypatch, beam_size=beam_size)
    layers = setup["tcfg"].decoder_layers
    # the fused path ran: four kernels per layer and step, B2 not B10
    assert n["qkv_int8_fused"] == n["attnout_ln_q_cross_int8"] \
        == n["mlp_with_crossout_int8"] == layers * to["steps"]
    assert n["self_attn_step_indirect_int8"] == layers * to["steps"]
    assert n["self_attn_step_int8"] == 0


def test_int8_greedy_decode_matches_jax(setup, monkeypatch):
    to, n = _decode(setup, "greedy", monkeypatch, beam_size=1)
    assert n["self_attn_step_int8"] == setup["tcfg"].decoder_layers * to["steps"]
    assert n["self_attn_step_indirect_int8"] == 0


def test_int8_decode_paths_off_the_slice_raise(setup):
    """Every branch runs: the decode's other branches
    (tests/test_torch_decode_branches.py), the unfused-rules A/B path
    (tests/test_torch_unfused_rules.py; here on the int8 cache), tensor
    parallelism with its axis bound to a process group
    (tests/test_torch_tp_decode.py) and raising without one."""
    s = setup
    args = (s["tp"], s["tcfg"], torch.from_numpy(s["enc"]), s["prompt"], s["pad"])
    for kw, what, error in ((dict(tp_axis="model"), "not bound", RuntimeError),
                            (dict(tp_row_parallel=True), "tp_row_parallel",
                             ValueError)):
        opts = td.DecodingOptions(**{**dict(sample_len=4, **INT8), **kw})
        for fn in (td.beam_decode, td.greedy_decode):
            with pytest.raises(error, match=what):
                fn(*args, opts=opts, ti=s["tti"])
    opts = td.DecodingOptions(sample_len=4, unfused_rules=True, **INT8)
    for fn in (td.beam_decode, td.greedy_decode):
        out = fn(*args, opts=opts, ti=s["tti"])
        assert out["steps"] > 0 and out["logits_finite"]


def test_int8_engine_transcribe_matches_jax():
    """Same f32 parameters in both engines (quantized by each package), beam
    5 at T=0 with VAD and prompt carry over two 30 s windows."""
    jcfg = J_PRESETS[NAME]
    jp = jm.init_params(jcfg, seed=0)
    je = JEngine(NAME, compute_type="int8", params=jp, config=jcfg,
                 tokenizer=TOK, encoder_act_int8=False)
    te = TEngine(NAME, compute_type="int8", params=params_from_jax(
        jax.tree.map(np.asarray, jp)), config=T_PRESETS[NAME], tokenizer=TOK,
        device="cpu", encoder_act_int8=False)
    assert te.kv_cache_int8 and te.cross_kv_int4 and te.kv_int4
    assert "wqkv" in te.params["decoder"]["blocks"][0]
    audio = np.concatenate([synth_speech(np.random.default_rng(s), 20.0)[0]
                            for s in (0, 1)])
    kw = dict(language="zh", beam_size=5, vad_filter=True,
              condition_on_previous_text=True, temperature=(0.0,),
              max_new_tokens=40)
    want, want_info = je.transcribe(audio, **kw)
    got, got_info = te.transcribe(audio, **kw)
    assert got_info.__dict__ == want_info.__dict__
    assert len(want) > 1 and len({s.seek for s in want}) > 1
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g.id, g.seek, g.tokens, g.text) == (w.id, w.seek, w.tokens, w.text)
        assert (g.start, g.end, g.temperature) == (w.start, w.end, w.temperature)
        assert g.avg_logprob == pytest.approx(w.avg_logprob, rel=1e-4)
        assert g.no_speech_prob == pytest.approx(w.no_speech_prob, rel=1e-3, abs=1e-8)
    assert te.decode_stats["beam_decodes"] == 2
    assert te.decode_stats["encoder_passes"] == 2
    # encoder_act_int8=False forced the float encoder on the int8 weights;
    # the default takes the s8 x s8 one (tests/test_torch_int8_encoder.py)
    assert te._act8 is False
    default = TEngine(NAME, compute_type="int8", params=te.params,
                      config=T_PRESETS[NAME], tokenizer=TOK, device="cpu")
    assert default._act8 is None and default._fused_quant is None


def test_int8_bf16_step_logits_within_bound(setup):
    """The served dtype: bf16 weights quantized to int8 (as the engine loads
    large-v3), the fused step through B1/B10/B3/B4, against JAX's fused step
    in interpret mode.  Held to the bound the JAX package recorded for bf16
    reassociation (PERF_NOTES "TPU numeric parity": step logits within
    1.4 % of max, argmax agreement), as the bf16 float path is."""
    jcfg = setup["jcfg"]
    jq = fuse_qkv(quantize_params(jm.init_params(jcfg, seed=1, dtype=jnp.bfloat16)))
    tq = td._f32_decoder_vectors(params_from_jax(
        jax.tree.map(np.asarray, jq), dtype=torch.bfloat16))
    enc = jnp.asarray(setup["enc"][:1], jnp.bfloat16)
    prompt, pad = jd.pad_prompts([jd.build_prompt(TOK)], TOK.eot)
    flags = dict(max_len=prompt.shape[1] + 8, kv_int8=True, cross_kv_int8=True,
                 cross_kv_int4=True, flat_kv=True, kv_int4=True)
    jcache = jm.init_cache(jq, jcfg, enc, **flags)
    hj, jcache = jd._prefill(jq, jcfg, prompt, pad, jcache, s_real=1500)
    tcache = tm.init_cache(tq, setup["tcfg"],
                           torch.from_numpy(np.asarray(enc, np.float32)).bfloat16(),
                           **flags)
    tp_, tpad = (torch.from_numpy(x).long() for x in (prompt, pad))
    ht, tcache = td._prefill(tq, setup["tcfg"], tp_, tpad, tcache, s_real=1500)
    steps = [(np.asarray(jd._logits_at(jq, hj[:, -1]), np.float32),
              td._logits_at(tq, ht[:, -1]).numpy())]
    for i, tok in enumerate([TOK.timestamp_begin, 200, 201, TOK.timestamp_begin + 50]):
        slot = prompt.shape[1] + i
        lj, jcache = jd._step(jq, jcfg, np.array([[tok]], np.int32), slot, pad,
                              jcache, s_real=1500)
        lt, tcache = td._step(tq, setup["tcfg"], torch.tensor([[tok]]), slot,
                              tpad, tcache, s_real=1500)
        steps.append((np.asarray(lj, np.float32), lt.numpy()))
    assert tcache.self_int4 and tcache.cross_k.dtype == torch.uint8
    for lj, lt in steps:
        assert np.abs(lt - lj).max() <= 1.4e-2 * np.abs(lj).max()
        assert lt.argmax(-1) == lj.argmax(-1)
