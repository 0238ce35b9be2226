"""The kernels of the decode's other single-card branches (B12, B13, B17):
their plain versions against the JAX Pallas kernels run with
``interpret=True`` on the same seeded numpy inputs; and the two engine
calls that reach those branches, segment for segment against the JAX
engine.  The CUDA kernels themselves run only on the card, where
``chip_smoke.py`` holds each against the same plain version.

Float outputs are held to ``FLOAT_REL`` x max|JAX|, as the other decode
kernels (``tests/test_torch_decoder_kernels.py``): both sides round to bf16
at the same points (the LN output, the queries, the scale-folded
probabilities) and take exact f32 products of bf16 values and int codes,
with f32 sums in another order.  B17 is a copy: equal byte for byte.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tools.train_vad import synth_speech
from ttasr.engine.transcriber import WhisperEngine as JEngine
from ttasr.models.whisper import model as jm
from ttasr.models.whisper.config import PRESETS as J_PRESETS
from ttasr.ops import beam_gather_pallas as jbg
from ttasr.ops import cross_attention_pallas as jca
from ttasr.ops import decoder_blocks_pallas as jblk
from ttasr.ops.int4 import pack_int4
from ttasr.ops.quant import quantize_kv_sym, quantize_tensor
from ttasr.text.tokenizer import build_byte_fallback_tokenizer
from ttasr_torch.engine.transcriber import WhisperEngine as TEngine
from ttasr_torch.models.whisper import decode as td
from ttasr_torch.models.whisper.config import PRESETS as T_PRESETS
from ttasr_torch.models.whisper.load import params_from_jax
from ttasr_torch.ops import beam_gather as tbg
from ttasr_torch.ops import cross_attention as tca
from ttasr_torch.ops import decoder_blocks as tblk

FLOAT_REL = 2e-3
TOK = build_byte_fallback_tokenizer()
NAME = "micro64-test"


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, rel=FLOAT_REL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), (err, np.abs(want).max())


def _weight(rng, shape, scale=0.05):
    w = quantize_tensor((rng.standard_normal(shape) * scale).astype(np.float32))
    return np.asarray(w["q"]), np.asarray(w["s"])


def _vec(rng, n, scale=0.02, offset=0.0):
    return (rng.standard_normal(n) * scale + offset).astype(np.float32)


# ---------------------------------------------------------------------------
# B12: attention out-projection + LNc + cross-q
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("r,dc", [(5, 256), (10, 256), (10, 128)])
def test_attnout_ln_q_fused_matches_pallas(r, dc):
    rng = np.random.default_rng(100 + r + dc)
    d = 256
    x = (rng.standard_normal((r, d)) * 0.3).astype(np.float32)
    attn = (rng.standard_normal((r, d)) * 0.3).astype(np.float32)
    wo, wo_s = _weight(rng, (d, d))
    wqc, wqc_s = _weight(rng, (d, dc))
    args = (x, attn, wo, wo_s, _vec(rng, d), _vec(rng, d, 0.1, 1.0),
            _vec(rng, d, 0.1), wqc, wqc_s, _vec(rng, dc))
    xo_j, qc_j = jblk.attnout_ln_q_fused(*map(jnp.asarray, args), interpret=True)
    xo_t, qc_t = tblk.attnout_ln_q_fused(*map(_t, args))
    assert xo_t.shape == (r, d) and qc_t.shape == (r, dc)
    assert xo_t.dtype == qc_t.dtype == torch.float32
    _close(xo_t, xo_j)
    _close(qc_t, qc_j)


# ---------------------------------------------------------------------------
# B13: standalone int8/int4 cross-attention
# ---------------------------------------------------------------------------

def _cross_cache(rng, b, h, s, s_real, int4):
    d = h * 64
    codes, scales = [], []
    for _ in range(2):
        kv = (rng.standard_normal((b, s, h, 64)) * 0.5).astype(np.float32)
        kv[:, s_real:] = 0.0  # padding slots, as init_cache pads them
        c, sc = quantize_kv_sym(jnp.asarray(kv), 7 if int4 else 127)
        c = jnp.asarray(c).reshape(b, s, d)
        codes.append(np.asarray(pack_int4(c) if int4 else c))
        scales.append(np.ascontiguousarray(np.swapaxes(np.asarray(sc), 1, 2)))
    return codes[0], scales[0], codes[1], scales[1]


@pytest.mark.parametrize("k", [1, 5, 8])
@pytest.mark.parametrize("int4", [False, True])
def test_cross_attention_int8_matches_pallas(k, int4):
    rng = np.random.default_rng(10 * k + int4)
    b, h, s, s_real = 2, 4, 48, 45
    q = (rng.standard_normal((b, k, h, 64)) * 0.5).astype(np.float32)
    ck, cks, cv, cvs = _cross_cache(rng, b, h, s, s_real, int4)
    want = jca.cross_attention_int8(jnp.asarray(q), ck, cks, cv, cvs, s_real,
                                    interpret=True)
    got = tca.cross_attention_int8(*map(_t, (q, ck, cks, cv, cvs)), s_real)
    assert got.shape == (b, k, h, 64) and got.dtype == torch.float32
    _close(got, want)


def test_cross_attention_int8_scales_bf16_queries_in_bf16():
    """The served dtype: bf16 queries are scaled by dh**-0.5 in bf16 before
    the kernel, as the reference does; the result is f32."""
    rng = np.random.default_rng(7)
    b, k, h, s, s_real = 1, 5, 2, 32, 30
    q = jnp.asarray(rng.standard_normal((b, k, h, 64)) * 0.5, jnp.bfloat16)
    ck, cks, cv, cvs = _cross_cache(rng, b, h, s, s_real, True)
    want = jca.cross_attention_int8(q, ck, cks, cv, cvs, s_real, interpret=True)
    qt = torch.from_numpy(np.asarray(q, np.float32)).bfloat16()
    got = tca.cross_attention_int8(qt, *map(_t, (ck, cks, cv, cvs)), s_real)
    assert got.dtype == torch.float32
    _close(got, want)


# ---------------------------------------------------------------------------
# B17: beam-reorder gather of the flat cache
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("int4", [False, True])
def test_gather_cache_rows_matches_pallas_bit_for_bit(int4):
    rng = np.random.default_rng(3 + int4)
    n_layers, bk, t, d, hp = 3, 6, 24, 128, 8
    dtype = np.uint8 if int4 else np.int8
    info = np.iinfo(dtype)
    k, v = (rng.integers(info.min, info.max + 1, (n_layers, bk, t, d // 2 if int4 else d)
                         ).astype(dtype) for _ in range(2))
    ks, vs = (rng.standard_normal((n_layers, bk, hp, t)).astype(np.float32)
              for _ in range(2))
    idx = np.array([2, 2, 0, 5, 1, 3], np.int32)  # a repeat, a drop, a move
    want = jbg.gather_cache_rows(*map(jnp.asarray, (k, v, ks, vs, idx)),
                                 interpret=True)
    got = tbg.gather_cache_rows(*map(_t, (k, v, ks, vs, idx)))
    spare = tuple(torch.full_like(g, 7) for g in got)
    into = tbg.gather_cache_rows(*map(_t, (k, v, ks, vs, idx)), out=spare)
    assert all(a is b for a, b in zip(into, spare))
    for g, o, w in zip(got, into, want):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype
        assert g.numpy().tobytes() == w.tobytes()
        assert o.numpy().tobytes() == w.tobytes()


def test_branch_wrappers_reject_other_devices():
    x = torch.zeros((2, 128), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        tblk.attnout_ln_q_fused(x, x, x, x, x, x, x, x, x, x)
    q = torch.zeros((1, 2, 2, 64), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        tca.cross_attention_int8(q, x, x, x, x, 1)
    kv = torch.zeros((1, 2, 4, 64), dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        tbg.gather_cache_rows(kv, kv, x, x, torch.zeros(2))


# ---------------------------------------------------------------------------
# The engine calls that reach the branches
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def speech():
    return synth_speech(np.random.default_rng(0), 20.0)[0]


def _count_calls(monkeypatch, *names):
    """Counts the calls of ``td.<name>`` during the test."""
    n = dict.fromkeys(names, 0)
    for name in names:
        fn = getattr(td, name)

        def counted(*a, _fn=fn, _name=name, **kw):
            n[_name] += 1
            return _fn(*a, **kw)

        monkeypatch.setattr(td, name, counted)
    return n


def _same_segments(je, te, audio, **kw):
    kw = dict(language="zh", vad_filter=True, condition_on_previous_text=True,
              temperature=(0.0,), **kw)
    want, want_info = je.transcribe(audio, **kw)
    got, got_info = te.transcribe(audio, **kw)
    assert got_info.__dict__ == want_info.__dict__
    assert len(want) >= 1 and len(got) == len(want)
    for g, w in zip(got, want):
        assert (g.id, g.seek, g.tokens, g.text) == (w.id, w.seek, w.tokens, w.text)
        assert (g.start, g.end, g.temperature) == (w.start, w.end, w.temperature)
        assert g.avg_logprob == pytest.approx(w.avg_logprob, rel=1e-4)
        assert g.no_speech_prob == pytest.approx(w.no_speech_prob, rel=1e-3, abs=1e-8)
    assert te.decode_stats["beam_decodes"] >= 1
    assert te.decode_stats["nonfinite_logits"] == 0


def test_bf16_engine_with_int8_self_kv_matches_jax(speech, monkeypatch):
    """``compute_type="bfloat16"`` with ``kv_cache_int8=True``: the 5-D
    int8 self-KV beside a float cross-KV (the same f32 parameters in both
    engines, so that the comparison is exact; the compute type picks the
    cache flags)."""
    jcfg = J_PRESETS[NAME]
    jp = jm.init_params(jcfg, seed=0)
    je = JEngine(NAME, compute_type="bfloat16", params=jp, config=jcfg,
                 tokenizer=TOK)
    te = TEngine(NAME, compute_type="bfloat16", params=params_from_jax(
        jax.tree.map(np.asarray, jp)), config=T_PRESETS[NAME], tokenizer=TOK,
        device="cpu")
    n = _count_calls(monkeypatch, "_quant_self_attention", "qkv_int8_fused")
    _same_segments(je, te, speech, beam_size=5, kv_cache_int8=True,
                   max_new_tokens=24)
    steps = te.decode_stats["beam_steps"] + te.decode_stats["greedy_steps"]
    assert n["_quant_self_attention"] == te.cfg.decoder_layers * steps > 0
    assert n["qkv_int8_fused"] == 0


def test_int8_engine_with_ten_beams_matches_jax(speech, monkeypatch):
    """``compute_type="int8"`` with ``beam_size=10``: more than 8 beams per
    audio, so B12 and the XLA cross-attention branch over the int4
    cross-KV take B3's place (the float encoder on the int8 weights, as
    the JAX engine runs on the CPU)."""
    jcfg = J_PRESETS[NAME]
    jp = jm.init_params(jcfg, seed=1)
    je = JEngine(NAME, compute_type="int8", params=jp, config=jcfg,
                 tokenizer=TOK, encoder_act_int8=False)
    te = TEngine(NAME, compute_type="int8", params=params_from_jax(
        jax.tree.map(np.asarray, jp)), config=T_PRESETS[NAME], tokenizer=TOK,
        device="cpu", encoder_act_int8=False)
    n = _count_calls(monkeypatch, "attnout_ln_q_fused", "attnout_ln_q_cross_int8",
                     "cross_attention_int8")
    _same_segments(je, te, speech, beam_size=10, max_new_tokens=24)
    steps = te.decode_stats["beam_steps"] + te.decode_stats["greedy_steps"]
    assert n["attnout_ln_q_fused"] == te.cfg.decoder_layers * steps > 0
    assert n["attnout_ln_q_cross_int8"] == n["cross_attention_int8"] == 0
