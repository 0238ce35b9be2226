"""The s8 x s8 encoder on the CPU against the JAX package.

The JAX package takes the s8 x s8 encoder only on a TPU
(``model._use_fused_encoder_attention`` tests the backend), so its CPU
engine would silently run the float encoder.  The reference here is the
JAX encoder as the TPU runs it, on the CPU: the ``jax_act8`` fixture makes
``_use_fused_encoder_attention`` return ``dh == 64`` and runs the six
Pallas kernels of the path (``ln_quant``, ``add_ln_quant``, ``gelu_quant``,
``quant_only``, ``encoder_attention_merged_qkv``,
``encoder_attention_merged``) in interpret mode.  ``model.py`` looks them
up at call time, so the patches reach it; the JAX engine is built and
called inside that context (it jits ``encode`` per engine).

Weights: ``micro64-test`` (d 128, 2 heads of 64, 2+2 layers), quantized and
fused by the JAX package and carried over with ``params_from_jax``.

- ``encode``, fused-quant and unfused branches (and the fused-quant
  branch on separate q/k/v weights), bf16 activations: within
  2e-2 x max|ref| at the worst element (bf16 reassociation across two
  layers, as the bf16 encoder test in ``test_torch_engine.py``) and 1e-3 x
  max|ref| on average; each branch's kernels are counted (B5's two
  entries together, layer 0's ``ln_quant`` and the later layers'
  ``ln_quant_acc``; every int8 GEMM, whose accumulators go straight to
  ``qkv_epilogue_acc`` (the fused qkv leaf), ``add_ln_quant_acc`` (wo),
  ``gelu_quant_acc`` (W1) and ``ln_quant_acc`` (W2)).
- ``WhisperEngine(compute_type="int8")`` with its defaults against the JAX
  int8 engine, segment for segment at T=0 (tokens, text and times equal).
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
from ttasr.ops import encoder_attention_pallas as j_att
from ttasr.ops import encoder_fused_pallas as j_fused
from ttasr.ops.quant import fuse_qkv, quantize_params
from ttasr.text.tokenizer import build_byte_fallback_tokenizer
from ttasr_torch.engine.transcriber import WhisperEngine as TEngine
from ttasr_torch.models.whisper import model as tm
from ttasr_torch.models.whisper.config import PRESETS as T_PRESETS
from ttasr_torch.models.whisper.load import params_from_jax
from ttasr_torch.ops import encoder_fused as t_fused
from ttasr_torch.ops import quant as t_quant

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


def _interpreted(fn):
    """``fn`` with ``interpret=True`` whatever the caller passes
    (``model.py`` passes ``interpret=False`` explicitly)."""
    def run(*args, interpret=False, **kw):
        return fn(*args, interpret=True, **kw)
    return run


@pytest.fixture
def jax_act8(monkeypatch):
    monkeypatch.setattr(jm, "_use_fused_encoder_attention", lambda dh: dh == 64)
    for mod, names in ((j_fused, ("ln_quant", "add_ln_quant", "gelu_quant",
                                  "quant_only")),
                       (j_att, ("encoder_attention_merged_qkv",
                                "encoder_attention_merged"))):
        for name in names:
            monkeypatch.setattr(mod, name, _interpreted(getattr(mod, name)))


class _Calls:
    """Counts the port's encoder kernel wrappers and int8 GEMMs (the launch
    counters count only CUDA launches)."""

    def __init__(self, monkeypatch):
        self.n = {}
        for mod, name in ((t_fused, "ln_quant"), (t_fused, "ln_quant_acc"),
                          (t_fused, "add_ln_quant"), (t_fused, "add_ln_quant_acc"),
                          (t_fused, "gelu_quant"), (t_fused, "gelu_quant_acc"),
                          (t_fused, "quant_only"), (t_fused, "qkv_epilogue_acc"),
                          (tm, "encoder_attention_merged_qkv"),
                          (tm, "encoder_attention_merged"),
                          (t_quant, "_int8_product")):
            fn = getattr(mod, name)
            self.n[name] = 0

            def counted(*a, _fn=fn, _name=name, **kw):
                self.n[_name] += 1
                return _fn(*a, **kw)

            monkeypatch.setattr(mod, name, counted)


def _bf16_weights(fuse: bool):
    jcfg = J_PRESETS[NAME]
    jp = quantize_params(jm.init_params(jcfg, seed=0, dtype=jnp.bfloat16))
    if fuse:
        jp = fuse_qkv(jp)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), dtype=torch.bfloat16)
    mel = (np.random.default_rng(0).standard_normal((2, 80, 3000)) * 0.5
           ).astype(np.float32)
    return jp, tp, mel


@pytest.fixture(scope="module")
def bf16_weights():
    return _bf16_weights(fuse=True)


@pytest.mark.parametrize("fused_quant,fuse", [(None, True), (False, True), (None, False)],
                         ids=["fused", "unfused", "fused-separate-qkv"])
def test_act8_encode_matches_jax(jax_act8, monkeypatch, fused_quant, fuse):
    jp, tp, mel = _bf16_weights(fuse)
    jcfg, tcfg = J_PRESETS[NAME], T_PRESETS[NAME]
    want = np.asarray(jax.jit(lambda p, m: jm.encode(p, jcfg, m, fused_quant=fused_quant))(
        jp, mel), np.float32)
    calls = _Calls(monkeypatch)
    got = tm.encode(tp, tcfg, torch.from_numpy(mel), fused_quant=fused_quant)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    err = np.abs(got.float().numpy() - want)
    scale = np.abs(want).max()
    assert err.max() <= 2e-2 * scale, err.max()
    assert err.mean() <= 1e-3 * scale, err.mean()
    layers = tcfg.encoder_layers
    n = calls.n
    assert n["_int8_product"] == (4 if fuse else 6) * layers
    if fused_quant is None:
        assert n["ln_quant"] + n["ln_quant_acc"] == layers
        assert (n["ln_quant"], n["gelu_quant"], n["add_ln_quant"]) == (1, 0, 0)
        for name in ("gelu_quant_acc", "add_ln_quant_acc", "quant_only"):
            assert n[name] == layers, name
        # the qkv epilogue runs on the fused qkv leaf's accumulators
        assert n["qkv_epilogue_acc"] == (layers if fuse else 0)
        # B6 reads the fused qkv buffer; separate q/k/v leaves go to B11
        assert n["encoder_attention_merged_qkv"] == (layers if fuse else 0)
        assert n["encoder_attention_merged"] == (0 if fuse else layers)
    else:
        assert n["encoder_attention_merged"] == layers
        assert sum(n[k] for k in ("ln_quant", "ln_quant_acc", "add_ln_quant",
                                  "add_ln_quant_acc", "gelu_quant", "gelu_quant_acc",
                                  "quant_only", "qkv_epilogue_acc",
                                  "encoder_attention_merged_qkv")) == 0


def test_act8_encode_rules(bf16_weights):
    """The auto rule: act8 on quantized weights with 64-wide heads, float
    otherwise; forcing act8 where it cannot run raises."""
    jp, tp, mel = bf16_weights
    tcfg = T_PRESETS[NAME]
    m = torch.from_numpy(mel[:1, :, :400])
    auto = tm.encode(tp, tcfg, m)
    assert torch.equal(auto, tm.encode(tp, tcfg, m, act_int8=True))
    assert not torch.equal(auto, tm.encode(tp, tcfg, m, act_int8=False))
    # qkv_direct=False keeps the fused-quant kernels but slices q/k/v for B11
    indirect = tm.encode(tp, tcfg, m, qkv_direct=False)
    assert (indirect.float() - auto.float()).abs().max() <= 2e-2 * auto.float().abs().max()
    float_params = params_from_jax(jax.tree.map(np.asarray, jm.init_params(
        J_PRESETS[NAME], seed=0, dtype=jnp.bfloat16)), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="act_int8"):
        tm.encode(float_params, tcfg, m, act_int8=True)
    with pytest.raises(ValueError, match="act_int8"):
        tm.encode(tp, tcfg, m, act_int8=True, fused_attention=False)


def test_int8_engine_defaults_match_jax(jax_act8):
    """Same bf16 parameters in both engines (the served dtype), each
    quantizing and fusing its own; ``compute_type="int8"`` and nothing
    else, so the s8 x s8 encoder with the fused quantize kernels, then the
    flat int8/int4 decode.  bf16, not f32: the Pallas attention kernels
    round q and the probabilities to bf16 whatever their input type, while
    the port's plain attention keeps f32 inputs in f32, so f32 activations
    are not like for like there."""
    jcfg = J_PRESETS[NAME]
    jp = jm.init_params(jcfg, seed=0, dtype=jnp.bfloat16)
    je = JEngine(NAME, compute_type="int8", params=jp, config=jcfg, tokenizer=TOK)
    te = TEngine(NAME, compute_type="int8", params=params_from_jax(
        jax.tree.map(np.asarray, jp), dtype=torch.bfloat16),
        config=T_PRESETS[NAME], tokenizer=TOK, device="cpu")
    assert te._act8 is None and te._fused_quant is None
    blk = te.params["encoder"]["blocks"][0]
    assert "wqkv" in blk and blk["w1"]["q"].stride() == (1, blk["w1"]["q"].shape[0])
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
        assert g.avg_logprob == pytest.approx(w.avg_logprob, rel=1e-3)
        assert g.no_speech_prob == pytest.approx(w.no_speech_prob, rel=1e-2, abs=1e-6)
    assert te.decode_stats["encoder_passes"] == 2
    assert te.decode_stats["nonfinite_logits"] == 0
