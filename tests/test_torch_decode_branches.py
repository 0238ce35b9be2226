"""The decode's other single-card branches on the CPU against the JAX
package, token for token at T=0.

Weights: ``micro64-test`` (d 128, 2 heads of 64, 2+2 layers), quantized by
the JAX package (with ``fuse_qkv`` for the flat fused path, without it for
the unfused int8 graph) and carried across with ``params_from_jax``.  The
JAX Pallas kernels run in interpret mode, the port's through their plain
versions.  ``growth_min_cap=8`` with ``sample_len=12`` crosses a growth
bucket, so caches, scales and the ancestry map grow once.

- (a) the flat fused path with a bf16 cross-KV: B12 ``attnout_ln_q_fused``
  where B3 ran, the cross-attention outside the kernel;
- (b) more than 8 beams: B12 and the quantized cross-attention's XLA
  branch over the int4 cross-KV;
- (c) ``beam_indirect=False``: B10 for the beam rows and B17
  ``gather_cache_rows`` after each top-k, equal to JAX and to the port's
  own run through the ancestry map;
- (d) the unfused int8 graph: the 5-D int8 self-KV, the plain quantized
  self-attention and B13 ``cross_attention_int8``;
- fused int8 weights over the 5-D int8 cache (``micro-test``, heads 16
  wide, where the flat layout does not apply): the plain layer loop,
  equal to the reference's fused scan.

Each case also counts the kernel wrappers the port's decode called.
"""

import jax
import numpy as np
import pytest
import torch

from ttasr.models.whisper import decode as jd
from ttasr.models.whisper import model as jm
from ttasr.models.whisper.config import PRESETS as J_PRESETS
from ttasr.ops.quant import fuse_qkv, quantize_params
from ttasr.text.tokenizer import build_byte_fallback_tokenizer
from ttasr_torch.models.whisper import decode as td
from ttasr_torch.models.whisper import model as tm
from ttasr_torch.models.whisper.config import PRESETS as T_PRESETS
from ttasr_torch.models.whisper.load import params_from_jax

TOK = build_byte_fallback_tokenizer()
INT8 = dict(kv_int8=True, cross_kv_int8=True, cross_kv_int4=True, kv_int4=True)
SHORT = dict(sample_len=12, growth_min_cap=8)
KERNELS = ("qkv_int8_fused", "self_attn_step_indirect_int8",
           "self_attn_step_int8", "attnout_ln_q_cross_int8",
           "attnout_ln_q_fused", "mlp_with_crossout_int8",
           "cross_attention_int8", "gather_cache_rows")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The micro model's eager ops run faster on one thread, and the suite
    runs several workers to a machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(name):
    jcfg = J_PRESETS[name]
    jq = quantize_params(jm.init_params(jcfg, seed=0))
    jf = fuse_qkv(jq)
    mel = (np.random.default_rng(0).standard_normal((2, 80, 3000)) * 0.5
           ).astype(np.float32)
    enc = np.array(jm.encode(jf, jcfg, mel))
    prompts = [jd.build_prompt(TOK),
               jd.build_prompt(TOK, previous_tokens=list(range(40, 70)))]
    prompt, pad = jd.pad_prompts(prompts, TOK.eot)
    assert pad[0] != pad[1]
    return dict(
        jcfg=jcfg, tcfg=T_PRESETS[name], enc=enc, prompt=prompt, pad=pad,
        params={"fused": (jf, params_from_jax(jax.tree.map(np.asarray, jf))),
                "unfused": (jq, params_from_jax(jax.tree.map(np.asarray, jq)))},
        jti=jd.TokenizerInfo.from_tokenizer(TOK, n_vocab=jcfg.vocab_size),
        tti=td.TokenizerInfo.from_tokenizer(TOK, n_vocab=jcfg.vocab_size))


@pytest.fixture(scope="module")
def setup():
    return _setup("micro64-test")


class _Calls:
    """Counts the kernel wrappers the port's decode calls (the launch
    counters count only CUDA launches)."""

    def __init__(self, monkeypatch):
        self.n = dict.fromkeys(KERNELS, 0)
        for name in KERNELS:
            fn = getattr(td, name)

            def counted(*a, _fn=fn, _name=name, **kw):
                self.n[_name] += 1
                return _fn(*a, **kw)

            monkeypatch.setattr(td, name, counted)


def _run_port(s, kind, graph, opts, monkeypatch=None):
    calls = _Calls(monkeypatch) if monkeypatch is not None else None
    fn = td.beam_decode if kind == "beam" else td.greedy_decode
    out = fn(s["params"][graph][1], s["tcfg"], torch.from_numpy(s["enc"]),
             s["prompt"], s["pad"], opts=td.DecodingOptions(**opts), ti=s["tti"])
    if calls is not None:
        monkeypatch.undo()
    return out, (calls.n if calls is not None else None)


def _same_tokens(to, jo):
    for b in range(2):
        n = int(jo["lengths"][b])
        assert int(to["lengths"][b]) == n
        assert list(to["tokens"][b, :n].numpy()) == list(np.asarray(jo["tokens"])[b, :n]), b


def _decode(s, kind, graph, monkeypatch, **kw):
    opts = dict(**SHORT, **kw)
    jfn = jd.beam_decode if kind == "beam" else jd.greedy_decode
    jo = jfn(s["params"][graph][0], s["jcfg"], s["enc"], s["prompt"], s["pad"],
             jax.random.PRNGKey(0), opts=jd.DecodingOptions(**opts), ti=s["jti"])
    to, n = _run_port(s, kind, graph, opts, monkeypatch)
    assert to["steps"] > SHORT["growth_min_cap"] and to["logits_finite"]
    _same_tokens(to, jo)
    np.testing.assert_allclose(to["sum_logprob"].numpy(),
                               np.asarray(jo["sum_logprob"]), rtol=1e-4)
    np.testing.assert_allclose(to["no_speech_prob"].numpy(),
                               np.asarray(jo["no_speech_prob"]), rtol=1e-4,
                               atol=1e-7)
    return to, n


@pytest.mark.parametrize("kind", ["beam", "greedy"])
def test_flat_path_with_bf16_cross_kv_runs_b12(setup, monkeypatch, kind):
    to, n = _decode(setup, kind, "fused", monkeypatch,
                    **dict(INT8, cross_kv_int8=False),
                    beam_size=3 if kind == "beam" else 1)
    layers = setup["tcfg"].decoder_layers
    assert n["attnout_ln_q_fused"] == n["qkv_int8_fused"] \
        == n["mlp_with_crossout_int8"] == layers * to["steps"]
    assert n["attnout_ln_q_cross_int8"] == n["cross_attention_int8"] == 0
    self_kernel = ("self_attn_step_indirect_int8" if kind == "beam"
                   else "self_attn_step_int8")
    assert n[self_kernel] == layers * to["steps"]


def test_flat_path_with_nine_beams_runs_b12(setup, monkeypatch):
    to, n = _decode(setup, "beam", "fused", monkeypatch, **INT8, beam_size=9)
    layers = setup["tcfg"].decoder_layers
    assert n["attnout_ln_q_fused"] == n["self_attn_step_indirect_int8"] \
        == layers * to["steps"]
    # more than 8 beams: the cross-attention takes the XLA branch, not B13
    assert n["attnout_ln_q_cross_int8"] == n["cross_attention_int8"] == 0


def test_beam_without_ancestry_map_runs_b17(setup, monkeypatch):
    to, n = _decode(setup, "beam", "fused", monkeypatch, **INT8, beam_size=3,
                    beam_indirect=False)
    layers = setup["tcfg"].decoder_layers
    assert n["gather_cache_rows"] == to["steps"]  # one gather per top-k
    assert n["self_attn_step_int8"] == layers * to["steps"]
    assert n["self_attn_step_indirect_int8"] == 0
    assert n["attnout_ln_q_cross_int8"] == layers * to["steps"]
    # the physical copy and the ancestry map pick the same tokens
    indirect, _ = _run_port(setup, "beam", "fused",
                            dict(**SHORT, **INT8, beam_size=3))
    for key in ("tokens", "lengths"):
        torch.testing.assert_close(to[key], indirect[key], rtol=0, atol=0)
    torch.testing.assert_close(to["sum_logprob"], indirect["sum_logprob"])


@pytest.mark.parametrize("kind", ["beam", "greedy"])
def test_unfused_int8_graph_runs_b13(setup, monkeypatch, kind):
    to, n = _decode(setup, kind, "unfused", monkeypatch, **INT8,
                    beam_size=3 if kind == "beam" else 1)
    layers = setup["tcfg"].decoder_layers
    assert n["cross_attention_int8"] == layers * to["steps"]
    assert sum(n.values()) == n["cross_attention_int8"]


def test_fused_kernels_over_the_5d_cache(monkeypatch):
    """Fused int8 weights with 16-wide heads: no flat layout, so the step
    is the plain layer loop over the 5-D cache (``_qkv_proj`` on the fused
    ``wqkv`` leaf) and no kernel wrapper runs; its tokens equal those of
    the reference, which runs its fused kernels around the 5-D cache."""
    s = _setup("micro-test")
    opts = dict(**SHORT, **INT8, beam_size=1)
    jo = jd.greedy_decode(s["params"]["fused"][0], s["jcfg"], s["enc"],
                          s["prompt"], s["pad"], jax.random.PRNGKey(0),
                          opts=jd.DecodingOptions(**opts), ti=s["jti"])
    to, n = _run_port(s, "greedy", "fused", opts, monkeypatch)
    assert to["steps"] > SHORT["growth_min_cap"] and to["logits_finite"]
    _same_tokens(to, jo)
    assert sum(n.values()) == 0


def test_5d_int8_cache_layout_and_growth(setup):
    """init_cache's 5-D int8 layout (the reference's model.py:644-650), its
    growth on the len axis of codes and scales, and the row gather."""
    tp = setup["params"]["unfused"][1]
    cfg = setup["tcfg"]
    enc = torch.from_numpy(setup["enc"])
    cache = tm.init_cache(tp, cfg, enc, max_len=20, kv_int8=True,
                          cross_kv_int8=True)
    L, h = cfg.decoder_layers, cfg.decoder_heads
    assert not cache.flat and cache.quantized and cache.cross_quantized
    assert cache.k.shape == (L, 2, 20, h, 64) and cache.k.dtype == torch.int8
    assert cache.ks.shape == (L, 2, 20, h) and cache.ks.dtype == torch.float32
    assert cache.cross_k.shape == (L, 2, 1504, h * 64)  # S padded to 8
    assert cache.cks.shape == (L, 2, h, 1504)
    cache.ks.fill_(1.0)
    grown = td._pad_cache_to(cache, 28)
    assert grown.k.shape[2] == grown.ks.shape[2] == 28
    assert grown.ks[:, :, 20:].abs().sum() == 0 and grown.ks[:, :, :20].eq(1).all()
    idx = torch.tensor([1, 0])
    gathered, spare = td._gather_cache(grown, idx)
    assert spare is None
    for t, g in zip((grown.k, grown.v, grown.ks, grown.vs),
                    (gathered.k, gathered.v, gathered.ks, gathered.vs)):
        torch.testing.assert_close(g, t[:, [1, 0]], rtol=0, atol=0)


def test_chip_smoke_holds_the_copied_leg_to_the_step_logits(setup):
    """The smoke's check of the ``beam_indirect=False`` leg on the CPU: one
    logit tensor per step of each leg, equal between the ancestry map and
    the physical copy, and ``decode._step`` restored afterwards."""
    import importlib.util
    import os

    spec = importlib.util.spec_from_file_location("chip_smoke_branches", os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    step = td._step
    opts = dict(**SHORT, **INT8, beam_size=3)
    with smoke._step_logits() as mapped_logits:
        mapped, _ = _run_port(setup, "beam", "fused", opts)
    with smoke._step_logits() as copied_logits:
        copied, _ = _run_port(setup, "beam", "fused", dict(opts, beam_indirect=False))
    assert td._step is step
    assert len(mapped_logits) == len(copied_logits) == mapped["steps"] > 0
    assert smoke._first_difference(mapped, copied) is None
    gaps = smoke._logit_gaps(mapped_logits, copied_logits)
    assert all(gap <= smoke.STEP_LOGIT_REL and same for gap, same in gaps)
    # a wrong row order in the copy shows as a gap
    swapped = [t.flip(0) for t in copied_logits]
    assert max(g for g, _ in smoke._logit_gaps(mapped_logits, swapped)) > 0
