"""The port's Whisper model against the JAX package, f32 on the CPU.

Two small configurations: the ``micro64-test`` preset (64-wide heads, so
the encoder goes through the encoder-attention wrapper) and the 64-wide
HF config of ``tests/test_whisper_model.py`` (16-wide heads, plain
attention).  Weights are shared through ``params_from_jax`` and
``params_from_state_dict``; inputs are made from a seed with numpy.
Tolerance: 1e-4 relative to the output's scale (f32 with different
summation orders in XLA and PyTorch).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from ttasr.models.whisper import model as jm
from ttasr.models.whisper.config import PRESETS as J_PRESETS
from ttasr.models.whisper.load import params_from_hf_model
from ttasr_torch.models.whisper import model as tm
from ttasr_torch.models.whisper.config import PRESETS as T_PRESETS
from ttasr_torch.models.whisper.config import WhisperConfig as TConfig
from ttasr_torch.models.whisper.load import (
    load_whisper,
    params_from_jax,
    params_from_state_dict,
)

TINY_HF = dict(
    vocab_size=257, num_mel_bins=80, d_model=64, encoder_layers=2,
    encoder_attention_heads=4, decoder_layers=2, decoder_attention_heads=4,
    encoder_ffn_dim=128, decoder_ffn_dim=128, max_source_positions=64,
    max_target_positions=64,
)
REL = 1e-4


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / (np.abs(want).max() + 1e-12)


@pytest.fixture(scope="module", params=["micro64", "hf64"])
def pair(request):
    """(jax params, jax cfg, port params, port cfg, mel frames)."""
    if request.param == "micro64":
        jcfg = J_PRESETS["micro64-test"]
        jp = jm.init_params(jcfg, seed=0)
        tp = params_from_jax(jax.tree.map(np.asarray, jp))
        return jp, jcfg, tp, T_PRESETS["micro64-test"], 3000
    from transformers import WhisperConfig as HFConfig
    from transformers import WhisperForConditionalGeneration

    torch.manual_seed(0)
    hf = WhisperForConditionalGeneration(HFConfig(
        **TINY_HF, dropout=0.0, attention_dropout=0.0, activation_dropout=0.0,
        pad_token_id=0, bos_token_id=1, eos_token_id=2,
        decoder_start_token_id=1)).eval()
    jp, jcfg = params_from_hf_model(hf)
    sd = {k: v.detach().float().numpy() for k, v in hf.state_dict().items()}
    tcfg = TConfig(**dataclasses.asdict(jcfg))
    return jp, jcfg, params_from_state_dict(sd, tcfg), tcfg, 128


@pytest.fixture(scope="module")
def encoded(pair):
    jp, jcfg, tp, tcfg, frames = pair
    rng = np.random.default_rng(0)
    mel = (rng.standard_normal((2, jcfg.num_mel_bins, frames)) * 0.5).astype(np.float32)
    return mel, np.array(jm.encode(jp, jcfg, mel))


def test_params_match_jax_leaf_for_leaf(pair):
    jp, _, tp, _, _ = pair
    for part in ("encoder", "decoder"):
        for name, leaf in jp[part].items():
            if name == "blocks":
                assert len(tp[part]["blocks"]) == next(iter(leaf.values())).shape[0]
                for key, stacked in leaf.items():
                    for i, blk in enumerate(tp[part]["blocks"]):
                        np.testing.assert_array_equal(
                            blk[key].numpy(), np.asarray(stacked[i]), err_msg=key)
            else:
                np.testing.assert_array_equal(
                    tp[part][name].numpy(), np.asarray(leaf), err_msg=name)


def test_init_params_structure_and_scale():
    cfg = T_PRESETS["micro-test"]
    jp = jm.init_params(J_PRESETS["micro-test"], seed=0)
    tp, _ = load_whisper("micro-test", device="cpu", seed=3)
    for part in ("encoder", "decoder"):
        assert set(tp[part]) == set(jp[part])
        for key, stacked in jp[part]["blocks"].items():
            assert len(tp[part]["blocks"]) == stacked.shape[0]
            assert tuple(tp[part]["blocks"][0][key].shape) == stacked.shape[1:]
        for key, leaf in jp[part].items():
            if key != "blocks":
                assert tuple(tp[part][key].shape) == leaf.shape, key
    np.testing.assert_array_equal(tp["encoder"]["pos"].numpy(),
                                  np.asarray(jp["encoder"]["pos"]))
    w = tp["decoder"]["embed"]
    assert abs(float(w.std()) - 0.02) < 2e-3 and w.dtype == torch.float32
    again, _ = load_whisper("micro-test", device="cpu", seed=3)
    torch.testing.assert_close(again["decoder"]["embed"], w, rtol=0, atol=0)
    bf, _ = load_whisper("micro-test", dtype=torch.bfloat16, device="cpu")
    assert bf["encoder"]["blocks"][1]["w1"].dtype == torch.bfloat16
    assert cfg.d_model == tp["encoder"]["ln_s"].shape[0]


def test_encode_matches_jax(pair, encoded):
    _, _, tp, tcfg, _ = pair
    mel, want = encoded
    got = tm.encode(tp, tcfg, torch.from_numpy(mel)).numpy()
    assert got.shape == want.shape
    assert _rel(got, want) < REL


def test_decode_train_matches_jax(pair, encoded):
    jp, jcfg, tp, tcfg, _ = pair
    _, enc = encoded
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, jcfg.vocab_size, size=(2, 9)).astype(np.int32)
    want = np.asarray(jm.decode_train(jp, jcfg, tokens, enc))
    got = tm.decode_train(tp, tcfg, torch.from_numpy(tokens).long(),
                          torch.from_numpy(enc)).numpy()
    assert got.shape == want.shape
    assert _rel(got, want) < REL


def test_prefill_and_step_logits_match_jax(pair, encoded):
    jp, jcfg, tp, tcfg, _ = pair
    _, enc = encoded
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, jcfg.vocab_size, size=(2, 7)).astype(np.int32)
    jcache = jm.init_cache(jp, jcfg, enc, max_len=16)
    tcache = tm.init_cache(tp, tcfg, torch.from_numpy(enc), max_len=16)
    np.testing.assert_allclose(tcache.cross_k.numpy(), np.asarray(jcache.cross_k),
                               rtol=1e-5, atol=1e-5)
    tt = torch.from_numpy(tokens).long()
    want, jcache = jm.decode_step(jp, jcfg, tokens[:, :4], 0, jcache)
    got, tcache = tm.decode_step(tp, tcfg, tt[:, :4], 0, tcache)
    assert _rel(got.numpy(), np.asarray(want)) < REL
    for i in range(4, 7):
        want, jcache = jm.decode_step(jp, jcfg, tokens[:, i:i + 1], i, jcache)
        got, tcache = tm.decode_step(tp, tcfg, tt[:, i:i + 1], i, tcache)
        assert got.shape == (2, 1, jcfg.vocab_size)
        assert _rel(got.numpy(), np.asarray(want)) < REL
    assert _rel(tcache.k.numpy(), np.asarray(jcache.k)) < REL


def test_encoder_fused_and_plain_attention_agree():
    cfg = T_PRESETS["micro64-test"]
    tp, _ = load_whisper("micro64-test", device="cpu")
    mel = torch.from_numpy(
        np.random.default_rng(5).standard_normal((1, 80, 400)).astype(np.float32))
    fused = tm.encode(tp, cfg, mel)
    plain = tm.encode(tp, cfg, mel, fused_attention=False)
    assert fused.shape == (1, 200, cfg.d_model)
    torch.testing.assert_close(fused, plain, rtol=1e-5, atol=1e-5)
