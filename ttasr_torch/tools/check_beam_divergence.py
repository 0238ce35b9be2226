"""How far two int8 routes' beam searches diverge (the port of
``tools/check_beam_divergence.py``).

The kernels' step logits are held to their plain versions elsewhere (the
smoke run, the CPU tests).  This tool measures what a route's arithmetic
means for free-running BEAM SEARCH: N speech-like 30 s windows decode
through two routes with beam 5, and the report gives

- the exact token-sequence agreement rate across windows,
- the mean first-divergence step among diverging windows,
- the token edit distance between the routes, and
- the CER of one route's text against the other's (the recognition-level
  delta a near-tie argmax flip can cause).

``--ab kernels``: the fused decode (flat cache: B1 -> B2 -> B3 -> B4) against
the unfused int8 graph (5-D cache, B13), the float encoder in both;
``encoder-act8``: the unfused decode in both, the s8 x s8 encoder on
against off (plain quantize chains); ``encoder-fused-quant``: act8 in both,
the one-pass quantize kernels (B5, B7-B9 and the qkv epilogue) on against
the plain chains.  Divergence here is not a bug: the routes sum in other
orders, so near-tie beam picks legitimately differ.  This records how often
it matters.

Usage: python -m ttasr_torch.tools.check_beam_divergence [--windows 8]
       [--sample-len 64] [--device cuda]
Random weights from seed 0 (bf16, quantized on the device).  The device is
``cuda`` unless ``--device cpu``; without a card the tool raises.
"""

from __future__ import annotations

import argparse
import dataclasses
import difflib
import json

import numpy as np


def _edit_distance(a, b):
    sm = difflib.SequenceMatcher(a=a, b=b, autojunk=False)
    same = sum(block.size for block in sm.get_matching_blocks())
    return max(len(a), len(b)) - same


def windows_audio(n_windows: int, seed: int = 0) -> np.ndarray:
    """(n_windows, 30 s) of synthesized speech of 8-25 s each, zero-padded."""
    from ttasr_torch.ops.mel import N_SAMPLES
    from ttasr_torch.tools.synth import synth_speech

    rng = np.random.default_rng(seed)
    audio = np.zeros((n_windows, N_SAMPLES), np.float32)
    for i in range(n_windows):
        clip, _ = synth_speech(rng, seconds=float(rng.uniform(8.0, 25.0)))
        audio[i, : len(clip)] = clip[:N_SAMPLES]
    return audio


def legs(params, ab: str, cross_int4: bool, beam: int, sample_len: int):
    """The two routes of ``ab`` as (name, params, opts, act8, fused_quant),
    the unfused one first; ``params`` are float weights."""
    from ttasr_torch.models.whisper.decode import DecodingOptions
    from ttasr_torch.ops.quant import fuse_qkv, kmajor_encoder_codes, quantize_params

    qparams = quantize_params(params)        # unfused int8 graph
    fparams = fuse_qkv(qparams)              # fused flat-cache kernels
    # the s8 x s8 GEMM's K-major codes, as the engine lays them out
    qparams, fparams = kmajor_encoder_codes(qparams), kmajor_encoder_codes(fparams)
    opts = DecodingOptions(beam_size=beam, sample_len=sample_len,
                           kv_int8=True, cross_kv_int8=True)
    opts_fused = (dataclasses.replace(opts, cross_kv_int4=True)
                  if cross_int4 else opts)
    if ab == "kernels":
        return (("unfused", qparams, opts, False, None),
                ("fused", fparams, opts_fused, False, None))
    if ab == "encoder-act8":
        # identical unfused decode, encoder s8xs8 A/B (plain quantize chains
        # in both legs so the bound isolates activation quantization)
        return (("unfused", qparams, opts, False, None),
                ("fused", qparams, opts, True, False))
    # encoder-fused-quant: act8 both legs, fused quantize kernels on vs off
    return (("unfused", fparams, opts, True, False),
            ("fused", fparams, opts, True, True))


def divergence_report(params, cfg, tok, audio, *, ab: str = "kernels",
                      cross_int4: bool = False, beam: int = 5,
                      sample_len: int = 64) -> dict:
    """Decodes ``audio`` (windows, 30 s) through both legs of ``ab`` on
    ``params``' device; returns the report."""
    import torch

    from ttasr_torch.models.whisper.decode import TokenizerInfo, beam_decode, pad_prompts
    from ttasr_torch.models.whisper.model import encode
    from ttasr_torch.ops.mel import log_mel_spectrogram
    from ttasr_torch.text.cer import cer_metric

    device = params["encoder"]["conv1_w"].device
    n_windows = audio.shape[0]
    ti = TokenizerInfo.from_tokenizer(tok, n_vocab=cfg.vocab_size)
    prompt_ids = tok.sot_sequence("zh", "transcribe", predict_timestamps=True)
    prompt, pad = pad_prompts([prompt_ids] * n_windows, tok.eot)
    results = {}
    with torch.inference_mode():
        mel = log_mel_spectrogram(audio, n_mels=cfg.num_mel_bins, device=device)
        for name, prms, o, act8, fq in legs(params, ab, cross_int4, beam, sample_len):
            enc_out = encode(prms, cfg, mel, act_int8=act8, fused_quant=fq)
            out = beam_decode(prms, cfg, enc_out, prompt, pad,
                              torch.Generator(device=device).manual_seed(0),
                              opts=o, ti=ti)
            results[name] = {"tokens": out["tokens"].cpu().numpy(),
                             "lengths": out["lengths"].cpu().numpy()}

    agree = 0
    first_div = []
    edits = []
    texts_u, texts_f = [], []
    for i in range(n_windows):
        nu = int(results["unfused"]["lengths"][i])
        nf = int(results["fused"]["lengths"][i])
        tu = results["unfused"]["tokens"][i, :nu].tolist()
        tf = results["fused"]["tokens"][i, :nf].tolist()
        texts_u.append(tok.decode([t for t in tu if t < ti.timestamp_begin]))
        texts_f.append(tok.decode([t for t in tf if t < ti.timestamp_begin]))
        if tu == tf:
            agree += 1
        else:
            k = next((j for j, (a, b) in enumerate(zip(tu, tf)) if a != b),
                     min(nu, nf))
            first_div.append(k)
            edits.append(_edit_distance(tu, tf))
    cer_delta = cer_metric(texts_u, texts_f)  # fraction
    return {
        "ab": ab,
        "cross_int4": bool(cross_int4),
        "windows": n_windows,
        "beam": beam,
        "sample_len": sample_len,
        "exact_agreement_rate": round(agree / n_windows, 3),
        "diverging_windows": n_windows - agree,
        "mean_first_divergence_step": (round(float(np.mean(first_div)), 1)
                                       if first_div else None),
        "mean_token_edit_distance": (round(float(np.mean(edits)), 1)
                                     if edits else 0.0),
        "cer_between_paths": round(cer_delta, 4),
    }


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model", default="large-v3")
    p.add_argument("--windows", type=int, default=8)
    p.add_argument("--sample-len", type=int, default=64)
    p.add_argument("--beam", type=int, default=5)
    p.add_argument("--cross-int4", action="store_true",
                   help="fused path uses int4 nibble-packed cross-KV: "
                        "bounds the int4 quantization error at the "
                        "recognition level, not just kernel numerics")
    p.add_argument("--ab", default="kernels",
                   choices=["kernels", "encoder-act8", "encoder-fused-quant"],
                   help="kernels: fused-vs-unfused decode kernels "
                        "(encoder act-int8 off in both). encoder-act8: "
                        "same unfused decode, encoder s8xs8 on vs off. "
                        "encoder-fused-quant: act8 on in both, the one-pass "
                        "quantize kernels on vs the plain quantize chains")
    p.add_argument("--out-json", default=None)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the routes run; cuda raises without a card")
    return p


def main(argv=None) -> dict:
    p = build_parser()
    args = p.parse_args(argv)
    if args.cross_int4 and args.ab != "kernels":
        # opts_fused is only consumed by the "kernels" legs; silently
        # ignoring the flag would mislabel the recorded bound
        p.error("--cross-int4 only applies to --ab kernels "
                "(the encoder-act8 A/B runs both legs with int8 cross-KV)")

    import torch

    from ttasr_torch import resolve_device
    from ttasr_torch.models.whisper.config import get_config
    from ttasr_torch.models.whisper.model import init_params
    from ttasr_torch.text.tokenizer import build_byte_fallback_tokenizer

    device = resolve_device(args.device)
    cfg = get_config(args.model)
    params = init_params(cfg, seed=0, dtype=torch.bfloat16, device=device)
    report = divergence_report(params, cfg, build_byte_fallback_tokenizer(),
                               windows_audio(args.windows), ab=args.ab,
                               cross_int4=args.cross_int4, beam=args.beam,
                               sample_len=args.sample_len)
    print(json.dumps(report))
    if args.out_json:
        with open(args.out_json, "w") as fh:
            json.dump(report, fh, indent=1)
    return report


if __name__ == "__main__":
    main()
