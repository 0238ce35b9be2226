"""End-to-end trained-recognition check, on the card (the port of
``tools/check_trained_recognition.py``).

Every other decode check runs random weights, so recognition-level wiring
(VAD interaction with real signal structure, prompt carry, seek, timestamp
parsing, normalize) would otherwise never produce a *correct* transcript.
This check closes that: overfit a micro Whisper on a tiny speech-like
corpus through the port's ``Trainer`` (timestamp labels on), then run the
FULL ``WhisperEngine.transcribe`` path (learned conv VAD on, beam 5,
timestamp rules, text normalize) and require CER ~ 0 on the training
clips.

The clips come from the VAD training synthesizer (glottal pulses +
formants + syllabic gating, ``ttasr_torch/tools/synth.py``), so the
default VAD detects them as speech.

Usage: python -m ttasr_torch.tools.check_trained_recognition [--steps 800]
       [--clips 6] [--model micro64-test] [--compute int8] [--device cuda]
Exit code 0 iff the greedy CER <= --max-cer (default 0.05).  The device is
``cuda`` unless ``--device cpu``; without a card the tool raises.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import numpy as np

SENTENCES = [
    "今天天氣真好",
    "請問現在幾點",
    "我想要一杯咖啡",
    "台北的捷運很方便",
    "這個週末要去爬山",
    "會議改到下午三點",
    "火車快要進站了",
    "晚餐吃什麼好呢",
]
# the transcription's keywords (beam_size per pass), as the original's
TRANSCRIBE_KWARGS = dict(language="zh", vad_filter=True, condition_on_previous_text=True,
                         initial_prompt="", max_new_tokens=48)


def make_clips(n_clips: int, seed: int, out_dir: str):
    """``n_clips`` synthesized speech clips of 2-3 s as 16-bit WAVs in
    ``out_dir``, each labelled with one of ``SENTENCES``."""
    from ttasr_torch.audio.io import write_wav
    from ttasr_torch.tools.synth import synth_speech  # speech-like: the VAD detects it
    from ttasr_torch.train.data import CorpusExample

    rng = np.random.default_rng(seed)
    examples = []
    for i in range(n_clips):
        audio, _ = synth_speech(rng, seconds=float(rng.uniform(2.0, 3.0)))
        path = os.path.join(out_dir, f"clip{i}.wav")
        write_wav(path, audio)
        examples.append(CorpusExample(audio_path=path,
                                      sentence=SENTENCES[i % len(SENTENCES)]))
    return examples


def trainer_config(out_dir: str, steps: int, n_clips: int, lr: float):
    """The original's recipe: timestamp labels padded to 64, no remat."""
    from ttasr_torch.train.trainer import TrainerConfig

    return TrainerConfig(
        output_dir=out_dir, max_steps=steps,
        per_device_train_batch_size=min(n_clips, 8), learning_rate=lr,
        warmup_steps=20, logging_steps=50, eval_steps=10 ** 9,
        save_steps=10 ** 9, label_pad_to=64, gradient_checkpointing=False,
        predict_timestamps=True,
    )


def train_model(examples, model: str, steps: int, lr: float, seed: int, device,
                out_dir: str):
    """Trains ``model`` from ``init_params(cfg, seed)`` on ``device``;
    returns (params, cfg, tokenizer, train metrics)."""
    from ttasr_torch.models.whisper.config import get_config
    from ttasr_torch.models.whisper.model import init_params
    from ttasr_torch.text.tokenizer import build_byte_fallback_tokenizer
    from ttasr_torch.train.trainer import Trainer

    tok = build_byte_fallback_tokenizer()
    cfg = get_config(model)
    trainer = Trainer(init_params(cfg, seed=seed, device=device), cfg, tok,
                      trainer_config(out_dir, steps, len(examples), lr))
    metrics = trainer.train(examples)
    return trainer.state.params, cfg, tok, metrics


def transcribe_clips(engine, examples, beams=(1, 5), **overrides):
    """Each clip through ``engine.transcribe`` at each beam size: the
    per-clip rows of the original's report and the hypotheses by beam."""
    per_clip, hyps = [], {beam: [] for beam in beams}
    for ex in examples:
        row = {"ref": ex.sentence}
        for beam in beams:
            segments, info = engine.transcribe(
                ex.audio_path, beam_size=beam, **{**TRANSCRIBE_KWARGS, **overrides})
            text = "".join(s.text for s in segments)
            hyps[beam].append(text)
            row[f"hyp_beam{beam}"] = text
            if beam == 1:
                row.update({
                    "segments": [[round(s.start, 2), round(s.end, 2)]
                                 for s in segments],
                    "vad_kept_s": round(info.duration_after_vad, 2),
                    "duration_s": round(info.duration, 2),
                })
        per_clip.append(row)
    return per_clip, hyps


def served_params(params, compute: str):
    """The trained params as a ``compute`` engine serves them: int8
    quantizes bfloat16 weights, as ``WhisperEngine`` loads a model for int8
    (the s8 x s8 encoder's row kernels read bfloat16 rows on the card);
    the float engines take the params as they are."""
    if compute != "int8":
        return params
    import torch

    from ttasr_torch.core.checkpoint import map_leaves

    return map_leaves(lambda _, x: x.to(torch.bfloat16) if x.is_floating_point() else x,
                      params)


def device_name(device) -> str:
    import torch

    device = torch.device(device)
    if device.type == "cuda":
        return f"{torch.cuda.get_device_name(device)} x {torch.cuda.device_count()}"
    return "cpu"


def run_check(steps=800, n_clips=6, lr=2e-3, seed=0, max_cer=0.05,
              out_json=None, model="micro-test", compute="float32",
              batched=False, int4_ab=False, device="cuda"):
    from ttasr_torch import resolve_device
    from ttasr_torch.engine.transcriber import WhisperEngine
    from ttasr_torch.text.cer import cer_metric

    device = resolve_device(device)
    with tempfile.TemporaryDirectory(prefix="ttasr-e2e-") as tmp:
        examples = make_clips(n_clips, seed, tmp)
        params, cfg, tok, train_metrics = train_model(
            examples, model, steps, lr, seed, device, os.path.join(tmp, "out"))

        def make_engine(**kw):
            return WhisperEngine(model, params=served_params(params, compute), config=cfg,
                                 tokenizer=tok, compute_type=compute, device=device, **kw)

        engine = make_engine()
        refs = [ex.sentence.lower() for ex in examples]
        per_clip, hyps = transcribe_clips(engine, examples)
        # The gated metric is the greedy path: it exercises VAD, seek,
        # timestamp rules and normalize end-to-end.  Beam-5 CER is recorded,
        # not gated: a toy decoder has uncalibrated eot probability on junk
        # prefixes, so low-score eot candidates flood the openai finished-set
        # (k finishers end the search) before the true beam completes — a
        # toy-scale artifact that vanishes with a real model, where
        # mid-speech eot is strongly suppressed by training.
        cer = cer_metric(refs, hyps[1])  # fraction (edits / ref chars)

        extra = {}
        if batched:
            # the VAD-chunked batched path (the BatchServer) on every clip
            from ttasr_torch.engine.batched import BatchedInferencePipeline

            pipe = BatchedInferencePipeline(engine, batch_size=4)
            try:
                hyps_b = []
                for ex in examples:
                    segs_b, _ = pipe.transcribe(
                        ex.audio_path, language="zh", beam_size=5,
                        vad_filter=True, initial_prompt="", max_new_tokens=48)
                    hyps_b.append("".join(s.text for s in segs_b))
            finally:
                pipe.close()
            extra["e2e_trained_cer_batched_beam5"] = round(
                cer_metric(refs, hyps_b), 4)
            extra["batched_hyps"] = hyps_b
        if int4_ab and compute == "int8":
            # the int4 self-KV's recognition bound: the same trained params,
            # kv_int4 off against the default on above
            eng_off = make_engine(kv_int4=False)
            _, hyps_off = transcribe_clips(eng_off, examples, beams=(5,))
            extra["e2e_trained_cer_beam5_kv_int8"] = round(
                cer_metric(refs, hyps_off[5]), 4)

    result = {
        "model": model, "compute": compute, "device": device_name(device),
        "e2e_trained_cer_greedy": round(cer, 4),
        "e2e_trained_cer_beam5": round(cer_metric(refs, hyps[5]), 4),
        **extra,
        "train_loss": round(train_metrics["train_loss"], 4),
        "steps": steps, "clips": n_clips,
        "vad_all_detected": all(c["vad_kept_s"] > 0.5 for c in per_clip),
        "timestamps_sane": all(
            all(0.0 <= s0 <= s1 <= c["duration_s"] + 0.5
                for s0, s1 in c["segments"]) and c["segments"]
            for c in per_clip),
        "per_clip": per_clip,
    }
    print(json.dumps(result, ensure_ascii=False))
    if out_json:
        with open(out_json, "w", encoding="utf-8") as fh:
            json.dump(result, fh, ensure_ascii=False, indent=1)
    return result, cer <= max_cer


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=800)
    ap.add_argument("--clips", type=int, default=6)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--max-cer", type=float, default=0.05)
    ap.add_argument("--out-json", default=None)
    ap.add_argument("--model", default="micro-test",
                    help="micro64-test engages the fused dh-64 path")
    ap.add_argument("--compute", default="float32",
                    help="int8 runs the fused kernels")
    ap.add_argument("--batched", action="store_true",
                    help="also score BatchedInferencePipeline")
    ap.add_argument("--int4-ab", action="store_true",
                    help="also score kv_int4 OFF for the int4 self-KV "
                         "recognition bound (needs --compute int8)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the model trains and decodes; cuda raises "
                         "without a card")
    return ap


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    _, ok = run_check(args.steps, args.clips, args.lr, args.seed,
                      args.max_cer, args.out_json, model=args.model,
                      compute=args.compute, batched=args.batched,
                      int4_ab=args.int4_ab, device=args.device)
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
