"""Training loop: steps, eval, checkpointing, metrics (port of
``ttasr/train/trainer.py``).

Replaces Seq2SeqTrainer usage in the reference (train_asr.py:697-751):
- max_steps budget with eval/save cadences (run.sh:13,23-25),
- greedy generation for eval + CER metric (train_asr.py:662-675,
  ``evaluate.load("cer")`` semantics via ttasr_torch.text.cer.cer_metric),
- checkpoint auto-detect + resume (train_asr.py:374-392,710-716),
- train/eval metrics persisted (train_asr.py:717-751).

Everything runs on the params' device.  As in the JAX package, ``train``
builds a fresh batch iterator from ``seed`` on every call, so a resumed run
replays the epoch from its first batch (ROADMAP C8).

On a mesh (``Trainer(mesh=...)``, one process per rank, every rank running
the same loop) the trainer takes the whole params, as the JAX one takes
global arrays, and its state holds the rank's slices
(``init_train_state(mesh=...)``: ZeRO-1 moments).  Every rank builds the
same batch iterator from ``seed``; ``per_device_train_batch_size`` is the
global batch, split over the data axes (the JAX trainer's
``batch_iterator(batch_size=...)`` then ``_shard_batch``; HF's is per
device), and the train step keeps the rank's rows.  Checkpoints and the
final ``model/`` hold the whole state, gathered on every rank and written
by rank 0: the files of the one-process run, so either resumes the other.
``evaluate`` runs on the gathered whole params (B11 on the card, as
without a mesh) and every rank returns the same metrics.  Logs and
TensorBoard are rank 0's.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import time
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ttasr_torch.core.checkpoint import (
    get_last_checkpoint,
    restore_checkpoint,
    save_checkpoint,
    save_params,
)
from ttasr_torch.models.whisper.config import WhisperConfig
from ttasr_torch.models.whisper.decode import (
    DecodingOptions,
    TokenizerInfo,
    beam_decode,
    greedy_decode,
    pad_prompts,
)
from ttasr_torch.models.whisper.model import encode
from ttasr_torch.ops.mel import N_SAMPLES, log_mel_spectrogram
from ttasr_torch.text.cer import cer_metric
from ttasr_torch.train.data import (
    CorpusExample,
    batch_iterator,
    prepare_example,
)
from ttasr_torch.train.spec_augment import SpecAugmentConfig
from ttasr_torch.train.train_step import (
    init_train_state,
    make_optimizer,
    make_train_step,
    params_device,
)

logger = logging.getLogger("ttasr_torch.train")


@dataclasses.dataclass
class TrainerConfig:
    output_dir: str
    max_steps: int = 2000
    per_device_train_batch_size: int = 4
    per_device_eval_batch_size: int = 16
    gradient_accumulation_steps: int = 1
    learning_rate: float = 1e-5
    warmup_steps: int = 500
    logging_steps: int = 25
    eval_steps: int = 1000
    save_steps: int = 1000
    generation_max_length: int = 225
    # reference train_asr.py:739: trainer.evaluate(num_beams=
    # training_args.generation_num_beams) under predict_with_generate;
    # 1 = greedy (run.sh's effective default)
    generation_num_beams: int = 1
    language: str = "zh"
    task: str = "transcribe"
    do_lower_case: bool = True
    min_duration_in_seconds: float = 0.0
    max_duration_in_seconds: float = 30.0
    gradient_checkpointing: bool = True
    freeze_encoder: bool = False
    label_pad_to: int = 128
    seed: int = 42
    resume_from_checkpoint: Optional[str] = None
    # reference train_asr.py:139-144 + HF WhisperConfig mask defaults
    apply_spec_augment: bool = False
    mask_time_prob: float = 0.05
    mask_time_length: int = 10
    mask_time_min_masks: int = 2
    mask_feature_prob: float = 0.0
    mask_feature_length: int = 10
    mask_feature_min_masks: int = 0
    # reference run.sh:33
    group_by_length: bool = False
    # reference train_asr.py:125-138, 509-513: generation overrides
    forced_decoder_ids: Optional[Sequence[Sequence[int]]] = None
    suppress_tokens: Optional[Sequence[int]] = None
    # "bfloat16" = mixed precision (f32 master params, bf16 forward)
    compute_dtype: Optional[str] = None
    # train the timestamp head (openai segment-label format); the
    # reference's HF recipe is notimestamps-only
    predict_timestamps: bool = False


class Trainer:
    def __init__(self, params, cfg: WhisperConfig, tokenizer,
                 trainer_config: TrainerConfig, *, mesh=None):
        self.mesh = mesh
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.tc = trainer_config
        self.device = params_device(params)
        self.optimizer = make_optimizer(
            learning_rate=self.tc.learning_rate,
            warmup_steps=self.tc.warmup_steps,
            total_steps=self.tc.max_steps,
        )
        if self.tc.gradient_accumulation_steps > 1:
            # optax.MultiSteps in the JAX package
            self.optimizer = dataclasses.replace(
                self.optimizer, every_k=self.tc.gradient_accumulation_steps)
        self.state = init_train_state(params, self.optimizer, mesh)
        spec_aug = None
        if self.tc.apply_spec_augment:
            spec_aug = SpecAugmentConfig(
                mask_time_prob=self.tc.mask_time_prob,
                mask_time_length=self.tc.mask_time_length,
                mask_time_min_masks=self.tc.mask_time_min_masks,
                mask_feature_prob=self.tc.mask_feature_prob,
                mask_feature_length=self.tc.mask_feature_length,
                mask_feature_min_masks=self.tc.mask_feature_min_masks,
            )
        compute_dtype = None
        if self.tc.compute_dtype not in (None, "float32"):
            compute_dtype = getattr(torch, self.tc.compute_dtype)
        self.train_step = make_train_step(
            cfg, self.optimizer, mesh=mesh,
            remat=self.tc.gradient_checkpointing,
            freeze_encoder=self.tc.freeze_encoder,
            spec_augment_cfg=spec_aug, compute_dtype=compute_dtype,
            seed=self.tc.seed,
        )
        self.metrics_path = os.path.join(self.tc.output_dir, "metrics.jsonl")

    # -- checkpoint management ------------------------------------------------

    def maybe_resume(self) -> int:
        """HF-style resume precedence (train_asr.py:710-716)."""
        ckpt = self.tc.resume_from_checkpoint or get_last_checkpoint(
            self.tc.output_dir
        )
        if ckpt:
            logger.info("resuming from %s", ckpt)
            self.state = restore_checkpoint(ckpt, self.state)
            return self.state.step
        return 0

    @property
    def _writes(self) -> bool:
        """Whether this process writes files and logs: rank 0 on a mesh."""
        return self.mesh is None or dist.get_rank() == 0

    def _write(self, save, *args) -> None:
        """``save(*args)`` in the writing process; on a mesh the others
        wait for it."""
        if self._writes:
            save(*args)
        if self.mesh is not None:
            dist.barrier()

    def _log(self, record: dict) -> None:
        if not self._writes:
            return
        os.makedirs(self.tc.output_dir, exist_ok=True)
        with open(self.metrics_path, "a", encoding="utf-8") as fh:
            fh.write(json.dumps(record, ensure_ascii=False) + "\n")
        logger.info("%s", record)
        tb = self._tb_writer()
        if tb is not None:
            step = record.get("step", 0)
            for key, value in record.items():
                if key != "step" and isinstance(value, (int, float)):
                    tb.add_scalar(key, value, step)

    def _tb_writer(self):
        """Lazy TensorBoard writer (HF Trainer logs TB by default)."""
        if not hasattr(self, "_tb"):
            try:
                from tensorboardX import SummaryWriter

                self._tb = SummaryWriter(
                    os.path.join(self.tc.output_dir, "runs")
                )
            except Exception:
                self._tb = None
        return self._tb

    # -- training --------------------------------------------------------------

    def train(self, train_examples,
              eval_examples: Optional[List[CorpusExample]] = None) -> dict:
        """``train_examples``: a list, or a zero-arg callable yielding
        CorpusExamples per epoch (the --streaming path)."""
        start_step = self.maybe_resume()
        it = batch_iterator(
            train_examples, self.tokenizer,
            batch_size=self.tc.per_device_train_batch_size,
            n_mels=self.cfg.num_mel_bins, seed=self.tc.seed,
            label_pad_to=self.tc.label_pad_to,
            group_by_length=self.tc.group_by_length,
            device=self.device,
            language=self.tc.language, task=self.tc.task,
            do_lower_case=self.tc.do_lower_case,
            min_duration_s=self.tc.min_duration_in_seconds,
            max_duration_s=self.tc.max_duration_in_seconds,
            timestamps=self.tc.predict_timestamps,
        )
        t0 = time.time()
        losses = []
        final_loss = float("nan")
        for step in range(start_step, self.tc.max_steps):
            batch = next(it)
            self.state, loss = self.train_step(self.state, batch)
            losses.append(loss)
            if (step + 1) % self.tc.logging_steps == 0 or step + 1 == self.tc.max_steps:
                final_loss = float(np.mean([float(l) for l in losses]))
                self._log({
                    "step": step + 1, "loss": round(final_loss, 4),
                    "elapsed_s": round(time.time() - t0, 1),
                })
                losses = []
            if (step + 1) % self.tc.save_steps == 0:
                # state_dict gathers the whole state on a mesh: every rank
                self._write(save_checkpoint, self.tc.output_dir, step + 1,
                            self.state.state_dict())
            if eval_examples and (step + 1) % self.tc.eval_steps == 0:
                metrics = self.evaluate(eval_examples)
                self._log({"step": step + 1, **metrics})

        self._write(save_checkpoint, self.tc.output_dir, self.tc.max_steps,
                    self.state.state_dict())
        self._write(save_params, os.path.join(self.tc.output_dir, "model"),
                    self.state.whole_params())
        return {"train_loss": final_loss, "steps": self.tc.max_steps}

    # -- evaluation --------------------------------------------------------------

    def evaluate(self, eval_examples: List[CorpusExample],
                 num_beams: Optional[int] = None) -> dict:
        """Generation + CER (predict_with_generate parity).  ``num_beams``
        (default ``generation_num_beams``) > 1 evaluates with beam search
        — reference train_asr.py:739 passes
        ``num_beams=training_args.generation_num_beams``.  The mel and the
        encoder (the port's ``encode`` at its defaults: the encoder-attention
        kernel for 64-wide heads) run on the params' device, on a mesh on
        the whole params gathered by every rank."""
        tok = self.tokenizer
        ti = TokenizerInfo.from_tokenizer(tok, n_vocab=self.cfg.vocab_size)
        if self.tc.suppress_tokens is not None:
            # generation-time suppression override (reference
            # train_asr.py:509-513 config.update suppress_tokens)
            ti = dataclasses.replace(
                ti, suppress=tuple(sorted(set(ti.suppress)
                                          | set(self.tc.suppress_tokens)))
            )
        beams = max(1, int(num_beams if num_beams is not None
                           else self.tc.generation_num_beams))
        opts = DecodingOptions(
            beam_size=beams, without_timestamps=True,
            sample_len=min(self.tc.generation_max_length, 224),
        )
        if self.tc.forced_decoder_ids:
            # [[idx, token], ...] forces generation positions 1..k after
            # sot, replacing the language/task prefix (HF semantics;
            # reference train_asr.py:125-131)
            forced = sorted((int(i), int(t))
                            for i, t in self.tc.forced_decoder_ids)
            prompt_ids = [tok.sot] + [t for _, t in forced]
        else:
            prompt_ids = tok.sot_sequence(self.tc.language, self.tc.task,
                                          predict_timestamps=False)
        refs: List[str] = []
        hyps: List[str] = []
        bs = self.tc.per_device_eval_batch_size
        prepared = []
        for ex in eval_examples:
            p = prepare_example(
                ex, tok, language=self.tc.language, task=self.tc.task,
                do_lower_case=self.tc.do_lower_case,
                min_duration_s=self.tc.min_duration_in_seconds,
                max_duration_s=self.tc.max_duration_in_seconds,
            )
            if p is not None:
                prepared.append(p)
        params = self.state.whole_params()
        with torch.inference_mode():
            for i in range(0, len(prepared), bs):
                chunk = prepared[i : i + bs]
                # fixed (bs, N_SAMPLES) shape, as the JAX package's one
                # compiled program: the final short chunk is padded too
                audio = np.zeros((bs, N_SAMPLES), np.float32)
                for j, ex in enumerate(chunk):
                    a = ex["audio"][:N_SAMPLES]
                    audio[j, : len(a)] = a
                mel = log_mel_spectrogram(audio, n_mels=self.cfg.num_mel_bins,
                                          device=self.device)
                enc_out = encode(params, self.cfg, mel)
                prompt, pad = pad_prompts([prompt_ids] * bs, tok.eot)
                rng = torch.Generator(device=self.device).manual_seed(0)
                decode = beam_decode if beams > 1 else greedy_decode
                out = decode(params, self.cfg, enc_out, prompt, pad, rng,
                             opts=opts, ti=ti)
                tokens = out["tokens"].cpu().numpy()
                lengths = out["lengths"].cpu().numpy()
                for j, ex in enumerate(chunk):
                    hyp = tok.decode([int(t) for t in tokens[j, : lengths[j]]])
                    refs.append(ex["sentence"])
                    hyps.append(hyp)
        cer = cer_metric(refs, hyps)
        return {"eval_cer": round(cer, 4), "eval_samples": len(refs)}
