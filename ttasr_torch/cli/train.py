"""Fine-tuning CLI on the card (port of ``ttasr/cli/train.py``).

Flag surface mirrors the reference training entry point (train_asr.py
HfArgumentParser dataclasses + run.sh:6-41), flag for flag the JAX
package's, plus ``--device``:

    python -m ttasr_torch.cli.train \
        --model_name_or_path ./whisper-small \
        --corpus_data_dir ./sample_corpus \
        --dataset_config_name train_ds_01+train_ds_02 \
        --train_split_name train+validated --eval_split_name test \
        --language zh --task transcribe \
        --max_steps 2000 --per_device_train_batch_size 4 \
        --learning_rate 1e-5 --warmup_steps 500 \
        --eval_steps 1000 --save_steps 1000 \
        --output_dir ./out --do_train --do_eval \
        --gradient_checkpointing --max_duration_in_seconds 30

The device is ``cuda`` unless ``--device cpu`` is asked for (micro
models); without CUDA the default raises.

``--mesh_data/--mesh_model`` above 1 train on a ``(data, model)`` mesh,
one process per rank, under torchrun:

    torchrun --nproc_per_node 4 -m ttasr_torch.cli.train \
        --mesh_data 2 --mesh_model 2 ...

Each rank joins the group from torchrun's variables
(``initialize_distributed``: NCCL on the cards, one a rank; ``gloo`` with
``--device cpu``, which CPU tensors need), then ``create_mesh`` and
``Trainer(mesh=...)``.  A group that cannot start fails the run; nothing
falls back to another backend.  ``--per_device_train_batch_size`` is the
global batch, split over ``--mesh_data`` (the JAX CLI's meaning).
"""

from __future__ import annotations

import argparse
import itertools
import json
import logging
import os


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Whisper fine-tuning (PyTorch/CUDA)")
    # ModelArguments (train_asr.py:61-144)
    p.add_argument("--model_name_or_path", required=True)
    p.add_argument("--tokenizer_name", default=None)
    p.add_argument("--freeze_feature_encoder", action="store_true", default=True)
    p.add_argument("--freeze_encoder", action="store_true", default=False)
    p.add_argument("--forced_decoder_ids", default=None,
                   help='JSON list of [index, token] pairs forced at '
                        'generation (train_asr.py:125-131), e.g. "[[1,123]]"')
    p.add_argument("--suppress_tokens", default=None,
                   help='JSON list of token ids suppressed at generation '
                        '(train_asr.py:132-138), e.g. "[1,2,3]"')
    p.add_argument("--apply_spec_augment", action="store_true", default=False)
    p.add_argument("--mask_time_prob", type=float, default=0.05)
    p.add_argument("--mask_time_length", type=int, default=10)
    p.add_argument("--mask_time_min_masks", type=int, default=2)
    p.add_argument("--mask_feature_prob", type=float, default=0.0)
    p.add_argument("--mask_feature_length", type=int, default=10)
    p.add_argument("--mask_feature_min_masks", type=int, default=0)
    # DataTrainingArguments (train_asr.py:147-265)
    p.add_argument("--corpus_data_dir", required=True)
    p.add_argument("--dataset_config_name", required=True)
    p.add_argument("--train_split_name", default="train")
    p.add_argument("--eval_split_name", default="test")
    p.add_argument("--max_train_samples", type=int, default=None)
    p.add_argument("--max_eval_samples", type=int, default=None)
    p.add_argument("--max_duration_in_seconds", type=float, default=20.0)
    p.add_argument("--min_duration_in_seconds", type=float, default=0.0)
    p.add_argument("--do_lower_case", action="store_true", default=True)
    p.add_argument("--language", default="zh")
    p.add_argument("--task", default="transcribe")
    p.add_argument("--preprocessing_only", action="store_true")
    p.add_argument("--streaming", action="store_true", default=False)
    # Seq2SeqTrainingArguments subset (run.sh:10-40)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--overwrite_output_dir", action="store_true")
    p.add_argument("--max_steps", type=int, default=2000)
    p.add_argument("--per_device_train_batch_size", type=int, default=4)
    p.add_argument("--per_device_eval_batch_size", type=int, default=16)
    p.add_argument("--gradient_accumulation_steps", type=int, default=1)
    p.add_argument("--learning_rate", type=float, default=1e-5)
    p.add_argument("--warmup_steps", type=int, default=500)
    p.add_argument("--logging_steps", type=int, default=25)
    p.add_argument("--eval_steps", type=int, default=1000)
    p.add_argument("--save_steps", type=int, default=1000)
    p.add_argument("--generation_max_length", type=int, default=225)
    p.add_argument("--generation_num_beams", type=int, default=1,
                   help="beam width for eval generation (reference "
                        "train_asr.py:739; 1 = greedy)")
    p.add_argument("--group_by_length", action="store_true", default=False)
    p.add_argument("--gradient_checkpointing", action="store_true", default=False)
    p.add_argument("--do_train", action="store_true")
    p.add_argument("--do_eval", action="store_true")
    p.add_argument("--resume_from_checkpoint", default=None)
    p.add_argument("--seed", type=int, default=42)
    # device mesh: > 1 trains on a (data, model) mesh, a process per rank
    p.add_argument("--mesh_data", type=int, default=1)
    p.add_argument("--mesh_model", type=int, default=1)
    p.add_argument("--compute_dtype", default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="torch device (default cuda; raises without CUDA)")
    return p


def main(argv=None) -> dict:
    logging.basicConfig(level=logging.INFO)
    args = build_parser().parse_args(argv)

    import torch

    from ttasr_torch import resolve_device
    from ttasr_torch.models.whisper.load import load_whisper
    from ttasr_torch.text.tokenizer import load_tokenizer
    from ttasr_torch.train.data import iter_tsv_corpus, load_tsv_corpus, prepare_example
    from ttasr_torch.train.trainer import Trainer, TrainerConfig

    device = resolve_device(args.device)
    mesh = None
    if args.mesh_data * args.mesh_model > 1:
        from ttasr_torch.parallel.distributed import initialize_distributed
        from ttasr_torch.parallel.sharding import create_mesh

        initialize_distributed(backend="gloo" if device.type == "cpu" else "nccl")
        mesh = create_mesh(args.mesh_data, args.mesh_model)
    tokenizer = load_tokenizer(args.tokenizer_name or args.model_name_or_path)

    if args.streaming:
        # lazy per-epoch iterator: nothing materialized (train_asr.py:176-183)
        def train_examples():
            it = iter_tsv_corpus(args.corpus_data_dir,
                                 args.dataset_config_name,
                                 args.train_split_name)
            if args.max_train_samples:
                return itertools.islice(it, args.max_train_samples)
            return it
        logging.info("train corpus: streaming")
    else:
        train_examples = load_tsv_corpus(
            args.corpus_data_dir, args.dataset_config_name,
            args.train_split_name
        )
        if args.max_train_samples:
            train_examples = train_examples[: args.max_train_samples]
        logging.info("train=%d examples", len(train_examples))
    eval_examples = load_tsv_corpus(
        args.corpus_data_dir, args.dataset_config_name, args.eval_split_name
    ) if args.do_eval else []
    if args.max_eval_samples:
        eval_examples = eval_examples[: args.max_eval_samples]

    if args.preprocessing_only:
        # escape hatch (train_asr.py:656-659): verify preprocessing, exit
        source = train_examples() if callable(train_examples) else train_examples
        count = sum(
            1 for ex in source
            if prepare_example(ex, tokenizer, language=args.language,
                               task=args.task,
                               max_duration_s=args.max_duration_in_seconds)
            is not None
        )
        logging.info("preprocessing ok: %d usable examples", count)
        return {"preprocessed": count}

    # master params always f32; --compute_dtype bfloat16 = mixed precision
    # (forward cast in the loss fn, f32 grads/optimizer state)
    params, cfg = load_whisper(args.model_name_or_path, dtype=torch.float32,
                               device=device)

    tc = TrainerConfig(
        output_dir=args.output_dir,
        max_steps=args.max_steps,
        per_device_train_batch_size=args.per_device_train_batch_size,
        per_device_eval_batch_size=args.per_device_eval_batch_size,
        gradient_accumulation_steps=args.gradient_accumulation_steps,
        learning_rate=args.learning_rate,
        warmup_steps=args.warmup_steps,
        logging_steps=args.logging_steps,
        eval_steps=args.eval_steps,
        save_steps=args.save_steps,
        generation_max_length=args.generation_max_length,
        generation_num_beams=args.generation_num_beams,
        language=args.language,
        task=args.task,
        do_lower_case=args.do_lower_case,
        min_duration_in_seconds=args.min_duration_in_seconds,
        max_duration_in_seconds=args.max_duration_in_seconds,
        gradient_checkpointing=args.gradient_checkpointing,
        freeze_encoder=args.freeze_encoder,
        seed=args.seed,
        resume_from_checkpoint=args.resume_from_checkpoint,
        apply_spec_augment=args.apply_spec_augment,
        mask_time_prob=args.mask_time_prob,
        mask_time_length=args.mask_time_length,
        mask_time_min_masks=args.mask_time_min_masks,
        mask_feature_prob=args.mask_feature_prob,
        mask_feature_length=args.mask_feature_length,
        mask_feature_min_masks=args.mask_feature_min_masks,
        group_by_length=args.group_by_length,
        forced_decoder_ids=(json.loads(args.forced_decoder_ids)
                            if args.forced_decoder_ids else None),
        suppress_tokens=(json.loads(args.suppress_tokens)
                         if args.suppress_tokens else None),
        compute_dtype=args.compute_dtype,
    )
    os.makedirs(args.output_dir, exist_ok=True)
    trainer = Trainer(params, cfg, tokenizer, tc, mesh=mesh)
    del params  # on a mesh the trainer keeps the rank's slices

    metrics = {}
    if args.do_train:
        metrics.update(trainer.train(train_examples,
                                     eval_examples if args.do_eval else None))
    if args.do_eval and eval_examples:
        metrics.update(trainer.evaluate(eval_examples))
    logging.info("final metrics: %s", metrics)
    return metrics


if __name__ == "__main__":
    main()
