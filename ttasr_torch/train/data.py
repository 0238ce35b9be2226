"""TSV corpus loading and batch preparation (the port's copy of
``ttasr/train/data.py``).

Parity surface: reference train_asr.py:400-473 & 607-649 —
- corpora live at ``{corpus_data_dir}/{config}/{split}*.tsv`` with
  ``path<TAB>sentence`` rows; audio files under ``{config}/clips/{path}``
  (nested subdirs supported),
- ``+``-joined config names and split names concatenate datasets
  (train_asr.py:446-468, run.sh:20-22 ``train+validated``),
- 16 kHz mono cast, min/max duration filter (train_asr.py:642-649),
- labels = prefix tokens + BPE(sentence) + eot, padded to -100
  (collator, train_asr.py:268-319), lowercased when ``do_lower_case``.

The one change: ``collate_batch`` (and ``batch_iterator``, which calls it)
takes a ``device``, and the batch's ``mel`` is the port's log-mel tensor
computed there; the other fields stay numpy.
"""

from __future__ import annotations

import dataclasses
import glob
import os
import random
from typing import Iterator, List, Optional, Sequence

import numpy as np

from ttasr_torch.audio.io import load_audio, probe_num_samples
from ttasr_torch.ops.mel import HOP_LENGTH, N_FRAMES, N_SAMPLES, SAMPLE_RATE, log_mel_spectrogram

LABEL_PAD = -100


@dataclasses.dataclass
class CorpusExample:
    audio_path: str
    sentence: str


def load_tsv_corpus(corpus_data_dir: str, dataset_config_name: str,
                    split_name: str) -> List[CorpusExample]:
    """Load ``+``-joined configs x ``+``-joined splits, concatenated.

    Mirrors load_maybe_streaming_dataset (reference train_asr.py:400-468):
    file pattern ``{dir}/{config}/{split}*.tsv``.
    """
    return list(iter_tsv_corpus(corpus_data_dir, dataset_config_name,
                                split_name))


def iter_tsv_corpus(corpus_data_dir: str, dataset_config_name: str,
                    split_name: str) -> Iterator[CorpusExample]:
    """Streaming corpus iterator: yields rows without materializing.

    The true ``--streaming`` path (reference train_asr.py:176-183,
    400-468: HF IterableDataset) — a 200 h corpus never needs to fit in
    host RAM; rows stream from the TSVs in file order and audio decodes
    lazily in :func:`prepare_example`.
    """
    clip_dirs = []
    for config in dataset_config_name.split("+"):
        for split in split_name.split("+"):
            pattern = os.path.join(corpus_data_dir, config, f"{split}*.tsv")
            matches = sorted(glob.glob(pattern))
            if not matches:
                raise FileNotFoundError(f"no TSV matches {pattern}")
            clip_dirs.extend(matches)
    for tsv in clip_dirs:
        yield from _iter_tsv(tsv)


def _iter_tsv(path: str) -> Iterator[CorpusExample]:
    clips_dir = os.path.join(os.path.dirname(path), "clips")
    with open(path, encoding="utf-8") as fh:
        header = fh.readline().rstrip("\n").split("\t")
        try:
            path_col = header.index("path")
            sent_col = header.index("sentence")
        except ValueError:
            fh.seek(0)
            path_col, sent_col = 0, 1
        for line in fh:
            parts = line.rstrip("\n").split("\t")
            if len(parts) <= max(path_col, sent_col):
                continue
            rel, sentence = parts[path_col], parts[sent_col]
            if not rel or not sentence:
                continue
            yield CorpusExample(os.path.join(clips_dir, rel), sentence)


def prepare_example(example: CorpusExample, tokenizer, *,
                    language: str = "zh", task: str = "transcribe",
                    do_lower_case: bool = True,
                    min_duration_s: float = 0.0,
                    max_duration_s: float = 30.0,
                    timestamps: bool = False) -> Optional[dict]:
    """Decode audio + tokenize label; None when duration-filtered.

    ``timestamps=True`` trains the timestamp head too: the label becomes
    ``sot_seq(predict_timestamps) <|0.00|> text <|t_end|> eot`` with
    ``t_end`` the clip duration on the 0.02 s grid — the openai-whisper
    segment-label format, so a model fine-tuned this way drives the full
    timestamp-rule decode path (the reference's HF recipe trains
    notimestamps-only, train_asr.py:125-131)."""
    audio, _ = load_audio(example.audio_path, sr=SAMPLE_RATE)
    duration = len(audio) / SAMPLE_RATE
    if duration < min_duration_s or duration > max_duration_s:
        return None
    sentence = example.sentence.lower() if do_lower_case else example.sentence
    prefix = tokenizer.sot_sequence(language, task,
                                    predict_timestamps=timestamps)
    text_tokens = tokenizer.encode(sentence)
    if timestamps:
        ts0 = tokenizer.timestamp_begin
        t_end = min(int(round(duration / 0.02)), 1500)
        labels = (prefix + [ts0] + text_tokens + [ts0 + t_end, tokenizer.eot])
    else:
        labels = prefix + text_tokens + [tokenizer.eot]
    return {"audio": audio, "labels": labels, "sentence": sentence,
            "duration": duration}


def collate_batch(prepared: Sequence[dict], n_mels: int, eot: int,
                  max_label_len: int = 448, device="cpu") -> dict:
    """Batch: mel features + decoder inputs/targets with -100 masking.

    Teacher forcing: ``decoder_input = labels[:-1]``, ``target =
    labels[1:]`` (the HF collator's strip-BOS + shift-right combined;
    reference train_asr.py:297-317).
    """
    batch = len(prepared)
    audio = np.zeros((batch, N_SAMPLES), np.float32)
    num_frames = np.zeros((batch,), np.int32)
    for i, ex in enumerate(prepared):
        a = ex["audio"][:N_SAMPLES]
        audio[i, : len(a)] = a
        # valid mel frames per row: lets SpecAugment stay inside real
        # audio (the reference's forward_attention_mask role,
        # train_asr.py:590-619)
        num_frames[i] = min(len(a) // HOP_LENGTH, N_FRAMES)
    mel = log_mel_spectrogram(audio, n_mels=n_mels, device=device)

    label_len = min(max(len(ex["labels"]) for ex in prepared), max_label_len)
    inputs = np.full((batch, label_len - 1), eot, np.int32)
    targets = np.full((batch, label_len - 1), LABEL_PAD, np.int32)
    for i, ex in enumerate(prepared):
        lab = ex["labels"][:label_len]
        inputs[i, : len(lab) - 1] = lab[:-1]
        targets[i, : len(lab) - 1] = lab[1:]
    return {"mel": mel, "decoder_input_ids": inputs, "labels": targets,
            "num_frames": num_frames}


def length_grouped_order(lengths: Sequence[int], batch_size: int,
                         rng: random.Random,
                         mega_factor: int = 50) -> List[int]:
    """HF ``LengthGroupedSampler`` semantics (run.sh:33 group_by_length):
    shuffle, split into megabatches of ``batch_size * 50``, sort each by
    length descending, then swap the globally-longest element to the
    front so any OOM hits on step 1."""
    n = len(lengths)
    indices = list(range(n))
    rng.shuffle(indices)
    mega = batch_size * mega_factor
    megabatches = [
        sorted(indices[i : i + mega], key=lambda j: lengths[j], reverse=True)
        for i in range(0, n, mega)
    ]
    if megabatches and megabatches[0]:
        longest_mb = max(range(len(megabatches)),
                         key=lambda m: lengths[megabatches[m][0]])
        megabatches[0][0], megabatches[longest_mb][0] = (
            megabatches[longest_mb][0], megabatches[0][0],
        )
    return [j for mb in megabatches for j in mb]


def batch_iterator(examples, tokenizer, *,
                   batch_size: int, n_mels: int, seed: int = 0,
                   shuffle: bool = True, drop_last: bool = True,
                   epochs: Optional[int] = None, label_pad_to: int = 128,
                   group_by_length: bool = False, device="cpu",
                   **prep_kwargs) -> Iterator[dict]:
    """Host-side batching with fixed label padding (static shapes for jit).

    ``examples`` is either a materialized list or a zero-arg callable
    returning a fresh iterator per epoch (the ``--streaming`` path —
    reference train_asr.py:176-183: rows stream in file order, unshuffled,
    like an HF IterableDataset).
    """
    streaming = callable(examples)
    if group_by_length and streaming:
        raise ValueError("group_by_length requires a materialized dataset; "
                         "it cannot be combined with --streaming")
    rng = random.Random(seed)
    lengths: Optional[List[int]] = None
    epoch = 0
    while epochs is None or epoch < epochs:
        if streaming:
            source: Iterator[CorpusExample] = examples()
        elif group_by_length:
            if lengths is None:
                lengths = [probe_num_samples(ex.audio_path)
                           for ex in examples]
            order = length_grouped_order(lengths, batch_size, rng)
            source = (examples[i] for i in order)
        else:
            order = list(range(len(examples)))
            if shuffle:
                rng.shuffle(order)
            source = (examples[i] for i in order)
        buf: List[dict] = []
        for example in source:
            prepared = prepare_example(example, tokenizer, **prep_kwargs)
            if prepared is None:
                continue
            buf.append(prepared)
            if len(buf) == batch_size:
                batch = collate_batch(buf, n_mels, tokenizer.eot,
                                      max_label_len=label_pad_to + 1,
                                      device=device)
                batch = _pad_labels(batch, label_pad_to, tokenizer.eot)
                yield batch
                buf = []
        if buf and not drop_last:
            batch = collate_batch(buf, n_mels, tokenizer.eot,
                                  max_label_len=label_pad_to + 1, device=device)
            yield _pad_labels(batch, label_pad_to, tokenizer.eot)
        epoch += 1


def _pad_labels(batch: dict, label_pad_to: int, eot: int) -> dict:
    """Right-pad decoder inputs/targets to a fixed width (no recompiles)."""
    cur = batch["decoder_input_ids"].shape[1]
    if cur >= label_pad_to:
        batch["decoder_input_ids"] = batch["decoder_input_ids"][:, :label_pad_to]
        batch["labels"] = batch["labels"][:, :label_pad_to]
        return batch
    pad = label_pad_to - cur
    batch["decoder_input_ids"] = np.pad(
        batch["decoder_input_ids"], ((0, 0), (0, pad)), constant_values=eot
    )
    batch["labels"] = np.pad(
        batch["labels"], ((0, 0), (0, pad)), constant_values=LABEL_PAD
    )
    return batch
