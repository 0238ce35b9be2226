"""Fine-tuning pipeline: TSV corpus loading, the train step, torch.save
checkpointing, CER evaluation (port of ``ttasr/train``).

Replaces the reference's PyTorch/HF Seq2SeqTrainer stack (train_asr.py +
run.sh) with the JAX package's loop and step semantics, on one card or a
mesh of them.
"""

from ttasr_torch.train.data import load_tsv_corpus, CorpusExample, batch_iterator
from ttasr_torch.train.train_step import (
    make_train_step,
    make_optimizer,
    cross_entropy_loss,
    TrainState,
)

__all__ = [
    "load_tsv_corpus", "CorpusExample", "batch_iterator",
    "make_train_step", "make_optimizer", "cross_entropy_loss", "TrainState",
]
