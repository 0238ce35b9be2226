"""The port's fine-tuning host layers against the JAX package's on the CPU:
the corpus and batches (``ttasr_torch/train/data.py``), checkpoints
(``ttasr_torch/core/checkpoint.py``), the ``Trainer`` (resume, its data
order, ``evaluate``) and ``python -m ttasr_torch.cli.train``.

- Batches: token arrays and ``num_frames`` equal, the mel within 1e-4 (the
  port's log-mel against the JAX package's, as ``test_torch_ops.py``
  holds it), for the shuffled, the length-grouped and the streaming
  iterators.
- Checkpoints: a restored state equals the saved one bit for bit (params,
  moments, counters, the accumulator); ``get_last_checkpoint``, the
  ``keep=3`` cleanup and the resume precedence are the JAX package's.
- A resumed run replays the epoch from its first batch (ROADMAP C8) and
  keys SpecAugment off the restored step: bit for bit the steps taken by
  hand from the restored state.
- ``evaluate`` on ``micro64-test`` weights moved by ``params_from_jax``:
  the same hypotheses as the JAX ``Trainer`` at T = 0 (greedy, beams 2,
  ``forced_decoder_ids`` with ``suppress_tokens``) and the same CER.
- The CLI: ``--device cpu`` end to end, ``--preprocessing_only``, no run
  without CUDA unless ``--device cpu``, a mesh in one process raises, and
  ``--mesh_data 2`` on two ``gloo`` ranks started with torchrun's
  variables writes the checkpoint and the model of the one-process run
  (params and moments within rtol 2e-5, atol 2e-6; the counters equal).
"""

import dataclasses
import functools
import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ttasr.models.whisper import model as jm
from ttasr.models.whisper.config import PRESETS as J_PRESETS
from ttasr.text.tokenizer import build_byte_fallback_tokenizer as j_tokenizer
from ttasr.train import data as jd
from ttasr.train import trainer as jt
from ttasr_torch.core import checkpoint as ck
from ttasr_torch.models.whisper.config import PRESETS as T_PRESETS
from ttasr_torch.models.whisper.load import params_from_jax
from ttasr_torch.text.tokenizer import build_byte_fallback_tokenizer as t_tokenizer
from ttasr_torch.train import data as td
from ttasr_torch.train import train_step as tts
from ttasr_torch.train import trainer as tt

NAME = "micro64-test"
JTOK, TTOK = j_tokenizer(), t_tokenizer()
CORPUS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "sample_corpus")
MEL_ABS = 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The micro model's eager ops run faster on one thread, and the suite
    runs several workers to a machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _jax_params():
    return jm.init_params(J_PRESETS[NAME], seed=0, dtype=jnp.float32)


def _port_params():
    return params_from_jax(jax.tree.map(np.asarray, _jax_params()), dtype=torch.float32)


def _examples(split="train", config="train_ds_01"):
    return (jd.load_tsv_corpus(CORPUS, config, split),
            td.load_tsv_corpus(CORPUS, config, split))


# ---------------------------------------------------------------------------
# Data
# ---------------------------------------------------------------------------

def test_corpus_and_examples_match_jax():
    for config, split in (("train_ds_01", "train"), ("train_ds_01+train_ds_02",
                                                      "train+validated")):
        want, got = _examples(split, config)
        assert [(e.audio_path, e.sentence) for e in got] == [
            (e.audio_path, e.sentence) for e in want]
    for w, g in zip(*_examples()):
        for kw in ({}, dict(timestamps=True), dict(max_duration_s=0.5)):
            pw, pg = jd.prepare_example(w, JTOK, **kw), td.prepare_example(g, TTOK, **kw)
            assert (pw is None) == (pg is None)
            if pw is not None:
                assert pg["labels"] == pw["labels"] and pg["sentence"] == pw["sentence"]
                assert np.array_equal(pg["audio"], pw["audio"])
        assert td.probe_num_samples(g.audio_path) == jd.probe_num_samples(w.audio_path)


@pytest.mark.parametrize("mode", ["shuffled", "group_by_length", "streaming"])
def test_batch_iterator_matches_jax(mode):
    want_ex, got_ex = _examples("train+validated", "train_ds_01+train_ds_02")
    kw = dict(batch_size=3, n_mels=80, seed=5, label_pad_to=24, epochs=1)
    if mode == "group_by_length":
        kw["group_by_length"] = True
    if mode == "streaming":
        want_list, got_list = want_ex, got_ex
        want_ex, got_ex = (lambda: iter(want_list)), (lambda: iter(got_list))
        kw["drop_last"] = False
    want = list(jd.batch_iterator(want_ex, JTOK, **kw))
    got = list(td.batch_iterator(got_ex, TTOK, **kw))
    assert len(got) == len(want) >= 3
    for g, w in zip(got, want):
        for key in ("decoder_input_ids", "labels", "num_frames"):
            assert np.array_equal(g[key], w[key]), key
        assert isinstance(g["mel"], torch.Tensor) and g["mel"].shape == w["mel"].shape
        assert np.abs(g["mel"].numpy() - w["mel"]).max() <= MEL_ABS
    if mode == "streaming":
        with pytest.raises(ValueError, match="group_by_length"):
            next(td.batch_iterator(got_ex, TTOK, group_by_length=True, **kw))


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------

def _state_after_one_micro_step():
    """A state with every field set: moments, counters and a running
    accumulator (two micro-batches a step, one taken)."""
    opt = dataclasses.replace(tts.make_optimizer(learning_rate=1e-3, warmup_steps=0,
                                                 total_steps=10), every_k=2)
    state = tts.init_train_state(_port_params(), opt)
    step = tts.make_train_step(T_PRESETS[NAME], opt)
    batch = next(td.batch_iterator(_examples()[1], TTOK, batch_size=2, n_mels=80,
                                   label_pad_to=16))
    for _ in range(3):
        state, _ = step(state, batch)
    return state, opt


def _assert_states_equal(a, b):
    da, db = a.state_dict(), b.state_dict()
    assert da.keys() == db.keys()
    assert all(torch.equal(da[k], db[k]) for k in da)


def test_checkpoint_round_trip_and_cleanup(tmp_path):
    state, opt = _state_after_one_micro_step()
    assert (state.step, state.opt_state.count, state.opt_state.mini_step) == (3, 1, 1)
    out = str(tmp_path)
    assert ck.get_last_checkpoint(out) is None
    for step in (5, 10, 15, 20):
        ck.save_checkpoint(out, step, state)
    names = sorted(os.listdir(out))
    assert names == ["checkpoint-10", "checkpoint-15", "checkpoint-20"]
    last = ck.get_last_checkpoint(out)
    assert last.endswith("checkpoint-20")
    fresh = tts.init_train_state(_port_params(), opt)
    restored = ck.restore_checkpoint(last, fresh)
    assert restored is fresh
    _assert_states_equal(restored, state)
    assert any(float(v.abs().max()) > 0 for v in restored.opt_state.acc.values())
    # the bare params: the final export
    ck.save_params(os.path.join(out, "model"), state.params)
    back = ck.restore_params(os.path.join(out, "model"), _port_params())
    assert all(torch.equal(a, b) for a, b in zip(ck.named_leaves(back).values(),
                                                 ck.named_leaves(state.params).values()))
    flat = ck.restore_params(os.path.join(out, "model"))
    assert flat.keys() == ck.named_leaves(state.params).keys()
    with pytest.raises(ValueError, match="names differ"):
        ck.restore_checkpoint(last, tts.init_train_state(_port_params(),
                                                         tts.make_optimizer()))


def _trainer(out, **kw):
    cfg = dict(output_dir=out, max_steps=4, per_device_train_batch_size=2,
               learning_rate=1e-3, warmup_steps=1, logging_steps=1, save_steps=2,
               eval_steps=1000, gradient_checkpointing=False, label_pad_to=16,
               apply_spec_augment=True, seed=3)
    cfg.update(kw)
    return tt.Trainer(_port_params(), T_PRESETS[NAME], TTOK, tt.TrainerConfig(**cfg))


def test_resume_replays_the_epoch_from_its_first_batch(tmp_path):
    """A run of 4 steps saving every 2, resumed from checkpoint-2 by a
    fresh ``Trainer``: its steps 3 and 4 take the epoch's first two
    batches again (the JAX package's behaviour, ROADMAP C8), with the
    SpecAugment masks of steps 3 and 4; bit for bit the same steps taken by
    hand from the restored state."""
    out = str(tmp_path / "run")
    first = _trainer(out, max_steps=2)
    first.train(_examples()[1])
    assert {"checkpoint-2", "metrics.jsonl", "model"} <= set(os.listdir(out))
    assert "checkpoint-4" not in os.listdir(out)
    resumed = _trainer(out)
    metrics = resumed.train(_examples()[1])
    assert resumed.state.step == 4 and np.isfinite(metrics["train_loss"])
    assert {"checkpoint-2", "checkpoint-4"} <= set(os.listdir(out))

    by_hand = _trainer(str(tmp_path / "by_hand"))
    ck.restore_checkpoint(os.path.join(out, "checkpoint-2"), by_hand.state)
    it = td.batch_iterator(_examples()[1], TTOK, batch_size=2, n_mels=80, seed=3,
                           label_pad_to=16)
    for _ in range(2):
        by_hand.state, _ = by_hand.train_step(by_hand.state, next(it))
    _assert_states_equal(resumed.state, by_hand.state)
    records = [json.loads(line) for line in open(os.path.join(out, "metrics.jsonl"))]
    assert [r["step"] for r in records] == [1, 2, 3, 4]


def test_resume_precedence(tmp_path):
    """``resume_from_checkpoint`` wins over the newest ``checkpoint-N``."""
    out = str(tmp_path)
    trainer = _trainer(out)
    ck.save_checkpoint(out, 1, trainer.state)
    older = trainer.state.state_dict()
    trainer.state.step = 9
    ck.save_checkpoint(out, 9, trainer.state)
    assert _trainer(out).maybe_resume() == 9
    chosen = _trainer(out, resume_from_checkpoint=os.path.join(out, "checkpoint-1"))
    assert chosen.maybe_resume() == 0
    assert all(torch.equal(v, older[k]) for k, v in chosen.state.state_dict().items())
    assert _trainer(str(tmp_path / "empty")).maybe_resume() == 0


def test_trainer_mesh_raises(tmp_path):
    """A mesh without its process groups raises, naming
    ``initialize_distributed``; the CLI's two-rank run below trains on
    one."""
    from ttasr_torch.parallel import sharding

    shape = {"data": 2, "model": 1}
    mesh = sharding.Mesh(shape=shape, coords=sharding.mesh_coords(shape, 0), groups={})
    with pytest.raises(RuntimeError, match="initialize_distributed"):
        tt.Trainer(_port_params(), T_PRESETS[NAME], TTOK,
                   tt.TrainerConfig(output_dir=str(tmp_path)), mesh=mesh)
    assert not os.listdir(tmp_path)


# ---------------------------------------------------------------------------
# evaluate
# ---------------------------------------------------------------------------

def _hyps(module, monkeypatch):
    seen = {}

    def capture(refs, hyps, **kw):
        seen["refs"], seen["hyps"] = list(refs), list(hyps)
        return 0.5

    monkeypatch.setattr(module, "cer_metric", capture)
    return seen


@pytest.mark.parametrize("case", ["greedy", "beams2", "forced_suppressed"])
def test_evaluate_matches_jax(case, tmp_path, monkeypatch):
    kw = dict(output_dir=str(tmp_path), per_device_eval_batch_size=2,
              generation_max_length=12)
    if case == "beams2":
        kw["generation_num_beams"] = 2
    if case == "forced_suppressed":
        kw["forced_decoder_ids"] = [[1, JTOK.sot_sequence("zh", "transcribe")[1]],
                                    [2, JTOK.no_timestamps]]
        kw["suppress_tokens"] = list(range(100, 140))
    want_ex, got_ex = _examples("test", "train_ds_01+train_ds_02")
    want_ex, got_ex = want_ex[:3], got_ex[:3]  # a full chunk and a padded one
    jseen, tseen = _hyps(jt, monkeypatch), _hyps(tt, monkeypatch)
    want = jt.Trainer(jax.tree.map(jnp.array, _jax_params()), J_PRESETS[NAME], JTOK,
                      jt.TrainerConfig(**kw)).evaluate(want_ex)
    got = tt.Trainer(_port_params(), T_PRESETS[NAME], TTOK,
                     tt.TrainerConfig(**kw)).evaluate(got_ex)
    assert got == want == {"eval_cer": 0.5, "eval_samples": 3}
    assert tseen == jseen
    assert any(tseen["hyps"]), tseen


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------

CLI_ARGS = ["--model_name_or_path", NAME, "--corpus_data_dir", CORPUS,
            "--dataset_config_name", "train_ds_01", "--language", "zh"]


def test_cli_trains_and_evaluates_on_the_cpu(tmp_path):
    from ttasr_torch.cli.train import main

    out = str(tmp_path / "out")
    metrics = main(CLI_ARGS + [
        "--output_dir", out, "--device", "cpu", "--max_steps", "2",
        "--per_device_train_batch_size", "2", "--per_device_eval_batch_size", "2",
        "--logging_steps", "1", "--save_steps", "1000", "--warmup_steps", "1",
        "--generation_max_length", "8", "--max_eval_samples", "2",
        "--gradient_checkpointing", "--compute_dtype", "bfloat16",
        "--apply_spec_augment", "--do_train", "--do_eval"])
    assert np.isfinite(metrics["train_loss"]) and metrics["steps"] == 2
    assert 0.0 <= metrics["eval_cer"] and metrics["eval_samples"] == 2
    assert os.path.isdir(os.path.join(out, "checkpoint-2"))
    assert os.path.isfile(os.path.join(out, "model", ck.PARAMS_FILE))
    records = [json.loads(line) for line in open(os.path.join(out, "metrics.jsonl"))]
    assert [r["step"] for r in records] == [1, 2] and all(np.isfinite(r["loss"])
                                                          for r in records)


def test_cli_preprocessing_only_matches_jax(tmp_path):
    from ttasr.cli.train import main as j_main
    from ttasr_torch.cli.train import main

    args = ["--model_name_or_path", NAME, "--corpus_data_dir", CORPUS,
            "--dataset_config_name", "train_ds_01+train_ds_02",
            "--output_dir", str(tmp_path), "--preprocessing_only"]
    got = main(args + ["--device", "cpu"])
    assert got == j_main(args) == {"preprocessed": 8}
    assert main(args + ["--device", "cpu", "--streaming"]) == {"preprocessed": 8}


def test_cli_needs_cuda_unless_told_cpu_and_refuses_a_mesh(tmp_path, monkeypatch):
    from ttasr_torch.cli.train import main

    args = CLI_ARGS + ["--output_dir", str(tmp_path), "--do_train", "--max_steps", "1"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        main(args)
    with pytest.raises(RuntimeError, match="mesh 2x1 needs 2 ranks"):
        main(args + ["--device", "cpu", "--mesh_data", "2"])
    assert not os.listdir(tmp_path)


_RANK = """
import importlib.abc, runpy, sys

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "ttasr", "tools"):
            raise ImportError("blocked: " + name)

sys.meta_path.insert(0, Block())
sys.argv = ["train"] + {args!r}
runpy.run_module("ttasr_torch.cli.train", run_name="__main__")
"""


def test_cli_on_two_gloo_ranks_writes_the_one_process_checkpoint(tmp_path):
    """``--device cpu --mesh_data 2`` under torchrun's variables (RANK,
    WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE, MASTER_ADDR, MASTER_PORT) on
    two processes: a global batch of 2, a row a rank.  Rank 0 alone writes
    ``metrics.jsonl``, ``checkpoint-2/`` and ``model/``, and they hold what
    the one-process run writes."""
    from ttasr_torch.cli.train import main

    args = CLI_ARGS + ["--device", "cpu", "--max_steps", "2", "--do_train",
                       "--per_device_train_batch_size", "2", "--logging_steps", "1",
                       "--save_steps", "1000", "--warmup_steps", "0", "--seed", "3"]
    one, two = str(tmp_path / "one"), str(tmp_path / "two")
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = dict(os.environ, WORLD_SIZE="2", LOCAL_WORLD_SIZE="2", MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(port), OMP_NUM_THREADS="1")
    env.pop("PYTHONPATH", None)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANK.format(args=args + ["--output_dir", two,
                                                         "--mesh_data", "2"])],
        env=dict(env, RANK=str(r), LOCAL_RANK=str(r)), cwd=root, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    try:
        want = main(args + ["--output_dir", one])
        outputs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, out in zip(procs, outputs):
        assert p.returncode == 0, out[-3000:]
    for out in (one, two):
        assert sorted(os.listdir(out)) == ["checkpoint-2", "metrics.jsonl", "model", "runs"]
    got_records, want_records = (
        [json.loads(line) for line in open(os.path.join(out, "metrics.jsonl"))]
        for out in (two, one))
    assert [r["step"] for r in got_records] == [1, 2] == [r["step"] for r in want_records]
    assert abs(got_records[-1]["loss"] - want["train_loss"]) <= 1e-4  # rounded to 4
    got, ref = (torch.load(os.path.join(out, "checkpoint-2", ck.STATE_FILE),
                           weights_only=True) for out in (two, one))
    assert got.keys() == ref.keys()
    for k in ("step", "count", "mini_step"):
        assert int(got[k]) == int(ref[k]), k
    for k, v in ref.items():
        assert got[k].shape == v.shape and got[k].dtype == v.dtype, k
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=2e-5, atol=2e-6,
                                   err_msg=k)
    state = got
    got, ref = (torch.load(os.path.join(out, "model", ck.PARAMS_FILE), weights_only=True)
                for out in (two, one))
    assert got.keys() == ref.keys()
    assert all(torch.equal(v, state[f"params/{k}"]) for k, v in got.items())
