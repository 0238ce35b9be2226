"""The port's recognition check against the JAX package's on the CPU.

A module fixture trains ``micro64-test`` with the JAX ``Trainer`` as
``tools/check_trained_recognition.py`` does (timestamp labels, labels
padded to 64, no remat, lr 3e-3 with 20 warm-up steps) for ``STEPS``
steps on the tool's clips, which by then decode to the start of their
sentences; ``params_from_jax`` moves the weights to the port.  Each of
``CLIPS`` clips then goes through the JAX ``WhisperEngine.transcribe``
and the port's ``transcribe_clips`` with the tool's keywords at T = 0
(the sampled fallback draws from different generators): the same text
and segment times within 0.02 s, greedy and beam 5, VAD on, float32 and
int8 on the float32 weights, which the tool serves to both engines as they
are (ROADMAP C9: the card's row kernels take float32 rows).  The
int8 engines run the float encoder on the int8 weights
(``encoder_act_int8=False``): the JAX package's s8 x s8 encoder runs only
on a TPU (its CPU reference is ``tests/test_torch_int8_encoder.py``); the
decode is the fused path, Pallas in interpret mode against the port's
plain versions.  The clips are the port's ``make_clips`` output, byte
for byte the JAX tool's WAVs.

The tool's labels, its CLI and the other tools are in
``tests/test_torch_tools.py``.
"""

import os
import sys
import wave

import jax
import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))

from tools import check_trained_recognition as j_tool  # noqa: E402
from ttasr.engine.transcriber import WhisperEngine as JEngine  # noqa: E402
from ttasr.models.whisper.config import get_config as j_config  # noqa: E402
from ttasr.models.whisper.model import init_params as j_init  # noqa: E402
from ttasr.text.tokenizer import build_byte_fallback_tokenizer  # noqa: E402
from ttasr.train.data import CorpusExample as JExample  # noqa: E402
from ttasr.train.trainer import Trainer as JTrainer  # noqa: E402
from ttasr.train.trainer import TrainerConfig as JTrainerConfig  # noqa: E402
from ttasr_torch.engine.transcriber import WhisperEngine as TEngine  # noqa: E402
from ttasr_torch.models.whisper.config import get_config as t_config  # noqa: E402
from ttasr_torch.models.whisper.load import params_from_jax  # noqa: E402
from ttasr_torch.tools import check_trained_recognition as t_tool  # noqa: E402

MODEL = "micro64-test"
STEPS = 40   # the tool's 800 took 9 min 20 s on this CPU
CLIPS = 2
LR = 3e-3
TOK = build_byte_fallback_tokenizer()
T0 = dict(temperature=0.0)
TIME_ABS = 0.02


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The micro model's eager ops run faster on one thread, and the suite
    runs several workers to a machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_clips(tmp):
    """The JAX tool's clips: its synthesizer and WAV writer on its seed."""
    from train_vad import synth_speech

    rng = np.random.default_rng(0)
    examples = []
    for i in range(6):
        audio, _ = synth_speech(rng, seconds=float(rng.uniform(2.0, 3.0)))
        path = os.path.join(tmp, f"jax{i}.wav")
        j_tool._write_wav(path, audio)
        examples.append(JExample(audio_path=path, sentence=j_tool.SENTENCES[i]))
    return examples


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("recognition"))
    j_examples = _jax_clips(tmp)
    t_examples = t_tool.make_clips(6, 0, tmp)
    cfg = j_config(MODEL)
    tc = JTrainerConfig(
        output_dir=os.path.join(tmp, "out"), max_steps=STEPS,
        per_device_train_batch_size=6, learning_rate=LR, warmup_steps=20,
        logging_steps=50, eval_steps=10 ** 9, save_steps=10 ** 9, label_pad_to=64,
        gradient_checkpointing=False, predict_timestamps=True)
    trainer = JTrainer(j_init(cfg, seed=0), cfg, TOK, tc)
    metrics = trainer.train(j_examples)
    return dict(jparams=trainer.state.params, j_examples=j_examples,
                t_examples=t_examples, loss=metrics["train_loss"])


def test_clips_are_the_jax_tools(trained):
    for j, t in zip(trained["j_examples"], trained["t_examples"]):
        assert t.sentence == j.sentence
        frames = []
        for path in (j.audio_path, t.audio_path):
            with wave.open(path, "rb") as wf:
                frames.append((wf.getparams(), wf.readframes(wf.getnframes())))
        assert frames[0] == frames[1]


@pytest.mark.parametrize("compute", ["float32", "int8"])
def test_transcripts_match_jax(trained, compute):
    assert np.isfinite(trained["loss"])
    kw = {} if compute == "float32" else dict(encoder_act_int8=False)
    cfg = j_config(MODEL)
    je = JEngine(MODEL, params=trained["jparams"], config=cfg, tokenizer=TOK,
                 compute_type=compute, **kw)
    te = TEngine(MODEL, params=params_from_jax(jax.tree.map(np.asarray, trained["jparams"])),
                 config=t_config(MODEL), tokenizer=TOK, compute_type=compute, device="cpu",
                 **kw)
    examples = trained["t_examples"][:CLIPS]
    _, got = t_tool.transcribe_clips(te, examples, **T0)
    texts = []
    for i, ex in enumerate(examples):
        for beam in (1, 5):
            segs, info = je.transcribe(ex.audio_path, beam_size=beam,
                                       **{**t_tool.TRANSCRIBE_KWARGS, **T0})
            want = "".join(s.text for s in segs)
            assert got[beam][i] == want, (compute, beam, i)
            texts.append(want)
            port_segs, port_info = te.transcribe(ex.audio_path, beam_size=beam,
                                                 **{**t_tool.TRANSCRIBE_KWARGS, **T0})
            assert port_info.duration_after_vad == info.duration_after_vad
            assert [s.text for s in port_segs] == [s.text for s in segs]
            for p, w in zip(port_segs, segs):
                assert abs(p.start - w.start) <= TIME_ABS and abs(p.end - w.end) <= TIME_ABS
    # the model has learned some of the sentences' characters
    assert any(ch in "".join(texts) for ch in "".join(j_tool.SENTENCES))


def test_the_int8_engine_serves_the_float32_params_as_they_are(trained):
    """The tool hands the trained float32 params to the int8 engine with no
    cast (ROADMAP C9): the engine quantizes the matmul weights and keeps
    every other leaf, and the s8 x s8 encoder's float32 rows, in float32."""
    params = params_from_jax(jax.tree.map(np.asarray, trained["jparams"]))
    engine = TEngine(MODEL, params=params, config=t_config(MODEL), tokenizer=TOK,
                     compute_type="int8", device="cpu")
    enc = engine.params["encoder"]
    assert enc["conv1_w"].dtype == torch.float32 and enc["blocks"][0]["ln1_s"].dtype == torch.float32
    assert enc["blocks"][0]["w1"]["q"].dtype == torch.int8
    assert engine.params["decoder"]["blocks"][0]["bo"].dtype == torch.float32
    out = engine.encode_windows(np.zeros(16000, np.float32))
    assert out.dtype == torch.float32 and bool(torch.isfinite(out).all())
