"""The port's tools against the JAX package's on the CPU
(``ttasr_torch/core/flops.py`` and ``ttasr_torch/tools/``).

- ``core/flops.py``'s counts equal ``ttasr/core/flops.py``'s for every
  preset, and ``peak_tflops`` is the H100's dense bf16 peak, which
  ``chip_smoke.PEAK_OPS_PER_S`` holds too (``TTASR_PEAK_TFLOPS`` overrides
  it, as in the original).
- ``check_trained_recognition``: the trainer's batches with the tool's
  labels (timestamps, padded to 64) equal the JAX ``Trainer``'s; ``python
  -m ttasr_torch.tools.check_trained_recognition --device cpu --steps 2``
  prints the original's keys, and without ``--device cpu`` it raises where
  CUDA is absent.
- ``profile_decode`` refuses ``--device cpu`` and raises without CUDA.

``check_beam_divergence`` is in ``tests/test_torch_beam_divergence.py``.
"""

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from ttasr.core import flops as j_flops
from ttasr.models.whisper.config import PRESETS as J_PRESETS
from ttasr.text.tokenizer import build_byte_fallback_tokenizer as j_tokenizer
from ttasr.train import data as jd
from ttasr_torch.core import flops as t_flops
from ttasr_torch.models.whisper.config import PRESETS as T_PRESETS
from ttasr_torch.text.tokenizer import build_byte_fallback_tokenizer as t_tokenizer
from ttasr_torch.tools import check_trained_recognition as t_rec
from ttasr_torch.tools import profile_decode
from ttasr_torch.train import data as td

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAME = "micro64-test"
MEL_ABS = 1e-4
# the original's keys (tools/check_trained_recognition.py run_check)
RECOGNITION_KEYS = {"model", "compute", "e2e_trained_cer_greedy", "e2e_trained_cer_beam5",
                    "train_loss", "steps", "clips", "vad_all_detected", "timestamps_sane",
                    "per_clip"}
NO_CUDA = "import torch; torch.cuda.is_available = lambda: False; "


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_flops_counts_are_the_originals(monkeypatch):
    assert J_PRESETS.keys() == T_PRESETS.keys()
    for name in J_PRESETS:
        jc, tc = J_PRESETS[name], T_PRESETS[name]
        for batch in (1, 48):
            assert t_flops.encoder_flops(tc, batch) == j_flops.encoder_flops(jc, batch)
            for beam, prompt, new in ((5, 16, 128), (1, 144, 224)):
                assert (t_flops.decode_flops(tc, batch, beam, prompt, new)
                        == j_flops.decode_flops(jc, batch, beam, prompt, new))
    monkeypatch.delenv("TTASR_PEAK_TFLOPS", raising=False)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_peaks", os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert t_flops.peak_tflops() * 1e12 == smoke.PEAK_OPS_PER_S["bf16"] == 989e12
    monkeypatch.setenv("TTASR_PEAK_TFLOPS", "756.5")
    assert t_flops.peak_tflops() == 756.5


def test_recognition_labels_match_jax(tmp_path):
    examples = t_rec.make_clips(6, 0, str(tmp_path))
    tc = t_rec.trainer_config(str(tmp_path / "out"), 800, len(examples), 3e-3)
    assert (tc.label_pad_to, tc.predict_timestamps, tc.gradient_checkpointing,
            tc.per_device_train_batch_size, tc.warmup_steps) == (64, True, False, 6, 20)
    j_examples = [jd.CorpusExample(e.audio_path, e.sentence) for e in examples]
    kw = dict(batch_size=tc.per_device_train_batch_size, n_mels=T_PRESETS[NAME].num_mel_bins,
              seed=tc.seed, label_pad_to=tc.label_pad_to, epochs=1,
              timestamps=tc.predict_timestamps)
    want = list(jd.batch_iterator(j_examples, j_tokenizer(), **kw))
    got = list(td.batch_iterator(examples, t_tokenizer(), **kw))
    assert len(got) == len(want) == 1
    for key in ("decoder_input_ids", "labels", "num_frames"):
        assert np.array_equal(got[0][key], want[0][key]), key
    assert np.abs(got[0]["mel"].numpy() - want[0]["mel"]).max() <= MEL_ABS
    tok = t_tokenizer()
    assert tok.timestamp_begin in got[0]["labels"][0]  # timestamp labels


def test_recognition_cli_prints_the_originals_keys(tmp_path):
    out = str(tmp_path / "check.json")
    env = dict(os.environ, OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, "-m", "ttasr_torch.tools.check_trained_recognition",
                           "--device", "cpu", "--steps", "2", "--clips", "2", "--out-json", out],
                          capture_output=True, text=True, cwd=REPO, timeout=600, env=env)
    assert proc.returncode in (0, 1), proc.stderr[-2000:]  # 1: the CER gate
    with open(out, encoding="utf-8") as fh:
        result = json.load(fh)
    assert RECOGNITION_KEYS <= result.keys()
    assert result["steps"] == 2 and result["clips"] == len(result["per_clip"]) == 2
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == result
    proc = subprocess.run([sys.executable, "-c", NO_CUDA + "import sys; "
                           "from ttasr_torch.tools import check_trained_recognition as c; "
                           "c.main(['--steps', '1'])"],
                          capture_output=True, text=True, cwd=REPO, timeout=120)
    assert proc.returncode != 0 and "CUDA is not available" in proc.stderr


def test_profile_decode_needs_the_card(monkeypatch):
    with pytest.raises(RuntimeError, match="--device cpu is refused"):
        profile_decode.main(["--device", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        profile_decode.main(["--batch", "1"])
    # every wrapped stage is a function that the beam step looks up in decode.py
    from ttasr_torch.models.whisper import decode as dm

    assert all(callable(getattr(dm, name)) for name in profile_decode.STAGES)
    assert profile_decode.LAYER_STAGES == {"qkv_int8_fused", "self_attn_step_indirect_int8",
                                           "attnout_ln_q_cross_int8", "mlp_with_crossout_int8"}
