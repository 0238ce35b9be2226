"""The port's batch CLI and device checks on the CPU.

- the CLI folder function with the port engine (``micro64-test`` f32
  weights moved from the JAX package's seeded init by ``params_from_jax``),
  and its entry point in the sequential mode and with ``--concurrency 2``
  (the served modes are held against the JAX CLI in
  ``tests/test_torch_batched.py``);
- the engine and the CLI raise without CUDA, and the int8 engine returns
  words with ``word_timestamps=True``;
- ``chip_smoke.py`` exits non-zero, printing no result, without a card.

The engine's parity with the JAX engine is in
``tests/test_torch_engine_parity.py``.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tools.train_vad import synth_speech
from ttasr.audio.io import write_wav
from ttasr.models.whisper import model as jm
from ttasr.models.whisper.config import PRESETS as J_PRESETS
from ttasr.text.tokenizer import build_byte_fallback_tokenizer
from ttasr_torch.cli import asr as t_cli
from ttasr_torch.engine import transcriber as t_tr
from ttasr_torch.engine.transcriber import WhisperEngine as TEngine
from ttasr_torch.models.whisper.config import PRESETS as T_PRESETS
from ttasr_torch.models.whisper.load import params_from_jax

TOK = build_byte_fallback_tokenizer()
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAME = "micro64-test"


@pytest.fixture(scope="module")
def engines_f32():
    """(None, the port's f32 engine) on the JAX package's seeded weights,
    the shape of ``tests/test_torch_engine_parity.py``'s fixture."""
    jp = jm.init_params(J_PRESETS[NAME], seed=0, dtype=jnp.float32)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), dtype=torch.float32)
    return None, TEngine(NAME, compute_type="float32", params=tp,
                         config=T_PRESETS[NAME], tokenizer=TOK, device="cpu")


def test_cli_folder_with_port_engine(engines_f32, tmp_path):
    _, te = engines_f32
    audio_dir = tmp_path / "audio"
    audio_dir.mkdir()
    for seed in (3, 4):
        audio, _ = synth_speech(np.random.default_rng(seed), 4.0)
        write_wav(str(audio_dir / f"s{seed}.wav"), audio, 16000)
    (audio_dir / "s3.txt").write_text("你好", encoding="utf-8")
    result = t_cli.process_audio_folder(str(audio_dir), engine=te,
                                        results_json_dir=str(tmp_path))
    assert result is not None
    entries = result["detailed_results"]
    assert [e["audio_file"] for e in entries] == ["s3.wav", "s4.wav"]
    assert all("error" not in e for e in entries)
    assert entries[0]["has_original_transcript"] and entries[0]["cer_result"]
    assert (audio_dir / "s4_asr.txt").exists()
    assert (tmp_path / "asr_comparison_results.json").exists()
    assert t_cli.process_audio_folder(str(tmp_path / "none"), engine=te,
                                      results_json_dir=str(tmp_path)) is None



def test_cli_main_entry_point(tmp_path, monkeypatch):
    """``python -m ttasr_torch.cli.asr <folder> --model ... --device cpu``:
    builds the engine from a preset, writes the results JSON in the CWD."""
    audio_dir = tmp_path / "audio"
    audio_dir.mkdir()
    audio, _ = synth_speech(np.random.default_rng(5), 3.0)
    write_wav(str(audio_dir / "a.wav"), audio, 16000)
    monkeypatch.chdir(tmp_path)
    t_cli.main([str(audio_dir), "--model", NAME, "--device", "cpu"])
    results = tmp_path / "asr_comparison_results.json"
    assert results.exists()
    assert (audio_dir / "a_asr.txt").exists()
    results.unlink()
    # the served run's ladder at T = 0 only: on random weights every rung
    # fails its gates, and each sampled rung is best_of requests
    parse = t_tr._parse_transcribe_kwargs
    monkeypatch.setattr(t_tr, "_parse_transcribe_kwargs",
                        lambda kwargs: parse(dict(kwargs, temperature=(0.0,))))
    t_cli.main([str(audio_dir), "--model", NAME, "--device", "cpu",
                "--concurrency", "2"])
    entries = json.loads(results.read_text(encoding="utf-8"))["detailed_results"]
    assert [e["audio_file"] for e in entries] == ["a.wav"]
    assert "error" not in entries[0]



def test_engine_rejects_unported_and_missing_device(monkeypatch):
    # the int8 engine builds with its defaults and aligns words on its
    # quantized, fused weights (the alignment's parity is in
    # tests/test_torch_align.py)
    int8 = TEngine(NAME, compute_type="int8", device="cpu")
    assert "wqkv" in int8.params["decoder"]["blocks"][0]
    audio, _ = synth_speech(np.random.default_rng(4), 6.0)
    segs, _ = int8.transcribe(audio, word_timestamps=True, vad_filter=False,
                              max_new_tokens=24, temperature=(0.0,),
                              compression_ratio_threshold=None,
                              log_prob_threshold=None, no_speech_threshold=None)
    assert segs and all(s.words is not None for s in segs)
    words = [w for s in segs for w in s.words]
    assert words and all(0 <= w.start <= w.end <= 30.0 and w.word for w in words)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TEngine(NAME, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        t_cli.build_engine(NAME, device="cuda")



def test_chip_smoke_fails_without_cuda(tmp_path):
    """No card here: the smoke script must exit non-zero and print no
    result, both from the checkout and alone in a directory."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    script = os.path.join(REPO_ROOT, "chip_smoke.py")
    lone = tmp_path / "chip_smoke.py"
    lone.write_bytes(open(script, "rb").read())
    for path, cwd in ((script, REPO_ROOT), (str(lone), str(tmp_path))):
        proc = subprocess.run([sys.executable, path], capture_output=True,
                              text=True, cwd=cwd, env=env, timeout=120)
        assert proc.returncode != 0
        assert '"ok": true' not in proc.stdout
