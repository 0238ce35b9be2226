"""The port's operations tools and ``params_from_hf_model`` against the JAX
package on the CPU.

- ``params_from_hf_model`` on a ``transformers`` Whisper model built from a
  small config in code with random weights: every leaf equal to the JAX
  package's conversion of the same model, and the same config.
- ``core.census``: equal to the JAX census on a grid of arguments, its
  bucket constants pinned to the port's own (``decode.pad_prompts``,
  ``serving.WINDOW_BUCKETS``, the streaming plugin's ``_token_budget``);
  ``warmup --dry-run`` lines equal to the JAX command's.
- ``warmup --device cpu --slots 1 --file-api off`` on ``micro64-test``
  runs every census entry; without CUDA ``warmup`` raises and ``doctor``
  reports CUDA absent and no kernel build (nothing falls back to the CPU).
- ``core.config`` (device default ``cuda``), ``core.logging``,
  ``core.profiling`` (``StageTimer``, a Chrome trace with an annotated
  region).
- The native host lane built with g++ here: bit for bit against
  ``ttasr.native`` and against numpy/Python versions of ``resample``,
  ``levenshtein`` and ``pcm16_to_f32``; ``cer_metric`` equal with and
  without it.
"""

import dataclasses
import itertools
import json
import os
import random
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from ttasr import native as j_native
from ttasr.core import census as j_census
from ttasr.models.whisper import load as j_load
from ttasr_torch import native as t_native
from ttasr_torch.cli import doctor as t_doctor
from ttasr_torch.cli import warmup as t_warmup
from ttasr_torch.core import census as t_census
from ttasr_torch.engine import serving as t_serving
from ttasr_torch.models.whisper import decode as t_decode
from ttasr_torch.models.whisper import load as t_load
from ttasr_torch.models.whisper.load import params_from_jax
from ttasr_torch.ops.mel import N_SAMPLES
from ttasr_torch.streaming.asr.torch_whisper_asr import TorchWhisperASR
from ttasr_torch.text import cer as t_cer

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The micro model's eager ops run faster on one thread (about 2x for
    the warm-up here), and the suite runs several workers to a machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def test_params_from_hf_model_matches_jax(monkeypatch):
    monkeypatch.setenv("USE_TF", "0")  # torch models only: skip TensorFlow's import
    from transformers import WhisperConfig as HFConfig
    from transformers import WhisperForConditionalGeneration

    torch.manual_seed(0)
    hf = WhisperForConditionalGeneration(HFConfig(
        vocab_size=300, num_mel_bins=80, d_model=64, encoder_layers=2,
        decoder_layers=2, encoder_attention_heads=2, decoder_attention_heads=2,
        encoder_ffn_dim=128, decoder_ffn_dim=128, max_source_positions=1500,
        max_target_positions=64, pad_token_id=0, bos_token_id=1, eos_token_id=2,
        decoder_start_token_id=1, suppress_tokens=[], begin_suppress_tokens=[]))
    hf.eval()
    with torch.no_grad():  # random LayerNorm and bias values, not 1 and 0
        for p in hf.parameters():
            p.add_(torch.randn_like(p) * 0.01)
    jp, jcfg = j_load.params_from_hf_model(hf)
    tp, tcfg = t_load.params_from_hf_model(hf)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert tcfg.d_model == 64 and tcfg.decoder_layers == 2
    want = dict(_leaves(params_from_jax(jax.tree.map(np.asarray, jp))))
    got = dict(_leaves(tp))
    assert got.keys() == want.keys() and len(got) > 40
    for path, leaf in got.items():
        assert leaf.dtype == torch.float32 and leaf.device.type == "cpu", path
        assert torch.equal(leaf, want[path]), path
    # the embedding and a transposed linear, against the torch module itself
    sd = hf.state_dict()
    assert torch.equal(tp["decoder"]["embed"], sd["model.decoder.embed_tokens.weight"])
    assert torch.equal(tp["decoder"]["blocks"][1]["w1"],
                       sd["model.decoder.layers.1.fc1.weight"].T)
    from ttasr_torch.models.whisper import params_from_hf_model

    assert params_from_hf_model is t_load.params_from_hf_model


CENSUS_GRID = list(itertools.product(
    (1, 4, 8), (1, 5), (True, False), (True, False), (False, True), (True, False),
    (False, True)))


def test_census_matches_jax_and_the_ports_buckets():
    for slots, beam, streaming, file_api, cli, prompt, prefix in CENSUS_GRID:
        kw = dict(beam_size=beam, streaming=streaming, file_api=file_api,
                  sequential_cli=cli, initial_prompt=prompt, prefix=prefix)
        assert t_census.census(slots, **kw) == j_census.census(slots, **kw)
    for name in ("PROMPT_BUCKETS", "STREAM_BUDGETS", "WINDOW_BUDGET",
                 "STREAM_WINDOW_BUDGETS"):
        assert getattr(t_census, name) == getattr(j_census, name), name
    # the port's own buckets: pad_prompts' widths ...
    widths = [t_decode.pad_prompts([[1] * n], 0)[0].shape[1]
              for n in range(1, t_decode.MAX_PROMPT + 1)]
    assert tuple(sorted(set(widths))) == t_census.PROMPT_BUCKETS
    assert t_census.PROMPT_BUCKETS[-1] == t_decode.MAX_PROMPT
    # ... the decode budget, the short windows and their token budgets
    assert t_census.WINDOW_BUDGET == t_decode.SAMPLE_LEN
    windows = t_serving.WINDOW_BUCKETS + (N_SAMPLES,)
    assert tuple(w for w, _ in t_census.STREAM_WINDOW_BUDGETS) == windows
    for win, budget in t_census.STREAM_WINDOW_BUDGETS:
        assert TorchWhisperASR._token_budget(win / 16000) == budget
        assert t_serving.window_bucket(win) == win
    assert tuple(b for _, b in t_census.STREAM_WINDOW_BUDGETS) == t_census.STREAM_BUDGETS


def _json_lines(text):
    return [json.loads(x) for x in text.splitlines() if x.startswith("{")]


def test_warmup_dry_run_matches_jax(capsys):
    args = ["--dry-run", "--slots", "4", "--cli", "on"]
    # the JAX command in its own process: importing it sets JAX's cache env
    proc = subprocess.run([sys.executable, "-m", "ttasr.cli.warmup", *args],
                          capture_output=True, text=True, timeout=120, cwd=REPO_ROOT,
                          env=dict(os.environ, PYTHONPATH=REPO_ROOT))
    assert proc.returncode == 0, proc.stderr
    t_warmup.main(args)
    got = _json_lines(capsys.readouterr().out)
    assert got == _json_lines(proc.stdout)
    assert len(got) == len(t_census.census(4, sequential_cli=True))


def test_warmup_runs_the_census_on_cpu(capsys):
    t_warmup.main(["--model", "micro64-test", "--compute", "float32", "--slots", "1",
                   "--file-api", "off", "--beam", "2", "--device", "cpu"])
    lines = _json_lines(capsys.readouterr().out)
    done = [x for x in lines if "family" in x]
    assert [tuple(x["key"]) for x in done] == [
        k for _, k, _ in t_census.census(1, beam_size=2, file_api=False)]
    assert all("s" in x and "skipped" not in x for x in done)
    assert {x["family"] for x in done} == {"encoder", "beam_decode"}
    assert lines[-1]["programs"] == len(done) == 6
    assert lines[0] == {"stage": "engine_init", "s": lines[0]["s"]}
    assert "kernel_build" not in {x.get("stage") for x in lines}  # CPU: no kernels


def test_no_cpu_fallback_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        t_warmup.main(["--model", "micro64-test", "--slots", "1"])
    devices = t_doctor.check_devices()
    assert devices["cuda_available"] is False and devices["device_count"] == 0
    assert "CUDA" in devices["error"]
    # the kernel check reports a missing toolkit or a failed build as such
    from ttasr_torch.ops import _build

    def no_nvcc():
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")

    monkeypatch.setattr(_build, "_nvcc", no_nvcc)
    kernels = t_doctor.check_kernels()
    assert kernels == {"nvcc": None, "loaded": False, "error": kernels["error"]}
    assert "nvcc not found" in kernels["error"]

    def failed_build():
        raise RuntimeError("nvcc failed (2): error in decoder_mlp.cu")

    monkeypatch.setattr(_build, "_nvcc", lambda: "/usr/local/cuda/bin/nvcc")
    monkeypatch.setattr(_build, "load_library", failed_build)
    kernels = t_doctor.check_kernels()
    assert kernels["loaded"] is False and "decoder_mlp.cu" in kernels["error"]


def test_doctor_report(tmp_path, capsys):
    model_dir = tmp_path / "model"
    model_dir.mkdir()
    (model_dir / "config.json").write_text("{}")
    (model_dir / "model.safetensors").write_bytes(b"")
    report = t_doctor.main(["--model-dir", str(model_dir)])
    assert json.loads(capsys.readouterr().out) == report
    assert set(report) == {"python", "modules", "devices", "kernels", "model_dir", "native"}
    assert all(report["modules"][m] == "ok" for m in t_doctor.REQUIRED_MODULES)
    assert "jax" not in report["modules"]
    assert report["model_dir"]["ok"] is True
    assert report["native"]["built"] is True
    assert report["native"]["source"].endswith(os.path.join("ttasr_torch", "native",
                                                            "ttasr_native.cpp"))
    assert os.path.dirname(report["native"]["library"]).endswith(
        os.path.join("ttasr_torch", "_build"))


def test_config_logging_and_profiling(monkeypatch, tmp_path):
    from ttasr.core import config as j_config
    from ttasr_torch.core import config as t_config
    from ttasr_torch.core.logging import setup_api_logging, setup_hourly_logging
    from ttasr_torch.core.profiling import StageTimer, annotate, trace

    monkeypatch.delenv("TTASR_MODEL_DEVICE", raising=False)
    monkeypatch.setenv("BUFFERING_CHUNK_LENGTH_SECONDS", "2.5")
    monkeypatch.setenv("TTASR_MAX_STREAMS", "7")
    got, want = t_config.load_config(), j_config.load_config()
    assert got.model.device == "cuda" and want.model.device == "tpu"
    got.model.device = want.model.device
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.streaming.chunk_length_seconds == 2.5 and got.streaming.max_streams == 7
    monkeypatch.setenv("TTASR_MODEL_DEVICE", "cpu")
    assert t_config.load_config().model.device == "cpu"

    logger = setup_api_logging(str(tmp_path), name="test_torch_api_log")
    logger.error("bad")
    for h in logger.handlers:
        h.flush()
    assert "bad" in (tmp_path / "test_torch_api_log_error.log").read_text()
    hourly = setup_hourly_logging(str(tmp_path / "h" / "x.log"), name="test_torch_hourly")
    hourly.info("tick")
    for h in hourly.handlers:
        h.flush()
    assert "tick" in (tmp_path / "h" / "x.log").read_text()

    timer = StageTimer()
    for _ in range(2):
        with timer.stage("mel"):
            pass
    assert timer.snapshot()["mel"]["count"] == 2
    timer.reset()
    assert timer.snapshot() == {}

    with trace(str(tmp_path / "trace")):
        with annotate("ttasr_region"):
            torch.ones(8, 8) @ torch.ones(8, 8)
    (name,) = os.listdir(tmp_path / "trace")
    events = json.loads((tmp_path / "trace" / name).read_text())["traceEvents"]
    assert any(e.get("name") == "ttasr_region" for e in events)


def _resample_numpy(audio, sr_from, sr_to, half_width=32):
    """``ttasr_resample`` in numpy: the Kaiser-windowed sinc filter per
    output phase in float64, rounded to float32, then each output's taps
    summed in float32 in tap order."""
    from math import gcd

    g = gcd(sr_from, sr_to)
    up, down = sr_to // g, sr_from // g
    n_out = (len(audio) * up + down - 1) // down
    cutoff = 1.0 / max(up, down)
    taps = 2 * half_width + 1

    def i0(x):
        total, term = 1.0, 1.0
        for k in range(1, 32):
            term *= (x / (2.0 * k)) * (x / (2.0 * k))
            total += term
            if term < 1e-16 * total:
                break
        return total

    i0b = i0(8.0)
    kernel = np.empty((up, taps), np.float32)
    for p in range(up):
        frac = np.fmod(float(p) * down / up, 1.0)
        for t in range(taps):
            x = (t - half_width) - frac
            arg = x * up * cutoff
            sinc = 1.0 if arg == 0.0 else np.sin(np.pi * arg) / (np.pi * arg)
            w_pos = float(t) / (taps - 1) * 2.0 - 1.0
            kaiser = i0(8.0 * np.sqrt(max(0.0, 1.0 - w_pos * w_pos))) / i0b
            kernel[p, t] = np.float32(sinc * kaiser * up * cutoff)
    o = np.arange(n_out)
    phase, base = (o * down) % up, (o * down) // up
    acc = np.zeros(n_out, np.float32)
    for t in range(taps):
        src = np.clip(base + t - half_width, 0, len(audio) - 1)
        acc = acc + audio[src] * kernel[phase, t]
    return acc


def _levenshtein_python(a, b):
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[-1] + 1, prev[j - 1] + (ca != cb)))
        prev = cur
    return prev[-1]


def test_native_lane_bit_for_bit():
    assert t_native.available() and j_native.available()
    assert t_native.library_path() != j_native._LIB_PATH
    rng = np.random.default_rng(0)
    audio = (0.3 * rng.standard_normal(4410)).astype(np.float32)
    for sr_from, sr_to in ((44100, 16000), (8000, 16000), (22050, 16000), (16000, 16000)):
        got = t_native.resample(audio, sr_from, sr_to)
        np.testing.assert_array_equal(got, j_native.resample(audio, sr_from, sr_to))
        np.testing.assert_array_equal(got, _resample_numpy(audio, sr_from, sr_to))
    pcm = (rng.standard_normal(5000) * 9000).clip(-32768, 32767).astype("<i2")
    pcm[:3] = (-32768, 32767, 0)
    got = t_native.pcm16_to_f32(pcm.tobytes())
    np.testing.assert_array_equal(got, j_native.pcm16_to_f32(pcm.tobytes()))
    np.testing.assert_array_equal(got, pcm.astype(np.float32) / 32768.0)
    rnd = random.Random(1)
    pool = "abc中文字元xyz 123🙂"
    for _ in range(60):
        a = "".join(rnd.choice(pool) for _ in range(rnd.randint(0, 40)))
        b = "".join(rnd.choice(pool) for _ in range(rnd.randint(0, 40)))
        want = _levenshtein_python(a, b)
        assert t_native.levenshtein(a, b) == j_native.levenshtein(a, b) == want


def test_cer_metric_with_and_without_the_native_lane(monkeypatch):
    refs = ["今天天氣很好", "the thing is 你們 going", "台灣的夜市很熱鬧", ""]
    hyps = ["今天天气很好 123", "the think is 你们", "台灣夜市熱鬧", "x"]
    with_lane = t_cer.cer_metric(refs, hyps, clean=True)
    monkeypatch.setattr(t_native, "available", lambda: False)
    assert t_cer.cer_metric(refs, hyps, clean=True) == with_lane
    monkeypatch.setitem(sys.modules, "Levenshtein", None)  # the Python loop
    assert t_cer.cer_metric(refs, hyps, clean=True) == with_lane > 0
