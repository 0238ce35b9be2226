"""The port stands alone: it imports nothing of the JAX package, and its
copies of the JAX package's host modules behave as the originals.

- Every ``ttasr_torch`` module (``ttasr_torch.parallel`` included), and
  ``chip_smoke.py`` loaded as a module, imports in a subprocess where
  ``ttasr``, ``tools``, ``jax`` and ``jaxlib`` are blocked.
- No ``import ttasr`` or ``from ttasr.`` (``ttasr_torch`` aside) in the
  port's sources or ``chip_smoke.py``.
- The copies agree with their originals: tokenizer encode and decode (BPE
  merges and byte fallback) on mixed zh/en/byte strings, VAD timestamps on
  synthesized speech (the learned model and the energy heuristic), a
  ``write_wav``/``load_audio`` round trip with resampling,
  ``compare_texts`` and ``postprocess_transcript`` on ``sample_corpus/``,
  the mel constants, and ``chip_smoke.synth_speech``.
"""

import csv
import glob
import importlib.util
import json
import os
import re
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from tools import train_vad as j_train_vad
from ttasr.audio import io as j_io
from ttasr.audio import vad as j_vad
from ttasr.cli import asr as j_cli
from ttasr.ops import mel as j_mel
from ttasr.text import cer as j_cer
from ttasr.text import normalize as j_norm
from ttasr.text import tokenizer as j_tok
from ttasr_torch.audio import io as t_io
from ttasr_torch.audio import vad as t_vad
from ttasr_torch.cli import asr as t_cli
from ttasr_torch.ops import mel as t_mel
from ttasr_torch.text import cer as t_cer
from ttasr_torch.text import normalize as t_norm
from ttasr_torch.text import tokenizer as t_tok

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCKED = ("ttasr", "tools", "jax", "jaxlib")

_ISOLATED = textwrap.dedent("""
    import importlib, importlib.abc, importlib.util, pkgutil, sys

    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path, target=None):
            if name.split(".")[0] in {blocked!r}:
                raise ImportError("blocked: " + name)

    sys.meta_path.insert(0, Block())
    sys.path.insert(0, {root!r})
    import ttasr_torch
    names = ["ttasr_torch"] + [m.name for m in pkgutil.walk_packages(
        ttasr_torch.__path__, "ttasr_torch.")]
    assert {{"ttasr_torch.ops.cross_attention", "ttasr_torch.ops.beam_gather",
             "ttasr_torch.ops.decoder_blocks", "ttasr_torch.parallel.distributed",
             "ttasr_torch.parallel.sharding", "ttasr_torch.parallel.tp"}} <= set(names), names
    for name in names:
        importlib.import_module(name)
    spec = importlib.util.spec_from_file_location("chip_smoke", {smoke!r})
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
    loaded = {{m.split(".")[0] for m in sys.modules}}
    assert not loaded & set({blocked!r}), loaded & set({blocked!r})
    print(len(names))
""")


def test_port_and_chip_smoke_import_with_ttasr_blocked():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    code = _ISOLATED.format(root=REPO_ROOT, blocked=BLOCKED,
                            smoke=os.path.join(REPO_ROOT, "chip_smoke.py"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=REPO_ROOT, env=env, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip().splitlines()[-1]) >= 31


_IMPORT_TTASR = re.compile(r"^\s*(from|import)\s+ttasr(\.|\s|$)")


def test_port_sources_never_import_ttasr():
    files = [os.path.join(REPO_ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(os.path.join(REPO_ROOT, "ttasr_torch")):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    assert len(files) > 25
    for path in files:
        with open(path, encoding="utf-8") as fh:
            for i, line in enumerate(fh, 1):
                assert not _IMPORT_TTASR.match(line), f"{path}:{i}: {line}"


def _bpe_tokenizer_json(tmp_path):
    """A small byte-level BPE: the 256 byte tokens, merges for "th", "the",
    "in", "ing" and the first two bytes of 你 and 們, and the specials of
    the byte-fallback layout."""
    b2u = j_tok._bytes_to_unicode()
    vocab = {b2u[b]: b for b in range(256)}
    merges = [("t", "h"), ("th", "e"), ("i", "n"), ("in", "g")]
    for ch in "你們":
        raw = [b2u[b] for b in ch.encode("utf-8")]
        merges.append((raw[0], raw[1]))
    for a, b in merges:
        vocab[a + b] = len(vocab)
    fallback = j_tok.build_byte_fallback_tokenizer()
    added = [{"id": len(vocab) + i, "content": tok, "special": True}
             for i, tok in enumerate(sorted(fallback.special, key=fallback.special.get))]
    data = {"model": {"type": "BPE", "vocab": vocab,
                      "merges": [f"{a} {b}" for a, b in merges]},
            "added_tokens": added}
    path = tmp_path / "tokenizer.json"
    path.write_text(json.dumps(data, ensure_ascii=False), encoding="utf-8")
    return str(path)


TEXTS = ["今天天氣很好", "the thing is 你們 going", "mixed 中英 text, 123!",
         "emoji 🙂 and bytes \x01\x7f", "  leading spaces", "台灣的夜市很熱鬧"]


@pytest.mark.parametrize("kind", ["bpe", "byte_fallback"])
def test_tokenizer_copy_matches(kind, tmp_path):
    if kind == "bpe":
        path = _bpe_tokenizer_json(tmp_path)
        want, got = j_tok.load_tokenizer(path), t_tok.load_tokenizer(path)
    else:
        want, got = (j_tok.build_byte_fallback_tokenizer(),
                     t_tok.build_byte_fallback_tokenizer())
    for text in TEXTS:
        ids = got.encode(text)
        assert ids == want.encode(text), text
        assert got.decode(ids) == want.decode(ids) == text
    assert got.sot_sequence("zh", "transcribe") == want.sot_sequence("zh", "transcribe")
    assert (got.eot, got.sot, got.timestamp_begin) == (want.eot, want.sot,
                                                       want.timestamp_begin)
    if kind == "bpe":
        assert len(got.encode("the thing")) < len("the thing".encode("utf-8"))


@pytest.mark.parametrize("heuristic", [False, True], ids=["model", "energy"])
def test_vad_copy_matches(heuristic, monkeypatch):
    if heuristic:
        monkeypatch.setenv("TTASR_VAD_HEURISTIC", "1")
    audio = np.concatenate([
        j_train_vad.synth_speech(np.random.default_rng(0), 6.0)[0],
        np.zeros(16000 * 6, np.float32),
        j_train_vad.synth_speech(np.random.default_rng(1), 4.0)[0]])
    np.testing.assert_array_equal(t_vad.speech_probabilities(audio),
                                  j_vad.speech_probabilities(audio))
    want = j_vad.get_speech_timestamps(audio, j_vad.VadOptions())
    got = t_vad.get_speech_timestamps(audio, t_vad.VadOptions())
    assert got == want and len(want) >= 2
    np.testing.assert_array_equal(t_vad.collect_chunks(audio, got),
                                  j_vad.collect_chunks(audio, want))


def test_audio_io_copy_round_trip(tmp_path, monkeypatch):
    # the port copies the scipy host path of resample_poly_host; the JAX
    # package tries its C++ resampler first, so switch that off here
    from ttasr import native

    monkeypatch.setattr(native, "resample", lambda *a, **k: None)
    audio = j_train_vad.synth_speech(np.random.default_rng(2), 2.0)[0]
    for sr in (16000, 22050, 8000):
        path = str(tmp_path / f"a{sr}.wav")
        t_io.write_wav(path, audio, sr)
        with open(path, "rb") as fh:
            assert fh.read() == j_io.wav_bytes(audio, sr)
        for int16 in (False, True):
            got, got_sr = t_io.load_audio(path, sr=16000, int16=int16)
            want, want_sr = j_io.load_audio(path, sr=16000, int16=int16)
            assert got_sr == want_sr == 16000 and got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)


def _corpus():
    pairs = []
    for tsv in sorted(glob.glob(os.path.join(REPO_ROOT, "sample_corpus", "*", "*.tsv"))):
        with open(tsv, encoding="utf-8") as fh:
            pairs += [row["sentence"] for row in csv.DictReader(fh, delimiter="\t")]
    return pairs


def test_text_copies_match_on_sample_corpus():
    sentences = _corpus()
    assert len(sentences) >= 10
    hyps = [s[::-1] for s in sentences] + ["今天天气很好 123", "我们去公园 ABC"]
    for ref, hyp in zip(sentences + sentences[:2], hyps):
        assert t_norm.postprocess_transcript(hyp) == j_norm.postprocess_transcript(hyp)
        got, want = t_cer.compare_texts(ref, hyp), j_cer.compare_texts(ref, hyp)
        assert got.to_dict() == want.to_dict()
    assert (t_cer.cer_metric(sentences, hyps[:len(sentences)])
            == pytest.approx(j_cer.cer_metric(sentences, hyps[:len(sentences)])))
    assert t_cli.TRANSCRIPT_PATTERNS == j_cli.TRANSCRIPT_PATTERNS
    assert t_cli.AUDIO_EXTENSIONS == j_cli.AUDIO_EXTENSIONS
    for v in (0.0, 1.9996, 3725.25):
        assert t_cli.convert_time(v) == j_cli.convert_time(v)


def test_mel_constants_equal():
    for name in ("SAMPLE_RATE", "N_FFT", "HOP_LENGTH", "CHUNK_LENGTH",
                 "N_SAMPLES", "N_FRAMES", "N_FREQS"):
        assert getattr(t_mel, name) == getattr(j_mel, name), name
    for n_mels in (80, 128):
        for got, want in zip(t_mel._device_constants(n_mels),
                             j_mel._device_constants(n_mels)):
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)


def test_chip_smoke_synth_speech_matches():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_copy", os.path.join(REPO_ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    for seed, seconds in ((0, 3.0), (1, 5.0)):
        got = smoke.synth_speech(np.random.default_rng(seed), seconds)
        want = j_train_vad.synth_speech(np.random.default_rng(seed), seconds)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
