"""The port stands alone: it imports nothing of the JAX package, and its
copies of the JAX package's host modules behave as the originals.

- Every ``ttasr_torch`` module (``ttasr_torch.parallel`` included), and
  ``chip_smoke.py`` loaded as a module (its rank entries among its
  functions), imports in a subprocess where ``ttasr``, ``tools``, ``jax``
  and ``jaxlib`` are blocked.
- No ``import ttasr`` or ``from ttasr.`` (``ttasr_torch`` aside) in the
  port's sources or ``chip_smoke.py``.
- The copies agree with their originals: tokenizer encode and decode (BPE
  merges and byte fallback) on mixed zh/en/byte strings, VAD timestamps on
  synthesized speech (the learned model and the energy heuristic), a
  ``write_wav``/``load_audio`` round trip with resampling,
  ``compare_texts`` and ``postprocess_transcript`` on ``sample_corpus/``,
  the mel constants (the DFT basis and filterbank that the fused log-mel
  kernel reads too), the ``TTASR_UNFUSED_RULES`` truthiness, the
  synthesizer ``tools/synth.py`` (``tools/train_vad.py``'s generators, code
  and outputs on seeds; ``chip_smoke.synth_speech`` reads it),
  ``core/flops.py`` (the original's code but ``peak_tflops``), and the
  subtitle writers of
  ``engine/results.py`` (``format_srt_timestamp``, ``segments_to_srt``,
  ``segments_to_txt``).
- The plain copies of the HTTP service are the originals' text: ``api/jwt.py``,
  ``api/passwords.py``, ``text/filters.py`` and ``streaming/utils.py`` with
  ``ttasr.`` read as ``ttasr_torch.``, and the two test pages byte for byte.
- The training modules (``ttasr_torch/train/``, ``cli/train.py``,
  ``core/checkpoint.py``, the mesh's ``parallel/`` modules with
  ``tp_train.py``), the VAD model and the tools (``tools/``,
  ``core/flops.py``) import nothing of ``jax``, ``optax``, ``orbax`` or
  ``ttasr``; ``train/data.py`` is the original's code with its
  ``device`` argument, ``get_last_checkpoint``/``_cleanup_old`` and
  ``audio/io.py``'s ``probe_num_samples`` the originals', and
  ``cli/train.py`` takes every flag of the original, plus ``--device``.
- The operations copies: ``core/logging.py`` is the original's text;
  ``core/census.py`` and ``core/config.py`` its code (docstrings and
  comments aside; config's device default ``cuda`` for ``tpu``);
  ``models/whisper/align.py``'s host half (``_median_filter``,
  ``dtw_path``, ``TokenTiming``, ``merge_tokens_to_words`` and the
  statements of ``align_tokens`` after the pass); ``ttasr_native.cpp``
  after its header comment.
"""

import ast
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
from ttasr.engine import results as j_results
from ttasr.ops import mel as j_mel
from ttasr.text import cer as j_cer
from ttasr.text import normalize as j_norm
from ttasr.text import tokenizer as j_tok
from ttasr_torch.audio import io as t_io
from ttasr_torch.audio import vad as t_vad
from ttasr_torch.cli import asr as t_cli
from ttasr_torch.engine import results as t_results
from ttasr_torch.ops import mel as t_mel
from ttasr_torch.text import cer as t_cer
from ttasr_torch.text import normalize as t_norm
from ttasr_torch.text import tokenizer as t_tok

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCKED = ("ttasr", "tools", "jax", "jaxlib", "optax", "orbax")

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
             "ttasr_torch.parallel.sharding", "ttasr_torch.parallel.tp",
             "ttasr_torch.ops.mel_fused", "ttasr_torch.ops.encoder_attention",
             "ttasr_torch.engine.serving", "ttasr_torch.engine.batched",
             "ttasr_torch.engine.registry", "ttasr_torch.api.app",
             "ttasr_torch.api.auth", "ttasr_torch.api.config",
             "ttasr_torch.api.file_tasks", "ttasr_torch.api.jwt",
             "ttasr_torch.api.passwords", "ttasr_torch.api.streaming_ws",
             "ttasr_torch.text.filters", "ttasr_torch.streaming.client",
             "ttasr_torch.streaming.server", "ttasr_torch.streaming.main",
             "ttasr_torch.streaming.utils",
             "ttasr_torch.streaming.asr.torch_whisper_asr",
             "ttasr_torch.streaming.asr.asr_factory",
             "ttasr_torch.streaming.buffering_strategy.buffering_strategies",
             "ttasr_torch.streaming.vad.energy_vad",
             "ttasr_torch.streaming.vad.pyannote_vad",
             "ttasr_torch.streaming.vad.vad_factory",
             "ttasr_torch.models.whisper.align", "ttasr_torch.core.census",
             "ttasr_torch.core.config", "ttasr_torch.core.logging",
             "ttasr_torch.core.profiling", "ttasr_torch.cli.warmup",
             "ttasr_torch.cli.doctor", "ttasr_torch.native",
             "ttasr_torch.train", "ttasr_torch.train.data",
             "ttasr_torch.train.spec_augment", "ttasr_torch.train.train_step",
             "ttasr_torch.train.trainer", "ttasr_torch.cli.train",
             "ttasr_torch.core.checkpoint", "ttasr_torch.core.flops",
             "ttasr_torch.tools", "ttasr_torch.tools.synth",
             "ttasr_torch.tools.train_vad", "ttasr_torch.tools.check_trained_recognition",
             "ttasr_torch.tools.check_beam_divergence",
             "ttasr_torch.tools.profile_decode", "ttasr_torch.parallel.tp_train",
             "ttasr_torch.parallel.gspmd",
             "ttasr_torch.tools.memory_accounting"}} <= set(names), names
    for name in names:
        importlib.import_module(name)
    spec = importlib.util.spec_from_file_location("chip_smoke", {smoke!r})
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    # the rank entries run in processes of their own: present, and loaded here
    for entry in ("tp_rank_main", "sharded_rank_main", "mesh_train_rank_main"):
        assert callable(getattr(smoke, entry)), entry
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
    assert int(proc.stdout.strip().splitlines()[-1]) >= 60


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


def test_chip_compare_imports_nothing_of_jax_or_ttasr():
    """``chip_compare.py``, the kernel timing tool beside ``chip_smoke.py``,
    loads with jax and the JAX package blocked, and its source names
    neither."""
    path = os.path.join(REPO_ROOT, "chip_compare.py")
    with open(path, encoding="utf-8") as fh:
        for i, line in enumerate(fh, 1):
            assert not _IMPORT_TTASR.match(line), f"{path}:{i}: {line}"
    code = textwrap.dedent(f"""
        import importlib.abc, importlib.util, sys

        class Block(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path, target=None):
                if name.split(".")[0] in {BLOCKED!r}:
                    raise ImportError("blocked: " + name)

        sys.meta_path.insert(0, Block())
        sys.path.insert(0, {REPO_ROOT!r})
        spec = importlib.util.spec_from_file_location("chip_compare", {path!r})
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        assert module.MARKS and callable(module.main)
        print("ok")
    """)
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=REPO_ROOT, env=env, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr


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


@pytest.mark.parametrize("lane", ["native", "scipy"])
def test_audio_io_copy_round_trip(lane, tmp_path, monkeypatch):
    # both packages' resample_poly_host try their C++ resampler first, then
    # scipy: "native" compares the default paths, "scipy" the next lane with
    # both C++ resamplers switched off
    from ttasr import native as j_native
    from ttasr.audio import resample as j_resample
    from ttasr_torch import native as t_native
    from ttasr_torch.audio import resample as t_resample

    want_fn = _defs(_read("ttasr", "audio", "resample.py"))["resample_poly_host"]
    want_fn = ast.parse(ast.unparse(want_fn).replace(
        "from ttasr import native", "from ttasr_torch import native")).body[0]
    got_fn = _defs(_read("ttasr_torch", "audio", "resample.py"))["resample_poly_host"]
    assert (ast.dump(_StripDocstrings().visit(got_fn))
            == ast.dump(_StripDocstrings().visit(want_fn)))
    audio = j_train_vad.synth_speech(np.random.default_rng(2), 2.0)[0]
    if lane == "scipy":
        monkeypatch.setattr(j_native, "resample", lambda *a, **k: None)
        monkeypatch.setattr(t_native, "resample", lambda *a, **k: None)
    else:
        assert t_native.resample(audio, 22050, 16000) is not None
        assert j_native.resample(audio, 22050, 16000) is not None
    for sr in (16000, 22050, 8000, 44100, 48000):
        np.testing.assert_array_equal(t_resample.resample_poly_host(audio, 16000, sr),
                                      j_resample.resample_poly_host(audio, 16000, sr))
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


def test_fused_mel_and_rules_copies_match(monkeypatch):
    """The copies ``ops/mel_fused.py`` and the decode's rules switch read."""
    from ttasr.models.whisper import decode as j_dec
    from ttasr_torch.models.whisper import decode as t_dec

    for got, want in zip(t_mel._dft_basis(), j_mel._dft_basis()):
        np.testing.assert_array_equal(got, want)
    for n_mels in (80, 128):
        np.testing.assert_array_equal(t_mel.mel_filter_bank(n_mels),
                                      j_mel.mel_filter_bank(n_mels))
    for value in ("1", "true", "0", "false", "no", "", "anything"):
        monkeypatch.setenv("TTASR_UNFUSED_RULES", value)
        assert t_dec._env_unfused_rules() == j_dec._env_unfused_rules(), value


SYNTH_FUNCTIONS = ("_formant_filter", "synth_speech", "_reverb", "synth_babble",
                   "synth_vocal_music", "synth_negative", "make_example", "_auc")


def test_synth_copy_matches():
    """``ttasr_torch/tools/synth.py`` holds ``tools/train_vad.py``'s
    generators: their code and their output on seeds."""
    from ttasr_torch.tools import synth

    want = _defs(_read("tools", "train_vad.py"))
    got = _defs(_read("ttasr_torch", "tools", "synth.py"))
    for name in SYNTH_FUNCTIONS:
        assert ast.dump(got[name]) == ast.dump(want[name]), name
    assert synth.SR == j_train_vad.SR and synth.WINDOW == j_train_vad.WINDOW
    for seed, seconds in ((0, 3.0), (1, 5.0)):
        for name in ("synth_speech", "synth_babble", "synth_vocal_music", "make_example"):
            got_out = getattr(synth, name)(np.random.default_rng(seed), seconds)
            want_out = getattr(j_train_vad, name)(np.random.default_rng(seed), seconds)
            for g, w in zip(*(o if isinstance(o, tuple) else (o,)
                              for o in (got_out, want_out))):
                np.testing.assert_array_equal(g, w)
        for kind in range(9):
            for g, w in zip(synth.synth_negative(np.random.default_rng(seed), seconds, kind),
                            j_train_vad.synth_negative(np.random.default_rng(seed), seconds,
                                                       kind)):
                np.testing.assert_array_equal(g, w)
    labels = np.random.default_rng(3).random(500) > 0.5
    scores = np.random.default_rng(4).random(500)
    assert synth._auc(labels, scores) == j_train_vad._auc(labels, scores)


def test_chip_smoke_synth_speech_matches():
    """``chip_smoke.synth_speech`` reads the port's copy, output for output."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_copy", os.path.join(REPO_ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    for seed, seconds in ((0, 3.0), (1, 5.0)):
        got = smoke.synth_speech(np.random.default_rng(seed), seconds)
        want = j_train_vad.synth_speech(np.random.default_rng(seed), seconds)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_flops_copy_is_the_originals_code():
    """``core/flops.py`` is the original's code but ``peak_tflops`` (the
    card's rate in place of the TPU's)."""
    def code(src):
        tree = _StripDocstrings().visit(ast.parse(src))
        tree.body = [n for n in tree.body
                     if not (isinstance(n, ast.FunctionDef) and n.name == "peak_tflops")]
        return ast.dump(tree)

    assert (code(_read("ttasr_torch", "core", "flops.py"))
            == code(_read("ttasr", "core", "flops.py")))
    assert "peak_tflops" in _defs(_read("ttasr_torch", "core", "flops.py"))


def test_subtitle_writer_copies_match():
    segments = [
        t_results.Segment(id=i, seek=0, start=start, end=end, text=text,
                          tokens=[1], avg_logprob=-0.1, compression_ratio=1.0,
                          no_speech_prob=0.0)
        for i, (start, end, text) in enumerate([
            (0.0, 1.234, "今天天氣很好"), (1.2345, 61.0005, " line\r\nbreak "),
            (3599.9996, 3725.25, ""), (-1.0, None, "台灣的夜市很熱鬧")])]
    for t in (None, -2.0, 0.0, 0.0004, 0.0005, 1.2345, 59.9999, 3600.0, 3725.25,
              86399.9995):
        assert t_results.format_srt_timestamp(t) == j_results.format_srt_timestamp(t)
    assert t_results.segments_to_srt(segments) == j_results.segments_to_srt(segments)
    assert t_results.segments_to_txt(segments) == j_results.segments_to_txt(segments)
    assert t_results.segments_to_srt([]) == j_results.segments_to_srt([]) == ""


PLAIN_COPIES = ("api/jwt.py", "api/passwords.py", "text/filters.py", "streaming/utils.py",
                "api/test_files.html", "api/test_realtime.html")


@pytest.mark.parametrize("rel", PLAIN_COPIES)
def test_service_plain_copies_match(rel):
    with open(os.path.join(REPO_ROOT, "ttasr", rel), encoding="utf-8") as fh:
        want = fh.read()
    with open(os.path.join(REPO_ROOT, "ttasr_torch", rel), encoding="utf-8") as fh:
        got = fh.read()
    if rel.endswith(".py"):
        want = want.replace("ttasr.", "ttasr_torch.")
    assert got == want


class _StripDocstrings(ast.NodeTransformer):
    def _strip(self, node):
        self.generic_visit(node)
        body = node.body
        if (body and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            node.body = body[1:] or [ast.Pass()]
        return node

    visit_Module = visit_FunctionDef = visit_ClassDef = _strip


def _code(src: str) -> str:
    """The module's code without docstrings (comments never reach the AST)."""
    return ast.dump(_StripDocstrings().visit(ast.parse(src)))


def _read(*parts):
    with open(os.path.join(REPO_ROOT, *parts), encoding="utf-8") as fh:
        return fh.read()


def test_operations_copies_match():
    assert _read("ttasr_torch", "core", "logging.py") == _read("ttasr", "core", "logging.py")
    assert (_code(_read("ttasr_torch", "core", "census.py"))
            == _code(_read("ttasr", "core", "census.py")))
    config = _read("ttasr", "core", "config.py")
    assert config.count('"TTASR_MODEL_DEVICE", "tpu"') == 1
    assert (_code(_read("ttasr_torch", "core", "config.py"))
            == _code(config.replace('"TTASR_MODEL_DEVICE", "tpu"',
                                    '"TTASR_MODEL_DEVICE", "cuda"')))
    want_cpp = _read("ttasr", "native", "ttasr_native.cpp")
    got_cpp = _read("ttasr_torch", "native", "ttasr_native.cpp")
    body = want_cpp[want_cpp.index("#include"):]
    assert got_cpp.endswith(body) and got_cpp[: -len(body)].startswith("// ")
    assert all(line.startswith("//") or not line
               for line in got_cpp[: -len(body)].splitlines())


def _defs(src: str) -> dict:
    return {node.name: node for node in ast.parse(src).body
            if isinstance(node, (ast.FunctionDef, ast.ClassDef))}


def test_align_host_half_matches():
    want = _defs(_read("ttasr", "models", "whisper", "align.py"))
    got = _defs(_read("ttasr_torch", "models", "whisper", "align.py"))
    for name in ("_median_filter", "dtw_path", "TokenTiming", "merge_tokens_to_words"):
        assert ast.dump(got[name]) == ast.dump(want[name]), name
    # the host statements of align_tokens, from the head reshape to the end
    def tail(fn, start):
        stmts = [ast.dump(s) for s in fn.body]
        return stmts[next(i for i, s in enumerate(fn.body)
                          if ast.unparse(s).startswith(start)):]

    ref = want["align_tokens"]
    ref_src = ast.unparse(ref).replace("start_row = len(sot_seq)", "start_row = n_sot")
    ref = ast.parse(ref_src).body[0]
    assert tail(got["token_timings"], "w = w.reshape") == tail(ref, "w = w.reshape")


_IMPORT_JAX_FAMILY = re.compile(r"^\s*(from|import)\s+(jax|jaxlib|optax|orbax|ttasr)(\.|\s|$)")
TRAINING_MODULES = ("train/__init__.py", "train/data.py", "train/spec_augment.py",
                    "train/train_step.py", "train/trainer.py", "cli/train.py",
                    "core/checkpoint.py", "core/flops.py", "audio/vad_model.py",
                    "tools/__init__.py", "tools/synth.py", "tools/train_vad.py",
                    "tools/check_trained_recognition.py", "tools/check_beam_divergence.py",
                    "tools/profile_decode.py", "tools/memory_accounting.py",
                    "parallel/tp_train.py", "parallel/sharding.py", "parallel/distributed.py")


def test_training_modules_import_no_jax_optax_orbax():
    for rel in TRAINING_MODULES:
        for i, line in enumerate(_read("ttasr_torch", rel).splitlines(), 1):
            assert not _IMPORT_JAX_FAMILY.match(line), f"{rel}:{i}: {line}"


# the port's data.py: the original's code with a ``device`` for the mel
DATA_EDITS = (
    ("from ttasr.audio.io", "from ttasr_torch.audio.io"),
    ("from ttasr.ops.mel", "from ttasr_torch.ops.mel"),
    ("max_label_len: int = 448) -> dict:", 'max_label_len: int = 448, device="cpu") -> dict:'),
    ("mel = np.asarray(log_mel_spectrogram(audio, n_mels=n_mels))",
     "mel = log_mel_spectrogram(audio, n_mels=n_mels, device=device)"),
    ("group_by_length: bool = False,\n", 'group_by_length: bool = False, device="cpu",\n'),
    ("max_label_len=label_pad_to + 1)", "max_label_len=label_pad_to + 1, device=device)"),
)


def test_training_host_copies_match():
    data = _read("ttasr", "train", "data.py")
    for old, new in DATA_EDITS:
        assert old in data, old
        data = data.replace(old, new)
    assert _code(_read("ttasr_torch", "train", "data.py")) == _code(data)
    for (orig, port), names in (
            (("core/checkpoint.py", "core/checkpoint.py"),
             ("get_last_checkpoint", "_cleanup_old")),
            (("audio/io.py", "audio/io.py"), ("probe_num_samples",))):
        want = _defs(_read("ttasr", *orig.split("/")))
        got = _defs(_read("ttasr_torch", *port.split("/")))
        for name in names:
            assert ast.dump(got[name]) == ast.dump(want[name]), name
    from ttasr.cli import train as j_train
    from ttasr_torch.cli import train as t_train

    def flags(parser):
        return {a.dest: (tuple(a.option_strings), a.default, a.type, a.required,
                         a.choices, type(a).__name__) for a in parser._actions
                if a.dest != "help"}

    got, want = flags(t_train.build_parser()), flags(j_train.build_parser())
    assert got.pop("device") == (("--device",), "cuda", None, False, ("cuda", "cpu"),
                                 "_StoreAction")
    assert got == want
