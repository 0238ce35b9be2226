"""The port's redeclared host pieces stay equal to the JAX originals, and
no ``ttasr_torch`` module imports jax.

``ttasr.models.whisper`` and ``ttasr.engine`` import jax in their package
``__init__``, so the port declares ``WhisperConfig``/``PRESETS``,
``DecodingOptions``, ``TokenizerInfo``, the prompt helpers and the result
types again; these tests pin them field by field.
"""

import dataclasses
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from ttasr.engine import results as j_results
from ttasr.models.whisper import config as j_config
from ttasr.models.whisper import decode as j_decode
from ttasr.models.whisper import load as j_load
from ttasr.text.tokenizer import build_byte_fallback_tokenizer
from ttasr_torch.engine import results as t_results
from ttasr_torch.models.whisper import config as t_config
from ttasr_torch.models.whisper import decode as t_decode
from ttasr_torch.models.whisper import load as t_load

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _fields(cls):
    return [(f.name, f.type, f.default, f.default_factory)
            for f in dataclasses.fields(cls)]


@pytest.mark.parametrize("pair", [
    (j_config.WhisperConfig, t_config.WhisperConfig),
    (j_decode.DecodingOptions, t_decode.DecodingOptions),
    (j_decode.TokenizerInfo, t_decode.TokenizerInfo),
    (j_results.Word, t_results.Word),
    (j_results.Segment, t_results.Segment),
    (j_results.TranscriptionInfo, t_results.TranscriptionInfo),
], ids=lambda p: p[0].__name__)
def test_redeclared_dataclass_fields_and_defaults(pair):
    ref, port = pair
    assert _fields(port) == _fields(ref)
    assert (dataclasses.fields(port)[0].metadata
            == dataclasses.fields(ref)[0].metadata)


def test_presets_and_config_resolution():
    assert t_config.PRESETS.keys() == j_config.PRESETS.keys()
    for name, cfg in j_config.PRESETS.items():
        assert dataclasses.asdict(t_config.PRESETS[name]) == dataclasses.asdict(cfg)
        assert t_config.PRESETS[name].head_dim == cfg.head_dim
    assert t_config.get_config("large-v3") == t_config.PRESETS["large-v3"]
    with pytest.raises(ValueError):
        t_config.get_config("no-such-model")
    hf = {"vocab_size": 99, "num_mel_bins": 80, "d_model": 64,
          "encoder_layers": 1, "encoder_attention_heads": 4,
          "decoder_layers": 1, "decoder_attention_heads": 4,
          "encoder_ffn_dim": 128}
    assert (dataclasses.asdict(t_config.WhisperConfig.from_hf_config(hf))
            == dataclasses.asdict(j_config.WhisperConfig.from_hf_config(hf)))


def test_decode_constants_and_state_dict_maps():
    for name in ("NEG_INF", "MAX_PROMPT", "SAMPLE_LEN"):
        assert getattr(t_decode, name) == getattr(j_decode, name), name
    assert t_load._ENC_BLOCK_MAP == j_load._ENC_BLOCK_MAP
    assert t_load._DEC_EXTRA_MAP == j_load._DEC_EXTRA_MAP


@pytest.mark.parametrize("n_vocab", [None, 1865, 51866])
def test_tokenizer_info_matches(n_vocab):
    tok = build_byte_fallback_tokenizer()
    want = j_decode.TokenizerInfo.from_tokenizer(tok, n_vocab=n_vocab)
    got = t_decode.TokenizerInfo.from_tokenizer(tok, n_vocab=n_vocab)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    np.testing.assert_array_equal(t_decode._static_suppress_mask(got),
                                  j_decode._static_suppress_mask(want))


def test_prompt_helpers_match():
    tok = build_byte_fallback_tokenizer()
    for kw in ({}, {"previous_tokens": list(range(300))},
               {"initial_prompt_tokens": [5, 6], "prefix_tokens": [7]},
               {"without_timestamps": True, "language": "en"}):
        assert t_decode.build_prompt(tok, **kw) == j_decode.build_prompt(tok, **kw)
    for prompts in ([[1, 2, 3]], [list(range(20)), [4]], [list(range(70))],
                    [list(range(200))]):
        for width in (None, 16):
            got = t_decode.pad_prompts(prompts, 9, width=width)
            want = j_decode.pad_prompts(prompts, 9, width=width)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)
                assert g.dtype == w.dtype
    for text in ("", "abc", "你好" * 40):
        assert t_decode.compression_ratio(text) == j_decode.compression_ratio(text)
    for args in ((16, 224, 32), (144, 48, 32), (256, 224, 64), (16, 20, 32)):
        assert t_decode._growth_buckets(*args) == j_decode._growth_buckets(*args)


_NO_JAX = textwrap.dedent("""
    import importlib, importlib.abc, pkgutil, sys

    class BlockJax(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path, target=None):
            if name.split(".")[0] in ("jax", "jaxlib"):
                raise ImportError("jax is blocked: " + name)

    sys.meta_path.insert(0, BlockJax())
    sys.path.insert(0, {root!r})
    import ttasr_torch
    names = ["ttasr_torch"] + [m.name for m in pkgutil.walk_packages(
        ttasr_torch.__path__, "ttasr_torch.")]
    for name in names:
        importlib.import_module(name)
    assert not any(m.split(".")[0] in ("jax", "jaxlib") for m in sys.modules)
    print(len(names))
""")


def test_port_imports_without_jax():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run(
        [sys.executable, "-c", _NO_JAX.format(root=REPO_ROOT)],
        capture_output=True, text=True, cwd=REPO_ROOT, env=env, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip().splitlines()[-1]) >= 15


def test_port_sources_never_import_jax():
    root = os.path.join(REPO_ROOT, "ttasr_torch")
    for dirpath, _, files in os.walk(root):
        for fname in files:
            if fname.endswith(".py"):
                with open(os.path.join(dirpath, fname), encoding="utf-8") as fh:
                    for line in fh:
                        stripped = line.strip()
                        assert not stripped.startswith(("import jax", "from jax")), (
                            fname, line)
