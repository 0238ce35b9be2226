"""The port's tensor-parallel int8 decode on two ``gloo`` ranks against the
JAX package's ``TPDecoder`` on the 8-device CPU mesh, token for token at
T = 0.

Configuration: ``tests/test_parallel.py``'s TP model (d_model 256, 2+2
layers, 4 heads of 64, ffn 512, S = 32, vocab 512), its seeded f32
weights, quantized by each package.  One module fixture starts the two
ranks once, as subprocesses with ``jax``, ``ttasr`` and ``tools`` blocked,
and they run every case on both meshes, (1, 2) and (2, 1), plus the engine.
The JAX references are computed meanwhile, the (1, 2) cases in this
process, the (2, 1) cases and the engine in two more subprocesses (each
JAX case compiles a shard_map program in interpret mode, seconds apiece).

- Mesh (1, 2): v1 and v2, beam 3 (the ancestry map) and greedy, int8 and
  int4 cross-KV, b = 4 and 3, every combination against the port's own
  single-process fused decode; the five combinations of a pairwise
  covering array also against JAX's ``TPDecoder`` on
  ``create_mesh(data=1, model=2)``.
- Mesh (2, 1): the batch split over ``data``, b = 3 padded to 4, against
  JAX's ``TPDecoder`` on ``create_mesh(data=2, model=1)``.
- The engine: ``WhisperEngine(compute_type="int8", mesh=create_mesh(1, 2))``
  against the JAX engine with a (1, 2) mesh, segment for segment (d_model
  256, 4 heads, S = 1500 and the byte-fallback tokenizer's vocabulary:
  the engine's 30 s window and tokenizer need them), the JAX s8 x s8
  encoder in interpret mode as ``tests/test_torch_int8_encoder.py`` runs it.

In-process: a decode naming an unbound axis raises, the engine takes the
GSPMD path (``ShardedDecoder``) on a mesh ``tp_eligible`` refuses, and the
port's shards equal the JAX package's ``build_tp_decoder`` output leaf for
leaf.

This module imports no JAX at its top: the ranks run its ``_rank_main``,
the JAX subprocess its ``_jax_main``.
"""

import dataclasses
import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from ttasr_torch.engine.transcriber import WhisperEngine as TEngine
from ttasr_torch.models.whisper import decode as td
from ttasr_torch.models.whisper.config import WhisperConfig as TConfig
from ttasr_torch.models.whisper.load import params_from_jax
from ttasr_torch.ops.quant import fuse_qkv, quantize_params
from ttasr_torch.parallel import sharding, tp as ttp

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
CFG = dict(vocab_size=512, num_mel_bins=80, d_model=256, encoder_layers=2,
           encoder_heads=4, decoder_layers=2, decoder_heads=4, ffn_dim=512,
           max_source_positions=32)
ENGINE_CFG = dict(CFG, vocab_size=1865, max_source_positions=1500)
TI = dict(eot=500, sot=499, no_timestamps=498, timestamp_begin=300,
          no_speech=497, blank=(32,), suppress=(1, 2, 3), n_vocab=512)
SAMPLE_LEN = 10
FLOAT_OPTS = td.DecodingOptions(beam_size=3, sample_len=SAMPLE_LEN)
ENGINE_KW = dict(language="zh", beam_size=5, vad_filter=True, temperature=(0.0,),
                 condition_on_previous_text=True, max_new_tokens=20)

# (mesh, version, mode, cross int4, batch)
PORT_CASES = [((1, 2), v, mode, int4, b)
              for v in ("v1", "v2") for mode in ("beam", "greedy")
              for int4 in (False, True) for b in (4, 3)]
PORT_CASES += [((2, 1), "v1", "beam", True, 3), ((2, 1), "v1", "greedy", False, 3)]
# every pair of values of (version, mode, int4, batch) in five cases
JAX_CASES = [((1, 2), "v1", "beam", False, 4), ((1, 2), "v1", "greedy", True, 3),
             ((1, 2), "v2", "beam", True, 3), ((1, 2), "v2", "greedy", False, 3),
             ((1, 2), "v2", "greedy", True, 4)]
JAX_SUB_CASES = PORT_CASES[-2:]  # the (2, 1) cases, in the JAX subprocess

_BLOCK = textwrap.dedent("""
    import importlib.abc, sys

    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path, target=None):
            if name.split(".")[0] in ("jax", "jaxlib", "ttasr", "tools"):
                raise ImportError("blocked: " + name)

    sys.meta_path.insert(0, Block())
""")
_RUN = textwrap.dedent("""
    import runpy, sys
    sys.path.insert(0, {root!r})
    runpy.run_path({path!r})[{fn!r}](*{args!r})
""")


def _case_id(case):
    mesh, v, mode, int4, b = case
    return f"mesh{mesh[0]}x{mesh[1]}-{v}-{mode}-{'int4' if int4 else 'int8'}-b{b}"


def _opts(mode, int4, module=td):
    return module.DecodingOptions(
        beam_size=3 if mode == "beam" else 1, sample_len=SAMPLE_LEN, kv_int8=True,
        cross_kv_int8=True, cross_kv_int4=int4)


def _inputs(b):
    """The seeded encoder states and sot prompts of a batch of b."""
    enc = np.random.default_rng(5 + b).standard_normal(
        (b, CFG["max_source_positions"], CFG["d_model"])).astype(np.float32)
    prompt, pad = td.pad_prompts([[TI["sot"]]] * b, TI["eot"], width=16)
    return enc, prompt, pad


def _speech():
    """8 s of the VAD's synthetic speech (``tools/train_vad.py``'s, as
    ``chip_smoke.synth_speech`` copies it)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "chip_smoke_for_tp", os.path.join(REPO_ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke.synth_speech(np.random.default_rng(3), 8.0)[0]


def _decode_out(out):
    return {k: out[k].cpu().numpy() for k in ("tokens", "lengths", "sum_logprob")}


# ---------------------------------------------------------------------------
# The ranks (run in subprocesses, jax blocked)
# ---------------------------------------------------------------------------

def _rank_main(rank: int, tmp: str) -> None:
    from ttasr_torch.parallel.distributed import initialize_distributed
    from ttasr_torch.text.tokenizer import build_byte_fallback_tokenizer

    torch.set_num_threads(2)
    initialize_distributed(f"file://{tmp}/store", WORLD, rank, backend="gloo")
    with open(os.path.join(tmp, "params.pkl"), "rb") as fh:
        trees = pickle.load(fh)
    cfg = TConfig(name="tp", **CFG)
    ti = td.TokenizerInfo(**TI)
    q = quantize_params(params_from_jax(trees["decode"]))
    meshes = {shape: sharding.create_mesh(*shape) for shape in ((1, 2), (2, 1))}
    res = {"coords": {str(s): m.coords for s, m in meshes.items()}}
    for case in PORT_CASES:
        mesh, v, mode, int4, b = case
        dec = ttp.TPDecoder(q, cfg, meshes[mesh], row_parallel=v == "v2")
        assert dec.row_parallel == (v == "v2")
        enc, prompt, pad = _inputs(b)
        enc = torch.from_numpy(enc)
        if mode == "beam":
            out = dec.beam(enc, prompt, pad, opts=_opts(mode, int4), ti=ti)
        else:
            out = dec.greedy(enc, prompt, pad, None, 0.0, opts=_opts(mode, int4), ti=ti)
        res[_case_id(case)] = _decode_out(out)
    # v1 over a float self-KV: the plain layer loop's all-gathers
    enc, prompt, pad = _inputs(4)
    dec = ttp.TPDecoder(q, cfg, meshes[(1, 2)], row_parallel=False)
    res["float-cache"] = _decode_out(dec.beam(torch.from_numpy(enc), prompt, pad,
                                              opts=FLOAT_OPTS, ti=ti))
    engine = TEngine("tp-engine", compute_type="int8", device="cpu",
                     params=params_from_jax(trees["engine"]),
                     config=TConfig(name="tp-engine", **ENGINE_CFG),
                     tokenizer=build_byte_fallback_tokenizer(),
                     mesh=meshes[(1, 2)])
    segments, info = engine.transcribe(_speech(), **ENGINE_KW)
    res["engine"] = dict(segments=[dataclasses.asdict(s) for s in segments],
                         info=dataclasses.asdict(info), stats=engine.decode_stats,
                         row_parallel=engine._tp.row_parallel)
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as fh:
        pickle.dump(res, fh)


# ---------------------------------------------------------------------------
# The JAX references (this process)
# ---------------------------------------------------------------------------

def _interpreted(fn):
    """``fn`` with ``interpret=True`` whatever the caller passes."""
    def run(*args, interpret=False, **kw):
        return fn(*args, interpret=True, **kw)
    return run


def _jax_cases(trees, cases):
    """JAX's ``TPDecoder`` on each case's mesh of the 8-device CPU mesh."""
    import jax

    from ttasr.models.whisper import decode as jd
    from ttasr.models.whisper.config import WhisperConfig as JConfig
    from ttasr.ops.quant import quantize_params as j_quantize
    from ttasr.parallel.sharding import create_mesh
    from ttasr.parallel.tp import TPDecoder

    jcfg, ti = JConfig(name="tp", **CFG), jd.TokenizerInfo(**TI)
    q = j_quantize(jax.tree.map(jax.numpy.asarray, trees["decode"]))
    res = {}
    for case in cases:
        mesh, v, mode, int4, b = case
        dec = TPDecoder(q, jcfg, create_mesh(data=mesh[0], model=mesh[1]),
                        row_parallel=v == "v2")
        enc, prompt, pad = _inputs(b)
        key = jax.random.PRNGKey(0)
        opts = _opts(mode, int4, jd)
        out = (dec.beam(enc, prompt, pad, key, opts=opts, ti=ti) if mode == "beam"
               else dec.greedy(enc, prompt, pad, key, 0.0, opts=opts, ti=ti))
        res[_case_id(case)] = {k: np.asarray(out[k])
                               for k in ("tokens", "lengths", "sum_logprob")}
    return res


def _jax_engine(trees):
    """The JAX engine with a (1, 2) mesh, its s8 x s8 encoder's Pallas
    kernels in interpret mode."""
    import jax

    from ttasr.engine.transcriber import WhisperEngine as JEngine
    from ttasr.models.whisper import model as jm
    from ttasr.models.whisper.config import WhisperConfig as JConfig
    from ttasr.ops import encoder_attention_pallas as j_att
    from ttasr.ops import encoder_fused_pallas as j_fused
    from ttasr.parallel.sharding import create_mesh
    from ttasr.text.tokenizer import build_byte_fallback_tokenizer

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jm, "_use_fused_encoder_attention", lambda dh: dh == 64)
        for mod, names in ((j_fused, ("ln_quant", "add_ln_quant", "gelu_quant",
                                      "quant_only")),
                           (j_att, ("encoder_attention_merged_qkv",
                                    "encoder_attention_merged"))):
            for name in names:
                mp.setattr(mod, name, _interpreted(getattr(mod, name)))
        engine = JEngine("tp-engine", compute_type="int8", params=jax.tree.map(
            jax.numpy.asarray, trees["engine"]), config=JConfig(name="tp-engine", **ENGINE_CFG),
            tokenizer=build_byte_fallback_tokenizer(), mesh=create_mesh(data=1, model=2))
        assert engine._tp is not None and engine._tp.row_parallel
        segments, info = engine.transcribe(_speech(), **ENGINE_KW)
    return dict(segments=[dataclasses.asdict(s) for s in segments],
                info=dataclasses.asdict(info))


def _jax_main(tmp: str, part: str) -> None:
    """A JAX subprocess: the (2, 1) cases or the engine, on the CPU mesh
    ``tests/conftest.py`` sets up (its environment is inherited)."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    with open(os.path.join(tmp, "params.pkl"), "rb") as fh:
        trees = pickle.load(fh)
    res = (dict(engine=_jax_engine(trees)) if part == "engine"
           else _jax_cases(trees, JAX_SUB_CASES))
    with open(os.path.join(tmp, f"jax_{part}.pkl"), "wb") as fh:
        pickle.dump(res, fh)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    import jax

    from ttasr.models.whisper import model as jm
    from ttasr.models.whisper.config import WhisperConfig as JConfig

    tmp = str(tmp_path_factory.mktemp("tp_ranks"))
    trees = {name: jax.tree.map(np.asarray, jm.init_params(JConfig(name=name, **cfg),
                                                           seed=0))
             for name, cfg in (("decode", CFG), ("engine", ENGINE_CFG))}
    with open(os.path.join(tmp, "params.pkl"), "wb") as fh:
        pickle.dump(trees, fh)
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    path = os.path.abspath(__file__)
    codes = [_BLOCK + _RUN.format(root=REPO_ROOT, path=path, fn="_rank_main",
                                  args=(r, tmp)) for r in range(WORLD)]
    codes += [_RUN.format(root=REPO_ROOT, path=path, fn="_jax_main", args=(tmp, part))
              for part in ("engine", "cases")]
    procs = [subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, cwd=REPO_ROOT,
                              env=env) for code in codes]
    try:
        jax_res = _jax_cases(trees, JAX_CASES)
        outputs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, out in zip(procs, outputs):
        assert p.returncode == 0, out[-4000:]
    port = []
    for r in range(WORLD):
        with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as fh:
            port.append(pickle.load(fh))
    for part in ("engine", "cases"):
        with open(os.path.join(tmp, f"jax_{part}.pkl"), "rb") as fh:
            jax_res.update(pickle.load(fh))
    return dict(port=port, jax=jax_res, trees=trees)


def _assert_same_tokens(got, want):
    np.testing.assert_array_equal(got["lengths"], want["lengths"])
    for row, n in enumerate(want["lengths"]):
        np.testing.assert_array_equal(got["tokens"][row, :n], want["tokens"][row, :n])


@pytest.fixture(scope="module")
def single(ranks):
    """The port's own single-process fused decode of every (mode, int4,
    batch) of PORT_CASES."""
    params = fuse_qkv(quantize_params(params_from_jax(ranks["trees"]["decode"])))
    cfg, ti = TConfig(name="tp", **CFG), td.TokenizerInfo(**TI)
    out = {}
    for mode, int4, b in {case[2:] for case in PORT_CASES}:
        enc, prompt, pad = _inputs(b)
        args = (params, cfg, torch.from_numpy(enc), prompt, pad)
        kw = dict(opts=_opts(mode, int4), ti=ti)
        out[mode, int4, b] = _decode_out(
            td.beam_decode(*args, **kw) if mode == "beam"
            else td.greedy_decode(*args, None, 0.0, **kw))
    return out


@pytest.mark.parametrize("case", PORT_CASES, ids=_case_id)
def test_tp_decode_matches_the_single_process_decode(ranks, single, case):
    got, want = ranks["port"][0][_case_id(case)], single[case[2:]]
    _assert_same_tokens(got, want)
    np.testing.assert_allclose(got["sum_logprob"], want["sum_logprob"], rtol=1e-4)


def test_tp_v1_over_a_float_cache_matches_the_single_process_decode(ranks):
    """TP v1 without the int8 caches runs the plain layer loop, gathering
    the local heads' attention and cross outputs."""
    params = fuse_qkv(quantize_params(params_from_jax(ranks["trees"]["decode"])))
    enc, prompt, pad = _inputs(4)
    want = _decode_out(td.beam_decode(params, TConfig(name="tp", **CFG),
                                      torch.from_numpy(enc), prompt, pad,
                                      opts=FLOAT_OPTS, ti=td.TokenizerInfo(**TI)))
    _assert_same_tokens(ranks["port"][0]["float-cache"], want)


@pytest.mark.parametrize("case", JAX_CASES + JAX_SUB_CASES, ids=_case_id)
def test_tp_decode_matches_jax_tp_decoder(ranks, case):
    got, want = ranks["port"][0][_case_id(case)], ranks["jax"][_case_id(case)]
    _assert_same_tokens(got, want)
    np.testing.assert_allclose(got["sum_logprob"], want["sum_logprob"], rtol=1e-4)


def test_every_rank_returns_the_whole_batch_at_its_coordinates(ranks):
    r0, r1 = ranks["port"]
    for case in PORT_CASES:
        for k in ("tokens", "lengths", "sum_logprob"):
            np.testing.assert_array_equal(r0[_case_id(case)][k], r1[_case_id(case)][k])
        assert r0[_case_id(case)]["tokens"].shape == (case[4], SAMPLE_LEN)
    # rank r sits at (r // model, r % model), as the JAX package's devices
    assert r1["coords"] == {"(1, 2)": {"data": 0, "model": 1},
                            "(2, 1)": {"data": 1, "model": 0}}


def test_mesh_engine_matches_the_jax_mesh_engine(ranks):
    got, want = ranks["port"][0]["engine"], ranks["jax"]["engine"]
    assert got["row_parallel"]  # TP v2 by the reference's rule at model = 2
    assert got["stats"]["beam_decodes"] > 0 and got["stats"]["nonfinite_logits"] == 0
    assert got["info"] == want["info"]
    assert len(got["segments"]) == len(want["segments"]) > 0
    for g, w in zip(got["segments"], want["segments"]):
        assert (g["id"], g["seek"], g["tokens"], g["text"]) == (
            w["id"], w["seek"], w["tokens"], w["text"])
        assert (g["start"], g["end"], g["temperature"]) == (
            w["start"], w["end"], w["temperature"])
        assert g["avg_logprob"] == pytest.approx(w["avg_logprob"], rel=1e-4)
        assert g["no_speech_prob"] == pytest.approx(w["no_speech_prob"], rel=1e-3,
                                                    abs=1e-8)
    assert ranks["port"][1]["engine"]["segments"] == got["segments"]


# ---------------------------------------------------------------------------
# In-process
# ---------------------------------------------------------------------------

def _port_qparams():
    from ttasr_torch.models.whisper.model import init_params

    cfg = TConfig(name="tp", **CFG)
    return quantize_params(init_params(cfg, seed=0)), cfg


def test_a_decode_naming_an_unbound_axis_raises():
    q, cfg = _port_qparams()
    enc, prompt, pad = _inputs(1)
    for fn in (td.beam_decode, td.greedy_decode):
        opts = dataclasses.replace(_opts("beam", False), tp_axis="model")
        with pytest.raises(RuntimeError, match="not bound"):
            fn(fuse_qkv(q), cfg, torch.from_numpy(enc), prompt, pad, opts=opts,
               ti=td.TokenizerInfo(**TI))
    with pytest.raises(RuntimeError, match="not bound"):
        sharding.axis_group("model")
    # row-parallel runs only in the fused step over the flat int8 cache
    with sharding.bind_axes({"model": None}), pytest.raises(ValueError, match="fused"):
        td.beam_decode(fuse_qkv(q), cfg, torch.from_numpy(enc), prompt, pad,
                       opts=dataclasses.replace(FLOAT_OPTS, tp_axis="model",
                                                tp_row_parallel=True),
                       ti=td.TokenizerInfo(**TI))


def test_the_engine_raises_on_a_mesh_tp_refuses():
    """A mesh the fused TP decode refuses no longer raises: the engine takes
    the GSPMD path (``ShardedDecoder`` on ``shard_params``' slices), as the
    reference falls back to it."""
    from ttasr_torch.parallel.gspmd import ShardedDecoder

    q, cfg = _port_qparams()
    odd = sharding.Mesh(shape={"data": 1, "model": 4}, coords={"data": 0, "model": 0},
                        groups={})  # 4 heads over 4 shards: 1 local head, odd
    assert not ttp.tp_eligible(q, cfg, odd)
    assert ttp.tp_eligible(q, cfg, dataclasses.replace(odd, shape={"data": 1, "model": 2}))
    from ttasr_torch.models.whisper.model import init_params

    params = init_params(cfg, seed=0)
    for compute_type, mesh in (("int8", odd), ("float32", dataclasses.replace(
            odd, shape={"data": 1, "model": 1}))):
        engine = TEngine("tp", compute_type=compute_type, params=params, config=cfg,
                         device="cpu", mesh=mesh)
        assert engine._tp is None and isinstance(engine._sharded, ShardedDecoder)
        blk = engine._sharded.params["decoder"]["blocks"][0]
        n = mesh.shape["model"]
        assert "wqkv" not in blk  # the unfused graph, int8 included
        wq = blk["wq"]["q"] if compute_type == "int8" else blk["wq"]
        assert wq.shape == (CFG["d_model"], CFG["d_model"] // n)


@pytest.mark.parametrize("row_parallel", [False, True], ids=["v1", "v2"])
def test_shards_equal_the_jax_build_tp_decoder(row_parallel):
    """The port's shards against the JAX package's stacked shard tree,
    converted shard by shard through ``params_from_jax``: int8 codes bit for
    bit, scales and biases exactly, and the same leaves."""
    import jax

    from ttasr.models.whisper import model as jm
    from ttasr.models.whisper.config import WhisperConfig as JConfig
    from ttasr.ops.quant import quantize_params as j_quantize
    from ttasr.parallel.tp import build_tp_decoder

    tree = jax.tree.map(np.asarray, jm.init_params(JConfig(name="tp", **CFG), seed=0))
    jtree, stacked = build_tp_decoder(j_quantize(tree), 2, row_parallel=row_parallel)
    mine = ttp.build_tp_decoder(quantize_params(params_from_jax(tree)), 2,
                                row_parallel=row_parallel)
    for part in range(2):
        shard = jax.tree.map(lambda x, s: np.asarray(x[part] if s else x),
                             jtree, stacked)
        want = params_from_jax(shard)["decoder"]
        got = mine[part]["decoder"]
        assert set(got) == set(want)
        for g_blk, w_blk in zip(got["blocks"], want["blocks"]):
            assert set(g_blk) == set(w_blk)
            for key in w_blk:
                g, w = g_blk[key], w_blk[key]
                pairs = ([(g[k], w[k]) for k in ("q", "s")] if isinstance(w, dict)
                         else [(g, w)])
                for a, b in pairs:
                    assert a.dtype == b.dtype and a.is_contiguous(), key
                    assert torch.equal(a, b), key
        if row_parallel:
            assert got["blocks"][0]["wo"]["q"].shape == (CFG["d_model"] // 2,
                                                         CFG["d_model"])
