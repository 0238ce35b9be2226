"""The port's GSPMD decode (``ttasr_torch.parallel.gspmd.ShardedDecoder``:
``shard_params``' slices and the unfused graph) on two ``gloo`` ranks,
against the port's single-process decode and the JAX package's decode on
``shard_params`` over the 8-device CPU mesh.

Configurations, both refused by the fused tensor-parallel decode:

- ``micro``: the JAX tests' decode model (``tests/test_parallel.py``: d 64,
  4 heads of 16, ffn 128, 2 + 2 layers, S = 32, vocab 256, so the
  vocabulary splits at model 2), 2 heads a shard;
- ``d384``: d 384, 6 heads of 64, ffn 768, 2 decoder layers, S = 32, vocab
  256: 3 heads a shard, so the int8 graph runs B13 (its plain version
  here) on an odd local head count;
- ``cut3`` (mesh (1, 2) only): d 96, 3 heads of 32, ffn 192: the model
  axis divides d_model but not the heads, so a shard's 48 q/k/v columns
  end inside a head and each decode gathers the attention's columns
  whole (``ShardedDecoder.heads_cut``).

One module fixture starts the two ranks once, as subprocesses with
``jax``, ``ttasr`` and ``tools`` blocked; they run every case on both
meshes, (1, 2) and (2, 1) (the batch of 3 padded to 4 over ``data``),
float32 and int8 (``quantize_params`` without ``fuse_qkv``: the 5-D int8
self-KV and an int8 cross-KV), beam 3 and greedy, then the mesh engines
and a ``BatchServer`` over one.  Meanwhile the JAX references run in this
process: ``beam_decode``/``greedy_decode`` on ``shard_params(...,
create_mesh(1, 2))`` for each case, the JAX mesh engine (float32 and
int8, ``tests/test_parallel.py:161-230``) and its ``BatchServer``
(``:233-277``).

Each case is held to the port's single-process decode (tokens and lengths
equal, ``sum_logprob`` within rtol 1e-4 and atol 1e-4, the JAX test's
bound) and to JAX's (tokens equal); each engine to the JAX mesh engine
segment for segment.  In-process: ``param_pspecs`` and ``sanitize_spec``
against JAX's leaf for leaf (float and int8 trees, and large-v3's shapes at
model 2 and 4), and ``shard_params``' slice at each coordinate against the
JAX array's shard on the device there.

This module imports no JAX at its top: the ranks run its ``_rank_main``.
About 60-80 s on one worker (the JAX references most of it).
"""

import asyncio
import dataclasses
import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from ttasr_torch.models.whisper import decode as td
from ttasr_torch.models.whisper.config import WhisperConfig as TConfig
from ttasr_torch.models.whisper.load import params_from_jax
from ttasr_torch.ops.quant import quantize_params
from ttasr_torch.parallel import sharding

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
CFGS = {
    "micro": dict(vocab_size=256, num_mel_bins=80, d_model=64, encoder_layers=2,
                  encoder_heads=4, decoder_layers=2, decoder_heads=4, ffn_dim=128,
                  max_source_positions=32),
    "d384": dict(vocab_size=256, num_mel_bins=80, d_model=384, encoder_layers=1,
                 encoder_heads=6, decoder_layers=2, decoder_heads=6, ffn_dim=768,
                 max_source_positions=32),
    "cut3": dict(vocab_size=256, num_mel_bins=80, d_model=96, encoder_layers=1,
                 encoder_heads=3, decoder_layers=2, decoder_heads=3, ffn_dim=192,
                 max_source_positions=32),
}
# the engines' model: the micro widths at the byte-fallback tokenizer's
# vocabulary (1865 rows, odd: replicated at model 2) and a 30 s window
ENGINE_CFG = dict(CFGS["micro"], vocab_size=1865, max_source_positions=1500)
TI = dict(eot=250, sot=249, no_timestamps=248, timestamp_begin=200, no_speech=247,
          blank=(32,), suppress=(1, 2, 3), n_vocab=256)
SAMPLE_LEN = 12
BATCH = 3
MESHES = ((1, 2), (2, 1))
CASES = [(mesh, cfg, dtype, mode) for mesh in MESHES for cfg in CFGS
         for dtype in ("float32", "int8") for mode in ("beam", "greedy")
         if cfg != "cut3" or mesh == (1, 2)]
KEYS = list(dict.fromkeys(case[1:] for case in CASES))  # (cfg, dtype, mode)
ENGINES = [(mesh, dtype) for mesh in MESHES for dtype in ("float32", "int8")]
ENGINE_KW = dict(beam_size=2, vad_filter=False, max_new_tokens=10, temperature=(0.0,))

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
    mesh, cfg, dtype, mode = case
    return f"mesh{mesh[0]}x{mesh[1]}-{cfg}-{dtype}-{mode}"


def _opts(dtype, mode, module=td):
    int8 = dtype == "int8"
    return module.DecodingOptions(beam_size=3 if mode == "beam" else 1,
                                  sample_len=SAMPLE_LEN, kv_int8=int8, cross_kv_int8=int8)


def _inputs(cfg):
    """The seeded encoder states and sot prompts of a batch of BATCH."""
    enc = np.random.default_rng(3).standard_normal(
        (BATCH, CFGS[cfg]["max_source_positions"], CFGS[cfg]["d_model"])).astype(np.float32)
    prompt, pad = td.pad_prompts([[TI["sot"]]] * BATCH, TI["eot"], width=16)
    return enc, prompt, pad


def _audio(seed, hz):
    """1 s of a tone over faint noise (``tests/test_parallel.py``'s clips)."""
    t = np.arange(16000) / 16000
    rng = np.random.default_rng(seed)
    return (0.3 * np.sin(2 * np.pi * hz * t)
            + 0.02 * rng.standard_normal(16000)).astype(np.float32)


def _clips():
    rng = np.random.default_rng(2)
    t = np.arange(16000) / 16000
    return [(0.3 * np.sin(2 * np.pi * (200 + 60 * i) * t)
             + 0.02 * rng.standard_normal(16000)).astype(np.float32) for i in range(3)]


def _port_params(trees, cfg, dtype):
    params = params_from_jax(trees[cfg])
    return quantize_params(params) if dtype == "int8" else params


def _decode_out(out):
    return {k: out[k].cpu().numpy() for k in ("tokens", "lengths", "sum_logprob")}


async def _serve(engine, prompt, clips):
    from ttasr_torch.engine.serving import BatchServer

    server = BatchServer(engine, slots=4, beam_size=2, sample_len=8, linger_ms=20)
    await server.start()
    try:
        return await asyncio.gather(*[server.transcribe_window(c, prompt) for c in clips])
    finally:
        await server.stop()


def _segments(segments):
    return [dataclasses.asdict(s) for s in segments]


# ---------------------------------------------------------------------------
# The ranks (run in subprocesses, jax blocked)
# ---------------------------------------------------------------------------

def _rank_main(rank: int, tmp: str) -> None:
    from ttasr_torch.engine.transcriber import WhisperEngine
    from ttasr_torch.parallel.distributed import initialize_distributed
    from ttasr_torch.parallel.gspmd import ShardedDecoder
    from ttasr_torch.text.tokenizer import build_byte_fallback_tokenizer

    torch.set_num_threads(1)
    initialize_distributed(f"file://{tmp}/store", WORLD, rank, backend="gloo")
    with open(os.path.join(tmp, "params.pkl"), "rb") as fh:
        trees = pickle.load(fh)
    meshes = {shape: sharding.create_mesh(*shape) for shape in MESHES}
    ti = td.TokenizerInfo(**TI)
    b13 = {"calls": 0}
    real_b13 = td.cross_attention_int8

    def counted(*args):
        b13["calls"] += 1
        return real_b13(*args)

    td.cross_attention_int8 = counted
    res = {}
    for case in CASES:
        mesh, cfg, dtype, mode = case
        dec = ShardedDecoder(sharding.shard_params(_port_params(trees, cfg, dtype), meshes[mesh]),
                             TConfig(name=cfg, **CFGS[cfg]), meshes[mesh])
        enc, prompt, pad = _inputs(cfg)
        b13["calls"] = 0
        if mode == "beam":
            out = dec.beam(torch.from_numpy(enc), prompt, pad, opts=_opts(dtype, mode), ti=ti)
        else:
            out = dec.greedy(torch.from_numpy(enc), prompt, pad, None, 0.0,
                             opts=_opts(dtype, mode), ti=ti)
        heads = dec.params["decoder"]["blocks"][0]["wq"]
        res[_case_id(case)] = dict(
            _decode_out(out), steps=out["steps"], b13_calls=b13["calls"],
            local_width=(heads["q"] if isinstance(heads, dict) else heads).shape[-1])
    td.cross_attention_int8 = real_b13

    tok = build_byte_fallback_tokenizer()
    engine_params = params_from_jax(trees["engine"])
    cfg = TConfig(name="micro", **ENGINE_CFG)
    for mesh, dtype in ENGINES:
        engine = WhisperEngine("micro", compute_type=dtype, device="cpu",
                               params=engine_params, config=cfg, tokenizer=tok,
                               mesh=meshes[mesh])
        segments, info = engine.transcribe(_audio(1, 330), **ENGINE_KW)
        res[f"engine-{mesh}-{dtype}"] = dict(
            segments=_segments(segments), info=dataclasses.asdict(info),
            stats=engine.decode_stats, tp=engine._tp is not None,
            sharded=engine._sharded is not None)
        if (mesh, dtype) == ((1, 2), "float32"):
            prompt = tok.sot_sequence("zh", predict_timestamps=True)
            res["server"] = [r.tokens for r in asyncio.run(_serve(engine, prompt, _clips()))]
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as fh:
        pickle.dump(res, fh)


# ---------------------------------------------------------------------------
# The JAX references (this process)
# ---------------------------------------------------------------------------

def _jax_decodes(trees):
    """JAX's beam_decode/greedy_decode on shard_params(..., create_mesh(1,
    2)) for every (configuration, dtype, mode) of CASES."""
    import jax

    from ttasr.models.whisper import decode as jd
    from ttasr.models.whisper.config import WhisperConfig as JConfig
    from ttasr.ops.quant import quantize_params as j_quantize
    from ttasr.parallel.sharding import create_mesh, shard_params

    mesh, ti, res = create_mesh(data=1, model=2), jd.TokenizerInfo(**TI), {}
    key = jax.random.PRNGKey(0)
    for cfg, dtype, mode in KEYS:
        params = jax.tree.map(jax.numpy.asarray, trees[cfg])
        if dtype == "int8":
            params = j_quantize(params)
        sp = shard_params(params, mesh)
        enc, prompt, pad = _inputs(cfg)
        fn = jd.beam_decode if mode == "beam" else jd.greedy_decode
        out = fn(sp, JConfig(name=cfg, **CFGS[cfg]), enc, prompt, pad, key,
                 opts=_opts(dtype, mode, jd), ti=ti)
        res[cfg, dtype, mode] = {k: np.asarray(out[k]) for k in ("tokens", "lengths")}
    return res


def _jax_engines(trees):
    """The JAX mesh engine (float32 and int8) on the engine clip, and a
    BatchServer over the float32 one."""
    import jax

    from ttasr.engine.serving import BatchServer
    from ttasr.engine.transcriber import WhisperEngine as JEngine
    from ttasr.models.whisper.config import WhisperConfig as JConfig
    from ttasr.parallel.sharding import create_mesh
    from ttasr.text.tokenizer import build_byte_fallback_tokenizer

    tok = build_byte_fallback_tokenizer()
    params = jax.tree.map(jax.numpy.asarray, trees["engine"])
    cfg = JConfig(name="micro", **ENGINE_CFG)
    res = {}
    for dtype in ("float32", "int8"):
        engine = JEngine("micro", compute_type=dtype, params=params, config=cfg,
                         tokenizer=tok, mesh=create_mesh(data=1, model=2))
        assert engine._tp is None
        segments, info = engine.transcribe(_audio(1, 330), **ENGINE_KW)
        res[dtype] = dict(segments=_segments(segments), info=dataclasses.asdict(info))
        if dtype == "float32":
            prompt = tok.sot_sequence("zh", predict_timestamps=True)

            async def serve():
                server = BatchServer(engine, slots=4, beam_size=2, sample_len=8,
                                     linger_ms=20)
                await server.start()
                try:
                    return await asyncio.gather(*[server.transcribe_window(c, prompt)
                                                  for c in _clips()])
                finally:
                    await server.stop()

            res["server"] = [r.tokens for r in asyncio.run(serve())]
    return res


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The micro models' eager ops run on one thread here, as in the ranks:
    the suite runs several workers to a machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    import jax

    from ttasr.models.whisper import model as jm
    from ttasr.models.whisper.config import WhisperConfig as JConfig

    tmp = str(tmp_path_factory.mktemp("sharded_ranks"))
    trees = {name: jax.tree.map(np.asarray, jm.init_params(JConfig(name=name, **cfg),
                                                           seed=0))
             for name, cfg in dict(CFGS, engine=ENGINE_CFG).items()}
    with open(os.path.join(tmp, "params.pkl"), "wb") as fh:
        pickle.dump(trees, fh)
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    path = os.path.abspath(__file__)
    procs = [subprocess.Popen(
        [sys.executable, "-c", _BLOCK + _RUN.format(root=REPO_ROOT, path=path,
                                                     fn="_rank_main", args=(r, tmp))],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=REPO_ROOT,
        env=env) for r in range(WORLD)]
    try:
        jax_res = dict(decodes=_jax_decodes(trees), engines=_jax_engines(trees))
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
    return dict(port=port, jax=jax_res, trees=trees)


@pytest.fixture(scope="module")
def single(ranks):
    """The port's single-process decode of every (configuration, dtype,
    mode)."""
    ti, out = td.TokenizerInfo(**TI), {}
    for cfg, dtype, mode in KEYS:
        enc, prompt, pad = _inputs(cfg)
        args = (_port_params(ranks["trees"], cfg, dtype), TConfig(name=cfg, **CFGS[cfg]),
                torch.from_numpy(enc), prompt, pad)
        kw = dict(opts=_opts(dtype, mode), ti=ti)
        out[cfg, dtype, mode] = _decode_out(
            td.beam_decode(*args, **kw) if mode == "beam"
            else td.greedy_decode(*args, None, 0.0, **kw))
    return out


def _assert_same_tokens(got, want):
    np.testing.assert_array_equal(got["lengths"], want["lengths"])
    for row, n in enumerate(want["lengths"]):
        np.testing.assert_array_equal(got["tokens"][row, :n], want["tokens"][row, :n])


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_sharded_decode_matches_the_single_process_decode(ranks, single, case):
    got, want = ranks["port"][0][_case_id(case)], single[case[1:]]
    _assert_same_tokens(got, want)
    np.testing.assert_allclose(got["sum_logprob"], want["sum_logprob"], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_sharded_decode_matches_jax_on_shard_params(ranks, case):
    _assert_same_tokens(ranks["port"][0][_case_id(case)], ranks["jax"]["decodes"][case[1:]])


def test_every_rank_returns_the_whole_batch_on_its_shard(ranks):
    r0, r1 = ranks["port"]
    for case in CASES:
        mesh, cfg, _, _ = case
        for k in ("tokens", "lengths", "sum_logprob"):
            np.testing.assert_array_equal(r0[_case_id(case)][k], r1[_case_id(case)][k])
        assert r0[_case_id(case)]["tokens"].shape == (BATCH, SAMPLE_LEN)
        # the q columns split over "model" ((1, 2)), whole on a data axis
        assert r0[_case_id(case)]["local_width"] == CFGS[cfg]["d_model"] // mesh[1]


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"mesh{m[0]}x{m[1]}")
def test_b13_runs_per_shard_on_three_local_heads(ranks, mesh):
    """d384's int8 graph: 6 heads, 3 a shard at (1, 2); B13's wrapper (its
    plain version on the CPU) takes every decode step's cross-attention,
    layers x steps calls, on the odd local count too."""
    for mode in ("beam", "greedy"):
        got = ranks["port"][0][_case_id((mesh, "d384", "int8", mode))]
        assert got["b13_calls"] == CFGS["d384"]["decoder_layers"] * got["steps"] > 0


@pytest.mark.parametrize("engine", ENGINES, ids=lambda e: f"mesh{e[0][0]}x{e[0][1]}-{e[1]}")
def test_mesh_engine_matches_the_jax_mesh_engine(ranks, engine):
    mesh, dtype = engine
    got = ranks["port"][0][f"engine-{mesh}-{dtype}"]
    want = ranks["jax"]["engines"][dtype]
    assert got["sharded"] and not got["tp"]  # TP refuses 16-wide heads
    assert got["stats"]["beam_decodes"] > 0 and got["stats"]["nonfinite_logits"] == 0
    assert got["info"] == want["info"]
    assert len(got["segments"]) == len(want["segments"]) > 0
    for g, w in zip(got["segments"], want["segments"]):
        assert (g["id"], g["seek"], g["tokens"], g["text"]) == (
            w["id"], w["seek"], w["tokens"], w["text"])
        assert (g["start"], g["end"], g["temperature"]) == (
            w["start"], w["end"], w["temperature"])
        assert g["avg_logprob"] == pytest.approx(w["avg_logprob"], rel=1e-4)
        assert g["no_speech_prob"] == pytest.approx(w["no_speech_prob"], rel=1e-3, abs=1e-8)
    assert ranks["port"][1][f"engine-{mesh}-{dtype}"]["segments"] == got["segments"]


def test_batchserver_serves_the_sharded_engine(ranks):
    """BatchServer over the (1, 2) float32 mesh engine: the slot-packed
    group of three windows decodes as the JAX server over the JAX mesh
    engine, and as the port's server over a single-process engine."""
    from ttasr_torch.engine.transcriber import WhisperEngine
    from ttasr_torch.text.tokenizer import build_byte_fallback_tokenizer

    got = ranks["port"][0]["server"]
    assert got == ranks["port"][1]["server"] == ranks["jax"]["engines"]["server"]
    tok = build_byte_fallback_tokenizer()
    base = WhisperEngine("micro", device="cpu", params=params_from_jax(ranks["trees"]["engine"]),
                         config=TConfig(name="micro", **ENGINE_CFG), tokenizer=tok)
    prompt = tok.sot_sequence("zh", predict_timestamps=True)
    assert [r.tokens for r in asyncio.run(_serve(base, prompt, _clips()))] == got


# ---------------------------------------------------------------------------
# In-process: the specs and the slices against JAX's
# ---------------------------------------------------------------------------

def _jax_tree(dtype, cfg=CFGS["micro"], shapes_only=False):
    import jax

    from ttasr.models.whisper import model as jm
    from ttasr.models.whisper.config import WhisperConfig as JConfig
    from ttasr.ops.quant import quantize_params as j_quantize

    def make():
        params = jm.init_params(JConfig(name="t", **cfg), seed=0)
        return j_quantize(params) if dtype == "int8" else params

    return jax.eval_shape(make) if shapes_only else make()


def _stacked(spec):
    """A port block leaf's spec as the JAX package's on the stacked layers."""
    return (None,) + tuple(spec) if spec else ()


def _jax_leaves(tree):
    """(path, leaf, in blocks) of every leaf of a JAX parameter tree (or of
    its spec tree), a quantized {q, s} leaf by part."""
    for part in ("encoder", "decoder"):
        for key, leaf in tree[part].items():
            for name, lf in (leaf.items() if key == "blocks" else [(key, leaf)]):
                for sub in (("q", "s") if isinstance(lf, dict) else (None,)):
                    yield (part, name, sub), (lf if sub is None else lf[sub]), key == "blocks"


def _port_leaf(tree, path, block):
    """The port tree's leaf at ``path``: one per layer in the blocks."""
    part, name, sub = path

    def get(d):
        return d[name] if sub is None else d[name][sub]

    return [get(b) for b in tree[part]["blocks"]] if block else get(tree[part])


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_param_pspecs_equal_jax_leaf_for_leaf(dtype):
    from ttasr.parallel.sharding import param_pspecs as j_pspecs

    jspecs = j_pspecs(_jax_tree(dtype))
    pspecs = sharding.param_pspecs(
        _port_params({"micro": _jax_tree("float32")}, "micro", dtype))
    n = 0
    for path, jspec, block in _jax_leaves(jspecs):
        got = _port_leaf(pspecs, path, block)
        if block:  # one spec per layer, the stacked axis dropped
            assert [_stacked(s) for s in got] == [tuple(jspec)] * len(got), path
        else:
            assert got == tuple(jspec), path
        n += 1
    assert n == len(list(_jax_leaves(_jax_tree(dtype)))) > 40


@pytest.mark.parametrize("model", [2, 4])
@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_sanitize_spec_equals_jax_at_large_v3(dtype, model):
    """large-v3's leaf shapes (shapes only) under the port's specs: every
    leaf sanitized as JAX sanitizes it; the 51866 vocabulary rows split in
    two at model 2 and replicated at model 4."""
    from ttasr.models.whisper.config import PRESETS
    from ttasr.parallel.sharding import create_mesh, param_pspecs as j_pspecs
    from ttasr.parallel.sharding import sanitize_spec as j_sanitize

    cfg = dataclasses.asdict(PRESETS["large-v3"])
    cfg.pop("name")
    shapes = _jax_tree(dtype, cfg, shapes_only=True)
    jmesh = create_mesh(data=1, model=model)
    mesh = sharding.Mesh(shape={"data": 1, "model": model},
                         coords={"data": 0, "model": 0}, groups={})
    # the specs depend on the names only: the micro tree's, layer 0's
    pspecs = sharding.param_pspecs(
        _port_params({"micro": _jax_tree("float32")}, "micro", dtype))
    n = 0
    for (path, jspec, block), (_, shape, _) in zip(_jax_leaves(j_pspecs(shapes)),
                                                    _jax_leaves(shapes)):
        pspec = _port_leaf(pspecs, path, block)
        pspec = pspec[0] if block else pspec
        got = sharding.sanitize_spec(pspec, shape.shape[1:] if block else shape.shape, mesh)
        assert ((None,) + got if block else got) == tuple(
            j_sanitize(jspec, shape.shape, jmesh)), path
        n += 1
    assert n > 40
    embed = sharding.sanitize_spec(("model", None), (51866, 1280), mesh)
    assert embed == (("model", None) if model == 2 else (None, None))


@pytest.mark.parametrize("shape", [(1, 2), (2, 1), (2, 4)], ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_shard_params_slice_equals_the_jax_shard_at_its_coordinates(dtype, shape):
    import jax

    from ttasr.parallel.sharding import create_mesh, shard_params as j_shard

    jtree = _jax_tree(dtype)
    jmesh = create_mesh(data=shape[0], model=shape[1])
    placed = j_shard(jtree, jmesh)
    port_tree = params_from_jax(jax.tree.map(np.asarray, jtree))
    for i in range(shape[0]):
        for j in range(shape[1]):
            mine = sharding.shard_params(port_tree, sharding.Mesh(
                shape={"data": shape[0], "model": shape[1]},
                coords={"data": i, "model": j}, groups={}))
            for path, jleaf, block in _jax_leaves(placed):
                data = np.asarray(next(s.data for s in jleaf.addressable_shards
                                       if s.device == jmesh.devices[i, j]))
                got = _port_leaf(mine, path, block)
                got = got if block else [got]
                assert all(t.is_contiguous() for t in got), path
                got = np.stack([t.numpy() for t in got]) if block else got[0].numpy()
                np.testing.assert_array_equal(got, data, err_msg=str(path))


def test_data_pspec_equals_jax():
    from ttasr.parallel.sharding import data_pspec as j_data

    for ndim in (1, 3):
        assert sharding.data_pspec(ndim) == tuple(j_data(ndim))


def test_the_sharded_decoder_takes_unfused_weights_only():
    from ttasr_torch.models.whisper.model import init_params
    from ttasr_torch.ops.quant import fuse_qkv
    from ttasr_torch.parallel.gspmd import ShardedDecoder

    cfg = TConfig(name="micro", **CFGS["micro"])
    mesh = sharding.Mesh(shape={"data": 1, "model": 2}, coords={"data": 0, "model": 1},
                         groups={})
    with pytest.raises(ValueError, match="fuse_qkv"):
        ShardedDecoder(sharding.shard_params(fuse_qkv(quantize_params(init_params(cfg))), mesh),
                       cfg, mesh)
    dec = ShardedDecoder(sharding.shard_params(quantize_params(init_params(cfg)), mesh), cfg, mesh)
    assert set(dec.params) == {"decoder"}
    assert dec.params["decoder"]["embed"]["q"].shape == (128, 64)
    assert dec.params["decoder"]["blocks"][0]["wo"]["q"].shape == (32, 64)
