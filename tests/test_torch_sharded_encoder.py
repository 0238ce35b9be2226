"""The encoder, the language detection and the word alignment on
``shard_params``' slices under a mesh (``WhisperEngine(mesh=...)`` keeps
only its shard, as the JAX engine does), on two ``gloo`` ranks, against the
port's one-process encoder and the JAX package on ``shard_params`` over the
8-device CPU mesh.

Configurations (2 encoder layers each, so layer 1's B5 reads W2's summed
accumulators):

- ``micro64``: ``micro64-test`` (d 128, 2 heads of 64, ffn 512): 1 head a
  rank at model 2;
- ``d384``: d 384, 6 heads of 64, ffn 768: 3 heads a rank (B11 on an odd
  local count);
- ``d192``: d 192, 3 heads of 64, ffn 384: at model 2 a rank's 96 q/k/v
  columns end inside a head, so the attention gathers q/k/v whole, runs on
  every head and keeps the rank's columns.  Its global head count is odd,
  and the JAX package's rule (``ttasr/models/whisper/model.py:377-379``)
  keeps such an encoder off the s8 x s8 blocks, so its int8 engine runs the
  float blocks on int8 weights; the cut-head s8 x s8 blocks (large-v3 at
  model 8: 20 heads, 2.5 a rank) are driven here below that rule, through
  ``encode``'s stem with ``_encoder_blocks`` forced to the act8 branch.

Meshes (1, 2) and (2, 1), float32 and int8 (``quantize_params`` without
``fuse_qkv``, the encoder's codes laid out K-major after the slicing), a
batch of two 2 s windows.  The ranks (subprocesses with ``jax``, ``ttasr``
and ``tools`` blocked) encode every case; meanwhile the JAX references run
in this process.  Held:

- the int8 (s8 x s8) sharded encoder bit for bit to the one-process encoder
  on the same unfused params, with the row kernels (B7's and B9's split
  entries) and with the plain quantize chains (``encoder_fused_quant=False``);
- the float32 sharded encoder within 1e-5 x max of JAX's ``encode`` on
  ``shard_params(..., create_mesh(1, 2))``, and the int8 one within the
  bound of ``tests/test_torch_int8_encoder.py`` (2e-2 x max at the worst
  element, 1e-3 x max on average) of JAX's s8 x s8 encode on the same
  slices, its Pallas kernels in interpret mode (they run under the sharded
  jit: GSPMD replicates a ``pallas_call``);
- the data axis: the JAX engine hands its jit an unplaced numpy batch, and
  its output comes back replicated (``PartitionSpec()``) on the 8-device
  CPU mesh at (2, 1) and (2, 2), every device of the data axis holding the
  whole batch; so each data rank encodes the whole batch, as here.

In process: the split entries' plain versions against the whole-row plain
versions at each shard's columns; the mesh engine's leaves (each of
``slice_shape`` in storage of its own, the encoder codes K-major, the
decoder view sharing the engine's slices).  The mesh engines (micro64-test at (1, 2), float32 and
int8) against the JAX mesh engine: the detected language, the transcript
and the words (times within 0.02 s).

This module imports no JAX at its top: the ranks run its ``_rank_main``.
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

from ttasr_torch.models.whisper import model as tm
from ttasr_torch.models.whisper.config import PRESETS as T_PRESETS
from ttasr_torch.models.whisper.config import WhisperConfig as TConfig
from ttasr_torch.models.whisper.load import params_from_jax
from ttasr_torch.ops import encoder_fused as t_fused
from ttasr_torch.ops.quant import kmajor_encoder_codes, quantize_params
from ttasr_torch.parallel import sharding

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
_MICRO = {k: v for k, v in dataclasses.asdict(T_PRESETS["micro64-test"]).items()
          if k != "name"}
CFGS = {
    "micro64": _MICRO,
    "d384": dict(vocab_size=256, num_mel_bins=80, d_model=384, encoder_layers=2,
                 encoder_heads=6, decoder_layers=1, decoder_heads=6, ffn_dim=768,
                 max_source_positions=128),
    "d192": dict(vocab_size=256, num_mel_bins=80, d_model=192, encoder_layers=2,
                 encoder_heads=3, decoder_layers=1, decoder_heads=3, ffn_dim=384,
                 max_source_positions=128),
}
MESHES = ((1, 2), (2, 1))
DTYPES = ("float32", "int8")
CASES = [(mesh, cfg, dtype) for mesh in MESHES for cfg in CFGS for dtype in DTYPES]
# the s8 x s8 encoder's other routes: the plain quantize chains, and the
# cut-head act8 blocks below the JAX package's even-head rule
ACT8_EXTRA = [(mesh, "micro64", "chains") for mesh in MESHES] + [
    (mesh, "d192", "forced") for mesh in MESHES]
FRAMES = 200  # 2 s windows: 100 encoder rows
ENGINE_KW = dict(beam_size=2, vad_filter=False, max_new_tokens=8, temperature=(0.0,),
                 word_timestamps=True)

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


def _cfg(name):
    return TConfig(name=name, **CFGS[name])


def _mel():
    return (np.random.default_rng(5).standard_normal((2, 80, FRAMES)) * 0.5
            ).astype(np.float32)


def _audio():
    """1 s of a tone over faint noise (``tests/test_parallel.py``'s clips)."""
    t = np.arange(16000) / 16000
    rng = np.random.default_rng(1)
    return (0.3 * np.sin(2 * np.pi * 330 * t)
            + 0.02 * rng.standard_normal(16000)).astype(np.float32)


def _port_params(tree, dtype):
    params = params_from_jax(tree)
    return quantize_params(params) if dtype == "int8" else params


def _forced_act8():
    """``_encoder_blocks`` on the s8 x s8 branch with its row kernels,
    whatever ``encode``'s rule chose (a restore function comes back)."""
    real = tm._encoder_blocks

    def forced(x, blocks, cfg, **kw):
        return real(x, blocks, cfg, **dict(kw, act8=True, fused_quant=True))

    tm._encoder_blocks = forced
    return lambda: setattr(tm, "_encoder_blocks", real)


def _encode(params, cfg, route="auto"):
    """``encode`` of the seeded batch by ``route``: the engine's rule
    (``auto``), the plain quantize chains (``chains``) or the forced act8
    blocks (``forced``)."""
    mel = torch.from_numpy(_mel())
    if route == "forced":
        restore = _forced_act8()
        try:
            return tm.encode(params, cfg, mel)
        finally:
            restore()
    return tm.encode(params, cfg, mel, fused_quant=False if route == "chains" else None)


def _words(segments):
    return [[(w.word, w.start, w.end) for w in (s.words or [])] for s in segments]


# ---------------------------------------------------------------------------
# The ranks (run in subprocesses, jax blocked)
# ---------------------------------------------------------------------------

def _rank_main(rank: int, tmp: str) -> None:
    from ttasr_torch.engine.transcriber import WhisperEngine
    from ttasr_torch.parallel.distributed import initialize_distributed
    from ttasr_torch.text.tokenizer import build_byte_fallback_tokenizer

    torch.set_num_threads(1)
    initialize_distributed(f"file://{tmp}/store", WORLD, rank, backend="gloo")
    with open(os.path.join(tmp, "params.pkl"), "rb") as fh:
        trees = pickle.load(fh)
    meshes = {shape: sharding.create_mesh(*shape) for shape in MESHES}
    calls = {"quant_only_absmax": 0, "gelu_quant_acc_absmax": 0}
    for name in calls:
        real = getattr(t_fused, name)

        def counted(*a, _real=real, _name=name):
            calls[_name] += 1
            return _real(*a)

        setattr(t_fused, name, counted)
    res = {}
    runs = [(mesh, cfg, dtype, "auto") for mesh, cfg, dtype in CASES] + [
        (mesh, cfg, "int8", route) for mesh, cfg, route in ACT8_EXTRA]
    for mesh, cfg, dtype, route in runs:
        shard = sharding.shard_params(_port_params(trees[cfg], dtype), meshes[mesh])
        if dtype == "int8":
            shard = kmajor_encoder_codes(shard)
        for name in calls:
            calls[name] = 0
        with sharding.bind_axes({"model": meshes[mesh].groups["model"]}):
            out = _encode(shard, _cfg(cfg), route)
        res[mesh, cfg, dtype, route] = dict(out=out.numpy(), calls=dict(calls))

    tok = build_byte_fallback_tokenizer()
    for dtype in DTYPES:
        engine = WhisperEngine("micro64-test", compute_type=dtype, device="cpu",
                               params=params_from_jax(trees["micro64"]),
                               config=_cfg("micro64"), tokenizer=tok, mesh=meshes[(1, 2)])
        segments, info = engine.transcribe(_audio(), **ENGINE_KW)
        res["engine", dtype] = dict(
            texts=[(s.tokens, s.text, s.start, s.end) for s in segments],
            words=_words(segments), language=info.language,
            probability=info.language_probability,
            sharded=engine._sharded is not None)
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as fh:
        pickle.dump(res, fh)


# ---------------------------------------------------------------------------
# The JAX references (this process)
# ---------------------------------------------------------------------------

def _interpreted(fn):
    def run(*args, interpret=False, **kw):
        return fn(*args, interpret=True, **kw)
    return run


def _jax_act8(monkeypatch):
    """The JAX s8 x s8 encoder as a TPU runs it, on the CPU (the
    ``jax_act8`` fixture of ``tests/test_torch_int8_encoder.py``)."""
    from ttasr.models.whisper import model as jm
    from ttasr.ops import encoder_attention_pallas as j_att
    from ttasr.ops import encoder_fused_pallas as j_fused

    monkeypatch.setattr(jm, "_use_fused_encoder_attention", lambda dh: dh == 64)
    for mod, names in ((j_fused, ("ln_quant", "add_ln_quant", "gelu_quant", "quant_only")),
                       (j_att, ("encoder_attention_merged_qkv",
                                "encoder_attention_merged"))):
        for name in names:
            monkeypatch.setattr(mod, name, _interpreted(getattr(mod, name)))


def _jax_references(trees):
    """JAX's encode on shard_params(..., create_mesh(1, 2)) of every
    (configuration, dtype), and the JAX mesh engines' transcripts."""
    import jax

    from ttasr.engine.transcriber import WhisperEngine as JEngine
    from ttasr.models.whisper import model as jm
    from ttasr.models.whisper.config import WhisperConfig as JConfig
    from ttasr.ops.quant import quantize_params as j_quantize
    from ttasr.parallel.sharding import create_mesh, shard_params
    from ttasr.text.tokenizer import build_byte_fallback_tokenizer

    mesh, res = create_mesh(data=1, model=2), {}
    tok = build_byte_fallback_tokenizer()
    for dtype in DTYPES:
        with pytest.MonkeyPatch.context() as mp:
            if dtype == "int8":  # float32 runs the JAX package's CPU path
                _jax_act8(mp)
            for cfg in CFGS:
                jcfg = JConfig(name=cfg, **CFGS[cfg])
                params = jax.tree.map(jax.numpy.asarray, trees[cfg])
                if dtype == "int8":
                    params = j_quantize(params)
                run = jax.jit(lambda p, m, c=jcfg: jm.encode(p, c, m))
                res[cfg, dtype] = np.asarray(run(shard_params(params, mesh), _mel()))
            engine = JEngine("micro64-test", compute_type=dtype,
                             params=jax.tree.map(jax.numpy.asarray, trees["micro64"]),
                             config=JConfig(name="micro64", **CFGS["micro64"]),
                             tokenizer=tok, mesh=mesh)
            segments, info = engine.transcribe(_audio(), **ENGINE_KW)
            res["engine", dtype] = dict(
                texts=[(s.tokens, s.text, s.start, s.end) for s in segments],
                words=_words(segments), language=info.language,
                probability=info.language_probability)
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

    tmp = str(tmp_path_factory.mktemp("sharded_encoder_ranks"))
    trees = {name: jax.tree.map(np.asarray, jm.init_params(JConfig(name=name, **cfg), seed=0))
             for name, cfg in CFGS.items()}
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
        jax_res = _jax_references(trees)
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
    """The port's one-process encoder of every case and route, on the
    same unfused params (the mesh engine's route)."""
    out = {}
    keys = {(cfg, dtype, "auto") for _, cfg, dtype in CASES} | {
        (cfg, "int8", route) for _, cfg, route in ACT8_EXTRA}
    for cfg, dtype, route in sorted(keys):
        params = _port_params(ranks["trees"][cfg], dtype)
        if dtype == "int8":
            params = kmajor_encoder_codes(params)
        out[cfg, dtype, route] = _encode(params, _cfg(cfg), route).numpy()
    return out


def _case_id(case):
    mesh, cfg, dtype = case[:3]
    return f"mesh{mesh[0]}x{mesh[1]}-{cfg}-{dtype}"


def _act8(cfg, dtype):
    return dtype == "int8" and CFGS[cfg]["encoder_heads"] % 2 == 0


@pytest.mark.parametrize("case", CASES + [(m, c, "int8", r) for m, c, r in ACT8_EXTRA],
                         ids=lambda c: _case_id(c) + ("" if len(c) == 3 else f"-{c[3]}"))
def test_sharded_encoder_against_the_one_process_encoder(ranks, single, case):
    """Every rank returns the whole batch.  The s8 x s8 routes equal the
    one-process encoder bit for bit (the split scales and the int32 sums
    are exact); the float blocks sum the row-split projections in another
    order, so they are held within 1e-5 x max."""
    mesh, cfg, dtype = case[:3]
    route = case[3] if len(case) == 4 else "auto"
    want = single[cfg, dtype, route]
    got = [r[mesh, cfg, dtype, route] for r in ranks["port"]]
    assert got[0]["out"].shape == (2, FRAMES // 2, CFGS[cfg]["d_model"])
    np.testing.assert_array_equal(got[0]["out"], got[1]["out"])
    split = mesh[1] > 1
    if route != "auto" or _act8(cfg, dtype):
        np.testing.assert_array_equal(got[0]["out"], want)
        if route != "chains":
            # B7's and B9's split entries run once a layer where the axis splits
            n = CFGS[cfg]["encoder_layers"] if split else 0
            assert got[0]["calls"] == dict(quant_only_absmax=n, gelu_quant_acc_absmax=n)
    else:
        np.testing.assert_allclose(got[0]["out"], want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_sharded_encoder_against_jax_on_shard_params(ranks, case):
    mesh, cfg, dtype = case
    got = ranks["port"][0][mesh, cfg, dtype, "auto"]["out"]
    want = ranks["jax"][cfg, dtype]
    scale = np.abs(want).max()
    if _act8(cfg, dtype):
        err = np.abs(got - want)
        assert err.max() <= 2e-2 * scale and err.mean() <= 1e-3 * scale
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale)


@pytest.mark.parametrize("dtype", DTYPES)
def test_mesh_engine_matches_the_jax_mesh_engine(ranks, dtype):
    """micro64-test at (1, 2): the language detected from the first window,
    the transcript and the words (times within 0.02 s), on every rank."""
    got, want = ranks["port"][0]["engine", dtype], ranks["jax"]["engine", dtype]
    assert got["sharded"]
    assert got["language"] == want["language"]
    assert got["probability"] == pytest.approx(want["probability"], rel=1e-3)
    assert len(got["texts"]) == len(want["texts"]) > 0
    for g, w in zip(got["texts"], want["texts"]):
        assert g[:2] == w[:2] and g[2:] == pytest.approx(w[2:], abs=1e-6)
    assert [len(s) for s in got["words"]] == [len(s) for s in want["words"]]
    assert sum(len(s) for s in got["words"]) > 0
    for gs, ws in zip(got["words"], want["words"]):
        for g, w in zip(gs, ws):
            assert g[0] == w[0] and abs(g[1] - w[1]) <= 0.02 and abs(g[2] - w[2]) <= 0.02
    assert ranks["port"][1]["engine", dtype] == got


# ---------------------------------------------------------------------------
# In process
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("parts", [2, 4])
@pytest.mark.parametrize("entry", ["quant_only", "gelu_quant_acc"])
def test_split_entries_equal_the_whole_row_entry_at_each_shards_columns(entry, parts):
    """The plain versions of the split entries: each part's absmax, their
    max, each part's codes pass; the codes and scales are the whole-row
    plain version's at the part's columns, bit for bit (widths 1280 and
    5120 over 2 and 4 parts: large-v3's shard widths)."""
    rng = np.random.default_rng(parts)
    rows = 24
    if entry == "quant_only":
        x = torch.from_numpy(rng.standard_normal((2, rows, 1280)).astype(np.float32)
                             ).to(torch.bfloat16)
        whole = t_fused.quant_only_ref(x)
        cols = x.chunk(parts, dim=-1)
        absmax = torch.stack([t_fused.quant_only_absmax_ref(c) for c in cols]).amax(0)
        got = [t_fused.quant_only_scaled_ref(c, absmax) for c in cols]
    else:
        acc = torch.from_numpy(rng.integers(-60000, 60000, (2, rows, 5120)).astype(np.int32))
        xs = torch.from_numpy(rng.uniform(1e-4, 1e-3, (2, rows, 1)).astype(np.float32))
        ws = torch.from_numpy(rng.uniform(1e-4, 1e-3, (1, 5120)).astype(np.float32))
        b = torch.from_numpy(rng.standard_normal(5120).astype(np.float32) * 0.1)
        whole = t_fused.gelu_quant_acc_ref(acc, xs, ws, b)
        split = [(a, w, bb) for a, w, bb in zip(acc.chunk(parts, -1), ws.chunk(parts, -1),
                                                 b.chunk(parts))]
        passes = [t_fused.gelu_quant_acc_absmax_ref(a, xs, w, bb) for a, w, bb in split]
        absmax = torch.stack([p[0] for p in passes]).amax(0)
        got = [t_fused.gelu_quant_scaled_ref(p[1], absmax) for p in passes]
    torch.testing.assert_close(torch.cat([g[0] for g in got], -1), whole[0], rtol=0, atol=0)
    for g in got:
        torch.testing.assert_close(g[1], whole[1], rtol=0, atol=0)


@pytest.mark.parametrize("model", [2, 4])
def test_the_mesh_engine_keeps_only_its_slices(model):
    """``WhisperEngine(mesh=...)`` at (1, model) (a hand-made mesh: the
    slicing needs no process group): every leaf of ``engine.params`` has the
    shape of its ``shard_params`` slice, the encoder's int8 codes are
    K-major (``torch._int_mm``'s layout, which a column slice of K-major
    codes keeps and a row slice loses), and the GSPMD decode reads the
    engine's own slices."""
    from ttasr_torch.core.checkpoint import named_leaves
    from ttasr_torch.engine.transcriber import WhisperEngine
    from ttasr_torch.models.whisper.model import init_params

    cfg = _cfg("d384")
    whole = quantize_params(init_params(cfg))
    mesh = sharding.Mesh(shape={"data": 1, "model": model},
                         coords={"data": 0, "model": model - 1}, groups={})
    engine = WhisperEngine("d384", compute_type="int8", device="cpu",
                           params=init_params(cfg), config=cfg, mesh=mesh)
    specs = sharding.leaf_specs(whole, mesh)
    mine = dict(sharding._by_path(engine.params, lambda spec, shape: tuple(shape)))
    wants = sharding._by_path(whole, lambda spec, shape: tuple(shape))
    assert mine.keys() == wants.keys()
    split = 0
    for path, shape in mine.items():
        assert shape == sharding.slice_shape(wants[path], specs[path], mesh), path
        split += shape != wants[path]
    assert split > 10
    # no slice keeps its whole leaf's storage alive (a row block of a
    # contiguous leaf is a contiguous view of it)
    for path, leaf in named_leaves(engine.params).items():
        if tuple(leaf.shape) != wants[path]:
            assert leaf.untyped_storage().nbytes() == leaf.numel() * leaf.element_size(), path
    for blk in engine.params["encoder"]["blocks"]:
        for key in ("wq", "wk", "wv", "wo", "w1", "w2"):
            q = blk[key]["q"]
            assert q.stride() == (1, q.shape[0]), key  # K-major
    assert engine._sharded.params["decoder"] is engine.params["decoder"]
    assert engine.params["encoder"]["blocks"][0]["w1"]["q"].shape == (384, 768 // model)
