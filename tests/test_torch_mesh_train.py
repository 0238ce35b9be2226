"""Fine-tuning on a mesh (``make_train_step(mesh=...)``,
``init_train_state(mesh=...)``, ``ttasr_torch.parallel.tp_train``) on four
``gloo`` ranks, against the port's single-process steps and the JAX
package's mesh step.

One module fixture starts the four ranks once, as subprocesses with
``jax``, ``ttasr`` and ``tools`` blocked.  They lay out five meshes,
``create_mesh`` (4, 1), (2, 2) and (1, 4) and ``create_multislice_mesh(
model=2, force_slices=2)`` -> (2, 1, 2) and ``(model=1, force_slices=2)`` ->
(2, 2, 1), and run the cases of CASES from the same seeded params and
batches (JAX's ``_train_fixture`` model, ``tests/test_parallel.py:335-350``:
d 64, 4 heads, ffn 128, 2 + 2 layers, a batch of 4; and ``cut3``, d 96 with
3 heads of 32, where the model axis cuts a head), two steps each (four
micro-steps under ``MultiSteps``), AdamW at lr 1e-5 with no warm-up and a
weight decay.  Meanwhile this process runs the JAX package's
``make_train_step`` on ``create_mesh(2, 2, devices[:4])`` and on the forced
multislice mesh (2, 1, 2) over the same inputs.

Each case is held to the port's single-process steps (loss within 1e-5 and
params within rtol 2e-5, atol 2e-6: the JAX multislice test's bounds) and
to the JAX mesh step (``tests/test_torch_train_step.py``'s: loss 1e-5
relative, params within 0.1 lr; the bf16 case's loss 1e-3 relative, its
params where the JAX gradient is firm).  ZeRO-1 is held to replicated
moments on the same mesh (rtol 1e-6, atol 1e-7).  A batch whose ranks hold
unequal label counts must match, and a mean of the ranks' means must not.
The autograd collectives are held to single-process gradients, and a
version of the row-split sum with ``torch.distributed.nn``'s all-reduce
must fail the same check.

SpecAugment's case is held to the port's single-process step only: the
JAX package draws its masks with ``jax.random``.  The ranks use one torch
thread each; about 60 s on one worker.
"""

import dataclasses
import hashlib
import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from ttasr_torch.core.checkpoint import named_leaves
from ttasr_torch.models.whisper.config import WhisperConfig as TConfig
from ttasr_torch.models.whisper.load import params_from_jax
from ttasr_torch.train import train_step as tts
from ttasr_torch.train.spec_augment import SpecAugmentConfig

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
CFGS = {
    "micro": dict(vocab_size=256, num_mel_bins=80, d_model=64, encoder_layers=2,
                  encoder_heads=4, decoder_layers=2, decoder_heads=4, ffn_dim=128,
                  max_source_positions=32),
    "cut3": dict(vocab_size=256, num_mel_bins=80, d_model=96, encoder_layers=1,
                 encoder_heads=3, decoder_layers=2, decoder_heads=3, ffn_dim=192,
                 max_source_positions=32),
}
MESHES = {"4x1": (4, 1), "2x2": (2, 2), "1x4": (1, 4), "2x1x2": (2, 1, 2), "2x2x1": (2, 2, 1)}
OPT = dict(total_steps=10, warmup_steps=0, weight_decay=0.01)  # lr 1e-5
LR = 1e-5
SPEC = dict(mask_time_prob=0.2, mask_time_length=5, mask_time_min_masks=1,
            mask_feature_prob=0.1, mask_feature_length=8, mask_feature_min_masks=1)
CASES = dict(
    **{f"f32-{m}": dict(mesh=m) for m in MESHES},
    **{"cut3-2x2": dict(mesh="2x2", cfg="cut3"),
       "bf16-2x2": dict(mesh="2x2", compute_dtype="bfloat16"),
       "multisteps-2x1x2": dict(mesh="2x1x2", every_k=2),
       "freeze-unequal-4x1": dict(mesh="4x1", freeze_encoder=True, unequal=True),
       "specaugment-2x2x1": dict(mesh="2x2x1", spec=True),
       "replicated-2x2": dict(mesh="2x2", zero1=False)})
# the JAX mesh step of each case: on the forced multislice mesh for its own
# f32 case, else on (2, 2) (GSPMD's result does not depend on the mesh)
JAX_CASES = {"f32-2x1x2": ("2x1x2", {}), "f32": ("2x2", {}),
             "cut3": ("2x2", dict(cfg="cut3")),
             "bf16": ("2x2", dict(compute_dtype="bfloat16")),
             "multisteps": ("2x2", dict(every_k=2)),
             "freeze": ("2x2", dict(freeze_encoder=True, unequal=True))}
LOSS_ABS, P_RTOL, P_ATOL = 1e-5, 2e-5, 2e-6


def _jax_key(name):
    """The JAX_CASES entry a case is held to (None: SpecAugment's)."""
    if name == "f32-2x1x2":
        return name
    kind = name.split("-")[0]
    return None if kind == "specaugment" else {"replicated": "f32"}.get(kind, kind)


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


def _batches(case):
    """The seeded global batches of a case: 4 rows, mel (80, 64), 8 tokens;
    ``unequal`` pads the labels to 8, 2, 1 and 5 tokens a row; ``spec``
    adds the valid frames SpecAugment reads.  Two steps, four micro-steps
    under ``MultiSteps``, one in bf16: its forward reads the master params
    rounded to bf16, and a last-bit difference of a param after a step
    (the gradient's sum order) moves that rounding by a bf16 step (the
    second step's loss moved by 1.5e-4 at (2, 2))."""
    out = []
    for k in range(4 if case.get("every_k") else 1 if case.get("compute_dtype") else 2):
        rng = np.random.default_rng(k)
        b = {"mel": rng.standard_normal((4, 80, 64)).astype(np.float32),
             "decoder_input_ids": rng.integers(0, 256, (4, 8)).astype(np.int32),
             "labels": rng.integers(0, 256, (4, 8)).astype(np.int32)}
        if case.get("unequal"):
            for row, n in enumerate((8, 2, 1, 5)):
                b["labels"][row, n:] = -100
        if case.get("spec"):
            b["num_frames"] = np.array([64, 50, 31, 64], np.int32)
        out.append(b)
    return out


def _optimizer(module, case):
    opt = module.make_optimizer(**OPT)
    if case.get("every_k"):
        if module is tts:
            return dataclasses.replace(opt, every_k=case["every_k"])
        import optax

        return optax.MultiSteps(opt, every_k_schedule=case["every_k"])
    return opt


def _port_steps(trees, case, mesh=None):
    """(losses, whole params by leaf name, state) of the port's steps."""
    cfg = TConfig(name="t", **CFGS[case.get("cfg", "micro")])
    opt = _optimizer(tts, case)
    params = params_from_jax(trees[case.get("cfg", "micro")])
    state = tts.init_train_state(params, opt, mesh, zero1=case.get("zero1", True))
    step = tts.make_train_step(
        cfg, opt, mesh=mesh, remat=True, freeze_encoder=case.get("freeze_encoder", False),
        compute_dtype=getattr(torch, case["compute_dtype"]) if "compute_dtype" in case
        else None, spec_augment_cfg=SpecAugmentConfig(**SPEC) if case.get("spec") else None,
        seed=3)
    losses = []
    for batch in _batches(case):
        state, loss = step(state, batch)
        losses.append(float(loss))
    whole = {k: v.detach().numpy().copy() for k, v in
             named_leaves(state.whole_params()).items()}
    return losses, whole, state


def _digest(arrays):
    h = hashlib.sha1()
    for k in sorted(arrays):
        h.update(np.ascontiguousarray(arrays[k]).tobytes())
    return h.hexdigest()


# ---------------------------------------------------------------------------
# The ranks (run in subprocesses, jax blocked)
# ---------------------------------------------------------------------------

def _function_checks(mesh):
    """Each autograd collective on the model group of ``mesh`` against the
    same function computed whole: {name: max over the grads of max|gap| /
    max|whole|}.  ``control`` is the row-split sum through
    ``torch.distributed.nn.functional.all_reduce``."""
    import torch.distributed.nn.functional as dist_nn

    from ttasr_torch.parallel import tp_train
    from ttasr_torch.parallel.sharding import axis_index

    group = mesh.groups["model"]
    n, r = mesh.shape["model"], axis_index(mesh, "model")
    gen = torch.Generator().manual_seed(5)

    def rand(*shape):
        return torch.randn(shape, generator=gen, dtype=torch.float64)

    def cols(t):
        w = t.shape[-1] // n
        return t[..., r * w:(r + 1) * w]

    def rows(t):
        w = t.shape[0] // n
        return t[r * w:(r + 1) * w]

    def grads(fn, *leaves):
        leaves = [t.detach().clone().requires_grad_() for t in leaves]
        fn(*leaves).backward()
        return [t.grad for t in leaves]

    def gap(got, want):
        return max(float((g - w).abs().max() / w.abs().max()) for g, w in zip(got, want))

    x, w1, w2, c = rand(3, 8), rand(8, 16), rand(16, 8), rand(3, 8)
    e, tok = rand(16, 8), torch.tensor([[0, 5, 9, 15, 3], [12, 7, 7, 1, 8]])
    wq, wo = rand(8, 12), rand(12, 8)
    out = {}

    def mlp(reduce):
        def tp(x, a, b):
            h = torch.nn.functional.gelu(tp_train.copy_to_model(x, group) @ a)
            return (reduce(h @ b) * c).sum()
        return tp

    whole = grads(lambda x, a, b: (torch.nn.functional.gelu(x @ a) @ b * c).sum(), x, w1, w2)
    want = [whole[0], cols(whole[1]), rows(whole[2])]
    out["copy_to_model+reduce_from_model"] = gap(
        grads(mlp(lambda t: tp_train.reduce_from_model(t, group)), x, cols(w1), rows(w2)), want)
    out["control"] = gap(
        grads(mlp(lambda t: dist_nn.all_reduce(t, group=group)), x, cols(w1), rows(w2)), want)

    cw = rand(2, 5, 8)
    whole = grads(lambda e: (e[tok] * cw).sum(), e)
    out["vocab_embed"] = gap(grads(lambda e: (tp_train.vocab_embed(e, tok, group) * cw).sum(),
                                   rows(e)), [rows(whole[0])])

    def loss_of(logits):
        return (torch.log_softmax(logits, -1) * rand(3, 16)).sum()

    state = gen.get_state()
    whole = grads(lambda x, e: loss_of(x @ e.t()), x, e)
    gen.set_state(state)
    out["gather_vocab"] = gap(grads(lambda x, e: loss_of(tp_train.gather_vocab(
        tp_train.copy_to_model(x, group) @ e.t(), group)), x, rows(e)),
        [whole[0], rows(whole[1])])

    def cut(x, a, b, tp):
        q = (tp_train.copy_to_model(x, group) if tp else x) @ a
        if tp:
            q = tp_train.gather_cut_columns(q, group)
        h = torch.softmax(q.reshape(3, 4, 3), -1).reshape(3, 12) * q  # across the cut
        if tp:
            return (tp_train.reduce_from_model(cols(h) @ b, group) * c).sum()
        return (h @ b * c).sum()

    whole = grads(lambda x, a, b: cut(x, a, b, False), x, wq, wo)
    out["gather_cut_columns"] = gap(grads(lambda x, a, b: cut(x, a, b, True), x, cols(wq),
                                          rows(wo)), [whole[0], cols(whole[1]), rows(whole[2])])
    return out


def _rank_main(rank: int, tmp: str) -> None:
    from ttasr_torch.parallel.distributed import create_multislice_mesh, initialize_distributed
    from ttasr_torch.parallel.sharding import create_mesh

    torch.set_num_threads(1)
    initialize_distributed(f"file://{tmp}/store", WORLD, rank, backend="gloo")
    with open(os.path.join(tmp, "params.pkl"), "rb") as fh:
        trees = pickle.load(fh)
    meshes = {"4x1": create_mesh(4, 1), "2x2": create_mesh(2, 2), "1x4": create_mesh(1, 4),
              "2x1x2": create_multislice_mesh(model=2, force_slices=2),
              "2x2x1": create_multislice_mesh(model=1, force_slices=2)}
    res = {"coords": {k: m.coords for k, m in meshes.items()},
           "shapes": {k: m.shape for k, m in meshes.items()}, "cases": {}, "moments": {}}
    for name, case in CASES.items():
        losses, whole, state = _port_steps(trees, case, meshes[case["mesh"]])
        res["cases"][name] = dict(losses=losses, digest=_digest(whole),
                                  params=whole if rank == 0 else None)
        if name in ("f32-2x2", "replicated-2x2"):
            res["moments"][name] = {k: tuple(v.shape) for k, v in state.opt_state.mu.items()}
    try:
        tts.make_train_step(TConfig(name="t", **CFGS["micro"]), tts.make_optimizer(),
                            mesh=meshes["4x1"])(
            tts.init_train_state(params_from_jax(trees["micro"]), tts.make_optimizer(),
                                 meshes["4x1"]),
            {k: v[:3] for k, v in _batches({})[0].items()})
        res["indivisible"] = None
    except ValueError as exc:
        res["indivisible"] = str(exc)
    res["functions"] = _function_checks(meshes["1x4"])
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as fh:
        pickle.dump(res, fh)


# ---------------------------------------------------------------------------
# The JAX references (this process)
# ---------------------------------------------------------------------------

def _jax_meshes():
    import jax

    from ttasr.parallel.distributed import create_multislice_mesh
    from ttasr.parallel.sharding import create_mesh

    devs = jax.devices()[:4]
    return {"4x1": create_mesh(4, 1, devs), "2x2": create_mesh(2, 2, devs),
            "1x4": create_mesh(1, 4, devs),
            "2x1x2": create_multislice_mesh(model=2, devices=devs, force_slices=2),
            "2x2x1": create_multislice_mesh(model=1, devices=devs, force_slices=2)}


def _jax_steps(trees, mesh, case):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec

    from ttasr.models.whisper.config import WhisperConfig as JConfig
    from ttasr.parallel.sharding import shard_params
    from ttasr.train import train_step as jts

    cfg = JConfig(name="t", **CFGS[case.get("cfg", "micro")])
    opt = _optimizer(jts, case)
    losses = []
    with mesh:
        params = shard_params(jax.tree.map(jnp.asarray, trees[case.get("cfg", "micro")]), mesh)
        state = jts.init_train_state(params, opt, mesh=mesh)
        # every leaf on the mesh (the counters replicated), where the step
        # is put back after each call, so that every call reuses the first
        # one's compile (placement only: the same numbers)
        placed = jax.tree.map(lambda x: x.sharding if len(x.sharding.device_set) > 1
                              else NamedSharding(mesh, PartitionSpec()), state)
        state = jax.device_put(state, placed)
        step = jts.make_train_step(
            cfg, opt, mesh=mesh, remat=True, freeze_encoder=case.get("freeze_encoder", False),
            compute_dtype=jnp.bfloat16 if case.get("compute_dtype") else None)
        for batch in _batches(case):
            state, loss = step(state, batch)
            state = jax.device_put(state, placed)
            losses.append(float(loss))
    whole = named_leaves(params_from_jax(jax.tree.map(np.asarray, state.params)))
    return losses, {k: v.numpy() for k, v in whole.items()}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    import jax

    from ttasr.models.whisper import model as jm
    from ttasr.models.whisper.config import WhisperConfig as JConfig

    tmp = str(tmp_path_factory.mktemp("mesh_train_ranks"))
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
        jmeshes = _jax_meshes()
        jax_res = {key: _jax_steps(trees, jmeshes[m], kw) for key, (m, kw) in JAX_CASES.items()}
        coords = {name: {r: tuple(int(i) for i in np.argwhere(m.devices == jax.devices()[r])[0])
                         for r in range(WORLD)} for name, m in jmeshes.items()}
        jax_res["coords"] = coords
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
    """The port's single-process steps of every case (the mesh left out)."""
    return {name: _port_steps(ranks["trees"], case)[:2] for name, case in CASES.items()}


@pytest.fixture(scope="module")
def bf16_firm(ranks):
    """Where the bf16 case's first gradient (the port's, single-process) is
    firm, at least 0.1 of its leaf's largest: Adam's first update there is
    -lr sign(g) in any sum order."""
    case = CASES["bf16-2x2"]
    _, grads = tts.value_and_grad(
        params_from_jax(ranks["trees"]["micro"]), TConfig(name="t", **CFGS["micro"]),
        tts.batch_to(_batches(case)[0], "cpu"), remat=True, compute_dtype=torch.bfloat16)
    return {k: (g.abs() >= 0.1 * g.abs().max()).numpy() for k, g in grads.items()}


# ---------------------------------------------------------------------------
# The tests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh", list(MESHES))
def test_mesh_coordinates_are_jax_device_order(ranks, mesh):
    """Rank r sits where device r sits in the JAX mesh of the same
    shape (``create_multislice_mesh``'s ``reshape(n_slices, per_slice //
    model, model)`` included)."""
    for r in range(WORLD):
        got = ranks["port"][r]
        assert tuple(got["shapes"][mesh].values()) == MESHES[mesh]
        assert tuple(got["coords"][mesh].values()) == ranks["jax"]["coords"][mesh][r]


def _assert_params_close(got, want, rtol, atol, label):
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol, err_msg=f"{label} {k}")


@pytest.mark.parametrize("name", list(CASES))
def test_mesh_steps_match_the_single_process_steps(ranks, single, bf16_firm, name):
    """Loss and params; in bf16 the params where the gradient is firm (its
    bf16 backward's sum order differs between the layouts, and Adam's
    first update turns a gradient near zero into -lr sign(g)), the rest
    within that update."""
    got = ranks["port"][0]["cases"][name]
    want_losses, want = single[name]
    assert np.abs(np.subtract(got["losses"], want_losses)).max() < LOSS_ABS, (
        got["losses"], want_losses)
    if name.startswith("bf16"):
        for k in want:
            firm = bf16_firm[k]
            np.testing.assert_allclose(got["params"][k][firm], want[k][firm], rtol=P_RTOL,
                                       atol=P_ATOL, err_msg=k)
            np.testing.assert_allclose(got["params"][k], want[k], rtol=0, atol=2.2 * LR,
                                       err_msg=k)
        return
    _assert_params_close(got["params"], want, P_RTOL, P_ATOL, name)


@pytest.mark.parametrize("name", [n for n in CASES if _jax_key(n)])
def test_mesh_steps_match_the_jax_mesh_step(ranks, bf16_firm, name):
    got = ranks["port"][0]["cases"][name]
    want_losses, want = ranks["jax"][_jax_key(name)]
    start = {k: v.numpy() for k, v in named_leaves(params_from_jax(
        ranks["trees"][CASES[name].get("cfg", "micro")])).items()}
    if name.startswith("bf16"):
        # bf16 forwards of two frameworks: the tolerances of the one-card
        # bf16 step's test, its params where the JAX gradient is firm
        np.testing.assert_allclose(got["losses"], want_losses, rtol=1e-3)
        for k in want:
            firm = bf16_firm[k]
            np.testing.assert_allclose((got["params"][k] - start[k])[firm],
                                       (want[k] - start[k])[firm], rtol=0, atol=0.1 * LR)
        return
    np.testing.assert_allclose(got["losses"], want_losses, rtol=1e-5)
    _assert_params_close(got["params"], want, 0, 0.1 * LR, name)


def test_every_rank_ends_with_the_same_state(ranks):
    for name in CASES:
        got = [ranks["port"][r]["cases"][name] for r in range(WORLD)]
        assert len({g["digest"] for g in got}) == 1, name
        assert all(g["losses"] == got[0]["losses"] for g in got), name
        assert got[0]["digest"] == _digest(got[0]["params"])


def test_zero1_matches_replicated_moments_and_holds_a_data_slice(ranks):
    port = ranks["port"][0]
    _assert_params_close(port["cases"]["f32-2x2"]["params"],
                         port["cases"]["replicated-2x2"]["params"], 1e-6, 1e-7, "ZeRO-1")
    assert port["cases"]["f32-2x2"]["losses"] == port["cases"]["replicated-2x2"]["losses"]
    zero1, repl = port["moments"]["f32-2x2"], port["moments"]["replicated-2x2"]
    big = [k for k, s in repl.items() if np.prod(s) >= 1024]
    assert big and all(np.prod(zero1[k]) * 2 == np.prod(repl[k]) for k in big)


def test_unequal_label_counts_need_the_global_token_mean(ranks, single):
    """The mesh matches the single-process step on rows holding 8, 2, 1 and
    5 labels, one a rank (``freeze-unequal-4x1`` in
    test_mesh_steps_match_the_single_process_steps); a mean of the four
    ranks' means, the control, misses it by far."""
    trees = ranks["trees"]
    cfg = TConfig(name="t", **CFGS["micro"])
    opt = tts.make_optimizer(**OPT)
    state = tts.init_train_state(params_from_jax(trees["micro"]), opt)
    losses = []
    for batch in _batches(CASES["freeze-unequal-4x1"]):
        parts = [tts.value_and_grad(state.params, cfg, tts.batch_to(
            {k: v[i:i + 1] for k, v in batch.items()}, "cpu"), remat=True,
            freeze_encoder=True) for i in range(4)]
        losses.append(float(np.mean([float(p[0]) for p in parts])))
        grads = {k: sum(p[1][k] for p in parts) / 4 for k in parts[0][1]}
        tts.apply_updates(state.params, opt.update(grads, state.opt_state, state.params))
    want_losses, want = single["freeze-unequal-4x1"]
    assert np.abs(np.subtract(losses, want_losses)).max() > 100 * LOSS_ABS
    control = {k: v.detach().numpy() for k, v in named_leaves(state.params).items()}
    with pytest.raises(AssertionError):
        _assert_params_close(control, want, P_RTOL, P_ATOL, "mean of means")


def test_a_batch_the_data_axes_do_not_divide_raises(ranks):
    for r in range(WORLD):
        assert "3 rows does not split over the data axes' 4 ranks" in ranks["port"][r][
            "indivisible"]


@pytest.mark.parametrize("name", ["copy_to_model+reduce_from_model", "vocab_embed",
                                  "gather_vocab", "gather_cut_columns"])
def test_autograd_collectives_give_the_whole_gradient(ranks, name):
    for r in range(WORLD):
        assert ranks["port"][r]["functions"][name] < 1e-12, (r, ranks["port"][r]["functions"])


def test_distributed_nn_all_reduce_fails_the_gradient_check(ranks):
    """``torch.distributed.nn.functional.all_reduce`` after the row-split
    projection: its backward all-reduces again, n = 4 times the gradient."""
    for r in range(WORLD):
        assert ranks["port"][r]["functions"]["control"] > 1.0
