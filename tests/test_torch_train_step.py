"""The port's training step (``ttasr_torch/train/train_step.py``,
``spec_augment.py``, ``model.forward`` and ``remat``) against the JAX
package's on the CPU, on ``micro64-test`` weights moved by
``params_from_jax`` and batches of ``sample_corpus`` collated by the JAX
package.

Tolerances, each from f32 (or bf16) arithmetic in two frameworks:

- loss: 1e-5 relative (f32); gradients: each leaf within 1e-4 of the
  leaf's largest |g| (f32), 3e-2 in bf16 (about eight bf16 steps of the
  leaf's largest; measured 1.1e-2);
- the optimizer on the same gradients: each update leaf within 1e-6 of
  its largest |u| (measured 5e-7);
- params after a full step: within 0.1 lr.  Adam's first update is
  lr * g / (|g| + eps), so where |g| is near eps a gradient difference
  that is small against the leaf's largest |g| still moves the update by
  a share of lr (measured 0.031 lr); the optimizer test above is the
  tight one.

Each semantic where the plain PyTorch idiom differs from optax has a test
that the idiom fails: the schedule's first update, optax's clip formula,
the all-pad batch, zero gradients under ``freeze_encoder`` with weight
decay, and ``optax.MultiSteps``' accumulation.  The mixed-precision test
also holds the LayerNorm's scale and bias gradients, which a bf16
``layer_norm`` backward sums poorly over the encoder's 1500 rows.
"""

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from ttasr.models.whisper import model as jm
from ttasr.models.whisper.config import PRESETS as J_PRESETS
from ttasr.text.tokenizer import build_byte_fallback_tokenizer
from ttasr.train import spec_augment as jsa
from ttasr.train import train_step as jts
from ttasr.train.data import batch_iterator, load_tsv_corpus
from ttasr_torch.core.checkpoint import map_leaves, named_leaves
from ttasr_torch.models.whisper import model as tm
from ttasr_torch.models.whisper.config import PRESETS as T_PRESETS
from ttasr_torch.models.whisper.load import params_from_jax
from ttasr_torch.train import spec_augment as tsa
from ttasr_torch.train import train_step as tts

NAME = "micro64-test"
JCFG, TCFG = J_PRESETS[NAME], T_PRESETS[NAME]
TOK = build_byte_fallback_tokenizer()
CORPUS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "sample_corpus")
LOSS_REL = 1e-5
GRAD_REL = 1e-4
GRAD_REL_BF16 = 3e-2
UPDATE_REL = 1e-6
LR = 1e-3
STEP_ABS = 0.1 * LR
FRAMES = 1000  # 500 encoder positions


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The micro model's eager ops run faster on one thread, and the suite
    runs several workers to a machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _jax_params():
    return jm.init_params(JCFG, seed=0, dtype=jnp.float32)


def _fresh_jax():
    """A copy of the JAX params (the JAX step donates its state)."""
    return jax.tree.map(jnp.array, _jax_params())


def _port_params():
    return params_from_jax(jax.tree.map(np.asarray, _jax_params()), dtype=torch.float32)


@functools.lru_cache(maxsize=None)
def _batches():
    """Two batches of two clips, labels padded to 32, the mel cut to its
    first FRAMES frames (both encoders slice their positions to the mel's
    length), which keeps the file inside its time budget."""
    examples = load_tsv_corpus(CORPUS, "train_ds_01", "train")
    it = batch_iterator(examples, TOK, batch_size=2, n_mels=JCFG.num_mel_bins, seed=0,
                        label_pad_to=32)
    return tuple(dict(b, mel=b["mel"][..., :FRAMES],
                      num_frames=np.minimum(b["num_frames"], FRAMES))
                 for b in (next(it), next(it)))


def to_jax_layout(tree):
    """The port's tree (per-layer block dicts) as numpy in the JAX
    package's layout (each block leaf stacked over layers): the inverse of
    ``params_from_jax``."""
    out = {}
    for side, sub in tree.items():
        out[side] = {}
        for key, value in sub.items():
            if key == "blocks":
                out[side]["blocks"] = {
                    k: np.stack([blk[k].detach().float().numpy() for blk in value])
                    for k in value[0]}
            else:
                out[side][key] = value.detach().float().numpy()
    return out


def _tree_of(flat):
    """A flat name -> tensor dict (grads, updates) as the params' tree."""
    return map_leaves(lambda path, _: flat[path], _port_params())


def _leaf_gaps(got_flat, want_tree):
    """{leaf path: max|got - want| / max|want|} in the JAX layout."""
    got = dict(jax.tree_util.tree_flatten_with_path(to_jax_layout(_tree_of(got_flat)))[0])
    want = dict(jax.tree_util.tree_flatten_with_path(jax.tree.map(np.asarray, want_tree))[0])
    assert got.keys() == want.keys()
    return {jax.tree_util.keystr(k): float(np.abs(got[k] - want[k]).max()
                                           / max(np.abs(want[k]).max(), 1e-30))
            for k in want}


def _assert_steps_agree(label, jstate, tstate, jloss, tloss):
    assert abs(float(tloss) - float(jloss)) <= LOSS_REL * abs(float(jloss)), label
    got = to_jax_layout(tstate.params)
    want = jax.tree.map(np.asarray, jstate.params)
    gaps = jax.tree.map(lambda g, w: float(np.abs(g - w).max()), got, want)
    worst = max(jax.tree.leaves(gaps))
    assert worst <= STEP_ABS, (label, worst)


# ---------------------------------------------------------------------------
# The model: forward and remat
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_loss_grad(compute_dtype=None, freeze_encoder=False):
    """``jax.value_and_grad(loss_fn)`` jitted, batch as an argument: one
    compile serves every batch of the file."""
    return jax.jit(jax.value_and_grad(
        lambda p, b: jts.loss_fn(p, JCFG, b, compute_dtype=compute_dtype,
                                 freeze_encoder=freeze_encoder)))


@functools.lru_cache(maxsize=None)
def _jax_value_and_grad(compute_dtype=None):
    loss, grads = _jax_loss_grad(compute_dtype)(_jax_params(), _batches()[0])
    return float(loss), jax.tree.map(np.asarray, grads)


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_loss_and_grads_match_jax(remat):
    b1, _ = _batches()
    want_loss, want_grads = _jax_value_and_grad()
    loss, grads = tts.value_and_grad(_port_params(), TCFG, tts.batch_to(b1, "cpu"),
                                     remat=remat)
    assert abs(float(loss) - want_loss) <= LOSS_REL * abs(want_loss)
    gaps = _leaf_gaps(grads, want_grads)
    assert max(gaps.values()) <= GRAD_REL, sorted(gaps.items(), key=lambda kv: -kv[1])[:3]
    if remat:  # the same arithmetic, recomputed: the same bits as without remat
        plain_loss, plain = tts.value_and_grad(_port_params(), TCFG,
                                               tts.batch_to(b1, "cpu"))
        assert torch.equal(loss, plain_loss)
        assert all(torch.equal(grads[k], plain[k]) for k in plain)


def test_forward_matches_jax():
    b1, _ = _batches()
    want = np.asarray(jax.jit(lambda p: jm.forward(p, JCFG, b1["mel"],
                                                   b1["decoder_input_ids"]))(_jax_params()))
    batch = tts.batch_to(b1, "cpu")
    got = tm.forward(_port_params(), TCFG, batch["mel"], batch["decoder_input_ids"])
    assert got.shape == want.shape == (2, 32, TCFG.vocab_size)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4 * np.abs(want).max())
    remat = tm.forward(_port_params(), TCFG, batch["mel"], batch["decoder_input_ids"],
                       remat=True)
    assert torch.equal(remat, got)


# ---------------------------------------------------------------------------
# The loss
# ---------------------------------------------------------------------------

def test_cross_entropy_matches_jax_and_an_all_pad_batch_gives_zero():
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((2, 5, 11)).astype(np.float32) * 3
    targets = rng.integers(0, 11, (2, 5)).astype(np.int32)
    targets[0, 3:] = tts.LABEL_PAD
    got = tts.cross_entropy_loss(torch.from_numpy(logits), torch.from_numpy(targets))
    want = float(jts.cross_entropy_loss(logits, targets))
    assert float(got) == pytest.approx(want, rel=LOSS_REL)
    pad = np.full((2, 5), tts.LABEL_PAD, np.int32)
    assert float(jts.cross_entropy_loss(logits, pad)) == 0.0
    assert float(tts.cross_entropy_loss(torch.from_numpy(logits), torch.from_numpy(pad))) == 0.0
    # the plain idiom's mean over no token is NaN
    idiom = F.cross_entropy(torch.from_numpy(logits).flatten(0, 1),
                            torch.from_numpy(pad).long().flatten(), ignore_index=-100)
    assert torch.isnan(idiom)


# ---------------------------------------------------------------------------
# The optimizer
# ---------------------------------------------------------------------------

def _optax_schedule(lr, warmup, total):
    return optax.join_schedules(
        [optax.linear_schedule(0.0, lr, warmup),
         optax.linear_schedule(lr, 0.0, max(total - warmup, 1))], [warmup])


@pytest.mark.parametrize("lr,warmup,total", [(1e-3, 3, 10), (1e-4, 0, 20),
                                             (3e-3, 5, 5), (1e-5, 500, 2000)])
def test_schedule_matches_optax(lr, warmup, total):
    """The learning rate of updates 0..N: optax's in float32, the first one
    ``schedule(0)`` (0 under warm-up; an off-by-one ``LambdaLR`` gives the
    second value there)."""
    opt = tts.make_optimizer(learning_rate=lr, warmup_steps=warmup, total_steps=total)
    sched = _optax_schedule(lr, warmup, total)
    for count in range(total + 3):
        assert np.float32(opt.schedule(count)) == np.float32(sched(count)), count
    if warmup:
        assert opt.schedule(0) == 0.0 < opt.schedule(1)


def _scaled_grads(scale):
    _, grads = _jax_value_and_grad()
    return jax.tree.map(lambda g: (g * scale).astype(np.float32), grads)


@pytest.mark.parametrize("max_norm", [5e-4, 1.0], ids=["clipped", "unclipped"])
def test_clip_is_optax_formula(max_norm):
    """Grads scaled to a global norm of ~1e-3: clipped to ``max_norm`` by
    ``g / norm * max_norm`` (``clip_grad_norm_``'s ``norm + 1e-6`` is
    1e-3 relative off here), left alone below it."""
    grads = _scaled_grads(1.5e-4)
    norm = float(optax.global_norm(grads))
    assert 5e-4 < norm < 1.0
    want, _ = optax.clip_by_global_norm(max_norm).update(grads, optax.EmptyState())
    flat = named_leaves(params_from_jax(grads))
    opt = tts.make_optimizer(max_grad_norm=max_norm)
    g = list(flat.values())
    opt.clip(g)
    gaps = _leaf_gaps(dict(zip(flat, g)), want)
    assert max(gaps.values()) <= UPDATE_REL
    if max_norm > norm:
        assert all(torch.equal(a, b) for a, b in
                   zip(g, named_leaves(params_from_jax(grads)).values()))
    else:
        idiom = list(named_leaves(params_from_jax(grads)).values())
        torch.nn.utils.clip_grad_norm_(idiom, max_norm)
        assert max(_leaf_gaps(dict(zip(flat, idiom)), want).values()) > 1e-4


@pytest.mark.parametrize("wd", [0.0, 0.01], ids=["no_decay", "decay"])
def test_adamw_updates_match_optax(wd):
    """The same (JAX) gradients through both optimizers, three updates with
    a one-step warm-up: the updates within 1e-6 of each leaf's largest,
    the first one zero in both."""
    _, grads = _jax_value_and_grad()
    jopt = jts.make_optimizer(learning_rate=LR, warmup_steps=1, total_steps=10,
                              weight_decay=wd)
    topt = tts.make_optimizer(learning_rate=LR, warmup_steps=1, total_steps=10,
                              weight_decay=wd)
    jparams, tparams = _fresh_jax(), _port_params()
    jstate, tstate = jopt.init(jparams), topt.init(tparams)
    jupdate = jax.jit(jopt.update)
    for k in range(3):
        jup, jstate = jupdate(grads, jstate, jparams)
        tup = topt.update(named_leaves(params_from_jax(grads)), tstate, tparams)
        if k == 0:
            assert all(float(u.abs().max()) == 0.0 for u in tup.values())
        else:
            gaps = _leaf_gaps(tup, jup)
            assert max(gaps.values()) <= UPDATE_REL, (k, max(gaps.values()))
        jparams = optax.apply_updates(jparams, jup)
        tts.apply_updates(tparams, tup)
    assert tstate.count == 3


# ---------------------------------------------------------------------------
# The step
# ---------------------------------------------------------------------------

class _JaxSteps:
    """The JAX package's train step as its two parts: ``jax.value_and_grad``
    of ``loss_fn`` and ``optimizer.update`` + ``optax.apply_updates``
    (``make_train_step`` composes them; jitted apart, the loss's compile is
    shared by the tests of this file)."""

    def __init__(self, optimizer, **loss_kw):
        self.loss_grad = _jax_loss_grad(**loss_kw)
        self.update = jax.jit(optimizer.update)
        self.params = _fresh_jax()
        self.opt_state = optimizer.init(self.params)
        self.step = 0

    def __call__(self, batch):
        loss, grads = self.loss_grad(self.params, batch)
        updates, self.opt_state = self.update(grads, self.opt_state, self.params)
        self.params = optax.apply_updates(self.params, updates)
        self.step += 1
        return self, loss


def _run_both(jopt, topt, batches, jkw=None, tkw=None):
    jsteps = _JaxSteps(jopt, **(jkw or {}))
    tstate = tts.init_train_state(_port_params(), topt)
    tstep = tts.make_train_step(TCFG, topt, **(tkw or {}))
    for batch in batches:
        jstate, jloss = jsteps(batch)
        tstate, tloss = tstep(tstate, batch)
        yield jstate, tstate, jloss, tloss


def test_one_and_two_f32_steps_match_jax():
    opt = dict(learning_rate=LR, warmup_steps=0, total_steps=10, weight_decay=0.01)
    runs = _run_both(jts.make_optimizer(**opt), tts.make_optimizer(**opt), _batches())
    for k, (jstate, tstate, jloss, tloss) in enumerate(runs, 1):
        _assert_steps_agree(f"step {k}", jstate, tstate, jloss, tloss)
        assert tstate.step == jstate.step == k
        assert tstate.opt_state.count == k


def test_bf16_step_matches_jax():
    """Mixed precision: a bf16 copy of every leaf but the stem convs' for
    the forward, f32 master params and grads; loss and grads against the
    JAX package's bf16 step."""
    b1, _ = _batches()
    cast = named_leaves(tts.cast_params(_port_params(), torch.bfloat16))
    assert {k for k, v in cast.items() if v.dtype == torch.float32} == {
        "encoder.conv1_w", "encoder.conv1_b", "encoder.conv2_w", "encoder.conv2_b"}
    want_loss, want_grads = _jax_value_and_grad(jnp.bfloat16)
    loss, grads = tts.value_and_grad(_port_params(), TCFG, tts.batch_to(b1, "cpu"),
                                     compute_dtype=torch.bfloat16)
    assert abs(float(loss) - want_loss) <= 1e-3 * abs(want_loss)
    assert all(g.dtype == torch.float32 for g in grads.values())
    gaps = _leaf_gaps(grads, want_grads)
    assert max(gaps.values()) <= GRAD_REL_BF16, sorted(gaps.items(), key=lambda kv: -kv[1])[:3]

    opt = dict(learning_rate=LR, warmup_steps=0, total_steps=10)
    runs = _run_both(jts.make_optimizer(**opt), tts.make_optimizer(**opt), _batches()[:1],
                     dict(compute_dtype=jnp.bfloat16), dict(compute_dtype=torch.bfloat16))
    jstate, tstate, jloss, tloss = next(runs)
    assert float(tloss) == float(loss) and float(jloss) == want_loss
    assert all(v.dtype == torch.float32 for v in named_leaves(tstate.params).values())
    # where the grads agree to 1e-2 of their leaf's largest, the update's
    # sign does too: Adam's first step moves those entries by -lr sign(g)
    got, want = to_jax_layout(tstate.params), jax.tree.map(np.asarray, jstate.params)
    start = to_jax_layout(_port_params())
    for g, w, b, jg in zip(jax.tree.leaves(got), jax.tree.leaves(want),
                           jax.tree.leaves(start), jax.tree.leaves(want_grads)):
        firm = np.abs(jg) >= 0.1 * np.abs(jg).max()
        np.testing.assert_allclose((g - b)[firm], (w - b)[firm], rtol=0, atol=STEP_ABS)


def test_freeze_encoder_matches_jax():
    """The encoder's leaves get zero grads, not none: with weight decay
    AdamW decays them as optax does (``torch.optim`` skips a parameter
    whose grad is None), without it they stay as they were."""
    b1, _ = _batches()
    _, grads = tts.value_and_grad(_port_params(), TCFG, tts.batch_to(b1, "cpu"),
                                  freeze_encoder=True)
    assert all(float(g.abs().max()) == 0.0 for k, g in grads.items()
               if k.startswith("encoder."))
    opt = dict(learning_rate=LR, warmup_steps=0, total_steps=10, weight_decay=0.01)
    runs = _run_both(jts.make_optimizer(**opt), tts.make_optimizer(**opt), _batches()[:1],
                     dict(freeze_encoder=True), dict(freeze_encoder=True))
    jstate, tstate, jloss, tloss = next(runs)
    _assert_steps_agree("freeze_encoder", jstate, tstate, jloss, tloss)
    before = to_jax_layout(_port_params())["encoder"]
    got = to_jax_layout(tstate.params)["encoder"]
    want = jax.tree.map(np.asarray, jstate.params["encoder"])
    for g, w, b in zip(jax.tree.leaves(got), jax.tree.leaves(want), jax.tree.leaves(before)):
        assert np.array_equal(g == b, b == 0)  # decayed where nonzero
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-7)
    no_decay = tts.init_train_state(_port_params(), tts.make_optimizer(
        learning_rate=LR, warmup_steps=0, total_steps=10))
    no_decay, _ = tts.make_train_step(TCFG, tts.make_optimizer(
        learning_rate=LR, warmup_steps=0, total_steps=10), freeze_encoder=True)(no_decay, b1)
    for g, b in zip(jax.tree.leaves(to_jax_layout(no_decay.params)["encoder"]),
                    jax.tree.leaves(before)):
        assert np.array_equal(g, b)


def test_gradient_accumulation_matches_multisteps():
    """Two micro-batches a step (``optax.MultiSteps``): the first leaves the
    params alone and holds the grads' running mean; the second applies one
    clipped AdamW update of the mean; the schedule counts updates and
    ``step`` micro-steps."""
    opt = dict(learning_rate=LR, warmup_steps=0, total_steps=10)
    jopt = optax.MultiSteps(jts.make_optimizer(**opt), every_k_schedule=2)
    topt = dataclasses.replace(tts.make_optimizer(**opt), every_k=2)
    b1, b2 = _batches()
    runs = _run_both(jopt, topt, (b1, b2))
    for micro, (jstate, tstate, jloss, tloss) in enumerate(runs, 1):
        ts, js = tstate.opt_state, jstate.opt_state
        assert (tstate.step, ts.mini_step, ts.count, ts.count) == (
            jstate.step, int(js.mini_step), int(js.gradient_step),
            int(js.inner_opt_state[1][0].count))
        assert ts.count == micro - 1
        if micro == 1:
            assert all(torch.equal(a, b) for a, b in zip(
                named_leaves(tstate.params).values(),
                named_leaves(_port_params()).values()))
            gaps = _leaf_gaps(ts.acc, js.acc_grads)
            assert max(gaps.values()) <= GRAD_REL
        _assert_steps_agree(f"micro-step {micro}", jstate, tstate, jloss, tloss)


def test_a_mesh_raises():
    opt = tts.make_optimizer()
    with pytest.raises(NotImplementedError, match="A12"):
        tts.make_train_step(TCFG, opt, mesh=object())
    with pytest.raises(NotImplementedError, match="A12"):
        tts.init_train_state(_port_params(), opt, mesh=object())


# ---------------------------------------------------------------------------
# SpecAugment
# ---------------------------------------------------------------------------

SPEC = tsa.SpecAugmentConfig(mask_time_prob=0.2, mask_time_length=10,
                             mask_time_min_masks=2, mask_feature_prob=0.1,
                             mask_feature_length=8, mask_feature_min_masks=1)


def _jax_uniforms(rng, batch, axis_size, prob, span, min_masks):
    """The uniforms ``ttasr.train.spec_augment._axis_masks`` draws."""
    rng_n, rng_s = jax.random.split(rng)
    n_spans = tsa.max_spans(axis_size, prob, span, min_masks)
    return (np.array(jax.random.uniform(rng_n, (batch,))),
            np.array(jax.random.uniform(rng_s, (batch, n_spans))))


def test_spec_augment_applies_the_same_spans_bit_for_bit():
    """JAX's draws fed to the port's span arithmetic and mask: the same
    output as ``ttasr.train.spec_augment.spec_augment``, bit for bit."""
    rng = jax.random.PRNGKey(3)
    mel = np.random.default_rng(4).standard_normal((3, 80, 300)).astype(np.float32)
    num_frames = np.array([200, 300, 37], np.int32)
    want = np.asarray(jsa.spec_augment(rng, mel, num_frames,
                                       jsa.SpecAugmentConfig(**dataclasses.asdict(SPEC))))
    rng_t, rng_f = jax.random.split(rng)
    got = torch.from_numpy(mel)
    for key, axis, size, valid, prob, span, mins in (
            (rng_t, 2, 300, num_frames, SPEC.mask_time_prob, SPEC.mask_time_length,
             SPEC.mask_time_min_masks),
            (rng_f, 1, 80, np.full(3, 80, np.int32), SPEC.mask_feature_prob,
             SPEC.mask_feature_length, SPEC.mask_feature_min_masks)):
        u, s = _jax_uniforms(key, 3, size, prob, span, mins)
        n, starts = tsa._spans(torch.from_numpy(u), torch.from_numpy(s),
                               torch.from_numpy(valid), prob=prob, span=span,
                               min_masks=mins)
        mask = tsa._span_mask(n, starts, size, span)
        got = got.masked_fill(mask[:, None, :] if axis == 2 else mask[:, :, None], 0.0)
    assert (want == 0).any()
    assert np.array_equal(got.numpy(), want)


def _spans_of(gen, valid, prob, span, mins, size=300):
    u = torch.rand((len(valid),), generator=gen)
    s = torch.rand((len(valid), tsa.max_spans(size, prob, span, mins)), generator=gen)
    return tsa._spans(u, s, torch.tensor(valid), prob=prob, span=span, min_masks=mins)


def test_spec_augment_sampling_properties():
    """Spans stay inside ``num_frames``, at least ``min_masks`` of them, each
    ``span`` frames long; a prob of 0 disables the axis."""
    gen = torch.Generator().manual_seed(0)
    valid = [200, 300, 37, 15]
    for _ in range(20):
        n, starts = _spans_of(gen, valid, 0.2, 10, 2)
        for row, v in enumerate(valid):
            assert int(n[row]) >= min(2, v // 10)
            assert int(n[row]) <= v // 10
            active = starts[row, : int(n[row])]
            assert (active >= 0).all() and (active + 10 <= v).all()
            mask = tsa._span_mask(n[row:row + 1], starts[row:row + 1], 300, 10)[0]
            assert not mask[v:].any()
            assert int(mask.sum()) >= min(10, 10 * int(n[row]))
    mel = torch.ones((2, 80, 300))
    off = tsa.SpecAugmentConfig(mask_time_prob=0.0, mask_time_min_masks=2,
                                mask_feature_prob=0.0, mask_feature_min_masks=3)
    assert torch.equal(tsa.spec_augment(gen, mel, torch.tensor([300, 100]), off), mel)


def test_spec_augment_masks_are_keyed_by_seed_and_step():
    """A resumed run draws the masks the uninterrupted run drew: the
    generator comes from (seed, step)."""
    mel = torch.ones((2, 80, 3000))
    frames = torch.tensor([3000, 1700])

    def masks(seed, step):
        return tsa.spec_augment(tts.step_generator(seed, step, "cpu"), mel, frames, SPEC)

    assert torch.equal(masks(42, 7), masks(42, 7))
    assert not torch.equal(masks(42, 7), masks(42, 8))
    assert not torch.equal(masks(42, 7), masks(43, 7))
    assert (masks(42, 7) == 0).any()
