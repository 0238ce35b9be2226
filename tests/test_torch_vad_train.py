"""The port's VAD model forward and trainer against the JAX package's on the
CPU (``ttasr_torch/audio/vad_model.py``, ``ttasr_torch/tools/train_vad.py``
against ``ttasr/audio/vad_model.py`` and ``tools/train_vad.py``).

- ``log_mel_frames`` against JAX's within 1e-5 of the largest magnitude
  where the mel power is well above the 1e-8 floor (1e-2 absolute near it),
  and ``forward`` against JAX's ``_forward`` and the numpy inference within
  1e-5 on the same log-mels (one clip and a batch, the shipped weights and
  fresh ones);
- the loss and grads of one batch against ``jax.value_and_grad`` of the JAX
  tool's BCE (loss within 1e-6 relative, grads within 1e-5 of each
  leaf's largest);
- five Adam steps against ``optax.adam`` on the same grads (within 1e-6 of
  each leaf's largest), tiny grads among them;
- ``evaluate``'s numbers after a short run against the JAX ``evaluate``'s
  (AUC within 5e-3, rates within 1e-2: see ``EVAL_AUC_ABS``);
- ``init_vad_params`` is the original's, and the CLI raises without CUDA
  unless ``--device cpu``.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))

import train_vad as j_tv  # noqa: E402
from ttasr.audio import vad_model as j_vm  # noqa: E402
from ttasr_torch.audio import vad_model as t_vm  # noqa: E402
from ttasr_torch.tools import train_vad as t_tv  # noqa: E402

FWD_ABS = 1e-5
GRAD_REL = 1e-5
ADAM_REL = 1e-6
LOG_FLOOR_ABS = 1e-2
# evaluate's AUC and rates: on tonal negatives (hum, tones, chords) most mel
# bins sit at the 1e-8 floor with a per-bin spread of ~1e-5, so the
# per-utterance normalisation lifts the FFTs' last-bit differences to O(1)
# inputs; the JAX forward and the reference's own numpy inference differ
# there by up to 0.12 in probability, and a few of 1860 frames cross 0.5
EVAL_AUC_ABS = 5e-3
EVAL_RATE_ABS = 1e-2
N_FRAMES = int(16000 * 3.0) // t_vm.WINDOW


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(seed=0, batch=4):
    return t_tv.make_batch(np.random.default_rng(seed), batch, 3.0)


def _hold_log_mel(got, want):
    """Within 1e-5 of the largest magnitude where the mel power is 1e4 times
    the 1e-8 floor or more; within LOG_FLOOR_ABS below it, where a power
    difference of 1e-11 moves the log by 1e-3 (numpy's and JAX's own
    log-mels differ by 1.4e-3 there)."""
    loud = want > np.log(1e-4)
    assert loud.mean() > 0.25
    assert np.abs(got - want)[loud].max() <= FWD_ABS * np.abs(want).max()
    assert np.abs(got - want).max() <= LOG_FLOOR_ABS


def _params(kind):
    return t_vm._load_weights() if kind == "shipped" else t_vm.init_vad_params(3)


def test_init_params_are_the_originals():
    for seed in (0, 7):
        want, got = j_vm.init_vad_params(seed), t_vm.init_vad_params(seed)
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("kind", ["shipped", "init"])
def test_forward_and_log_mel_match_jax(kind):
    params = _params(kind)
    fb = t_vm.mel_filterbank()
    np.testing.assert_array_equal(fb, j_vm.mel_filterbank())
    audio, _ = _batch(1, 3)
    # one clip with a trailing partial frame, then the batch
    clip = np.concatenate([audio[0], audio[1][:700]])
    want_mel = np.array(j_vm.log_mel_frames(jnp.asarray(clip), fb))
    got_mel = t_vm.log_mel_frames(torch.from_numpy(clip), fb)
    assert got_mel.shape == want_mel.shape == (len(clip) // t_vm.WINDOW, t_vm.N_MELS)
    _hold_log_mel(got_mel.numpy(), want_mel)
    want = np.asarray(j_vm._forward({k: jnp.asarray(v) for k, v in params.items()},
                                    jnp.asarray(want_mel)))
    tparams = t_tv.to_device(params, "cpu")
    got = t_vm.forward(tparams, torch.from_numpy(want_mel)).numpy()
    assert got.shape == want.shape and np.abs(got - want).max() <= FWD_ABS
    np.testing.assert_allclose(got, t_vm._forward_np(params, want_mel), atol=FWD_ABS)
    # batched: each utterance normalised on its own, as jax.vmap(_forward)
    mels = np.stack([np.array(j_vm.log_mel_frames(jnp.asarray(a), fb))[:N_FRAMES]
                     for a in audio])
    _hold_log_mel(t_tv.batch_mels(audio, fb, N_FRAMES, "cpu").numpy(), mels)
    want_b = np.stack([np.asarray(j_vm._forward(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(m))) for m in mels])
    got_b = t_vm.forward(tparams, torch.from_numpy(mels)).numpy()
    assert np.abs(got_b - want_b).max() <= FWD_ABS


def _jax_loss(params, mel_batch, labels):
    """The JAX tool's step loss (``tools/train_vad.py`` main's ``loss_fn``)."""
    probs = jax.vmap(lambda m: j_vm._forward(params, m))(mel_batch)
    eps = 1e-6
    bce = -(labels * jnp.log(probs + eps) + (1 - labels) * jnp.log(1 - probs + eps))
    return jnp.mean(bce)


def test_loss_and_grads_match_jax():
    audio, labels = _batch(2)
    fb = t_vm.mel_filterbank()
    mels = t_tv.batch_mels(audio, fb, N_FRAMES, "cpu")
    params = t_vm.init_vad_params(0)
    want_loss, want_grads = jax.value_and_grad(_jax_loss)(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(mels.numpy()),
        jnp.asarray(labels[:, :N_FRAMES]))
    loss, grads = t_tv.value_and_grad(t_tv.to_device(params, "cpu"), mels,
                                      torch.from_numpy(labels[:, :N_FRAMES]))
    assert float(loss) == pytest.approx(float(want_loss), rel=1e-6)
    for k, w in want_grads.items():
        w = np.asarray(w)
        assert np.abs(grads[k].numpy() - w).max() <= GRAD_REL * np.abs(w).max(), k


def test_adam_matches_optax():
    rng = np.random.default_rng(4)
    params = t_vm.init_vad_params(1)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = t_tv.to_device(params, "cpu")
    opt, adam = optax.adam(3e-3), t_tv.Adam(3e-3)
    jstate, tstate = opt.init(jp), adam.init(tp)
    for step in range(5):
        grads = {}
        for k, v in params.items():
            g = rng.standard_normal(v.shape).astype(np.float32) * 10.0 ** rng.integers(-9, 0)
            g[..., :1] *= 1e-6  # grads beside eps
            grads[k] = g
        updates, jstate = opt.update({k: jnp.asarray(g) for k, g in grads.items()}, jstate)
        jp = optax.apply_updates(jp, updates)
        tupd = adam.update({k: torch.from_numpy(g) for k, g in grads.items()}, tstate)
        with torch.no_grad():
            for k, u in tupd.items():
                tp[k] += u
        for k in params:
            want = np.asarray(jp[k])
            assert np.abs(tp[k].numpy() - want).max() <= ADAM_REL * np.abs(want).max(), (step, k)
    assert tstate["count"] == int(jstate[0].count) == 5


def test_short_run_and_evaluate_match_jax():
    """Three steps of the port's trainer (the JAX tool's init, batches from
    its seed), then both packages' ``evaluate`` on the trained weights."""
    params, losses = t_tv.train(3, 4, 3.0, 3e-3, 10, "cpu")
    assert len(losses) == 3 and all(np.isfinite(losses))
    fb = t_vm.mel_filterbank()
    got = t_tv.evaluate(params, fb, seed=5, n_clips=6, device="cpu")
    want = j_tv.evaluate({k: jnp.asarray(v.numpy()) for k, v in params.items()}, fb,
                         seed=5, n_clips=6)
    assert got.keys() == want.keys()
    for k, w in want.items():
        assert abs(got[k] - w) <= (EVAL_AUC_ABS if k == "frame_auc" else EVAL_RATE_ABS), k


def test_cli_needs_cuda_unless_cpu(tmp_path):
    code = ("import torch; torch.cuda.is_available = lambda: False; import sys; "
            "from ttasr_torch.tools import train_vad; sys.argv[0] = 'train_vad'; "
            "train_vad.main(sys.argv[1:])")
    out = str(tmp_path / "vad.npz")
    proc = subprocess.run([sys.executable, "-c", code, "--steps", "1", "--out", out],
                          capture_output=True, text=True, cwd=REPO, timeout=120)
    assert proc.returncode != 0 and "CUDA is not available" in proc.stderr
    assert not os.path.exists(out)
    np.savez(out, **t_vm._load_weights())
    proc = subprocess.run([sys.executable, "-c", code, "--eval-only", "--out", out,
                           "--device", "cpu"], capture_output=True, text=True, cwd=REPO,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert '"frame_auc"' in proc.stdout
