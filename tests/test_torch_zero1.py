"""ZeRO-1 and the multislice mesh's layout (``ttasr_torch.parallel.
sharding``: ``zero1_moment_spec``, ``shard_opt_state``, ``gather_leaf``'s
slices, ``mesh_coords``) and the memory reckoning
(``ttasr_torch.tools.memory_accounting``) against the JAX package, in
process: a mesh built by hand at each coordinate needs no process group.

- ``zero1_moment_spec`` against JAX's, called on the same per-layer shapes
  (JAX's rule on the port's leaves), leaf for leaf at large-v3's shapes on
  (4, 2) and on the multislice (2, 2, 2);
- ``shard_opt_state``'s slice at each coordinate against the JAX array's
  shard on the device there: on the port's leaves placed by JAX's rule,
  and, where the port's shapes are JAX's (the leaves outside the blocks),
  against JAX's own ``shard_opt_state``;
- each rank's moments of a leaf of at least 4096 elements and two
  dimensions (JAX's test's selection) at most 1/data of the leaf's;
- ``mesh_coords`` against JAX's device arrays;
- the memory reckoning against ``tools/memory_accounting.account()``.

The autograd collectives need ranks: ``tests/test_torch_mesh_train.py``
holds them, and the ``torch.distributed.nn`` control, on four.
"""

import os
import sys

import jax
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

from ttasr.models.whisper import model as jm
from ttasr.models.whisper.config import WhisperConfig as JConfig
from ttasr.parallel import sharding as jsh
from ttasr.parallel.distributed import create_multislice_mesh as j_multislice
from ttasr_torch.core.checkpoint import named_leaves
from ttasr_torch.models.whisper.config import PRESETS as T_PRESETS
from ttasr_torch.models.whisper.load import params_from_jax
from ttasr_torch.models.whisper.model import init_params
from ttasr_torch.parallel import sharding
from ttasr_torch.train import train_step as tts

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = {"4x2": {"data": 4, "model": 2},
          "2x2x2": {"dcn_data": 2, "data": 2, "model": 2}}
MICRO = dict(vocab_size=256, num_mel_bins=80, d_model=64, encoder_layers=2,
             encoder_heads=4, decoder_layers=2, decoder_heads=4, ffn_dim=128,
             max_source_positions=32)


def _jax_mesh(name):
    devs = jax.devices()[:8]
    if name == "4x2":
        return jsh.create_mesh(4, 2, devs)
    return j_multislice(model=2, devices=devs, force_slices=2)


def _port_mesh(name, rank=0):
    shape = SHAPES[name]
    return sharding.Mesh(shape=shape, coords=sharding.mesh_coords(shape, rank), groups={})


def _jax_spec(spec):
    return PartitionSpec(*spec)


def _pspec_tuple(spec, ndim):
    return tuple(spec) + (None,) * (ndim - len(spec))


@pytest.mark.parametrize("mesh", list(SHAPES))
def test_zero1_moment_spec_equals_jax_leaf_for_leaf_at_large_v3(mesh):
    jmesh, tmesh = _jax_mesh(mesh), _port_mesh(mesh)
    params = init_params(T_PRESETS["large-v3"], device="meta")
    got = sharding.moment_specs(params, tmesh)
    pspecs = sharding.leaf_specs(params, tmesh)
    n = 0
    for name, leaf in named_leaves(params).items():
        want = jsh.zero1_moment_spec(_jax_spec(pspecs[name]), tuple(leaf.shape), jmesh)
        assert got[name] == _pspec_tuple(want, leaf.dim()), name
        n += 1
    assert n == 1259
    # the big matrices take the data axes, as JAX's stacked leaves do
    entry = ("dcn_data", "data") if mesh == "2x2x2" else "data"
    assert got["encoder.blocks.0.wq"] == (entry, "model")
    assert got["decoder.blocks.31.wo"] == ("model", entry)
    assert got["decoder.embed"] == ("model", entry)
    assert got["decoder.blocks.0.bq"] == ("model",)  # a column-split bias: whole over data


def _moments(seed=0):
    """A whole opt state of the micro model with random moments."""
    params = params_from_jax(jax.tree.map(np.asarray, jm.init_params(
        JConfig(name="t", **MICRO), seed=0)))
    opt = tts.make_optimizer()
    state = opt.init(params)
    gen = torch.Generator().manual_seed(seed)
    for k in state.mu:
        state.mu[k].copy_(torch.randn(state.mu[k].shape, generator=gen))
        state.nu[k].copy_(torch.rand(state.nu[k].shape, generator=gen))
    return params, state


def _shard_on(x, device):
    return next(np.asarray(s.data) for s in x.addressable_shards if s.device == device)


@pytest.mark.parametrize("mesh", list(SHAPES))
def test_shard_opt_state_slices_equal_jax_shards(mesh):
    jmesh = _jax_mesh(mesh)
    params, state = _moments()
    specs = sharding.moment_specs(params, _port_mesh(mesh))
    placed = {k: jax.device_put(v.numpy(), NamedSharding(jmesh, _jax_spec(specs[k])))
              for k, v in state.mu.items()}
    # where the port's shapes are JAX's, JAX's own shard_opt_state places them
    jparams = jm.init_params(JConfig(name="t", **MICRO), seed=0)
    jstate = jsh.shard_opt_state(optax.adam(1e-3).init(jparams), jparams, jmesh)
    jmu = jstate[0].mu
    for side in ("encoder", "decoder"):
        for key in jparams[side]:
            if key != "blocks":
                assert jmu[side][key].sharding.spec == _jax_spec(specs[f"{side}.{key}"]), key
    for r, device in enumerate(jax.devices()[:8]):
        mine = sharding.shard_opt_state(state, params, _port_mesh(mesh, r))
        assert mine.count == state.count and mine.acc is None
        for k, v in mine.mu.items():
            np.testing.assert_array_equal(v.numpy(), _shard_on(placed[k], device), k)
        assert all(mine.nu[k].shape == v.shape for k, v in mine.mu.items())


@pytest.mark.parametrize("mesh", list(SHAPES))
def test_each_rank_holds_a_data_slice_of_every_big_moment(mesh):
    tmesh = _port_mesh(mesh)
    params = init_params(T_PRESETS["large-v3"], device="meta")
    specs = sharding.moment_specs(params, tmesh)
    dsize = 4
    big = {k: v for k, v in named_leaves(params).items()
           if v.dim() >= 2 and v.numel() >= 4096}
    assert len(big) == 517  # 6 a block of 32 encoder layers, 10 of 32 decoder, 5 outside
    for k, v in big.items():
        part = int(np.prod(sharding.slice_shape(v.shape, specs[k], tmesh)))
        assert part * dsize <= v.numel(), (k, specs[k])


@pytest.mark.parametrize("mesh", list(SHAPES))
def test_mesh_coords_are_jax_device_order(mesh):
    jmesh = _jax_mesh(mesh)
    for r, device in enumerate(jax.devices()[:8]):
        want = tuple(int(i) for i in np.argwhere(jmesh.devices == device)[0])
        assert tuple(sharding.mesh_coords(SHAPES[mesh], r).values()) == want
    assert tuple(SHAPES[mesh]) == tuple(jmesh.axis_names)


@pytest.mark.parametrize("mesh", [(4, 2, 1), (2, 2, 2), (8, 1, 1), (1, 8, 1)],
                         ids=lambda m: f"data{m[0]}-model{m[1]}-dcn{m[2]}")
def test_memory_reckoning_matches_the_jax_tool(mesh):
    sys.path.insert(0, os.path.join(REPO_ROOT, "tools"))
    from memory_accounting import account as j_account

    from ttasr_torch.tools.memory_accounting import account

    data, model, dcn = mesh  # data: per slice
    want = j_account("large-v3", data=data, model_axis=model, batch=4, dcn=dcn,
                     devices=jax.devices()[:dcn * data * model])
    got = account("large-v3", data=data, model_axis=model, batch=4, dcn=dcn)
    assert got["mesh"] == dict(want["mesh"])
    for key in ("params_f32", "grads_f32", "adamw_moments_zero1",
                "adamw_moments_if_replicated", "activations_est"):
        w, g = want["per_chip_gb"][key], got["per_chip_gb"][key]
        assert abs(g - w) <= 5e-3 * w, (key, g, w)


def test_memory_reckoning_prints_against_the_h100(capsys):
    from ttasr_torch.tools.memory_accounting import main

    stats = main(["--model", "large-v3", "--data", "4", "--model-axis", "2"])
    out = capsys.readouterr().out
    assert "80 GB" in out and "adamw_moments_zero1" in out
    gb = stats["per_chip_gb"]
    assert gb["adamw_moments_if_replicated"] > 2.5 * gb["adamw_moments_zero1"]
    assert gb["params_f32"] > 2.0
