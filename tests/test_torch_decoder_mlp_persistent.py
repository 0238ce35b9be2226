"""The persistent MLP kernel of B4 and B14 (``ttasr_torch/csrc/decoder_mlp.cu``)
and B1's one-wave layout (``skinny_gemm.cuh``'s teams), on the CPU.

The kernels run only on the card.  These tests hold what decides their
work and their bits:

- :func:`mlp_schedule`, the host's dealing of (column tile, K range) units
  of wo_c, W1 and W2 to the kernel's blocks, one or two per SM: every unit
  exactly once, one finisher per tile, each block's slab bytes within one
  unit of the mean, its shared memory within the card's 232,448 bytes, at
  large-v3 (D 1280, F 5120) and at the tensor-parallel shards' widths (F
  2560 and 1280); :func:`mlp_plan` puts two blocks on each SM where their
  shared memory fits;
- a torch emulation of the kernel's work: units run in a random order that
  respects only the phases' waits (W1 after every tile of x', W2 after the
  tiles of h in its K range), each unit's sums in the skinny GEMM's order,
  a tile finished by the holder of its range 0, which adds the ranges in
  rank order and applies the phase's epilogue.  It equals the composition of
  ``_split_k_sum`` (``tests/test_torch_decode_split_order.py``) bit for
  bit, and holds against the Pallas B4 and B14 in interpret mode and the
  port's plain versions with that file's tolerance, at K that splits 3 does
  not divide and at splits 1, 3 and 8;
- the skinny GEMM's shape rules at large-v3: B1's (1280, 3840) takes two
  teams per block, one wave of 120 blocks, in the order of its two ranges;
  every shape keeps its K ranges, and the other shapes the skinny GEMM
  serves keep their clusters.

About 9 s on one worker.
"""

from collections import Counter

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_decode_split_order import (
    K_GROUPS,
    WARPS,
    _bf16,
    _block_ln,
    _close,
    _in_order,
    _ranks,
    _split_k_sum,
    _strided_sums,
    _t,
    _vec,
    _weight,
)

from ttasr.ops import decoder_mlp_pallas as jmlp
from ttasr_torch.ops import decoder_blocks as tblk
from ttasr_torch.ops import decoder_mlp as tmlp

TILE = 32
H100_SMS = 132


# ---------------------------------------------------------------------------
# the schedule
# ---------------------------------------------------------------------------

SHAPES = [  # (D, F, B4?, blocks)
    (1280, 5120, True, H100_SMS),
    (1280, 5120, True, 2 * H100_SMS),
    (1280, 5120, False, H100_SMS),
    (1280, 5120, False, 2 * H100_SMS),
    (1280, 2560, False, 2 * H100_SMS),
    (1280, 1280, False, 2 * H100_SMS),
]


def _units_of(sch):
    """(phase, tile, range, offset, finisher) of each block's units, in its
    order."""
    out = []
    for row in sch.units:
        n = int(row[0])
        out.append([tuple(int(v) for v in row[1 + 5 * i:6 + 5 * i]) for i in range(n)])
    return out


@pytest.mark.parametrize("d,f,cross,blocks", SHAPES)
def test_schedule_deals_every_unit_once_and_evenly(d, f, cross, blocks):
    sch = tmlp.mlp_schedule(d, f, blocks, cross)
    phases = tmlp.mlp_phases(d, f, cross)
    want = {(p, t, q) for p, k, n in phases
            for t in range(n // TILE) for q in range(tblk.gemm_splits(k, n))}
    dealt = [u[:3] for us in _units_of(sch) for u in us]
    assert len(dealt) == len(want) and set(dealt) == want
    # one finisher per tile: the holder of its range 0
    finishers = [u[:3] for us in _units_of(sch) for u in us if u[4]]
    assert sorted(finishers) == sorted((p, t, 0) for p, t, q in want if q == 0)

    unit_bytes = {p: tblk.slab_bytes(k, tblk.gemm_splits(k, n)) for p, k, n in phases}
    mean = sum(unit_bytes[p] for p, _, _ in dealt) / blocks
    for us, nbytes in zip(_units_of(sch), sch.block_bytes):
        assert abs(nbytes - mean) <= max(unit_bytes.values())
        # by phase, then tile, then range; slabs back to back from offset 0
        assert [u[:3] for u in us] == sorted(u[:3] for u in us)
        off = 0
        for p, _, _, o, _ in us:
            assert o == off
            off += unit_bytes[p]
        assert off == nbytes <= sch.weight_bytes
    assert sch.smem_bytes <= tblk.MAX_SMEM
    assert sch.part_per_row == sum(tblk.gemm_splits(k, n) * n for _, k, n in phases)


def test_plan_at_large_v3():
    """B4 at large-v3: wo_c in 4 ranges, W1 in 2, W2 in 8 (the three
    launches' order); 14.7 MB over two blocks per SM, at most 4 units and
    72,448 slab bytes a block, at most one unit of wo_c and two of W1 and
    of W2, and two blocks' shared memory within an SM's.
    B14 at every shard width takes two blocks per SM too."""
    sch = tmlp.mlp_plan(1280, 5120, H100_SMS, True)
    assert sch.units.shape[0] == 2 * H100_SMS and sch.splits == (4, 2, 8)
    assert sum(sch.block_bytes) == 160 * 10240 + 320 * 20736 + 320 * 20736
    assert sch.max_units == 4 and sch.weight_bytes == 72448
    assert 2 * (sch.smem_bytes + tmlp.BLOCK_SMEM_RESERVED) <= tmlp.SM_SMEM
    per_phase = [Counter(u[0] for u in us) for us in _units_of(sch)]
    assert [max(c[p] for c in per_phase) for p in range(3)] == [1, 2, 2]
    for f in (5120, 2560, 1280):
        assert tmlp.mlp_plan(1280, f, H100_SMS, False).units.shape[0] == 2 * H100_SMS


def test_schedule_refuses_what_shared_memory_cannot_hold():
    with pytest.raises(ValueError, match="shared memory"):
        tmlp.mlp_schedule(1280, 5120, 16, True)
    with pytest.raises(ValueError, match="do not fit"):
        tmlp.mlp_plan(1280, 5120, 16, True)
    with pytest.raises(ValueError, match="multiples"):
        tmlp.mlp_schedule(1280, 5100, H100_SMS, True)


def test_skinny_gemm_shape_rules_at_large_v3():
    """Every shape keeps its K ranges (its order); of the shapes the skinny
    GEMM serves (B1, B3, B12, B15, B16 at one and two ranks), only B1's
    takes two teams: one block per tile, one wave on the card."""
    splits = {(1280, 1280): 4, (1280, 3840): 2, (1280, 5120): 2, (5120, 1280): 8,
              (640, 1280): 4, (1280, 640): 7, (1280, 2560): 2, (2560, 1280): 4}
    for (k, n), s in splits.items():
        assert tblk.gemm_splits(k, n) == s
    for k, n in [(1280, 3840), (1280, 1280), (640, 1280), (1280, 640)]:
        assert tblk.gemm_teams(k, n) == (2 if (k, n) == (1280, 3840) else 1)
    assert 3840 // TILE <= H100_SMS < 2 * (3840 // TILE)


# ---------------------------------------------------------------------------
# the kernel's order of work
# ---------------------------------------------------------------------------

def _unit_sums(a, wq, lo, hi):
    """One unit's sums over the K range [lo, hi) of a (R, K) bf16-exact
    rows and W (K, 32) codes: 32 K-groups summing every 32nd row in order, a
    warp's 4 groups paired by two shuffles, the 8 warps in index order."""
    prods = (a.T[lo:hi, :, None] * wq[lo:hi].float()[:, None, :]).permute(1, 2, 0)
    acc = _strided_sums(prods, K_GROUPS).reshape(*prods.shape[:2], WARPS, 4)
    pairs = (acc[..., 0] + acc[..., 1]) + (acc[..., 2] + acc[..., 3])
    return _in_order(pairs.unbind(-1))


def _persistent(a, splits, partial=False, seed=0):
    """The persistent kernel's work on torch tensors ``a`` (x, cross or
    None, LN2, wo_c, W1 and W2 codes/scales/biases), the units in a random
    order that respects the waits."""
    x, cross = a["x"], a.get("cross")
    r, d = x.shape
    f = a["w1"].shape[1]
    phases = tmlp.mlp_phases(d, f, cross is not None)
    codes = {0: a.get("woc"), 1: a["w1"], 2: a["w2"]}
    scale = {0: a.get("woc_s"), 1: a["w1s"], 2: a["w2s"]}
    bias = {0: a.get("boc"), 1: a["b1"], 2: a["b2"]}
    part = {p: torch.zeros(splits[p], r, n) for p, _, n in phases}
    pending = [(p, t, q) for p, _, n in phases for t in range(n // TILE)
               for q in range(splits[p])]
    arrived, x_done, h_done = Counter(), set(), set()
    x_mid = x if cross is None else torch.zeros_like(x)
    h = torch.zeros(r, f)
    out = torch.zeros(r, d)
    rng = np.random.default_rng(seed)

    def k_range(p, q):
        return _ranks(f if p == 2 else d, splits[p])[q]

    def ready(p, q):
        if p == 1:
            return cross is None or len(x_done) == d // TILE
        if p == 2:
            lo, hi = k_range(p, q)
            return all(t in h_done for t in range(lo // TILE, (hi - 1) // TILE + 1))
        return True

    while pending:
        can = [u for u in pending if ready(u[0], u[2])]
        p, t, q = can[rng.integers(len(can))]
        pending.remove((p, t, q))
        cols = slice(t * TILE, (t + 1) * TILE)
        act = (_bf16(cross) if p == 0 else
               _block_ln(x_mid, a["ln_s"], a["ln_b"]) if p == 1 else h)
        part[p][q][:, cols] = _unit_sums(act, codes[p][:, cols], *k_range(p, q))
        arrived[p, t] += 1
        if arrived[p, t] < splits[p]:
            continue
        # the tile's last range: the ranges in rank order, the epilogue
        vs = _in_order(part[p][i][:, cols] for i in range(splits[p])) * scale[p].reshape(-1)[cols]
        if p == 0:
            x_mid[:, cols] = (x[:, cols] + vs) + bias[0][cols]
            x_done.add(t)
        elif p == 1:
            h[:, cols] = _bf16(tmlp.gelu_as(vs + bias[1][cols]))
            h_done.add(t)
        else:
            out[:, cols] = vs if partial else (x_mid[:, cols] + bias[2][cols]) + vs
    return out


def _composed(a, splits, partial=False):
    """The same function as three ``_split_k_sum`` products."""
    x, cross = a["x"], a.get("cross")
    if cross is not None:
        x = (x + _split_k_sum(_bf16(cross), a["woc"], splits[0]) * a["woc_s"].reshape(-1)) \
            + a["boc"]
    ln = _block_ln(x, a["ln_s"], a["ln_b"])
    h = _bf16(tmlp.gelu_as(_split_k_sum(ln, a["w1"], splits[1]) * a["w1s"].reshape(-1)
                           + a["b1"]))
    v = _split_k_sum(h, a["w2"], splits[2]) * a["w2s"].reshape(-1)
    return v if partial else (x + a["b2"]) + v


D_UNEVEN, F_UNEVEN = 160, 352  # splits 3: 54, 54, 52 and 118, 118, 116 rows


def _mlp_inputs(seed, r, cross):
    rng = np.random.default_rng(seed)
    d, f = D_UNEVEN, F_UNEVEN
    a = dict(x=(rng.standard_normal((r, d)) * 0.3).astype(np.float32))
    if cross:
        a["cross"] = (rng.standard_normal((r, d)) * 0.3).astype(np.float32)
        a["woc"], a["woc_s"] = _weight(rng, (d, d))
        a["boc"] = _vec(rng, d)
    a["ln_s"], a["ln_b"] = _vec(rng, d, 0.1, 1.0), _vec(rng, d, 0.1)
    a["w1"], a["w1s"] = _weight(rng, (d, f))
    a["b1"] = _vec(rng, f)
    a["w2"], a["w2s"] = _weight(rng, (f, d))
    a["b2"] = _vec(rng, d)
    return a


B14_NAMES = ("x", "ln_s", "ln_b", "w1", "w1s", "b1", "w2", "w2s", "b2")
B4_NAMES = ("x", "cross", "woc", "woc_s", "boc") + B14_NAMES[1:]


@pytest.mark.parametrize("splits", [1, 3, 8])
def test_persistent_b4_order_matches_split_k_and_pallas(splits):
    """B4: the emulated kernel equals the three products' order bit for
    bit, and holds against the Pallas kernel and the plain version."""
    a = _mlp_inputs(splits, 5, True)
    ta = {k: _t(v) for k, v in a.items()}
    s = (splits,) * 3
    got = _persistent(ta, s, seed=splits)
    assert torch.equal(got, _composed(ta, s))
    args = [a[k] for k in B4_NAMES]
    _close(got, jmlp.mlp_with_crossout_int8(*map(jnp.asarray, args), tile=F_UNEVEN // 2,
                                            interpret=True))
    _close(got, tmlp.mlp_with_crossout_int8_ref(*map(_t, args)))


@pytest.mark.parametrize("partial", [True, False])
@pytest.mark.parametrize("splits", [1, 3, 8])
def test_persistent_b14_order_matches_split_k_and_pallas(splits, partial):
    """B14, partial and full: the same kernel without wo_c."""
    a = _mlp_inputs(10 + splits, 8, False)
    ta = {k: _t(v) for k, v in a.items()}
    s = (0, splits, splits)
    got = _persistent(ta, s, partial=partial, seed=splits)
    assert torch.equal(got, _composed(ta, s, partial=partial))
    args = [a[k] for k in B14_NAMES]
    _close(got, jmlp.mlp_int8_fused(*map(jnp.asarray, args), tile=F_UNEVEN // 2,
                                    interpret=True, partial=partial))
    _close(got, tmlp.mlp_int8_fused_ref(*map(_t, args), partial=partial))
