"""The order of work of the decode self-attention step on Hopper
(``ttasr_torch/csrc/self_attention.cu``, B2 and B10), on the CPU.

The kernel cannot run here; these tests hold a torch emulation of its
order of work against the Pallas kernels it replaces, in interpret mode,
and against the port's plain version (``ops/self_attention.py::_step_ref``).

``_split_step`` is an approximate emulation of that order: the cache
positions split into ``splits`` contiguous ranges of ``ceil(len / splits)``
(one block of a thread-block cluster each, the count a function of the
shape alone); the new entry's score as 32 lanes of two products each and a
butterfly, times the new scale; a position's 64-wide dot product as 4
quarters of 16 summed in order, paired by two shuffles, times its scale;
the maximum over every position and the new entry; each range's sum of
exp(s - m) as its 256 threads take it (a thread every 256th position, a
warp butterfly, the 8 warps in order), the ranges' sums in rank order and
exp(s_self - m) last; p = bf16(e / denom * vs); each range's P.V with a
thread on every 32nd position (8 columns each), the 4 positions of a warp
paired, the warps in order; the ranges' partial outputs in rank order, and
p_self * vq last.  It multiplies and then adds where the kernel fuses the
two (``fmaf``), so it is not bit-exact; reordering f32 sums moves the
output by ~1e-7 while the floats are held to 2e-3 x max, so these tests
cannot tell one split order from another.  They check the masking, the
exact softmax across ranges, the new codes and scales, and that a masked
range adds nothing; the kernel itself is held against ``_step_ref`` on
the card (``chip_smoke.py``).  Every head's arithmetic is its own: at int4
heads h and h + H/2 share their bytes, and the kernel's cluster for head
h reads the pair's bytes and uses its own nibble.

B10 ``self_attn_step_int8`` and B2 ``self_attn_step_indirect_int8`` (a
random ancestry map) at int8 and int4 (H = 4: pairs (0, 2), (1, 3)),
(B, K) = (1, 5), (5, 1) and (2, 3), per-row pads, splits 1, 3 (len 40:
ranges of 14, 14, 12, and live positions that no count divides) and 8,
with a slot and pads that leave every position of some ranges masked
(the output must stay finite).  Floats are held to ``FLOAT_REL`` x
max|reference|, the bound of ``tests/test_torch_decoder_kernels.py``;
the new codes and scales must be equal, array for array.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ttasr.ops import self_attention_pallas as jsa
from ttasr.ops.int4 import pack_int4_lanes
from ttasr.ops.quant import quantize_kv_sym
from ttasr_torch.ops import self_attention as tsa
from ttasr_torch.ops.int4 import pack_int4_lanes as t_pack_lanes
from ttasr_torch.ops.int4 import unpack_int4_lanes
from ttasr_torch.ops.quant import quantize_kv_sym as t_quantize_kv_sym

FLOAT_REL = 2e-3
THREADS = 256  # self_attention.cu: 8 warps
WARPS = THREADS // 32
PV_ROWS = THREADS // 8  # pass 2: 8 threads of 8 columns per position
DH = 64
NEG_INF = torch.finfo(torch.float32).min
HEADS, LEN = 4, 40
SPLITS = (1, 3, 8)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, rel=FLOAT_REL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), (err, np.abs(want).max())


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _ranks(n, splits):
    """The contiguous [lo, hi) range of each rank of a cluster."""
    per = -(-n // splits)
    return [(min(n, q * per), min(n, q * per + per)) for q in range(splits)]


def _butterfly(v):
    """A warp's __shfl_xor sum over the last axis (32 lanes): lane 0's."""
    lanes = torch.arange(32)
    for off in (16, 8, 4, 2, 1):
        v = v + v[..., lanes ^ off]
    return v[..., 0]


def _strided_sums(vals, threads):
    """Thread t of ``threads`` sums vals[..., t + threads * i] in order."""
    steps = -(-vals.shape[-1] // threads)
    pad = steps * threads - vals.shape[-1]
    vals = torch.cat([vals, vals.new_zeros((*vals.shape[:-1], pad))], -1)
    acc = vals.new_zeros((*vals.shape[:-1], threads))
    for step in vals.reshape(*vals.shape[:-1], steps, threads).unbind(-2):
        acc = acc + step
    return acc


def _in_order(parts):
    total = 0.0
    for p in parts:
        total = total + p
    return total


def _split_step(qkv, k8, ks, v8, vs, anc, pad, slot, n_heads, int4, splits):
    """The kernel's outputs (attn, k_new, ks_new, v_new, vs_new) in an
    approximation of its order of work (products rounded before they are
    added), for ``splits`` blocks per cluster."""
    b, k, d3 = qkv.shape
    d, h = d3 // 3, n_heads
    s_len = k8.shape[2]
    heads = lambda t: t.reshape(b, k, h, DH)  # noqa: E731
    q = _bf16(heads(qkv[..., :d]) * 0.125)
    k_code, ks_new = t_quantize_kv_sym(heads(qkv[..., d:2 * d]), 7 if int4 else 127)
    v_code, vs_new = t_quantize_kv_sym(heads(qkv[..., 2 * d:]), 7 if int4 else 127)
    # the new entry: lane l holds products l and l + 32, then a butterfly
    prod = q * k_code.float()
    s_self = _butterfly(prod[..., 32:] + prod[..., :32]) * ks_new          # (B,K,H)

    rows = torch.arange(k)[None, :, None].expand(b, k, s_len)
    live = torch.ones((b, k, s_len), dtype=torch.bool)
    if anc is not None:  # physical row anc[b, j, t]; out of range masks t
        live = (anc >= 0) & (anc < k)
        rows = anc.long().clamp(0, k - 1)
    t_ids = torch.arange(s_len)
    live = live & (t_ids < slot) & (t_ids >= pad[..., None])
    unpack = unpack_int4_lanes if int4 else (lambda t: t)
    kc = unpack(k8).float().reshape(b, k, s_len, h, DH)
    vc = unpack(v8).float().reshape(b, k, s_len, h, DH)
    bi = torch.arange(b)[:, None, None]
    kc = kc[bi, rows, t_ids].permute(0, 1, 3, 2, 4)                      # (B,K,H,len,64)
    vc = vc[bi, rows, t_ids].permute(0, 1, 3, 2, 4)
    ks_t = ks[bi, rows, :, t_ids].permute(0, 1, 3, 2)[:, :, :h]           # (B,K,H,len)
    vs_t = vs[bi, rows, :, t_ids].permute(0, 1, 3, 2)[:, :, :h]

    # pass 1: 4 quarters of 16 dims summed in order, paired by two shuffles
    acc = _in_order((q[:, :, :, None, :] * kc).reshape(b, k, h, s_len, 4, 16).unbind(-1))
    dot = (acc[..., 0] + acc[..., 1]) + (acc[..., 2] + acc[..., 3])
    scores = torch.where(live[:, :, None, :], dot * ks_t, NEG_INF)
    m = torch.maximum(scores.amax(-1), s_self)
    e = torch.exp(scores - m[..., None])

    def block_sum(vals):
        t = _strided_sums(vals, THREADS).reshape(*vals.shape[:-1], WARPS, 32)
        return _in_order(_butterfly(t).unbind(-1))

    spans = [(lo, min(hi, slot)) for lo, hi in _ranks(s_len, splits)]
    denom = _in_order(block_sum(e[..., lo:max(lo, hi)]) for lo, hi in spans)
    e_self = torch.exp(s_self - m)
    denom = denom + e_self
    p = torch.where(e > 0, _bf16(e / denom[..., None] * vs_t), 0.0)

    parts = []
    for lo, hi in spans:
        hi = max(lo, hi)
        terms = (p[..., lo:hi, None] * vc[..., lo:hi, :]).transpose(-1, -2)  # (...,64,n)
        acc = _strided_sums(terms, PV_ROWS).reshape(*terms.shape[:-1], WARPS, 4)
        pairs = (acc[..., 0] + acc[..., 1]) + (acc[..., 2] + acc[..., 3])
        parts.append(_in_order(pairs.unbind(-1)))
    p_self = e_self / denom
    out = _in_order(parts) + p_self[..., None] * (v_code.float() * vs_new[..., None])

    def store(code):
        code = code.reshape(b, k, d)
        return t_pack_lanes(code) if int4 else code

    return out.reshape(b, k, d), store(k_code), ks_new, store(v_code), vs_new


def _inputs(seed, b, k, slot, pads, int4, indirect):
    rng = np.random.default_rng(seed)
    h, d = HEADS, HEADS * DH
    hp = ((h + 7) // 8) * 8
    lv = 7 if int4 else 127
    qkv = (rng.standard_normal((b, k, 3 * d)) * 0.5).astype(np.float32)
    qkv[0, 0, d:d + 4] = [0.5, -0.5, 1.5, 2.5]  # exact .5 ratios at |x|max
    qkv[0, 0, d + 4] = 3.5 if int4 else 63.5
    caches = []
    for _ in range(2):
        kv = (rng.standard_normal((b * k, LEN, h, DH)) * 0.5).astype(np.float32)
        c, sc = quantize_kv_sym(jnp.asarray(kv), lv)
        c = np.array(c).reshape(b * k, LEN, d)
        junk = np.arange(LEN) >= slot  # not yet written: must not matter
        c[:, junk] = rng.integers(-lv, lv + 1, c[:, junk].shape)
        if int4:
            c = np.asarray(pack_int4_lanes(jnp.asarray(c)))
        sc = np.pad(np.swapaxes(np.asarray(sc), 1, 2), ((0, 0), (0, hp - h), (0, 0)))
        caches += [c.reshape(b, k, LEN, -1), np.ascontiguousarray(sc.reshape(b, k, hp, LEN))]
    pad = np.array(pads, np.int32).reshape(b, k)
    anc = rng.integers(0, k, (b, k, LEN)).astype(np.int32) if indirect else None
    return qkv, caches, pad, anc


# (slot, per-row pads): live positions 3..36 (no split count divides
# them); slot 12 masks every position of ranks >= 1 of 3 and >= 3 of 8;
# pads >= 28 mask ranks 0 and 1 of 3 and ranks 0-4 of 8
CASES = {
    "live": (37, lambda n: [3 + (2 * r) % 5 for r in range(n)]),
    "masked ranges": (12, lambda n: [0] * n),
    "masked pads": (37, lambda n: [28 + (r % 3) * 2 for r in range(n)]),
}


def _run(kernel, b, k, int4, case):
    slot, pads = CASES[case]
    indirect = kernel == "B2"
    seed = 1000 * indirect + 100 * int4 + 10 * b + k + slot
    qkv, (k8, ks, v8, vs), pad, anc = _inputs(seed, b, k, slot, pads(b * k), int4, indirect)
    kw = dict(n_heads=HEADS, int4=int4)
    if indirect:
        want = jsa.self_attn_step_indirect_int8(jnp.asarray(qkv), k8, ks, v8, vs, anc, pad,
                                                slot, interpret=True, **kw)
        plain = tsa.self_attn_step_indirect_int8_ref(
            *map(_t, (qkv, k8, ks, v8, vs, anc, pad)), slot, **kw)
    else:
        want = jsa.self_attn_step_int8(jnp.asarray(qkv), k8, ks, v8, vs, pad, slot,
                                       interpret=True, **kw)
        plain = tsa.self_attn_step_int8_ref(*map(_t, (qkv, k8, ks, v8, vs, pad)), slot, **kw)
    args = [_t(a) for a in (qkv, k8, ks, v8, vs)] + [None if anc is None else _t(anc), _t(pad)]
    return [_split_step(*args, slot, HEADS, int4, s) for s in SPLITS], want, plain


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("b,k", [(1, 5), (5, 1), (2, 3)])
@pytest.mark.parametrize("int4", [True, False])
@pytest.mark.parametrize("kernel", ["B10", "B2"])
def test_split_step_matches_pallas(kernel, int4, b, k, case):
    """Splits 1, 3 and 8 against the Pallas kernel and the plain version;
    the new codes and scales equal both, array for array."""
    emulated, want, plain = _run(kernel, b, k, int4, case)
    for got in emulated:
        assert torch.isfinite(got[0]).all()
        _close(got[0], want[0])
        _close(got[0], plain[0])
        for i in (1, 2, 3, 4):
            assert got[i].dtype == plain[i].dtype
            np.testing.assert_array_equal(got[i].numpy(), np.asarray(want[i]))
            assert torch.equal(got[i], plain[i])


def test_a_masked_range_contributes_nothing():
    """With every position of ranks >= 1 masked (slot 12 of 40 at 3
    ranges), the emulated kernel equals itself with those ranges' cache
    bytes and scales replaced: a masked range adds exact zeros."""
    slot = 12
    qkv, (k8, ks, v8, vs), pad, anc = _inputs(5, 1, 5, slot, [0] * 5, True, True)
    args = [_t(a) for a in (qkv, k8, ks, v8, vs, anc, pad)]
    assert all(lo >= slot for lo, _ in _ranks(LEN, 3)[1:])
    got = _split_step(*args, slot, HEADS, True, 3)
    for i in (1, 2, 3, 4):  # k8, ks, v8, vs past the slot: other values
        args[i] = args[i].clone()
        args[i][:, :, slot:] = args[i][:, :, slot:].flip(2)
    other = _split_step(*args, slot, HEADS, True, 3)
    for a, c in zip(got, other):
        assert torch.equal(a, c)


def test_b2_with_identity_ancestry_is_b10_in_every_split():
    """B2 and B10 at one shape do the same arithmetic: through an identity
    ancestry map B2's emulated order gives B10's bits."""
    qkv, (k8, ks, v8, vs), pad, _ = _inputs(9, 2, 3, 37, [3, 0, 5, 1, 2, 4], True, False)
    anc = torch.arange(3, dtype=torch.int32)[None, :, None].expand(2, 3, LEN)
    args = [_t(a) for a in (qkv, k8, ks, v8, vs)]
    for splits in SPLITS:
        direct = _split_step(*args, None, _t(pad), 37, HEADS, True, splits)
        indirect = _split_step(*args, anc, _t(pad), 37, HEADS, True, splits)
        for a, c in zip(direct, indirect):
            assert torch.equal(a, c)


def test_out_of_range_ancestry_masks_the_position():
    """An anc entry outside [0, K) masks its position, as in the Pallas B2
    (whose row mask anc == r matches no physical row)."""
    slot = 37
    qkv, (k8, ks, v8, vs), pad, anc = _inputs(11, 1, 5, slot, [0] * 5, True, True)
    anc[0, 1, 5:9] = -1
    anc[0, 3, 20] = 5
    want = jsa.self_attn_step_indirect_int8(jnp.asarray(qkv), k8, ks, v8, vs, anc, pad, slot,
                                            n_heads=HEADS, int4=True, interpret=True)
    args = [_t(a) for a in (qkv, k8, ks, v8, vs, anc, pad)]
    for splits in SPLITS:
        got = _split_step(*args, slot, HEADS, True, splits)
        _close(got[0], want[0])
