"""The order of work of the decode step's int8 kernels on Hopper
(``ttasr_torch/csrc/skinny_gemm.cuh`` and ``cross_attention.cuh``), on the
CPU.

The kernels cannot run here; these tests hold torch emulations of their
arithmetic against the Pallas kernels they replace, in interpret mode, and
against the port's plain versions.

- ``_split_k_sum`` is the skinny GEMM's dot product: K split into
  ``splits`` contiguous ranges (one block of a thread-block cluster each),
  32 K-groups per block summing every 32nd row in order, a warp's 4
  K-groups paired by two shuffles, the 8 warps in index order, then the
  ranges in rank order.  ``_block_ln`` is its LayerNorm prologue: every
  block reads the whole row (a warp's lanes every 32nd element, a shuffle
  butterfly) for the mean and then for the squared deviations (the TPU's
  two passes), so the statistics do not depend on the split.
- ``_split_s_attention`` is the cross-attention: S split into contiguous
  ranges of cache rows (int4: packed row p holds slots p and p + S/2), the
  64-wide dot product as 4 quarters of 16 summed in order, the global
  maximum, per-range sums of exp(s - m) (a thread every 256th slot, a warp
  butterfly, the warps in order) added in rank order, the normalised
  probability times vs rounded to bf16, and per-range P.V (a thread every
  32nd row, paired rows, the warps in order) added in rank order.

B15 ``matmul_int8_partial`` and B1 ``qkv_int8_fused`` run at splits 1, 3
and 8 over K = 205, which no split count divides evenly; B13
``cross_attention_int8``, B3 ``attnout_ln_q_cross_int8`` and B16
``ln_q_cross_int8`` at int8 and int4, (B, K) = (1, 5) and (2, 3), splits 1
and 8, with s_real = 45 of 48 slots and s_real = 20, which masks every
slot of the last ranges (the output must stay finite).  Floats are held to
``FLOAT_REL`` x max|reference|, the bound of
``tests/test_torch_decoder_kernels.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ttasr.ops import cross_attention_pallas as jca
from ttasr.ops import decoder_blocks_pallas as jblk
from ttasr.ops.int4 import pack_int4
from ttasr.ops.quant import quantize_kv_sym, quantize_tensor
from ttasr_torch.ops import cross_attention as tca
from ttasr_torch.ops import decoder_blocks as tblk
from ttasr_torch.ops.int4 import unpack_int4

FLOAT_REL = 2e-3
K_GROUPS = 32  # skinny_gemm.cuh: 256 threads = 32 K-groups x 8 column threads
WARPS = 8
THREADS = 256
DH = 64
NEG_INF = torch.finfo(torch.float32).min
QSCALE = DH ** -0.5


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
    pad = -vals.shape[-1] % threads
    vals = torch.cat([vals, vals.new_zeros((*vals.shape[:-1], pad))], -1)
    acc = vals.new_zeros((*vals.shape[:-1], threads))
    steps = vals.shape[-1] // threads
    for step in vals.reshape(*vals.shape[:-1], steps, threads).unbind(-2):
        acc = acc + step
    return acc


def _in_order(parts):
    total = 0.0
    for p in parts:
        total = total + p
    return total


# ---------------------------------------------------------------------------
# skinny_gemm.cuh
# ---------------------------------------------------------------------------

def _split_k_sum(a, wq, splits):
    """sum_k a[r, k] W[k, n] in the GEMM's order; a (R, K) bf16-exact f32,
    W (K, N) int8.  Products are exact in f32."""
    prods = (a.T[:, :, None] * wq.float()[:, None, :]).permute(1, 2, 0)  # (R, N, K)
    blocks = []
    for lo, hi in _ranks(prods.shape[-1], splits):
        acc = _strided_sums(prods[..., lo:hi], K_GROUPS)        # (R, N, 32)
        acc = acc.reshape(*acc.shape[:-1], WARPS, 4)           # warp w: groups 4w..4w+3
        pairs = (acc[..., 0] + acc[..., 1]) + (acc[..., 2] + acc[..., 3])
        blocks.append(_in_order(pairs.unbind(-1)))
    return _in_order(blocks)


def _block_ln(x, ln_s, ln_b):
    """The GEMM's LayerNorm prologue, bf16-rounded: every block reads the
    whole row (a warp per row, lanes every 32nd element, a shuffle
    butterfly) for the mean, then for the squared deviations."""
    k = x.shape[-1]
    mean = _butterfly(_strided_sums(x, 32)) / k
    dev = x - mean[:, None]
    var = _butterfly(_strided_sums(dev * dev, 32)) / k
    rstd = 1.0 / torch.sqrt(var + 1e-5)
    return _bf16(dev * rstd[:, None] * ln_s + ln_b)


def _weight(rng, shape, scale=0.05):
    w = quantize_tensor((rng.standard_normal(shape) * scale).astype(np.float32))
    return np.asarray(w["q"]), np.asarray(w["s"])


def _vec(rng, n, scale=0.02, offset=0.0):
    return (rng.standard_normal(n) * scale + offset).astype(np.float32)


UNEVEN_K = 205  # splits 3: 69, 69, 67 rows; splits 8: 7 x 26 + 23


@pytest.mark.parametrize("splits", [1, 3, 8])
def test_split_k_partial_matches_pallas(splits):
    """B15: bf16(x) @ W * s over a K that no split count divides."""
    rng = np.random.default_rng(splits)
    x = (rng.standard_normal((5, UNEVEN_K)) * 0.3).astype(np.float32)
    wq, ws = _weight(rng, (UNEVEN_K, 64))
    want = jblk.matmul_int8_partial(jnp.asarray(x), wq, ws, interpret=True)
    got = _split_k_sum(_bf16(_t(x)), _t(wq), splits) * _t(ws).reshape(-1)
    _close(got, want)
    _close(got, tblk.matmul_int8_partial_ref(*map(_t, (x, wq, ws))))


@pytest.mark.parametrize("splits", [1, 3, 8])
def test_split_k_layer_norm_prologue_matches_pallas(splits):
    """B1: LN(x) @ W * s + b, the LayerNorm's statistics from the whole row
    in every block."""
    rng = np.random.default_rng(10 + splits)
    x = (rng.standard_normal((5, UNEVEN_K)) * 0.3 + 0.1).astype(np.float32)
    ln_s, ln_b = _vec(rng, UNEVEN_K, 0.1, 1.0), _vec(rng, UNEVEN_K, 0.1)
    wq, ws = _weight(rng, (UNEVEN_K, 96))
    b = _vec(rng, 96)
    want = jblk.qkv_int8_fused(jnp.asarray(x), ln_s, ln_b, wq, ws, b, interpret=True)
    ln = _block_ln(*map(_t, (x, ln_s, ln_b)))
    got = _split_k_sum(ln, _t(wq), splits) * _t(ws).reshape(-1) + _t(b)
    _close(got, want)
    _close(got, tblk.qkv_int8_fused_ref(*map(_t, (x, ln_s, ln_b, wq, ws, b))))


# ---------------------------------------------------------------------------
# cross_attention.cuh
# ---------------------------------------------------------------------------

def _codes(c):
    return (unpack_int4(c) if c.dtype == torch.uint8 else c).float()


def _split_s_attention(qc, ck, cks, cv, cvs, s_real, splits):
    """The cross-attention's order of work; qc (B, K, H, 64) f32 already
    times 64**-0.5.  Returns (B, K, H, 64) f32."""
    b, k, h, _ = qc.shape
    packed = ck.dtype == torch.uint8
    s = cks.shape[-1]
    rows = s // 2 if packed else s
    qb = _bf16(qc).permute(0, 2, 1, 3)                             # (B,H,K,64)
    kc = _codes(ck).reshape(b, s, h, DH).permute(0, 2, 1, 3)       # (B,H,S,64)
    vc = _codes(cv).reshape(b, s, h, DH).permute(0, 2, 1, 3)
    # scores: 4 threads of 16 dims each, summed in order, then paired
    prod = (qb[:, :, :, None, :] * kc[:, :, None, :, :]).reshape(b, h, k, s, 4, 16)
    acc = _in_order(prod.unbind(-1))
    dot = (acc[..., 0] + acc[..., 1]) + (acc[..., 2] + acc[..., 3])
    scores = (dot * cks[:, :, None, :]).masked_fill(torch.arange(s) >= s_real, NEG_INF)
    m = scores.amax(-1, keepdim=True)  # the ranks' maxima, then theirs
    e = torch.exp(scores - m)
    spans = []
    for lo, hi in _ranks(rows, splits):
        slots = list(range(lo, hi)) + (list(range(lo + rows, hi + rows)) if packed else [])
        spans.append(torch.tensor(slots, dtype=torch.long))

    def block_sum(vals):
        t = _strided_sums(vals, THREADS).reshape(*vals.shape[:-1], WARPS, 32)
        return _in_order(_butterfly(t).unbind(-1))

    denom = _in_order(block_sum(e[..., idx]) for idx in spans)
    p = _bf16(e / denom[..., None] * cvs[:, :, None, :])
    out = []
    for lo, hi in _ranks(rows, splits):
        # a thread: 8 columns of every 32nd row, its lo slot then its hi slot
        steps = -(-(hi - lo) // 32)

        def rows32(first):
            t = p[..., first:first + hi - lo, None] * vc[:, :, None, first:first + hi - lo]
            pad = t.new_zeros((b, h, k, 32 * steps - (hi - lo), DH))
            return torch.cat([t, pad], -2).reshape(b, h, k, steps, 32, DH)

        lo_terms = rows32(lo)
        hi_terms = rows32(lo + rows) if packed else None
        acc = torch.zeros((b, h, k, 32, DH))
        for i in range(steps):
            acc = acc + lo_terms[..., i, :, :]
            if packed:
                acc = acc + hi_terms[..., i, :, :]
        acc = acc.reshape(b, h, k, WARPS, 4, DH)  # warp w: rows 4w..4w+3
        pairs = (acc[..., 0, :] + acc[..., 1, :]) + (acc[..., 2, :] + acc[..., 3, :])
        out.append(_in_order(pairs.unbind(-2)))
    return _in_order(out).permute(0, 2, 1, 3)


S, HEADS = 48, 2
S_REALS = [45, 20]  # 20: every slot of the last ranges masked (int4 and int8)


def _cross_inputs(seed, b, k, int4):
    rng = np.random.default_rng(seed)
    d = HEADS * DH
    x = (rng.standard_normal((b, k, d)) * 0.3).astype(np.float32)
    attn = (rng.standard_normal((b, k, d)) * 0.3).astype(np.float32)
    wo, wo_s = _weight(rng, (d, d))
    wqc, wqc_s = _weight(rng, (d, d))
    codes, scales = [], []
    for _ in range(2):
        kv = (rng.standard_normal((b, S, HEADS, DH)) * 0.5).astype(np.float32)
        c, sc = quantize_kv_sym(jnp.asarray(kv), 7 if int4 else 127)
        c = jnp.asarray(c).reshape(b, S, d)
        codes.append(np.asarray(pack_int4(c) if int4 else c))
        scales.append(np.ascontiguousarray(np.swapaxes(np.asarray(sc), 1, 2)))
    return dict(x=x, attn=attn, wo=wo, wo_s=wo_s, bo=_vec(rng, d),
                lnc_s=_vec(rng, d, 0.1, 1.0), lnc_b=_vec(rng, d, 0.1), wqc=wqc,
                wqc_s=wqc_s, bqc=_vec(rng, d), kv=(codes[0], scales[0], codes[1], scales[1]))


def _emulated_query(xo, a, splits):
    """B3's and B16's cross query: LNc(xo) @ Wq_c * s + b, times 64**-0.5."""
    b, k, d = xo.shape
    ln = _block_ln(xo.reshape(b * k, d), a["lnc_s"], a["lnc_b"])
    v = _split_k_sum(ln, a["wqc"], splits)
    qc = (v * a["wqc_s"].reshape(-1) + a["bqc"]) * QSCALE
    return qc.reshape(b, k, HEADS, DH)


def _emulated(kernel, a, s_real, splits):
    """The kernel's outputs from the emulated orders (B3: (x', cross))."""
    b, k, d = a["x"].shape
    kv = a["kv"]
    if kernel == "B13":
        return _split_s_attention(a["x"].reshape(b, k, HEADS, DH) * QSCALE, *kv,
                                  s_real, splits).reshape(b, k, d)
    xo = a["x"]
    if kernel == "B3":
        v = _split_k_sum(_bf16(a["attn"].reshape(b * k, d)), a["wo"], splits)
        xo = ((a["x"].reshape(b * k, d) + v * a["wo_s"].reshape(-1)) + a["bo"]).reshape(b, k, d)
    cross = _split_s_attention(_emulated_query(xo, a, splits), *kv, s_real,
                               splits).reshape(b, k, d)
    return (xo, cross) if kernel == "B3" else cross


def _references(kernel, a, s_real):
    """(Pallas in interpret mode, the port's plain version)."""
    n = {k: v for k, v in a.items() if k != "kv"}
    j = dict(n, kv=tuple(jnp.asarray(t) for t in a["kv"]))
    t = {k: (_t(v) if k != "kv" else tuple(map(_t, v))) for k, v in a.items()}
    if kernel == "B13":
        b, k, d = a["x"].shape
        q = a["x"].reshape(b, k, HEADS, DH)
        want = jca.cross_attention_int8(jnp.asarray(q), *j["kv"], s_real, interpret=True)
        plain = tca.cross_attention_int8_ref(_t(q), *t["kv"], s_real)
        return np.asarray(want).reshape(b, k, d), plain.reshape(b, k, d)
    names = ("lnc_s", "lnc_b", "wqc", "wqc_s", "bqc")
    if kernel == "B16":
        args = [n["x"]] + [n[m] for m in names]
        want = jblk.ln_q_cross_int8(*map(jnp.asarray, args), *j["kv"], s_real=s_real,
                                    interpret=True)
        plain = tblk.ln_q_cross_int8_ref(*map(_t, args), *t["kv"], s_real)
        return want, plain
    args = [n[m] for m in ("x", "attn", "wo", "wo_s", "bo")] + [n[m] for m in names]
    want = jblk.attnout_ln_q_cross_int8(*map(jnp.asarray, args), *j["kv"], s_real=s_real,
                                        interpret=True)
    plain = tblk.attnout_ln_q_cross_int8_ref(*map(_t, args), *t["kv"], s_real)
    return want, plain


@pytest.mark.parametrize("s_real", S_REALS)
@pytest.mark.parametrize("b,k", [(1, 5), (2, 3)])
@pytest.mark.parametrize("int4", [True, False])
@pytest.mark.parametrize("kernel", ["B13", "B3", "B16"])
def test_split_s_cross_attention_matches_pallas(kernel, int4, b, k, s_real):
    """Splits 1 and 8 against the Pallas kernel and the plain version; at
    s_real = 20 the last ranges hold masked slots only and add exact
    zeros (exp(finfo.min - m) = 0), never a NaN."""
    a = _cross_inputs(100 * int4 + 10 * b + k + s_real, b, k, int4)
    want, plain = _references(kernel, a, s_real)
    ta = {key: (_t(v) if key != "kv" else tuple(map(_t, v))) for key, v in a.items()}
    for splits in (1, 8):
        got = _emulated(kernel, ta, s_real, splits)
        if kernel == "B3":
            _close(got[0], want[0])
            _close(got[0], plain[0])
            got, cross_want, cross_plain = got[1], want[1], plain[1]
        else:
            cross_want, cross_plain = want, plain
        assert torch.isfinite(got).all()
        _close(got, cross_want)
        _close(got, cross_plain)


def test_a_masked_range_contributes_nothing():
    """With every slot of the last ranges masked, the emulated kernel at 8
    ranges equals itself with those ranges' rows zeroed, and the ranges'
    partial outputs are exact zeros."""
    a = _cross_inputs(7, 1, 5, True)
    ck, cks, cv, cvs = map(_t, a["kv"])
    qc = _t(a["x"]).reshape(1, 5, HEADS, DH) * QSCALE
    rows = S // 2
    masked = [(lo, hi) for lo, hi in _ranks(rows, 8) if lo >= 20]
    assert masked, "s_real = 20 must mask a whole range"
    got = _split_s_attention(qc, ck, cks, cv, cvs, 20, 8)
    cv2 = cv.clone()
    for lo, hi in masked:
        cv2[:, lo:hi] = 0
    assert torch.equal(got, _split_s_attention(qc, ck, cks, cv2, cvs, 20, 8))
