"""Fused int8 decoder MLPs: the Hopper kernels and their plain versions.

Ports of ``ttasr/ops/decoder_mlp_pallas.py``:

- B4 ``mlp_with_crossout_int8``, the MLP with the cross-attention
  out-projection folded in::

    x' = x + (cross @ Wo_c) * s_oc + b_oc
    y  = x' + GELU(LN2(x') @ W1 * s1 + b1) @ W2 * s2 + b2

- B14 ``mlp_int8_fused``, the MLP alone; with ``partial=True`` it is a
  row-parallel tensor-parallel shard's partial sum (W1/b1 the shard's
  column slice, W2 its row slice): ``GELU(LN2(x) @ W1 * s1 + b1) @ W2 * s2``
  with no residual and no b2, which the caller adds once after the sum.

GELU uses the Abramowitz-Stegun 7.1.26 erf polynomial the TPU kernel uses
(``decoder_mlp_pallas.py:28-48``, max erf error 1.5e-7), in both the CUDA
kernel and the plain version, so the two match each other and the JAX
kernel; the JAX reference paths outside the kernel use the exact erf.
The LN2 output and the GELU output round to bf16 before their weight
products, as on the TPU.

Each wrapper runs its plain version for CPU tensors and launches
``ttasr_torch/csrc/decoder_mlp.cu`` for CUDA tensors, counting launches in
``<wrapper>.launches``; on the card the vectors must be f32, as for the
kernels of :mod:`ttasr_torch.ops.decoder_blocks`.

On the card both run one persistent cooperative kernel, two blocks per SM,
whose work :func:`mlp_plan` deals out on the host: units of (column tile,
K range) of wo_c, W1 and W2, each block's slab bytes as even as the units
allow, a tile's ranges added in rank order by the block that finishes it.
The schedule, and a small buffer of counters the kernel leaves at zero,
are made on the first call for a shape and kept on the device.  The calls
on one device share the counters, so they must run one after another (one
stream, or streams that wait for each other, as a CUDA graph's capture
stream does), as the decode runs them.
"""

from __future__ import annotations

import dataclasses
import functools
import heapq

import numpy as np
import torch

from ttasr_torch.ops._build import count_launch
from ttasr_torch.ops.decoder_blocks import (
    MAX_SMEM,
    RED_FLOATS,
    ROW_CHUNK,
    TILE_COLS,
    _bf16,
    _check_cuda,
    _dispatch,
    _ln_f32,
    _wmul,
    gemm_splits,
    slab_bytes,
    slab_of,
)

_AS = (0.254829592, -0.284496736, 1.421413741, -1.453152027, 1.061405429)
_AS_P = 0.3275911


def erf_as(z):
    """Abramowitz-Stegun 7.1.26 erf, f32."""
    a1, a2, a3, a4, a5 = _AS
    s = torch.sign(z)
    z = z.abs()
    t = 1.0 / (1.0 + _AS_P * z)
    poly = t * (a1 + t * (a2 + t * (a3 + t * (a4 + t * a5))))
    return s * (1.0 - poly * torch.exp(-z * z))


def gelu_as(h):
    return 0.5 * h * (1.0 + erf_as(h * 0.7071067811865476))


# ---------------------------------------------------------------------------
# The persistent kernel's schedule (decoder_mlp.cu)
# ---------------------------------------------------------------------------

# kUnitInts: phase, column tile, K range, slab offset, and whether the block
# finishes the tile (adds its ranges' sums and applies the epilogue)
UNIT_INTS = 5
LINE_INTS = 32  # kLineInts: the counters' 128-byte lines


def mlp_phases(d: int, f: int, cross: bool):
    """(phase, K, N) of the products: 0 wo_c (B4 only), 1 W1, 2 W2."""
    return ([(0, d, d)] if cross else []) + [(1, d, f), (2, f, d)]


def mlp_sync_ints(d: int, f: int) -> int:
    """int32s of the kernel's counters (``mlp_sync_ints``): three lines of
    done counts, then each phase's column tiles."""
    return 3 * LINE_INTS + 2 * (d // TILE_COLS) + f // TILE_COLS


SM_SMEM = 233472             # an H100 SM's shared memory
BLOCK_SMEM_RESERVED = 1024  # the runtime's share of it per resident block
BLOCKS_PER_SM = 2           # the kernel's __launch_bounds__: two blocks' registers fit an SM


def mlp_smem_bytes(d: int, f: int, splits, cross: bool, max_units: int,
                   weight_bytes: int) -> int:
    """A block's shared memory (``mlp_smem_bytes``): its slabs, a barrier
    per unit, LN2's vectors, one unit's activations, the block's sums and
    the statistics."""
    kpers = [slab_of(d, splits[1])[0], slab_of(f, splits[2])[0]]
    if cross:
        kpers.append(slab_of(d, splits[0])[0])
    bars = (8 * max_units + 15) // 16 * 16
    return weight_bytes + bars + 4 * (2 * d + max(kpers) * ROW_CHUNK + RED_FLOATS
                                      + 2 * ROW_CHUNK)


@dataclasses.dataclass(frozen=True)
class MlpSchedule:
    """The persistent kernel's work per block.

    ``units`` (n_blocks, 1 + 5 max_units) int32: a block's unit count, then
    per unit its phase, column tile, K range, the offset of its slab in the
    block's shared memory and whether the block finishes the tile (the
    holder of its range 0: it waits for the other ranges' sums, adds them
    in rank order and applies the epilogue), in the order the block runs
    them."""

    units: np.ndarray
    max_units: int
    weight_bytes: int     # the largest block's slab bytes
    smem_bytes: int
    splits: tuple         # K ranges of wo_c (0 for B14), W1, W2
    block_bytes: tuple    # each block's slab bytes
    part_per_row: int     # f32 partial sums per activation row


@functools.lru_cache(maxsize=64)
def mlp_schedule(d: int, f: int, n_blocks: int, cross: bool) -> MlpSchedule:
    """Deal the (column tile, K range) units of wo_c (``cross``: B4), W1
    and W2 out to ``n_blocks`` blocks: the largest first, each to a block
    with the fewest units of its phase so far (a phase's time is set by its
    busiest block), of those the one with the fewest slab bytes, then the
    lower block; every block's bytes lie within one unit of the mean.  A
    block runs its units by phase, then tile, then range.  Raises if a
    block's shared memory would pass the card's 232,448 bytes."""
    if d % TILE_COLS or f % TILE_COLS or n_blocks < 1:
        raise ValueError(f"D={d} and F={f} must be multiples of {TILE_COLS}")
    splits = [0, 0, 0]
    units, part_per_row = [], 0
    for p, k, n in mlp_phases(d, f, cross):
        splits[p] = gemm_splits(k, n)
        nbytes = slab_bytes(k, splits[p])
        part_per_row += splits[p] * n
        units += [(nbytes, p, t, q) for t in range(n // TILE_COLS)
                  for q in range(splits[p])]
    units.sort(key=lambda u: (-u[0], u[1], u[2], u[3]))
    per_block = [[] for _ in range(n_blocks)]
    heap = None  # (units of the phase, bytes, block), rebuilt per phase
    for i, (nbytes, p, t, q) in enumerate(units):
        if i == 0 or p != units[i - 1][1]:
            heap = [(0, sum(u[3] for u in us), b) for b, us in enumerate(per_block)]
            heapq.heapify(heap)
        count, load, b = heapq.heappop(heap)
        per_block[b].append((p, t, q, nbytes))
        heapq.heappush(heap, (count + 1, load + nbytes, b))
    max_units = max(len(us) for us in per_block)
    table = np.zeros((n_blocks, 1 + UNIT_INTS * max_units), np.int32)
    for b, us in enumerate(per_block):
        us.sort()
        table[b, 0] = len(us)
        off = 0
        for i, (p, t, q, nbytes) in enumerate(us):
            table[b, 1 + UNIT_INTS * i:1 + UNIT_INTS * (i + 1)] = (p, t, q, off, q == 0)
            off += nbytes
    block_bytes = tuple(sum(u[3] for u in us) for us in per_block)
    weight_bytes = max(block_bytes)
    smem = mlp_smem_bytes(d, f, splits, cross, max_units, weight_bytes)
    if smem > MAX_SMEM:
        raise ValueError(f"D={d} F={f}: a block would need {smem} bytes of shared "
                         f"memory over {n_blocks} blocks, more than {MAX_SMEM}")
    return MlpSchedule(table, max_units, weight_bytes, smem, tuple(splits),
                       block_bytes, part_per_row)


@functools.lru_cache(maxsize=64)
def mlp_plan(d: int, f: int, sms: int, cross: bool) -> MlpSchedule:
    """The schedule over two blocks per SM (16 warps to hide each other's
    latencies) where two blocks' shared memory fits an SM, else over one."""
    for per_sm in (BLOCKS_PER_SM, 1):
        try:
            sch = mlp_schedule(d, f, per_sm * sms, cross)
        except ValueError:
            continue
        if per_sm * (sch.smem_bytes + BLOCK_SMEM_RESERVED) <= SM_SMEM:
            return sch
    raise ValueError(f"D={d} F={f}: the weights do not fit {sms} SMs' shared memory")


@functools.lru_cache(maxsize=None)
def _sm_count(dev) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


_SCHEDULES: dict = {}  # (device, D, F, B4?) -> the schedule on the card
_COUNTERS: dict = {}   # device -> int32 zeros between calls


def _persistent_args(dev, d: int, f: int, r: int, cross: bool):
    """The scratch, counter and schedule tensors of one launch, then its
    ints (n_blocks, max_units, weight_bytes, part_numel, sync_numel)."""
    sch = mlp_plan(d, f, _sm_count(dev), cross)
    n_blocks = sch.units.shape[0]
    key = (dev, d, f, cross)
    sched, sync = _SCHEDULES.get(key), _COUNTERS.get(dev)
    need = mlp_sync_ints(d, f)
    if sched is None or sync is None or sync.numel() < need:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("call the MLP kernel once outside CUDA graph capture "
                               "first: its schedule and counters are made then")
        if sched is None:
            sched = _SCHEDULES[key] = torch.from_numpy(sch.units).to(dev)
        if sync is None or sync.numel() < need:
            sync = _COUNTERS[dev] = torch.zeros(need, dtype=torch.int32, device=dev)
    part = torch.empty(sch.part_per_row * r, dtype=torch.float32, device=dev)
    return (part, sync, sched,
            n_blocks, sch.max_units, sch.weight_bytes, part.numel(), sync.numel())


def mlp_with_crossout_int8_ref(x, cross, woc_q, woc_s, boc, ln_s, ln_b,
                               w1q, w1s, b1, w2q, w2s, b2):
    """x, cross: (R, D).  Weights int8 with (1, N) f32 column scales.
    Returns (R, D) f32."""
    xm = x.float() + _wmul(_bf16(cross.float()), woc_q, woc_s) + boc.float()
    ln = _bf16(_ln_f32(xm, ln_s, ln_b))
    hid = _bf16(gelu_as(_wmul(ln, w1q, w1s) + b1.float()))
    return xm + b2.float() + _wmul(hid, w2q, w2s)


def mlp_with_crossout_int8(x, cross, woc_q, woc_s, boc, ln_s, ln_b,
                           w1q, w1s, b1, w2q, w2s, b2):
    """B4; see :func:`mlp_with_crossout_int8_ref` for the contract."""
    if not _dispatch(x):
        return mlp_with_crossout_int8_ref(x, cross, woc_q, woc_s, boc, ln_s,
                                          ln_b, w1q, w1s, b1, w2q, w2s, b2)
    r, d = x.shape
    f = w1q.shape[1]
    if x.dtype != torch.float32 or cross.dtype != torch.float32 \
            or cross.shape != x.shape:
        raise TypeError("x and cross must be f32 (R, D)")
    if (woc_q.shape != (d, d) or w1q.shape != (d, f) or w2q.shape != (f, d)
            or {woc_q.dtype, w1q.dtype, w2q.dtype} != {torch.int8}):
        raise ValueError("Wo_c (D, D), W1 (D, F), W2 (F, D) must be int8")
    vec = dict(woc_s=(woc_s, d), boc=(boc, d), ln_s=(ln_s, d), ln_b=(ln_b, d),
               w1s=(w1s, f), b1=(b1, f), w2s=(w2s, d), b2=(b2, d))
    dev = _check_cuda(vec, x=x, cross=cross, woc_q=woc_q, w1q=w1q, w2q=w2q)
    x_mid = torch.empty((r, d), dtype=torch.float32, device=dev)
    hid = torch.empty((r, f), dtype=torch.bfloat16, device=dev)
    out = torch.empty((r, d), dtype=torch.float32, device=dev)
    from ttasr_torch.ops._build import launch

    part, sync, sched, *ints = _persistent_args(dev, d, f, r, cross=True)
    launch("ttasr_mlp_crossout_int8", dev, x, cross, woc_q, woc_s, boc, ln_s,
           ln_b, w1q, w1s, b1, w2q, w2s, b2, x_mid, hid, out, part, sync, sched,
           r, d, f, *ints)
    count_launch(mlp_with_crossout_int8)
    return out


mlp_with_crossout_int8.launches = 0


def mlp_int8_fused_ref(x, ln_s, ln_b, w1q, w1s, b1, w2q, w2s, b2,
                       partial: bool = False):
    """x: (R, D).  w1q (D, F) int8 with (1, F) f32 scales and (F,) bias;
    w2q (F, D) int8 with the full (1, D) scales.  Returns (R, D) f32:
    ``x + b2 + GELU(LN2(x) @ W1 * s1 + b1) @ W2 * s2``, or with ``partial``
    the last term alone."""
    ln = _bf16(_ln_f32(x.float(), ln_s, ln_b))
    hid = _bf16(gelu_as(_wmul(ln, w1q, w1s) + b1.float()))
    out = _wmul(hid, w2q, w2s)
    return out if partial else x.float() + b2.float() + out


def mlp_int8_fused(x, ln_s, ln_b, w1q, w1s, b1, w2q, w2s, b2,
                   partial: bool = False):
    """B14; see :func:`mlp_int8_fused_ref` for the contract."""
    if not _dispatch(x):
        return mlp_int8_fused_ref(x, ln_s, ln_b, w1q, w1s, b1, w2q, w2s, b2,
                                  partial)
    r, d = x.shape
    f = w1q.shape[1]
    if x.dtype != torch.float32:
        raise TypeError("x must be f32 (R, D)")
    if (w1q.shape != (d, f) or w2q.shape != (f, d)
            or {w1q.dtype, w2q.dtype} != {torch.int8}):
        raise ValueError("W1 (D, F) and W2 (F, D) must be int8")
    vec = dict(ln_s=(ln_s, d), ln_b=(ln_b, d), w1s=(w1s, f), b1=(b1, f),
               w2s=(w2s, d), b2=(b2, d))
    dev = _check_cuda(vec, x=x, w1q=w1q, w2q=w2q)
    hid = torch.empty((r, f), dtype=torch.bfloat16, device=dev)
    out = torch.empty((r, d), dtype=torch.float32, device=dev)
    from ttasr_torch.ops._build import launch

    part, sync, sched, *ints = _persistent_args(dev, d, f, r, cross=False)
    launch("ttasr_mlp_int8", dev, x, ln_s, ln_b, w1q, w1s, b1, w2q, w2s, b2,
           hid, out, part, sync, sched, r, d, f, int(partial), *ints)
    count_launch(mlp_int8_fused)
    return out


mlp_int8_fused.launches = 0
