"""int4 nibble packing of the K/V caches (port of ``ttasr/ops/int4.py``).

Two layouts, both two's-complement nibbles with codes in -7..7:

- sublane-half along S (the cross-KV cache): a (S, D) tensor, S even,
  stores as (S/2, D) uint8 with byte ``[s, d]`` = slot ``s`` (low nibble)
  | slot ``s + S/2`` << 4;
- lanes along D (the self-KV cache): byte ``[.., c]`` = column ``c`` (low
  nibble) | column ``c + D/2`` << 4, so one slot's bytes never share a
  byte with another slot's.
"""

from __future__ import annotations

import torch

from ttasr_torch.ops.quant import quantize_kv_sym


def quantize_kv4(x):
    """Per (row, slot, head) symmetric int4 quantization: x (..., Dh) ->
    (int8 codes in [-7, 7], f32 scales (...))."""
    return quantize_kv_sym(x, levels=7)


def _nibble_decode(packed):
    """uint8 nibble pairs -> (lo, hi) int32 two's-complement values."""
    p = packed.to(torch.int32)
    return ((p & 0xF) ^ 8) - 8, ((p >> 4) ^ 8) - 8


def _pack(lo, hi):
    return ((lo.to(torch.int32) & 0xF) | ((hi.to(torch.int32) & 0xF) << 4)
            ).to(torch.uint8)


def pack_int4(q):
    """(.., S, D) int8 in [-8, 7], S even -> (.., S/2, D) uint8."""
    s = q.shape[-2]
    if s % 2:
        raise ValueError("pack_int4 needs an even slot count")
    return _pack(q[..., : s // 2, :], q[..., s // 2:, :])


def unpack_int4(packed, dtype=torch.int8):
    """(.., S/2, D) uint8 -> (.., S, D) signed values in slot order."""
    lo, hi = _nibble_decode(packed)
    return torch.cat([lo, hi], dim=-2).to(dtype)


def pack_int4_lanes(q):
    """(.., D) int8 in [-8, 7], D even -> (.., D/2) uint8."""
    d = q.shape[-1]
    if d % 2:
        raise ValueError("pack_int4_lanes needs an even column count")
    return _pack(q[..., : d // 2], q[..., d // 2:])


def unpack_int4_lanes(packed, dtype=torch.int8):
    """(.., D/2) uint8 -> (.., D) signed values in column order."""
    lo, hi = _nibble_decode(packed)
    return torch.cat([lo, hi], dim=-1).to(dtype)
