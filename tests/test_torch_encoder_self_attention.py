"""B19 in the port, ``encoder_self_attention``, against the Pallas kernel
``ttasr.ops.encoder_attention_pallas.encoder_self_attention`` in interpret
mode, on seeded q/k/v (B, T, 4, 64) in float32 and bf16, at T = 150 (one
query block) and T = 600 (not a multiple of 512: two query blocks, padded
keys masked).  On the CPU the wrapper runs its plain version, which
follows B19's roundings (everything to bf16 on the way in and out); the
CUDA kernel is held to it on the card by ``chip_smoke.py``.  Tolerance
2e-3 absolute, the golden test's bound (``tests/test_mel_pallas.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ttasr.ops.encoder_attention_pallas import encoder_self_attention as j_attn
from ttasr_torch.ops import encoder_attention as t_att

TOL = 2e-3
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.mark.parametrize("b,t", [(2, 150), (1, 600)])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_matches_pallas_interpret(dtype, b, t):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(5)
    qkv = [jnp.asarray(rng.standard_normal((b, t, 4, 64)) * 0.3, jdt)
           for _ in range(3)]
    want = np.asarray(j_attn(*qkv, interpret=True), np.float32)
    # the same values in the port (bf16 -> f32 -> bf16 is exact)
    args = [torch.from_numpy(np.array(x, np.float32)).to(tdt) for x in qkv]
    before = t_att.encoder_self_attention.launches
    got = t_att.encoder_self_attention(*args)
    assert t_att.encoder_self_attention.launches == before  # plain version
    assert got.dtype == tdt and got.shape == (b, t, 4, 64)
    err = np.abs(got.float().numpy() - want).max()
    print(f"B19 {dtype} B={b} T={t}: max |port - Pallas| = {err:.3e}")
    assert err < TOL
    # B19 rounds its output to bf16 before the cast to q's type
    torch.testing.assert_close(got.to(torch.bfloat16).to(tdt), got, rtol=0, atol=0)


def test_wrapper_refuses_what_it_cannot_run():
    x = torch.zeros((1, 8, 2, 64))
    with pytest.raises(ValueError, match="meta"):
        t_att.encoder_self_attention(*(torch.empty((1, 8, 2, 64), device="meta"),) * 3)
    with pytest.raises(ValueError, match="Dh"):
        t_att.encoder_self_attention(*(torch.zeros((1, 8, 2, 32)),) * 3)
    with pytest.raises(TypeError):
        t_att.encoder_self_attention(x, x, x.half())
    with pytest.raises(ValueError, match="shape"):
        t_att.encoder_self_attention(x, x, x[:, :4])
