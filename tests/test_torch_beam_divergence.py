"""The port's ``check_beam_divergence`` against the JAX tool on the CPU:
the report on two ``micro64-test`` windows (beam 5, 16 tokens) equals
the JAX tool's on the same weights (the JAX tool in a subprocess, its
``init_params(cfg, seed=0)`` in bf16 moved by ``params_from_jax``; on the
CPU the port's legs run the plain versions, so they differ only by
arithmetic), and the flags' rules are the original's.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ttasr.models.whisper.config import PRESETS as J_PRESETS
from ttasr.models.whisper.model import init_params as j_init
from ttasr_torch.models.whisper.config import PRESETS as T_PRESETS
from ttasr_torch.models.whisper.load import params_from_jax
from ttasr_torch.text.tokenizer import build_byte_fallback_tokenizer as t_tokenizer
from ttasr_torch.tools import check_beam_divergence as t_div

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAME = "micro64-test"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_beam_divergence_report_matches_jax(tmp_path):
    out = str(tmp_path / "jax.json")
    args = ["--model", NAME, "--windows", "2", "--sample-len", "16"]
    proc = subprocess.run([sys.executable, os.path.join(REPO, "tools",
                                                        "check_beam_divergence.py"),
                           *args, "--out-json", out], capture_output=True, text=True,
                          cwd=REPO, timeout=600,
                          env=dict(os.environ, JAX_COMPILATION_CACHE_DIR=str(tmp_path)))
    assert proc.returncode == 0, proc.stderr[-2000:]
    with open(out) as fh:
        want = json.load(fh)
    # the JAX tool's weights: init_params(cfg, seed=0) in bf16
    params = params_from_jax(jax.tree.map(
        np.asarray, j_init(J_PRESETS[NAME], seed=0, dtype=jnp.bfloat16)),
        dtype=torch.bfloat16)
    got = t_div.divergence_report(params, T_PRESETS[NAME], t_tokenizer(),
                                  t_div.windows_audio(2), sample_len=16)
    assert got == want
    # the legs of the other A/Bs, on the plain versions
    for ab in ("encoder-act8", "encoder-fused-quant"):
        names = [leg[0] for leg in t_div.legs(params, ab, False, 5, 16)]
        assert names == ["unfused", "fused"]
    with pytest.raises(SystemExit):
        t_div.main(["--ab", "encoder-act8", "--cross-int4", "--device", "cpu"])
