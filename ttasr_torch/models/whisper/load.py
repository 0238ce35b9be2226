"""Checkpoint import (port of ``ttasr/models/whisper/load.py``).

HF Whisper weights -> the port's parameter dict, with the JAX package's
leaf names and layouts: torch ``Linear.weight`` (out, in) is transposed to
(in, out), conv1d weight (out, in, k) becomes (k, in, out), and the
decoder/encoder layers become a list of per-layer dicts.
:func:`params_from_jax` takes the JAX package's stacked parameter tree (as
numpy arrays) so that both packages can compute the same function; its
quantized ``{"q", "s"}`` leaves (``ttasr/ops/quant.py``) stay int8 codes
and f32 scales, unstacked per layer like every other leaf.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ttasr_torch.models.whisper.config import WhisperConfig, get_config
from ttasr_torch.models.whisper.model import init_params, unstack_blocks

_ENC_BLOCK_MAP = {
    "self_attn.q_proj.weight": ("wq", "linear"),
    "self_attn.q_proj.bias": ("bq", "bias"),
    "self_attn.k_proj.weight": ("wk", "linear"),
    "self_attn.v_proj.weight": ("wv", "linear"),
    "self_attn.v_proj.bias": ("bv", "bias"),
    "self_attn.out_proj.weight": ("wo", "linear"),
    "self_attn.out_proj.bias": ("bo", "bias"),
    "self_attn_layer_norm.weight": ("ln1_s", "bias"),
    "self_attn_layer_norm.bias": ("ln1_b", "bias"),
    "fc1.weight": ("w1", "linear"),
    "fc1.bias": ("b1", "bias"),
    "fc2.weight": ("w2", "linear"),
    "fc2.bias": ("b2", "bias"),
    "final_layer_norm.weight": ("ln2_s", "bias"),
    "final_layer_norm.bias": ("ln2_b", "bias"),
}

_DEC_EXTRA_MAP = {
    "encoder_attn.q_proj.weight": ("wq_c", "linear"),
    "encoder_attn.q_proj.bias": ("bq_c", "bias"),
    "encoder_attn.k_proj.weight": ("wk_c", "linear"),
    "encoder_attn.v_proj.weight": ("wv_c", "linear"),
    "encoder_attn.v_proj.bias": ("bv_c", "bias"),
    "encoder_attn.out_proj.weight": ("wo_c", "linear"),
    "encoder_attn.out_proj.bias": ("bo_c", "bias"),
    "encoder_attn_layer_norm.weight": ("lnc_s", "bias"),
    "encoder_attn_layer_norm.bias": ("lnc_b", "bias"),
}


def _to_tensor(x, dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32)).to(
        device=device, dtype=dtype)


def _quantized_leaf(val, device) -> Dict[str, torch.Tensor]:
    return {"q": torch.from_numpy(np.array(val["q"], np.int8)).to(device),
            "s": torch.from_numpy(np.array(val["s"], np.float32)).to(device)}


def _convert_tree(tree, dtype, device):
    """Nested dict of numpy arrays (stacked layers) -> port params; float
    leaves take ``dtype``, quantized leaves keep int8 codes and f32
    scales."""
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict) and set(val) == {"q", "s"}:
            out[key] = _quantized_leaf(val, device)
        elif isinstance(val, dict):
            sub = _convert_tree(val, dtype, device)
            out[key] = unstack_blocks(sub) if key == "blocks" else sub
        else:
            out[key] = _to_tensor(val, dtype, device)
    return out


def params_from_jax(tree, dtype=torch.float32, device="cpu") -> Dict[str, Any]:
    """The JAX package's parameter pytree (numpy or jax arrays, stacked
    layer axes; float or ``quantize_params``/``fuse_qkv`` int8 weights)
    -> the port's parameter dict."""
    return _convert_tree(tree, dtype, device)


def _stack_blocks(sd, prefix, n_layers, mapping):
    out = {}
    for suffix, (name, kind) in mapping.items():
        stack = [sd[f"{prefix}.layers.{i}.{suffix}"] for i in range(n_layers)]
        if kind == "linear":
            stack = [w.T for w in stack]
        out[name] = np.stack(stack, axis=0)
    return out


def params_from_state_dict(sd: Dict[str, np.ndarray], cfg: WhisperConfig,
                           dtype=torch.float32, device="cpu") -> Dict[str, Any]:
    """Convert an HF Whisper state dict (numpy values) to port params."""
    sd = {k[len("model."):] if k.startswith("model.") else k: v for k, v in sd.items()}
    dec_map = dict(_ENC_BLOCK_MAP)
    dec_map.update(_DEC_EXTRA_MAP)
    tree = {
        "encoder": {
            "conv1_w": sd["encoder.conv1.weight"].transpose(2, 1, 0),
            "conv1_b": sd["encoder.conv1.bias"],
            "conv2_w": sd["encoder.conv2.weight"].transpose(2, 1, 0),
            "conv2_b": sd["encoder.conv2.bias"],
            "pos": sd["encoder.embed_positions.weight"],
            "blocks": _stack_blocks(sd, "encoder", cfg.encoder_layers, _ENC_BLOCK_MAP),
            "ln_s": sd["encoder.layer_norm.weight"],
            "ln_b": sd["encoder.layer_norm.bias"],
        },
        "decoder": {
            "embed": sd["decoder.embed_tokens.weight"],
            "pos": sd["decoder.embed_positions.weight"],
            "blocks": _stack_blocks(sd, "decoder", cfg.decoder_layers, dec_map),
            "ln_s": sd["decoder.layer_norm.weight"],
            "ln_b": sd["decoder.layer_norm.bias"],
        },
    }
    return _convert_tree(tree, dtype, device)


def _numpy_state_dict_from_torch(module) -> Dict[str, np.ndarray]:
    return {k: v.detach().to("cpu").float().numpy() for k, v in module.state_dict().items()}


def params_from_hf_model(hf_model, dtype=torch.float32, device="cpu"
                         ) -> Tuple[Dict[str, Any], WhisperConfig]:
    """Convert a live transformers WhisperForConditionalGeneration /
    WhisperModel -> (port params on ``device``, config)."""
    cfg = WhisperConfig.from_hf_config(hf_model.config)
    return params_from_state_dict(_numpy_state_dict_from_torch(hf_model), cfg,
                                  dtype, device), cfg


def _read_safetensors_dir(path: str) -> Dict[str, np.ndarray]:
    index_path = os.path.join(path, "model.safetensors.index.json")
    single = os.path.join(path, "model.safetensors")
    if not (os.path.exists(index_path) or os.path.exists(single)):
        raise FileNotFoundError(f"no safetensors weights under {path}")
    from safetensors.numpy import load_file

    sd: Dict[str, np.ndarray] = {}
    if os.path.exists(index_path):
        with open(index_path, encoding="utf-8") as fh:
            index = json.load(fh)
        for shard in sorted(set(index["weight_map"].values())):
            sd.update(load_file(os.path.join(path, shard)))
    else:
        sd.update(load_file(single))
    return sd


def load_whisper(path_or_name: str, dtype=torch.float32, device="cuda",
                 seed: int = 0) -> Tuple[Dict[str, Any], WhisperConfig]:
    """Load (params, config) from an HF checkpoint dir (safetensors, else
    ``pytorch_model.bin``), or random-init a preset directly on ``device``
    from a generator seeded with ``seed``."""
    if os.path.isdir(path_or_name):
        cfg = get_config(path_or_name)
        pt = os.path.join(path_or_name, "pytorch_model.bin")
        try:
            sd = _read_safetensors_dir(path_or_name)
        except FileNotFoundError:
            if not os.path.exists(pt):
                raise
            sd = {k: v.float().numpy() for k, v in
                  torch.load(pt, map_location="cpu", weights_only=True).items()}
        return params_from_state_dict(sd, cfg, dtype, device), cfg
    cfg = get_config(path_or_name)
    return init_params(cfg, seed=seed, dtype=dtype, device=device), cfg
