"""Per-card memory of sharded training, reckoned from the port's own specs
(the port of ``tools/memory_accounting.py``).

For a model on a ``(data, model)`` mesh, or a multislice ``(dcn_data,
data, model)`` one, it counts what each card holds through a train step of
``ttasr_torch.train.train_step.make_train_step(mesh=...)``: the f32 master
params (``shard_params``' slices by ``param_pspecs``), grads of the same
shape, AdamW's two moments as ZeRO-1 slices (``zero1_moment_spec``) and,
for comparison, as the param slices whole, and an analytic activation
estimate (remat: the layer-boundary residuals in bf16, the decoder's f32
logits and log-softmax, the mel), each in GiB against the H100's 80 GB:

    python -m ttasr_torch.tools.memory_accounting --model large-v3 --data 4 --model-axis 2

Shapes come from ``init_params`` on the meta device: nothing is allocated
and no card is needed.  The port stores a layer per dict where the JAX
package stacks them, so a block leaf's ZeRO-1 dimension differs from
JAX's (``sharding``'s docstring); the bytes differ only by the column-split
biases, whose one dimension the model axis takes.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Optional

import numpy as np

CARD_GIB = 80e9 / 2**30  # the H100's 80 GB of HBM3


def account(model: str = "large-v3", data: int = 4, model_axis: int = 2,
            batch: int = 4, dcn: int = 1, layers: Optional[int] = None) -> dict:
    """{"model", "mesh", "batch_global", "per_chip_gb": {...}} as the JAX
    tool's ``account`` gives, from the port's specs (GiB per card);
    ``layers`` cuts the encoder and the decoder to that depth."""
    from ttasr_torch.core.checkpoint import named_leaves
    from ttasr_torch.models.whisper.config import get_config
    from ttasr_torch.models.whisper.model import init_params
    from ttasr_torch.parallel.sharding import (
        Mesh,
        leaf_specs,
        mesh_coords,
        moment_specs,
        slice_shape,
    )

    cfg = get_config(model)
    if layers is not None:
        cfg = dataclasses.replace(cfg, encoder_layers=layers, decoder_layers=layers)
    shape = ({"dcn_data": dcn, "data": data, "model": model_axis} if dcn > 1
             else {"data": data, "model": model_axis})
    mesh = Mesh(shape=shape, coords=mesh_coords(shape, 0), groups={})
    params = init_params(cfg, device="meta")
    leaves = named_leaves(params)
    pspecs, mspecs = leaf_specs(params, mesh), moment_specs(params, mesh)

    def nbytes(specs):
        return sum(int(np.prod(slice_shape(v.shape, specs[k], mesh))) * v.element_size()
                   for k, v in leaves.items())

    param_b = nbytes(pspecs)
    grad_b = param_b  # the grads take the params' slices
    moments_b = 2 * nbytes(mspecs)  # mu and nu
    moments_repl_b = 2 * param_b

    # the JAX tool's analytic estimate at the reference's shape (30 s
    # windows): remat keeps the layer-boundary residuals (bf16), the mel,
    # and the decoder's logits and log-softmax (f32, the largest pair)
    b_local = max(batch // (data * dcn), 1)
    seq_e, seq_d, d = cfg.max_source_positions, 448, cfg.d_model
    resid = (cfg.encoder_layers * b_local * seq_e * d
             + cfg.decoder_layers * b_local * seq_d * d) * 2
    logits = 2 * b_local * seq_d * cfg.vocab_size * 4
    mel = b_local * cfg.num_mel_bins * 3000 * 4
    act_b = resid + logits + mel

    total = param_b + grad_b + moments_b + act_b
    return {
        "model": model if layers is None else f"{model}, {layers} + {layers} layers",
        "mesh": dict(shape),
        "batch_global": batch,
        "per_chip_gb": {
            "params_f32": param_b / 2**30,
            "grads_f32": grad_b / 2**30,
            "adamw_moments_zero1": moments_b / 2**30,
            "adamw_moments_if_replicated": moments_repl_b / 2**30,
            "activations_est": act_b / 2**30,
            "total": total / 2**30,
            "total_if_replicated_moments": (
                param_b + grad_b + moments_repl_b + act_b) / 2**30,
        },
    }


def engine_params(model: str = "large-v3", compute_type: str = "int8", data: int = 1,
                  model_axis: int = 4) -> dict:
    """The bytes of params one rank of ``WhisperEngine(mesh=create_mesh(data,
    model_axis))`` keeps: ``shard_params``' slices of the tree the engine
    quantizes (int8: ``quantize_params`` of the bfloat16 weights, unfused;
    bfloat16, float32: the weights), reckoned from the shapes on the meta
    device.  {"per_rank": {...}, "whole": {...}}, each with ``encoder``,
    ``decoder``, ``total`` and, int8, ``encoder_codes`` (the encoder's int8
    codes alone), in bytes."""
    import torch

    from ttasr_torch.core.checkpoint import named_leaves
    from ttasr_torch.models.whisper.config import get_config
    from ttasr_torch.models.whisper.model import init_params
    from ttasr_torch.ops.quant import quantize_params
    from ttasr_torch.parallel.sharding import Mesh, leaf_specs, mesh_coords, slice_shape

    dtype = {"int8": torch.bfloat16, "bfloat16": torch.bfloat16,
             "float32": torch.float32}[compute_type]
    shape = {"data": data, "model": model_axis}
    mesh = Mesh(shape=shape, coords=mesh_coords(shape, 0), groups={})
    params = init_params(get_config(model), dtype=dtype, device="meta")
    if compute_type == "int8":
        params = quantize_params(params)
    specs = leaf_specs(params, mesh)
    out = {"per_rank": {}, "whole": {}}
    for path, leaf in named_leaves(params).items():
        whole = leaf.numel() * leaf.element_size()
        mine = int(np.prod(slice_shape(leaf.shape, specs[path], mesh))) * leaf.element_size()
        keys = [path.split(".")[0], "total"]
        if path.startswith("encoder.") and leaf.dtype == torch.int8:
            keys.append("encoder_codes")
        for key in keys:
            out["whole"][key] = out["whole"].get(key, 0) + whole
            out["per_rank"][key] = out["per_rank"].get(key, 0) + mine
    return out


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--model", default="large-v3")
    parser.add_argument("--data", type=int, default=4)
    parser.add_argument("--model-axis", type=int, default=2)
    parser.add_argument("--batch", type=int, default=4)
    parser.add_argument("--dcn", type=int, default=1)
    parser.add_argument("--layers", type=int, default=None,
                        help="cut the encoder and the decoder to this depth")
    args = parser.parse_args(argv)
    stats = account(args.model, args.data, args.model_axis, args.batch, args.dcn,
                    args.layers)
    print(f"{stats['model']} on mesh {stats['mesh']} (global batch "
          f"{stats['batch_global']}), per card against the H100's "
          f"{CARD_GIB:.1f} GiB (80 GB):")
    for k, v in stats["per_chip_gb"].items():
        print(f"  {k:34s} {v:7.2f} GiB  ({100 * v / CARD_GIB:5.1f} % of the card)")
    return stats


if __name__ == "__main__":
    main()
