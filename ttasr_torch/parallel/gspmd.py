"""The GSPMD decode: every mesh the fused tensor-parallel decode refuses.

Port of the JAX engine's mesh path for those meshes
(``ttasr/engine/transcriber.py:208-238``): ``shard_params`` places the
params by ``param_pspecs`` and XLA partitions the unfused decode graph
(``ttasr/models/whisper/decode.py``'s ``beam_decode``/``greedy_decode``)
over the mesh, inserting the collectives.  Here each rank is a process
holding :func:`ttasr_torch.parallel.sharding.shard_params`' slice of the
decoder, and the port's plain layer loop reads the layout from the slices'
shapes (``decode._out_proj``, ``decode._block_mlp``,
``decode._embed_tokens``, ``decode._logits_at``): attention on the local
heads (any count), the row-split projections' partial products summed over
the model axis, a vocabulary-split embedding summed and its logits
gathered.  Float weights (float32, bfloat16) and unfused int8 weights
alike; the int8 graph keeps the 5-D int8 self-KV and an int8 cross-KV read
by B13 on the local heads, as the JAX package ignores the int4 sub-modes
off the fused path.

The batch splits over ``data`` as in :class:`ttasr_torch.parallel.tp.
TPDecoder`, whose batch split, axis binding, gathers and per-data-rank
sampling noise this shares (:class:`~ttasr_torch.parallel.tp.MeshDecoder`).
"""

from __future__ import annotations

from ttasr_torch.models.whisper.decode import _tp_gather
from ttasr_torch.ops.quant import is_quantized
from ttasr_torch.parallel.sharding import axis_group
from ttasr_torch.parallel.tp import MeshDecoder

# the attention's column-split leaves: where the model axis divides the
# width but not the heads, a shard's columns end inside a head
_HEAD_COLUMNS = ("wq", "wk", "wv", "bq", "bv", "wq_c", "wk_c", "wv_c", "bq_c", "bv_c")


class ShardedDecoder(MeshDecoder):
    """This rank's ``shard_params`` slice of the decoder (float, or
    quantized without ``fuse_qkv``) and the mesh it decodes on.
    ``params``: ``shard_params(tree, mesh)``, the slices a mesh engine
    keeps; the decoder's are held as they are (no second copy).

    Where the model axis divides d_model but not the heads (large-v3 at 8,
    tiny at 4), a shard's q/k/v columns end inside a head: each decode then
    all-gathers the attention's column slices first (wq/wk/wv, the cross
    projections, their biases and scales), runs the attentions on every
    head and keeps wo's and wo_c's row split, summing the rank's columns of
    the merged heads over the axis.  The shard keeps only its slices; the
    whole columns live for the decode."""

    def __init__(self, params, cfg, mesh):
        if "wqkv" in params["decoder"]["blocks"][0]:
            raise ValueError("the sharded decode runs the unfused graph: give it "
                             "params without fuse_qkv")
        self.params = {"decoder": params["decoder"]}
        self.cfg = cfg
        self.mesh = mesh
        n = mesh.shape["model"]
        self.heads_cut = (cfg.d_model % n == 0 and n > 1
                          and cfg.decoder_heads % n != 0)

    def _decode_params(self):
        """The params a decode reads: the shard, or with ``heads_cut`` the
        shard with its attention columns gathered whole."""
        if not self.heads_cut:
            return self.params
        group = axis_group("model")

        def whole(leaf):
            if is_quantized(leaf):
                return {"q": _tp_gather(leaf["q"], group),
                        "s": _tp_gather(leaf["s"], group)}
            return _tp_gather(leaf, group)

        dec = self.params["decoder"]
        blocks = [{k: (whole(v) if k in _HEAD_COLUMNS else v) for k, v in blk.items()}
                  for blk in dec["blocks"]]
        return {"decoder": dict(dec, blocks=blocks)}
