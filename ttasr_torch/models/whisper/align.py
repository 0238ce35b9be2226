"""Word-level timestamp alignment via cross-attention DTW (port of
``ttasr/models/whisper/align.py``).

Teacher-force the decoded tokens through the decoder, keep every layer's
cross-attention probabilities, average the alignment heads (the upper half
of the decoder layers when no model-specific head mask is known),
median-filter over audio frames and run monotonic DTW to give each token a
frame span; tokens merge into words (CJK characters stand alone, latin
sub-tokens merge on the no-leading-space rule).

The teacher-forced pass (:func:`decode_with_cross_attn`) is plain PyTorch
built from the model's helpers, as the reference's is plain XLA; int8
leaves go through :func:`ttasr_torch.ops.quant.quant_matmul` and a fused
``wqkv`` through :func:`ttasr_torch.models.whisper.decode._qkv_proj`.  It
runs eagerly on the tokens' true length: the reference pads them to a few
jit buckets only to bound its compiles, and the pad rows are causal-masked
history that no real row reads.  The host half (z-norm, median filter,
head mean, :func:`dtw_path`, token and word timings) is the reference's
numpy code unchanged.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ttasr_torch.models.whisper.config import WhisperConfig
from ttasr_torch.models.whisper.decode import _qkv_proj
from ttasr_torch.models.whisper.model import (
    _attention,
    _embed_lookup,
    _ln,
    _merge_heads,
    _mlp,
    _model_dtype,
    _proj,
    _split_heads,
)

TIME_PER_FRAME = 0.02


def decode_with_cross_attn(params, cfg: WhisperConfig, tokens, enc_out):
    """Teacher-forced pass returning (hidden, cross_qk).

    tokens: (B, T) int; enc_out: (B, S, d).  hidden is the last block's
    output (before the final LayerNorm), cross_qk the (L, B, H, T, S)
    attention probabilities in float32 (float64 for float64 inputs).
    Rounding as the reference: ``q * scale`` in q's type, the scores
    accumulated in float32, softmax in float32, the probabilities cast
    back to q's type before P.V."""
    dec = params["decoder"]
    b, t = tokens.shape
    x = _embed_lookup(dec, tokens) + dec["pos"][:t]
    x = x.to(_model_dtype(dec))
    causal = torch.tril(torch.ones((t, t), dtype=torch.bool,
                                   device=x.device))[None, None]
    probs_per_layer = []
    for blk in dec["blocks"]:
        h1 = _ln(x, blk["ln1_s"], blk["ln1_b"])
        q1, k1, v1 = _qkv_proj(h1, blk, cfg)
        x = x + _proj(_merge_heads(_attention(q1, k1, v1, causal)),
                      blk["wo"], blk["bo"])
        hc = _ln(x, blk["lnc_s"], blk["lnc_b"])
        q = _split_heads(_proj(hc, blk["wq_c"], blk["bq_c"]), cfg.decoder_heads)
        k = _split_heads(_proj(enc_out, blk["wk_c"]), cfg.decoder_heads)
        v = _split_heads(_proj(enc_out, blk["wv_c"], blk["bv_c"]), cfg.decoder_heads)
        probs = _cross_attn_probs(q, k)                       # (B, H, T, S)
        out = torch.matmul(probs.to(q.dtype), v.transpose(1, 2).to(q.dtype))
        x = x + _proj(_merge_heads(out.transpose(1, 2)), blk["wo_c"], blk["bo_c"])
        x = x + _mlp(_ln(x, blk["ln2_s"], blk["ln2_b"]), blk)
        probs_per_layer.append(probs)
    return x, torch.stack(probs_per_layer)


def _cross_attn_probs(q, k):
    """softmax(q.k^T / sqrt(d)) of (B, T, H, dh) q and (B, S, H, dh) k as
    (B, H, T, S): ``q * scale`` in q's type, the scores and the softmax in
    float32 (float64 for float64 inputs)."""
    acc = torch.promote_types(q.dtype, torch.float32)
    scale = q.shape[-1] ** -0.5
    scores = torch.matmul((q * scale).transpose(1, 2).to(acc),
                          k.transpose(1, 2).to(acc).transpose(-1, -2))
    return torch.softmax(scores, dim=-1)


def _median_filter(x: np.ndarray, width: int = 7) -> np.ndarray:
    """Median filter along the last axis (audio frames)."""
    if width <= 1:
        return x
    pad = width // 2
    padded = np.pad(x, [(0, 0)] * (x.ndim - 1) + [(pad, pad)], mode="reflect")
    windows = np.lib.stride_tricks.sliding_window_view(padded, width, axis=-1)
    return np.median(windows, axis=-1)


def dtw_path(cost: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Monotonic DTW through a (T_text, T_audio) cost matrix.

    Returns (text_indices, time_indices) of the optimal path.
    """
    n, m = cost.shape
    acc = np.full((n + 1, m + 1), np.inf)
    acc[0, 0] = 0.0
    trace = np.zeros((n + 1, m + 1), dtype=np.int8)
    for i in range(1, n + 1):
        row_cost = cost[i - 1]
        for j in range(1, m + 1):
            c0 = acc[i - 1, j - 1]
            c1 = acc[i - 1, j]
            c2 = acc[i, j - 1]
            best = min(c0, c1, c2)
            acc[i, j] = row_cost[j - 1] + best
            trace[i, j] = 0 if best == c0 else (1 if best == c1 else 2)
    i, j = n, m
    text_idx, time_idx = [], []
    while i > 0 and j > 0:
        text_idx.append(i - 1)
        time_idx.append(j - 1)
        t = trace[i, j]
        if t == 0:
            i, j = i - 1, j - 1
        elif t == 1:
            i -= 1
        else:
            j -= 1
    return np.asarray(text_idx[::-1]), np.asarray(time_idx[::-1])


@dataclasses.dataclass
class TokenTiming:
    token: int
    start: float
    end: float
    probability: float


def _teacher_tokens(tokenizer, text_tokens: Sequence[int]) -> Tuple[List[int], int]:
    """The forced sequence (the reference's fixed ``zh`` prefix, the text,
    eot) and the prefix's length."""
    sot_seq = tokenizer.sot_sequence("zh", "transcribe", predict_timestamps=False)
    return sot_seq + list(text_tokens) + [tokenizer.eot], len(sot_seq)


@torch.inference_mode()
def alignment_heads_qk(params, cfg: WhisperConfig, tokenizer,
                       text_tokens: Sequence[int], enc_out) -> np.ndarray:
    """The device half of :func:`align_tokens`: the teacher-forced pass over
    one window's text, and the alignment layers' (the upper half's)
    cross-attention of its first row on the host, (L', H, T, S)."""
    tokens, _ = _teacher_tokens(tokenizer, text_tokens)
    arr = torch.tensor([tokens], dtype=torch.long, device=enc_out.device)
    _hidden, cross_qk = decode_with_cross_attn(params, cfg, arr, enc_out)
    n_layers = cross_qk.shape[0]
    use_layers = list(range(n_layers // 2, n_layers)) or [n_layers - 1]
    return cross_qk[use_layers, 0].cpu().numpy()


def token_timings(tokenizer, text_tokens: Sequence[int], w: np.ndarray, *,
                  num_frames: int = 1500, medfilt_width: int = 7
                  ) -> List[TokenTiming]:
    """The host half of :func:`align_tokens` on the alignment layers'
    cross-attention ``w`` (L', H, T, S), as :func:`alignment_heads_qk`
    returns it."""
    _, n_sot = _teacher_tokens(tokenizer, text_tokens)
    w = w.reshape(-1, w.shape[-2], w.shape[-1])  # (heads, T, S)
    w = w[:, :, : num_frames]

    # z-norm per head over time, median filter, average heads
    mean = w.mean(axis=-1, keepdims=True)
    std = w.std(axis=-1, keepdims=True) + 1e-8
    w = (w - mean) / std
    w = _median_filter(w, medfilt_width)
    matrix = w.mean(axis=0)                      # (T, S)

    # restrict to the text region (skip sot prefix, keep eot row)
    start_row = n_sot
    matrix = matrix[start_row - 1 : -1]          # rows predicting text+eot
    text_idx, time_idx = dtw_path(-matrix)

    jumps = np.pad(np.diff(text_idx), (1, 0), constant_values=1).astype(bool)
    jump_times = time_idx[jumps] * TIME_PER_FRAME
    timings: List[TokenTiming] = []
    for i, tok in enumerate(text_tokens):
        start = float(jump_times[i]) if i < len(jump_times) else 0.0
        end = float(jump_times[i + 1]) if i + 1 < len(jump_times) else start
        timings.append(TokenTiming(tok, start, end, 1.0))
    return timings


def align_tokens(params, cfg: WhisperConfig, tokenizer, text_tokens: List[int],
                 enc_out, *, num_frames: int = 1500, medfilt_width: int = 7,
                 ) -> List[TokenTiming]:
    """Assign (start, end) seconds to each text token of one window."""
    w = alignment_heads_qk(params, cfg, tokenizer, text_tokens, enc_out)
    return token_timings(tokenizer, text_tokens, w, num_frames=num_frames,
                         medfilt_width=medfilt_width)


def merge_tokens_to_words(tokenizer, timings: Sequence[TokenTiming]
                          ) -> List[dict]:
    """Group token timings into words.

    CJK characters become standalone words; latin BPE pieces merge until
    the next piece starts with a space (GPT-2 byte-level convention).
    """
    words: List[dict] = []
    cur_tokens: List[int] = []
    cur_start: Optional[float] = None
    cur_end: float = 0.0

    def flush():
        nonlocal cur_tokens, cur_start, cur_end
        if cur_tokens:
            text = tokenizer.decode(cur_tokens)
            if text.strip():
                words.append({
                    "word": text,
                    "start": round(cur_start or 0.0, 2),
                    "end": round(cur_end, 2),
                })
        cur_tokens, cur_start = [], None

    for t in timings:
        piece = tokenizer.decode([t.token])
        is_cjk = any("一" <= ch <= "鿿" for ch in piece)
        starts_word = piece.startswith(" ") or is_cjk
        if starts_word and cur_tokens:
            flush()
        if cur_start is None:
            cur_start = t.start
        cur_tokens.append(t.token)
        cur_end = t.end
        if is_cjk:
            flush()
    flush()
    return words
