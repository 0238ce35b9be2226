"""Where a main-path beam step's time goes, on the card (the counterpart of
``tools/profile_decode.py``).

Builds the main path's decode state at large-v3 (random weights from seed
0, int8 with fused q/k/v, int4 self- and cross-KV, beam search through the
ancestry map) for ``--batch`` audios of ``--beam`` beams with the next
token at slot ``--len`` - 8, and runs the program's own beam step
(``decode._beam_step``) once with its stage functions wrapped from outside,
keeping each call's arguments: ``_rules_logprobs``, ``_top_k``,
``_update_finished``, ``_survivors`` and ``_permute_ancestry`` (the
ancestry permute), B1-B4 of every layer and ``_unembed``.  Each stage's
calls are then captured in a CUDA graph and replayed: milliseconds per
call on CUDA events over the replays, and the kernels' device time per
call from ``torch.profiler`` (the most of three tries: the profiler has
dropped kernel records on this card).  A layer stage replays all the layers' calls
(each its own weights and caches, as the step meets them).  The step's
other work (embedding, casts, cache writes, the final LayerNorm, the
candidate arithmetic and the state's gathers) is one more stage: the step
with every wrapped stage returning its kept output.

Then the whole eager step: its wall (host clock around a synchronised
step, median of ``--repeats`` * 4), and its device time and kernel count
from ``torch.profiler`` (the most of three tries).  Prints one JSON line a stage, then a table in
which the stages' device times per step are held to the step's device
time (within 10 %) and the step's busy share is its device time over its
wall.  The tool adds no span or counter to the program.

Usage: python -m ttasr_torch.tools.profile_decode [--batch 8] [--beam 5]
       [--len 144] [--repeats 5] [--device cuda]
It needs the card: ``--device cpu`` is refused (the graphs and the
profiler's device time exist only there).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import sys
import time

# the wrapped stage functions of decode.py; those of LAYER_STAGES run once
# per decoder layer, the others once per step
STAGES = ("_rules_logprobs", "_top_k", "_update_finished", "_survivors",
          "_permute_ancestry", "qkv_int8_fused", "self_attn_step_indirect_int8",
          "attnout_ln_q_cross_int8", "mlp_with_crossout_int8", "_unembed")
LAYER_STAGES = frozenset(STAGES[5:9])
LABELS = {"_rules_logprobs": "_apply_rules_logprobs", "_top_k": "top-k",
          "_update_finished": "finished-set update",
          "_survivors": "ancestry permute: survivors",
          "_permute_ancestry": "ancestry permute: map",
          "qkv_int8_fused": "B1 per layer", "self_attn_step_indirect_int8": "B2 per layer",
          "attnout_ln_q_cross_int8": "B3 per layer", "mlp_with_crossout_int8": "B4 per layer",
          "_unembed": "unembed", "glue": "the step's other work"}
SUM_TOLERANCE = 0.10
PROFILER_TRIES = 3
MODEL = "large-v3"


def decode_state(batch: int, beam: int, cache_len: int, device, seed: int = 0):
    """(params, cfg, state, context, step) of the main path's beam loop at
    slot ``cache_len`` - 8: the prompt prefilled and tiled over the beams,
    a random ancestry map, random logits and a random live state."""
    import torch

    from ttasr_torch.models.whisper import decode as dm
    from ttasr_torch.models.whisper.config import get_config
    from ttasr_torch.models.whisper.model import init_cache, init_params
    from ttasr_torch.ops.quant import fuse_qkv, quantize_params
    from ttasr_torch.text.tokenizer import build_byte_fallback_tokenizer

    cfg = get_config(MODEL)
    tok = build_byte_fallback_tokenizer()
    params = dm._f32_decoder_vectors(fuse_qkv(quantize_params(
        init_params(cfg, seed=seed, dtype=torch.bfloat16, device=device))))
    del params["encoder"]  # the decode step never reads it
    ti = dm.TokenizerInfo.from_tokenizer(tok, n_vocab=cfg.vocab_size)
    gen = torch.Generator(device=device).manual_seed(seed)
    s_real = cfg.max_source_positions
    enc_out = torch.randn((batch, s_real, cfg.d_model), generator=gen,
                          device=device).to(torch.bfloat16)
    prompt, pad = dm.pad_prompts(
        [tok.sot_sequence("zh", "transcribe", predict_timestamps=True)] * batch, tok.eot)
    max_prompt = prompt.shape[1]
    step = cache_len - 8 - max_prompt
    if step < 1:
        raise ValueError(f"--len {cache_len} leaves no decoded token after the "
                         f"{max_prompt}-slot prompt")
    sample_len = cache_len - max_prompt
    opts = dm.DecodingOptions(beam_size=beam, sample_len=sample_len, kv_int8=True,
                              cross_kv_int8=True, cross_kv_int4=True, kv_int4=True)
    with torch.inference_mode():
        cache = init_cache(params, cfg, enc_out, max_len=cache_len,
                           **dm._cache_flags(params, cfg, opts))
        prompt_t, pad_t = dm._prompt_tensors(prompt, pad, device)
        _, cache = dm._prefill(params, cfg, prompt_t, pad_t, cache, s_real)
    cache = dm._tile_cache_rows(cache, beam)
    check_flat = cache.quantized and cache.flat and cache.self_int4
    if not check_flat:
        raise RuntimeError("the main path's flat int4 cache was not built")
    bk = batch * beam
    own_row = (torch.arange(bk, device=device) % beam).to(torch.int32)

    def rand_ids(*shape, high=ti.timestamp_begin):
        return torch.randint(0, high, shape, generator=gen, device=device)

    logits = torch.randn((bk, ti.n_vocab), generator=gen, device=device) * 3.0
    st = dm._BeamLoop(
        tokens=rand_ids(bk, sample_len), n=torch.full((bk,), step, device=device),
        cum_logprob=-torch.rand((bk,), generator=gen, device=device) * step,
        last=rand_ids(bk), penult=rand_ids(bk),
        max_ts=torch.zeros((bk,), dtype=torch.long, device=device),
        logits=logits, finite=torch.isfinite(logits).all(),
        fin_tokens=torch.full((batch, beam, sample_len), ti.eot, dtype=torch.long,
                              device=device),
        fin_len=torch.zeros((batch, beam), dtype=torch.long, device=device),
        fin_logprob=torch.full((batch, beam), dm.NEG_INF, dtype=torch.float32,
                               device=device),
        fin_count=torch.zeros((batch,), dtype=torch.long, device=device),
        cache=cache,
        anc=torch.randint(0, beam, (bk, cache_len), generator=gen, device=device,
                          dtype=torch.int32))
    ctx = dm._BeamContext(
        ti=ti, opts=opts,
        static_mask=torch.from_numpy(dm._static_suppress_mask(ti)).to(device),
        max_prompt=max_prompt, own_row=own_row,
        pad_rep=pad_t.repeat_interleave(beam), s_real=s_real, tp=())
    return params, cfg, st, ctx, step


class StageCalls:
    """Wraps the stage functions of ``decode.py`` from outside: inside
    :meth:`recording` each call's arguments and output are kept; inside
    :meth:`stubbed` each returns, in call order, the output it gave."""

    def __init__(self, names):
        self.names = tuple(names)
        self.calls = {name: [] for name in self.names}

    @contextlib.contextmanager
    def _patched(self, make):
        from ttasr_torch.models.whisper import decode as dm

        saved = {name: getattr(dm, name) for name in self.names}
        try:
            for name in self.names:
                setattr(dm, name, make(name, saved[name]))
            yield
        finally:
            for name, fn in saved.items():
                setattr(dm, name, fn)

    def recording(self):
        def make(name, fn):
            def recorded(*args, **kwargs):
                out = fn(*args, **kwargs)
                self.calls[name].append((args, kwargs, out))
                return out
            return recorded
        return self._patched(make)

    def stubbed(self):
        outs = {name: iter([out for _, _, out in self.calls[name]]) for name in self.names}
        return self._patched(lambda name, fn: lambda *args, **kwargs: next(outs[name]))

    def replay(self, name):
        """A callable that makes every kept call of ``name`` again."""
        from ttasr_torch.models.whisper import decode as dm

        fn, calls = getattr(dm, name), self.calls[name]
        return lambda: [fn(*args, **kwargs) for args, kwargs, _ in calls]


def _kernel_time(run, calls: int):
    """Device ms and kernels per call of ``run()`` (``calls`` calls) under
    ``torch.profiler``: the most of PROFILER_TRIES tries, since the profiler
    has been seen to drop kernel records on this card, and each try."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    tries = []
    for _ in range(PROFILER_TRIES):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        tries.append((sum(e.self_device_time_total for e in kernels) / 1e3 / calls,
                      sum(e.count for e in kernels) / calls))
    return max(tries), [round(ms, 4) for ms, _ in tries]


def graph_times(fn, replays: int) -> dict:
    """``fn`` captured once in a CUDA graph: ms per replay on CUDA events,
    and the kernels' device ms and count per replay from ``torch.profiler``
    (None where the profiler records no kernel of the graph)."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    for _ in range(3):
        graph.replay()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    event_ms = start.elapsed_time(end) / replays
    (device_ms, kernels), tries = _kernel_time(
        lambda: [graph.replay() for _ in range(replays)], replays)
    del graph
    return dict(event_ms=event_ms, device_ms=device_ms or None, kernels=kernels,
                device_ms_tries=tries)


def eager_step(params, cfg, st, ctx, step, repeats: int) -> dict:
    """The program's beam step, eager: the median wall of ``4 * repeats``
    synchronised steps, then the device ms and kernels per step of
    ``repeats`` steps under ``torch.profiler``."""
    import torch

    from ttasr_torch.models.whisper import decode as dm

    walls = []
    for i in range(4 * repeats + 2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dm._beam_step(params, cfg, st, step, ctx)
        torch.cuda.synchronize()
        if i >= 2:
            walls.append((time.perf_counter() - t0) * 1e3)
    (device_ms, kernels), tries = _kernel_time(
        lambda: [dm._beam_step(params, cfg, st, step, ctx) for _ in range(repeats)], repeats)
    return dict(wall_ms=statistics.median(walls), device_ms=device_ms, kernels=kernels,
                device_ms_tries=tries)


def profile_step(batch: int = 8, beam: int = 5, cache_len: int = 144,
                 repeats: int = 5, device="cuda") -> dict:
    """Each stage of the main path's beam step and the whole eager step;
    prints a JSON line a stage and the table, returns the summary."""
    import torch

    from ttasr_torch import resolve_device
    from ttasr_torch.models.whisper import decode as dm
    from ttasr_torch.ops import _build

    device = resolve_device(device)
    if device.type != "cuda":
        raise RuntimeError("profile_decode measures the card: CUDA graphs and the "
                           "profiler's device time; --device cpu is refused")
    if beam < 2:
        raise ValueError("profile_decode profiles the beam step: --beam must be >= 2")
    _build.load_library()
    card = torch.cuda.get_device_name(device)
    params, cfg, st, ctx, step = decode_state(batch, beam, cache_len, device)
    n_layers = cfg.decoder_layers
    shapes = f"b{batch} k{beam} len{cache_len}"
    with torch.inference_mode():
        for _ in range(2):  # warm: the kernels' tensor maps, the allocator
            dm._beam_step(params, cfg, st, step, ctx)
        stages = StageCalls(STAGES)
        with stages.recording():
            dm._beam_step(params, cfg, st, step, ctx)
        per_step = {name: n_layers if name in LAYER_STAGES else 1 for name in STAGES}
        for name, calls in per_step.items():
            if len(stages.calls[name]) != calls:
                raise RuntimeError(f"{name}: {len(stages.calls[name])} calls in one step, "
                                   f"expected {calls}: not the main path's step")
        whole = eager_step(params, cfg, st, ctx, step, repeats)
        rows = []
        for name, calls in per_step.items():
            t = graph_times(stages.replay(name), repeats * 4)
            rows.append(dict(stage=LABELS[name], calls_per_step=calls, **{
                k: (None if v is None else [round(x / calls, 5) for x in v]
                    if k == "device_ms_tries" else v / calls) for k, v in t.items()}))

        def glue():
            with stages.stubbed():
                dm._beam_step(params, cfg, st, step, ctx)

        rows.append(dict(stage=LABELS["glue"], calls_per_step=1,
                         **graph_times(glue, repeats * 4)))
    for row in rows:
        per_call = row["device_ms"] if row["device_ms"] is not None else row["event_ms"]
        row["ms_per_step"] = per_call * row["calls_per_step"]
        row["share_of_step"] = row["ms_per_step"] / whole["device_ms"]
        print(json.dumps({"shapes": shapes, **row}), flush=True)
    stage_sum = sum(row["ms_per_step"] for row in rows)
    summary = dict(
        shapes=shapes, card=card, step_wall_ms=whole["wall_ms"],
        step_device_ms=whole["device_ms"], step_device_ms_tries=whole["device_ms_tries"],
        step_kernels=whole["kernels"],
        busy_share=whole["device_ms"] / whole["wall_ms"], stage_sum_ms=stage_sum,
        stage_sum_over_step=stage_sum / whole["device_ms"],
        device_times_from=("profiler" if all(r["device_ms"] is not None for r in rows)
                           else "events where the profiler saw no graph kernel"))
    summary["sum_checks"] = abs(summary["stage_sum_over_step"] - 1.0) <= SUM_TOLERANCE
    print(f"\n{'stage':32s} {'calls':>5s} {'ms/call (events)':>17s} "
          f"{'device ms/call':>15s} {'ms/step':>9s} {'share':>7s}")
    for row in rows:
        dev = "-" if row["device_ms"] is None else f"{row['device_ms']:.4f}"
        print(f"{row['stage']:32s} {row['calls_per_step']:5d} {row['event_ms']:17.4f} "
              f"{dev:>15s} {row['ms_per_step']:9.4f} {row['share_of_step']:7.1%}")
    print(f"{'sum of the stages':32s} {'':5s} {'':17s} {'':15s} {stage_sum:9.4f} "
          f"{summary['stage_sum_over_step']:7.1%}")
    print(f"{'eager step (device)':32s} {'':5s} {'':17s} {'':15s} "
          f"{whole['device_ms']:9.4f}   ({whole['kernels']:.0f} kernels)")
    print(f"{'eager step (wall)':32s} {'':5s} {'':17s} {'':15s} {whole['wall_ms']:9.4f}   "
          f"busy {summary['busy_share']:.1%}")
    print(f"stage sum within {SUM_TOLERANCE:.0%} of the step's device time: "
          f"{summary['sum_checks']} ({card})")
    print(json.dumps({"profile_decode": summary}), flush=True)
    return summary


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--beam", type=int, default=5)
    p.add_argument("--len", type=int, dest="cache_len", default=144)
    p.add_argument("--repeats", type=int, default=5)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return p


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    summary = profile_step(args.batch, args.beam, args.cache_len, args.repeats,
                           args.device)
    if not summary["sum_checks"]:
        sys.exit(1)
    return summary


if __name__ == "__main__":
    main()
