"""Warm the serving shapes on the card before routing traffic (port of
``ttasr/cli/warmup.py``).

Walks the reachable (program, shape) census (:mod:`ttasr_torch.core.census`,
the reference's enumeration over the port's own buckets) and runs each
entry once with minimal inputs and the ``BatchServer``'s
``DecodingOptions``, after building the hand-written CUDA kernels.

What warming buys on the card: the kernel library is built by ``nvcc`` (or
found under ``ttasr_torch/_build/``, named by a hash of the sources), and
before the first request the process holds cuBLAS's handles and its
heuristics' picks for the served shapes, the caching allocator's blocks,
and the kernels' host-side state (tensor maps, shared-memory limits).
What it does not buy: the port decodes eagerly and compiles no programs,
so there is no persistent compile cache to ship as a deploy artefact; a
new process repeats this warm-up, less the ``nvcc`` build, which stays on
disk.

Usage:

    python -m ttasr_torch.cli.warmup --model large-v3 --slots 8
    python -m ttasr_torch.cli.warmup --dry-run          # list, run nothing

The device is ``cuda`` unless ``--device cpu`` is asked for (micro models);
without CUDA it raises.  The API servers' ``FASTAPI_WARMUP`` covers only the
streaming buckets at startup; this covers the full surface.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np

from ttasr_torch.ops._build import BUILD_DIR


def cache_entries() -> int:
    """Files in the build directory (the kernel and native libraries)."""
    try:
        return len(os.listdir(BUILD_DIR))
    except OSError:
        return 0


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        description="warm the reachable serving shapes on the card")
    parser.add_argument("--model", default="large-v3")
    parser.add_argument("--compute", default="int8")
    parser.add_argument("--slots", type=int, default=8,
                        help="BatchServer batch size (every group pads "
                             "to this)")
    parser.add_argument("--beam", type=int, default=5)
    parser.add_argument("--streams", choices=("on", "off"), default="on")
    parser.add_argument("--file-api", choices=("on", "off"), default="on")
    parser.add_argument("--cli", choices=("on", "off"), default="off",
                        help="also warm the sequential batch-1 "
                             "engine.transcribe shapes")
    parser.add_argument("--dry-run", action="store_true",
                        help="list the programs without running them")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="cpu: micro models on the kernels' plain "
                             "versions; cuda raises when absent")
    args = parser.parse_args(argv)

    from ttasr_torch.core.census import census

    programs = census(args.slots, beam_size=args.beam,
                      streaming=args.streams == "on",
                      file_api=args.file_api == "on",
                      sequential_cli=args.cli == "on")
    print(f"warming {len(programs)} reachable programs "
          f"(build dir {BUILD_DIR}, {cache_entries()} entries before)",
          flush=True)
    if args.dry_run:
        for fam, key, why in programs:
            print(json.dumps({"family": fam, "key": list(key), "why": why}))
        return

    import torch

    from ttasr_torch import resolve_device
    from ttasr_torch.engine.transcriber import WhisperEngine
    from ttasr_torch.models.whisper.decode import DecodingOptions, pad_prompts
    from ttasr_torch.ops import _build

    device = resolve_device(args.device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    if device.type == "cuda":
        t0 = time.perf_counter()
        _build.load_library()
        print(json.dumps({"stage": "kernel_build",
                          "s": round(time.perf_counter() - t0, 3)}), flush=True)

    t0 = time.perf_counter()
    engine = WhisperEngine(args.model, compute_type=args.compute, device=device)
    sync()
    print(json.dumps({"stage": "engine_init",
                      "s": round(time.perf_counter() - t0, 3)}), flush=True)

    # BatchServer-identical DecodingOptions (ttasr_torch/engine/serving.py):
    # a near-miss variant would warm a shape the server never dispatches
    kv_int8 = engine.kv_cache_int8
    base_opts = DecodingOptions(
        beam_size=args.beam, sample_len=224, without_timestamps=False,
        kv_int8=kv_int8,
        cross_kv_int8=kv_int8 and engine.compute_type == "int8",
        cross_kv_int4=kv_int8 and engine.cross_kv_int4,
        kv_int4=kv_int8 and engine.kv_int4,
    )

    enc_cache = {}

    def enc_for(b, win):
        if (b, win) not in enc_cache:
            enc_cache[(b, win)] = engine.encode_windows(
                np.zeros((b, win), np.int16), window_samples=win)
        return enc_cache[(b, win)]

    def prompt_rows(b, width):
        sot = engine.tokenizer.sot_sequence("zh", "transcribe",
                                            predict_timestamps=True)
        row = (list(sot) + [engine.ti.eot] * width)[:width]
        return pad_prompts([row] * b, engine.ti.eot)

    total = 0.0
    for fam, key, why in programs:
        t0 = time.perf_counter()
        if fam == "encoder":
            b, win, _dtype = key
            enc_for(b, win)
        elif fam in ("beam_decode", "greedy_decode"):
            if len(key) == 5:            # streaming: (b, p, win, budget, bm)
                b, p, win, budget = key[:4]
            else:                        # file/task: (b, p, budget[, bm])
                b, p, budget = key[:3]
                win = 480000
            enc_out = enc_for(b, win)
            prompt, pad = prompt_rows(b, p)
            opts = dataclasses.replace(base_opts, sample_len=budget)
            rng = torch.Generator(device=device).manual_seed(0)
            if fam == "beam_decode":
                out = engine.run_beam_decode(enc_out, prompt, pad, rng,
                                             opts=opts)
            else:
                temps = np.full((b,), 0.2, np.float32)
                out = engine.run_greedy_decode(enc_out, prompt, pad, rng,
                                               temps, opts=opts)
            out["tokens"].cpu()          # wait for the decode
        elif fam == "lang_logits":
            engine.detect_language(np.zeros((16000,), np.float32))
        else:                            # unknown family: census grew —
            print(json.dumps({"family": fam, "key": list(key),
                              "skipped": "no warmup driver"}), flush=True)
            continue
        sync()
        dt = time.perf_counter() - t0
        total += dt
        print(json.dumps({"family": fam, "key": list(key),
                          "s": round(dt, 3)}), flush=True)

    print(json.dumps({"warmup_total_s": round(total, 3),
                      "programs": len(programs),
                      "cache_entries_after": cache_entries()}), flush=True)


if __name__ == "__main__":
    main()
