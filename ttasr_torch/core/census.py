"""Reachable (program, shape) census for the serving stack (copy of
``ttasr/core/census.py``).

Every distinct (program, static shape) the serving paths can hit: the
batch sizes the server pads to, the encoder windows, the prompt buckets
and the token budgets.  ``ttasr_torch.cli.warmup`` runs each entry once
before traffic.  The bucket constants are the port's own
(``decode.pad_prompts``, ``serving.WINDOW_BUCKETS`` and the streaming
plugin's ``_token_budget``); a test pins them to both.
"""

from __future__ import annotations

PROMPT_BUCKETS = (16, 32, 64, 144, 256)   # decode.pad_prompts
STREAM_BUDGETS = (48, 96, 224)            # torch_whisper_asr._token_budget
WINDOW_BUDGET = 224                       # SAMPLE_LEN
# streaming short-window encode buckets (serving.WINDOW_BUCKETS + full):
# chunk seconds -> (window samples, token budget) pairs that co-occur —
# the budget thresholds EQUAL the window buckets (5.12 s / 15.36 s,
# ADVICE round 4 #2), so exactly one budget exists per window
STREAM_WINDOW_BUDGETS = ((81920, 48), (245760, 96), (480000, 224))


def census(slots: int = 4, *, beam_size: int = 5, best_of: int = 5,
           streaming: bool = True, file_api: bool = True,
           sequential_cli: bool = False, initial_prompt: bool = True,
           prefix: bool = False) -> list:
    """Enumerate reachable (program, shape) combos for one serving config.

    Returns [(family, key, reachable_reason)] — one entry per program
    and shape.
    """
    programs = []
    seen = set()

    def add(family, key, why):
        if (family, key) in seen:  # one entry serves every reachable path
            return
        seen.add((family, key))
        programs.append((family, key, why))

    # ---- batch sizes that reach the device --------------------------------
    batches = set()
    if streaming or file_api:
        batches.add(slots)           # BatchServer pads every group to slots
    if sequential_cli:
        batches.add(1)               # engine.transcribe seek loop
        batches.add(best_of)         # temperature>0 best_of batched decode

    # ---- encoder (mel + encode), one per (batch, window, dtype) -----------
    for b in sorted(batches):
        add("encoder", (b, 480000, "int16"),
            "file/task uploads ship int16 PCM")
        if streaming:
            # streaming chunks ship int16 through the BatchServer and
            # encode bucketed short windows (serving.WINDOW_BUCKETS)
            for win, _budget in STREAM_WINDOW_BUDGETS:
                add("encoder", (b, win, "int16"),
                    "streaming chunk window bucket")

    # ---- prompt buckets reachable per path ---------------------------------
    # seek-loop window 1: sot_seq (3-4 tokens) -> 16; +initial_prompt -> 32;
    # steady-state conditioned carry -> 144 (build_prompt caps prev at 127);
    # 64 bridges short carries; 256 only with long prefix= prompts.
    file_prompts = [16, 144]
    if initial_prompt:
        file_prompts.append(32)
    file_prompts.append(64)
    if prefix:
        file_prompts.append(256)
    stream_prompts = [32 if initial_prompt else 16]

    # ---- decode programs ----------------------------------------------------
    for b in sorted(batches):
        if file_api or sequential_cli:
            for p in sorted(set(file_prompts)):
                add("beam_decode",
                    (b, p, WINDOW_BUDGET, f"beam{beam_size}"),
                    "task/CLI window decode (temperature 0)")
                # fallback ladder rungs > 0 sample (the greedy program with
                # the temperature as an input: one entry serves every rung)
                add("greedy_decode", (b, p, WINDOW_BUDGET),
                    "fallback ladder t>0 (one compile, traced temperature)")
        if streaming:
            for p in stream_prompts:
                # partials decode at the server's beam_size (default 5)
                # over the bucketed (window, budget) pairs; only the
                # combos the chunk-duration thresholds can produce
                # co-occur (short_window off collapses windows to 480000)
                for win, budget in STREAM_WINDOW_BUDGETS:
                    add("beam_decode",
                        (b, p, win, budget, f"beam{beam_size}"),
                        "streaming partial (window x token bucket)")
    # lang-detect prefill (engine.detect_language): tiny, width-16
    if sequential_cli:
        add("lang_logits", (1, 16), "language auto-detect")
    return programs


