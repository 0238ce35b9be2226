#!/usr/bin/env python3
"""Smoke run of the ttasr_torch port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout.  Phases, each of which raises on failure:

1. the device: CUDA must be available; prints the card's name and power
   limit (``nvidia-smi``);
2. builds the hand-written CUDA kernels from ``ttasr_torch/csrc`` with nvcc
   (one process per source, in parallel), and prints the floor of
   ``time_ms`` (a 1-element add per CUDA graph replay: the host's launch
   rate, which a kernel time near it reflects);
3. holds the encoder-attention kernel (B11) against its plain PyTorch
   version at large-v3 shapes (bf16 and float32, full and ragged
   ``t_real``); prints its TFLOP/s and share of the bound beside
   ``scaled_dot_product_attention``'s; float32 B11 (also at B = 2 and a
   ragged (4, 1536)) and B6 (the fused (B, 1500, 3840) buffer through
   ``encoder_attention_merged_qkv``, B = 1 and 2), the 3xTF32 kernel,
   within ``F32_REL`` of their plain versions; at one window timed beside
   them and the library call in f32, with the bound of the function's
   FLOP at the rate of f32-accurate tensor-core products
   (``PEAK_OPS_PER_S["f32_tc"]``) and, in brackets, at the TF32 and the f32
   peaks;
4. holds the int8 decode kernels against their plain versions at large-v3
   shapes: B1 and B4 at 5 rows; B3 at (B, K) = (1, 5) and (5, 1) over int4
   and int8 cross-KV; B2 (beam 5, a non-identity ancestry map) and B10
   (5 audios x 1 row) at cache lengths 288 and 480 with the slot near the
   end and two pad lengths, int4 and int8 self-KV.  New K/V codes and
   scales must be exact; floats within the bounds below.  Each kernel and
   its plain version, and one decoder layer's chain B1 -> B2 -> B3 -> B4
   against the plain chain, are timed in turns (plain, kernel, kernel,
   plain) with CUDA events over replays of a CUDA graph of the call, so
   the host's launch overhead is out of both numbers; B3 also with an
   ``s_real`` that masks a whole split of its cross-attention's cluster
   (finite, within the same bound), twice on one input (the same bits), and
   cold: a graph over 32 layers' distinct weights and cross-KV caches; B1
   twice on one input (the same bits); B4 at 5 and 10 rows, equal bit for
   bit to B15 (wo_c) followed by B14 (full) on x' (the persistent kernel
   keeps the three products' order), twice on one input (the same bits),
   one CUDA kernel per call (torch.profiler), warm, in graphs of 20 calls
   and cold (a graph over 32 layers' distinct wo_c, W1 and W2), beside the
   ``time_ms`` floor; every kernel's share of its bound;
5. holds the s8 x s8 encoder's kernels against their plain versions at
   large-v3 shapes (B = 1 and 2, T = 1500): B5 ``ln_quant``, B7
   ``quant_only``, B8 ``add_ln_quant`` (D = 1280) and B9 ``gelu_quant`` (F =
   5120) within the codes envelope (|delta code| <= 1 on under 0.1 % of
   entries, row scales within rtol 1e-6, B8's residual exact); B9 and B5
   from the int8 GEMM's accumulators, ``gelu_quant_acc`` (W1's, F = 5120)
   and ``ln_quant_acc`` (W2's, with the residual x), on accumulators of
   seeded codes some of which pass 2**24, within the same envelope with
   ``x'`` exact, equal bit for bit to the parent route on the card (the
   torch epilogue, the eager add and the bf16 entry) and the same bits
   twice, timed in turns with their plain versions and with the parent
   route (also in graphs of 20 calls); likewise B8 from wo's accumulators,
   ``add_ln_quant_acc`` (the residual exact), and the qkv GEMM's epilogue,
   ``qkv_epilogue_acc`` (the (B, T, 3840) bf16 buffer with the dh**-0.5
   query scale folded in, bit for bit with its plain version, which is
   the parent route's column-scale launches and torch epilogue); B6
   ``encoder_attention_merged_qkv`` from the (B, T, 3840) qkv buffer
   within B11's bound, and the int8 GEMM (``torch._int_mm`` on K-major
   codes) equal to the exact int32 product at the encoder's four shapes;
   timed as in phase 4, with the library call beside B6 and B11
   (``scaled_dot_product_attention``) and the GEMM (a bf16 matmul); B6
   also at bench.py's 48 windows, (48, 1500, 3840), held to and timed in
   turns with ``scaled_dot_product_attention``, with TFLOP/s and the share
   of the bound; then the row kernels on float32 rows (``check_f32_rows``,
   ROADMAP C9: the int8 engine on float32 params): B5, B7, B8, B9, B5 and
   B8 from the accumulators with an f32 residual, and the qkv epilogue
   writing f32, at one window, codes within the envelope and row scales
   within ``SCALE_RTOL``, the f32 residuals and the f32 qkv buffer bit for
   bit, the same bits twice, each timed beside its plain version and bound;
   and B7's and B9's split entries (the encoder on a mesh,
   ``_check_split_entries``) at large-v3's shard widths (D/2, D/4 on bf16
   and f32 rows; F/2, F/4): each pass against its plain version, every
   part's codes and scales after the MAX of the parts' absmax equal to the
   whole-row entry's bit for bit, one rank's part timed in turns with its
   plain version and both passes with the whole-row entry;
6. holds the kernels of the decode's other branches against their plain
   versions at large-v3 shapes: B12 ``attnout_ln_q_fused`` at 5 and 10
   rows and B13 ``cross_attention_int8`` at (B, K) = (1, 5), (5, 1) and
   (1, 8) over int8 and int4 cross-KV, and at (1, 5) with a whole split of
   the cache masked, within the bound of B1-B4; B17
   ``gather_cache_rows`` (32 layers, 5 rows, len 480, int4 and int8 codes,
   a top-k's index and a permutation) byte for byte; timed as in phase 4,
   B17 on the permutation beside its library call (four ``index_select``
   into the spare buffers);
7. holds the tensor-parallel kernels against their plain versions at the
   shard shapes of a model axis of 1 and 2: B15 ``matmul_int8_partial``
   (DL = 1280 and 640, 5 and 10 rows), B14 ``mlp_int8_fused`` (partial
   and full, F = 5120 and 2560, 5 and 8 rows) and B16 ``ln_q_cross_int8``
   (20 and 10 local heads, (B, K) = (1, 5) and (5, 1), int4 and int8
   cross-KV, and at n = 1, (1, 5) with a whole split of the cache masked),
   within the bound of B1-B4; B15 and B14 twice on one input (the same
   bits), B14 one CUDA kernel per call; timed as in phase 4, B15 beside its library call (a bf16 matmul on a
   weight cast beforehand), warm and cold (a graph over the 64 distinct
   weights of a tensor-parallel step's wo and wo_c, the library call over
   the same weights in bf16), with the ``time_ms`` floor beside them;
8. drives B18 ``log_mel_spectrogram_fused`` and B19
   ``encoder_self_attention``, which no engine path calls (in either
   package), through their entry points as the JAX golden test drives the
   Pallas kernels: B18 at 128 mels on the 20 s and 45 s clips (padded and
   cut) at B = 1 and on 48 windows, within 2e-4 of its plain version (the
   port's matmul frontend in float64), two launches a call (the FFT
   kernel, then the clamp and rescale), and one call's CUDA kernels under
   torch.profiler both of ``mel.cu`` (no torch op on its output); B19 at
   (1, 1500, 20, 64) in bf16 and float32 within ``BF16_REL`` x
   max|plain|, its float32 output bf16-rounded; exact launch counts; timed
   as in phase 4, B18 at each size beside the port's float32 matmul
   frontend (whose distance from the plain version is printed) with its
   share of the bound, B19 beside ``scaled_dot_product_attention``
   (TFLOP/s and the share of the bound printed);
9. drives the bf16 batch CLI path: ``WhisperEngine("large-v3",
   compute_type="bfloat16")`` with random weights from a seeded generator,
   its decoder cut to ``BF16_DECODER_LAYERS`` layers to keep the script
   within its time (the encoder whole), on two synthesized speech-like
   WAVs (20 s and 45 s, so the seek loop crosses a window with prompt
   carry), through
   ``ttasr_torch.cli.asr.process_audio_folder``; checks the results, that
   B11 ran 32 times per encoder pass, that beam decodes ran with finite
   logits, and that the encoder output agrees with the plain-attention
   encoder on one window;
10. drives the main path, the int8 engine with all its defaults:
   ``WhisperEngine("large-v3", compute_type="int8")`` (weights quantized
   on the card, the s8 x s8 encoder with B5-B9, int8 and int4 self-KV,
   int4 cross-KV, beam 5 through the ancestry map, best-of-5 fallback);
   checks the results, that the qkv epilogue, B6, B7, B8 (from wo's
   accumulators) and B9 (from W1's) ran 32 times per encoder pass, B5 once
   from x and 31 times from W2's accumulators, the int8 GEMM 4 x 32 times,
   B11 never, B1, B3 and B4 32 times per decode step, B2 32 times per beam
   step and B10 32 times per greedy step; that one window through the s8
   x s8 encoder agrees with the same encoder on the plain versions of
   B5-B9 and the qkv epilogue; and the encoder through this tree's route
   and the parent route (the qkv and wo torch epilogues, the per-call
   column scale, B8's bf16 entry) in turns: their outputs within
   ``ENCODER_REL``, one window's wall, device ms and kernels, and
   bench.py's 48 windows' wall, device ms and peak memory; one window also
   through the route of the bf16 entries (all four torch epilogues, B5's,
   B8's and B9's bf16 entries), which gives ``gelu_quant`` its launches;
11. drives the decode's other branches on one encoder window of the main
   path's engine, ``BRANCH_STEPS`` tokens each, beside a main-path beam
   decode of the same window: ``beam_decode`` with
   ``TTASR_UNFUSED_RULES=1`` (the two-stage logit rules: ``_apply_rules``
   once per step, finite log-probabilities, its tokens' agreement with the
   main-path leg printed), ``beam_decode`` with a bf16 cross-KV (B12),
   ``beam_decode`` with ``beam_indirect=False`` (B17 and B10; its tokens
   must equal the main-path leg's and its step logits stay within 1.4 %
   of them with every argmax equal), ``beam_decode`` and
   ``greedy_decode`` on the weights
   ``quantize_params`` gives without ``fuse_qkv`` (the 5-D int8 self-KV,
   B13), and one 20 s file through the engine's ``transcribe`` with
   ``beam_size=10`` (B12 and the quantized cross-attention's XLA branch);
   each with exact launch counts, finite logits and its ms per step; the
   main-path leg and the unfused beam leg once more over
   ``PROFILE_STEPS`` tokens under ``torch.profiler`` (device ms, kernels
   and busy share per step);
12. drives the tensor-parallel decode (``ttasr_torch.parallel``) on the
   same window: ``TPDecoder(..., create_mesh(1, 1), row_parallel=True)``
   on a one-rank NCCL group (TP v2: B15 twice, B16 and B14 per layer),
   beam 5 held to the main-path leg (equal tokens, step logits within
   1.4 % with every argmax equal) and greedy over 5 rows held to the
   single-card fused greedy decode; ``WhisperEngine(..., mesh=
   create_mesh(1, 1))`` (TP v1, the unfused s8 x s8 encoder with B11) on
   the 20 s file at T = 0, and its own window decoded by the engine and by
   the single-card fused ``beam_decode`` (held the same way); two one-card
   controls that change only the order of f32 sums (B4 through its plain
   version; the cross-KV projected per half of the heads, as a 2-way shard
   does); then two gloo ranks on this card, mesh (1, 2) (10 local heads
   each), v2 and v1 beam 5, their step-logit gaps to the main-path leg
   held to the controls' (``CONTROL_MARGIN``); exact launch counts in
   every leg;
13. drives the int8 engine with ``encoder_act_int8=False`` (the bf16
   encoder on int8 weights, B11) on one file, with its launch counts;
14. drives the server path on the main path's engine (it runs between 12
   and 13): the task API's call, two synthesized WAVs (``UPLOADS``)
   loaded with ``int16=True`` (both before either is submitted, so their
   first windows share a beam group) and submitted at once through
   ``shared_server(engine, slots=4, linger_ms=5)`` and
   ``transcribe_batched_with_server`` with the task worker's kwargs (no
   exception, well-formed segments, exact launch counts; the sweeps, rows,
   most rows in one sweep (> 1) and dispatches started while another group
   was in flight (>= 1), counted by wrapping the server's
   ``_decode_batch``; wall per audio second and peak memory); the call's first
   beam group of 2+ rows and first sampled greedy group re-run directly
   (``encode_windows``, then the decode with a generator seeded as the
   server seeded it): tokens, lengths, ``sum_logprob`` and
   ``no_speech_prob`` bit for bit; each window of that beam group decoded
   alone, its step-logit gaps and first differing token printed (a report,
   ROADMAP C3); the CLI's ``concurrency=4`` and ``batched=True`` modes
   (``CLI_MODE_FILES``) on a view of the engine whose decoder is cut to
   ``CLI_MODE_DECODER_LAYERS`` layers, with exact launch counts; a 3 s and a 12 s
   ``short_window`` request, each bit for bit its direct decode at S = 256
   and 768; B6 and B3 at T = S = 256 and 768 within the bounds of phases 4
   and 5; B1, B3 and B4 at 20 rows of 4 audios, B2 at 4 audios x 5 beams
   and B10 at 4 rows within ``DECODE_REL``, timed beside their plain
   versions and bounds; and its own seconds;
15. serves the HTTP service on the main path's engine (after 14; the
   engine of phases 10-15 is built by ``registry.get_engine("large-v3",
   compute_type="int8", device="cuda")``, so the app's own ``load_model``
   and the stream's init find it): ``ttasr_torch.api.app.create_app()`` on
   a localhost socket, its data and auth DB in a temporary directory; it
   logs in as the bootstrap admin, opens ``/stream/ws/stt`` with the
   ``simple`` VAD, uploads one synthesized 8 s WAV (``SERVICE_UPLOAD``) as
   a subtitle task and at the same time sends ``STREAM_SPEECH`` and
   ``STREAM_SILENCE_S`` of PCM16 over the socket in 0.25 s frames at about
   real time; it requires status 22, the TXT and a parsable SRT through the
   routes (a start after the file's end only where the end is clipped to
   it, ROADMAP C6), transcripts with text on the socket, the task API and
   the stream on the main engine and one ``BatchServer``, at least one
   priority sweep and one beam group of the upload (counted by wrapping
   ``_decode_batch``), exact launch counts, both health routes' JSON and no
   ERROR record from a ``ttasr_torch`` logger (the service logs and
   swallows its failures); prints the upload's wall per audio second, each
   transcript's latency from its last frame, sweeps, rows and priority
   rows, peak memory and its own seconds;
16. word timestamps, the warm-up and the doctor on the main path's engine
   (after 15): one synthesized 12 s WAV (``WORDS_CLIP``) with
   ``vad_filter=False`` and ``temperature=(0.0,)`` through
   ``engine.transcribe``, ``transcribe_with_server`` (the task API's
   ``shared_server``) and ``BatchedInferencePipeline(engine,
   batch_size=4)`` with ``word_timestamps=True``, and ``engine.transcribe``
   without: the tokens equal with and without words, a ``words`` list on
   every segment with text, every word within ``0 <= start <= end`` and
   its window ``[offset, offset + 30]``, starts sorted in a segment, and no
   ERROR record of a ``ttasr_torch`` logger (a failing alignment is logged
   and swallowed, as in the reference); one window's cross-attention from
   the pass in the engine's dtype held to the pass on a float64 copy of
   the dequantized decoder leaves (``ALIGN_PROB_BOUND``, max p printed
   beside it), and each layer's score step on its own q and k held to
   float64 (``SCORE_STEP_BOUND``) beside a control with bf16 scores that
   must break that bound, on a forced
   transcript of ``ALIGN_TOKENS`` tokens (random weights decode a few text
   tokens), with the share of tokens whose DTW start moves; each
   alignment's seconds and the peak memory above what it started with;
   then ``python -m
   ttasr_torch.cli.warmup --model large-v3 --slots 1 --file-api off`` (its
   six census entries, each a JSON line, the kernels' build stage and the
   total), its ``--dry-run`` at the defaults equal to ``census(8)``, and
   ``python -m ttasr_torch.cli.doctor`` (the card named, the kernel library
   loaded, the native host library built by g++ or absent with its
   reason); and its own seconds.
17. fine-tuning (after 13): the byte-fallback tokenizer and a corpus of
   two synthesized clips (``TRAIN_CLIPS``, 20 s and 28 s, labelled
   ``TRAIN_TEXT``, labels padded to 128); (a) large-v3 at full width and
   depth, f32 master params, ``make_train_step(remat=True,
   compute_dtype=bfloat16)`` with SpecAugment, AdamW lr 1e-4, no warm-up:
   ``TRAIN_STEPS`` steps on one batch, every loss finite, the last under
   ``LOSS_FALL`` of the first, every master leaf f32, no kernel launched;
   seconds per step (median of steps 3-8, synchronised), label tokens per
   second, peak memory beside the reckoned params, grads, moments and bf16
   copy; (b) ``Trainer.evaluate`` on those params (greedy, two clips in one
   chunk, ``generation_max_length`` 48): B11 launched 32 times per chunk
   and nothing else, its wall beside the one measured with the SIMT f32
   kernel (``EVAL_WALL_SIMT_S``); B11 in float32 at evaluate's chunk of
   ``EVAL_BATCH`` windows held to its plain version and timed beside it
   and ``scaled_dot_product_attention``, with its bounds as in phase 3; (c) at
   large-v3's width with 2 + 2 layers, f32, batch 1: loss within 1e-5 and
   each grad leaf within 1e-4 of its largest |g| of the port on the CPU,
   and the card's grads with remat against without, bit for bit but in
   the leaves whose gradient plain twice (the control) does not repeat,
   and there within twice the control's gap (each stem conv's weight
   gradient then run alone twice, to name the cause); (d) a ``Trainer`` of
   that size takes 4 steps saving every 2, checkpoint-4 restored into a
   fresh ``Trainer`` equals the live state bit for bit, and one more step
   from each on the same batch gives the same bits but in those leaves
   and their moments, with the bytes on disk per checkpoint; (e) ``python -m
   ttasr_torch.cli.train`` with the default device (``TRAIN_CLI_ARGS``, tiny
   on ``sample_corpus/``) in a subprocess beside legs b-d: rc 0, finite
   losses in ``metrics.jsonl``, an ``eval_cer``, ``checkpoint-2/`` and
   ``model/``; and its own seconds.
18. a trained model recognised on the card (after 17): (a) B1-B10 and the
   qkv epilogue at ``micro64-test``'s widths (d 128, 2 heads, F 512; 5
   rows, beam 5 and 5 x 1 at cache lengths 64 and 480, S = T = 1500)
   against their plain versions under the bounds of phases 4 and 5, each
   timed beside its plain version with its bound; (b) ``micro64-test``
   trained from seed 0 by the port's ``Trainer`` on the card, the
   recognition check's recipe (``ttasr_torch.tools.check_trained_recognition``:
   6 synthesized clips, 800 steps, lr 3e-3, timestamp labels), its seconds;
   (c) the check's transcription of every clip (VAD on, greedy and beam 5,
   the temperature ladder) through the int8 engine (the main path's
   kernels, on the trained float32 params as they are: the s8 x s8
   encoder's row kernels on float32 rows, ROADMAP C9) and the float32
   engine (B11 on 3xTF32):
   greedy CER <= ``MAX_CER`` on each, beam 5 recorded, launches exact
   against the decode stats, and the int8 engine's greedy texts at T = 0
   equal an int8 engine's on the CPU (the plain versions); (d) the VAD's
   torch forward on the card against ``vad_probabilities`` on the shipped
   weights, a batch's log-mel against the CPU's, and on the CPU's log-mels
   the first step's grads and ``VAD_STEPS`` Adam steps against the CPU's;
   (e) ``check_beam_divergence --ab kernels --windows 2 --sample-len 32``
   and ``profile_decode --batch 1`` at large-v3, its stage sum within 10 %
   of the step's device time; and its own seconds.
19. the GSPMD mesh path (after 12, on the main path's window and engine):
   ``WhisperEngine("large-v3", mesh=...)`` on meshes the fused TP decode
   refuses, which decode through ``ShardedDecoder`` (``shard_params``'
   slices and the unfused graph), ``BRANCH_STEPS`` tokens beam 5 and greedy through the
   engine's ``run_*_decode``: (a) int8 at (1, 4) on four ``gloo`` ranks of
   this card (5 heads a shard, the embedding whole), B13 exactly 32 x steps
   on each rank; (b) bf16 at (1, 2) on two (10 heads and 25933 vocabulary
   rows a shard), no kernel; both started before phase 12 as processes of
   this script (``--sharded-rank``), so that they decode beside phase 12
   (each step mostly waits on gloo's host round trips; phase 12's ms per
   step read the shared card), and held, rank 0's step
   logits, to the one-card decode of the same weights (the unfused int8
   graph of the main engine's weights; the bf16 weights' plain layer loop)
   under ROADMAP C3's rule: worst and median gaps within
   ``CONTROL_MARGIN`` x the larger of two one-card controls' measured in
   the same run (wo, wo_c and w2 as partial products of n and of 2n row
   blocks, n the model axis); (c) the bf16 engine at (1,
   1) on a one-rank NCCL group: tokens equal to its one-card decode, step
   logits within ``STEP_LOGIT_REL`` with every argmax equal; (e) B13 at
   h = 5 and 3, K = 1..5, S = 1500 within ``DECODE_REL`` x max of its
   plain version, timed at h = 5, K = 5.  (d), the int8 engine on float32
   params, is phase 18's int8 recognition leg and phase 5's float32 rows.
   Each rank also keeps only ``shard_params``' slices (its params' bytes,
   the encoder's and its int8 codes' beside
   ``tools/memory_accounting.engine_params``' reckoning of the slice and of
   the whole tree, ``memory_allocated`` after construction within
   ``RESIDENT_SLACK`` of the slices, the construction's peak) and encodes
   the main window's audio through ``encode_windows`` on its slices, the
   counts set to 0 before and read after: int8, exactly
   :func:`_sharded_encoder_launches` (B5, B8, both passes of B7's and B9's
   split entries, B11, the GEMMs) on every rank and every rank's output
   equal bit for bit to the one-card encoder on the same unfused K-major
   weights (``_unfused_encoder``), and the int8 ranks' greedy decode
   (``OWN_ENCODER_MODE``) reads their own encoder output, held to the
   one-card decode of the one-card encoder's; bf16, B11 32 times and every
   rank's output within ``CONTROL_MARGIN`` x two one-card controls (wo and
   W2 in 2 and 4 row blocks, ``_encoder_row_sums_in_parts``) of the (1, 1)
   engine's encoder.  Prints its seconds after phase 12 and the ranks'
   from their start.
20. fine-tuning on a mesh (its ranks start before 13, its comparisons
   run after 18): large-v3's width at
   ``MESH_TRAIN_LAYERS`` + ``MESH_TRAIN_LAYERS`` layers on two ``gloo``
   ranks of this card (processes of this script, ``--train-rank``), while
   this process runs the one-card references: (a) mesh (2, 1), f32,
   ZeRO-1, remat, ``MESH_TRAIN_STEPS`` steps on a global batch of four
   synthesized clips (labels of unequal lengths): losses and final params
   against the one-card run, within ``CONTROL_MARGIN`` x a control that
   only reorders sums (the two halves' grads, each loss over the global
   token count, summed); (b) mesh (1, 2), bf16 compute (10 heads and 25933
   vocabulary rows a rank): the first step's loss and grads against the
   one-card bf16 step, within ``CONTROL_MARGIN`` x a control with a 2-way
   split's arithmetic (column and row blocks, the logits in 2 vocabulary
   blocks); no kernel launched in a-c; (c) each rank's peak memory of the
   first step with ZeRO-1 against replicated moments, the difference within
   ``ZERO1_PEAK_REL`` of half the moments' bytes that
   ``ttasr_torch.tools.memory_accounting`` reckons (printed beside its
   full-depth numbers); (d) a ``Trainer`` at (2, 1): 2 steps and its
   checkpoint, greedy ``evaluate`` on two clips with B11 exactly
   ``MESH_TRAIN_LAYERS`` launches a chunk on each rank and the same metrics
   on both, then the checkpoint resumed in this process, equal bit for bit
   to the ranks' gathered state; its seconds and each rank's peak memory.

Every path's counts are set to 0 just before it and read just after, and
each path ends with one 30 s window through its encoder, timed and
profiled (``torch.profiler``: device time, kernel count).  Prints one
JSON line with each kernel's launches (from the main path's run; B11's
from the bf16 path's, B12's from the bf16 cross-KV leg's, B13's from the
unfused beam leg's, B17's from the ``beam_indirect=False`` leg's, B14-B16's
from the one-rank TP v2 beam leg's, B18's and B19's from phase 8's run, B8's
bf16 entry's from one parent-route encoder pass, B9's bf16 entry's from one
pass of the route of the bf16 entries, B7's and B9's split entries' from
rank 0 of phase 19's int8 (1, 4) leg's encoder pass), worst error, times,
bound and
library time, then
the card line, then the contract line ``{"ok": true, "device": {...}}``
last.
Imports nothing of jax and nothing of the JAX package.  Exits non-zero,
printing no result, when CUDA is unavailable or the checkout is missing.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import logging
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# bounds over rows < t_real, relative to max|plain|
BF16_REL = 2e-2   # bf16 inputs and probabilities, f32 sums
F32_REL = 1e-4    # exact f32 products, f32 sums in another order
ENCODER_REL = 5e-2  # 32 bf16 layers, kernel vs plain attention
# int8 decode kernels vs their plain versions, relative to max|plain|: both
# round to bf16 at the same points (LN and GELU outputs, pre-scaled
# queries, scale-folded probabilities) and take exact f32 products; the f32
# sums run in another order, so a last-bit difference can flip one bf16
# rounding of an intermediate and move an output by about one bf16 step of
# one term.  New K/V codes and scales are held exactly.
DECODE_REL = 2e-3
# the encoder's row quantizers vs their plain versions: the LayerNorm's
# sums run in another order, so a code can flip by one at a .5 tie
CODE_FLIP_FRAC = 1e-3
SCALE_RTOL = 1e-6

N_LAYERS = 32  # large-v3 decoder and encoder depth

# H100 SXM 80GB HBM3 at 700 W (NVIDIA's data sheet, dense): the least time
# a kernel could take is the larger of its bytes over the memory rate and
# its operations over the peak rate of their type
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12, "tf32": 494.7e12}
# float32-accurate products on the tensor cores, the rate that bounds an f32
# attention on this card whatever its design: the tensor cores have no f32
# type, and the cheapest known products of f32 accuracy cost three TF32
# products (hi.hi + hi.lo + lo.hi of 11-bit halves: 494.7 / 3) or six bf16
# ones (three 8-bit thirds, the terms of order <= 2: 989 / 6); both ~165
# TFLOP/s, above the 67 of the f32 units outside them
PEAK_OPS_PER_S["f32_tc"] = PEAK_OPS_PER_S["tf32"] / 3


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, iters: int = 50) -> float:
    """Device milliseconds per call of ``fn``: ``fn`` is captured once in a
    CUDA graph and the graph replayed ``iters`` times between two CUDA
    events, so the host's per-launch overhead is not in the number."""
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
    for _ in range(iters):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def in_turns(kernel_fn, plain_fn, timer=None):
    """(kernel ms, plain ms), measured plain, kernel, kernel, plain by
    ``timer`` (default :func:`time_ms`)."""
    timer = timer or time_ms
    p1, k1, k2, p2 = (timer(plain_fn), timer(kernel_fn), timer(kernel_fn), timer(plain_fn))
    return (k1 + k2) / 2, (p1 + p2) / 2


def time_ms_floor() -> float:
    """``time_ms`` of one 1-element add: the floor that the host's graph
    launches put under every ``time_ms`` reading; a kernel near it is
    launch-bound in that reading, not device-bound."""
    import torch

    t = torch.zeros(1, device="cuda")
    return time_ms(lambda: t.add_(1.0))


def per_call_ms(fn, reps: int = 20) -> float:
    """Milliseconds per call of a CUDA graph of ``reps`` calls: back to back
    on the card, with no host launch between them (no ``time_ms`` floor)."""
    return time_ms(lambda: [fn() for _ in range(reps)]) / reps


def time_cold_ms(fns, iters: int = 5) -> float:
    """Device milliseconds per call of a CUDA graph that calls every ``fns``
    in turn once: each call meets its operands cold (their sum far beyond
    the 50 MB L2), as one decode step meets its 32 layers' weights."""
    return time_ms(lambda: [fn() for fn in fns], iters=iters) / len(fns)


def _same_bits(name, fn) -> None:
    """``fn()`` twice on the same input gives the same bits (fixed-order
    sums, no atomics)."""
    import torch

    outs = []
    for _ in range(2):
        out = fn()
        outs.append([t.clone() for t in (out if isinstance(out, tuple) else (out,))])
    torch.cuda.synchronize()
    same = all(torch.equal(a.view(torch.int32), b.view(torch.int32))
               for a, b in zip(*outs))
    print(f"{name}: the same bits on two calls with the same input: {same}")
    check(same, f"{name} gave other bits on a second call with the same input")


def _max_err(got, want):
    return (got.float() - want.float()).abs().max().item()


def _tensors(*objs):
    """The tensors among ``objs``, tuples and lists flattened."""
    import torch

    out = []
    for o in objs:
        if isinstance(o, torch.Tensor):
            out.append(o)
        elif isinstance(o, (tuple, list)):
            out += _tensors(*o)
    return out


def bound(tensors, ops: float, kind: str) -> dict:
    """{bound_ms, bound_by}: every input read once and every output
    written once, against ``ops`` operations at the peak rate of ``kind``."""
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    op_ms = ops / PEAK_OPS_PER_S[kind] * 1e3
    return (dict(bound_ms=byte_ms, bound_by="bytes") if byte_ms >= op_ms
            else dict(bound_ms=op_ms, bound_by="operations"))


def _sdpa_ms(q, k, v, t_real: int, scale: float = 1.0) -> float:
    """One ``scaled_dot_product_attention`` call on the same heads (the
    merged (B, T, D) tensors viewed as (B, H, T, 64)), keys >= t_real
    masked, scores times ``scale``: the library yardstick for B6, B11 and
    B19."""
    import torch
    import torch.nn.functional as F

    b, t, d = q.shape
    h = d // 64

    def heads(x):
        return x.view(b, t, h, 64).transpose(1, 2)

    mask = None
    if t_real < t:
        mask = (torch.arange(t, device=q.device) < t_real).view(1, 1, 1, t)
    return time_ms(lambda: F.scaled_dot_product_attention(
        heads(q), heads(k), heads(v), attn_mask=mask, scale=scale))


def _attention_rate(name: str, m: dict, flop: float, card: str) -> None:
    """Prints an attention kernel's achieved rate and its share of the
    bound (``m``: ms, bound_ms, library_ms)."""
    print(f"{name}: {flop / m['ms'] / 1e9:.1f} TFLOP/s ({flop / 1e9:.2f} GFLOP), "
          f"{m['bound_ms'] / m['ms']:.1%} of the bound; scaled_dot_product_attention "
          f"{flop / m['library_ms'] / 1e9:.1f} TFLOP/s ({card})")


def _f32_bound(tensors, flop: float) -> dict:
    """The float32 attention's bound: the function's ``flop`` at the rate of
    f32-accurate tensor-core products (``PEAK_OPS_PER_S["f32_tc"]``), and
    the same ``flop`` at the TF32 peak (``tf32_peak_ms``: one TF32 product
    per multiply-add, below f32 accuracy) and at the f32 peak outside the
    tensor cores (``f32_peak_ms``: the bound of a SIMT kernel)."""
    return dict(**bound(tensors, flop, "f32_tc"),
                tf32_peak_ms=bound(tensors, flop, "tf32")["bound_ms"],
                f32_peak_ms=bound(tensors, flop, "f32")["bound_ms"])


def _f32_attention_line(name: str, m: dict, flop: float, card: str) -> None:
    print(f"{name}: kernel {m['ms']:.4f} ms, plain {m['plain_ms']:.4f} ms, "
          f"scaled_dot_product_attention (f32) {m['library_ms']:.4f} ms, bound "
          f"{m['bound_ms']:.4f} ms ({m['bound_by']}: {flop / 1e9:.2f} GFLOP at "
          f"{PEAK_OPS_PER_S['f32_tc'] / 1e12:.1f} TFLOP/s, f32-accurate tensor-core products), "
          f"{m['bound_ms'] / m['ms']:.1%} of the bound [{m['tf32_peak_ms']:.4f} ms at the TF32 "
          f"peak, {m['tf32_peak_ms'] / m['ms']:.1%} of it; {m['f32_peak_ms']:.4f} ms at the f32 "
          f"peak], {m['library_ms'] / m['ms']:.2f}x SDPA's speed, max_abs_err "
          f"{m['max_abs_err']:.3e} (bound {m['limit']:.3e}) ({card})")


def _check_b6_f32(card: str) -> dict:
    """B6 in float32: the fused (B, 1500, 3 x 1280) buffer, q's third
    pre-scaled, through ``encoder_attention_merged_qkv`` (the 3xTF32
    kernel) at B = 1 and 2 (the batch rows' lo planes lie B rows past their
    hi planes), each held to its plain version within ``F32_REL``; at one
    window timed beside it and the library call."""
    import torch

    from ttasr_torch.ops.encoder_attention import (
        encoder_attention_merged_qkv,
        encoder_attention_merged_qkv_ref,
    )

    gen = torch.Generator(device="cuda").manual_seed(20)
    colscale = torch.ones(3 * D, device="cuda")
    colscale[:D] = 64 ** -0.5
    for b in (2, 1):
        qkv = torch.randn((b, ENC_T, 3 * D), generator=gen, device="cuda") * colscale
        got = encoder_attention_merged_qkv(qkv, ENC_T)
        torch.cuda.synchronize()
        want = encoder_attention_merged_qkv_ref(qkv, ENC_T)
        err = _max_err(got, want)
        limit = F32_REL * want.abs().max().item()
        print(f"encoder_attention_merged_qkv float32 B={b} T={ENC_T}: max_abs_err {err:.3e} "
              f"(bound {limit:.3e})")
        check(got.dtype == torch.float32 and bool(torch.isfinite(got).all()),
              f"B6 float32 B={b}: a non-finite or non-f32 output")
        check(err <= limit, f"B6 float32 B={b} disagrees with its plain version: "
                            f"{err} > {limit}")
    ms, plain_ms = in_turns(lambda: encoder_attention_merged_qkv(qkv, ENC_T),
                            lambda: encoder_attention_merged_qkv_ref(qkv, ENC_T))
    flop = 4.0 * ENC_T * ENC_T * D
    m = dict(max_abs_err=err, limit=limit, ms=ms, plain_ms=plain_ms,
             library_ms=_sdpa_ms(qkv[..., :D], qkv[..., D:2 * D], qkv[..., 2 * D:], ENC_T),
             **_f32_bound([qkv, got], flop))
    _f32_attention_line(f"encoder_attention_merged_qkv float32 B=1 T={ENC_T}", m, flop, card)
    return m


def check_encoder_attention(card: str) -> dict:
    """B11 against its plain version at the main path's shapes; B11's and
    B6's float32 path (3xTF32) at one window beside the library call."""
    import torch

    from ttasr_torch.ops.encoder_attention import (
        encoder_attention_merged,
        encoder_attention_merged_ref,
    )

    gen = torch.Generator(device="cuda").manual_seed(0)
    d, dh = 1280, 64
    worst = 0.0
    cases = [(torch.bfloat16, 1, 1500, 1500), (torch.bfloat16, 4, 1500, 1500),
             (torch.bfloat16, 1, 1536, 1500), (torch.bfloat16, 4, 1536, 1500),
             (torch.float32, 1, 1500, 1500), (torch.float32, 2, 1500, 1500),
             (torch.float32, 1, 1536, 1500), (torch.float32, 4, 1536, 1500)]
    for dtype, b, t, t_real in cases:
        def rand():
            return torch.randn((b, t, d), generator=gen, device="cuda")

        q = (rand() * dh ** -0.5).to(dtype)
        k, v = rand().to(dtype), rand().to(dtype)
        got = encoder_attention_merged(q, k, v, t_real)
        torch.cuda.synchronize()
        want = encoder_attention_merged_ref(q, k, v, t_real)
        err = _max_err(got[:, :t_real], want[:, :t_real])
        scale = want[:, :t_real].float().abs().max().item()
        limit = (BF16_REL if dtype == torch.bfloat16 else F32_REL) * scale
        print(f"encoder_attention {str(dtype)[6:]} B={b} T={t} t_real={t_real}: "
              f"max_abs_err {err:.3e} (bound {limit:.3e}, max|plain| {scale:.3e})")
        check(err <= limit, f"encoder attention disagrees with its plain "
                            f"version: {err} > {limit}")
        worst = max(worst, err)
        if t == t_real:
            kernel_ms, plain_ms = in_turns(
                lambda: encoder_attention_merged(q, k, v, t_real),
                lambda: encoder_attention_merged_ref(q, k, v, t_real))
            print(f"encoder_attention {str(dtype)[6:]} B={b} T={t}: kernel "
                  f"{kernel_ms:.4f} ms, plain {plain_ms:.4f} ms ({card})")
            if dtype == torch.bfloat16 and b == 1:
                main = dict(ms=kernel_ms, plain_ms=plain_ms,
                            library_ms=_sdpa_ms(q, k, v, t_real),
                            **bound([q, k, v, got], 4.0 * b * t * t_real * d, "bf16"))
            elif b == 1:
                f32 = dict(max_abs_err=err, limit=limit, ms=kernel_ms, plain_ms=plain_ms,
                           library_ms=_sdpa_ms(q, k, v, t_real),
                           **_f32_bound([q, k, v, got], 4.0 * b * t * t_real * d))
    print(f"encoder_attention bf16 B=1 T=1500: scaled_dot_product_attention "
          f"{main['library_ms']:.4f} ms, bound {main['bound_ms']:.4f} ms ({card})")
    _attention_rate("encoder_attention bf16 B=1 T=1500", main, 4.0 * 1500 * 1500 * d, card)
    _f32_attention_line("encoder_attention float32 B=1 T=1500", f32, 4.0 * 1500 * 1500 * d,
                        card)
    b6_f32 = _check_b6_f32(card)
    return dict(max_abs_err=worst, b11_f32=f32, b6_f32=b6_f32, **main)


# ---------------------------------------------------------------------------
# Phase 4: the int8 decode kernels at large-v3 shapes
# ---------------------------------------------------------------------------

D, H, FFN, S_PAD, S_REAL = 1280, 20, 5120, 1504, 1500
HP = 24  # ceil(H / 8) * 8 scale rows
# an s_real that masks every slot of the last of the 7 blocks that split a
# (head, audio) of beam 5 (cross_attention.cuh: int4 packed rows 648-751,
# slots 648-751 and 1400-1503; int8 slots 1290-1503)
MASKED_S_REAL = 600


class Inputs:
    """Seeded random decode-step operands on the card, at large-v3's widths
    unless ``d``, ``h`` and ``ffn`` say otherwise."""

    def __init__(self, seed: int, d: int = D, h: int = H, ffn: int = FFN):
        import torch

        self.gen = torch.Generator(device="cuda").manual_seed(seed)
        self.d, self.h, self.ffn = d, h, ffn
        self.hp = -(-h // 8) * 8  # scale rows: ceil(H / 8) * 8

    def randn(self, *shape, scale=1.0):
        import torch

        return torch.randn(shape, generator=self.gen, device="cuda") * scale

    def weight(self, k, n):
        from ttasr_torch.ops.quant import quantize_tensor

        w = quantize_tensor(self.randn(k, n, scale=0.02))
        return w["q"], w["s"]

    def vec(self, n, scale=0.02, offset=0.0):
        return self.randn(n, scale=scale) + offset

    def codes(self, *shape, levels):
        import torch

        return torch.randint(-levels, levels + 1, shape, generator=self.gen,
                             device="cuda", dtype=torch.int8)

    def layer(self):
        """One decoder layer's int8 weights and f32 vectors."""
        d, ffn = self.d, self.ffn
        p = {}
        p["wqkv"], p["wqkv_s"] = self.weight(d, 3 * d)
        p["wo"], p["wo_s"] = self.weight(d, d)
        p["wqc"], p["wqc_s"] = self.weight(d, d)
        p["woc"], p["woc_s"] = self.weight(d, d)
        p["w1"], p["w1_s"] = self.weight(d, ffn)
        p["w2"], p["w2_s"] = self.weight(ffn, d)
        for name, n in (("bqkv", 3 * d), ("bo", d), ("bqc", d), ("boc", d),
                        ("b1", ffn), ("b2", d)):
            p[name] = self.vec(n)
        for ln in ("ln1", "lnc", "ln2"):
            p[ln + "_s"], p[ln + "_b"] = self.vec(d, 0.1, 1.0), self.vec(d, 0.1)
        return p

    def cross_kv(self, b, int4: bool):
        """Quantized cross-KV of b audios: codes (B, S/2, D) uint8 packed
        along S or (B, S, D) int8, scales (B, H, S), last slots padding."""
        from ttasr_torch.ops.int4 import pack_int4
        from ttasr_torch.ops.quant import quantize_kv_sym

        out = []
        for _ in range(2):
            kv = self.randn(b, S_PAD, self.h, 64, scale=0.5)
            kv[:, S_REAL:] = 0.0
            codes, scales = quantize_kv_sym(kv, 7 if int4 else 127)
            codes = codes.reshape(b, S_PAD, self.d)
            out += [pack_int4(codes) if int4 else codes,
                    scales.transpose(1, 2).contiguous()]
        return out

    def self_kv(self, b, k, length, int4: bool):
        """Flat self-KV caches (B, K, len, D or D/2) and scales (B, K, HP,
        len) with rows >= H zero."""
        import torch

        from ttasr_torch.ops.int4 import pack_int4_lanes

        out = []
        for _ in range(2):
            codes = self.codes(b, k, length, self.d, levels=7 if int4 else 127)
            scales = torch.zeros((b, k, self.hp, length), device="cuda")
            scales[:, :, :self.h] = self.randn(b, k, self.h, length).abs() * 0.02 + 1e-3
            out += [pack_int4_lanes(codes) if int4 else codes, scales]
        return out


def _hold(name, case, got, want, worst):
    """Floats within DECODE_REL x max|plain|; returns the new worst error."""
    err = _max_err(got, want)
    scale = want.float().abs().max().item()
    print(f"{name} {case}: max_abs_err {err:.3e} (bound {DECODE_REL * scale:.3e}, "
          f"max|plain| {scale:.3e})")
    check(err <= DECODE_REL * scale,
          f"{name} {case} disagrees with its plain version: {err}")
    return max(worst, err)


def check_decode_kernels(card: str) -> dict:
    """B1, B2, B3, B4, B10 against their plain versions; returns per-kernel
    {max_abs_err, ms, plain_ms} keyed by wrapper name."""
    import torch

    from ttasr_torch.ops import decoder_blocks as blk
    from ttasr_torch.ops import decoder_mlp as mlp

    inp = Inputs(1)
    lay = inp.layer()
    res = {}

    # B1: 5 rows
    x = inp.randn(5, D, scale=0.5)
    b1 = (x, lay["ln1_s"], lay["ln1_b"], lay["wqkv"], lay["wqkv_s"], lay["bqkv"])
    worst = _hold("qkv_int8_fused", "R=5", blk.qkv_int8_fused(*b1),
                  blk.qkv_int8_fused_ref(*b1), 0.0)
    ms, plain_ms = in_turns(lambda: blk.qkv_int8_fused(*b1),
                            lambda: blk.qkv_int8_fused_ref(*b1))
    res["qkv_int8_fused"] = dict(
        max_abs_err=worst, ms=ms, plain_ms=plain_ms,
        **bound(_tensors(b1, blk.qkv_int8_fused(*b1)), 2.0 * 5 * D * 3 * D, "bf16"))
    _same_bits("qkv_int8_fused R=5", lambda: blk.qkv_int8_fused(*b1))
    n_kernels = _kernels_per_call("qkv_int8_fused R=5", lambda: blk.qkv_int8_fused(*b1))
    print(f"qkv_int8_fused R=5: in a graph of 20 {per_call_ms(lambda: blk.qkv_int8_fused(*b1)):.4f} "
          f"ms per call, {n_kernels:.0f} CUDA kernel(s) per call ({card})")

    # B3: (B, K) = (1, 5) and (5, 1), int4-packed and int8 cross-KV
    worst = 0.0
    main_b3 = None
    for b, k in ((1, 5), (5, 1)):
        for int4 in (True, False):
            ck, cks, cv, cvs = inp.cross_kv(b, int4)
            args = (inp.randn(b, k, D, scale=0.5), inp.randn(b, k, D, scale=0.5),
                    lay["wo"], lay["wo_s"], lay["bo"], lay["lnc_s"], lay["lnc_b"],
                    lay["wqc"], lay["wqc_s"], lay["bqc"], ck, cks, cv, cvs, S_REAL)
            got = blk.attnout_ln_q_cross_int8(*args)
            want = blk.attnout_ln_q_cross_int8_ref(*args)
            case = f"B={b} K={k} {'int4' if int4 else 'int8'} cross-KV"
            worst = _hold("attnout_ln_q_cross_int8", case + " x'", got[0], want[0], worst)
            worst = _hold("attnout_ln_q_cross_int8", case + " cross", got[1], want[1], worst)
            if (b, k, int4) == (1, 5, True):
                main_b3 = args
    # beam 5 of one audio with a whole split of the cache masked
    for int4 in (True, False):
        args = main_b3[:10] + tuple(inp.cross_kv(1, int4)) + (MASKED_S_REAL,)
        got = blk.attnout_ln_q_cross_int8(*args)
        want = blk.attnout_ln_q_cross_int8_ref(*args)
        case = (f"B=1 K=5 {'int4' if int4 else 'int8'} cross-KV s_real={MASKED_S_REAL} "
                f"(a whole split masked)")
        check(bool(torch.isfinite(got[1]).all()), f"attnout_ln_q_cross_int8 {case}: not finite")
        worst = _hold("attnout_ln_q_cross_int8", case + " x'", got[0], want[0], worst)
        worst = _hold("attnout_ln_q_cross_int8", case + " cross", got[1], want[1], worst)
    _same_bits("attnout_ln_q_cross_int8 B=1 K=5 int4",
               lambda: blk.attnout_ln_q_cross_int8(*main_b3))
    ms, plain_ms = in_turns(lambda: blk.attnout_ln_q_cross_int8(*main_b3),
                            lambda: blk.attnout_ln_q_cross_int8_ref(*main_b3))
    # cold: 32 layers' wo, cross query and cross-KV, one call each
    cold = []
    for _ in range(N_LAYERS):
        (wo, wo_s), (wqc, wqc_s) = inp.weight(D, D), inp.weight(D, D)
        layer = (main_b3[0], main_b3[1], wo, wo_s, lay["bo"], lay["lnc_s"], lay["lnc_b"],
                 wqc, wqc_s, lay["bqc"], *inp.cross_kv(1, True), S_REAL)
        cold.append(lambda a=layer: blk.attnout_ln_q_cross_int8(*a))
    cold_ms = time_cold_ms(cold)
    print(f"attnout_ln_q_cross_int8 B=1 K=5 int4: warm {ms:.4f} ms, cold {cold_ms:.4f} ms "
          f"(a graph over {N_LAYERS} layers' weights and cross-KV) ({card})")
    del cold
    # wo and the cross query (2 x 2 R D^2), scores and values over S_REAL
    b3_ops = 2.0 * 2 * 5 * D * D + 2.0 * 2 * 5 * S_REAL * D
    res["attnout_ln_q_cross_int8"] = dict(
        max_abs_err=worst, ms=ms, plain_ms=plain_ms,
        **bound(_tensors(main_b3, blk.attnout_ln_q_cross_int8(*main_b3)), b3_ops, "bf16"))

    # B4: 5 and 10 rows; one persistent kernel in the three products' order
    worst, b4 = 0.0, None
    for r in (5, 10):
        args = (inp.randn(r, D, scale=0.5), inp.randn(r, D, scale=0.5),
                lay["woc"], lay["woc_s"], lay["boc"], lay["ln2_s"], lay["ln2_b"],
                lay["w1"], lay["w1_s"], lay["b1"], lay["w2"], lay["w2_s"], lay["b2"])
        got = mlp.mlp_with_crossout_int8(*args)
        worst = _hold("mlp_with_crossout_int8", f"R={r}", got,
                      mlp.mlp_with_crossout_int8_ref(*args), worst)
        _b4_is_b15_then_b14(f"R={r}", args, got)
        if r == 5:
            b4 = args
    _same_bits("mlp_with_crossout_int8 R=5", lambda: mlp.mlp_with_crossout_int8(*b4))
    n_kernels = _kernels_per_call("mlp_with_crossout_int8 R=5",
                                  lambda: mlp.mlp_with_crossout_int8(*b4))
    print(f"mlp_with_crossout_int8 R=5: {n_kernels:.0f} CUDA kernel(s) per call")
    check(n_kernels == 1, f"mlp_with_crossout_int8 ran {n_kernels} CUDA kernels per call, not 1")
    ms, plain_ms = in_turns(lambda: mlp.mlp_with_crossout_int8(*b4),
                            lambda: mlp.mlp_with_crossout_int8_ref(*b4))
    # cold: 32 layers' distinct wo_c, W1 and W2 (470 MB), one call each
    cold = []
    for _ in range(N_LAYERS):
        weights = (*inp.weight(D, D), lay["boc"], lay["ln2_s"], lay["ln2_b"],
                   *inp.weight(D, FFN), lay["b1"], *inp.weight(FFN, D), lay["b2"])
        cold.append(lambda w=weights: mlp.mlp_with_crossout_int8(b4[0], b4[1], *w))
    cold_ms = time_cold_ms(cold)
    del cold
    print(f"mlp_with_crossout_int8 R=5: warm {ms:.4f} ms, in a graph of 20 "
          f"{per_call_ms(lambda: mlp.mlp_with_crossout_int8(*b4)):.4f}, cold {cold_ms:.4f} "
          f"(a graph over {N_LAYERS} layers' weights); time_ms floor {time_ms_floor():.4f} ms "
          f"({card})")
    res["mlp_with_crossout_int8"] = dict(
        max_abs_err=worst, ms=ms, plain_ms=plain_ms,
        **bound(_tensors(b4, mlp.mlp_with_crossout_int8(*b4)),
                2.0 * 5 * (D * D + 2 * D * FFN), "bf16"))

    res.update(check_self_attention(inp, card))

    for name, r in res.items():
        r["library_ms"] = None  # no single PyTorch call computes these
        print(f"{name}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}), {r['bound_ms'] / r['ms']:.1%} "
              f"of the bound ({card})")
    time_layer_chain(inp, lay, card)
    return res


def _kernels_per_call(label, fn) -> int:
    """The graph nodes of one call of ``fn`` (kernels and any other work),
    by :func:`_kernel_names`; printed by name."""
    names = _kernel_names(fn)
    print(f"{label}: one call's graph nodes {json.dumps(names)}")
    return sum(names.values())


# cuda.h's CUgraphNodeType: the node kinds a captured call can hold
GRAPH_NODE_KINDS = {0: "kernel", 1: "memcpy", 2: "memset", 3: "host", 4: "child graph",
                    5: "empty", 6: "event wait", 7: "event record", 10: "mem alloc",
                    11: "mem free"}


def _kernel_names(fn) -> dict:
    """{CUDA kernel name: launches} of one call of ``fn``, read through the
    driver API from the nodes of a CUDA graph that captures the call: the
    driver's own record of the work, where torch.profiler has dropped kernel
    records on this card (B18's FFT kernel in each of three tries of one
    run).  A node that is not a kernel counts under "<kind> node"; empty
    nodes, which do no work, are left out.  Names are as the driver gives
    them (mangled)."""
    import ctypes

    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    cu = ctypes.CDLL("libcuda.so.1")

    def call(name, *args):
        err = getattr(cu, name)(*args)
        check(err == 0, f"{name} returned CUresult {err}")

    raw = ctypes.c_void_p(graph.raw_cuda_graph())
    count = ctypes.c_size_t(0)
    call("cuGraphGetNodes", raw, None, ctypes.byref(count))
    nodes = (ctypes.c_void_p * count.value)()
    call("cuGraphGetNodes", raw, nodes, ctypes.byref(count))
    names = {}
    for node in nodes:
        kind = ctypes.c_int()
        call("cuGraphNodeGetType", ctypes.c_void_p(node), ctypes.byref(kind))
        if kind.value == 5:
            continue
        key = f"{GRAPH_NODE_KINDS.get(kind.value, kind.value)} node"
        if kind.value == 0:
            # CUDA_KERNEL_NODE_PARAMS_v2: the CUfunction first, the CUkernel
            # at byte 56 (set where the runtime launched a library kernel)
            params = (ctypes.c_void_p * 9)()
            call("cuGraphKernelNodeGetParams_v2", ctypes.c_void_p(node), params)
            name = ctypes.c_char_p()
            if params[0]:
                call("cuFuncGetName", ctypes.byref(name), ctypes.c_void_p(params[0]))
            else:
                call("cuKernelGetName", ctypes.byref(name), ctypes.c_void_p(params[7]))
            key = name.value.decode()
        names[key] = names.get(key, 0) + 1
    del graph
    return names


def _b4_is_b15_then_b14(case, args, got) -> None:
    """B4's output ``got`` equals B15 on wo_c with the residual and b_oc
    added (x'), then B14 (full) on x', bit for bit: the persistent kernel
    sums each product in the order of the kernels that take it alone."""
    import torch

    from ttasr_torch.ops import decoder_blocks as blk
    from ttasr_torch.ops import decoder_mlp as mlp

    x, cross, woc, woc_s, boc = args[:5]
    x_mid = (x + blk.matmul_int8_partial(cross, woc, woc_s)) + boc
    chain = mlp.mlp_int8_fused(x_mid, *args[5:], partial=False)
    same = torch.equal(got.view(torch.int32), chain.view(torch.int32))
    print(f"mlp_with_crossout_int8 {case}: equal bit for bit to B15 (wo_c) then B14 (full): "
          f"{same}")
    check(same, f"mlp_with_crossout_int8 {case} differs from B15 then B14")


# B2/B10 cache lengths and slots timed (480: the main path's last growth
# bucket; 64: an early one), and the longest the wrapper takes: at the 2
# splits of 100 (head, row) clusters one block's range would not fit
# shared memory, so the kernel takes more
SELF_LENGTHS = ((480, 477), (288, 285), (64, 40))
SELF_LONG = 4096


def _self_step(inp: Inputs, b, k, length, slot, pads, int4):
    """B2's (k > 1, a random ancestry map) or B10's (k = 1) wrapper, plain
    version and arguments at one length."""
    import torch

    from ttasr_torch.ops import self_attention as sa

    kc, ks, vc, vs = inp.self_kv(b, k, length, int4)
    qkv = inp.randn(b, k, 3 * inp.d, scale=0.5)
    pad = torch.tensor(pads, dtype=torch.int32, device="cuda").reshape(b, k)
    if k > 1:
        anc = torch.randint(0, k, (b, k, length), generator=inp.gen, device="cuda",
                            dtype=torch.int32)
        return (sa.self_attn_step_indirect_int8, sa.self_attn_step_indirect_int8_ref,
                (qkv, kc, ks, vc, vs, anc, pad, slot))
    return sa.self_attn_step_int8, sa.self_attn_step_int8_ref, (qkv, kc, ks, vc, vs, pad, slot)


def check_self_attention(inp: Inputs, card: str) -> dict:
    """B2 (beam 5 of one audio, through anc) and B10 (5 audios x 1 row)
    against their plain versions: len 288 and 480 with two pad sets, a
    slot or pads that mask whole splits, len SELF_LONG; int4 and int8; new
    codes and scales exact, the same bits twice; warm at SELF_LENGTHS (one
    call per replay and in graphs of 20), cold over 32 layers' caches."""
    import torch

    res = {}
    for name, b, k in (("self_attn_step_indirect_int8", 1, 5),
                       ("self_attn_step_int8", 5, 1)):
        # B2: audio-uniform pads (the beams share the prompt); B10: per row
        pad_sets = [[0] * 5, [100] * 5] if k == 5 else [[0, 3, 100, 7, 250], [41] * 5]
        cases = [(length, length - 3, pads, "") for length in (288, 480) for pads in pad_sets]
        # 2 splits of 240 positions at len 480: B2's slot 150 masks rank 1,
        # B10's pads 330 rank 0
        cases.append((480, 150, [0] * 5, " (split 2 of 2 masked)") if k == 5
                     else (480, 477, [330] * 5, " (split 1 of 2 masked)"))
        cases.append((SELF_LONG, SELF_LONG - 3, pad_sets[0], " (longer than one block's stage)"))
        worst, main = 0.0, None
        for length, slot, pads, note in cases:
            for int4 in (True, False):
                fn, ref, args = _self_step(inp, b, k, length, slot, pads, int4)
                kw = dict(n_heads=H, int4=int4)
                got, want = fn(*args, **kw), ref(*args, **kw)
                case = (f"B={b} K={k} len={length} slot={slot} pad={pads[:2]} "
                        f"{'int4' if int4 else 'int8'}{note}")
                check(bool(torch.isfinite(got[0]).all()), f"{name} {case}: not finite")
                worst = _hold(name, case, got[0], want[0], worst)
                for i, what in ((1, "k codes"), (2, "k scales"), (3, "v codes"),
                                (4, "v scales")):
                    check(torch.equal(got[i], want[i]),
                          f"{name} {case}: new {what} differ from the plain version")
                if length == 480 and int4 and main is None:
                    main = (fn, ref, args, kw)
        print(f"{name}: new codes and scales exact in every case")
        fn, ref, args, kw = main
        _same_bits(f"{name} B={b} K={k} len=480 int4", lambda: fn(*args, **kw))
        ms, plain_ms = in_turns(lambda: fn(*args, **kw), lambda: ref(*args, **kw))
        for length, slot in SELF_LENGTHS:
            f, _, a = _self_step(inp, b, k, length, slot, [0] * 5, True)
            call = (lambda f=f, a=a: f(*a, n_heads=H, int4=True))
            print(f"{name} B={b} K={k} len={length} slot={slot} int4: time_ms "
                  f"{time_ms(call):.4f}, in a graph of 20 {per_call_ms(call):.4f} ms per "
                  f"call ({card})")
        cold = []
        for _ in range(N_LAYERS):
            f, _, a = _self_step(inp, b, k, 480, 477, [0] * 5, True)
            cold.append(lambda f=f, a=a: f(*a, n_heads=H, int4=True))
        print(f"{name} B={b} K={k} len=480 int4: warm {ms:.4f} ms, cold "
              f"{time_cold_ms(cold):.4f} ms (a graph over {N_LAYERS} layers' caches) ({card})")
        del cold
        # scores and values over positions pad..slot of each row (the
        # caches' bytes counted whole)
        pad, slot = args[-2], args[-1]
        positions = float((slot + 1 - pad).sum().item())
        res[name] = dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms,
                         **bound(_tensors(args, fn(*args, **kw)),
                                 2.0 * 2 * positions * D, "bf16"))
    return res


def time_layer_chain(inp: Inputs, lay: dict, card: str) -> dict:
    """One decoder layer of a beam-5 step at cache length 480 (int4 self-
    and cross-KV): B1 -> B2 -> B3 -> B4 against the plain chain."""
    from ttasr_torch.ops import decoder_blocks as blk
    from ttasr_torch.ops import decoder_mlp as mlp
    from ttasr_torch.ops import self_attention as sa

    import torch

    b, k, length = 1, 5, 480
    kc, ks, vc, vs = inp.self_kv(b, k, length, True)
    ck, cks, cv, cvs = inp.cross_kv(b, True)
    anc = torch.randint(0, k, (b, k, length), generator=inp.gen, device="cuda",
                        dtype=torch.int32)
    pad = torch.zeros((b, k), dtype=torch.int32, device="cuda")
    x = inp.randn(b * k, D, scale=0.5)

    def chain(f1, f2, f3, f4):
        qkv = f1(x, lay["ln1_s"], lay["ln1_b"], lay["wqkv"], lay["wqkv_s"], lay["bqkv"])
        attn = f2(qkv.reshape(b, k, 3 * D), kc, ks, vc, vs, anc, pad, length - 1,
                  n_heads=H, int4=True)[0]
        xo, cross = f3(x.reshape(b, k, D), attn, lay["wo"], lay["wo_s"], lay["bo"],
                       lay["lnc_s"], lay["lnc_b"], lay["wqc"], lay["wqc_s"], lay["bqc"],
                       ck, cks, cv, cvs, S_REAL)
        return f4(xo.reshape(b * k, D), cross.reshape(b * k, D), lay["woc"], lay["woc_s"],
                  lay["boc"], lay["ln2_s"], lay["ln2_b"], lay["w1"], lay["w1_s"],
                  lay["b1"], lay["w2"], lay["w2_s"], lay["b2"])

    kernels = (blk.qkv_int8_fused, sa.self_attn_step_indirect_int8,
               blk.attnout_ln_q_cross_int8, mlp.mlp_with_crossout_int8)
    plains = (blk.qkv_int8_fused_ref, sa.self_attn_step_indirect_int8_ref,
              blk.attnout_ln_q_cross_int8_ref, mlp.mlp_with_crossout_int8_ref)
    got, want = chain(*kernels), chain(*plains)
    err = _max_err(got, want)
    scale = want.abs().max().item()
    print(f"layer chain B1->B2->B3->B4 (beam 5, len 480, int4): max_abs_err "
          f"{err:.3e} (max|plain| {scale:.3e})")
    check(err <= DECODE_REL * scale, f"the kernel chain disagrees with the plain chain: {err}")
    ms, plain_ms = in_turns(lambda: chain(*kernels), lambda: chain(*plains))
    print(f"layer chain: kernels {ms:.4f} ms, plain {plain_ms:.4f} ms per layer; "
          f"x 32 layers = {32 * ms:.3f} vs {32 * plain_ms:.3f} ms of device time "
          f"per beam step ({card})")
    return dict(ms=ms, plain_ms=plain_ms)


# ---------------------------------------------------------------------------
# Phase 5: the s8 x s8 encoder's kernels at large-v3 shapes
# ---------------------------------------------------------------------------

ENC_T = 1500  # encoder positions of a 30 s window


def _hold_codes(name, case, got, want):
    """Codes within the envelope, scales within SCALE_RTOL; returns the
    largest code difference."""
    dq = (got[0].int() - want[0].int()).abs()
    worst, frac = dq.max().item(), (dq > 0).float().mean().item()
    rel = ((got[1] - want[1]).abs() / want[1].abs()).max().item()
    print(f"{name} {case}: max |delta code| {worst}, on {frac:.2e} of codes; "
          f"scales max rel err {rel:.2e}")
    check(worst <= 1 and frac < CODE_FLIP_FRAC,
          f"{name} {case}: codes outside the envelope ({worst}, {frac})")
    check(rel <= SCALE_RTOL, f"{name} {case}: scales differ by {rel}")
    return float(worst)


def _b6_windows(gen, colscale, card: str) -> dict:
    """B6 at bench.py's MEL_WINDOWS windows ((48, 1500, 3840) bf16, each
    window's attention 32 times per encoder pass there), held to
    ``scaled_dot_product_attention`` on the same heads within B11's bound
    and timed beside it in turns."""
    import torch
    import torch.nn.functional as F

    from ttasr_torch.ops.encoder_attention import encoder_attention_merged_qkv

    b = MEL_WINDOWS
    qkv = (torch.randn((b, ENC_T, 3 * D), generator=gen, device="cuda") * colscale
           ).to(torch.bfloat16)

    def heads(x):
        return x.view(b, ENC_T, H, 64).transpose(1, 2)

    q, k, v = heads(qkv[..., :D]), heads(qkv[..., D:2 * D]), heads(qkv[..., 2 * D:])
    got = encoder_attention_merged_qkv(qkv, ENC_T)
    want = F.scaled_dot_product_attention(q, k, v, scale=1.0).transpose(1, 2).reshape(
        b, ENC_T, D)
    err = _max_err(got, want)
    limit = BF16_REL * want.float().abs().max().item()
    print(f"encoder_attention_merged_qkv B={b} T={ENC_T}: max_abs_err {err:.3e} against "
          f"scaled_dot_product_attention (bound {limit:.3e})")
    check(err <= limit, f"B6 at B={b} disagrees with scaled_dot_product_attention: {err}")
    ms, sdpa_ms = in_turns(lambda: encoder_attention_merged_qkv(qkv, ENC_T),
                           lambda: F.scaled_dot_product_attention(q, k, v, scale=1.0))
    m = dict(ms=ms, library_ms=sdpa_ms, **bound([qkv, got], 4.0 * b * ENC_T * ENC_T * D, "bf16"))
    print(f"encoder_attention_merged_qkv B={b} T={ENC_T}: kernel {ms:.4f} ms, "
          f"scaled_dot_product_attention {sdpa_ms:.4f} ms, bound {m['bound_ms']:.4f} ms "
          f"({card})")
    _attention_rate(f"encoder_attention_merged_qkv B={b} T={ENC_T}", m,
                    4.0 * b * ENC_T * ENC_T * D, card)
    return m


def _acc_case(gen, b, k, n):
    """W1's (k, n) = (D, FFN) or W2's (FFN, D) accumulators (b, ENC_T, n)
    from the int8 GEMM on seeded codes, the first rows and columns all 127
    so some pass 2**24 where k allows it (where the int -> float conversion
    rounds), with
    row scales, column scales and a bf16 bias of the encoder's magnitudes
    (outputs of a few units)."""
    import torch

    from ttasr_torch.ops import quant

    a = torch.randint(-127, 128, (b * ENC_T, k), generator=gen, device="cuda",
                      dtype=torch.int8)
    a[:3] = 127
    w = torch.randint(-127, 128, (k, n), generator=gen, device="cuda", dtype=torch.int8)
    w[:, :4] = 127
    acc = quant._int8_product(a, quant.kmajor(w)).view(b, ENC_T, n)
    if k * 127 * 127 > 2 ** 24:  # out of reach below k = 1041 (micro widths)
        check(acc.abs().max().item() > 2 ** 24, "no accumulator beyond 2**24")
    xs = torch.rand((b, ENC_T, 1), generator=gen, device="cuda") * 0.045 + 0.005
    ws = torch.rand((1, n), generator=gen, device="cuda") * 8e-4 + 2e-4
    bias = (torch.randn(n, generator=gen, device="cuda") * 0.1).to(torch.bfloat16)
    return acc, xs, ws, bias


def parent_gelu_quant_acc(acc, xs, w_scale, b):
    """The parent route of B9: W1's torch epilogue, then the bf16 entry."""
    import torch

    from ttasr_torch.ops import encoder_fused as ef
    from ttasr_torch.ops.quant import act8_epilogue

    return ef.gelu_quant(act8_epilogue(acc, xs, w_scale, b, torch.bfloat16))


def parent_ln_quant_acc(x, acc, xs, w_scale, b, scale, bias):
    """The parent route of B5 after W2: the torch epilogue, the eager bf16
    residual add, then the bf16 entry."""
    import torch

    from ttasr_torch.ops import encoder_fused as ef
    from ttasr_torch.ops.quant import act8_epilogue

    x2 = x + act8_epilogue(acc, xs, w_scale, b, torch.bfloat16)
    return (x2, *ef.ln_quant(x2, scale, bias))


def parent_add_ln_quant_acc(x, acc, xs, w_scale, b, scale, bias):
    """The parent route of B8 after wo: wo's torch epilogue, then the bf16
    entry."""
    import torch

    from ttasr_torch.ops import encoder_fused as ef
    from ttasr_torch.ops.quant import act8_epilogue

    return ef.add_ln_quant(x, act8_epilogue(acc, xs, w_scale, b, torch.bfloat16),
                           scale, bias)


Q_SCALE = 64 ** -0.5  # large-v3's dh**-0.5, folded into the q third


def _check_acc_entries(gen, ln_s, ln_b, act, card: str) -> dict:
    """B9, B5 and B8 from the accumulators, and the qkv epilogue, at B = 1
    and 2: against their plain versions (residuals exact, codes within the
    envelope, the qkv buffer bit for bit), against the parent route on the
    card bit for bit (B9: an exact epilogue, a GELU per element, an absmax
    in any order; B5 and B8: ``ln_quant`` and ``add_ln_quant`` run the same
    template, so their LayerNorms sum in the same order; the qkv epilogue:
    the same four roundings), the same bits twice; at B = 1 timed in turns
    with the plain version and with the parent route (``time_ms`` and
    graphs of 20 calls), beside the bound."""
    import torch

    from ttasr_torch.ops import encoder_fused as ef

    t0 = time.perf_counter()
    res = {}
    for b in (1, 2):
        w1 = _acc_case(gen, b, D, FFN)
        x = act(b, ENC_T, D)
        w2 = _acc_case(gen, b, FFN, D)
        wo = _acc_case(gen, b, D, D)
        qkv = _acc_case(gen, b, D, 3 * D)
        cases = {  # name: (kernel, plain, parent route, args, the accumulators,
            #               operations per element)
            "gelu_quant_acc": (ef.gelu_quant_acc, ef.gelu_quant_acc_ref,
                               parent_gelu_quant_acc, w1, w1[0], 30),
            "ln_quant_acc": (ef.ln_quant_acc, ef.ln_quant_acc_ref, parent_ln_quant_acc,
                             (x, *w2, ln_s, ln_b), w2[0], 20),
            "add_ln_quant_acc": (ef.add_ln_quant_acc, ef.add_ln_quant_acc_ref,
                                 parent_add_ln_quant_acc, (x, *wo, ln_s, ln_b), wo[0], 20),
            # the parent route's column scale (torch.ones, a slice fill, two
            # multiplies) and torch epilogue are the plain version's
            "qkv_epilogue_acc": (ef.qkv_epilogue_acc, ef.qkv_epilogue_acc_ref,
                                 ef.qkv_epilogue_acc_ref, (*qkv, Q_SCALE), qkv[0], 4),
        }
        for name, (fn, ref, parent, args, acc, per_elem) in cases.items():
            got, want, old = fn(*args), ref(*args), parent(*args)
            case = f"B={b} T={ENC_T} width={acc.shape[-1]}"
            same = all(torch.equal(g, o) for g, o in zip(_tensors(got), _tensors(old)))
            print(f"{name} {case}: equal to the parent route bit for bit: {same}")
            check(same, f"{name} {case}: differs from the parent route on the card")
            if name == "qkv_epilogue_acc":
                err = _max_err(got, want)
                print(f"{name} {case}: equal to the plain version bit for bit: "
                      f"{torch.equal(got, want)}")
                check(torch.equal(got, want), f"{name} {case}: differs from the plain version")
            else:
                if name != "gelu_quant_acc":
                    check(torch.equal(got[0], want[0]),
                          f"{name} {case}: the bf16 residual differs from the plain version")
                    got, want = got[1:], want[1:]
                err = _hold_codes(name, case, got, want)
            _same_bits(f"{name} {case}", lambda: fn(*args))
            r = res.setdefault(name, dict(max_abs_err=0.0, library_ms=None))
            r["max_abs_err"] = max(r["max_abs_err"], err)
            if b == 1:
                r["ms"], r["plain_ms"] = in_turns(lambda: fn(*args), lambda: ref(*args))
                r["ms_beside_parent"], r["parent_ms"] = in_turns(
                    lambda: fn(*args), lambda: parent(*args))
                r["graph20_ms"], r["graph20_parent_ms"] = in_turns(
                    lambda: fn(*args), lambda: parent(*args), timer=per_call_ms)
                # the column vectors are read as f32
                ins = [a.float() if getattr(a, "ndim", 0) == 1 else a for a in args]
                r.update(bound(_tensors(ins, fn(*args)), float(per_elem * acc.numel()),
                               "f32"))
                print(f"{name} B=1: kernel {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}); "
                      f"in turns with the parent route {r['ms_beside_parent']:.4f} against "
                      f"{r['parent_ms']:.4f} ms; graphs of 20 {r['graph20_ms']:.4f} against "
                      f"{r['graph20_parent_ms']:.4f} ms; bound {r['bound_ms']:.4f} ms "
                      f"({r['bound_by']}), {r['bound_ms'] / r['graph20_ms']:.1%} of it in "
                      f"graphs of 20 ({card})")
    print(f"accumulator entries (B9, B5, B8, the qkv epilogue): "
          f"{time.perf_counter() - t0:.1f} s")
    return res


SPLIT_PARTS = (2, 4)  # the model axis of the mesh legs: bf16 at 2, int8 at 4


def _split_pass_pair(absmax_fn, codes_fn, part_args):
    """Both passes of a split entry over every part of a row (one card
    standing in for the ranks): each part's absmax pass, the MAX of the
    partials (the all-reduce), each part's codes pass, which takes the
    part's arguments, the absmax pass's other output (B9's h) and the
    reduced absmax.  Returns the codes and scales of every part and the
    reduced absmax."""
    import torch

    first = [absmax_fn(*a) for a in part_args]
    pairs = [f if isinstance(f, tuple) else (f, None) for f in first]
    absmax = torch.stack([p[0] for p in pairs]).amax(0)
    return [codes_fn(a, p[1], absmax) for a, p in zip(part_args, pairs)], absmax


def _check_split_entries(gen, act, card: str) -> dict:
    """B7's and B9's split entries (the encoder on a mesh: a rank's columns
    of rows the model axis splits) at large-v3's shard widths, D/2 = 640 and
    D/4 = 320 (B7, bf16 and f32 rows) and F/2 = 2560 and F/4 = 1280 (B9),
    one window of rows: each pass against its plain version (the absmax
    exact, B9's stored h equal, codes within the envelope), and the codes
    and scales of every part, after the MAX of the parts' absmax, equal to
    the whole-row entry's at its columns bit for bit; at each width one
    rank's part timed in turns: each pass with its plain version, and both
    passes with the whole-row entry on the same rows.  Returns {name:
    measurements} for the kernels line (at model 4, the int8 leg's
    widths)."""
    import torch

    from ttasr_torch.ops import encoder_fused as ef

    t0 = time.perf_counter()
    res = {}
    errs = dict.fromkeys(("quant_only_absmax", "quant_only_scaled", "gelu_quant_acc_absmax",
                          "gelu_quant_scaled"), 0.0)  # name: worst over parts and widths

    def worst(name, err):
        errs[name] = max(errs[name], err)

    x16 = act(1, ENC_T, D)
    w1 = _acc_case(gen, 1, D, FFN)
    for n in SPLIT_PARTS:
        for rows in (x16, x16.float()):
            whole = ef.quant_only(rows)
            parts = [(c.contiguous(),) for c in rows.chunk(n, -1)]
            got, absmax = _split_pass_pair(
                ef.quant_only_absmax, lambda a, _, m: ef.quant_only_scaled(a[0], m), parts)
            case = f"{str(rows.dtype)[6:]} T={ENC_T} width {D // n} of {D}"
            for (part,), g in zip(parts, got):
                m, want_m = ef.quant_only_absmax(part), ef.quant_only_absmax_ref(part)
                worst("quant_only_absmax", _max_err(m, want_m))
                check(torch.equal(m, want_m),
                      f"quant_only_absmax {case}: differs from its plain version")
                worst("quant_only_scaled", _hold_codes(
                    "quant_only_scaled", case, g, ef.quant_only_scaled_ref(part, absmax)))
            same = (torch.equal(torch.cat([g[0] for g in got], -1), whole[0])
                    and all(torch.equal(g[1], whole[1]) for g in got))
            print(f"B7 split {case}: codes and scales equal to the whole-row entry's "
                  f"bit for bit: {same}")
            check(same, f"B7 split {case}: differs from the whole-row entry")
        acc, xs, ws, b = w1
        whole = ef.gelu_quant_acc(*w1)
        parts = [(a.contiguous(), xs, w.contiguous(), bb.contiguous())
                 for a, w, bb in zip(acc.chunk(n, -1), ws.chunk(n, -1), b.chunk(n))]
        case = f"T={ENC_T} width {FFN // n} of {FFN}"
        got, absmax = _split_pass_pair(ef.gelu_quant_acc_absmax,
                                       lambda a, h, m: ef.gelu_quant_scaled(h, m), parts)
        same = (torch.equal(torch.cat([g[0] for g in got], -1), whole[0])
                and all(torch.equal(g[1], whole[1]) for g in got))
        print(f"B9 split {case}: codes and scales equal to the whole-row entry's bit for "
              f"bit: {same}")
        check(same, f"B9 split {case}: differs from the whole-row entry")
        for part in parts:
            m, h = ef.gelu_quant_acc_absmax(*part)
            want_m, want_h = ef.gelu_quant_acc_absmax_ref(*part)
            worst("gelu_quant_acc_absmax", max(_max_err(m, want_m), _max_err(h, want_h)))
            check(torch.equal(h, want_h) and torch.equal(m, want_m),
                  f"gelu_quant_acc_absmax {case}: differs from its plain version")
            worst("gelu_quant_scaled", _hold_codes(
                "gelu_quant_scaled", case, ef.gelu_quant_scaled(h, absmax),
                ef.gelu_quant_scaled_ref(h, absmax)))
        _same_bits(f"B9 split {case}", lambda: ef.gelu_quant_scaled(
            ef.gelu_quant_acc_absmax(*parts[0])[1], absmax))

        # one rank's part, timed
        xp = x16.chunk(n, -1)[0].contiguous()
        m7 = ef.quant_only_absmax(xp)
        a9 = parts[0]
        m9, h9 = ef.gelu_quant_acc_absmax(*a9)
        timed = {  # name: (kernel, plain, bound tensors, operations per element)
            "quant_only_absmax": (lambda: ef.quant_only_absmax(xp),
                                  lambda: ef.quant_only_absmax_ref(xp), [xp, m7], 2),
            "quant_only_scaled": (lambda: ef.quant_only_scaled(xp, m7),
                                  lambda: ef.quant_only_scaled_ref(xp, m7),
                                  [xp, m7, *ef.quant_only_scaled(xp, m7)], 4),
            "gelu_quant_acc_absmax": (lambda: ef.gelu_quant_acc_absmax(*a9),
                                      lambda: ef.gelu_quant_acc_absmax_ref(*a9),
                                      [a9[0], a9[1], a9[2], a9[3].float(), h9, m9], 28),
            "gelu_quant_scaled": (lambda: ef.gelu_quant_scaled(h9, m9),
                                  lambda: ef.gelu_quant_scaled_ref(h9, m9),
                                  [h9, m9, *ef.gelu_quant_scaled(h9, m9)], 26),
        }
        for name, (fn, ref, tensors, per_elem) in timed.items():
            r = dict(library_ms=None, parts=n)
            r["ms"], r["plain_ms"] = in_turns(fn, ref)
            r.update(bound(tensors, float(per_elem * tensors[0].numel()), "f32"))
            print(f"{name} T={ENC_T} width {tensors[0].shape[-1]} (1/{n} of the row): "
                  f"kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound "
                  f"{r['bound_ms']:.4f} ms ({r['bound_by']}) ({card})")
            if n == max(SPLIT_PARTS):
                res[name] = r
        pair7, whole7 = in_turns(lambda: ef.quant_only_scaled(xp, ef.quant_only_absmax(xp)),
                                 lambda: ef.quant_only(x16))
        pair9, whole9 = in_turns(
            lambda: ef.gelu_quant_scaled(*ef.gelu_quant_acc_absmax(*a9)[::-1]),
            lambda: ef.gelu_quant_acc(*w1))
        print(f"split entries at 1/{n} of the row against the whole-row entry on the same "
              f"{ENC_T} rows, in turns: B7 both passes {pair7:.4f} ms against quant_only "
              f"{whole7:.4f} ms; B9 both passes {pair9:.4f} ms against gelu_quant_acc "
              f"{whole9:.4f} ms ({card})")
        res.setdefault("turns", {})[n] = dict(
            b7_pair_ms=pair7, quant_only_ms=whole7, b9_pair_ms=pair9, gelu_quant_acc_ms=whole9)
    for name, err in errs.items():  # measured against the plain versions above
        res[name]["max_abs_err"] = err
    print(f"split entries (B7, B9): {time.perf_counter() - t0:.1f} s")
    return res


def check_f32_rows(card: str) -> dict:
    """The row kernels on float32 rows (the int8 engine on float32 params):
    B5 ``ln_quant``, B7 ``quant_only``, B8 ``add_ln_quant`` and B9
    ``gelu_quant`` on f32 x, y and h, B5 and B8 from the accumulators with
    an f32 residual x, and the qkv epilogue writing f32, at large-v3's
    widths and one window: codes within the envelope and row scales within
    SCALE_RTOL of the plain versions, the f32 residuals and the f32 qkv
    buffer bit for bit, the same bits twice; each timed in turns with its
    plain version beside its bound.  Returns {name: measurements}."""
    import torch

    from ttasr_torch.ops import encoder_fused as ef

    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(12)

    def act(*shape, scale=1.0):
        """f32 activations, rows of different magnitude (not bf16 values)."""
        x = torch.randn(shape, generator=gen, device="cuda") * scale
        return x * (torch.rand(shape[:-1] + (1,), generator=gen, device="cuda") * 3.9 + 0.1)

    ln_s = 1.0 + 0.1 * torch.randn(D, generator=gen, device="cuda")
    ln_b = 0.1 * torch.randn(D, generator=gen, device="cuda")
    x, y, h = act(1, ENC_T, D), act(1, ENC_T, D, scale=0.5), act(1, ENC_T, FFN, scale=2.0)
    w2, wo, qkv = (_acc_case(gen, 1, k, n) for k, n in ((FFN, D), (D, D), (D, 3 * D)))
    cases = {  # name: (kernel, plain, args, elements, operations per element)
        "ln_quant": (ef.ln_quant, ef.ln_quant_ref, (x, ln_s, ln_b), x, 14),
        "quant_only": (ef.quant_only, ef.quant_only_ref, (x,), x, 4),
        "add_ln_quant": (ef.add_ln_quant, ef.add_ln_quant_ref, (x, y, ln_s, ln_b), x, 15),
        "gelu_quant": (ef.gelu_quant, ef.gelu_quant_ref, (h,), h, 26),
        "ln_quant_acc": (ef.ln_quant_acc, ef.ln_quant_acc_ref, (x, *w2, ln_s, ln_b), x, 20),
        "add_ln_quant_acc": (ef.add_ln_quant_acc, ef.add_ln_quant_acc_ref,
                             (x, *wo, ln_s, ln_b), x, 20),
        "qkv_epilogue_acc": (ef.qkv_epilogue_acc, ef.qkv_epilogue_acc_ref,
                             (*qkv, Q_SCALE, torch.float32), qkv[0], 4),
    }
    res = {}
    for name, (fn, ref, args, elems, per_elem) in cases.items():
        got, want = fn(*args), ref(*args)
        case = f"f32 rows B=1 T={ENC_T} width={elems.shape[-1]}"
        if name == "qkv_epilogue_acc":
            check(got.dtype == torch.float32 and torch.equal(got, want),
                  f"{name} {case}: the f32 buffer differs from the plain version")
            print(f"{name} {case}: the f32 buffer equal to the plain version bit for bit")
            err = 0.0
        else:
            if name in ("add_ln_quant", "ln_quant_acc", "add_ln_quant_acc"):
                check(got[0].dtype == torch.float32 and torch.equal(got[0], want[0]),
                      f"{name} {case}: the f32 residual differs from the plain version")
                got, want = got[1:], want[1:]
            err = _hold_codes(name, case, got, want)
        _same_bits(f"{name} {case}", lambda: fn(*args))
        ms, plain_ms = in_turns(lambda: fn(*args), lambda: ref(*args))
        ins = [a for a in args if isinstance(a, torch.Tensor)]
        res[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, **bound(
            _tensors(ins, fn(*args)), float(per_elem * elems.numel()), "f32"))
        print(f"{name} {case}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
              f"{res[name]['bound_ms']:.4f} ms ({res[name]['bound_by']}) ({card})")
    print(f"row kernels on float32 rows: {time.perf_counter() - t0:.1f} s")
    return res


def check_encoder_kernels(card: str) -> dict:
    """B5, B6, B7, B8 and B9 (both entries of B5, B8 and B9) and the qkv
    epilogue against their plain versions, and the int8 GEMM against the
    exact product; returns per-kernel measurements keyed by wrapper name,
    and the GEMM's under ``int8_gemm``."""
    import torch

    from ttasr_torch.ops import encoder_fused as ef
    from ttasr_torch.ops import quant
    from ttasr_torch.ops.encoder_attention import (
        encoder_attention_merged_qkv,
        encoder_attention_merged_qkv_ref,
    )

    gen = torch.Generator(device="cuda").manual_seed(2)

    def act(*shape, scale=1.0):
        """bf16 activations, rows of different magnitude."""
        x = torch.randn(shape, generator=gen, device="cuda") * scale
        spread = torch.rand(shape[:-1] + (1,), generator=gen, device="cuda") * 3.9 + 0.1
        return (x * spread).to(torch.bfloat16)

    ln_s = (1.0 + 0.1 * torch.randn(D, generator=gen, device="cuda")).to(torch.bfloat16)
    ln_b = (0.1 * torch.randn(D, generator=gen, device="cuda")).to(torch.bfloat16)
    res = {}
    for b in (1, 2):
        x, y, h = act(b, ENC_T, D), act(b, ENC_T, D, scale=0.5), act(b, ENC_T, FFN, scale=2.0)
        cases = {  # name: (kernel, plain, args, operations per element)
            "ln_quant": (ef.ln_quant, ef.ln_quant_ref, (x, ln_s, ln_b), 14),
            "quant_only": (ef.quant_only, ef.quant_only_ref, (x,), 4),
            "add_ln_quant": (ef.add_ln_quant, ef.add_ln_quant_ref, (x, y, ln_s, ln_b), 15),
            "gelu_quant": (ef.gelu_quant, ef.gelu_quant_ref, (h,), 26),
        }
        for name, (fn, ref, args, per_elem) in cases.items():
            got, want = fn(*args), ref(*args)
            case = f"B={b} T={ENC_T} width={args[0].shape[-1]}"
            if name == "add_ln_quant":
                check(torch.equal(got[0], want[0]),
                      f"add_ln_quant {case}: the bf16 residual differs")
                got, want = got[1:], want[1:]
            err = _hold_codes(name, case, got, want)
            r = res.setdefault(name, dict(max_abs_err=0.0, library_ms=None))
            r["max_abs_err"] = max(r["max_abs_err"], err)
            if b == 1:
                r["ms"], r["plain_ms"] = in_turns(lambda: fn(*args), lambda: ref(*args))
                # the LN parameters are read as f32
                ins = [a.float() if a.dim() == 1 else a for a in args]
                r.update(bound(_tensors(ins, fn(*args)),
                               float(per_elem * args[0].numel()), "f32"))

    res.update(_check_acc_entries(gen, ln_s, ln_b, act, card))
    split = _check_split_entries(gen, act, card)
    res["split_turns"] = split.pop("turns")
    res.update(split)

    # B6: q/K/V straight from the fused qkv buffer, q pre-scaled
    worst = 0.0
    colscale = torch.ones(3 * D, device="cuda")
    colscale[:D] = 0.125
    for b, t_real in ((1, ENC_T), (2, ENC_T), (2, 1400)):
        qkv = (torch.randn((b, ENC_T, 3 * D), generator=gen, device="cuda") * colscale
               ).to(torch.bfloat16)
        got = encoder_attention_merged_qkv(qkv, t_real)
        want = encoder_attention_merged_qkv_ref(qkv, t_real)
        err = _max_err(got[:, :t_real], want[:, :t_real])
        scale = want[:, :t_real].float().abs().max().item()
        print(f"encoder_attention_merged_qkv B={b} T={ENC_T} t_real={t_real}: "
              f"max_abs_err {err:.3e} (bound {BF16_REL * scale:.3e})")
        check(err <= BF16_REL * scale, f"B6 disagrees with its plain version: {err}")
        worst = max(worst, err)
        if b == 1:
            ms, plain_ms = in_turns(lambda: encoder_attention_merged_qkv(qkv, t_real),
                                    lambda: encoder_attention_merged_qkv_ref(qkv, t_real))
            main = dict(ms=ms, plain_ms=plain_ms, library_ms=_sdpa_ms(
                qkv[..., :D], qkv[..., D:2 * D], qkv[..., 2 * D:], t_real),
                **bound([qkv, got], 4.0 * b * ENC_T * t_real * D, "bf16"))
    res["encoder_attention_merged_qkv"] = dict(max_abs_err=worst, **main)
    _attention_rate(f"encoder_attention_merged_qkv B=1 T={ENC_T}", main,
                    4.0 * ENC_T * ENC_T * D, card)
    res["b6_windows"] = _b6_windows(gen, colscale, card)

    # the int8 GEMM at the encoder's four shapes, K-major codes
    gemm = {}
    for k, n in ((D, 3 * D), (D, D), (D, FFN), (FFN, D)):
        for m in (ENC_T, 2 * ENC_T, 5):
            a = torch.randint(-127, 128, (m, k), generator=gen, device="cuda",
                              dtype=torch.int8)
            w = quant.kmajor(torch.randint(-127, 128, (k, n), generator=gen,
                                           device="cuda", dtype=torch.int8))
            acc = quant._int8_product(a, w)
            exact = torch.matmul(a.double(), w.double())  # |sum| < 2**53: exact
            check(acc.dtype == torch.int32 and torch.equal(acc.double(), exact),
                  f"int8 GEMM M={m} K={k} N={n} differs from the exact product")
        a = torch.randint(-127, 128, (ENC_T, k), generator=gen, device="cuda",
                          dtype=torch.int8)
        acc = quant._int8_product(a, w)
        ab, wb = a.to(torch.bfloat16), w.to(torch.bfloat16)
        xs = torch.rand((ENC_T, 1), generator=gen, device="cuda") * 1e-2
        leaf = {"q": w, "s": torch.rand((1, n), generator=gen, device="cuda") * 1e-3}
        g = dict(ms=time_ms(lambda: quant._int8_product(a, w)),
                 epilogue_ms=time_ms(lambda: quant.quant_matmul_act8(a, xs, leaf)),
                 bf16_matmul_ms=time_ms(lambda: torch.matmul(ab, wb)),
                 **bound([a, w, acc], 2.0 * ENC_T * k * n, "int8"))
        try:  # the layout probe: row-major (K, N) codes
            rm = w.contiguous()
            torch._int_mm(a, rm)
            g["row_major_ms"] = time_ms(lambda: torch._int_mm(a, rm))
        except RuntimeError as exc:
            g["row_major_ms"] = f"refused: {str(exc).splitlines()[0][:120]}"
        gemm[f"{ENC_T}x{k}x{n}"] = g
        print(f"int8 GEMM M={ENC_T} K={k} N={n}: _int_mm {g['ms']:.4f} ms, with "
              f"the scale/bias epilogue {g['epilogue_ms']:.4f} ms, bf16 matmul "
              f"{g['bf16_matmul_ms']:.4f} ms, bound {g['bound_ms']:.4f} ms, "
              f"row-major codes {g['row_major_ms']} ({card})")
    try:
        quant._int8_product(a, w.contiguous())
        check(False, "the GEMM wrapper took row-major codes")
    except ValueError:
        pass
    print("int8 GEMM: int32 accumulators equal the exact product at every shape")
    for name in ("ln_quant", "quant_only", "add_ln_quant", "gelu_quant",
                 "encoder_attention_merged_qkv"):
        r = res[name]
        print(f"{name}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}) ({card})")
    res["int8_gemm"] = gemm
    return res


# ---------------------------------------------------------------------------
# Phase 6: the kernels of the decode's other branches at large-v3 shapes
# ---------------------------------------------------------------------------

BEAM_ROWS, CACHE_LEN = 5, 480  # B17: beam 5 of one audio, the last bucket


def check_branch_kernels(card: str) -> dict:
    """B12, B13 and B17 against their plain versions; returns per-kernel
    measurements keyed by wrapper name."""
    import torch

    from ttasr_torch.ops import beam_gather as bg
    from ttasr_torch.ops import cross_attention as ca
    from ttasr_torch.ops import decoder_blocks as blk

    inp = Inputs(3)
    lay = inp.layer()
    res = {}

    # B12: 5 rows (a bf16 cross-KV at beam 5) and 10 (beam 10 of one audio)
    worst = 0.0
    for r in (5, 10):
        b12 = (inp.randn(r, D, scale=0.5), inp.randn(r, D, scale=0.5),
               lay["wo"], lay["wo_s"], lay["bo"], lay["lnc_s"], lay["lnc_b"],
               lay["wqc"], lay["wqc_s"], lay["bqc"])
        got, want = blk.attnout_ln_q_fused(*b12), blk.attnout_ln_q_fused_ref(*b12)
        worst = _hold("attnout_ln_q_fused", f"R={r} x'", got[0], want[0], worst)
        worst = _hold("attnout_ln_q_fused", f"R={r} qc", got[1], want[1], worst)
    ms, plain_ms = in_turns(lambda: blk.attnout_ln_q_fused(*b12),
                            lambda: blk.attnout_ln_q_fused_ref(*b12))
    res["attnout_ln_q_fused"] = dict(
        max_abs_err=worst, ms=ms, plain_ms=plain_ms,
        **bound(_tensors(b12, blk.attnout_ln_q_fused(*b12)), 2.0 * 2 * 10 * D * D, "bf16"))

    # B13: bf16 queries (the served dtype) over int8 and int4 cross-KV
    worst, main = 0.0, None
    for b, k in ((1, 5), (5, 1), (1, 8)):
        for int4 in (False, True):
            ck, cks, cv, cvs = inp.cross_kv(b, int4)
            b13 = (inp.randn(b, k, H, 64, scale=0.5).to(torch.bfloat16),
                   ck, cks, cv, cvs, S_REAL)
            case = f"B={b} K={k} {'int4' if int4 else 'int8'} cross-KV"
            worst = _hold("cross_attention_int8", case, ca.cross_attention_int8(*b13),
                          ca.cross_attention_int8_ref(*b13), worst)
            if (b, k, int4) == (1, 5, False):  # the unfused beam leg's shape
                main = b13
    for int4 in (False, True):  # a whole split of the cache masked
        b13 = (main[0], *inp.cross_kv(1, int4), MASKED_S_REAL)
        got = ca.cross_attention_int8(*b13)
        case = (f"B=1 K=5 {'int4' if int4 else 'int8'} cross-KV s_real={MASKED_S_REAL} "
                f"(a whole split masked)")
        check(bool(torch.isfinite(got).all()), f"cross_attention_int8 {case}: not finite")
        worst = _hold("cross_attention_int8", case, got, ca.cross_attention_int8_ref(*b13), worst)
    ms, plain_ms = in_turns(lambda: ca.cross_attention_int8(*main),
                            lambda: ca.cross_attention_int8_ref(*main))
    # scores and values of 5 rows over the S_REAL valid slots
    res["cross_attention_int8"] = dict(
        max_abs_err=worst, ms=ms, plain_ms=plain_ms,
        **bound(_tensors(main, ca.cross_attention_int8(*main)),
                2.0 * 2 * 5 * S_REAL * D, "bf16"))

    # B17: every layer's rows of a beam-5 cache, held byte for byte on a
    # top-k's index (a repeat, a drop and a move) and on a permutation;
    # timed and bounded on the permutation, which reads every row once
    top_k_idx, perm = (torch.tensor(i, dtype=torch.int32, device="cuda")
                       for i in ([3, 3, 0, 4, 1], [3, 0, 4, 1, 2]))
    for int4 in (False, True):
        width, dtype, lo, hi = ((D // 2, torch.uint8, 0, 256) if int4
                                else (D, torch.int8, -128, 128))
        codes = [torch.randint(lo, hi, (N_LAYERS, BEAM_ROWS, CACHE_LEN, width),
                               generator=inp.gen, device="cuda", dtype=dtype)
                 for _ in range(2)]
        scales = [inp.randn(N_LAYERS, BEAM_ROWS, HP, CACHE_LEN) for _ in range(2)]
        b17 = (*codes, *scales)
        spare = tuple(torch.empty_like(t) for t in b17)
        for idx in (top_k_idx, perm):
            got = bg.gather_cache_rows(*b17, idx, out=spare)
            want = bg.gather_cache_rows_ref(*b17, idx)
            for g, w in zip(got, want):
                check(torch.equal(g.view(torch.uint8), w.view(torch.uint8)),
                      f"gather_cache_rows {'int4' if int4 else 'int8'} "
                      f"idx {idx.tolist()}: bytes differ from index_select")
        print(f"gather_cache_rows L={N_LAYERS} BK={BEAM_ROWS} T={CACHE_LEN} "
              f"{'int4' if int4 else 'int8'}: equal to index_select byte for byte")
    ms, plain_ms = in_turns(lambda: bg.gather_cache_rows(*b17, perm, out=spare),
                            lambda: bg.gather_cache_rows_ref(*b17, perm))
    long_perm = perm.long()
    library_ms = time_ms(lambda: [torch.index_select(t, 1, long_perm, out=o)
                                  for t, o in zip(b17, spare)])
    res["gather_cache_rows"] = dict(
        max_abs_err=0.0, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
        **bound(_tensors((*b17, perm), spare), 0.0, "f32"))

    for name, r in res.items():
        r.setdefault("library_ms", None)  # no single PyTorch call for B12, B13
        print(f"{name}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
              f"library {r['library_ms']}, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}) ({card})")
    return res


ODD_HEADS = (5, 3)  # B13 on a shard's odd local heads: large-v3 at model 4, d 384 at 2


def check_b13_odd_heads(card: str) -> dict:
    """B13 on odd head counts (a tensor-parallel shard's local heads, int8
    cross-KV): h = 5 and 3, K = 1..5 beam rows of one audio, S = 1500,
    against its plain version within DECODE_REL x max|plain|; at h = 5, K = 5
    (large-v3's shard on a (1, 4) mesh, beam 5) timed beside it with its
    bound.  Returns its measurements."""
    import torch

    from ttasr_torch.ops import cross_attention as ca

    worst, main = 0.0, None
    for h in ODD_HEADS:
        inp = Inputs(19 + h, d=64 * h, h=h)
        ck, cks, cv, cvs = inp.cross_kv(1, False)
        for k in range(1, 6):
            b13 = (inp.randn(1, k, h, 64, scale=0.5).to(torch.bfloat16), ck, cks, cv, cvs,
                   S_REAL)
            got, want = ca.cross_attention_int8(*b13), ca.cross_attention_int8_ref(*b13)
            err = _max_err(got, want)
            limit = DECODE_REL * want.float().abs().max().item()
            print(f"cross_attention_int8 h={h} K={k} S={S_REAL}: max_abs_err {err:.3e} "
                  f"(bound {limit:.3e})")
            check(err <= limit, f"B13 at h={h} K={k} disagrees with its plain version: {err}")
            worst = max(worst, err / max(want.float().abs().max().item(), 1e-30))
            if (h, k) == (5, 5):
                main = b13
    ms, plain_ms = in_turns(lambda: ca.cross_attention_int8(*main),
                            lambda: ca.cross_attention_int8_ref(*main))
    m = dict(max_rel_err=worst, ms=ms, plain_ms=plain_ms,
             **bound(_tensors(main, ca.cross_attention_int8(*main)),
                     2.0 * 2 * 5 * S_REAL * 5 * 64, "bf16"))
    print(f"cross_attention_int8 h=5 K=5 (a (1, 4) shard of large-v3): kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, bound {m['bound_ms']:.4f} ms ({m['bound_by']}) ({card})")
    return m


# ---------------------------------------------------------------------------
# Phase 7: the tensor-parallel kernels at large-v3 shard shapes
# ---------------------------------------------------------------------------

def check_tp_kernels(card: str) -> dict:
    """B15, B14 and B16 against their plain versions at the shapes of a
    model axis of n = 1 and n = 2 (a shard's rows of wo/wo_c/w2, columns of
    w1 and cross-q, local heads); timed at n = 1 with 5 rows, the one-card
    TP leg's shapes.  Returns per-kernel measurements keyed by wrapper
    name."""
    import torch

    from ttasr_torch.ops import decoder_blocks as blk
    from ttasr_torch.ops import decoder_mlp as mlp

    inp = Inputs(4)
    res = {}

    # B15: a shard's DL = D / n input columns, 5 and 10 rows
    worst, main = 0.0, None
    for n in (1, 2):
        wq, ws = inp.weight(D // n, D)
        for r in (5, 10):
            b15 = (inp.randn(r, D // n, scale=0.5), wq, ws)
            worst = _hold("matmul_int8_partial", f"n={n} DL={D // n} R={r}",
                          blk.matmul_int8_partial(*b15),
                          blk.matmul_int8_partial_ref(*b15), worst)
            if (n, r) == (1, 5):
                main = b15
    _same_bits("matmul_int8_partial n=1 R=5", lambda: blk.matmul_int8_partial(*main))
    ms, plain_ms = in_turns(lambda: blk.matmul_int8_partial(*main),
                            lambda: blk.matmul_int8_partial_ref(*main))
    x, wq, ws = main
    w_bf16 = wq.to(torch.bfloat16)  # cast once, outside the timed call
    library_ms = time_ms(lambda: torch.matmul(x.to(torch.bfloat16), w_bf16))
    res["matmul_int8_partial"] = dict(
        max_abs_err=worst, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
        **bound(_tensors(main, blk.matmul_int8_partial(*main)),
                2.0 * 5 * D * D, "bf16"))
    # cold: the 64 row-split projections of a TP v2 step (wo, wo_c per
    # layer), and the library call over the same weights cast to bf16
    weights = [inp.weight(D, D) for _ in range(2 * N_LAYERS)]
    cold_ms = time_cold_ms([lambda w=w: blk.matmul_int8_partial(x, *w) for w in weights])
    cold_bf16 = [w.to(torch.bfloat16) for w, _ in weights]
    cold_library_ms = time_cold_ms(
        [lambda w=w: torch.matmul(x.to(torch.bfloat16), w) for w in cold_bf16])
    del weights, cold_bf16
    print(f"matmul_int8_partial R=5 DL=1280: warm {ms:.4f} ms, library {library_ms:.4f}; "
          f"cold {cold_ms:.4f}, library cold {cold_library_ms:.4f} (a graph over "
          f"{2 * N_LAYERS} weights); time_ms floor {time_ms_floor():.4f} ms ({card})")

    # B14: F / n hidden columns, partial (TP v2) and full, 5 and 8 rows
    worst, main = 0.0, None
    for n in (1, 2):
        f = FFN // n
        w1, w1_s = inp.weight(D, f)
        w2, w2_s = inp.weight(f, D)
        vecs = (inp.vec(D, 0.1, 1.0), inp.vec(D, 0.1), w1, w1_s, inp.vec(f),
                w2, w2_s, inp.vec(D))
        for r in (5, 8):
            for partial in (True, False):
                b14 = (inp.randn(r, D, scale=0.5), *vecs)
                worst = _hold("mlp_int8_fused", f"n={n} F={f} R={r} partial={partial}",
                              mlp.mlp_int8_fused(*b14, partial=partial),
                              mlp.mlp_int8_fused_ref(*b14, partial=partial), worst)
                if (n, r, partial) == (1, 5, True):
                    main = b14
    _same_bits("mlp_int8_fused n=1 R=5 partial", lambda: mlp.mlp_int8_fused(*main, partial=True))
    n_kernels = _kernels_per_call("mlp_int8_fused n=1 R=5 partial",
                                  lambda: mlp.mlp_int8_fused(*main, partial=True))
    print(f"mlp_int8_fused n=1 R=5 partial: {n_kernels:.0f} CUDA kernel(s) per call, in a "
          f"graph of 20 {per_call_ms(lambda: mlp.mlp_int8_fused(*main, partial=True)):.4f} ms "
          f"({card})")
    check(n_kernels == 1, f"mlp_int8_fused ran {n_kernels} CUDA kernels per call, not 1")
    ms, plain_ms = in_turns(lambda: mlp.mlp_int8_fused(*main, partial=True),
                            lambda: mlp.mlp_int8_fused_ref(*main, partial=True))
    res["mlp_int8_fused"] = dict(
        max_abs_err=worst, ms=ms, plain_ms=plain_ms,
        **bound(_tensors(main, mlp.mlp_int8_fused(*main, partial=True)),
                2.0 * 5 * 2 * D * FFN, "bf16"))

    # B16: H / n local heads over int4 and int8 cross-KV, (B, K) = (1, 5)
    # and (5, 1), 1500 of 1504 slots valid
    worst, main = 0.0, None
    for n in (1, 2):
        h_loc = H // n
        wqc, wqc_s = inp.weight(D, h_loc * 64)
        for b, k in ((1, 5), (5, 1)):
            for int4 in (True, False):
                ck, cks, cv, cvs = inp.cross_kv(b, int4)
                ck, cv = (t[..., :h_loc * 64].contiguous() for t in (ck, cv))
                cks, cvs = (t[:, :h_loc].contiguous() for t in (cks, cvs))
                b16 = (inp.randn(b, k, D, scale=0.5), inp.vec(D, 0.1, 1.0),
                       inp.vec(D, 0.1), wqc, wqc_s, inp.vec(h_loc * 64),
                       ck, cks, cv, cvs, S_REAL)
                case = f"n={n} H_loc={h_loc} B={b} K={k} {'int4' if int4 else 'int8'} cross-KV"
                worst = _hold("ln_q_cross_int8", case, blk.ln_q_cross_int8(*b16),
                              blk.ln_q_cross_int8_ref(*b16), worst)
                if (n, b, k, int4) == (1, 1, 5, True):
                    main = b16
    for int4 in (True, False):  # n = 1, beam 5, a whole split of the cache masked
        b16 = main[:6] + tuple(inp.cross_kv(1, int4)) + (MASKED_S_REAL,)
        got = blk.ln_q_cross_int8(*b16)
        case = (f"n=1 B=1 K=5 {'int4' if int4 else 'int8'} cross-KV s_real={MASKED_S_REAL} "
                f"(a whole split masked)")
        check(bool(torch.isfinite(got).all()), f"ln_q_cross_int8 {case}: not finite")
        worst = _hold("ln_q_cross_int8", case, got, blk.ln_q_cross_int8_ref(*b16), worst)
    ms, plain_ms = in_turns(lambda: blk.ln_q_cross_int8(*main),
                            lambda: blk.ln_q_cross_int8_ref(*main))
    # the cross query (2 R D DC), scores and values over S_REAL
    res["ln_q_cross_int8"] = dict(
        max_abs_err=worst, ms=ms, plain_ms=plain_ms,
        **bound(_tensors(main, blk.ln_q_cross_int8(*main)),
                2.0 * 5 * D * D + 2.0 * 2 * 5 * S_REAL * D, "bf16"))

    for name, r in res.items():
        r.setdefault("library_ms", None)  # no single PyTorch call for B14, B16
        print(f"{name}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
              f"library {r['library_ms']}, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}) ({card})")
    return res


@contextlib.contextmanager
def plain_encoder_kernels():
    """The s8 x s8 encoder on the plain versions of B5-B9, both entries of
    B5, B8 and B9, and the qkv epilogue (the int8 GEMM is exact either
    way)."""
    from ttasr_torch.models.whisper import model
    from ttasr_torch.ops import encoder_fused as ef
    from ttasr_torch.ops import encoder_attention as ea

    saved = [(ef, n, getattr(ef, n)) for n in ("ln_quant", "quant_only", "add_ln_quant",
                                               "gelu_quant", "gelu_quant_acc",
                                               "ln_quant_acc", "add_ln_quant_acc",
                                               "qkv_epilogue_acc")]
    saved.append((model, "encoder_attention_merged_qkv", model.encoder_attention_merged_qkv))
    try:
        for mod, name, _ in saved[:-1]:
            setattr(mod, name, getattr(ef, name + "_ref"))
        model.encoder_attention_merged_qkv = ea.encoder_attention_merged_qkv_ref
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def _act8_encoder_launches(passes: int, gemms: int = 4, layers: int = N_LAYERS) -> dict:
    """The fused-quant s8 x s8 encoder's row-kernel and GEMM launches over
    ``passes`` passes of ``layers`` layers: B5 from x in layer 0 and from
    W2's accumulators in the layers after it, B9 from W1's and B8 from wo's
    accumulators, B7 and ``gemms`` int8 GEMMs per layer (4 with the fused
    qkv leaf, whose accumulators go to the qkv epilogue, 6 without)."""
    L = layers
    want = dict(ln_quant=passes, ln_quant_acc=(L - 1) * passes, quant_only=L * passes,
                add_ln_quant_acc=L * passes, gelu_quant_acc=L * passes,
                quant_matmul_act8=gemms * L * passes)
    if gemms == 4:
        want["qkv_epilogue_acc"] = L * passes
    return want


@contextlib.contextmanager
def parent_encoder_route(bf16_entries: bool = False):
    """The s8 x s8 encoder as the parent tree ran it: the qkv epilogue's
    column scale built per call and its torch epilogue, wo's torch
    epilogue and the bf16 entry of B8, in place of the entries that read
    the accumulators.  ``bf16_entries``: also W1's and W2's torch
    epilogues, the eager residual add and the bf16 entries of B9 and B5
    (the route before the accumulator entries; the last layer's W2
    epilogue and add run in ``encode`` on every route)."""
    from ttasr_torch.ops import encoder_fused as ef

    swap = dict(add_ln_quant_acc=parent_add_ln_quant_acc,
                qkv_epilogue_acc=ef.qkv_epilogue_acc_ref)
    if bf16_entries:
        swap.update(gelu_quant_acc=parent_gelu_quant_acc, ln_quant_acc=parent_ln_quant_acc)
    saved = {name: getattr(ef, name) for name in swap}
    try:
        for name, fn in swap.items():
            setattr(ef, name, fn)
        yield
    finally:
        for name, fn in saved.items():
            setattr(ef, name, fn)


def _encoder_windows(engine, batch, label: str, card: str) -> dict:
    """``batch`` (bench.py's MEL_WINDOWS windows) through the engine's
    encoder: the wall of a call ended by a synchronise (median of 3 after a
    warm-up), the peak device memory of one call, and one call under
    ``torch.profiler`` (device ms, kernels)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    times = []
    for i in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.encode_windows(batch)
        torch.cuda.synchronize()
        if i:
            times.append((time.perf_counter() - t0) * 1e3)
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = engine.encode_windows(batch)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    del out
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        engine.encode_windows(batch)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    m = dict(wall_ms=sorted(times)[1], device_ms=sum(e.self_device_time_total
                                                     for e in kernels) / 1e3,
             kernels=sum(e.count for e in kernels), peak_gib=peak / 2 ** 30,
             peak_above_weights_gib=(peak - base) / 2 ** 30)
    print(f"{label}: {len(batch)} windows, wall {m['wall_ms']:.2f} ms (median of 3, "
          f"mel included), device {m['device_ms']:.2f} ms in {m['kernels']} kernels, "
          f"peak memory {m['peak_gib']:.2f} GiB ({m['peak_above_weights_gib']:.2f} above "
          f"what was allocated before) ({card})")
    return m


def compare_encoder_routes(engine, audio, card: str) -> dict:
    """The main path's s8 x s8 encoder through this tree's route and the
    parent route (:func:`parent_encoder_route`) on the same engine: one
    window through each, and through the route of the bf16 entries
    (finite, within ENCODER_REL of this tree's, the largest gaps printed;
    each route's row-kernel launch counts); one window timed and profiled
    by :func:`encoder_ms` and MEL_WINDOWS windows by
    :func:`_encoder_windows`, each in turns (parent, this tree, this tree,
    parent).  Returns the readings and each route's launches per pass
    (``counts``): the parent route's give ``add_ln_quant`` its launches,
    the bf16-entry route's ``gelu_quant``."""
    import torch

    from ttasr_torch.ops import encoder_fused as ef

    t0 = time.perf_counter()
    L = N_LAYERS
    counters = (ef.ln_quant, ef.ln_quant_acc, ef.add_ln_quant, ef.add_ln_quant_acc,
                ef.gelu_quant, ef.gelu_quant_acc, ef.qkv_epilogue_acc)
    routes = {  # name: (context, expected launches per pass)
        "tree": (contextlib.nullcontext, dict(
            ln_quant=1, ln_quant_acc=L - 1, add_ln_quant_acc=L, gelu_quant_acc=L,
            qkv_epilogue_acc=L)),
        "parent": (parent_encoder_route, dict(
            ln_quant=1, ln_quant_acc=L - 1, add_ln_quant=L, gelu_quant_acc=L)),
        "bf16 entries": (functools.partial(parent_encoder_route, bf16_entries=True),
                         dict(ln_quant=L, add_ln_quant=L, gelu_quant=L)),
    }
    outs, counts = {}, {}
    with torch.inference_mode():
        for route, (ctx, want) in routes.items():
            for fn in counters:
                fn.launches = 0
            with ctx():
                outs[route] = engine.encode_windows(audio[None])
            counts[route] = {fn.__name__: fn.launches for fn in counters}
            _expect(f"{route} route, one window", counts[route], want)
    new = outs["tree"]
    check(bool(torch.isfinite(new).all()), "s8 x s8 encoder: non-finite output")
    scale = new.float().abs().max().item()
    gaps = {}
    for route in ("parent", "bf16 entries"):
        old = outs[route]
        check(old.shape == new.shape, f"s8 x s8 encoder: shapes differ ({route} route)")
        gaps[route] = _max_err(new, old)
        print(f"s8 x s8 encoder, this tree's route vs the {route} route: largest gap "
              f"{gaps[route]:.3e}, max|tree| {scale:.3e}, bit for bit: "
              f"{torch.equal(new, old)}")
        check(gaps[route] <= ENCODER_REL * scale, f"the tree and {route} routes disagree")
    print(f"s8 x s8 encoder, row-kernel launches per pass: {json.dumps(counts)}")
    batch = np.stack([audio] * MEL_WINDOWS)
    res = dict(max_gap=gaps["parent"], counts=counts)
    for route in ("parent", "tree", "tree", "parent"):
        ctx = parent_encoder_route() if route == "parent" else contextlib.nullcontext()
        with ctx:
            label = f"s8 x s8 encoder, {'parent' if route == 'parent' else 'this tree'}'s route"
            one = encoder_ms(engine, audio, label, card)
            many = _encoder_windows(engine, batch, label, card)
        res.setdefault(route, []).append(dict(one_window=one, windows=many))
    print("s8 x s8 encoder routes: " + json.dumps({r: [dict(
        one_window={k: v["one_window"][k] for k in ("wall_ms", "device_ms", "kernels")},
        windows=v["windows"]) for v in res[r]] for r in ("parent", "tree")}) + f" ({card})")
    print(f"s8 x s8 encoder routes compared in {time.perf_counter() - t0:.1f} s")
    return res


# ---------------------------------------------------------------------------
# Phase 8: B18 and B19, the two kernels no engine path calls
# ---------------------------------------------------------------------------

MEL_ABS = 2e-4  # B18 vs its plain version: the Pallas kernel's contract
MEL_WINDOWS = 48  # bench.py's window count
N_MELS = 128  # large-v3
ATTN_SHAPE = (1, 1500, 20, 64)  # large-v3's encoder self-attention heads


def _mel_batch(clips):
    """MEL_WINDOWS rows of 45 s: the 45 s clip and the 20 s clip followed
    by silence, in turns, each rolled and scaled differently."""
    import torch
    import torch.nn.functional as F

    a20, a45 = clips["speech20"], clips["speech45"]
    rows = [torch.roll(a45 if i % 2 else F.pad(a20, (0, a45.numel() - a20.numel())),
                       7919 * i) * (0.5 + i / (2 * MEL_WINDOWS))
            for i in range(MEL_WINDOWS)]
    return torch.stack(rows).contiguous()


N_FFT, N_FREQS = 400, 201  # Whisper's frame and its one-sided spectrum


def _log_mel_frame_flop(n_fb: int) -> float:
    """Float operations one frame of the log-mel needs at the least: the
    window (N_FFT multiplies), a real FFT of N_FFT points (2.5 N log2 N, half
    of a complex FFT's 5 N log2 N), the power (3 per bin), the mel
    projection over the bank's ``n_fb`` nonzeros (2 each), and the floor
    and log10 of each mel (2 each)."""
    return (N_FFT + 2.5 * N_FFT * np.log2(N_FFT) + 3 * N_FREQS + 2 * n_fb
            + 2 * N_MELS)


def check_standalone_kernels(card: str) -> tuple:
    """B18 ``log_mel_spectrogram_fused`` and B19 ``encoder_self_attention``
    driven through their entry points as the JAX golden test drives the
    Pallas kernels (no engine path calls either, in either package): B18
    on the 20 s (padded) and 45 s (cut) clips at B = 1 and on
    MEL_WINDOWS windows, B19 at large-v3's encoder shape in bf16 and
    float32.  Counts set to 0 just before that run and read just after;
    each output held to its plain version on the same inputs; timed as in
    phase 4.  Returns ({name: measured}, {name: launches})."""
    import torch

    from ttasr_torch.ops.encoder_attention import (
        encoder_self_attention,
        encoder_self_attention_ref,
    )
    from ttasr_torch.ops.mel import log_mel_spectrogram, mel_filter_bank
    from ttasr_torch.ops.mel_fused import (
        log_mel_spectrogram_fused,
        log_mel_spectrogram_fused_ref,
    )

    t_phase = time.perf_counter()
    clips = {name: torch.from_numpy(synth_speech(np.random.default_rng(seed),
                                                 seconds)[0]).cuda()
             for name, seconds, seed in AUDIO}
    mel_in = {f"B=1 {name}": clip for name, clip in clips.items()}
    mel_in[f"B={MEL_WINDOWS}"] = _mel_batch(clips)
    gen = torch.Generator(device="cuda").manual_seed(8)
    qkv32 = [torch.randn(ATTN_SHAPE, generator=gen, device="cuda") for _ in range(3)]
    attn_in = {"bf16": [x.to(torch.bfloat16) for x in qkv32], "f32": qkv32}

    counters = (log_mel_spectrogram_fused, encoder_self_attention)
    for c in counters:
        c.launches = 0
    torch.cuda.synchronize()
    mel_out = {key: log_mel_spectrogram_fused(x, N_MELS) for key, x in mel_in.items()}
    attn_out = {key: encoder_self_attention(*x) for key, x in attn_in.items()}
    torch.cuda.synchronize()
    launches = {c.__name__: c.launches for c in counters}
    # B18: the FFT kernel, then the one that clamps and rescales
    _expect("phase 8", launches, {"log_mel_spectrogram_fused": 2 * len(mel_in),
                                  "encoder_self_attention": len(attn_in)})
    print(f"phase 8 launches: {json.dumps(launches)}")

    worst_mel = 0.0
    for key, x in mel_in.items():
        got, want = mel_out[key], log_mel_spectrogram_fused_ref(x, N_MELS)
        err = _max_err(got, want)
        # the float32 frontend's own distance from the float64 plain
        # version, for comparison (the DFT cancels near the floor)
        f32_err = _max_err(log_mel_spectrogram(x, N_MELS), want)
        print(f"log_mel_spectrogram_fused {key} ({x.shape[-1] / SR:.0f} s): max_abs_err "
              f"{err:.3e} (bound {MEL_ABS:.0e}); ops/mel.py float32 {f32_err:.3e}")
        check(got.shape == want.shape == x.shape[:-1] + (N_MELS, 3000)
              and bool(torch.isfinite(got).all()), f"B18 {key}: shape "
              f"{tuple(got.shape)} or non-finite values")
        check(err <= MEL_ABS, f"B18 {key} disagrees with its plain version: "
                              f"{err} > {MEL_ABS}")
        worst_mel = max(worst_mel, err)
    worst_attn = 0.0
    for key, x in attn_in.items():
        got, want = attn_out[key], encoder_self_attention_ref(*x)
        err = _max_err(got, want)
        limit = BF16_REL * want.float().abs().max().item()
        print(f"encoder_self_attention {key} {ATTN_SHAPE}: max_abs_err {err:.3e} "
              f"(bound {limit:.3e})")
        check(err <= limit, f"B19 {key} disagrees with its plain version: "
                            f"{err} > {limit}")
        check(torch.equal(got, got.to(torch.bfloat16).to(got.dtype)),
              f"B19 {key}: output not rounded to bf16")
        worst_attn = max(worst_attn, err)

    names = _kernel_names(lambda: log_mel_spectrogram_fused(mel_in[f"B={MEL_WINDOWS}"],
                                                            N_MELS))
    print(f"log_mel_spectrogram_fused B={MEL_WINDOWS}: one call's CUDA kernels "
          f"{json.dumps(names)}")
    check(len(names) == 2 and set(names.values()) == {1}
          and all("log_mel" in nm for nm in names),
          f"B18 ran other kernels than mel.cu's two: {names}")

    n_fb = int(np.count_nonzero(mel_filter_bank(N_MELS)))
    measured = {}
    for key, x in mel_in.items():
        kernel_ms, plain_ms = in_turns(lambda: log_mel_spectrogram_fused(x, N_MELS),
                                       lambda: log_mel_spectrogram_fused_ref(x, N_MELS))
        flop = x.reshape(-1, x.shape[-1]).shape[0] * 3000 * _log_mel_frame_flop(n_fb)
        m = dict(max_abs_err=worst_mel, ms=kernel_ms, plain_ms=plain_ms,
                 library_ms=time_ms(lambda: log_mel_spectrogram(x, N_MELS)),
                 **bound([x[..., :480000], mel_out[key]], flop, "f32"))
        print(f"log_mel_spectrogram_fused {key}: kernel {kernel_ms:.4f} ms, plain (float64) "
              f"{plain_ms:.4f} ms, library (ops/mel.py, f32 cuBLAS matmuls and unfold) "
              f"{m['library_ms']:.4f} ms; bound {m['bound_ms']:.4f} ms ({m['bound_by']}; "
              f"{flop / 1e9:.3f} GFLOP by a real FFT and the {n_fb} nonzeros of the mel "
              f"bank, {flop / PEAK_OPS_PER_S['f32'] * 1e3:.4f} ms at the f32 peak), "
              f"{m['bound_ms'] / kernel_ms:.1%} of it ({card})")
        if key == f"B={MEL_WINDOWS}":  # the numbers of the kernels line
            measured["log_mel_spectrogram_fused"] = m

    b, t, h, dh = ATTN_SHAPE
    for key, x in attn_in.items():
        kernel_ms, plain_ms = in_turns(lambda: encoder_self_attention(*x),
                                       lambda: encoder_self_attention_ref(*x))
        print(f"encoder_self_attention {key}: kernel {kernel_ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms ({card})")
        if key == "bf16":
            merged = [y.view(b, t, h * dh) for y in x]
            measured["encoder_self_attention"] = dict(
                max_abs_err=worst_attn, ms=kernel_ms, plain_ms=plain_ms,
                library_ms=_sdpa_ms(*merged, t, scale=dh ** -0.5),
                **bound(x + [attn_out[key]], 4.0 * b * h * t * t * dh, "bf16"))
    m = measured["encoder_self_attention"]
    print(f"encoder_self_attention bf16: scaled_dot_product_attention "
          f"{m['library_ms']:.4f} ms, bound {m['bound_ms']:.4f} ms ({card})")
    _attention_rate("encoder_self_attention bf16", m, 4.0 * b * h * t * t * dh, card)
    print(f"phase 8 (B18, B19): {time.perf_counter() - t_phase:.1f} s")
    return measured, launches


# ---------------------------------------------------------------------------
# Phases 9, 10 and 13: the CLI paths end to end
# ---------------------------------------------------------------------------

SR = 16000


def synth_speech(rng, seconds=3.0):
    """Speech-like audio and its per-frame labels from
    ``ttasr_torch/tools/synth.py`` (the VAD trainer's synthesizer; the smoke
    run's audio has come from it since the port began)."""
    from ttasr_torch.tools.synth import synth_speech as synth

    return synth(rng, seconds)


AUDIO = (("speech20", 20.0, 0), ("speech45", 45.0, 1))


def _write_wavs(audio_dir: str, files):
    """``files``: (name, seconds, seed) of synthesized speech, written as
    16-bit WAVs; returns their audio seconds and the first audio."""
    from ttasr_torch.audio.io import write_wav

    total, first = 0.0, None
    for name, seconds, seed in files:
        audio, _ = synth_speech(np.random.default_rng(seed), seconds)
        write_wav(os.path.join(audio_dir, f"{name}.wav"), audio, SR)
        total += seconds
        first = audio if first is None else first
    return total, first


def _drive_cli(engine, label: str, card: str, counters, n_files: int = 2,
               files=None, **mode) -> dict:
    """process_audio_folder over the first ``n_files`` WAVs of ``AUDIO`` (or
    ``files``) with ``engine`` and the CLI's ``mode`` keywords
    (``concurrency``, ``batched``); counts are set to 0 just before and read
    just after.  Returns the counts, the decode stats of the run, the first
    audio and timing."""
    import torch

    from ttasr_torch.cli.asr import process_audio_folder

    files = AUDIO[:n_files] if files is None else files
    with tempfile.TemporaryDirectory() as tmp:
        audio_dir = os.path.join(tmp, "audio")
        os.makedirs(audio_dir)
        audio_seconds, first = _write_wavs(audio_dir, files)
        before = dict(engine.decode_stats)
        for fn in counters:
            fn.launches = 0
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = process_audio_folder(audio_dir, model="large-v3", engine=engine,
                                      results_json_dir=tmp, **mode)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {fn.__name__: fn.launches for fn in counters}

    check(result is not None, f"{label}: process_audio_folder returned None")
    entries = result["detailed_results"]
    check(len(entries) == len(files),
          f"{label}: expected {len(files)} results, got {len(entries)}")
    for entry in entries:
        check("error" not in entry, f"{label} {entry['audio_file']}: {entry.get('error')}")
    stats = {k: engine.decode_stats[k] - before[k] for k in before}
    print(f"{label} decode stats: {json.dumps(stats)}")
    check(stats["beam_decodes"] > 0 and stats["beam_steps"] > 0,
          f"{label}: no beam decode step ran")
    check(stats["nonfinite_logits"] == 0, f"{label}: a decode produced non-finite logits")
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"{label}: {len(files)} files, {audio_seconds:.1f} s of audio, wall {wall:.2f} s = "
          f"{wall / audio_seconds:.4f} s per audio second, peak memory "
          f"{peak_gib:.2f} GiB ({card})")
    print(f"{label} launches: {json.dumps(counts)}")
    for entry in entries:
        print(f"  {entry['audio_file']}: {len(entry['asr_result'] or '')} chars")
    return dict(counts=counts, stats=stats, first=first, wall=wall,
                audio_seconds=audio_seconds, peak_gib=peak_gib)


def encoder_ms(engine, audio, label: str, card: str) -> dict:
    """One 30 s window through ``engine``'s encoder (mel included): the
    wall milliseconds, median of 5 calls after a warm-up, each ended by a
    synchronise; then one call under ``torch.profiler``: the device time,
    the kernels it ran and the longest of them."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    times = []
    for i in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.encode_windows(audio[None])
        torch.cuda.synchronize()
        if i:
            times.append((time.perf_counter() - t0) * 1e3)
    wall = sorted(times)[len(times) // 2]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        engine.encode_windows(audio[None])
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = {e.key: e.self_device_time_total for e in kernels}
    device_ms = sum(dev_us.values()) / 1e3
    n_kernels = sum(e.count for e in kernels)
    top = sorted(dev_us.items(), key=lambda kv: -kv[1])[:8]
    print(f"{label}: encoder {wall:.2f} ms per 30 s window (mel included; median "
          f"of 5); profiled call: {device_ms:.2f} ms of device time in {n_kernels} "
          f"kernels, busy {device_ms / wall:.0%} ({card})")
    for name, us in top:
        print(f"    {us / 1e3:8.3f} ms  {name[:100]}")
    return dict(wall_ms=wall, device_ms=device_ms, kernels=n_kernels,
                top=[(name[:100], us / 1e3) for name, us in top])


def _encoder_agrees(engine, audio, label: str, plain=None) -> None:
    """One window through the engine's encoder with the kernels and with
    the plain versions (``plain``: a context that swaps them in, or None
    for the bf16 path's plain attention): finite, of the expected shape,
    and within ENCODER_REL."""
    import torch

    from ttasr_torch.models.whisper.model import encode
    from ttasr_torch.ops.mel import log_mel_spectrogram

    with torch.inference_mode():
        mel = log_mel_spectrogram(audio, n_mels=engine.cfg.num_mel_bins,
                                  device=engine.device)[None]
        kw = dict(act_int8=engine._act8, fused_quant=engine._fused_quant)
        kernel_out = encode(engine.params, engine.cfg, mel, **kw)
        if plain is None:
            plain_out = encode(engine.params, engine.cfg, mel, fused_attention=False)
        else:
            with plain():
                plain_out = encode(engine.params, engine.cfg, mel, **kw)
    check(tuple(kernel_out.shape) == (1, 1500, 1280),
          f"{label}: encoder output shape {tuple(kernel_out.shape)}")
    check(bool(torch.isfinite(kernel_out).all()), f"{label}: non-finite encoder output")
    err = _max_err(kernel_out, plain_out)
    scale = plain_out.float().abs().max().item()
    print(f"{label}: encoder large-v3, kernels vs plain versions: max_abs_err "
          f"{err:.3e}, max|plain| {scale:.3e}")
    check(err <= ENCODER_REL * scale, f"{label}: encoder disagrees with its plain versions")


# the bf16 path's decoder depth (of 32): the script keeps within its time
# (4 since phase 19 joined, 8 before); every layer is the same arithmetic,
# and the encoder stays whole (B11)
BF16_DECODER_LAYERS = 4


def run_bf16_path(card: str) -> dict:
    """The batch CLI at large-v3, bf16, beam 5; returns B11's launches and
    the encoder's ms per window."""
    import torch

    from ttasr_torch.cli.asr import build_engine
    from ttasr_torch.ops.encoder_attention import encoder_attention_merged

    t0 = time.perf_counter()
    engine = build_engine("large-v3", device="cuda")
    engine.params["decoder"]["blocks"] = engine.params["decoder"]["blocks"][:BF16_DECODER_LAYERS]
    engine.cfg = dataclasses.replace(engine.cfg, decoder_layers=BF16_DECODER_LAYERS)
    torch.cuda.synchronize()
    print(f"engine: large-v3 bf16 random init on {engine.device} in "
          f"{time.perf_counter() - t0:.1f} s, decoder cut to {BF16_DECODER_LAYERS} layers")
    run = _drive_cli(engine, "bf16 path", card, [encoder_attention_merged])
    launches = run["counts"]["encoder_attention_merged"]
    check(launches > 0 and launches == N_LAYERS * run["stats"]["encoder_passes"],
          f"encoder attention launched {launches} times for "
          f"{run['stats']['encoder_passes']} encoder passes")
    _encoder_agrees(engine, run["first"], "bf16 path")
    ms = encoder_ms(engine, run["first"], "bf16 path", card)
    del engine
    torch.cuda.empty_cache()
    return dict(launches=launches, encoder_ms=ms)


def _int8_counters():
    from ttasr_torch.models.whisper import model
    from ttasr_torch.ops import decoder_blocks as blk
    from ttasr_torch.ops import decoder_mlp as mlp
    from ttasr_torch.ops import encoder_fused as ef
    from ttasr_torch.ops import quant
    from ttasr_torch.ops import self_attention as sa

    from ttasr_torch.ops import beam_gather as bg
    from ttasr_torch.ops import cross_attention as ca

    return [blk.qkv_int8_fused, sa.self_attn_step_indirect_int8,
            blk.attnout_ln_q_cross_int8, mlp.mlp_with_crossout_int8,
            sa.self_attn_step_int8, model.encoder_attention_merged,
            model.encoder_attention_merged_qkv, ef.ln_quant, ef.ln_quant_acc,
            ef.quant_only, ef.add_ln_quant, ef.add_ln_quant_acc, ef.gelu_quant,
            ef.gelu_quant_acc, ef.qkv_epilogue_acc, ef.quant_only_absmax,
            ef.quant_only_scaled, ef.gelu_quant_acc_absmax, ef.gelu_quant_scaled,
            quant.quant_matmul_act8,
            blk.attnout_ln_q_fused, ca.cross_attention_int8,
            bg.gather_cache_rows, blk.matmul_int8_partial,
            blk.ln_q_cross_int8, mlp.mlp_int8_fused]


def _expect_int8_launches(label, counts, st, act8: bool = True,
                          layers: int = N_LAYERS, decoder_layers=None) -> None:
    """The int8 engine's launches against its decode stats: B1, B3 and B4
    once per decoder layer and decode step, B2 per beam step, B10 per
    greedy step, and the encoder's kernels once per layer and pass (B11 for
    the bf16 encoder); ``layers``: the model's depth, ``decoder_layers``
    the decoder's where it is cut (default ``layers``)."""
    steps = st["beam_steps"] + st["greedy_steps"]
    passes = st["encoder_passes"]
    check(passes > 0 and steps > 0, f"{label}: no encoder pass or step")
    dl = layers if decoder_layers is None else decoder_layers
    want = {"qkv_int8_fused": dl * steps,
            "attnout_ln_q_cross_int8": dl * steps,
            "mlp_with_crossout_int8": dl * steps,
            "self_attn_step_indirect_int8": dl * st["beam_steps"],
            "self_attn_step_int8": dl * st["greedy_steps"]}
    if act8:
        want.update(_act8_encoder_launches(passes, layers=layers),
                    encoder_attention_merged_qkv=layers * passes)
    else:
        want["encoder_attention_merged"] = layers * passes
    _expect(label, counts, want)
    print(f"{label}: launch counts match the decode stats "
          f"({st['beam_steps']} beam + {st['greedy_steps']} greedy steps, "
          f"{st['encoder_passes']} encoder passes, x {layers} layers"
          + (f", the decoder's {dl}" if dl != layers else "") + ")")


def run_int8_path(card: str, act8: bool) -> dict:
    """The batch CLI on the int8 engine: with all its defaults (``act8``,
    the main path: the s8 x s8 encoder, both files; then the decode's
    other branches on the same engine, :func:`run_branch_paths`) or with
    ``encoder_act_int8=False`` (the bf16 encoder on int8 weights, one
    file).  Returns each kernel's launches in that run, the encoder's ms
    per window and, for the main path, the branch paths' results."""
    import torch

    from ttasr_torch.engine import registry
    from ttasr_torch.engine.transcriber import WhisperEngine

    label = "int8 main path" if act8 else "int8 path, encoder_act_int8=False"
    t0 = time.perf_counter()
    kw = {} if act8 else dict(encoder_act_int8=False)
    if act8:  # through the registry, where the HTTP service (phase 15) finds it
        engine = registry.get_engine(SERVICE_MODEL, compute_type="int8", device="cuda")
    else:
        engine = WhisperEngine("large-v3", compute_type="int8", device="cuda", **kw)
    torch.cuda.synchronize()
    print(f"engine: large-v3 int8 (quantized on the card) {kw or 'defaults'}, "
          f"random init in {time.perf_counter() - t0:.1f} s")
    run = _drive_cli(engine, label, card, _int8_counters(), n_files=2 if act8 else 1)
    c, st = run["counts"], run["stats"]
    _expect_int8_launches(label, c, st, act8)
    if act8:
        _encoder_agrees(engine, run["first"], label, plain=plain_encoder_kernels)
    ms = encoder_ms(engine, run["first"], label, card)
    branches = tp = sharded = routes = server = service = words = None
    if act8:
        routes = compare_encoder_routes(engine, run["first"], card)
        branches, main_leg = run_branch_paths(engine, run["first"], card)
        # phase 19's ranks decode the main window beside phase 12 (ROADMAP:
        # the script's time)
        with sharded_ranks(engine, main_leg) as ranks:
            tp = run_tp_paths(engine, run["first"], main_leg, card)
            sharded = run_sharded_paths(engine, main_leg, card, ranks)
        server = run_server_path(engine, card)
        service = run_http_service(engine, card)
        words = run_words_and_tools(engine, card)
        registry.reset_engines()
    del engine
    torch.cuda.empty_cache()
    return dict(counts=c, encoder_ms=ms, branches=branches, tp=tp, sharded=sharded,
                routes=routes, server=server, service=service, words=words)


# ---------------------------------------------------------------------------
# Phase 11: the decode's other branches on the main path's engine
# ---------------------------------------------------------------------------

# tokens per branch decode (phases 11, 12 and 19): two growth buckets, so
# the cache grows once; 96 (three buckets) until the script's phases
# outgrew the 1200-s limit on a slow host (1160 s of command with 96)
BRANCH_STEPS = 64
STEP_LOGIT_REL = 1.4e-2  # ROADMAP C: step logits within 1.4 % relative


def _unfused_decoder(params):
    """The decoder's fused q/k/v leaves split back into wq/wk/wv and bq/bv:
    the weights ``quantize_params`` gives without ``fuse_qkv`` (the scales
    are per output column, so the split is exact)."""
    dec = params["decoder"]
    blocks = []
    for blk in dec["blocks"]:
        out = {k: v for k, v in blk.items() if k not in ("wqkv", "bqkv")}
        d = blk["wqkv"]["q"].shape[0]
        for j, name in enumerate(("wq", "wk", "wv")):
            cols = slice(j * d, (j + 1) * d)
            out[name] = {"q": blk["wqkv"]["q"][:, cols].contiguous(),
                         "s": blk["wqkv"]["s"][..., cols].contiguous()}
        out["bq"], out["bv"] = blk["bqkv"][:d].contiguous(), blk["bqkv"][2 * d:].contiguous()
        blocks.append(out)
    return dict(params, decoder=dict(dec, blocks=blocks))


PROFILE_STEPS = 16  # tokens of the profiled decodes of PROFILED_LEGS
# the legs decoded once more under torch.profiler: the main path's step
# (B1 -> B2 -> B3 -> B4) and the slice's heaviest, with B13 in it
MAIN_LEG = "main path beam 5 (B3, ancestry map)"
PROFILED_LEGS = (MAIN_LEG, "unfused int8 graph beam 5 (B13, 5-D cache)")


def _profile_decode(run) -> dict:
    """One decode ``run()`` (prefill included) under ``torch.profiler``:
    device ms and kernels per step, the busy share of its wall, and the
    four kernels with the most device time per step."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        steps = run()["steps"]
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = {e.key: e.self_device_time_total for e in kernels}
    device_ms = sum(dev_us.values()) / 1e3
    top = sorted(dev_us.items(), key=lambda kv: -kv[1])[:4]
    return dict(device_ms_per_step=device_ms / steps,
                kernels_per_step=sum(e.count for e in kernels) / steps,
                busy=device_ms / wall_ms,
                top=[(name[:90], us / 1e3 / steps) for name, us in top])


def _expect(label, counts, want):
    """Every counter equals ``want`` (0 where not named), each named > 0."""
    for name, n in counts.items():
        w = want.get(name, 0)
        check(n == w and (w > 0 or name not in want),
              f"{label}: {name} launched {n} times, expected {w}")


@contextlib.contextmanager
def _step_logits():
    """Collects the logits of every decode step (``decode._step``'s
    output, kept by reference: nothing more runs on the card)."""
    from ttasr_torch.models.whisper import decode as dm

    step, seen = dm._step, []

    def recorded(*args, **kwargs):
        logits, cache = step(*args, **kwargs)
        seen.append(logits)
        return logits, cache

    dm._step = recorded
    try:
        yield seen
    finally:
        dm._step = step


@contextlib.contextmanager
def _unfused_rules_env():
    """TTASR_UNFUSED_RULES=1 for the decodes inside, with
    ``decode._apply_rules`` counted and its log-probabilities checked
    finite; the variable is unset afterwards.  The flag stays on the card
    (``seen["finite"]``, a bool tensor, read once after the leg), so the
    spy adds a few small kernels per step and no host sync."""
    import torch

    from ttasr_torch.models.whisper import decode as dm

    apply_rules, seen = dm._apply_rules, {"calls": 0, "finite": None}

    def counted(*args, **kwargs):
        out = apply_rules(*args, **kwargs)
        seen["calls"] += 1
        finite = torch.isfinite(torch.log_softmax(out, dim=-1)).all()
        seen["finite"] = finite if seen["finite"] is None else seen["finite"] & finite
        return out

    check("TTASR_UNFUSED_RULES" not in os.environ, "TTASR_UNFUSED_RULES already set")
    dm._apply_rules = counted
    os.environ["TTASR_UNFUSED_RULES"] = "1"
    try:
        yield seen
    finally:
        del os.environ["TTASR_UNFUSED_RULES"]
        dm._apply_rules = apply_rules


def _logit_gaps(a, b):
    """Per step of two decodes: (max |a - b| / max |a|, every row's argmax
    equal)."""
    return [(float((x - y).abs().max() / x.abs().max()),
             bool((x.argmax(-1) == y.argmax(-1)).all())) for x, y in zip(a, b)]


def _first_difference(a, b):
    """(row, step) of the first differing token of two decodes, or None."""
    for row in range(a["tokens"].shape[0]):
        n_a, n_b = int(a["lengths"][row]), int(b["lengths"][row])
        ta, tb = a["tokens"][row].tolist(), b["tokens"][row].tolist()
        for step in range(max(n_a, n_b)):
            if step >= min(n_a, n_b) or ta[step] != tb[step]:
                return row, step
    return None


def _hold_to_main(label, out, logits, main) -> float:
    """``out``'s tokens equal to the main-path leg's, and its step
    ``logits`` within STEP_LOGIT_REL of that leg's with every argmax
    equal; returns the worst relative gap."""
    gaps = _logit_gaps(main["logits"], logits)
    diff = _first_difference(main["out"], out)
    if diff is not None:
        row, step = diff
        gap = "the prefill's" if step == 0 else f"{gaps[step - 1][0]:.3e}"
        check(False, f"{label}: tokens differ from the main path leg's at row "
              f"{row} step {step}; relative logit gap of the step that chose "
              f"it {gap}")
    worst = max(g for g, _ in gaps)
    s = out["steps"]
    print(f"{label}: tokens equal to the main path leg's ({s} steps); step "
          f"logits within {worst:.3e} relative, argmax equal on "
          f"{sum(a for _, a in gaps)} of {len(gaps)} steps")
    check(len(gaps) == s and worst <= STEP_LOGIT_REL and all(a for _, a in gaps),
          f"{label}: step logits not within {STEP_LOGIT_REL} of the main path "
          f"leg's with every argmax equal")
    return worst


def run_branch_paths(engine, audio, card: str):
    """Each branch decode on one encoder window of ``audio``, its counts set
    to 0 just before and read just after; returns ({leg: {steps,
    ms_per_step, counts}}, the main-path leg: {out, logits, enc, prompt,
    pad}) for the tensor-parallel legs to be held to."""
    import torch

    from ttasr_torch.models.whisper.decode import (
        DecodingOptions,
        beam_decode,
        build_prompt,
        greedy_decode,
        pad_prompts,
    )

    counters = _int8_counters()
    enc = engine.encode_windows(audio[None])
    prompt, pad = pad_prompts([build_prompt(engine.tokenizer, language="zh")],
                              engine.ti.eot)
    base = dict(beam_size=5, sample_len=BRANCH_STEPS, kv_int8=True,
                cross_kv_int8=True, cross_kv_int4=True, kv_int4=True)
    unfused = _unfused_decoder(engine.params)
    legs = {}

    def decode(fn, params, rows, kw):
        with torch.inference_mode():
            return fn(params, engine.cfg, enc.expand(rows, -1, -1),
                      np.repeat(prompt, rows, 0), np.repeat(pad, rows, 0),
                      opts=DecodingOptions(**dict(base, **kw)), ti=engine.ti)

    def leg(label, fn, params, rows=1, **kw):
        for c in counters:
            c.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = decode(fn, params, rows, kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {c.__name__: c.launches for c in counters}
        steps = out["steps"]
        check(steps > 0 and out["logits_finite"], f"{label}: {steps} steps, "
              f"finite logits {out['logits_finite']}")
        legs[label] = dict(steps=steps, ms_per_step=1e3 * wall / steps, counts=counts)
        print(f"{label}: {steps} steps, {1e3 * wall / steps:.2f} ms per step "
              f"(decode wall {wall:.2f} s, prefill included) ({card})")
        print(f"{label} launches: {json.dumps({k: v for k, v in counts.items() if v})}")
        if label in PROFILED_LEGS:
            prof = _profile_decode(lambda: decode(fn, params, rows, dict(
                kw, sample_len=PROFILE_STEPS)))
            legs[label]["profile"] = prof
            print(f"{label}: profiled {PROFILE_STEPS}-step decode: "
                  f"{prof['device_ms_per_step']:.3f} ms of device time and "
                  f"{prof['kernels_per_step']:.0f} kernels per step, busy "
                  f"{prof['busy']:.0%} ({card})")
            if label == MAIN_LEG:  # B4 is one kernel of 32 per step, not three
                print(f"{label}: {prof['kernels_per_step']:.0f} kernels per step, 841 "
                      f"expected with B4 as one launch (905 with three)")
            for name, ms in prof["top"]:
                print(f"    {ms:8.3f} ms per step  {name}")
        return out, steps

    L = N_LAYERS
    with _step_logits() as main_logits:
        main, s = leg(MAIN_LEG, beam_decode, engine.params)
    _expect("main path leg", legs[MAIN_LEG]["counts"], {
        "qkv_int8_fused": L * s, "self_attn_step_indirect_int8": L * s,
        "attnout_ln_q_cross_int8": L * s, "mlp_with_crossout_int8": L * s})

    # the main path with the two-stage rules (ROADMAP C1): same kernels
    label = "TTASR_UNFUSED_RULES=1 beam 5 (two-stage rules)"
    with _unfused_rules_env() as rules:
        unfused_rules, s = leg(label, beam_decode, engine.params)
    _expect(label, legs[label]["counts"], {
        "qkv_int8_fused": L * s, "self_attn_step_indirect_int8": L * s,
        "attnout_ln_q_cross_int8": L * s, "mlp_with_crossout_int8": L * s})
    finite = rules["finite"] is not None and bool(rules["finite"])
    check(rules["calls"] == s and finite,
          f"{label}: _apply_rules ran {rules['calls']} times in {s} steps, "
          f"log-probabilities finite {finite}")
    diff = _first_difference(main, unfused_rules)
    print(f"{label}: _apply_rules ran once per step ({s} steps), log-probabilities "
          f"finite; tokens " + ("equal to the main path leg's" if diff is None else
                               f"differ from the main path leg's first at row "
                               f"{diff[0]} step {diff[1]}"))

    label = "beam_indirect=False (B17, B10)"
    with _step_logits() as copied_logits:
        copied, s = leg(label, beam_decode, engine.params, beam_indirect=False)
    _expect(label, legs[label]["counts"], {
        "qkv_int8_fused": L * s, "self_attn_step_int8": L * s,
        "attnout_ln_q_cross_int8": L * s, "mlp_with_crossout_int8": L * s,
        "gather_cache_rows": s})
    # B17 copies bytes and B10 sums the rows B2 reads through the map in the
    # same order: the legs do the same arithmetic, so no near-tie may flip
    main_leg = dict(out=main, logits=main_logits, enc=enc, prompt=prompt, pad=pad,
                    audio=audio)
    _hold_to_main(label, copied, copied_logits, main_leg)

    label = "bf16 cross-KV (B12)"
    _, s = leg(label, beam_decode, engine.params, cross_kv_int8=False,
               cross_kv_int4=False)
    _expect(label, legs[label]["counts"], {
        "qkv_int8_fused": L * s, "self_attn_step_indirect_int8": L * s,
        "attnout_ln_q_fused": L * s, "mlp_with_crossout_int8": L * s})

    for label, fn, rows in (("unfused int8 graph beam 5 (B13, 5-D cache)", beam_decode, 1),
                            ("unfused int8 graph greedy 5 rows (B13, 5-D cache)",
                             greedy_decode, 5)):
        with _step_logits() as unfused_logits:
            out, s = leg(label, fn, unfused, rows=rows, beam_size=5 if rows == 1 else 1)
        _expect(label, legs[label]["counts"], {"cross_attention_int8": L * s})
        if rows == 1:  # phase 19's one-card int8 beam decode (the profiled run's after)
            main_leg["unfused_beam"] = dict(out=out, logits=unfused_logits[:s])

    label = "engine transcribe beam_size=10 (B12, XLA cross)"
    for c in counters:
        c.launches = 0
    before = dict(engine.decode_stats)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    segments, _ = engine.transcribe(audio, beam_size=10, temperature=(0.0,))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {c.__name__: c.launches for c in counters}
    st = {k: engine.decode_stats[k] - before[k] for k in before}
    s, passes = st["beam_steps"], st["encoder_passes"]
    check(st["nonfinite_logits"] == 0 and s > 0 and st["greedy_steps"] == 0,
          f"{label}: decode stats {st}")
    _expect(label, counts, dict(
        _act8_encoder_launches(passes), qkv_int8_fused=L * s,
        self_attn_step_indirect_int8=L * s, attnout_ln_q_fused=L * s,
        mlp_with_crossout_int8=L * s, encoder_attention_merged_qkv=L * passes))
    legs[label] = dict(steps=s, ms_per_step=1e3 * wall / s, counts=counts)
    print(f"{label}: {len(segments)} segments, {s} beam steps, {passes} encoder "
          f"passes, wall {wall:.2f} s = {1e3 * wall / s:.2f} ms per beam step "
          f"(encoder included) ({card})")
    print(f"{label} launches: {json.dumps({k: v for k, v in counts.items() if v})}")
    print("branch paths, ms per step: " + json.dumps(
        {k: round(v["ms_per_step"], 3) for k, v in legs.items()}) + f" ({card})")
    print("branch paths, profiled device ms per step: " + json.dumps(
        {k: round(v["profile"]["device_ms_per_step"], 3) for k, v in legs.items()
         if "profile" in v}) + f" ({card})")
    return legs, main_leg


# ---------------------------------------------------------------------------
# Phase 12: the tensor-parallel decode
# ---------------------------------------------------------------------------

TP_RANKS = 2  # the two-rank leg: large-v3's 20 heads split into 2 x 10
# The two-rank legs change the f32 summation order (the partial sums of v2;
# cuBLAS's shape-dependent order in a shard's N = 640 projections), and on
# random weights 32 layers grow such last-bit changes into step-logit gaps
# far above STEP_LOGIT_REL: a one-card decode whose only change is the
# order (CONTROLS) moves as far.  So those legs are held to the controls'
# gaps, measured in the same run, times this margin for the spread of a
# maximum over BRANCH_STEPS steps; the legs whose arithmetic is the main leg's are
# held to STEP_LOGIT_REL and equal tokens.
CONTROL_MARGIN = 1.5
# a mesh engine's resident bytes after construction beyond its reckoned
# slices (allocator rounding, the mel's constants, small caches)
RESIDENT_SLACK = 64 * 2 ** 20


def _tp_launches(s: int, beam: bool, row_parallel: bool) -> dict:
    """Exact launch counts of ``s`` TP decode steps over N_LAYERS layers."""
    L = N_LAYERS
    want = {"qkv_int8_fused": L * s,
            "self_attn_step_indirect_int8" if beam else "self_attn_step_int8": L * s}
    if row_parallel:
        want.update(matmul_int8_partial=2 * L * s, ln_q_cross_int8=L * s,
                    mlp_int8_fused=L * s)
    else:
        want.update(attnout_ln_q_cross_int8=L * s, mlp_with_crossout_int8=L * s)
    return want


def _decode_leg(label, run, counters, card):
    """``run()`` with the counts set to 0 just before and read just after,
    under ``_step_logits``; returns (output, step logits, {steps,
    ms_per_step, counts})."""
    import torch

    for c in counters:
        c.launches = 0
    with _step_logits() as logits, torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts = {c.__name__: c.launches for c in counters}
    steps = out["steps"]
    check(steps > 0 and out["logits_finite"], f"{label}: {steps} steps, finite "
          f"logits {out['logits_finite']}")
    print(f"{label}: {steps} steps, {1e3 * wall / steps:.2f} ms per step (decode "
          f"wall {wall:.2f} s, prefill included) ({card})")
    return out, logits, dict(steps=steps, ms_per_step=1e3 * wall / steps, counts=counts)


def _gap_summary(main_logits, logits) -> dict:
    """Worst and median relative step-logit gap, steps with every argmax
    equal."""
    gaps = _logit_gaps(main_logits, logits)
    g = [x for x, _ in gaps]
    return dict(worst_gap=max(g), median_gap=float(np.median(g)),
                argmax_equal_steps=sum(a for _, a in gaps), compared_steps=len(g))


@contextlib.contextmanager
def _plain_b4():
    """The decode's B4 through its plain version: the same function, its
    f32 sums in another order."""
    from ttasr_torch.models.whisper import decode as dm
    from ttasr_torch.ops import decoder_mlp as mlp

    real = dm.mlp_with_crossout_int8
    dm.mlp_with_crossout_int8 = mlp.mlp_with_crossout_int8_ref
    try:
        yield
    finally:
        dm.mlp_with_crossout_int8 = real


@contextlib.contextmanager
def _cross_kv_in_halves():
    """``init_cache`` projects each layer's cross-KV as a 2-way model axis
    does, one projection per half of the heads, and concatenates the
    halves: one card, a 2-way shard's projection shapes."""
    import torch

    from ttasr_torch.models.whisper import model
    from ttasr_torch.parallel.tp import _split_cols

    real = model._quantized_cross_kv

    def halves(enc_out, blk, h, int4):
        parts = [real(enc_out, {k: _split_cols(blk[k], 2, i) for k in ("wk_c", "wv_c", "bv_c")},
                      h // 2, int4) for i in range(2)]
        # codes (B, S, D) join on D, scales (B, H, S) on H
        return [torch.cat(pair, dim=-1 if j % 2 == 0 else 1)
                for j, pair in enumerate(zip(*parts))]

    model._quantized_cross_kv = halves
    try:
        yield
    finally:
        model._quantized_cross_kv = real


CONTROLS = (("control: B4 through its plain version", _plain_b4),
            ("control: cross-KV projected in head halves", _cross_kv_in_halves))


def _segments_well_formed(label, segments, clipped_at=None) -> int:
    """Text, tokens, finite log-probability, a no-speech probability in
    [0, 1] and start <= end.  ``clipped_at``: the file's duration on the
    batched path, which clips a segment's end to it and not its start (as
    the JAX package does): a segment that starts after it must end at it.
    Returns how many did."""
    late = 0
    for seg in segments:
        ok = (isinstance(seg.text, str) and seg.tokens and np.isfinite(seg.avg_logprob)
              and 0.0 <= seg.no_speech_prob <= 1.0)
        if clipped_at is not None and seg.start > clipped_at:
            late += 1
            ok = ok and seg.end == clipped_at
        else:
            ok = ok and seg.start <= seg.end
        check(ok, f"{label}: malformed segment {seg}")
    return late


def run_tp_paths(engine, audio, main, card: str) -> dict:
    """The tensor-parallel decode on the main path's window: TP v2 forced on
    a one-rank NCCL group (beam 5 held to the main-path leg, greedy over 5
    rows held to the single-card fused greedy decode), the engine with a
    (1, 1) mesh (TP v1) on the 20 s file and on its own encoder window, the
    one-card CONTROLS, and two gloo ranks on this card
    (:func:`run_two_ranks`).  Returns {leg: {steps, ms_per_step, counts}}."""
    import torch
    import torch.distributed as dist

    from ttasr_torch.models.whisper.decode import (
        DecodingOptions,
        beam_decode,
        greedy_decode,
    )
    from ttasr_torch.parallel.distributed import initialize_distributed
    from ttasr_torch.parallel.sharding import create_mesh
    from ttasr_torch.parallel.tp import TPDecoder

    counters = _int8_counters()
    base = dict(beam_size=5, sample_len=BRANCH_STEPS, kv_int8=True,
                cross_kv_int8=True, cross_kv_int4=True, kv_int4=True)
    enc, prompt, pad, ti = main["enc"], main["prompt"], main["pad"], engine.ti
    legs = {}
    with tempfile.TemporaryDirectory() as tmp:
        initialize_distributed(f"file://{tmp}/store", world_size=1, rank=0)
        try:
            mesh = create_mesh(1, 1)
            tp = TPDecoder(_unfused_decoder(engine.params), engine.cfg, mesh,
                           row_parallel=True)
            label = "TP v2 one rank beam 5 (B15, B16, B14)"
            out, logits, legs[label] = _decode_leg(label, lambda: tp.beam(
                enc, prompt, pad, opts=DecodingOptions(**base), ti=ti), counters, card)
            _expect(label, legs[label]["counts"],
                    _tp_launches(out["steps"], beam=True, row_parallel=True))
            _hold_to_main(label, out, logits, main)

            rows = 5
            g_args = (enc.expand(rows, -1, -1), np.repeat(prompt, rows, 0),
                      np.repeat(pad, rows, 0), None, 0.0)
            g_opts = DecodingOptions(**dict(base, beam_size=1))
            label = "TP v2 one rank greedy 5 rows"
            out, logits, legs[label] = _decode_leg(label, lambda: tp.greedy(
                *g_args, opts=g_opts, ti=ti), counters, card)
            _expect(label, legs[label]["counts"],
                    _tp_launches(out["steps"], beam=False, row_parallel=True))
            single, single_logits, _ = _decode_leg(
                "single-card fused greedy 5 rows", lambda: greedy_decode(
                    engine.params, engine.cfg, *g_args, opts=g_opts, ti=ti),
                counters, card)
            _hold_to_main(label, out, logits, dict(out=single, logits=single_logits))
            del tp

            legs.update(run_mesh_engine(mesh, audio, base, counters, card))
        finally:
            dist.destroy_process_group()
    controls = {}
    for label, ctx in CONTROLS:
        with ctx():
            out, logits, legs[label] = _decode_leg(label, lambda: beam_decode(
                engine.params, engine.cfg, enc, prompt, pad,
                opts=DecodingOptions(**base), ti=ti), counters, card)
        controls[label] = dict(_gap_summary(main["logits"], logits),
                               first_difference=_first_difference(main["out"], out))
        print(f"{label}: {json.dumps(controls[label])}")
    legs.update(run_two_ranks(main, ti, controls, card))
    print("tensor-parallel legs, ms per step: " + json.dumps(
        {k: round(v["ms_per_step"], 3) for k, v in legs.items()}) + f" ({card})")
    return legs


def run_mesh_engine(mesh, audio, base, counters, card) -> dict:
    """``WhisperEngine(..., mesh=mesh)`` at (1, 1): TP v1 by the reference's
    rule, the unfused s8 x s8 encoder (B11).  ``transcribe`` of the 20 s
    file at T = 0 with exact counts, then the engine's own first window
    decoded by the engine and by the single-card fused ``beam_decode`` of
    its weights: equal tokens, step logits within STEP_LOGIT_REL."""
    import torch

    from ttasr_torch.engine.transcriber import WhisperEngine
    from ttasr_torch.models.whisper.decode import (
        DecodingOptions,
        beam_decode,
        build_prompt,
        pad_prompts,
    )
    from ttasr_torch.ops.quant import fuse_qkv

    L = N_LAYERS
    t0 = time.perf_counter()
    engine = WhisperEngine("large-v3", compute_type="int8", device="cuda", mesh=mesh)
    check(engine._tp is not None and not engine._tp.row_parallel,
          "the (1, 1) mesh engine must take TP v1")
    print(f"engine: large-v3 int8 with a (1, 1) mesh in {time.perf_counter() - t0:.1f} s")
    label = "mesh engine transcribe T=0 (TP v1, unfused encoder)"
    for c in counters:
        c.launches = 0
    before = dict(engine.decode_stats)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    segments, _ = engine.transcribe(audio, temperature=(0.0,))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {c.__name__: c.launches for c in counters}
    st = {k: engine.decode_stats[k] - before[k] for k in before}
    s, passes = st["beam_steps"], st["encoder_passes"]
    check(st["nonfinite_logits"] == 0 and s > 0 and st["greedy_steps"] == 0,
          f"{label}: decode stats {st}")
    _segments_well_formed(label, segments)
    _expect(label, counts, dict(
        _tp_launches(s, beam=True, row_parallel=False),
        **_act8_encoder_launches(passes, gemms=6), encoder_attention_merged=L * passes))
    legs = {label: dict(steps=s, ms_per_step=1e3 * wall / s, counts=counts)}
    print(f"{label}: {len(segments)} segments, {s} beam steps, {passes} encoder "
          f"passes, wall {wall:.2f} s = {1e3 * wall / s:.2f} ms per beam step "
          f"(encoder included) ({card})")

    enc = engine.encode_windows(audio[None])
    prompt, pad = pad_prompts([build_prompt(engine.tokenizer, language="zh")],
                              engine.ti.eot)
    opts = DecodingOptions(**base)
    label = "mesh engine beam 5 on its window (TP v1)"
    out, logits, legs[label] = _decode_leg(label, lambda: engine.run_beam_decode(
        enc, prompt, pad, None, opts), counters, card)
    _expect(label, legs[label]["counts"],
            _tp_launches(out["steps"], beam=True, row_parallel=False))
    fused = fuse_qkv({"decoder": engine.params["decoder"]})
    single, single_logits, _ = _decode_leg(
        "single-card fused beam 5 on the mesh engine's window", lambda: beam_decode(
            fused, engine.cfg, enc, prompt, pad, opts=opts, ti=engine.ti),
        counters, card)
    _hold_to_main(label, out, logits, dict(out=single, logits=single_logits))
    del engine, fused
    torch.cuda.empty_cache()
    return legs


def run_two_ranks(main, ti, controls, card: str) -> dict:
    """Two gloo ranks on this card, mesh (1, 2), the seeded large-v3
    weights: TP v2 and v1 beam 5 over the main-path leg's window, each
    rank a process of this script (``--tp-rank``).  Both ranks' counts
    must be exact at the shard shapes, and rank 0's worst and median step
    gap to the main-path leg within CONTROL_MARGIN x the largest of the
    ``controls``' (one-card decodes that only reorder sums)."""
    import torch

    with tempfile.TemporaryDirectory() as tmp:
        torch.save(dict(enc=main["enc"], prompt=main["prompt"], pad=main["pad"], ti=ti,
                        logits=torch.stack(main["logits"]),
                        out={k: main["out"][k] for k in ("tokens", "lengths", "steps")}),
                   os.path.join(tmp, "main.pt"))
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                                   "--tp-rank", str(r), tmp]) for r in range(TP_RANKS)]
        try:
            codes = [p.wait(timeout=600) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
        check(codes == [0] * TP_RANKS, f"two-rank leg: rank exit codes {codes}")
        legs = {}
        for r in range(TP_RANKS):
            with open(os.path.join(tmp, f"rank{r}.json"), encoding="utf-8") as fh:
                for label, leg in json.load(fh).items():
                    _expect(f"{label} rank {r}", leg["counts"], _tp_launches(
                        leg["steps"], beam=True, row_parallel=leg["row_parallel"]))
                    if r == 0:
                        legs[label] = leg
    limit = {k: CONTROL_MARGIN * max(c[k] for c in controls.values())
             for k in ("worst_gap", "median_gap")}
    for label, leg in legs.items():
        print(f"{label}: {leg['steps']} steps, {leg['ms_per_step']:.2f} ms per step; "
              f"to the main path leg: first token difference (row, step) "
              f"{leg['first_difference']}, step logits worst {leg['worst_gap']:.3e} "
              f"(limit {limit['worst_gap']:.3e}), median {leg['median_gap']:.3e} "
              f"(limit {limit['median_gap']:.3e}), argmax equal on "
              f"{leg['argmax_equal_steps']} of {leg['compared_steps']} steps ({card})")
        check(leg["compared_steps"] == leg["steps"]
              and all(leg[k] <= limit[k] for k in limit),
              f"{label}: further from the main path leg than the one-card controls")
    return legs


def tp_rank_main(rank: int, tmp: str) -> int:
    """One rank of :func:`run_two_ranks`: builds the seeded large-v3 decoder
    (the main engine's weights), keeps its shard, decodes v2 then v1 beam
    5 and writes its legs to ``rank<r>.json``."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, ROOT)
    from ttasr_torch import resolve_device
    from ttasr_torch.models.whisper.decode import DecodingOptions
    from ttasr_torch.models.whisper.load import load_whisper
    from ttasr_torch.ops.quant import quantize_params
    from ttasr_torch.parallel.distributed import initialize_distributed
    from ttasr_torch.parallel.sharding import create_mesh
    from ttasr_torch.parallel.tp import TPDecoder

    resolve_device("cuda")
    initialize_distributed(f"file://{tmp}/store", world_size=TP_RANKS, rank=rank,
                           backend="gloo")
    try:
        mesh = create_mesh(1, TP_RANKS)
        params, cfg = load_whisper("large-v3", dtype=torch.bfloat16, device="cuda")
        q = quantize_params({"decoder": params["decoder"]})
        del params
        ref = torch.load(os.path.join(tmp, "main.pt"), map_location="cuda",
                         weights_only=False)
        main = dict(out=ref["out"], logits=list(ref["logits"]))
        opts = DecodingOptions(beam_size=5, sample_len=BRANCH_STEPS, kv_int8=True,
                               cross_kv_int8=True, cross_kv_int4=True, kv_int4=True)
        counters = _int8_counters()
        legs = {}
        for label, rp in ((f"TP v2 {TP_RANKS} gloo ranks, one card, beam 5", True),
                          (f"TP v1 {TP_RANKS} gloo ranks, one card, beam 5", False)):
            tp = TPDecoder(q, cfg, mesh, row_parallel=rp)
            out, logits, leg = _decode_leg(label, lambda: tp.beam(
                ref["enc"], ref["prompt"], ref["pad"], opts=opts, ti=ref["ti"]),
                counters, f"rank {rank}")
            legs[label] = dict(leg, row_parallel=rp,
                               first_difference=_first_difference(main["out"], out),
                               **_gap_summary(main["logits"], logits))
            del tp
        with open(os.path.join(tmp, f"rank{rank}.json"), "w", encoding="utf-8") as fh:
            json.dump(legs, fh)
    finally:
        dist.destroy_process_group()
    return 0


# ---------------------------------------------------------------------------
# Phase 19: the GSPMD mesh path (ShardedDecoder) on the main path's window
# ---------------------------------------------------------------------------

# (label, compute type, model axis): rank processes of this script on this
# card over gloo.  large-v3's 20 heads over 4 shards leave 5 a shard (odd:
# the fused TP decode refuses it) and its 51866 vocabulary rows do not
# divide by 4 (the embedding stays whole); over 2 shards, 10 heads and
# 25933 vocabulary rows a shard in bf16 (TP refuses bf16 weights)
SHARDED_RANK_LEGS = (("GSPMD int8 (1, 4), 4 gloo ranks", "int8", 4),
                     ("GSPMD bf16 (1, 2), 2 gloo ranks", "bfloat16", 2))
SHARDED_MODES = (("beam 5", 5), ("greedy", 1))
# the mode that the int8 ranks decode from their own encoder output (equal
# to the one-card unfused encoder's bit for bit, which the one-card greedy
# reference then decodes): encoder on the slices, then decode, end to end.
# The bf16 ranks' encoder output is within its controls, not equal, so
# their decodes keep the main window's encoder states
OWN_ENCODER_MODE = "greedy"


def _sharded_opts(compute: str, beam: int):
    """The engine's decode options for ``compute`` (``_decoding_options``):
    the int8 caches with their int4 sub-modes asked for (off the fused path
    the decode keeps them int8, as the JAX package does)."""
    from ttasr_torch.models.whisper.decode import DecodingOptions

    int8 = compute == "int8"
    return DecodingOptions(beam_size=beam, sample_len=BRANCH_STEPS, kv_int8=int8,
                           cross_kv_int8=int8, cross_kv_int4=int8, kv_int4=int8)


def _sharded_encoder_launches(compute: str) -> dict:
    """One window's encoder pass on a rank of a mesh leg.  int8: the s8 x s8
    blocks on the rank's slices, B5 at layer 0 (``ln_quant``) and after each
    W2 (``ln_quant_acc``, on the summed accumulators), B8 after each wo,
    both passes of B7's and B9's split entries, B11 on the rank's heads and
    six int8 GEMMs a layer (q, k, v, wo, W1, W2); bf16: B11 on the rank's
    heads, the rest eager."""
    if compute != "int8":
        return {"encoder_attention_merged": N_LAYERS}
    per_layer = dict(add_ln_quant_acc=1, quant_only_absmax=1, quant_only_scaled=1,
                     gelu_quant_acc_absmax=1, gelu_quant_scaled=1,
                     encoder_attention_merged=1, quant_matmul_act8=6)
    return dict({k: n * N_LAYERS for k, n in per_layer.items()}, ln_quant=1,
                ln_quant_acc=N_LAYERS - 1)


def _encode_leg(label, run, counters, card):
    """``run()`` (an encoder pass) with the counts set to 0 just before and
    read just after; returns (output, {ms, counts})."""
    import torch

    for c in counters:
        c.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    counts = {c.__name__: c.launches for c in counters}
    check(bool(torch.isfinite(out.float()).all()), f"{label}: non-finite encoder output")
    print(f"{label}: one window in {ms:.1f} ms ({card})")
    return out, dict(ms=ms, counts=counts)


def _unfused_encoder(params):
    """The encoder's fused q/k/v leaves split back into wq/wk/wv (codes
    K-major) and bq/bv: the mesh engine's encoder weights on one card
    (``quantize_params`` without ``fuse_qkv``; the scales are per output
    column, so the split is exact)."""
    from ttasr_torch.ops.quant import kmajor

    enc = params["encoder"]
    blocks = []
    for blk in enc["blocks"]:
        out = {k: v for k, v in blk.items() if k not in ("wqkv", "bqkv")}
        d = blk["wqkv"]["q"].shape[0]
        for j, name in enumerate(("wq", "wk", "wv")):
            cols = slice(j * d, (j + 1) * d)
            out[name] = {"q": kmajor(blk["wqkv"]["q"][:, cols]),
                         "s": blk["wqkv"]["s"][..., cols].contiguous()}
        out["bq"], out["bv"] = blk["bqkv"][:d].contiguous(), blk["bqkv"][2 * d:].contiguous()
        blocks.append(out)
    return dict(params, encoder=dict(enc, blocks=blocks))


def _encode_on_params(engine, params, audio):
    """``engine.encode_windows`` of one window of ``audio`` on ``params``,
    off any mesh: the engine's own mel and encoder route on other weights."""
    import copy

    view = copy.copy(engine)
    view.params, view.mesh = params, None
    view.decode_stats = dict(engine.decode_stats)
    return view.encode_windows(audio[None])


def _sum_in_row_blocks(x, w, b, n: int):
    """``x @ w + b`` as ``n`` partial products of w's row blocks (x's column
    blocks), summed in f32, the bias added once, one rounding to x's type:
    the arithmetic of an n-way row split without the collective."""
    import torch

    from ttasr_torch.models.whisper import decode as dm
    from ttasr_torch.ops.quant import is_quantized, quant_matmul

    k = dm._in_rows(w) // n
    total = None
    for i in range(n):
        xi = x[..., i * k:(i + 1) * k]
        if is_quantized(w):
            part = quant_matmul(xi, {"q": w["q"][i * k:(i + 1) * k], "s": w["s"]})
        else:
            part = torch.matmul(xi.float(), w[i * k:(i + 1) * k].float())
        total = part if total is None else total + part
    return (total + b.float()).to(x.dtype)


@contextlib.contextmanager
def _encoder_row_sums_in_parts(n: int):
    """The one-card float encoder's wo and W2 as ``n`` row blocks
    (:func:`_sum_in_row_blocks`): a control that only reorders the sums the
    n-way shard's all-reduce adds."""
    import torch.nn.functional as F

    from ttasr_torch.models.whisper import model as tm

    real_attn, real_mlp = tm._self_attn, tm._mlp

    def self_attn(x, blk, n_heads, mask=None, fused=False, t_real=None):
        qm, km, vm = tm._enc_qkv(x, blk)
        out = tm.encoder_attention_merged(qm * (x.shape[-1] // n_heads) ** -0.5,
                                          km.contiguous(), vm.contiguous(),
                                          t_real if t_real is not None else x.shape[1])
        return _sum_in_row_blocks(out, blk["wo"], blk["bo"], n)

    def mlp(x, blk):
        return _sum_in_row_blocks(F.gelu(tm._proj(x, blk["w1"], blk["b1"])), blk["w2"],
                                  blk["b2"], n)

    tm._self_attn, tm._mlp = self_attn, mlp
    try:
        yield
    finally:
        tm._self_attn, tm._mlp = real_attn, real_mlp


def _encoder_gap(ref, got) -> dict:
    """Worst and mean |got - ref| relative to max |ref|."""
    d = (got.float() - ref.float()).abs()
    scale = ref.float().abs().max().item()
    return dict(worst=d.max().item() / scale, mean=d.mean().item() / scale)


def _hold_rank_encoder(label, compute, ref, got, leg: dict, card: str) -> None:
    """One mesh rank's encoder output of the main window against the
    one-card reference: int8 bit for bit (``ref`` the one-card encoder on
    the same unfused weights), bf16 within CONTROL_MARGIN x the larger gap
    of its two controls (``ref`` {out, controls}); the gap and its limit
    go into ``leg``."""
    import torch

    if compute == "int8":
        same = torch.equal(got, ref)
        leg["equal"] = same
        print(f"{label} encoder: output equal to the one-card encoder on the same unfused "
              f"weights bit for bit: {same}; {leg['ms']:.1f} ms a window (the card shared "
              f"by the ranks) ({card})")
        check(same, f"{label}: the sharded s8 x s8 encoder differs from the one-card one")
        return
    gap = _encoder_gap(ref["out"], got)
    limit = {k: CONTROL_MARGIN * max(c[k] for c in ref["controls"].values())
             for k in ("worst", "mean")}
    leg["gap"], leg["limit"] = gap, limit
    print(f"{label} encoder: to the one-card encoder worst {gap['worst']:.3e} (limit "
          f"{limit['worst']:.3e}), mean {gap['mean']:.3e} (limit {limit['mean']:.3e}) "
          f"relative to its largest value; {leg['ms']:.1f} ms a window ({card})")
    check(all(gap[k] <= limit[k] for k in limit),
          f"{label}: the sharded encoder is further from the one-card one than its controls")


def _sharded_launches(compute: str, steps: int) -> dict:
    """The unfused graph's launches: B13 once per layer and step over the
    int8 cross-KV (the prefill's cross-attention takes the plain branch, as
    the reference's does), nothing on the float path."""
    return {"cross_attention_int8": N_LAYERS * steps} if compute == "int8" else {}


@contextlib.contextmanager
def _row_sums_in_parts(n: int):
    """The one-card plain layer loop's wo, wo_c and w2 as ``n`` partial
    products of their row blocks, summed in f32 with the bias added once
    after: the arithmetic of an n-way row split without the collective."""
    import torch.nn.functional as F

    from ttasr_torch.models.whisper import decode as dm

    real_out, real_mlp = dm._out_proj, dm._block_mlp

    def parts(x, w, b):
        return _sum_in_row_blocks(x, w, b, n)

    def out_proj(merged, w, b, group, whole, row_parallel):
        if group is None and merged.shape[-1] == whole:
            return parts(merged, w, b)
        return real_out(merged, w, b, group, whole, row_parallel)

    def block_mlp(xln, blk, group, ffn, row_parallel):
        if group is None:
            return parts(F.gelu(dm._proj(xln, blk["w1"], blk["b1"])), blk["w2"], blk["b2"])
        return real_mlp(xln, blk, group, ffn, row_parallel)

    dm._out_proj, dm._block_mlp = out_proj, block_mlp
    try:
        yield
    finally:
        dm._out_proj, dm._block_mlp = real_out, real_mlp


def _one_card_legs(label, compute, params, cfg, window, counters, card, n: int,
                   known=None, windows=None) -> dict:
    """The one-card unfused graph on ``window`` (beam 5 and greedy; a mode
    in ``known``, {mode: {out, logits}}, was decoded already; a mode in
    ``windows``, {mode: window}, decodes that window instead), then each
    mode under two controls that only reorder sums: wo, wo_c and w2 summed
    in ``n`` row blocks, as the n-way shard's all-reduce adds them, and in
    2n (:func:`_row_sums_in_parts`).  Returns {mode: {out, logits,
    controls: {label: gap summary}}}."""
    from ttasr_torch.models.whisper.decode import beam_decode, greedy_decode

    res = {}
    for mode, beam in SHARDED_MODES:
        fn = beam_decode if beam > 1 else greedy_decode
        extra = () if beam > 1 else (None, 0.0)
        enc, prompt, pad, ti = (windows or {}).get(mode, window)

        def run():
            return fn(params, cfg, enc, prompt, pad, *extra,
                      opts=_sharded_opts(compute, beam), ti=ti)

        if known and mode in known:
            out, logits = known[mode]["out"], known[mode]["logits"]
            print(f"{label} one card {mode}: phase 11's leg of the same decode")
        else:
            out, logits, leg = _decode_leg(f"{label} one card {mode}", run, counters, card)
            _expect(f"{label} one card {mode}", leg["counts"],
                    _sharded_launches(compute, out["steps"]))
        controls = {}
        for parts in (n, 2 * n):
            name = f"control: wo, wo_c, w2 summed in {parts} row blocks"
            with _row_sums_in_parts(parts):
                c_out, c_logits, _ = _decode_leg(f"{label} {name} {mode}", run, counters,
                                                 card)
            controls[name] = dict(_gap_summary(logits, c_logits),
                                  first_difference=_first_difference(out, c_out))
            print(f"{label} {name} {mode}: {json.dumps(controls[name])}")
        res[mode] = dict(out=out, logits=logits, controls=controls)
    return res


@contextlib.contextmanager
def sharded_ranks(engine, main):
    """Every rank of SHARDED_RANK_LEGS, all started at once on the main
    path's window: processes of this script (``--sharded-rank``), one group
    per leg, in a temporary directory; those still running are killed on
    the way out.  Yields {tmp, procs, t0}.  The ranks spend most of a step
    waiting on gloo's round trips through the host, so they run beside this
    process's work: phase 12's and phase 19's own."""
    import torch

    with tempfile.TemporaryDirectory() as tmp:
        torch.save(dict(enc=main["enc"], prompt=main["prompt"], pad=main["pad"],
                        ti=engine.ti, audio=main["audio"]), os.path.join(tmp, "window.pt"))
        procs = []
        try:
            for i, (_, compute, world) in enumerate(SHARDED_RANK_LEGS):
                store = os.path.join(tmp, f"leg{i}")
                os.makedirs(store)
                procs += [subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__), "--sharded-rank", str(r),
                     str(world), compute, store]) for r in range(world)]
            yield dict(tmp=tmp, procs=procs, t0=time.perf_counter())
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()


def run_sharded_paths(engine, main, card: str, ranks=None) -> dict:
    """Phase 19: the GSPMD decode (``WhisperEngine(mesh=...)`` on a mesh the
    fused TP decode refuses) on the main path's window, BRANCH_STEPS tokens
    beam 5 and greedy.  (a) int8 at (1, 4) and (b) bf16 at (1, 2) on gloo ranks of
    this card (``ranks``, :func:`sharded_ranks`, started before phase 12;
    None: started here); meanwhile in this process the one-card
    references (the unfused int8 graph of the main engine's weights, the
    bf16 weights' plain layer loop) and their controls, (c) the bf16 engine
    at (1, 1) on a one-rank NCCL group held to its one-card decode
    (tokens equal, step logits within STEP_LOGIT_REL, every argmax equal),
    and (e) B13 on odd head counts.  Each rank's launches are exact (B13
    32 x steps on the int8 ranks, nothing on the bf16 ones); rank 0's
    worst and median step-logit gaps to its one-card decode within
    CONTROL_MARGIN x the larger of its two controls'.  Returns {leg: {steps,
    ms_per_step, ...}} and B13's odd-head measurements."""
    import torch
    import torch.distributed as dist

    from ttasr_torch.engine.transcriber import WhisperEngine
    from ttasr_torch.parallel.distributed import initialize_distributed
    from ttasr_torch.parallel.sharding import create_mesh

    if ranks is None:
        with sharded_ranks(engine, main) as started:
            return run_sharded_paths(engine, main, card, started)
    t0 = time.perf_counter()
    counters = _int8_counters()
    legs = {}
    window = (main["enc"], main["prompt"], main["pad"], engine.ti)
    # the int8 ranks' encoder is held to the one-card encoder on the same
    # unfused K-major weights, bit for bit, and their OWN_ENCODER_MODE
    # decode, from their own encoder output, to the one-card decode of it
    enc_refs = {"int8": _encode_on_params(engine, _unfused_encoder(engine.params),
                                          main["audio"])}
    refs = {"int8": _one_card_legs(
        "int8", "int8", _unfused_decoder(engine.params), engine.cfg, window, counters,
        card, 4, known={"beam 5": main["unfused_beam"]} if "unfused_beam" in main else None,
        windows={OWN_ENCODER_MODE: (enc_refs["int8"], *window[1:])})}
    b13 = check_b13_odd_heads(card)
    with tempfile.TemporaryDirectory() as store:
        initialize_distributed(f"file://{store}/store", world_size=1, rank=0)
        try:
            bf16 = WhisperEngine("large-v3", compute_type="bfloat16", device="cuda",
                                 mesh=create_mesh(1, 1))
            check(bf16._tp is None and bf16._sharded is not None,
                  "the bf16 engine at (1, 1) must take the GSPMD path")
            refs["bfloat16"] = _one_card_legs(
                "bf16", "bfloat16", bf16.params, bf16.cfg, window, counters, card, 2)
            ref = bf16.encode_windows(main["audio"][None])
            controls = {}
            for n in (2, 4):
                with _encoder_row_sums_in_parts(n):
                    controls[f"wo, w2 summed in {n} row blocks"] = _encoder_gap(
                        ref, bf16.encode_windows(main["audio"][None]))
            print(f"bf16 one-card encoder controls: {json.dumps(controls)} ({card})")
            enc_refs["bfloat16"] = dict(out=ref, controls=controls)
            for mode, beam in SHARDED_MODES:
                label = f"GSPMD bf16 (1, 1), one NCCL rank, {mode}"
                run = (functools.partial(bf16.run_beam_decode, *window[:3], None)
                       if beam > 1 else functools.partial(
                           bf16.run_greedy_decode, *window[:3], None, 0.0))
                out, logits, legs[label] = _decode_leg(
                    label, lambda: run(_sharded_opts("bfloat16", beam)), counters, card)
                _expect(label, legs[label]["counts"], {})
                ref = refs["bfloat16"][mode]
                legs[label]["worst_gap"] = _hold_to_main(
                    label, out, logits, dict(out=ref["out"], logits=ref["logits"]))
            del bf16
        finally:
            dist.destroy_process_group()
    own = time.perf_counter() - t0
    encoders = {}
    codes = [p.wait(timeout=900) for p in ranks["procs"]]
    check(codes == [0] * len(codes), f"sharded rank exit codes {codes}")
    rank_s = time.perf_counter() - ranks["t0"]
    for i, (label, compute, world) in enumerate(SHARDED_RANK_LEGS):
        store = os.path.join(ranks["tmp"], f"leg{i}")
        for r in range(world):
            with open(os.path.join(store, f"rank{r}.json"), encoding="utf-8") as fh:
                got = json.load(fh)
            for mode, leg in got["decode"].items():
                _expect(f"{label} {mode} rank {r}", leg["counts"],
                        _sharded_launches(compute, leg["steps"]))
                if r == 0:
                    legs[f"{label} {mode}"] = leg
            _expect(f"{label} encoder rank {r}", got["encoder"]["counts"],
                    _sharded_encoder_launches(compute))
            mem, gib = got["memory"], 2 ** 30
            print(f"{label} rank {r} params: {mem['param_bytes']['total'] / gib:.3f} GiB "
                  f"(encoder {mem['param_bytes']['encoder'] / gib:.3f}, its int8 codes "
                  f"{mem['param_bytes']['encoder_codes'] / gib:.3f}); reckoned slice "
                  f"{mem['reckoned']['total'] / gib:.3f} (encoder "
                  f"{mem['reckoned']['encoder'] / gib:.3f}, codes "
                  f"{mem['reckoned'].get('encoder_codes', 0) / gib:.3f}) of the whole "
                  f"{mem['whole']['total'] / gib:.3f} (encoder {mem['whole']['encoder'] / gib:.3f}, "
                  f"codes {mem['whole'].get('encoder_codes', 0) / gib:.3f}); "
                  f"memory_allocated {mem['allocated'] / gib:.3f} GiB after construction, "
                  f"peak {mem['construction_peak'] / gib:.3f} GiB during it ({card})")
            check(mem["allocated"] < mem["reckoned"]["total"] + RESIDENT_SLACK,
                  f"{label} rank {r}: {mem['allocated']} bytes resident after construction, "
                  f"the slices are {mem['reckoned']['total']}")
            _hold_rank_encoder(f"{label} rank {r}", compute, enc_refs[compute], torch.load(
                os.path.join(store, f"encoder{r}.pt")).cuda(), got["encoder"], card)
            if r == 0:
                encoders[compute] = dict(got["encoder"], memory=mem)
        for mode, _ in SHARDED_MODES:
            ref = refs[compute][mode]
            got = torch.load(os.path.join(store, f"{mode}.pt"), weights_only=False)
            leg = legs[f"{label} {mode}"]
            leg.update(_gap_summary(ref["logits"], list(got["logits"].cuda())),
                       first_difference=_first_difference(ref["out"], got["out"]))
            limit = {k: CONTROL_MARGIN * max(c[k] for c in ref["controls"].values())
                     for k in ("worst_gap", "median_gap")}
            print(f"{label} {mode}: {leg['steps']} steps, {leg['ms_per_step']:.2f} ms per "
                  f"step (rank 0, the card shared by {world} ranks and the other work); "
                  f"to the one-card decode: first token difference (row, step) "
                  f"{leg['first_difference']}, step logits worst {leg['worst_gap']:.3e} "
                  f"(limit {limit['worst_gap']:.3e}), median {leg['median_gap']:.3e} "
                  f"(limit {limit['median_gap']:.3e}), argmax equal on "
                  f"{leg['argmax_equal_steps']} of {leg['compared_steps']} steps ({card})")
            check(leg["compared_steps"] == leg["steps"]
                  and all(leg[k] <= limit[k] for k in limit),
                  f"{label} {mode}: further from the one-card decode than its controls")
    torch.cuda.empty_cache()
    seconds = time.perf_counter() - t0
    print("GSPMD legs, ms per step: " + json.dumps(
        {k: round(v["ms_per_step"], 3) for k, v in legs.items()}) + f" ({card})")
    print(f"phase 19 (the GSPMD mesh path): {seconds:.1f} s after phase 12 ({own:.1f} s of "
          f"this process's legs, then the ranks' end); the ranks ran {rank_s:.1f} s from "
          f"their start before phase 12")
    return dict(legs=legs, b13_odd_heads=b13, seconds=seconds, rank_seconds=rank_s,
                encoders=encoders)


def sharded_rank_main(rank: int, world: int, compute: str, store: str) -> int:
    """One rank of :func:`run_sharded_paths`: ``WhisperEngine("large-v3",
    compute_type=compute, mesh=create_mesh(1, world))`` (the seeded weights
    of the main engine), the saved window's audio encoded on the slices
    (``encode_windows``), the saved window decoded beam 5 and greedy through
    the engine's ``run_*_decode`` (int8's OWN_ENCODER_MODE from the rank's
    own encoder output); writes its legs to ``rank<r>.json``, its encoder
    output to ``encoder<r>.pt`` and, rank 0, each mode's tokens and step
    logits to ``<mode>.pt``."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, ROOT)
    from ttasr_torch import resolve_device
    from ttasr_torch.engine.transcriber import WhisperEngine
    from ttasr_torch.parallel.distributed import initialize_distributed
    from ttasr_torch.parallel.sharding import create_mesh

    resolve_device("cuda")
    # one intra-op thread: up to seven processes share the machine's cores
    torch.set_num_threads(1)
    initialize_distributed(f"file://{store}/store", world_size=world, rank=rank,
                           backend="gloo")
    try:
        torch.cuda.reset_peak_memory_stats()
        engine = WhisperEngine("large-v3", compute_type=compute, device="cuda",
                               mesh=create_mesh(1, world))
        torch.cuda.synchronize()
        memory = _rank_memory(engine, compute, world)
        check(engine._tp is None and engine._sharded is not None,
              f"rank {rank}: the {compute} engine at (1, {world}) must take the GSPMD path")
        ref = torch.load(os.path.join(os.path.dirname(store), "window.pt"),
                         map_location="cuda", weights_only=False)
        window = (ref["enc"], ref["prompt"], ref["pad"], None)
        counters = _int8_counters()
        enc, encoder = _encode_leg(f"{compute} (1, {world}) encoder", lambda: engine.encode_windows(
            ref["audio"][None]), counters, f"rank {rank}")
        torch.save(enc.cpu(), os.path.join(store, f"encoder{rank}.pt"))
        legs = {}
        for mode, beam in SHARDED_MODES:
            opts = _sharded_opts(compute, beam)
            src = ((enc, *window[1:]) if compute == "int8" and mode == OWN_ENCODER_MODE
                   else window)
            if beam > 1:
                def run():
                    return engine.run_beam_decode(*src, opts)
            else:
                def run():
                    return engine.run_greedy_decode(*src, 0.0, opts)
            out, logits, legs[mode] = _decode_leg(f"{compute} (1, {world}) {mode}", run,
                                                  counters, f"rank {rank}")
            if rank == 0:
                torch.save(dict(logits=torch.stack(logits).cpu(),
                                out={k: out[k] for k in ("tokens", "lengths", "steps")}),
                           os.path.join(store, f"{mode}.pt"))
        with open(os.path.join(store, f"rank{rank}.json"), "w", encoding="utf-8") as fh:
            json.dump(dict(decode=legs, encoder=encoder, memory=memory), fh)
    finally:
        dist.destroy_process_group()
    return 0


def _rank_memory(engine, compute: str, world: int) -> dict:
    """A mesh engine's resident bytes after its construction: its params'
    bytes (every leaf of ``engine.params``, the encoder's, its int8 codes'),
    ``torch.cuda.memory_allocated`` and the construction's peak, beside
    ``ttasr_torch.tools.memory_accounting.engine_params``' reckoning of a
    rank's slices and of the whole tree; the encoder's codes must be
    K-major and its bytes the reckoned slice's."""
    import torch

    from ttasr_torch.core.checkpoint import named_leaves
    from ttasr_torch.tools.memory_accounting import engine_params

    mine = {"total": 0, "encoder": 0, "encoder_codes": 0}
    for path, leaf in named_leaves(engine.params).items():
        n = leaf.numel() * leaf.element_size()
        mine["total"] += n
        if path.startswith("encoder."):
            mine["encoder"] += n
            if leaf.dtype == torch.int8:
                check(leaf.stride() == (1, leaf.shape[0]), f"{path}: codes not K-major")
                mine["encoder_codes"] += n
    reckoned = engine_params("large-v3", compute, 1, world)
    out = dict(param_bytes=mine, reckoned=reckoned["per_rank"], whole=reckoned["whole"],
               allocated=torch.cuda.memory_allocated(),
               construction_peak=torch.cuda.max_memory_allocated())
    for key in ("encoder", "encoder_codes"):
        check(mine[key] <= reckoned["per_rank"].get(key, 0),
              f"{compute} (1, {world}): {mine[key]} {key} bytes resident, the slice is "
              f"{reckoned['per_rank'].get(key, 0)}")
    return out


# ---------------------------------------------------------------------------
# Phase 14: the server path (BatchServer, the task API's call, the CLI modes)
# ---------------------------------------------------------------------------

# the task API's uploads: synthesized speech, one window each.  Two, not
# four: on random weights every window runs the whole fallback ladder
# (1 + 5 x ceil(5 N / 4) sweeps of 224 steps for N uploads, ~4 s each), and
# the phase keeps to 240 s
UPLOADS = (("upload0", 12.0, 10), ("upload1", 16.0, 11))
CLI_MODE_FILES = UPLOADS[:1]  # the CLI modes' folder
# the CLI modes' decoder depth (of 32): on random weights each mode runs
# the whole fallback ladder (11 sweeps of 224 steps), ~57 s a mode at full
# depth, 16-23 s at 8; 4 since phase 19 joined; every layer is the same
# arithmetic and the encoder stays whole
CLI_MODE_DECODER_LAYERS = 4
# ttasr/api/file_tasks.py TRANSCRIBE_KWARGS, the task worker's decode kwargs
TASK_KWARGS = dict(language="zh", word_timestamps=False, vad_filter=True, beam_size=5,
                   condition_on_previous_text=True, initial_prompt="")
TASK_SLOTS = 4  # the task API's BatchServer: shared_server(engine, slots=4, linger_ms=5)
SHORT_REQUESTS = ((3.0, 14), (12.0, 15))  # seconds, seed: buckets S = 256 and 768


class ServedGroups:
    """Wraps a server's ``_decode_batch`` and, for the calls made inside it,
    the engine's ``encode_windows`` / ``run_beam_decode`` /
    ``run_greedy_decode``: counts sweeps, rows and the dispatches that
    started while another group was in flight, logs each sweep's rows,
    priority rows, beam or not and window (``log``), and keeps each group's
    inputs (packed PCM, prompts, temperatures, seed, options) and outputs
    when ``keep(record, kept)`` says so.  ``close()`` takes the wrappers off
    the engine."""

    def __init__(self, server, engine, keep):
        import threading

        self.engine, self.keep = engine, keep
        self.lock, self.local = threading.Lock(), threading.local()
        self.sweeps = self.rows = self.max_rows = self.overlapped = self.inflight = 0
        self.kept, self.log = [], []
        real = server._decode_batch

        def decode_batch(batch):
            _, is_beam, _, window = batch[0].group_key
            with self.lock:
                self.log.append(dict(rows=len(batch), beam=is_beam, window=window,
                                     priority=sum(r.priority > 0 for r in batch)))
                self.sweeps += 1
                self.rows += len(batch)
                self.max_rows = max(self.max_rows, len(batch))
                self.overlapped += int(self.inflight > 0)
                self.inflight += 1
            rec = self.local.rec = dict(rows=len(batch),
                                        temps=[r.temperature for r in batch])
            try:
                return real(batch)
            finally:
                self.local.rec = None
                with self.lock:
                    self.inflight -= 1
                    if "out" in rec and self.keep(rec, self.kept):
                        self.kept.append(rec)

        def encode(audio, *, window_samples=None):
            rec = getattr(self.local, "rec", None)
            if rec is not None:
                rec.update(audio=np.array(audio), window=window_samples)
            return type(engine).encode_windows(engine, audio, window_samples=window_samples)

        def decoder(kind):
            real_fn = getattr(type(engine), f"run_{kind}_decode")

            def run(enc_out, prompt, pad, rng, *args, opts):
                out = real_fn(engine, enc_out, prompt, pad, rng, *args, opts=opts)
                rec = getattr(self.local, "rec", None)
                if rec is not None:
                    rec.update(kind=kind, prompt=np.array(prompt), pad=np.array(pad),
                               seed=rng.initial_seed(), args=args, opts=opts,
                               out={k: out[k].clone() for k in OUT_KEYS})
                return out
            return run

        server._decode_batch = decode_batch
        engine.encode_windows = encode
        engine.run_beam_decode = decoder("beam")
        engine.run_greedy_decode = decoder("greedy")

    def close(self):
        for name in ("encode_windows", "run_beam_decode", "run_greedy_decode"):
            delattr(self.engine, name)

    def summary(self, label):
        print(f"{label}: {self.sweeps} sweeps, {self.rows} rows served, at most "
              f"{self.max_rows} rows in one sweep, {self.overlapped} dispatches started "
              f"while another group was in flight")


OUT_KEYS = ("tokens", "lengths", "sum_logprob", "no_speech_prob")


def _rerun_group(engine, rec, label):
    """The kept group's packed batch decoded directly (``encode_windows``,
    then ``run_beam_decode`` / ``run_greedy_decode`` with a generator seeded
    as the server seeded it): every output bit for bit.  Returns the encoder
    output and the step logits of the rerun."""
    import torch

    with _step_logits() as logits:
        enc = engine.encode_windows(rec["audio"], window_samples=rec["window"])
        gen = torch.Generator(device=engine.device).manual_seed(rec["seed"])
        decode = engine.run_beam_decode if rec["kind"] == "beam" else engine.run_greedy_decode
        out = decode(enc, rec["prompt"], rec["pad"], gen, *rec["args"], opts=rec["opts"])
    same = {k: torch.equal(out[k], rec["out"][k]) for k in OUT_KEYS}
    print(f"{label}: {rec['rows']} rows of {rec['audio'].shape[0]} slots, temperatures "
          f"{rec['temps']}, seed {rec['seed']}, S = {enc.shape[1]}: the direct decode of the "
          f"same packed batch equals the served one bit for bit: {json.dumps(same)}")
    check(all(same.values()), f"{label}: the served decode differs from the direct "
          f"decode of the same packed batch: {same}")
    return enc, out, logits


def _beam_rows_alone(engine, rec, out, logits):
    """C3's rule, as a report: each packed window of the kept beam group
    decoded alone (batch 1), its tokens and step logits against its beams'
    rows of the packed decode."""
    import torch

    from ttasr_torch.models.whisper.decode import pad_prompts

    k = rec["opts"].beam_size
    for i in range(rec["rows"]):
        prompt, pad = pad_prompts([rec["prompt"][i, rec["pad"][i]:].tolist()], engine.ti.eot)
        with _step_logits() as alone_logits:
            enc = engine.encode_windows(rec["audio"][i:i + 1], window_samples=rec["window"])
            alone = engine.run_beam_decode(
                enc, prompt, pad, torch.Generator(device=engine.device).manual_seed(0),
                opts=rec["opts"])
        packed_rows = [x[i * k:(i + 1) * k] for x in logits]
        gaps = sorted(g for g, _ in _logit_gaps(alone_logits, packed_rows))
        packed = {"tokens": out["tokens"][i:i + 1], "lengths": out["lengths"][i:i + 1]}
        diff = _first_difference(packed, alone)
        print(f"  window {i} alone vs packed (report, ROADMAP C3): step-logit gaps worst "
              f"{gaps[-1]:.3e}, median {gaps[len(gaps) // 2]:.3e} over {len(gaps)} steps; "
              + ("tokens equal" if diff is None else f"first differing token at step {diff[1]}"))


def _uploads(engine, paths):
    """The task API's call: every path submitted at once as an upload (PCM
    loaded with ``int16=True`` off the loop, every file before the first
    submission), through ``shared_server(engine, slots=4, linger_ms=5)`` and
    ``transcribe_batched_with_server`` with the task worker's kwargs.
    Returns the results (an exception where one failed), the group wrapper
    and the wall.

    The loads finish before any upload is submitted, so the uploads' VADs
    are queued together and the server coalesces their first windows into
    one beam group (it defers a bulk sweep while a VAD is pending); their
    first fallback rung's best-of candidates (5 per upload) then reach the
    queue in one loop tick, and the server dispatches the second group of
    4 while the first decodes.  A load that finished a VAD's length after
    another's split the beam group, and no dispatch overlapped (0 of 17
    sweeps once on the card)."""
    import asyncio

    from ttasr_torch.audio.io import load_audio
    from ttasr_torch.engine.batched import transcribe_batched_with_server
    from ttasr_torch.engine.serving import shared_server

    def keep(rec, kept):  # the first beam group of 2+ rows, the first sampled one
        beam = rec["kind"] == "beam"
        wanted = rec["rows"] >= 2 if beam else any(t > 0 for t in rec["temps"])
        return wanted and all((r["kind"] == "beam") != beam for r in kept)

    async def call():
        server = await shared_server(engine, slots=TASK_SLOTS, linger_ms=5)
        groups = ServedGroups(server, engine, keep)
        loop = asyncio.get_running_loop()

        try:
            loaded = await asyncio.gather(*[loop.run_in_executor(
                None, lambda p=p: load_audio(p, int16=True)) for p in paths])
            return await asyncio.gather(*[
                transcribe_batched_with_server(engine, server, audio, **TASK_KWARGS)
                for audio, _ in loaded], return_exceptions=True), groups
        finally:
            await server.stop()
            groups.close()

    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results, groups = asyncio.run(call())
    torch.cuda.synchronize()
    return results, groups, time.perf_counter() - t0


def _short_windows(engine):
    """One 3 s and one 12 s request with ``short_window=True`` through a
    BatchServer: each group equals the direct decode of its packed batch at
    the bucket's window (S = 256 and 768) bit for bit."""
    import asyncio

    from ttasr_torch.engine.serving import BatchServer, window_bucket

    prompt = engine.tokenizer.sot_sequence("zh", "transcribe", predict_timestamps=True)

    async def call():
        server = BatchServer(engine, slots=TASK_SLOTS, linger_ms=5)
        await server.start()
        groups = ServedGroups(server, engine, lambda rec, kept: True)
        try:
            for seconds, seed in SHORT_REQUESTS:
                audio = synth_speech(np.random.default_rng(seed), seconds)[0]
                pcm = (np.clip(audio, -1, 1) * 32767).astype(np.int16)
                await server.transcribe_window(pcm, prompt, short_window=True)
            return groups
        finally:
            await server.stop()
            groups.close()

    groups = asyncio.run(call())
    check(len(groups.kept) == len(SHORT_REQUESTS), f"short windows: {len(groups.kept)} groups")
    for (seconds, _), rec in zip(SHORT_REQUESTS, groups.kept):
        bucket = window_bucket(int(seconds * SR))
        check(rec["window"] == bucket and rec["audio"].shape == (TASK_SLOTS, bucket),
              f"short window {seconds} s: encoded {rec['audio'].shape}")
        enc, _, _ = _rerun_group(engine, rec, f"short window {seconds} s (bucket {bucket} "
                                 f"samples)")
        check(enc.shape[1] == bucket // 320, f"short window: S = {enc.shape[1]}")


def _short_window_kernels(card: str) -> None:
    """B6 and then B3 at the short buckets' T = S = 256 and 768, four audios
    (the server's slots), within the bounds of phases 4 and 5."""
    import torch

    from ttasr_torch.ops import decoder_blocks as blk
    from ttasr_torch.ops.encoder_attention import (
        encoder_attention_merged_qkv,
        encoder_attention_merged_qkv_ref,
    )
    from ttasr_torch.ops.int4 import pack_int4
    from ttasr_torch.ops.quant import quantize_kv_sym

    inp = Inputs(14)
    lay = inp.layer()
    colscale = torch.ones(3 * D, device="cuda")
    colscale[:D] = 0.125
    for t in (256, 768):
        qkv = (inp.randn(TASK_SLOTS, t, 3 * D) * colscale).to(torch.bfloat16)
        got, want = encoder_attention_merged_qkv(qkv, t), encoder_attention_merged_qkv_ref(qkv, t)
        err, scale = _max_err(got, want), want.float().abs().max().item()
        print(f"encoder_attention_merged_qkv B={TASK_SLOTS} T={t}: max_abs_err {err:.3e} "
              f"(bound {BF16_REL * scale:.3e})")
        check(err <= BF16_REL * scale, f"B6 at T={t} disagrees with its plain version: {err}")
        ms, plain_ms = in_turns(lambda: encoder_attention_merged_qkv(qkv, t),
                                lambda: encoder_attention_merged_qkv_ref(qkv, t))
        b = bound([qkv, got], 4.0 * TASK_SLOTS * t * t * D, "bf16")
        print(f"encoder_attention_merged_qkv B={TASK_SLOTS} T={t}: kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, bound {b['bound_ms']:.4f} ms ({b['bound_by']}), "
              f"{b['bound_ms'] / ms:.1%} of the bound ({card})")
    for s in (256, 768):
        cache = []
        for _ in range(2):
            codes, scales = quantize_kv_sym(inp.randn(TASK_SLOTS, s, H, 64, scale=0.5), 7)
            cache += [pack_int4(codes.reshape(TASK_SLOTS, s, D)),
                      scales.transpose(1, 2).contiguous()]
        args = (inp.randn(TASK_SLOTS, 5, D, scale=0.5), inp.randn(TASK_SLOTS, 5, D, scale=0.5),
                lay["wo"], lay["wo_s"], lay["bo"], lay["lnc_s"], lay["lnc_b"],
                lay["wqc"], lay["wqc_s"], lay["bqc"], *cache, s)
        got, want = blk.attnout_ln_q_cross_int8(*args), blk.attnout_ln_q_cross_int8_ref(*args)
        case = f"B={TASK_SLOTS} K=5 S={s} int4 cross-KV"
        check(bool(torch.isfinite(got[1]).all()), f"B3 {case}: not finite")
        _hold("attnout_ln_q_cross_int8", case + " x'", got[0], want[0], 0.0)
        _hold("attnout_ln_q_cross_int8", case + " cross", got[1], want[1], 0.0)


def _server_shape_kernels(card: str) -> dict:
    """B1, B3 and B4 at 20 rows of 4 audios (the task API's beam group), B2
    at 4 audios x 5 beams through the ancestry map and B10 at 4 rows of 4
    audios, against their plain versions within DECODE_REL, timed in turns
    with them (``time_ms``) beside their bounds."""
    import torch

    from ttasr_torch.ops import decoder_blocks as blk
    from ttasr_torch.ops import decoder_mlp as mlp

    inp = Inputs(15)
    lay = inp.layer()
    b, k = TASK_SLOTS, 5
    r = b * k
    x = inp.randn(r, D, scale=0.5)
    cases = {}
    b1 = (x, lay["ln1_s"], lay["ln1_b"], lay["wqkv"], lay["wqkv_s"], lay["bqkv"])
    cases["qkv_int8_fused"] = (blk.qkv_int8_fused, blk.qkv_int8_fused_ref, b1,
                               2.0 * r * D * 3 * D, f"R={r}")
    b3 = (inp.randn(b, k, D, scale=0.5), inp.randn(b, k, D, scale=0.5),
          lay["wo"], lay["wo_s"], lay["bo"], lay["lnc_s"], lay["lnc_b"],
          lay["wqc"], lay["wqc_s"], lay["bqc"], *inp.cross_kv(b, True), S_REAL)
    cases["attnout_ln_q_cross_int8"] = (
        blk.attnout_ln_q_cross_int8, blk.attnout_ln_q_cross_int8_ref, b3,
        2.0 * 2 * r * D * D + 2.0 * 2 * r * S_REAL * D, f"B={b} K={k} int4 cross-KV")
    b4 = (x, inp.randn(r, D, scale=0.5), lay["woc"], lay["woc_s"], lay["boc"],
          lay["ln2_s"], lay["ln2_b"], lay["w1"], lay["w1_s"], lay["b1"], lay["w2"],
          lay["w2_s"], lay["b2"])
    cases["mlp_with_crossout_int8"] = (mlp.mlp_with_crossout_int8,
                                       mlp.mlp_with_crossout_int8_ref, b4,
                                       2.0 * r * (D * D + 2 * D * FFN), f"R={r}")
    length, slot = 480, 477
    for name, kk in (("self_attn_step_indirect_int8", k), ("self_attn_step_int8", 1)):
        pads = [0] * k + [3] * k + [40] * k + [100] * k if kk == k else [0, 3, 40, 100]
        fn, ref, args = _self_step(inp, b, kk, length, slot, pads, True)
        positions = float((slot + 1 - args[-2]).sum().item())
        cases[name] = (functools.partial(fn, n_heads=H, int4=True),
                       functools.partial(ref, n_heads=H, int4=True), args,
                       2.0 * 2 * positions * D, f"B={b} K={kk} len={length} int4")
    res = {}
    for name, (fn, ref, args, ops, case) in cases.items():
        got, want = fn(*args), ref(*args)
        case += " (the server's shape)"
        if isinstance(got, torch.Tensor):
            err = _hold(name, case, got, want, 0.0)
        elif name.startswith("self_attn"):  # the output, then the new codes and scales
            for i in range(1, 5):
                check(torch.equal(got[i], want[i]),
                      f"{name} {case}: new codes or scales differ from the plain version")
            err = _hold(name, case, got[0], want[0], 0.0)
        else:  # B3: x' and the cross-attention output
            err = _hold(name, case + " cross", got[1], want[1],
                        _hold(name, case + " x'", got[0], want[0], 0.0))
        ms, plain_ms = in_turns(lambda: fn(*args), lambda: ref(*args))
        bnd = bound(_tensors(args, fn(*args)), ops, "bf16")
        res[name] = dict(case=case, max_abs_err=err, ms=ms, plain_ms=plain_ms, **bnd)
        print(f"{name} {case}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
              f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']}), {bnd['bound_ms'] / ms:.1%} of "
              f"the bound ({card})")
    return res


def _decoder_cut(engine, layers: int):
    """A view of ``engine`` whose decoder is its first ``layers`` layers
    (the encoder whole): the same weights, device lock and decode stats."""
    import copy

    view = copy.copy(engine)
    dec = engine.params["decoder"]
    view.params = dict(engine.params, decoder=dict(dec, blocks=dec["blocks"][:layers]))
    view.cfg = dataclasses.replace(engine.cfg, decoder_layers=layers)
    return view


def run_server_path(engine, card: str) -> dict:
    """Phase 14 on the main path's engine: the task API's call (two
    uploads at once through the shared server and
    ``transcribe_batched_with_server``); one beam group and one sampled
    greedy group of that call re-run directly, bit for bit; the CLI's
    ``concurrency=4`` and ``batched=True`` modes; two short-window requests;
    B6 and B3 at the short buckets, and the decode kernels at the server's
    shapes.  Launches are exact against the decode stats in every run."""
    import torch

    t_phase = time.perf_counter()
    counters = _int8_counters()
    with tempfile.TemporaryDirectory() as tmp:
        audio_seconds, _ = _write_wavs(tmp, UPLOADS)
        paths = [os.path.join(tmp, f"{name}.wav") for name, _, _ in UPLOADS]
        label = f"task API call ({len(paths)} uploads, {TASK_SLOTS} slots)"
        before = dict(engine.decode_stats)
        for fn in counters:
            fn.launches = 0
        torch.cuda.reset_peak_memory_stats()
        results, groups, wall = _uploads(engine, paths)
        counts = {fn.__name__: fn.launches for fn in counters}
        st = {k: engine.decode_stats[k] - before[k] for k in before}
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        for path, res in zip(paths, results):
            name = os.path.basename(path)
            check(not isinstance(res, BaseException), f"{label} {name}: {res!r}")
            segments, info = res
            # clipped_at= copies the reference's clip of the end only
            # (ROADMAP C6): the fix of C6 drops it, and a late start fails
            late = _segments_well_formed(f"{label} {name}", segments,
                                         clipped_at=info.duration)
            print(f"  {name}: {len(segments)} segments ({late} starting after the file's "
                  f"end, their end clipped to it), {sum(len(s.text) for s in segments)} "
                  f"chars, {info.duration:.1f} s, {info.duration_after_vad:.1f} s after VAD")
        print(f"{label} decode stats: {json.dumps(st)}")
        check(st["nonfinite_logits"] == 0, f"{label}: a decode produced non-finite logits")
        groups.summary(label)
        check(groups.max_rows > 1, f"{label}: no sweep carried more than one row")
        check(groups.overlapped >= 1, f"{label}: no dispatch while another group was in flight")
        _expect_int8_launches(label, counts, st)
        print(f"{label}: {audio_seconds:.1f} s of audio, wall {wall:.2f} s = "
              f"{wall / audio_seconds:.4f} s per audio second, peak memory {peak:.2f} GiB "
              f"({card})")

    kinds = sorted(r["kind"] for r in groups.kept)
    check(kinds == ["beam", "greedy"], f"{label}: kept groups {kinds}")
    for rec in groups.kept:
        what = "beam group" if rec["kind"] == "beam" else "sampled greedy group"
        _, out, logits = _rerun_group(engine, rec, f"{label}, its first {what}")
        if rec["kind"] == "beam":
            _beam_rows_alone(engine, rec, out, logits)
        del logits

    modes = {}
    shallow = _decoder_cut(engine, CLI_MODE_DECODER_LAYERS)
    for mode in ({"concurrency": TASK_SLOTS}, {"batched": True}):
        mode_label = f"CLI {json.dumps(mode)} (decoder {CLI_MODE_DECODER_LAYERS} of {N_LAYERS})"
        run = _drive_cli(shallow, mode_label, card, counters, files=CLI_MODE_FILES, **mode)
        _expect_int8_launches(mode_label, run["counts"], run["stats"],
                              decoder_layers=CLI_MODE_DECODER_LAYERS)
        modes[mode_label] = run["wall"] / run["audio_seconds"]

    _short_windows(engine)
    _short_window_kernels(card)
    kernels = _server_shape_kernels(card)
    seconds = time.perf_counter() - t_phase
    print(f"phase 14 (the server path): {seconds:.1f} s")
    return dict(sweeps=groups.sweeps, rows=groups.rows, max_rows=groups.max_rows,
                overlapped=groups.overlapped, wall_per_audio_s=wall / audio_seconds,
                cli_modes=modes,
                kernels=kernels, seconds=seconds)


# ---------------------------------------------------------------------------
# Phase 15: the HTTP service (the task API, auth and the streaming WebSocket)
# ---------------------------------------------------------------------------

SERVICE_MODEL = "large-v3"  # TTASR_MODEL_PATH and FASTAPI_ASR_MODEL_SIZE
SERVICE_UPLOAD = ("service_upload", 8.0, 30)  # one window: name, seconds, seed
STREAM_SPEECH = (8.0, 31)  # seconds, seed of the streamed speech
STREAM_SILENCE_S = 2.0  # silence sent after it
STREAM_FRAME_S = 0.25  # one binary PCM16 frame, sent at about real time
SERVICE_TIMEOUT_S = 300.0  # a hang guard on the task and the stream, not a bound


@contextlib.contextmanager
def _service_env(tmp: str, model: str, device: str):
    """The service's environment for one run: its data and auth DB in
    ``tmp``, the task API's model and the stream's on ``model`` (one
    ``get_engine`` key), a test JWT secret and the bootstrap admin."""
    env = dict(TTASR_API_DATA_DIR=tmp, ASR_API_AUTH_DB=os.path.join(tmp, "auth.db"),
               ASR_API_JWT_SECRET="chip-smoke-secret", ASR_API_JWT_ALGORITHM="HS256",
               ASR_API_BOOTSTRAP_ADMIN_USERNAME="admin",
               ASR_API_BOOTSTRAP_ADMIN_PASSWORD="admin@0935",
               ASR_API_RESET_ADMIN_ON_STARTUP="1", TTASR_MODEL_PATH=model,
               FASTAPI_ASR_MODEL_SIZE=model, TTASR_MODEL_COMPUTE_TYPE="int8",
               TTASR_MODEL_DEVICE=device, TTASR_VAD_TYPE="simple", FASTAPI_SKIP_INIT="0",
               FASTAPI_WARMUP="0", TTASR_TASK_BATCH_SLOTS=str(TASK_SLOTS),
               TTASR_BATCH_SLOTS=str(TASK_SLOTS))
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


class _ErrorRecords(logging.Handler):
    """Keeps every ERROR record of the ``ttasr_torch`` loggers: the service
    logs and swallows its failures (the task worker, the stream's chunk
    processing, the ASR plugin), as the JAX package does."""

    def __init__(self):
        super().__init__(level=logging.ERROR)
        self.records = []

    def emit(self, record):
        self.records.append(f"{record.name}: {record.getMessage()}"
                            + (f" ({record.exc_info[1]!r})" if record.exc_info else ""))


def _parse_srt(text: str):
    """(start, end, text) of each block of ``segments_to_srt``'s output."""
    def seconds(stamp):
        h, m, rest = stamp.split(":")
        s, ms = rest.split(",")
        return int(h) * 3600 + int(m) * 60 + int(s) + int(ms) / 1000

    blocks = []
    text = text.replace("\r\n", "\n").strip()
    for block in text.split("\n\n") if text else []:
        lines = block.split("\n")
        check(len(lines) >= 2 and lines[0].isdigit() and " --> " in lines[1],
              f"malformed SRT block {block!r}")
        start, end = (seconds(x) for x in lines[1].split(" --> "))
        blocks.append((start, end, "\n".join(lines[2:])))
    return blocks


async def _serve_once(ft, service_app, audio_path: str, stream_pcm: bytes, on_ready):
    """One event loop: ``create_app()`` on a localhost socket; log in as the
    bootstrap admin; open ``/stream/ws/stt?token=...`` and wait for the
    service to be ready (``on_ready(app)`` is called then); upload
    ``audio_path`` as a subtitle task while ``stream_pcm`` goes over the
    socket in ``STREAM_FRAME_S`` frames at about real time; wait until the
    stream's strategy is idle and the task is done; download the TXT and SRT
    and read both health routes.  Returns what it saw."""
    import asyncio

    import aiohttp
    from aiohttp import web

    app = service_app.create_app()
    runner = web.AppRunner(app)
    await runner.setup()
    site = web.TCPSite(runner, "127.0.0.1", 0)
    await site.start()
    port = runner.addresses[0][1]
    base = f"http://127.0.0.1:{port}"
    out = {}
    loop = asyncio.get_running_loop()
    deadline = loop.time() + SERVICE_TIMEOUT_S
    try:
        async with aiohttp.ClientSession() as http:
            r = await http.post(f"{base}/api/v1/login", json={
                "username": "admin", "password": "admin@0935", "rememberMe": 0})
            check(r.status == 200, f"login: HTTP {r.status} {await r.text()}")
            token = (await r.json())["token"]
            headers = {"Authorization": f"Bearer {token}"}
            ws = await http.ws_connect(f"{base}/stream/ws/stt?token={token}")
            hello = await ws.receive_json(timeout=SERVICE_TIMEOUT_S)
            check(hello.get("code") == 100, f"stream handshake: {hello}")
            ready = await ws.receive_json(timeout=SERVICE_TIMEOUT_S)
            check(ready.get("code") == 180, f"stream not ready: {ready}")
            service = app["streaming_service"]
            on_ready(app)

            messages, sent_at = [], {}

            async def receive():
                async for msg in ws:
                    if msg.type == aiohttp.WSMsgType.TEXT:
                        messages.append((loop.time(), json.loads(msg.data)))

            async def stream():
                frame = int(2 * SR * STREAM_FRAME_S)
                t0 = loop.time()
                for i in range(0, len(stream_pcm), frame):
                    await ws.send_bytes(stream_pcm[i:i + frame])
                    end_s = min(i + frame, len(stream_pcm)) / (2 * SR)
                    sent_at[round(end_s, 3)] = loop.time()
                    await asyncio.sleep(max(0.0, t0 + end_s - loop.time()))

            receiver = loop.create_task(receive())
            form = aiohttp.FormData()
            with open(audio_path, "rb") as fh:
                form.add_field("audio", fh.read(), filename=os.path.basename(audio_path),
                               content_type="audio/wav")
            t_upload = loop.time()
            r = await http.post(f"{base}/api/v1/subtitle/tasks", data=form, headers=headers)
            check(r.status == 200, f"upload: HTTP {r.status} {await r.text()}")
            task_id = (await r.json())["id"]
            await stream()

            # the stream is done once its strategy is idle with under a
            # chunk pending; the task once its status is final
            client = service.connected_clients[0]
            strategy = client.buffering_strategy
            chunk = strategy.chunk_length_seconds * SR * 2
            task_s = None
            while True:
                if task_s is None:
                    r = await http.post(f"{base}/api/v1/subtitle/tasks/{task_id}",
                                        headers=headers)
                    status = (await r.json())["data"][0]["status"]
                    if status in (ft.STATUS_AUDIO_DONE, ft.STATUS_FAILED):
                        task_s, out["status"] = loop.time() - t_upload, status
                idle = not strategy.processing_flag and len(client.buffer) <= chunk
                if task_s is not None and idle:
                    break
                check(loop.time() < deadline, f"the service did not finish in "
                      f"{SERVICE_TIMEOUT_S:.0f} s (task status {status}, stream idle {idle})")
                await asyncio.sleep(0.1)
            await ws.close()
            await receiver
            out.update(task_s=task_s, messages=messages, sent_at=sent_at)
            if out["status"] != ft.STATUS_AUDIO_DONE:
                with ft._tasks_conn() as conn:
                    out["error"] = conn.execute("SELECT error FROM subtitle_tasks WHERE id=?",
                                                (task_id,)).fetchone()
                return out
            for kind in ("TXT", "SRT"):
                r = await http.get(f"{base}/api/v1/subtitle/tasks/{task_id}/subtitle"
                                   f"?type={kind}", headers=headers)
                check(r.status == 200, f"download {kind}: HTTP {r.status}")
                out[kind] = await r.text()
            for route in ("/api/health", "/stream/health"):
                r = await http.get(base + route)
                check(r.status == 200, f"{route}: HTTP {r.status}")
                out[route] = await r.json()
            out["same_engine"] = ft.whisper_engine is service.asr_pipeline.engine
            out["engine"] = ft.whisper_engine
            out["server"] = service.batch_server
    finally:
        await runner.cleanup()
    return out


def run_http_service(engine, card: str, model: str = SERVICE_MODEL,
                     device: str = "cuda") -> dict:
    """Phase 15 on the main path's engine (built by ``registry.get_engine``,
    so the app's own ``load_model`` and the stream's init resolve to it):
    the task API, auth and the streaming WebSocket of ``create_app()`` on a
    localhost socket, one upload beside one stream, sharing one engine and
    one ``BatchServer``.  Launches are exact against the decode stats."""
    import asyncio

    import torch

    from ttasr_torch.audio.io import write_wav
    from ttasr_torch.engine import serving

    t_phase = time.perf_counter()
    label = "HTTP service"
    counters = _int8_counters()
    speech = synth_speech(np.random.default_rng(STREAM_SPEECH[1]), STREAM_SPEECH[0])[0]
    stream_audio = np.concatenate([speech, np.zeros(int(SR * STREAM_SILENCE_S), np.float32)])
    stream_pcm = (np.clip(stream_audio, -1, 1) * 32767).astype("<i2").tobytes()
    errors = _ErrorRecords()
    logging.getLogger("ttasr_torch").addHandler(errors)
    with tempfile.TemporaryDirectory() as tmp, _service_env(tmp, model, device):
        from ttasr_torch.api import app as service_app
        from ttasr_torch.api import file_tasks as ft

        check(str(ft.BASE_DIR) == tmp, f"{label}: the task data went to {ft.BASE_DIR}")
        ft.whisper_engine = None
        audio_seconds, _ = _write_wavs(tmp, [SERVICE_UPLOAD])
        audio_path = os.path.join(tmp, f"{SERVICE_UPLOAD[0]}.wav")
        state = {}

        def on_ready(app):  # the stream's server exists: count from here
            server = app["streaming_service"].batch_server
            state["groups"] = ServedGroups(server, engine, keep=lambda rec, kept: False)
            state["before"] = dict(engine.decode_stats)
            for fn in counters:
                fn.launches = 0
            torch.cuda.reset_peak_memory_stats()

        try:
            out = asyncio.run(_serve_once(ft, service_app, audio_path, stream_pcm, on_ready))
        finally:
            logging.getLogger("ttasr_torch").removeHandler(errors)
            if "groups" in state:
                state["groups"].close()
        counts = {fn.__name__: fn.launches for fn in counters}
        st = {k: engine.decode_stats[k] - state["before"][k] for k in state["before"]}
        peak = torch.cuda.max_memory_allocated() / 2 ** 30

    check(not errors.records, f"{label}: ERROR records: {errors.records}")
    check(out["status"] == ft.STATUS_AUDIO_DONE,
          f"{label}: task status {out['status']}, error {out.get('error')}")
    check(out["engine"] is engine and out["same_engine"],
          f"{label}: the task API and the stream did not share the main engine")
    check(serving._SHARED_SERVERS.get(id(engine)) is out["server"],
          f"{label}: the task API and the stream did not share one BatchServer")
    blocks = _parse_srt(out["SRT"])
    duration = SERVICE_UPLOAD[1]
    late = 0
    for start, end, _ in blocks:
        # the batched path clips a segment's end, not its start (ROADMAP C6)
        if start > duration:
            late += 1
            check(end == duration, f"{label}: SRT block {start} --> {end} past {duration}")
        else:
            check(start <= end <= duration, f"{label}: SRT block {start} --> {end}")
    print(f"{label}: task status {out['status']}, TXT {len(out['TXT'])} chars, SRT "
          f"{len(blocks)} blocks ({late} starting after the file's end, their end "
          f"clipped to it)")
    for route in ("/api/health", "/stream/health"):
        print(f"{label}: GET {route} -> {json.dumps(out[route], ensure_ascii=False)}")
    check(out["/api/health"]["model_loaded"] is True, f"{label}: /api/health")
    check(out["/stream/health"]["asr_pipeline"] == "ready", f"{label}: /stream/health")

    partials = [(t, m) for t, m in out["messages"] if m.get("code") == 200 and "result" in m]
    check(partials and all(m["result"][0]["transcript"] for _, m in partials),
          f"{label}: no transcript with text on the socket: {out['messages']}")
    latencies = []
    for t, m in partials:
        start, end = m["result"][0]["startTime"], round(m["result"][0]["endTime"], 3)
        sent = min(out["sent_at"], key=lambda s: abs(s - end))
        check(abs(sent - end) < 1e-3, f"{label}: no frame ends at {end}")
        latencies.append(t - out["sent_at"][sent])
        print(f"  transcript of {start:.2f}-{end:.2f} s of the stream, "
              f"{len(m['result'][0]['transcript'])} chars, {latencies[-1]:.3f} s after "
              f"its last frame")
    sweeps = state["groups"].log
    priority = [s for s in sweeps if s["priority"]]
    bulk_beam = [s for s in sweeps if s["beam"] and not s["priority"]]
    check(priority, f"{label}: no priority request was served")
    check(bulk_beam, f"{label}: no beam group of the upload was served")
    print(f"{label} decode stats: {json.dumps(st)}")
    check(st["nonfinite_logits"] == 0, f"{label}: a decode produced non-finite logits")
    _expect_int8_launches(label, counts, st)
    rows = [s["rows"] for s in sweeps]
    print(f"{label}: {len(sweeps)} sweeps, rows per sweep {rows}, {len(priority)} priority "
          f"sweeps with {sum(s['priority'] for s in priority)} priority rows (windows "
          f"{sorted({s['window'] for s in priority})}), {len(bulk_beam)} beam groups of "
          f"the upload")
    print(f"{label}: upload {audio_seconds:.1f} s of audio done in {out['task_s']:.2f} s = "
          f"{out['task_s'] / audio_seconds:.4f} s per audio second (status polled every "
          f"0.1 s); {len(partials)} transcripts on the socket, latency from the last "
          f"frame to the message median {statistics.median(latencies):.3f} s, worst "
          f"{max(latencies):.3f} s; peak memory {peak:.2f} GiB ({card})")
    seconds = time.perf_counter() - t_phase
    print(f"phase 15 (the HTTP service): {seconds:.1f} s ({card})")
    return dict(status=out["status"], sweeps=len(sweeps), rows=rows,
                priority_rows=sum(s["priority"] for s in priority),
                upload_s_per_audio_s=out["task_s"] / audio_seconds,
                partial_latency_s=dict(median=statistics.median(latencies), worst=max(latencies)),
                peak_gib=peak, seconds=seconds)


# ---------------------------------------------------------------------------
# Phase 16: word timestamps on three routes, the warm-up and the doctor
# ---------------------------------------------------------------------------

WORDS_CLIP = ("words", 12.0, 40)  # name, seconds, seed: one window
WORDS_KWARGS = dict(vad_filter=False, temperature=(0.0,))
# on random weights the window decodes to timestamps and a few text tokens,
# so one more alignment forces a transcript of ALIGN_TOKENS byte tokens on
# the window's encoder row: the pass and the host DTW at a real length
ALIGN_TOKENS = 128
FORCED_TEXT = ("今天天氣很好，我們晚上去士林夜市吃東西。 The night market opens at six, "
               "and the trains run late. 台灣的夜市很熱鬧，大家都很開心。")
# the alignment pass in the engine's dtype (bf16 activations on int8
# weights) against the same pass in float64 on the dequantized decoder
# leaves: attention probabilities over 1500 frames, absolute; the pass
# read 2.3e-5 with max p 2.6e-3 (PERF.md).  The bf16 activations set that
# error: scores rounded to bf16 read only 3.5e-5, so the rounding the pass
# keeps in float32 is held at its own step (SCORE_STEP_BOUND)
ALIGN_PROB_BOUND = 1e-4
# the score step (align._cross_attn_probs) on each layer's own bf16 q and k
# against float64 on the same q and k: float32 sums and softmax leave
# ~1e-9; the control, scores rounded to bf16 (_scores_in_q_dtype), must
# exceed the bound
SCORE_STEP_BOUND = 1e-7
WARMUP_ARGS = ("--model", SERVICE_MODEL, "--slots", "1", "--file-api", "off")


class _AlignCalls:
    """Wraps the engine's ``_align_window_words``: seconds, tokens and the
    device memory above the call's start for each window; and the
    transcriber's ``alignment_heads_qk`` / ``token_timings``: the first
    call's encoder row (``first``) and the last call's text and timings
    (``last``), which the float64 comparison reuses."""

    def __init__(self, engine):
        import torch

        from ttasr_torch.engine import transcriber

        self.calls, self.first, self.last = [], {}, {}
        self._engine, self._tr = engine, transcriber
        self._saved = (transcriber.alignment_heads_qk, transcriber.token_timings)
        heads_qk, timings = self._saved

        def heads(params, cfg, tok, text_tokens, enc_out, **kw):
            qk = heads_qk(params, cfg, tok, text_tokens, enc_out, **kw)
            self.first.setdefault("enc", enc_out)
            self.last.update(text=list(text_tokens), enc=enc_out)
            return qk

        def host(tok, text_tokens, w, **kw):
            out = timings(tok, text_tokens, w, **kw)
            self.last["timings"] = out
            return out

        def align(text_tokens, enc_out, time_offset):
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            out = type(engine)._align_window_words(engine, text_tokens, enc_out, time_offset)
            self.calls.append(dict(tokens=len(text_tokens), s=time.perf_counter() - t0,
                                   peak_gib=(torch.cuda.max_memory_allocated() - base) / 2 ** 30))
            return out

        transcriber.alignment_heads_qk, transcriber.token_timings = heads, host
        engine._align_window_words = align

    def close(self):
        self._tr.alignment_heads_qk, self._tr.token_timings = self._saved
        del self._engine._align_window_words


def _words_well_formed(label, segments) -> int:
    """A words list on every segment with text, each word inside its window
    and ``0 <= start <= end``, starts sorted; returns the word count."""
    n = 0
    for seg in segments:
        if not seg.text.strip():
            continue
        check(seg.words is not None, f"{label}: segment {seg.id} with text has no words")
        offset = seg.seek * 0.01  # the window's (chunk's) start: seek frames of 10 ms
        starts = [w.start for w in seg.words]
        check(starts == sorted(starts), f"{label}: word starts {starts} out of order")
        for w in seg.words:
            check(0 <= w.start <= w.end, f"{label}: word {w}")
            check(offset - 0.01 <= w.start and w.end <= offset + 30.0 + 0.01,
                  f"{label}: word {w} outside its window at {offset:.2f} s")
        n += len(seg.words)
    return n


def _float64_decoder(params):
    """The decoder's leaves in float64, int8 ones dequantized (codes times
    scales)."""
    from ttasr_torch.ops.quant import is_quantized

    def f64(v):
        return v["q"].double() * v["s"].double() if is_quantized(v) else v.double()

    dec = params["decoder"]
    blocks = [{k: f64(v) for k, v in blk.items()} for blk in dec["blocks"]]
    return {"decoder": dict({k: f64(v) for k, v in dec.items() if k != "blocks"},
                            blocks=blocks)}


def _scores_in_q_dtype(q, k):
    """The control of the float64 comparison: ``align._cross_attn_probs``
    with the scores rounded to q's type (bf16) before the softmax, where
    the pass keeps them in float32."""
    import torch

    scale = q.shape[-1] ** -0.5
    scores = torch.matmul((q * scale).transpose(1, 2), k.transpose(1, 2).transpose(-1, -2))
    return torch.softmax(scores.float(), dim=-1)


def _align_against_float64(engine, last, card) -> dict:
    """One window's pass in the engine's dtype against float64 on the card;
    in that pass, the score step on each layer's own q and k against
    float64, beside the control (scores in bf16); the DTW starts of that
    alignment's timings against the float64 pass's."""
    import torch

    from ttasr_torch.models.whisper import align

    text, enc = last["text"], last["enc"]
    tokens, _ = align._teacher_tokens(engine.tokenizer, text)
    arr = torch.tensor([tokens], dtype=torch.long, device=enc.device)
    step = {"pass": 0.0, "control": 0.0}
    sound = align._cross_attn_probs

    def probed(q, k):
        p = sound(q, k)
        want = sound(q.double(), k.double())  # q * 2^-3 is exact in bf16
        step["pass"] = max(step["pass"], float((p.double() - want).abs().max()))
        step["control"] = max(step["control"], float(
            (_scores_in_q_dtype(q, k).double() - want).abs().max()))
        return p

    with torch.inference_mode():
        align._cross_attn_probs = probed
        try:
            _, qk = align.decode_with_cross_attn(engine.params, engine.cfg, arr, enc)
        finally:
            align._cross_attn_probs = sound
        params64 = _float64_decoder(engine.params)
        _, qk64 = align.decode_with_cross_attn(params64, engine.cfg, arr, enc.double())
        err = float((qk.double() - qk64).abs().max())
        p_max = float(qk64.max())
        w64 = qk64[qk64.shape[0] // 2:, 0].cpu().numpy()
    shape, dtype = tuple(qk.shape), qk.dtype
    del params64, qk64, qk
    torch.cuda.empty_cache()
    t64 = align.token_timings(engine.tokenizer, text, w64)
    moved = sum(a.start != b.start for a, b in zip(last["timings"], t64))
    print(f"words: one window's cross-attention {shape} ({dtype} from {enc.dtype} "
          f"activations) against float64: worst |delta p| {err:.3e}, max p {p_max:.3e}, "
          f"bound {ALIGN_PROB_BOUND:g}; DTW start moved on {moved} of {len(t64)} tokens "
          f"({moved / max(len(t64), 1):.1%}) ({card})")
    print(f"words: the score step on each layer's q and k against float64: worst "
          f"|delta p| {step['pass']:.3e}, bound {SCORE_STEP_BOUND:g}; the control with "
          f"bf16 scores {step['control']:.3e}")
    check(err <= ALIGN_PROB_BOUND, f"words: pass vs float64 {err:.3e} > {ALIGN_PROB_BOUND}")
    check(step["pass"] <= SCORE_STEP_BOUND,
          f"words: score step vs float64 {step['pass']:.3e} > {SCORE_STEP_BOUND}")
    check(step["control"] > SCORE_STEP_BOUND,
          f"words: the bf16-score control {step['control']:.3e} is within the bound "
          f"{SCORE_STEP_BOUND}: the check cannot see that rounding")
    return dict(max_abs_err=err, p_max=p_max, step_err=step["pass"],
                step_control_err=step["control"], tokens=len(t64), dtw_start_moved=moved)


def _module_cmd(module, *args):
    return [sys.executable, "-m", module, *args]


def _json_lines(text: str):
    return [json.loads(x) for x in text.splitlines() if x.startswith("{")]


def _word_routes(engine, audio, calls):
    """The clip through the three routes with words, and ``transcribe``
    without; returns their segments and walls."""
    import asyncio

    import torch

    from ttasr_torch.engine.batched import BatchedInferencePipeline
    from ttasr_torch.engine.serving import shared_server

    routes, walls = {}, {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        routes[name] = fn()
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t0

    async def served():
        server = await shared_server(engine, slots=TASK_SLOTS, linger_ms=5)
        try:
            return (await engine.transcribe_with_server(
                audio, server, word_timestamps=True, **WORDS_KWARGS))[0]
        finally:
            await server.stop()

    timed("transcribe", lambda: engine.transcribe(
        audio, word_timestamps=True, **WORDS_KWARGS)[0])
    check(len(calls.calls) >= 1, "words: transcribe aligned no window")
    timed("server", lambda: asyncio.run(served()))
    pipe = BatchedInferencePipeline(engine, batch_size=4)
    try:
        timed("batched", lambda: pipe.transcribe(
            audio, word_timestamps=True, **WORDS_KWARGS)[0])
    finally:
        pipe.close()
    timed("plain", lambda: engine.transcribe(
        audio, word_timestamps=False, **WORDS_KWARGS)[0])
    return routes, walls


def _check_tools(side, warm, warm_wall, card) -> dict:
    """The warm-up's, its dry run's and the doctor's output."""
    import torch

    from ttasr_torch.core.census import census

    check(warm.returncode == 0, f"warmup exited {warm.returncode}: {warm.stderr[-2000:]}")
    lines = _json_lines(warm.stdout)
    entries = [x for x in lines if "family" in x]
    want = census(1, file_api=False)
    check([(x["family"], tuple(x["key"])) for x in entries] == [(f, k) for f, k, _ in want]
          and all("s" in x for x in entries), f"warmup: entries {entries}")
    stages = {x["stage"]: x["s"] for x in lines if "stage" in x}
    check(set(stages) == {"kernel_build", "engine_init"}, f"warmup: stages {stages}")
    total = [x for x in lines if "warmup_total_s" in x]
    check(len(total) == 1 and total[0]["programs"] == len(want), f"warmup: {total}")
    print(f"warmup ({' '.join(WARMUP_ARGS)}): kernels {stages['kernel_build']:.3f} s, "
          f"engine {stages['engine_init']:.3f} s, entries " + json.dumps(
              [[x["family"], x["key"], x["s"]] for x in entries])
          + f", total {total[0]['warmup_total_s']:.3f} s, process {warm_wall:.1f} s ({card})")

    outs = {}
    for name, proc in side.items():
        out, err = proc.communicate(timeout=300)
        check(proc.returncode == 0, f"{name} exited {proc.returncode}: {err[-2000:]}")
        outs[name] = out
    dry = [(x["family"], tuple(x["key"]), x["why"]) for x in _json_lines(outs["dry_run"])]
    check(dry == census(8) and len(dry) == 14, f"warmup --dry-run: {dry}")
    print(f"warmup --dry-run: {len(dry)} entries, equal to census(8)")
    report = json.loads(outs["doctor"])
    dev, kern, nat = report["devices"], report["kernels"], report["native"]
    check(dev.get("cuda_available") is True
          and dev["devices"][0] == torch.cuda.get_device_name(0), f"doctor: devices {dev}")
    check(kern.get("loaded") is True, f"doctor: kernels {kern}")
    check(nat.get("built") is True or bool(nat.get("error")), f"doctor: native {nat}")
    print("doctor: devices " + json.dumps(dev) + "; kernels " + json.dumps(kern)
          + "; native " + json.dumps(nat))
    return dict(stages=stages, entries=entries, total=total[0], doctor=report)


def run_words_and_tools(engine, card: str) -> dict:
    """Phase 16 on the main path's engine: word timestamps through the
    three routes, one window's pass against float64, then the warm-up and
    the doctor as a user runs them (``python -m``, their own processes)."""
    t_phase = time.perf_counter()
    label = "words"
    env = dict(os.environ, PYTHONPATH=ROOT)
    with tempfile.TemporaryDirectory() as tmp:
        # the doctor and the dry run need no card time: they run beside the routes
        side = {name: subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                                       stderr=subprocess.PIPE, text=True)
                for name, cmd in (
                    ("doctor", _module_cmd("ttasr_torch.cli.doctor", "--model-dir", tmp)),
                    ("dry_run", _module_cmd("ttasr_torch.cli.warmup", "--dry-run")))}
        try:
            errors = _ErrorRecords()
            logging.getLogger("ttasr_torch").addHandler(errors)
            calls = _AlignCalls(engine)
            try:
                audio = synth_speech(np.random.default_rng(WORDS_CLIP[2]), WORDS_CLIP[1])[0]
                routes, walls = _word_routes(engine, audio, calls)
                forced = engine.tokenizer.encode(FORCED_TEXT)[:ALIGN_TOKENS]
                check(len(forced) == ALIGN_TOKENS, f"{label}: forced text {len(forced)} tokens")
                forced_words = engine._align_window_words(forced, calls.first["enc"], 0.0)
            finally:
                calls.close()
                logging.getLogger("ttasr_torch").removeHandler(errors)

            check(not errors.records, f"{label}: ERROR records: {errors.records}")
            plain = routes.pop("plain")
            check([s.tokens for s in routes["transcribe"]] == [s.tokens for s in plain],
                  f"{label}: the alignment changed the decoded tokens")
            check(all(s.words is None for s in plain),
                  f"{label}: words without word_timestamps")
            counts = {name: _words_well_formed(f"{label} ({name})", segs)
                      for name, segs in routes.items()}
            check(sum(counts.values()) > 0, f"{label}: no word on any route: {counts}")
            for name, segs in routes.items():
                print(f"{label} ({name}): {len(segs)} segments, {counts[name]} words, wall "
                      f"{walls[name]:.2f} s; first words " + json.dumps(
                          [(w.word, w.start, w.end) for s in segs
                           for w in (s.words or [])][:4], ensure_ascii=False))
            print(f"{label}: transcribe without words {walls['plain']:.2f} s, the same "
                  f"tokens")
            for c in calls.calls:
                print(f"{label}: alignment of {c['tokens']} tokens {c['s']:.2f} s, peak "
                      f"{c['peak_gib']:.3f} GiB above its start ({card})")
            check(len(forced_words) > 0 and all(0 <= w.start <= w.end <= 30.0
                                                for w in forced_words),
                  f"{label}: forced transcript's words {forced_words}")
            print(f"{label}: the forced {ALIGN_TOKENS}-token transcript gave "
                  f"{len(forced_words)} words, the first " + json.dumps(
                      [(w.word, w.start, w.end) for w in forced_words[:4]],
                      ensure_ascii=False))
            against64 = _align_against_float64(engine, calls.last, card)

            # the warm-up on the card, alone
            t0 = time.perf_counter()
            warm = subprocess.run(_module_cmd("ttasr_torch.cli.warmup", *WARMUP_ARGS),
                                  cwd=ROOT, env=env, capture_output=True, text=True,
                                  timeout=300)
            tools = _check_tools(side, warm, time.perf_counter() - t0, card)
        finally:
            for proc in side.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.communicate()
    seconds = time.perf_counter() - t_phase
    print(f"phase 16 (word timestamps, warmup, doctor): {seconds:.1f} s ({card})")
    return dict(words=counts, walls=walls, align=calls.calls, against_float64=against64,
                tools=tools, seconds=seconds)

# ---------------------------------------------------------------------------
# Phase 17: fine-tuning on the card
# ---------------------------------------------------------------------------

# the training corpus: two synthesized clips with one sentence as their label
TRAIN_CLIPS = (("train20", 20.0, 40), ("train28", 28.0, 41))  # name, seconds, seed
TRAIN_TEXT = "今天天氣很好，我們一起去夜市吃東西。the weather is fine today"
TRAIN_LABEL_PAD = 128
TRAIN_STEPS = 8
TRAIN_LR = 1e-4
# leg a: the last loss of TRAIN_STEPS steps on one batch under this share of
# the first (a trial on an H100 read 11.2535 -> 6.1698, 0.548; PERF.md,
# Findings)
LOSS_FALL = 0.7
EVAL_MAX_LENGTH = 48
# leg b's evaluate wall when B11's float32 inputs took the SIMT kernel
# (H100 80GB HBM3, 700 W: the proof run of this script before the 3xTF32
# kernel), printed beside this run's
EVAL_WALL_SIMT_S = 1.67
EVAL_BATCH = 2
CARD_GRAD_REL = 1e-4  # card against CPU: each leaf within 1e-4 of its largest |g|
SMALL_LAYERS = 2  # legs c and d: large-v3's width, 2 + 2 layers
TRAIN_CLI_ARGS = ("--model_name_or_path", "tiny", "--corpus_data_dir", "sample_corpus",
                  "--dataset_config_name", "train_ds_01", "--max_steps", "2",
                  "--do_train", "--do_eval", "--max_eval_samples", "2")


def _train_corpus(root: str) -> str:
    """``root/synth/{train,test}.tsv`` and ``clips/`` of ``TRAIN_CLIPS``, each
    labelled ``TRAIN_TEXT``; returns the corpus directory."""
    from ttasr_torch.audio.io import write_wav

    clips = os.path.join(root, "synth", "clips")
    os.makedirs(clips)
    rows = ["path\tsentence"]
    for name, seconds, seed in TRAIN_CLIPS:
        audio, _ = synth_speech(np.random.default_rng(seed), seconds)
        write_wav(os.path.join(clips, f"{name}.wav"), audio, SR)
        rows.append(f"{name}.wav\t{TRAIN_TEXT}")
    for split in ("train", "test"):
        with open(os.path.join(root, "synth", f"{split}.tsv"), "w", encoding="utf-8") as fh:
            fh.write("\n".join(rows) + "\n")
    return root


def _every_counter():
    """Every kernel wrapper's launch counter."""
    from ttasr_torch.ops import encoder_attention, mel_fused

    return _int8_counters() + [encoder_attention.encoder_self_attention,
                               mel_fused.log_mel_spectrogram_fused]


def _small_config():
    from ttasr_torch.models.whisper.config import PRESETS

    return dataclasses.replace(PRESETS["large-v3"], name=f"large-v3-{SMALL_LAYERS}+"
                               f"{SMALL_LAYERS}", encoder_layers=SMALL_LAYERS,
                               decoder_layers=SMALL_LAYERS)


def _leaf_gaps(got: dict, want: dict) -> dict:
    """{leaf: max|got - want|} (on the CPU)."""
    return {k: (got[k].float().cpu() - want[k].float().cpu()).abs().max().item()
            for k in want}


def _train_full_width(corpus: str, tok, counters, card: str) -> dict:
    """Leg a: large-v3 at full width and depth, f32 master params, the bf16
    step with remat and SpecAugment, TRAIN_STEPS steps on one batch."""
    import torch

    from ttasr_torch.core.checkpoint import named_leaves
    from ttasr_torch.models.whisper.load import load_whisper
    from ttasr_torch.train.data import batch_iterator, load_tsv_corpus
    from ttasr_torch.train.spec_augment import SpecAugmentConfig
    from ttasr_torch.train.train_step import (
        init_train_state,
        make_optimizer,
        make_train_step,
    )

    label = "training large-v3"
    params, cfg = load_whisper("large-v3", dtype=torch.float32, device="cuda", seed=0)
    n = sum(t.numel() for t in named_leaves(params).values())
    batch = next(batch_iterator(load_tsv_corpus(corpus, "synth", "train"), tok,
                                batch_size=len(TRAIN_CLIPS), n_mels=cfg.num_mel_bins,
                                shuffle=False, label_pad_to=TRAIN_LABEL_PAD,
                                device="cuda"))
    tokens = int((batch["labels"] != -100).sum())
    opt = make_optimizer(learning_rate=TRAIN_LR, warmup_steps=0, total_steps=1000)
    state = init_train_state(params, opt)
    step = make_train_step(cfg, opt, remat=True, compute_dtype=torch.bfloat16,
                           spec_augment_cfg=SpecAugmentConfig(), seed=0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters:
        fn.launches = 0
    losses, walls = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        state, loss = step(state, batch)
        losses.append(float(loss))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    _expect(label, {fn.__name__: fn.launches for fn in counters}, {})
    print(f"{label}: losses {json.dumps([round(x, 4) for x in losses])}")
    check(all(np.isfinite(losses)), f"{label}: a loss is not finite")
    check(losses[-1] < LOSS_FALL * losses[0],
          f"{label}: the loss fell {losses[0]:.4f} -> {losses[-1]:.4f}, not under "
          f"{LOSS_FALL} of the first")
    leaves = named_leaves(state.params)
    check(all(v.dtype == torch.float32 for v in leaves.values()),
          f"{label}: a master leaf left float32")
    step_s = statistics.median(walls[2:])
    reckoned = dict(params=4 * n, grads=4 * n, m=4 * n, v=4 * n, bf16_copy=2 * n)
    print(f"{label}: {n / 1e9:.3f} B params, batch {len(TRAIN_CLIPS)} x 30 s windows, "
          f"{tokens} label tokens; steps {json.dumps([round(w, 3) for w in walls])} s; "
          f"median of steps 3-{TRAIN_STEPS} {step_s:.3f} s = {tokens / step_s:.1f} label "
          f"tokens/s; peak memory {peak / 2 ** 30:.2f} GiB against {sum(reckoned.values()) / 1e9:.1f} "
          f"GB reckoned ({', '.join(f'{k} {v / 1e9:.2f} GB' for k, v in reckoned.items())}) "
          f"({card})")
    return dict(params=state.params, cfg=cfg, batch=batch, losses=losses, walls=walls,
                step_s=step_s, tokens_per_s=tokens / step_s, peak_gib=peak / 2 ** 30,
                reckoned_gb=sum(reckoned.values()) / 1e9, n_params=n)


def _evaluate_on_card(params, cfg, corpus: str, tok, counters, card: str) -> dict:
    """Leg b: ``Trainer.evaluate`` on leg a's params (greedy, f32, the
    encoder through B11), B11's launches exact; then B11 in float32 at the
    shape evaluate gives it, (EVAL_BATCH, 1500, D), held to its plain
    version and timed beside it and the library call."""
    import torch

    from ttasr_torch.ops.encoder_attention import (
        encoder_attention_merged,
        encoder_attention_merged_ref,
    )
    from ttasr_torch.train.data import load_tsv_corpus
    from ttasr_torch.train.trainer import Trainer, TrainerConfig

    label = "Trainer.evaluate"
    examples = load_tsv_corpus(corpus, "synth", "test")
    chunks = -(-len(examples) // EVAL_BATCH)
    with tempfile.TemporaryDirectory() as out:
        trainer = Trainer(params, cfg, tok, TrainerConfig(
            output_dir=out, per_device_eval_batch_size=EVAL_BATCH,
            generation_max_length=EVAL_MAX_LENGTH))
        for fn in counters:
            fn.launches = 0
        t0 = time.perf_counter()
        metrics = trainer.evaluate(examples)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        del trainer
    counts = {fn.__name__: fn.launches for fn in counters}
    _expect(label, counts, {"encoder_attention_merged": N_LAYERS * chunks})
    check(metrics["eval_samples"] == len(examples) and np.isfinite(metrics["eval_cer"]),
          f"{label}: {metrics}")
    print(f"{label}: {json.dumps(metrics)} in {wall:.2f} s ({len(examples)} clips, "
          f"{chunks} chunk(s), generation_max_length {EVAL_MAX_LENGTH}; "
          f"{EVAL_WALL_SIMT_S} s with the SIMT f32 kernel in an earlier proof run); B11 "
          f"launches {counts['encoder_attention_merged']} = {N_LAYERS} x {chunks} ({card})")

    gen = torch.Generator(device="cuda").manual_seed(17)

    def rand():
        return torch.randn((EVAL_BATCH, 1500, D), generator=gen, device="cuda")

    q, k, v = rand() * 64 ** -0.5, rand(), rand()
    got = encoder_attention_merged(q, k, v, 1500)
    torch.cuda.synchronize()
    want = encoder_attention_merged_ref(q, k, v, 1500)
    err = _max_err(got, want)
    limit = F32_REL * want.abs().max().item()
    check(err <= limit, f"B11 float32 B={EVAL_BATCH}: {err} > {limit}")
    kernel_ms, plain_ms = in_turns(lambda: encoder_attention_merged(q, k, v, 1500),
                                   lambda: encoder_attention_merged_ref(q, k, v, 1500))
    flop = 4.0 * EVAL_BATCH * 1500 * 1500 * D
    f32 = dict(max_abs_err=err, limit=limit, ms=kernel_ms, plain_ms=plain_ms,
               library_ms=_sdpa_ms(q, k, v, 1500), **_f32_bound([q, k, v, got], flop))
    _f32_attention_line(f"B11 float32 B={EVAL_BATCH} T=1500 (evaluate's chunk, 3xTF32)", f32,
                        flop, card)
    return dict(metrics=metrics, wall=wall, b11_launches=counts["encoder_attention_merged"],
                b11_f32=f32)


def _card_against_cpu(batch, card: str) -> dict:
    """Leg c: large-v3's width, SMALL_LAYERS + SMALL_LAYERS layers, f32,
    batch 1: loss and grads on the card against the port on the CPU; then
    the card's grads with remat against without, and without twice (the
    control of the card's own repeatability)."""
    import torch

    from ttasr_torch.core.checkpoint import map_leaves
    from ttasr_torch.models.whisper.model import init_params
    from ttasr_torch.train.train_step import batch_to, value_and_grad

    cfg = _small_config()
    params_cpu = init_params(cfg, seed=1, device="cpu")
    params = map_leaves(lambda _, t: t.to("cuda"), params_cpu)
    one = batch_to({key: val[:1] for key, val in batch.items()}, "cuda")
    one_cpu = batch_to(one, "cpu")
    t0 = time.perf_counter()
    loss, grads = value_and_grad(params, cfg, one)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    loss_cpu, grads_cpu = value_and_grad(params_cpu, cfg, one_cpu)
    cpu_s = time.perf_counter() - t0
    gaps = _leaf_gaps(grads, grads_cpu)
    rel = {k: gaps[k] / max(grads_cpu[k].abs().max().item(), 1e-30) for k in gaps}
    worst = max(rel, key=rel.get)
    loss_rel = abs(float(loss) - float(loss_cpu)) / abs(float(loss_cpu))
    print(f"card against CPU ({cfg.name}, f32, batch 1): loss {float(loss):.6f} / "
          f"{float(loss_cpu):.6f} (rel {loss_rel:.2e}); worst grad leaf {worst} "
          f"{rel[worst]:.2e} of its largest |g| (bound {CARD_GRAD_REL}); value_and_grad "
          f"{card_s:.2f} s on the card, {cpu_s:.2f} s on the CPU ({card})")
    check(loss_rel <= 1e-5, f"card against CPU: loss {loss_rel}")
    check(rel[worst] <= CARD_GRAD_REL, f"card against CPU: {worst} {rel[worst]}")

    remat_loss, remat = value_and_grad(params, cfg, one, remat=True)
    again_loss, again = value_and_grad(params, cfg, one)
    remat_gaps, control_gaps = _leaf_gaps(remat, grads), _leaf_gaps(again, grads)
    remat_diff = {k: g for k, g in remat_gaps.items() if g > 0}
    control_diff = {k: g for k, g in control_gaps.items() if g > 0}
    print(f"remat against plain on the card: loss {'equal' if torch.equal(remat_loss, loss) else 'differs'}, "
          f"{len(remat_diff)} of {len(grads)} grad leaves differ, largest "
          f"{max(remat_diff.values(), default=0.0):.3e} "
          f"{sorted(remat_diff, key=remat_diff.get)[-3:]}; plain twice (the control): "
          f"loss {'equal' if torch.equal(again_loss, loss) else 'differs'}, "
          f"{len(control_diff)} leaves differ, largest "
          f"{max(control_diff.values(), default=0.0):.3e} "
          f"{sorted(control_diff, key=control_diff.get)[-3:]}")
    check(torch.equal(again_loss, loss) and torch.equal(remat_loss, loss),
          "the card's loss did not repeat")
    if control_diff:  # the card's own repeatability bounds what remat may move
        check(set(remat_diff) <= set(control_diff)
              and max(remat_diff.values(), default=0.0) <= 2 * max(control_diff.values()),
              "remat moved grads beyond what plain twice moved")
        _stem_conv_repeats(params, one)
    else:
        check(not remat_diff, "remat changed the card's grads, and plain twice did not")
    return dict(loss_rel=loss_rel, worst_grad_rel=rel[worst], worst_leaf=worst,
                remat_diff=len(remat_diff), control_diff=sorted(control_diff))


def _stem_conv_repeats(params, batch) -> None:
    """Names the cause when plain twice differs: each stem conv's weight
    gradient, alone, twice on the same input and output gradient."""
    import torch
    import torch.nn.functional as F

    enc = params["encoder"]
    x = batch["mel"].float()
    for name, stride in (("conv1_w", 1), ("conv2_w", 2)):
        w = enc[name].detach().permute(2, 1, 0).contiguous().requires_grad_()
        if name == "conv2_w":
            x = F.gelu(F.conv1d(x, enc["conv1_w"].permute(2, 1, 0), enc["conv1_b"],
                                padding=1)).detach()
        y = F.conv1d(x, w, stride=stride, padding=1)
        g = torch.randn(y.shape, generator=torch.Generator(device=y.device).manual_seed(5),
                        device=y.device)
        a, b = (torch.autograd.grad(y, w, g, retain_graph=True)[0] for _ in range(2))
        print(f"stem {name}'s weight gradient alone, twice: "
              f"{'the same bits' if torch.equal(a, b) else f'differs by {(a - b).abs().max().item():.3e}'}")


def _checkpoint_and_resume(corpus: str, tok, batch, unrepeatable, card: str) -> dict:
    """Leg d: a ``Trainer`` of large-v3's width, SMALL_LAYERS + SMALL_LAYERS
    layers, takes 4 steps saving every 2; checkpoint-4 restored into a
    fresh ``Trainer`` equals the live state bit for bit, and one more step
    from each on the same batch gives the same bits, but in the leaves whose
    gradient leg c found the card not to repeat (``unrepeatable``) and in
    their moments."""
    import torch

    from ttasr_torch.core.checkpoint import STATE_FILE, restore_checkpoint
    from ttasr_torch.models.whisper.model import init_params
    from ttasr_torch.train.data import load_tsv_corpus
    from ttasr_torch.train.trainer import Trainer, TrainerConfig

    cfg = _small_config()
    label = "checkpoint and resume"
    with tempfile.TemporaryDirectory() as root:
        tc = TrainerConfig(output_dir=os.path.join(root, "live"), max_steps=4, save_steps=2,
                           per_device_train_batch_size=len(TRAIN_CLIPS), learning_rate=TRAIN_LR,
                           warmup_steps=0, logging_steps=1, compute_dtype="bfloat16",
                           apply_spec_augment=True, label_pad_to=TRAIN_LABEL_PAD, seed=0)
        live = Trainer(init_params(cfg, seed=2, device="cuda"), cfg, tok, tc)
        t0 = time.perf_counter()
        live.train(load_tsv_corpus(corpus, "synth", "train"))
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        ckpt = os.path.join(tc.output_dir, "checkpoint-4")
        nbytes = os.path.getsize(os.path.join(ckpt, STATE_FILE))
        fresh = Trainer(init_params(cfg, seed=3, device="cuda"), cfg, tok,
                        dataclasses.replace(tc, output_dir=os.path.join(root, "fresh")))
        t0 = time.perf_counter()
        restore_checkpoint(ckpt, fresh.state)
        restore_s = time.perf_counter() - t0
        saved = sorted(os.listdir(tc.output_dir))
    a, b = live.state.state_dict(), fresh.state.state_dict()
    same = a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    check(same and fresh.state.step == 4 and fresh.state.opt_state.count == 4,
          f"{label}: the restored state differs from the live one")
    live.state, _ = live.train_step(live.state, batch)
    fresh.state, _ = fresh.train_step(fresh.state, batch)
    a, b = live.state.state_dict(), fresh.state.state_dict()
    gaps = {k: g for k, g in _leaf_gaps(b, a).items() if g > 0}
    print(f"{label} ({cfg.name}): {saved}; {nbytes / 1e9:.3f} GB on disk per checkpoint "
          f"({len(a)} tensors); 4 steps with 3 saves and the export {train_s:.1f} s, restore "
          f"{restore_s:.1f} s; restored state equal bit for bit; the next step from each: "
          f"{len(gaps)} tensors differ, largest {max(gaps.values(), default=0.0):.3e} ({card})")
    free = {k for k in gaps if k.split("/", 1)[-1] in set(unrepeatable)}
    check(set(gaps) <= free, f"{label}: the next step differs in {sorted(set(gaps) - free)[:4]}")
    return dict(bytes_per_checkpoint=nbytes, train_s=train_s, restore_s=restore_s,
                next_step_tensors_differ=len(gaps))


def _check_train_cli(proc, out: str, wall: float, card: str) -> dict:
    """Leg e: the CLI subprocess's result."""
    stdout, stderr = proc.communicate(timeout=600)
    label = "python -m ttasr_torch.cli.train"
    check(proc.returncode == 0, f"{label}: rc {proc.returncode}: {stderr[-3000:]}")
    records = [json.loads(line) for line in open(os.path.join(out, "metrics.jsonl"),
                                                 encoding="utf-8")]
    losses = [r["loss"] for r in records if "loss" in r]
    check(losses and all(np.isfinite(losses)), f"{label}: losses {records}")
    final = [line for line in stderr.splitlines() if "final metrics" in line]
    check(final and "eval_cer" in final[-1], f"{label}: no eval_cer: {stderr[-2000:]}")
    for name in ("checkpoint-2", "model"):
        check(os.path.isdir(os.path.join(out, name)), f"{label}: no {name}/")
    print(f"{label} {' '.join(TRAIN_CLI_ARGS)}: rc 0 in {wall:.1f} s; metrics.jsonl "
          f"{json.dumps(records)}; {final[-1].split('final metrics: ')[-1]}; "
          f"{sorted(os.listdir(out))} ({card})")
    return dict(wall=wall, records=records)


def run_training(card: str) -> dict:
    """Phase 17: fine-tuning on the card, legs a-e."""
    import torch

    from ttasr_torch.text.tokenizer import build_byte_fallback_tokenizer

    t_phase = time.perf_counter()
    tok = build_byte_fallback_tokenizer()
    counters = _every_counter()
    with tempfile.TemporaryDirectory() as tmp:
        corpus = _train_corpus(os.path.join(tmp, "corpus"))
        full = _train_full_width(corpus, tok, counters, card)
        # leg e needs little of the card: it runs beside legs b-d
        cli_out = os.path.join(tmp, "cli")
        cli = subprocess.Popen(_module_cmd("ttasr_torch.cli.train", *TRAIN_CLI_ARGS,
                                           "--output_dir", cli_out),
                               cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT),
                               stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        t_cli = time.perf_counter()
        try:
            evaluation = _evaluate_on_card(full["params"], full["cfg"], corpus, tok,
                                           counters, card)
            batch = full.pop("batch")
            del full["params"]
            torch.cuda.empty_cache()
            against_cpu = _card_against_cpu(batch, card)
            resume = _checkpoint_and_resume(corpus, tok, batch, against_cpu["control_diff"],
                                            card)
            cli_run = _check_train_cli(cli, cli_out, time.perf_counter() - t_cli, card)
        finally:
            if cli.poll() is None:
                cli.kill()
                cli.communicate()
    seconds = time.perf_counter() - t_phase
    print(f"phase 17 (fine-tuning): {seconds:.1f} s ({card})")
    return dict(full={k: v for k, v in full.items() if k != "cfg"}, evaluate=evaluation,
                against_cpu=against_cpu, resume=resume, cli=cli_run, seconds=seconds)


# ---------------------------------------------------------------------------
# Phase 18: a trained model recognised on the card
# ---------------------------------------------------------------------------

# d 128, 2 heads of 64, F 512, 2 + 2 layers: large-v3's fused int8 path
MICRO = "micro64-test"
# the recognition check's defaults (tools/check_trained_recognition.py's main)
RECOG_CLIPS, RECOG_STEPS, RECOG_LR, RECOG_SEED = 6, 800, 3e-3, 0
MAX_CER = 0.05
MICRO_SELF = ((64, 61), (480, 477))  # B2/B10 cache lengths and slots
# the VAD: the torch forward on the card against the numpy inference on the
# shipped weights (float32 FFTs and convs in other orders; 1.5e-5 and 6.0e-5
# on the CPU for two synthesized clips).  A batch's log-mel, card against
# CPU, where the mel power is well above the 1e-8 floor: near the floor a
# power difference of 1e-11 moves the log by 1e-3, and on tonal negatives
# (most bins at the floor, each bin's spread over time ~1e-5) the
# per-utterance normalisation lifts that to O(1) inputs (the reference's JAX
# forward and numpy inference differ by up to 0.12 in probability there),
# so training is compared on the CPU's log-mels: the first step's grads, of
# each leaf's largest |g|, within VAD_CONTROL_MARGIN times the CPU's own
# gap when the log-mels move by one float32 ulp (the normalisation is as
# ill-conditioned there: float32 against float64 on the same log-mels
# differs by 0.6 % of w1's largest grad on the CPU); after VAD_STEPS steps
# each leaf's L2 gap over its norm and the losses (Adam steps sign(g) where
# |g| is near 0, so 1e-7 of relative noise on the CPU's log-mels alone moved
# the params by 0.2-5 % and the losses by up to 3e-3 after 20 steps)
VAD_PROB_ABS = 1e-3
VAD_LOUD_POWER = 1e-4
VAD_MEL_REL = 1e-4
VAD_CONTROL_SEEDS, VAD_CONTROL_MARGIN = 3, 2.0
VAD_STEPS, VAD_BATCH, VAD_SECONDS, VAD_LR = 20, 16, 3.0, 3e-3
VAD_PARAM_L2 = 0.15
VAD_LOSS_ABS = 0.02
DIVERGENCE_ARGS = ("--ab", "kernels", "--windows", "2", "--sample-len", "32")
PROFILE_BATCH = 1


def _micro_kernels(card: str) -> dict:
    """B1-B10 and the qkv epilogue at ``MICRO``'s widths against their plain
    versions, under the bounds of phases 4 and 5: the decode kernels at 5
    rows, beam 5 of one audio and 5 audios x 1 row, cache lengths 64 and
    480 (int4 and int8 self-KV, new codes exact), B3 over int4 and int8
    cross-KV of S = 1500; the encoder's at B = 1, T = 1500 (B5, B8, B9
    from x and from the int8 GEMM's accumulators); each timed beside its
    plain version with its bound.  Returns {name: measured}."""
    import torch

    from ttasr_torch.models.whisper.config import get_config
    from ttasr_torch.ops import decoder_blocks as blk
    from ttasr_torch.ops import decoder_mlp as mlp
    from ttasr_torch.ops import encoder_fused as ef
    from ttasr_torch.ops.encoder_attention import (
        encoder_attention_merged_qkv,
        encoder_attention_merged_qkv_ref,
    )

    cfg = get_config(MICRO)
    d, h, ffn = cfg.d_model, cfg.decoder_heads, cfg.ffn_dim
    inp = Inputs(18, d=d, h=h, ffn=ffn)
    lay = inp.layer()
    res = {}

    def timed(name, case, fn, ref, args, err, ops, kind="bf16", read=None):
        """``read``: the inputs as the kernel reads them, for the bound."""
        ms, plain_ms = in_turns(lambda: fn(*args), lambda: ref(*args))
        res[name] = dict(case=case, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         **bound(_tensors(read or args, fn(*args)), ops, kind))
        r = res[name]
        print(f"{name} {MICRO} {case}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}), {r['bound_ms'] / ms:.1%} of the "
              f"bound ({card})")

    # B1 at 5 rows
    b1 = (inp.randn(5, d, scale=0.5), lay["ln1_s"], lay["ln1_b"], lay["wqkv"],
          lay["wqkv_s"], lay["bqkv"])
    err = _hold("qkv_int8_fused", f"{MICRO} R=5", blk.qkv_int8_fused(*b1),
                blk.qkv_int8_fused_ref(*b1), 0.0)
    _same_bits(f"qkv_int8_fused {MICRO} R=5", lambda: blk.qkv_int8_fused(*b1))
    timed("qkv_int8_fused", "R=5", blk.qkv_int8_fused, blk.qkv_int8_fused_ref, b1, err,
          2.0 * 5 * d * 3 * d)

    # B3: beam 5 of one audio over int4 cross-KV, 5 audios x 1 over int8
    worst, b3 = 0.0, None
    for b, k, int4 in ((1, 5, True), (5, 1, False)):
        args = (inp.randn(b, k, d, scale=0.5), inp.randn(b, k, d, scale=0.5),
                lay["wo"], lay["wo_s"], lay["bo"], lay["lnc_s"], lay["lnc_b"],
                lay["wqc"], lay["wqc_s"], lay["bqc"], *inp.cross_kv(b, int4), S_REAL)
        got, want = blk.attnout_ln_q_cross_int8(*args), blk.attnout_ln_q_cross_int8_ref(*args)
        case = f"{MICRO} B={b} K={k} {'int4' if int4 else 'int8'} cross-KV"
        worst = _hold("attnout_ln_q_cross_int8", case + " x'", got[0], want[0], worst)
        worst = _hold("attnout_ln_q_cross_int8", case + " cross", got[1], want[1], worst)
        b3 = b3 or args
    timed("attnout_ln_q_cross_int8", "B=1 K=5 int4 cross-KV", blk.attnout_ln_q_cross_int8,
          blk.attnout_ln_q_cross_int8_ref, b3, worst,
          2.0 * 2 * 5 * d * d + 2.0 * 2 * 5 * S_REAL * d)

    # B4 at 5 and 10 rows: the persistent plan with most blocks idle
    worst, b4 = 0.0, None
    for r in (5, 10):
        args = (inp.randn(r, d, scale=0.5), inp.randn(r, d, scale=0.5),
                lay["woc"], lay["woc_s"], lay["boc"], lay["ln2_s"], lay["ln2_b"],
                lay["w1"], lay["w1_s"], lay["b1"], lay["w2"], lay["w2_s"], lay["b2"])
        got = mlp.mlp_with_crossout_int8(*args)
        worst = _hold("mlp_with_crossout_int8", f"{MICRO} R={r}", got,
                      mlp.mlp_with_crossout_int8_ref(*args), worst)
        _b4_is_b15_then_b14(f"{MICRO} R={r}", args, got)
        b4 = b4 or args
    _same_bits(f"mlp_with_crossout_int8 {MICRO} R=5", lambda: mlp.mlp_with_crossout_int8(*b4))
    timed("mlp_with_crossout_int8", "R=5", mlp.mlp_with_crossout_int8,
          mlp.mlp_with_crossout_int8_ref, b4, worst, 2.0 * 5 * (d * d + 2 * d * ffn))

    # B2 (beam 5 of one audio, through the ancestry map) and B10 (5 x 1)
    for name, b, k in (("self_attn_step_indirect_int8", 1, 5), ("self_attn_step_int8", 5, 1)):
        worst = 0.0
        for length, slot in MICRO_SELF:
            for int4 in (True, False):
                fn, ref, args = _self_step(inp, b, k, length, slot, [0] * 5, int4)
                kw = dict(n_heads=h, int4=int4)
                got, want = fn(*args, **kw), ref(*args, **kw)
                case = f"{MICRO} B={b} K={k} len={length} {'int4' if int4 else 'int8'}"
                check(bool(torch.isfinite(got[0]).all()), f"{name} {case}: not finite")
                worst = _hold(name, case, got[0], want[0], worst)
                for i in range(1, 5):
                    check(torch.equal(got[i], want[i]),
                          f"{name} {case}: new codes or scales differ from the plain version")
        _same_bits(f"{name} {MICRO} len=480 int4", lambda: fn(*args, **kw))
        for length, slot in MICRO_SELF:
            fn, ref, args = _self_step(inp, b, k, length, slot, [0] * 5, True)
            positions = float((slot + 1 - args[-2]).sum().item())
            timed(name if length == 480 else f"{name} len={length}",
                  f"B={b} K={k} len={length} int4",
                  functools.partial(fn, n_heads=h, int4=True),
                  functools.partial(ref, n_heads=h, int4=True), args, worst,
                  2.0 * 2 * positions * d)

    # the encoder's row kernels at B = 1, T = 1500
    gen = torch.Generator(device="cuda").manual_seed(19)

    def act(*shape, scale=1.0):
        x = torch.randn(shape, generator=gen, device="cuda") * scale
        spread = torch.rand(shape[:-1] + (1,), generator=gen, device="cuda") * 3.9 + 0.1
        return (x * spread).to(torch.bfloat16)

    ln_s = (1.0 + 0.1 * torch.randn(d, generator=gen, device="cuda")).to(torch.bfloat16)
    ln_b = (0.1 * torch.randn(d, generator=gen, device="cuda")).to(torch.bfloat16)
    x, y, hid = act(1, ENC_T, d), act(1, ENC_T, d, scale=0.5), act(1, ENC_T, ffn, scale=2.0)
    rows = {  # name: (kernel, plain, args, operations per element, the element count)
        "ln_quant": (ef.ln_quant, ef.ln_quant_ref, (x, ln_s, ln_b), 14, x.numel()),
        "quant_only": (ef.quant_only, ef.quant_only_ref, (x,), 4, x.numel()),
        "add_ln_quant": (ef.add_ln_quant, ef.add_ln_quant_ref, (x, y, ln_s, ln_b), 15,
                         x.numel()),
        "gelu_quant": (ef.gelu_quant, ef.gelu_quant_ref, (hid,), 26, hid.numel()),
    }
    w1, w2, wo, qkv = (_acc_case(gen, 1, *kn) for kn in ((d, ffn), (ffn, d), (d, d),
                                                         (d, 3 * d)))
    rows.update({
        "gelu_quant_acc": (ef.gelu_quant_acc, ef.gelu_quant_acc_ref, w1, 30, w1[0].numel()),
        "ln_quant_acc": (ef.ln_quant_acc, ef.ln_quant_acc_ref, (x, *w2, ln_s, ln_b), 20,
                         w2[0].numel()),
        "add_ln_quant_acc": (ef.add_ln_quant_acc, ef.add_ln_quant_acc_ref,
                             (x, *wo, ln_s, ln_b), 20, wo[0].numel()),
        "qkv_epilogue_acc": (ef.qkv_epilogue_acc, ef.qkv_epilogue_acc_ref, (*qkv, Q_SCALE),
                             4, qkv[0].numel()),
    })
    for name, (fn, ref, args, per_elem, n) in rows.items():
        got, want = fn(*args), ref(*args)
        case = f"{MICRO} B=1 T={ENC_T} width={n // ENC_T}"
        if name == "qkv_epilogue_acc":
            same = torch.equal(got, want)
            print(f"{name} {case}: equal to the plain version bit for bit: {same}")
            check(same, f"{name} {case}: differs from the plain version")
            err = 0.0
        else:
            if name in ("add_ln_quant", "ln_quant_acc", "add_ln_quant_acc"):
                check(torch.equal(got[0], want[0]),
                      f"{name} {case}: the bf16 residual differs from the plain version")
                got, want = got[1:], want[1:]
            err = _hold_codes(name, case, got, want)
        # the LN parameters and column vectors are read as f32
        timed(name, f"B=1 T={ENC_T}", fn, ref, args, err, float(per_elem * n), "f32",
              read=[a.float() if getattr(a, "ndim", 0) == 1 else a for a in args])

    # B6 from the fused (1, 1500, 3 d) buffer, q pre-scaled
    colscale = torch.ones(3 * d, device="cuda")
    colscale[:d] = 0.125
    qkv_buf = (torch.randn((1, ENC_T, 3 * d), generator=gen, device="cuda") * colscale
               ).to(torch.bfloat16)
    got = encoder_attention_merged_qkv(qkv_buf, ENC_T)
    want = encoder_attention_merged_qkv_ref(qkv_buf, ENC_T)
    err, scale = _max_err(got, want), want.float().abs().max().item()
    print(f"encoder_attention_merged_qkv {MICRO} B=1 T={ENC_T} ({h} heads): max_abs_err "
          f"{err:.3e} (bound {BF16_REL * scale:.3e})")
    check(err <= BF16_REL * scale, f"B6 at {MICRO} disagrees with its plain version: {err}")
    timed("encoder_attention_merged_qkv", f"B=1 T={ENC_T}", encoder_attention_merged_qkv,
          encoder_attention_merged_qkv_ref, (qkv_buf, ENC_T), err, 4.0 * ENC_T * ENC_T * d)
    return res


def _recognise(compute: str, examples, trained, card: str) -> dict:
    """The recognition check's transcription (greedy and beam 5, VAD on, the
    temperature ladder) of every clip through a ``compute`` engine on the
    trained float32 params as they are (the int8 engine's s8 x s8 encoder
    then runs the row kernels on float32 rows, ROADMAP C9): greedy CER <=
    MAX_CER, launches exact against the decode stats.  Returns the CERs, the
    wall and the engine."""
    import torch

    from ttasr_torch.engine.transcriber import WhisperEngine
    from ttasr_torch.text.cer import cer_metric
    from ttasr_torch.tools.check_trained_recognition import transcribe_clips

    params, cfg, tok = trained
    engine = WhisperEngine(MICRO, params=params, config=cfg, tokenizer=tok,
                           compute_type=compute, device="cuda")
    label = f"recognition {MICRO} {compute}"
    counters = _int8_counters()
    before = dict(engine.decode_stats)
    for fn in counters:
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    per_clip, hyps = transcribe_clips(engine, examples)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {fn.__name__: fn.launches for fn in counters}
    st = {k: engine.decode_stats[k] - before[k] for k in before}
    refs = [ex.sentence.lower() for ex in examples]
    cer = {beam: cer_metric(refs, hyps[beam]) for beam in hyps}
    for row in per_clip:
        print(f"  {label}: {row['ref']} -> greedy {row['hyp_beam1']!r}, beam 5 "
              f"{row['hyp_beam5']!r}, segments {row['segments']}, VAD kept "
              f"{row['vad_kept_s']} of {row['duration_s']} s")
    print(f"{label}: CER greedy {cer[1]:.4f} (bound {MAX_CER}), beam 5 {cer[5]:.4f} "
          f"(recorded, not gated); {len(examples)} clips in {wall:.2f} s; decode stats "
          f"{json.dumps(st)} ({card})")
    check(st["nonfinite_logits"] == 0, f"{label}: a decode produced non-finite logits")
    check(cer[1] <= MAX_CER, f"{label}: greedy CER {cer[1]} > {MAX_CER}")
    check(all(r["vad_kept_s"] > 0.5 for r in per_clip), f"{label}: the VAD dropped a clip")
    if compute == "int8":
        _expect_int8_launches(label, counts, st, layers=cfg.decoder_layers)
    else:  # B11 in float32 (3xTF32) per encoder layer and pass, nothing else
        _expect(label, counts, {"encoder_attention_merged":
                                cfg.encoder_layers * st["encoder_passes"]})
        print(f"{label}: B11 launched {counts['encoder_attention_merged']} times for "
              f"{st['encoder_passes']} encoder passes x {cfg.encoder_layers} layers")
    return dict(cer_greedy=cer[1], cer_beam5=cer[5], wall=wall, engine=engine)


def _card_texts_are_cpu_texts(engine, examples, trained) -> None:
    """The int8 engine's greedy texts at T = 0 on the card equal, clip for
    clip, an int8 engine's on the CPU (the plain versions) on the same
    params."""
    from ttasr_torch.core.checkpoint import map_leaves
    from ttasr_torch.engine.transcriber import WhisperEngine
    from ttasr_torch.tools.check_trained_recognition import transcribe_clips

    params, cfg, tok = trained
    cpu = WhisperEngine(MICRO, params=map_leaves(lambda _, x: x.cpu(), params),
                        config=cfg, tokenizer=tok, compute_type="int8", device="cpu")
    kw = dict(beams=(1,), temperature=(0.0,))
    _, card_hyps = transcribe_clips(engine, examples, **kw)
    _, cpu_hyps = transcribe_clips(cpu, examples, **kw)
    same = [a == b for a, b in zip(card_hyps[1], cpu_hyps[1])]
    print(f"recognition {MICRO} int8: greedy texts at T = 0 on the card equal the CPU's "
          f"plain versions': {same}")
    check(all(same), f"the card's greedy texts differ from the CPU's: "
                     f"{card_hyps[1]} against {cpu_hyps[1]}")


def _vad_on_card(card: str) -> dict:
    """The VAD's torch forward on the card against ``vad_probabilities``
    (numpy) on the shipped weights; the card's log-mel of a training batch
    against the CPU's; then, on the CPU's log-mels of VAD_STEPS batches
    from one seed, the first step's grads and VAD_STEPS Adam steps on the
    card against the CPU."""
    import torch

    from ttasr_torch.audio import vad_model as vm
    from ttasr_torch.tools import synth
    from ttasr_torch.tools import train_vad as tv

    rng = np.random.default_rng(50)
    audio = np.concatenate([synth.synth_speech(rng, 8.0)[0], np.zeros(2 * SR, np.float32),
                            synth.synth_negative(rng, 6.0)[0]]).astype(np.float32)
    want = vm.vad_probabilities(audio)
    with torch.no_grad():
        got = vm.forward(tv.to_device(vm._load_weights(), "cuda"), vm.log_mel_frames(
            torch.as_tensor(audio, device="cuda"), vm.mel_filterbank())).cpu().numpy()
    err = float(np.abs(got - want).max())
    print(f"VAD forward on the card against vad_probabilities (numpy), {len(want)} frames of "
          f"the shipped weights: max |delta p| {err:.3e} (bound {VAD_PROB_ABS})")
    check(got.shape == want.shape and err <= VAD_PROB_ABS, f"the VAD forward on the card "
          f"disagrees with the numpy inference: {err}")

    fb, n_frames = vm.mel_filterbank(), int(SR * VAD_SECONDS) // vm.WINDOW
    batches = [tv.make_batch(rng, VAD_BATCH, VAD_SECONDS) for _ in range(VAD_STEPS)]
    mels = [(tv.batch_mels(a, fb, n_frames, "cpu"), torch.as_tensor(lab[:, :n_frames]))
            for a, lab in batches]
    card_mel = tv.batch_mels(batches[0][0], fb, n_frames, "cuda").cpu()
    loud = mels[0][0] > np.log(VAD_LOUD_POWER)
    gap = (card_mel - mels[0][0]).abs()
    loud_gap = gap[loud].max().item() / mels[0][0].abs().max().item()
    print(f"VAD log-mel of a batch, card against CPU: {loud_gap:.2e} of the largest magnitude "
          f"where the power exceeds {VAD_LOUD_POWER:g} (bound {VAD_MEL_REL}), "
          f"{gap[~loud].max().item():.3e} at most near the 1e-8 floor (not bounded)")
    check(loud_gap <= VAD_MEL_REL, f"the card's VAD log-mel disagrees with the CPU's: {loud_gap}")

    def train(dev):
        params = tv.to_device(vm.init_vad_params(0), dev)
        opt = tv.Adam(VAD_LR)
        state, losses = opt.init(params), []
        for mel, lab in mels:
            losses.append(tv.train_step(params, opt, state, mel.to(dev), lab.to(dev)))
        return params, [float(x) for x in losses]

    def grads(dev, mel):
        return tv.value_and_grad(tv.to_device(vm.init_vad_params(0), dev), mel.to(dev),
                                 mels[0][1].to(dev))[1]

    def gaps(got, want):
        return {k: (got[k].cpu() - want[k]).abs().max().item() / want[k].abs().max().item()
                for k in want}

    cpu_grads = grads("cpu", mels[0][0])
    grad_gap = gaps(grads("cuda", mels[0][0]), cpu_grads)
    # the control: the CPU's grads on the log-mels moved by one float32 ulp
    # (2**-23 relative noise), the worst of VAD_CONTROL_SEEDS draws
    control = {}
    for seed in range(VAD_CONTROL_SEEDS):
        gen = torch.Generator().manual_seed(seed)
        noisy = mels[0][0] * (1 + 2.0 ** -23 * torch.randn(mels[0][0].shape, generator=gen))
        for k, g in gaps(grads("cpu", noisy), cpu_grads).items():
            control[k] = max(control.get(k, 0.0), g)
    print(f"VAD first step's grads on the same log-mels, card against CPU, of each leaf's "
          f"largest |g|: {json.dumps(grad_gap)}; the CPU's own on log-mels one ulp apart "
          f"(bound: {VAD_CONTROL_MARGIN} x it): {json.dumps(control)}")
    check(all(grad_gap[k] <= VAD_CONTROL_MARGIN * control[k] for k in control),
          "the VAD's grads on the card disagree with the CPU's beyond the control")
    runs = {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        runs[dev] = train(dev)
        print(f"VAD training on {dev}: {VAD_STEPS} steps of {VAD_BATCH} clips in "
              f"{time.perf_counter() - t0:.2f} s, loss {runs[dev][1][0]:.4f} -> "
              f"{runs[dev][1][-1]:.4f}")
    (card_p, card_l), (cpu_p, cpu_l) = runs["cuda"], runs["cpu"]
    l2 = {k: ((card_p[k].cpu() - cpu_p[k]).norm() / cpu_p[k].norm()).item() for k in cpu_p}
    loss_gap = max(abs(a - b) for a, b in zip(card_l, cpu_l))
    print(f"VAD params after {VAD_STEPS} steps, card against CPU, each leaf's L2 gap over "
          f"its norm: {json.dumps(l2)} (bound {VAD_PARAM_L2}); losses within {loss_gap:.2e} "
          f"(bound {VAD_LOSS_ABS}) ({card})")
    check(all(np.isfinite(card_l)) and max(l2.values()) <= VAD_PARAM_L2
          and loss_gap <= VAD_LOSS_ABS, "VAD training on the card disagrees with the CPU's")
    return dict(forward_err=err, mel_gap=loud_gap, grad_gap=grad_gap, grad_control=control,
                param_l2=l2, loss_gap=loss_gap)


def _other_tools(card: str) -> dict:
    """``check_beam_divergence`` (DIVERGENCE_ARGS, large-v3) and
    ``profile_decode --batch PROFILE_BATCH`` at large-v3, in this process:
    a well-formed report, and the profile's stage sum within its tolerance
    of the step's device time."""
    import torch

    from ttasr_torch.tools import check_beam_divergence, profile_decode

    t0 = time.perf_counter()
    report = check_beam_divergence.main(list(DIVERGENCE_ARGS))
    windows = int(DIVERGENCE_ARGS[DIVERGENCE_ARGS.index("--windows") + 1])
    check(report["windows"] == windows and report["windows"] >= report["diverging_windows"] >= 0
          and 0.0 <= report["exact_agreement_rate"] <= 1.0
          and report["cer_between_paths"] >= 0.0, f"beam divergence report: {report}")
    print(f"check_beam_divergence {' '.join(DIVERGENCE_ARGS)}: {time.perf_counter() - t0:.1f} s "
          f"({card})")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    profile = profile_decode.profile_step(batch=PROFILE_BATCH)
    check(profile["sum_checks"], f"profile_decode: the stages sum to "
          f"{profile['stage_sum_over_step']:.1%} of the step's device time")
    print(f"profile_decode --batch {PROFILE_BATCH}: {time.perf_counter() - t0:.1f} s ({card})")
    torch.cuda.empty_cache()
    return dict(divergence=report, profile=profile)


def run_recognition(card: str) -> dict:
    """Phase 18: a trained model recognised on the card, legs a-e."""
    import torch

    from ttasr_torch.tools import check_trained_recognition as ctr

    t_phase = time.perf_counter()
    kernels = _micro_kernels(card)
    print(f"micro64-test kernels: {json.dumps(kernels)} ({card})")
    with tempfile.TemporaryDirectory() as tmp:
        examples = ctr.make_clips(RECOG_CLIPS, RECOG_SEED, tmp)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, cfg, tok, metrics = ctr.train_model(
            examples, MICRO, RECOG_STEPS, RECOG_LR, RECOG_SEED, "cuda", os.path.join(tmp, "out"))
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        print(f"recognition {MICRO}: {RECOG_STEPS} steps on {RECOG_CLIPS} clips, lr {RECOG_LR}, "
              f"in {train_s:.1f} s ({train_s / RECOG_STEPS * 1e3:.1f} ms a step), final loss "
              f"{metrics['train_loss']:.4f} ({card})")
        check(np.isfinite(metrics["train_loss"]), "the recognition model's loss is not finite")
        trained = (params, cfg, tok)
        recognised = {compute: _recognise(compute, examples, trained, card)
                      for compute in ("int8", "float32")}
        _card_texts_are_cpu_texts(recognised["int8"].pop("engine"), examples, trained)
        recognised["float32"].pop("engine")
    del params, trained
    torch.cuda.empty_cache()
    vad = _vad_on_card(card)
    tools = _other_tools(card)
    seconds = time.perf_counter() - t_phase
    print(f"phase 18 (a trained model recognised on the card): {seconds:.1f} s ({card})")
    return dict(kernels=kernels, train_s=train_s, train_loss=metrics["train_loss"],
                recognised=recognised, vad=vad, tools=tools, seconds=seconds)


# ---------------------------------------------------------------------------
# Phase 20: fine-tuning on a mesh
# ---------------------------------------------------------------------------

# large-v3's width at 8 of its 32 + 32 layers: two ranks and the one-card
# references share the card, and the script keeps to its 1200 s
MESH_TRAIN_LAYERS = 8
MESH_TRAIN_STEPS = 3
MESH_TRAIN_LR = 1e-5
MESH_TRAIN_SEED = 7
MESH_RANKS = 2
# leg a's batch: four synthesized clips, their labels of unequal lengths, so
# the two ranks' rows hold unequal token counts
MESH_TRAIN_CLIPS = (("mesh0", 12.0, 50, TRAIN_TEXT), ("mesh1", 20.0, 51, TRAIN_TEXT[:9]),
                    ("mesh2", 27.0, 52, "the weather is fine today"),
                    ("mesh3", 8.0, 53, TRAIN_TEXT[9:]))
# leg c: ZeRO-1's saving in peak memory against half the moments' bytes
# that ttasr_torch.tools.memory_accounting reckons at this depth
ZERO1_PEAK_REL = 0.15


def _mesh_train_config():
    from ttasr_torch.models.whisper.config import PRESETS

    n = MESH_TRAIN_LAYERS
    return dataclasses.replace(PRESETS["large-v3"], name=f"large-v3-{n}+{n}",
                               encoder_layers=n, decoder_layers=n)


def _mesh_train_batch(root: str, tok) -> dict:
    """Leg a's global batch of MESH_TRAIN_CLIPS (on the card), by the
    port's data path."""
    from ttasr_torch.audio.io import write_wav
    from ttasr_torch.train.data import batch_iterator, load_tsv_corpus
    from ttasr_torch.train.train_step import batch_to

    clips = os.path.join(root, "mesh", "clips")
    os.makedirs(clips)
    rows = ["path\tsentence"]
    for name, seconds, seed, text in MESH_TRAIN_CLIPS:
        audio, _ = synth_speech(np.random.default_rng(seed), seconds)
        write_wav(os.path.join(clips, f"{name}.wav"), audio, SR)
        rows.append(f"{name}.wav\t{text}")
    with open(os.path.join(root, "mesh", "train.tsv"), "w", encoding="utf-8") as fh:
        fh.write("\n".join(rows) + "\n")
    return batch_to(next(batch_iterator(
        load_tsv_corpus(root, "mesh", "train"), tok, batch_size=len(MESH_TRAIN_CLIPS),
        n_mels=_mesh_train_config().num_mel_bins, shuffle=False,
        label_pad_to=TRAIN_LABEL_PAD, device="cuda")), "cuda")


def _mesh_optimizer():
    from ttasr_torch.train.train_step import make_optimizer

    return make_optimizer(learning_rate=MESH_TRAIN_LR, warmup_steps=0, total_steps=100)


def _mesh_trainer_config(out: str):
    from ttasr_torch.train.trainer import TrainerConfig

    return TrainerConfig(output_dir=out, max_steps=2, save_steps=1000,
                         per_device_train_batch_size=len(TRAIN_CLIPS),
                         per_device_eval_batch_size=EVAL_BATCH,
                         generation_max_length=EVAL_MAX_LENGTH, learning_rate=MESH_TRAIN_LR,
                         warmup_steps=0, logging_steps=1, label_pad_to=TRAIN_LABEL_PAD,
                         seed=0)


def _state_digest(flat: dict) -> dict:
    """Two sums of each tensor's 32-bit words (plain, and weighted by the
    position), on the card: equal digests stand for equal bits."""
    import torch

    out = {}
    for k, t in flat.items():
        if t.dim() == 0:
            out[k] = [int(t)]
            continue
        words = t.detach().contiguous().view(torch.int32).reshape(-1).to(torch.int64)
        weight = torch.arange(words.numel(), device=words.device) % 65521 + 1
        out[k] = [int(words.sum()), int((words * weight).sum())]
    return out


def _gaps(got: dict, want: dict, relative: bool) -> dict:
    """Per-leaf max|got - want| (over max|want| with ``relative``): the
    worst and the median over the leaves, and the worst leaf."""
    per = {}
    for k, w in want.items():
        gap = (got[k].float() - w.float()).abs().max().item()
        per[k] = gap / max(w.abs().max().item(), 1e-30) if relative else gap
    worst = max(per, key=per.get)
    return dict(worst=per[worst], median=float(statistics.median(per.values())),
                worst_leaf=worst)


def _hold_to_control(label, mesh: dict, control: dict, card: str) -> None:
    """ROADMAP C3's rule: each gap of the mesh to the one-card run within
    CONTROL_MARGIN x the one-card control's gap."""
    limits = {k: CONTROL_MARGIN * control[k] for k in mesh if k != "worst_leaf"}
    print(f"{label}: to the one-card run {json.dumps(mesh)}; the control's "
          f"{json.dumps(control)}; limits {json.dumps(limits)} ({card})")
    check(all(mesh[k] <= limits[k] for k in limits),
          f"{label}: further from the one-card run than {CONTROL_MARGIN} x its control")


@contextlib.contextmanager
def _train_in_blocks(n: int):
    """The one-card training forward with the arithmetic of an n-way model
    split and no collective: q/k/v (self and cross) and w1 as n column
    blocks, wo, wo_c and w2 as n partial products of their row blocks
    summed in f32 with the bias added once after, the logits as n
    vocabulary blocks (leg b's control)."""
    import torch
    import torch.nn.functional as F

    from ttasr_torch.models.whisper import model as mm

    saved = {k: getattr(mm, k) for k in ("_self_attn", "_decoder_attentions", "_mlp",
                                         "_unembed")}
    proj = mm._proj

    def cols(x, w, b=None):
        k = w.shape[-1] // n
        return torch.cat([proj(x, w[:, i * k:(i + 1) * k],
                               None if b is None else b[i * k:(i + 1) * k])
                          for i in range(n)], dim=-1)

    def rows(x, w, b):
        k = w.shape[0] // n
        total = None
        for i in range(n):
            part = torch.matmul(x[..., i * k:(i + 1) * k].float(), w[i * k:(i + 1) * k].float())
            total = part if total is None else total + part
        return (total + b.float()).to(x.dtype)

    def attention(hq, hkv, blk, sfx, heads, mask):
        q, k, v = (cols(hq, blk["wq" + sfx], blk["bq" + sfx]), cols(hkv, blk["wk" + sfx]),
                   cols(hkv, blk["wv" + sfx], blk["bv" + sfx]))
        out = mm._attention(mm._split_heads(q, heads), mm._split_heads(k, heads),
                            mm._split_heads(v, heads), mask)
        return rows(mm._merge_heads(out), blk["wo" + sfx], blk["bo" + sfx])

    def self_attn(x, blk, heads, mask=None, fused=False, t_real=None):
        return attention(x, x, blk, "", heads, mask)

    def decoder_attentions(x, blk, enc_out, heads, causal):
        x = x + attention(mm._ln(x, blk["ln1_s"], blk["ln1_b"]),
                          mm._ln(x, blk["ln1_s"], blk["ln1_b"]), blk, "", heads, causal)
        return x + attention(mm._ln(x, blk["lnc_s"], blk["lnc_b"]), enc_out, blk, "_c",
                             heads, None)

    def mlp(x, blk):
        return rows(F.gelu(cols(x, blk["w1"], blk["b1"])), blk["w2"], blk["b2"])

    def unembed(x, dec, cfg=None):
        e = dec["embed"]
        k = e.shape[0] // n
        return torch.cat([torch.matmul(x.float(), e[i * k:(i + 1) * k].float().t())
                          for i in range(n)], dim=-1)

    mm._self_attn, mm._decoder_attentions, mm._mlp, mm._unembed = (
        self_attn, decoder_attentions, mlp, unembed)
    try:
        yield
    finally:
        for k, fn in saved.items():
            setattr(mm, k, fn)


def _one_card_references(cfg, batch, card: str) -> dict:
    """The one-card runs the ranks are held to, in this process while they
    run: (a) MESH_TRAIN_STEPS f32 steps on the global batch, and its
    control, the batch as two halves, each loss over the global token count,
    the grads summed; (b) the bf16 step's loss and grads, and its control,
    the arithmetic of a 2-way model split (:func:`_train_in_blocks`)."""
    import torch

    from ttasr_torch.core.checkpoint import named_leaves
    from ttasr_torch.models.whisper.model import init_params
    from ttasr_torch.train.train_step import (
        batch_to,
        init_train_state,
        make_train_step,
        value_and_grad,
    )

    refs = {}
    for control in (False, True):
        opt = _mesh_optimizer()
        state = init_train_state(init_params(cfg, seed=MESH_TRAIN_SEED, device="cuda"), opt)
        step = make_train_step(cfg, opt, remat=True)
        count = (batch["labels"] != -100).sum().to(torch.float32)
        losses = []
        for _ in range(MESH_TRAIN_STEPS):
            if not control:
                state, loss = step(state, batch)
            else:
                half = len(MESH_TRAIN_CLIPS) // MESH_RANKS
                parts = [value_and_grad(state.params, cfg, batch_to(
                    {k: v[i * half:(i + 1) * half] for k, v in batch.items()}, "cuda"),
                    remat=True, token_count=count) for i in range(MESH_RANKS)]
                loss = parts[0][0] + parts[1][0]
                grads = {k: parts[0][1][k] + parts[1][1][k] for k in parts[0][1]}
                del parts
                opt.apply(grads, state.opt_state, state.params)
                del grads
                state.step += 1
            losses.append(float(loss))
        refs["a control" if control else "a"] = dict(
            losses=losses, params={k: v.detach() for k, v in named_leaves(state.params).items()})
        del state, step
    params = init_params(cfg, seed=MESH_TRAIN_SEED, device="cuda")
    loss, grads = value_and_grad(params, cfg, batch_to(batch, "cuda"), remat=True,
                                 compute_dtype=torch.bfloat16)
    refs["b"] = dict(loss=float(loss), grads=grads)
    with _train_in_blocks(MESH_RANKS):
        loss, grads = value_and_grad(params, cfg, batch_to(batch, "cuda"), remat=True,
                                     compute_dtype=torch.bfloat16)
    refs["b control"] = dict(loss=float(loss), grads=grads)
    del params
    torch.cuda.empty_cache()
    return refs


@contextlib.contextmanager
def mesh_train_ranks():
    """Phase 20's ranks, started: the corpus and leg a's batch written to a
    temporary directory, then MESH_RANKS processes of this script
    (``--train-rank``); those still running are killed on the way out.
    Yields {store, batch, procs, t0}.  The ranks need little of the card
    and no kernel but B11, so they run beside this process's phases 13,
    17 and 18."""
    import torch

    from ttasr_torch.text.tokenizer import build_byte_fallback_tokenizer

    with tempfile.TemporaryDirectory() as store:
        _train_corpus(os.path.join(store, "corpus"))
        batch = _mesh_train_batch(os.path.join(store, "corpus"),
                                  build_byte_fallback_tokenizer())
        torch.save({k: v.cpu() for k, v in batch.items()}, os.path.join(store, "batch.pt"))
        procs = []
        try:
            procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                                       "--train-rank", str(r), str(MESH_RANKS), store])
                     for r in range(MESH_RANKS)]
            yield dict(store=store, batch=batch, procs=procs, t0=time.perf_counter())
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()


def run_mesh_training(card: str, started=None) -> dict:
    """Phase 20: fine-tuning on a mesh, large-v3's width at
    MESH_TRAIN_LAYERS + MESH_TRAIN_LAYERS layers, on MESH_RANKS ``gloo``
    ranks of this card (processes of this script, ``--train-rank``):
    (a) mesh (2, 1), f32, ZeRO-1, remat, MESH_TRAIN_STEPS steps on a global
    batch of 4; (b) mesh (1, 2), bf16 compute, the first step's loss and
    grads; both held to one-card runs under ROADMAP C3's rule; (c) each
    rank's peak memory over leg a's first step with ZeRO-1 against the same
    step with replicated moments, the difference within ZERO1_PEAK_REL of
    half the moments' bytes ``memory_accounting`` reckons; (d) a
    ``Trainer`` at (2, 1): 2 steps, its checkpoint, greedy ``evaluate`` on
    two clips (B11 exactly MESH_TRAIN_LAYERS times a chunk on each rank),
    then that checkpoint resumed in this process, its state equal bit for
    bit to the ranks' gathered one.  ``started``: :func:`mesh_train_ranks`'
    ranks, started before phase 13 (None: started here)."""
    import torch

    from ttasr_torch.models.whisper.model import init_params
    from ttasr_torch.text.tokenizer import build_byte_fallback_tokenizer
    from ttasr_torch.tools.memory_accounting import account
    from ttasr_torch.train.trainer import Trainer

    if started is None:
        with mesh_train_ranks() as ranks:
            return run_mesh_training(card, ranks)
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    cfg = _mesh_train_config()
    tok = build_byte_fallback_tokenizer()
    store = started["store"]
    refs = _one_card_references(cfg, started["batch"], card)
    own = time.perf_counter() - t_phase
    codes = [p.wait(timeout=900) for p in started["procs"]]
    check(codes == [0] * MESH_RANKS, f"mesh training rank exit codes {codes}")
    rank_s = time.perf_counter() - started["t0"]
    ranks = []
    for r in range(MESH_RANKS):
        with open(os.path.join(store, f"rank{r}.json"), encoding="utf-8") as fh:
            ranks.append(json.load(fh))
    for key in ("a", "b", "c", "d"):
        check(all(rk[key]["same_on_every_rank"] == ranks[0][key]["same_on_every_rank"]
                  for rk in ranks), f"leg {key}: the ranks disagree")

    # (a) the losses and the final params against the one-card run
    a = ranks[0]["a"]
    got = torch.load(os.path.join(store, "a_params.pt"), map_location="cuda")
    ref, ctl = refs["a"], refs["a control"]

    def loss_gap(losses, want):
        return max(abs(x - y) for x, y in zip(losses, want))

    mesh_gaps = dict(loss=loss_gap(a["losses"], ref["losses"]),
                     **_gaps(got, ref["params"], relative=False))
    control_gaps = dict(loss=loss_gap(ctl["losses"], ref["losses"]),
                        **_gaps(ctl["params"], ref["params"], relative=False))
    print(f"leg a, mesh (2, 1) f32 ZeRO-1: losses {json.dumps(a['losses'])}, one card "
          f"{json.dumps(ref['losses'])}, control {json.dumps(ctl['losses'])}; ms per "
          f"step (rank 0) {json.dumps(a['ms'])} ({card})")
    _hold_to_control("leg a: params after 3 steps (max |gap| per leaf)", mesh_gaps,
                     control_gaps, card)
    del got, refs["a"], refs["a control"]

    # (b) the bf16 step's loss and grads at (1, 2)
    b = ranks[0]["b"]
    got = torch.load(os.path.join(store, "b_grads.pt"), map_location="cuda")
    mesh_gaps = dict(loss=abs(b["loss"] - refs["b"]["loss"]),
                     **_gaps(got, refs["b"]["grads"], relative=True))
    control_gaps = dict(loss=abs(refs["b control"]["loss"] - refs["b"]["loss"]),
                        **_gaps(refs["b control"]["grads"], refs["b"]["grads"],
                                relative=True))
    print(f"leg b, mesh (1, 2) bf16: loss {b['loss']!r}, one card {refs['b']['loss']!r}, "
          f"control {refs['b control']['loss']!r}; value_and_grad {b['ms']:.1f} ms "
          f"(rank 0) ({card})")
    _hold_to_control("leg b: the first step's grads (max |gap| / max |g| per leaf)",
                     mesh_gaps, control_gaps, card)
    del got, refs

    # (c) ZeRO-1's saving in peak memory
    reckoned = account("large-v3", data=MESH_RANKS, model_axis=1,
                       batch=len(MESH_TRAIN_CLIPS), layers=MESH_TRAIN_LAYERS)["per_chip_gb"]
    half_moments = reckoned["adamw_moments_if_replicated"] / 2
    full = account("large-v3", data=MESH_RANKS, model_axis=1,
                   batch=len(MESH_TRAIN_CLIPS))["per_chip_gb"]
    peaks = []
    for r, rk in enumerate(ranks):
        zero1, repl = rk["a"]["peak_gib"][0], rk["c"]["peak_gib"][0]
        peaks.append(dict(zero1=zero1, replicated=repl))
        print(f"leg c, rank {r}: peak of the first step {zero1:.3f} GiB with ZeRO-1 "
              f"({rk['a']['peak_gib'][-1]:.3f} after {MESH_TRAIN_STEPS}), {repl:.3f} GiB "
              f"with replicated moments: {repl - zero1:.3f} GiB saved, half the moments "
              f"reckoned {half_moments:.3f} GiB ({card})")
        check(abs((repl - zero1) - half_moments) <= ZERO1_PEAK_REL * half_moments,
              f"leg c, rank {r}: ZeRO-1 saved {repl - zero1:.3f} GiB, not within "
              f"{ZERO1_PEAK_REL} of {half_moments:.3f}")
    print(f"memory_accounting at {MESH_TRAIN_LAYERS} + {MESH_TRAIN_LAYERS} layers, (2, 1): "
          f"{json.dumps({k: round(v, 3) for k, v in reckoned.items()})}; at full depth: "
          f"{json.dumps({k: round(v, 3) for k, v in full.items()})} (GiB per card, of "
          f"the H100's 74.5 GiB)")

    # (d) the Trainer's checkpoint resumed in this process
    d = ranks[0]["d"]
    for r, rk in enumerate(ranks):
        print(f"leg d, rank {r}: {json.dumps(rk['d']['same_on_every_rank']['metrics'])}, "
              f"train {rk['d']['train_s']:.1f} s, evaluate {rk['d']['evaluate_s']:.1f} s, "
              f"B11 launches {rk['d']['b11']} ({card})")
    t0 = time.perf_counter()
    trainer = Trainer(init_params(cfg, seed=MESH_TRAIN_SEED + 2, device="cuda"), cfg, tok,
                      _mesh_trainer_config(os.path.join(store, "d")))
    check(trainer.maybe_resume() == 2, "leg d: checkpoint-2 did not resume")
    digest = _state_digest(trainer.state.state_dict())
    resume_s = time.perf_counter() - t0
    check(digest == d["same_on_every_rank"]["digest"],
          "leg d: the resumed state differs from the ranks' gathered state")
    print(f"leg d: checkpoint-2 of the (2, 1) Trainer resumed in one process in "
          f"{resume_s:.1f} s, its {len(digest)} tensors equal bit for bit to the ranks' "
          f"gathered state ({card})")
    del trainer
    torch.cuda.empty_cache()
    seconds = time.perf_counter() - t_phase
    print(f"phase 20 (fine-tuning on a mesh): {seconds:.1f} s, the one-card references "
          f"{own:.1f} s of it; the ranks {rank_s:.1f} s from their start "
          f"({json.dumps([rk['seconds'] for rk in ranks])} s of their own); peak memory per "
          f"rank {json.dumps(peaks)} GiB ({card})")
    return dict(seconds=seconds, rank_seconds=rank_s, peaks=peaks,
                ms_per_step=ranks[0]["a"]["ms"], half_moments_gib=half_moments)


def mesh_train_rank_main(rank: int, world: int, store: str) -> int:
    """One rank of :func:`run_mesh_training`: legs a-d on meshes (2, 1) and
    (1, 2) of ``world`` gloo ranks; writes ``rank<r>.json`` and, rank 0,
    leg a's final params (``a_params.pt``) and leg b's grads
    (``b_grads.pt``), each gathered whole."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, ROOT)
    from ttasr_torch import resolve_device
    from ttasr_torch.core.checkpoint import named_leaves
    from ttasr_torch.models.whisper.model import init_params
    from ttasr_torch.ops import _build
    from ttasr_torch.parallel.distributed import initialize_distributed
    from ttasr_torch.parallel.sharding import create_mesh, gather_leaf, shard_batch
    from ttasr_torch.text.tokenizer import build_byte_fallback_tokenizer
    from ttasr_torch.train.data import load_tsv_corpus
    from ttasr_torch.train.train_step import (
        batch_to,
        init_train_state,
        make_train_step,
        mesh_value_and_grad,
    )
    from ttasr_torch.train.trainer import Trainer

    t_rank = time.perf_counter()
    resolve_device("cuda")
    torch.set_num_threads(1)
    _build.load_library()
    initialize_distributed(f"file://{store}/pg", world_size=world, rank=rank, backend="gloo")
    out = {}
    try:
        data_mesh, model_mesh = create_mesh(world, 1), create_mesh(1, world)
        cfg = _mesh_train_config()
        batch = batch_to(torch.load(os.path.join(store, "batch.pt")), "cuda")
        counters = _every_counter()
        for fn in counters:
            fn.launches = 0
        # (a) ZeRO-1, then (c) its first step with replicated moments (the
        # peak comes in the first step: every tensor is live by its end)
        for leg, zero1, steps in (("a", True, MESH_TRAIN_STEPS), ("c", False, 1)):
            opt = _mesh_optimizer()
            state = init_train_state(init_params(cfg, seed=MESH_TRAIN_SEED, device="cuda"),
                                     opt, data_mesh, zero1=zero1)
            step = make_train_step(cfg, opt, mesh=data_mesh, remat=True)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            losses, ms, peaks = [], [], []
            for _ in range(steps):
                t0 = time.perf_counter()
                state, loss = step(state, batch)
                losses.append(float(loss))
                torch.cuda.synchronize()
                ms.append(round(1e3 * (time.perf_counter() - t0), 1))
                peaks.append(torch.cuda.max_memory_allocated() / 2 ** 30)
            out[leg] = dict(losses=losses, ms=ms, peak_gib=peaks,
                            same_on_every_rank=dict(losses=losses))
            if zero1:
                whole = named_leaves(state.whole_params())
                if rank == 0:
                    torch.save(whole, os.path.join(store, "a_params.pt"))
                del whole
            del state, step
            torch.cuda.empty_cache()
        # (b) the bf16 step's loss and grads on the (1, 2) model split
        state = init_train_state(init_params(cfg, seed=MESH_TRAIN_SEED, device="cuda"),
                                 _mesh_optimizer(), model_mesh)
        rows, _ = shard_batch(batch, model_mesh)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, grads = mesh_value_and_grad(state, cfg, rows, remat=True,
                                          compute_dtype=torch.bfloat16)
        torch.cuda.synchronize()
        b_ms = 1e3 * (time.perf_counter() - t0)
        whole = {k: gather_leaf(g, state.layout.params[k], model_mesh) for k, g in grads.items()}
        if rank == 0:
            torch.save(whole, os.path.join(store, "b_grads.pt"))
        out["b"] = dict(loss=float(loss), ms=b_ms, same_on_every_rank=dict(loss=float(loss)))
        del state, grads, whole
        torch.cuda.empty_cache()
        _expect(f"rank {rank}: legs a-c (training runs no kernel)",
                {fn.__name__: fn.launches for fn in counters}, {})
        # (d) the Trainer at (2, 1): 2 steps, the checkpoint, evaluate
        tok = build_byte_fallback_tokenizer()
        corpus = os.path.join(store, "corpus")
        trainer = Trainer(init_params(cfg, seed=MESH_TRAIN_SEED + 1, device="cuda"), cfg, tok,
                          _mesh_trainer_config(os.path.join(store, "d")), mesh=data_mesh)
        t0 = time.perf_counter()
        trainer.train(load_tsv_corpus(corpus, "synth", "train"))
        train_s = time.perf_counter() - t0
        examples = load_tsv_corpus(corpus, "synth", "test")
        chunks = -(-len(examples) // EVAL_BATCH)
        for fn in counters:
            fn.launches = 0
        t0 = time.perf_counter()
        metrics = trainer.evaluate(examples)
        torch.cuda.synchronize()
        evaluate_s = time.perf_counter() - t0
        counts = {fn.__name__: fn.launches for fn in counters}
        _expect(f"rank {rank}: Trainer.evaluate", counts,
                {"encoder_attention_merged": MESH_TRAIN_LAYERS * chunks})
        digest = _state_digest(trainer.state.state_dict())
        out["d"] = dict(train_s=train_s, evaluate_s=evaluate_s,
                        b11=counts["encoder_attention_merged"],
                        same_on_every_rank=dict(metrics=metrics, digest=digest))
        out["seconds"] = round(time.perf_counter() - t_rank, 1)
        with open(os.path.join(store, f"rank{rank}.json"), "w", encoding="utf-8") as fh:
            json.dump(out, fh)
    finally:
        dist.destroy_process_group()
    return 0


KERNELS = [  # wrapper name, source, the TPU kernel it replaces
    ("encoder_attention_merged", "ttasr_torch/csrc/encoder_attention.cu",
     "ttasr/ops/encoder_attention_pallas.py:156"),
    ("qkv_int8_fused", "ttasr_torch/csrc/decoder_blocks.cu",
     "ttasr/ops/decoder_blocks_pallas.py:50"),
    ("self_attn_step_indirect_int8", "ttasr_torch/csrc/self_attention.cu",
     "ttasr/ops/self_attention_pallas.py:290"),
    ("attnout_ln_q_cross_int8", "ttasr_torch/csrc/decoder_blocks.cu",
     "ttasr/ops/decoder_blocks_pallas.py:180"),
    ("mlp_with_crossout_int8", "ttasr_torch/csrc/decoder_mlp.cu",
     "ttasr/ops/decoder_mlp_pallas.py:153"),
    ("self_attn_step_int8", "ttasr_torch/csrc/self_attention.cu",
     "ttasr/ops/self_attention_pallas.py:47"),
    ("ln_quant", "ttasr_torch/csrc/encoder_fused.cu",
     "ttasr/ops/encoder_fused_pallas.py:113"),
    ("encoder_attention_merged_qkv", "ttasr_torch/csrc/encoder_attention.cu",
     "ttasr/ops/encoder_attention_pallas.py:90"),
    ("quant_only", "ttasr_torch/csrc/encoder_fused.cu",
     "ttasr/ops/encoder_fused_pallas.py:204"),
    ("add_ln_quant", "ttasr_torch/csrc/encoder_fused.cu",
     "ttasr/ops/encoder_fused_pallas.py:141"),
    ("gelu_quant", "ttasr_torch/csrc/encoder_fused.cu",
     "ttasr/ops/encoder_fused_pallas.py:177"),
    ("gelu_quant_acc", "ttasr_torch/csrc/encoder_fused.cu",
     "ttasr/ops/encoder_fused_pallas.py:177"),
    ("ln_quant_acc", "ttasr_torch/csrc/encoder_fused.cu",
     "ttasr/ops/encoder_fused_pallas.py:113"),
    ("add_ln_quant_acc", "ttasr_torch/csrc/encoder_fused.cu",
     "ttasr/ops/encoder_fused_pallas.py:141"),
    # the XLA dot's epilogue in the JAX package, not a Pallas kernel
    ("qkv_epilogue_acc", "ttasr_torch/csrc/encoder_fused.cu",
     "ttasr/ops/quant.py:168"),
    ("attnout_ln_q_fused", "ttasr_torch/csrc/decoder_blocks.cu",
     "ttasr/ops/decoder_blocks_pallas.py:75"),
    ("cross_attention_int8", "ttasr_torch/csrc/cross_attention.cu",
     "ttasr/ops/cross_attention_pallas.py:47"),
    ("gather_cache_rows", "ttasr_torch/csrc/beam_gather.cu",
     "ttasr/ops/beam_gather_pallas.py:23"),
    ("matmul_int8_partial", "ttasr_torch/csrc/decoder_blocks.cu",
     "ttasr/ops/decoder_blocks_pallas.py:292"),
    ("ln_q_cross_int8", "ttasr_torch/csrc/decoder_blocks.cu",
     "ttasr/ops/decoder_blocks_pallas.py:322"),
    ("mlp_int8_fused", "ttasr_torch/csrc/decoder_mlp.cu",
     "ttasr/ops/decoder_mlp_pallas.py:65"),
    ("log_mel_spectrogram_fused", "ttasr_torch/csrc/mel.cu",
     "ttasr/ops/mel_pallas.py:114"),
    ("encoder_self_attention", "ttasr_torch/csrc/encoder_attention.cu",
     "ttasr/ops/encoder_attention_pallas.py:23"),
    # B7 and B9 on a rank's columns of rows the model axis splits (the
    # encoder on a mesh): the absmax pass and the codes pass of each
    ("quant_only_absmax", "ttasr_torch/csrc/encoder_fused.cu",
     "ttasr/ops/encoder_fused_pallas.py:204"),
    ("quant_only_scaled", "ttasr_torch/csrc/encoder_fused.cu",
     "ttasr/ops/encoder_fused_pallas.py:204"),
    ("gelu_quant_acc_absmax", "ttasr_torch/csrc/encoder_fused.cu",
     "ttasr/ops/encoder_fused_pallas.py:177"),
    ("gelu_quant_scaled", "ttasr_torch/csrc/encoder_fused.cu",
     "ttasr/ops/encoder_fused_pallas.py:177"),
]
# the split entries' launches: rank 0 of phase 19's int8 mesh leg
SPLIT_ENTRIES = ("quant_only_absmax", "quant_only_scaled", "gelu_quant_acc_absmax",
                 "gelu_quant_scaled")
# the branch leg whose run gives each new kernel's launches
BRANCH_LAUNCHES = {
    "attnout_ln_q_fused": "bf16 cross-KV (B12)",
    "cross_attention_int8": "unfused int8 graph beam 5 (B13, 5-D cache)",
    "gather_cache_rows": "beam_indirect=False (B17, B10)",
}
# the tensor-parallel leg whose run gives B14-B16's launches
TP_LEG = "TP v2 one rank beam 5 (B15, B16, B14)"


def main() -> int:
    try:
        sys.stdout.reconfigure(encoding="utf-8")
    except AttributeError:
        pass
    import torch

    check(torch.cuda.is_available(), "CUDA is not available")
    check(os.path.isdir(os.path.join(ROOT, "ttasr_torch")),
          "ttasr_torch/ not found next to chip_smoke.py: run from a checkout")
    sys.path.insert(0, ROOT)
    card = card_line()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} device(s)")

    from ttasr_torch import resolve_device
    from ttasr_torch.ops import _build

    resolve_device("cuda")  # TF32 off: float32 means float32
    t0 = time.perf_counter()
    _build.load_library()
    print(f"kernels built and loaded in {time.perf_counter() - t0:.1f} s")
    print(f"time_ms floor (one 1-element add per CUDA graph replay): "
          f"{time_ms_floor():.4f} ms; a kernel time near it is the host's graph "
          f"launch rate, not the kernel's ({card})")

    measured = {"encoder_attention_merged": check_encoder_attention(card)}
    measured.update(check_decode_kernels(card))
    measured.update(check_encoder_kernels(card))
    f32_rows = check_f32_rows(card)
    measured.update(check_branch_kernels(card))
    measured.update(check_tp_kernels(card))
    standalone, standalone_launches = check_standalone_kernels(card)
    measured.update(standalone)
    gemm = measured.pop("int8_gemm")
    b6_windows = measured.pop("b6_windows")
    bf16 = run_bf16_path(card)
    main_path = run_int8_path(card, act8=True)
    # phase 20's ranks train beside phases 13, 17 and 18 (8.2 GiB a rank at
    # most, beside phase 17's 37 GiB)
    with mesh_train_ranks() as ranks:
        int8_bf16_encoder = run_int8_path(card, act8=False)
        training = run_training(card)
        recognition = run_recognition(card)
        mesh_training = run_mesh_training(card, ranks)
    launches = dict(main_path["counts"], encoder_attention_merged=bf16["launches"])
    for name, leg in BRANCH_LAUNCHES.items():
        launches[name] = main_path["branches"][leg]["counts"][name]
    for name in ("matmul_int8_partial", "ln_q_cross_int8", "mlp_int8_fused"):
        launches[name] = main_path["tp"][TP_LEG]["counts"][name]
    launches.update(standalone_launches)  # phase 8's run: no engine path calls them
    mesh_encoder = main_path["sharded"]["encoders"]["int8"]
    for name in SPLIT_ENTRIES:
        launches[name] = mesh_encoder["counts"][name]
    # B8's and B9's bf16 entries left the main path: their launches are one
    # encoder pass's of the parent route and of the route of the bf16
    # entries (compare_encoder_routes)
    route_counts = main_path["routes"]["counts"]
    for name, route in (("add_ln_quant", "parent"), ("gelu_quant", "bf16 entries")):
        launches[name] = route_counts[route][name]
        print(f"{name} (bf16 entry): {main_path['counts'][name]} launches on the main "
              f"path; {launches[name]} in one pass of the {route} route")
    print(f"B11 launches: bf16 path {bf16['launches']}, int8 main path "
          f"{main_path['counts']['encoder_attention_merged']}, encoder_act_int8=False "
          f"path {int8_bf16_encoder['counts']['encoder_attention_merged']}")
    print("encoder per window: " + json.dumps({
        "bf16": bf16["encoder_ms"], "int8_act8": main_path["encoder_ms"],
        "int8_bf16_encoder": int8_bf16_encoder["encoder_ms"]}) + f" ({card})")
    print("int8 GEMM: " + json.dumps(gemm))
    print(f"B6 at {MEL_WINDOWS} windows: " + json.dumps(b6_windows))
    b11 = measured["encoder_attention_merged"]
    print("float32 attention (3xTF32; bound_ms at the f32-accurate tensor-core rate, "
          "tf32_peak_ms and f32_peak_ms at those peaks; leg b at B = EVAL_BATCH): " + json.dumps({
              "B11 phase 3": b11.pop("b11_f32"), "B6 phase 3": b11.pop("b6_f32"),
              "B11 leg b": training["evaluate"]["b11_f32"],
              "evaluate wall s": training["evaluate"]["wall"],
              "evaluate wall s, SIMT kernel": EVAL_WALL_SIMT_S}) + f" ({card})")

    print("row kernels on float32 rows (C9; ms, plain_ms, bound_ms): " + json.dumps(
        {k: [round(v[m], 4) for m in ("ms", "plain_ms", "bound_ms")]
         for k, v in f32_rows.items()}) + f" ({card})")
    sharded = main_path["sharded"]
    print(f"B13 on a (1, 4) shard's 5 heads, beam 5: {sharded['b13_odd_heads']['ms']:.4f} ms "
          f"(plain {sharded['b13_odd_heads']['plain_ms']:.4f}, bound "
          f"{sharded['b13_odd_heads']['bound_ms']:.4f}); phase 19 "
          f"{sharded['seconds']:.1f} s ({card})")
    print("split entries at 1/n of the row beside the whole-row entry, ms in turns: "
          + json.dumps(measured.pop("split_turns")) + f" ({card})")
    print("mesh legs' encoders: " + json.dumps(
        {k: dict(ms=v["ms"], params=v["memory"]["param_bytes"],
                 reckoned=v["memory"]["reckoned"], allocated=v["memory"]["allocated"],
                 construction_peak=v["memory"]["construction_peak"],
                 **{g: v[g] for g in ("gap", "limit") if g in v})
         for k, v in sharded["encoders"].items()}) + f" ({card})")
    print(f"phase 20 (fine-tuning on a mesh): {mesh_training['seconds']:.1f} s, leg a "
          f"ms per step {json.dumps(mesh_training['ms_per_step'])}, peak GiB per rank "
          f"{json.dumps(mesh_training['peaks'])} ({card})")
    print(json.dumps({"kernels": [dict(
        name=name, route="cuda", source=source, replaces=replaces,
        launches=launches[name],
        **{k: measured[name][k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                          "bound_by", "library_ms")})
        for name, source, replaces in KERNELS]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        if sys.argv[1:2] == ["--tp-rank"]:  # a rank of run_two_ranks
            sys.exit(tp_rank_main(int(sys.argv[2]), sys.argv[3]))
        if sys.argv[1:2] == ["--sharded-rank"]:  # a rank of run_sharded_paths
            sys.exit(sharded_rank_main(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
                                       sys.argv[5]))
        if sys.argv[1:2] == ["--train-rank"]:  # a rank of run_mesh_training
            sys.exit(mesh_train_rank_main(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]))
        sys.exit(main())
    except SmokeFailure as exc:
        print(f"chip_smoke FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
