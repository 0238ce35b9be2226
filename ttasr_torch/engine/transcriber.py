"""Batch transcription engine (port of ``ttasr/engine/transcriber.py``).

``WhisperEngine`` keeps the reference's public surface and host logic
unchanged: the Whisper 30 s seek loop with timestamp-token parsing, the
temperature fallback ladder with its quality gates,
``condition_on_previous_text`` prompt carry with reset-on-high-temperature,
and VAD chunk collection and timestamp restoration (the VAD, audio I/O and
tokenizer are the port's copies of the ``ttasr.audio`` and ``ttasr.text``
modules).  Only the device calls differ: mel + encoder and the decodes run
eagerly in PyTorch on an explicit device, and each decode draws its random
numbers from a ``torch.Generator`` seeded with the engine's decode counter.

``compute_type="int8"`` quantizes the weights on the device
(``quantize_params`` + ``fuse_qkv``, the encoder's codes laid out K-major
for the int8 GEMM) and runs the reference's defaults: the s8 x s8 encoder
with the fused producer + quantize kernels (``encoder_act_int8=True``,
``encoder_fused_quant=True``), then the fused int8 decode kernels with int8
self-KV, int4 lane-packed self-KV, int4 cross-KV and beam search through
the ancestry map.  ``encoder_act_int8=False`` runs the encoder in bf16 on
the int8 weights; ``encoder_fused_quant=False`` keeps the s8 x s8 GEMMs
with plain quantize chains.  ``transcribe(..., beam_size=10)`` (more than
8 beams) takes the fused path's B12 branch, and ``kv_cache_int8=True`` on
a float engine the 5-D int8 self-KV of the unfused graph
(:mod:`ttasr_torch.models.whisper.decode`).

``mesh=`` (a :func:`ttasr_torch.parallel.sharding.create_mesh` mesh, one
engine per rank) follows the reference's rule and placement
(``ttasr/engine/transcriber.py:208-238``).  ``compute_type="int8"``
quantizes without fusing q/k/v, as the reference does under a mesh.  Where
``tp_eligible`` holds the decodes go to a
:class:`ttasr_torch.parallel.tp.TPDecoder` (the fused int8 kernels, heads
split over the model axis, the batch over the data axis), built from the
whole params first; then the engine keeps only ``shard_params``' slices of
the whole tree, as the reference does, and on every other mesh, for
float32, bfloat16 and int8 alike, a
:class:`ttasr_torch.parallel.gspmd.ShardedDecoder` decodes on those slices
(the unfused graph, the reference's GSPMD path).  The encoder, the language
detection and the word alignment run on the slices too, with the model axis
bound: the encoder on the rank's heads and hidden slice (the s8 x s8
encoder's split-scale row kernels, its output the one-card encoder's bit
for bit), every data rank on the whole batch, as the reference's jit
leaves it.

The continuous-batching path is the reference's too:
:meth:`WhisperEngine.transcribe_with_server` runs the same seek loop with
each window's fallback ladder routed through a
:class:`ttasr_torch.engine.serving.BatchServer`
(:meth:`WhisperEngine._decode_with_fallback_server`, best_of candidates as
separate window requests), and the host VAD of the served paths runs in one
serial executor whose pending count the server's coalescing wait reads
(:func:`run_vad_async`, :func:`vad_pending`).  Decodes may run from
several threads (a server's decode threads, other servers, direct calls),
so ``decode_stats`` is updated under a lock.

``word_timestamps=True`` aligns each window's text on all three routes
(``transcribe``, ``transcribe_with_server`` and the batched pipeline) with
:mod:`ttasr_torch.models.whisper.align`, on the window's encoder row and
``self.params`` (under a mesh the slices, each rank's cross-attention
heads gathered over the model axis).  As in the reference, word times stay
on the VAD-collected timeline when ``vad_filter`` maps the segments' times
back (ROADMAP C7).
"""

from __future__ import annotations

import asyncio
import contextlib
import dataclasses
import logging
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ttasr_torch import resolve_device
from ttasr_torch.audio.io import load_audio
from ttasr_torch.audio.vad import (
    SpeechTimestampsMap,
    VadOptions,
    collect_chunks,
    get_speech_timestamps,
)
from ttasr_torch.engine.results import Segment, TranscriptionInfo, Word
from ttasr_torch.models.whisper.align import (
    alignment_heads_qk,
    merge_tokens_to_words,
    token_timings,
)
from ttasr_torch.models.whisper.config import WhisperConfig
from ttasr_torch.models.whisper.decode import (
    SAMPLE_LEN,
    DecodingOptions,
    TokenizerInfo,
    _logits_at,
    _prefill,
    beam_decode,
    build_prompt,
    compression_ratio,
    greedy_decode,
    pad_prompts,
)
from ttasr_torch.models.whisper.load import load_whisper
from ttasr_torch.models.whisper.model import encode, init_cache
from ttasr_torch.ops.mel import (
    HOP_LENGTH,
    N_FRAMES,
    N_SAMPLES,
    SAMPLE_RATE,
    log_mel_spectrogram,
)
from ttasr_torch.ops.quant import fuse_qkv, kmajor_encoder_codes, quantize_params
from ttasr_torch.parallel.gspmd import ShardedDecoder
from ttasr_torch.parallel.sharding import bind_axes, shard_params
from ttasr_torch.parallel.tp import TPDecoder, tp_eligible
from ttasr_torch.text.tokenizer import WhisperTokenizer, load_tokenizer

logger = logging.getLogger("ttasr_torch.engine")

TIME_PRECISION = 0.02

# Host VAD of the served paths runs off the event loop in one dedicated
# single-worker executor: off the loop so concurrent files' VADs never
# block the server's submit path, single-worker so they finish FIFO and
# the first file's windows reach the decode slots first.  The pending
# count tells the BatchServer that more windows are on their way, so it
# holds a partly filled bulk sweep for them.
_VAD_POOL = None
_VAD_PENDING = 0
_VAD_LOCK = threading.Lock()


def _vad_pool() -> ThreadPoolExecutor:
    global _VAD_POOL
    with _VAD_LOCK:
        if _VAD_POOL is None:
            _VAD_POOL = ThreadPoolExecutor(max_workers=1,
                                           thread_name_prefix="ttasr-vad")
    return _VAD_POOL


def vad_pending() -> int:
    """Host VADs queued or running (see BatchServer's coalescing wait)."""
    return _VAD_PENDING


async def run_vad_async(audio_f32: np.ndarray, vad_opts) -> List[dict]:
    """``get_speech_timestamps`` in the serial VAD executor, with the
    pending count kept for the server's bulk-coalescing wait."""
    global _VAD_PENDING
    pool = _vad_pool()
    with _VAD_LOCK:
        _VAD_PENDING += 1
    try:
        return await asyncio.get_running_loop().run_in_executor(
            pool, get_speech_timestamps, audio_f32, vad_opts)
    finally:
        with _VAD_LOCK:
            _VAD_PENDING -= 1

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.bfloat16, "int8": torch.bfloat16}


@dataclasses.dataclass
class TranscribeOptions:
    """Per-call knobs, defaults matching faster-whisper/reference usage."""

    language: Optional[str] = "zh"
    task: str = "transcribe"
    beam_size: int = 5
    best_of: int = 5
    patience: float = 1.0
    length_penalty: float = 1.0
    temperatures: Sequence[float] = (0.0, 0.2, 0.4, 0.6, 0.8, 1.0)
    compression_ratio_threshold: Optional[float] = 2.4
    log_prob_threshold: Optional[float] = -1.0
    no_speech_threshold: Optional[float] = 0.6
    condition_on_previous_text: bool = True
    prompt_reset_on_temperature: float = 0.5
    initial_prompt: Optional[str] = None
    prefix: Optional[str] = None
    without_timestamps: bool = False
    max_initial_timestamp: float = 1.0
    word_timestamps: bool = False
    vad_filter: bool = True
    vad_parameters: Optional[VadOptions] = None
    max_new_tokens: int = SAMPLE_LEN
    kv_cache_int8: Optional[bool] = None  # None -> engine default


def _host_f32(audio: np.ndarray) -> np.ndarray:
    """float32 [-1, 1] view for host-side analysis (VAD)."""
    if audio.dtype == np.int16:
        return audio.astype(np.float32) / 32768.0
    return audio


def _as_master(audio) -> np.ndarray:
    """int16 passes through (the device converts), anything else becomes
    mono float32."""
    a = np.asarray(audio)
    if a.ndim > 1:
        a = np.asarray(a, dtype=np.float32).mean(axis=0)
    if a.dtype != np.int16:
        a = np.asarray(a, dtype=np.float32)
    return a


def _restore_times(segments: List[Segment], speech_chunks) -> List[Segment]:
    """Map the segments' times in the VAD-collected audio back to the
    original audio (no-op without VAD)."""
    if speech_chunks is not None and segments:
        ts_map = SpeechTimestampsMap(speech_chunks, SAMPLE_RATE)
        for seg in segments:
            seg.start = ts_map.get_original_time(seg.start)
            seg.end = ts_map.get_original_time(seg.end)
    return segments


class _AlignRequest(NamedTuple):
    """What the seek loop yields when a window's words are due: the
    arguments of :meth:`WhisperEngine._align_window_words`.  Its driver
    sends the words back, so an async driver runs the alignment off its
    event loop."""

    text_tokens: List[int]
    enc_out: Any
    time_offset: float


def _words_in(window_words: Optional[List[Word]], s_start: float,
              s_end: float) -> Optional[List[Word]]:
    """The window's words whose midpoint falls in the segment (the
    reference's rule); None without word timestamps."""
    if window_words is None:
        return None
    return [w for w in window_words
            if s_start - 0.01 <= (w.start + w.end) / 2 <= s_end + 0.5]


def _parse_transcribe_kwargs(kwargs: dict) -> TranscribeOptions:
    """faster-whisper-style kwargs -> TranscribeOptions (alias mapping,
    unknown-field tolerance, scalar-temperature normalization)."""
    known = {f.name for f in dataclasses.fields(TranscribeOptions)}
    fw_aliases = {"temperature": "temperatures"}
    clean_kwargs = {}
    for k, v in kwargs.items():
        k = fw_aliases.get(k, k)
        if k in known:
            clean_kwargs[k] = v
    opts = TranscribeOptions(**clean_kwargs)
    if isinstance(opts.temperatures, (int, float)):
        opts = dataclasses.replace(
            opts, temperatures=(float(opts.temperatures),))
    return opts


class WhisperEngine:
    """PyTorch Whisper inference engine with a faster-whisper-compatible
    API, on an explicit device (default ``"cuda"``; raises when absent).

    The keyword arguments after ``device`` are the reference's: the
    tensor-parallel mesh, the int4 sub-modes of the int8 caches (default
    on), and the s8 x s8 encoder switches (default on; they act only on
    quantized weights)."""

    def __init__(self, model_path_or_name: str = "tiny", *,
                 compute_type: str = "float32",
                 tokenizer: Optional[WhisperTokenizer] = None,
                 params: Optional[Any] = None,
                 config: Optional[WhisperConfig] = None,
                 device="cuda",
                 mesh: Optional[Any] = None,
                 cross_kv_int4: bool = True,
                 kv_int4: bool = True,
                 encoder_act_int8: bool = True,
                 encoder_fused_quant: bool = True):
        if compute_type not in _DTYPES:
            raise ValueError(f"unknown compute_type {compute_type!r}")
        self.compute_type = compute_type
        self.device = resolve_device(device)
        self.model_size = model_path_or_name
        self.mesh = mesh
        if params is not None and config is not None:
            self.params, self.cfg = params, config
        else:
            self.params, self.cfg = load_whisper(
                model_path_or_name, dtype=_DTYPES[compute_type],
                device=self.device)
        # int8: quantized weights, int8 self-KV with the int4 sub-modes
        self.kv_cache_int8 = compute_type == "int8"
        self.cross_kv_int4 = cross_kv_int4 and self.kv_cache_int8
        self.kv_int4 = kv_int4 and self.kv_cache_int8
        self._tp = self._sharded = None
        if compute_type == "int8":
            self.params = quantize_params(self.params)
            if mesh is None:
                self.params = fuse_qkv(self.params)
        if mesh is not None:
            # the reference's order: the fused TP decode (where it applies)
            # from the whole params, then only shard_params' slices stay;
            # the GSPMD decode (where TP does not apply), the language
            # detection and the word alignment read the decoder's slices
            # through one view
            if tp_eligible(self.params, self.cfg, mesh):
                self._tp = TPDecoder(self.params, self.cfg, mesh)
            self.params = shard_params(self.params, mesh)
            self._sharded = ShardedDecoder(self.params, self.cfg, mesh)
        if compute_type == "int8":
            # after the slicing: a row slice of K-major codes is not K-major
            self.params = kmajor_encoder_codes(self.params)
        # s8 x s8 encoder: None = the encoder's auto rule (on for quantized
        # weights), False forces it off; likewise its fused quantize kernels
        self._act8 = None if encoder_act_int8 else False
        self._fused_quant = None if encoder_fused_quant else False
        self.tokenizer = tokenizer or load_tokenizer(
            model_path_or_name if isinstance(model_path_or_name, str) else None)
        self.ti = TokenizerInfo.from_tokenizer(
            self.tokenizer, n_vocab=self.cfg.vocab_size)
        self._rng_counter = 0
        # what the decodes did: counts, steps, and any non-finite logits
        # (decodes may run from several threads: updated under the lock)
        self._stats_lock = threading.Lock()
        # one caller's device work at a time, for every server and direct
        # caller of this engine: two threads running the eager decode loop
        # at once hand the GIL back and forth at every op (~2.5x a step on
        # an H100 host, PERF.md), and B4/B14's counters are one buffer per
        # device.  Re-entrant: a BatchServer holds it around a whole group.
        self._device_lock = threading.RLock()
        self.decode_stats = {"beam_decodes": 0, "greedy_decodes": 0,
                             "beam_steps": 0, "greedy_steps": 0,
                             "nonfinite_logits": 0, "encoder_passes": 0}

    @torch.inference_mode()
    def encode_windows(self, audio: np.ndarray, *,
                       window_samples: Optional[int] = None):
        """(B, <=window) or (<=window,) audio -> encoder states on the
        device.  Pads host-side to ``window_samples`` (default the 30 s
        window); int16 is uploaded as-is and converted on the device."""
        w = N_SAMPLES if window_samples is None else int(window_samples)
        a = np.asarray(audio)
        if a.dtype != np.int16:
            a = a.astype(np.float32, copy=False)
        squeeze = a.ndim == 1
        if squeeze:
            a = a[None]
        if a.shape[-1] < w:
            a = np.pad(a, ((0, 0), (0, w - a.shape[-1])))
        elif a.shape[-1] > w:
            a = a[..., :w]
        with self._device_lock, self._model_axis():
            mel = log_mel_spectrogram(a, n_mels=self.cfg.num_mel_bins,
                                      pad_to_chunk=False, device=self.device)
            out = encode(self.params, self.cfg, mel, act_int8=self._act8,
                         fused_quant=self._fused_quant)
        with self._stats_lock:
            self.decode_stats["encoder_passes"] += 1
        return out[0] if squeeze else out

    def _model_axis(self):
        """The mesh's model axis bound for the block (a pass over the
        slices sums and gathers over it); nothing off a mesh."""
        if self.mesh is None:
            return contextlib.nullcontext()
        return bind_axes({"model": self.mesh.groups["model"]})

    @contextlib.contextmanager
    def _decoder_slices(self):
        """(params, model group) of a teacher-forced decoder pass, with the
        axis bound: the whole params and None off a mesh, else the
        decoder's slices (attention columns gathered where the axis cuts a
        head, as the GSPMD decode reads them)."""
        if self.mesh is None:
            yield self.params, None
            return
        with self._model_axis():
            yield self._sharded._decode_params(), self.mesh.groups["model"]

    # -- low-level window decode ------------------------------------------

    def _record(self, kind: str, out: dict) -> None:
        with self._stats_lock:
            self.decode_stats[f"{kind}_decodes"] += 1
            self.decode_stats[f"{kind}_steps"] += out["steps"]
            self.decode_stats["nonfinite_logits"] += int(not out["logits_finite"])

    @torch.inference_mode()
    def run_beam_decode(self, enc_out, prompt, pad, rng, opts: DecodingOptions):
        """A beam decode: through the mesh's decoder (tensor-parallel or
        GSPMD) under a mesh, else the single-card program."""
        mesh_decoder = self._tp or self._sharded
        with self._device_lock:
            if mesh_decoder is not None:
                out = mesh_decoder.beam(enc_out, prompt, pad, rng, opts=opts, ti=self.ti)
            else:
                out = beam_decode(self.params, self.cfg, enc_out, prompt, pad, rng,
                                  opts=opts, ti=self.ti)
        self._record("beam", out)
        return out

    @torch.inference_mode()
    def run_greedy_decode(self, enc_out, prompt, pad, rng, temperature,
                          opts: DecodingOptions):
        """Greedy/sampled counterpart of :meth:`run_beam_decode`."""
        mesh_decoder = self._tp or self._sharded
        with self._device_lock:
            if mesh_decoder is not None:
                out = mesh_decoder.greedy(enc_out, prompt, pad, rng, temperature,
                                          opts=opts, ti=self.ti)
            else:
                out = greedy_decode(self.params, self.cfg, enc_out, prompt, pad,
                                    rng, temperature, opts=opts, ti=self.ti)
        self._record("greedy", out)
        return out

    def _decoding_options(self, opts: TranscribeOptions) -> DecodingOptions:
        """The window decode's options, the int8 caches' int4 sub-modes
        included: one builder for the seek loop and the server path, so
        both decode with the same program."""
        kv_int8 = opts.kv_cache_int8
        if kv_int8 is None:
            kv_int8 = self.kv_cache_int8
        return DecodingOptions(
            beam_size=opts.beam_size,
            length_penalty=opts.length_penalty,
            patience=opts.patience,
            without_timestamps=opts.without_timestamps,
            max_initial_timestamp=opts.max_initial_timestamp,
            sample_len=min(opts.max_new_tokens, SAMPLE_LEN),
            kv_int8=kv_int8,
            cross_kv_int8=kv_int8 and self.compute_type == "int8",
            cross_kv_int4=self.cross_kv_int4 and kv_int8,
            kv_int4=self.kv_int4 and kv_int8,
        )

    def _decode_window(self, enc_out, prompt_ids: List[int],
                       opts: TranscribeOptions, temperature: float):
        self._rng_counter += 1
        rng = torch.Generator(device=self.device).manual_seed(self._rng_counter)
        prompt, pad = pad_prompts([prompt_ids], self.ti.eot)
        dec_opts = self._decoding_options(opts)
        if temperature == 0.0 and opts.beam_size > 1:
            out = self.run_beam_decode(enc_out, prompt, pad, rng, opts=dec_opts)
            pick = 0
        elif temperature > 0.0 and opts.best_of > 1:
            # best_of candidates ride the batch axis of one decode, then
            # MaximumLikelihoodRanker picks the winner on the host
            k = opts.best_of
            enc_rep = enc_out.expand((k,) + tuple(enc_out.shape[1:]))
            prompt_k = np.repeat(np.asarray(prompt), k, axis=0)
            pad_k = np.repeat(np.asarray(pad), k, axis=0)
            out = self.run_greedy_decode(enc_rep, prompt_k, pad_k, rng,
                                         temperature, opts=dec_opts)
            lengths = out["lengths"].cpu().numpy()
            sums = out["sum_logprob"].cpu().numpy()
            penalties = ((5.0 + lengths + 1.0) / 6.0) ** opts.length_penalty
            pick = int(np.argmax(sums / np.maximum(penalties, 1e-9)))
        else:
            out = self.run_greedy_decode(enc_out, prompt, pad, rng,
                                         temperature, opts=dec_opts)
            pick = 0
        n = int(out["lengths"][pick])
        tokens = [int(t) for t in out["tokens"][pick, :n].cpu().numpy()]
        sum_logprob = float(out["sum_logprob"][pick])
        avg_logprob = sum_logprob / (n + 1) if n >= 0 else 0.0
        no_speech_prob = float(out["no_speech_prob"][pick])
        return tokens, avg_logprob, no_speech_prob

    @staticmethod
    def _needs_fallback(ratio: float, avg_logprob: float,
                        no_speech_prob: float,
                        opts: TranscribeOptions) -> bool:
        """Quality gates of faster-whisper generate_with_fallback."""
        needs_fallback = False
        if (opts.compression_ratio_threshold is not None
                and ratio > opts.compression_ratio_threshold):
            needs_fallback = True
        if (opts.log_prob_threshold is not None
                and avg_logprob < opts.log_prob_threshold):
            needs_fallback = True
        if (opts.no_speech_threshold is not None
                and no_speech_prob > opts.no_speech_threshold
                and opts.log_prob_threshold is not None
                and avg_logprob < opts.log_prob_threshold):
            needs_fallback = False  # silence: don't ladder up
        return needs_fallback

    def _decode_with_fallback(self, enc_out, prompt_ids, opts: TranscribeOptions):
        """Temperature ladder (faster-whisper generate_with_fallback)."""
        last = None
        for temperature in opts.temperatures:
            tokens, avg_logprob, no_speech_prob = self._decode_window(
                enc_out, prompt_ids, opts, temperature)
            text = self.tokenizer.decode(tokens)
            ratio = compression_ratio(text)
            last = (tokens, avg_logprob, no_speech_prob, ratio, temperature)
            if not self._needs_fallback(ratio, avg_logprob, no_speech_prob,
                                        opts):
                break
        return last

    # -- public API ----------------------------------------------------------

    @torch.inference_mode()
    def detect_language(self, audio: Union[str, np.ndarray]
                        ) -> Tuple[str, float, List[Tuple[str, float]]]:
        """Identify the spoken language from the first 30 s window: one
        decode step from ``<|startoftranscript|>`` restricted to the
        language tokens.  Returns (language, probability, ranked list)."""
        if isinstance(audio, (str, bytes)):
            audio, _ = load_audio(audio, sr=SAMPLE_RATE, int16=True)
        audio = _as_master(audio)[:N_SAMPLES]
        enc_out = self.encode_windows(audio[None])
        prompt, pad = pad_prompts([[self.tokenizer.sot]], self.ti.eot, width=16)
        with self._device_lock, self._decoder_slices() as (params, group):
            cache = init_cache(params, self.cfg, enc_out, max_len=17)
            hidden, _ = _prefill(
                params, self.cfg,
                torch.as_tensor(prompt, dtype=torch.long, device=self.device),
                torch.as_tensor(pad, dtype=torch.long, device=self.device), cache,
                tp_group=group)
            logits = _logits_at(params, hidden[:, -1], self.cfg,
                                tp_group=group)[0].cpu().numpy()

        lang_ids = self.tokenizer.language_ids
        ids = np.asarray(list(lang_ids.values()))
        probs = np.exp(logits[ids] - logits[ids].max())
        probs = probs / probs.sum()
        ranked = sorted(zip(lang_ids.keys(), probs.tolist()),
                        key=lambda kv: -kv[1])
        return ranked[0][0], ranked[0][1], ranked

    def transcribe(self, audio: Union[str, np.ndarray], **kwargs
                   ) -> Tuple[List[Segment], TranscriptionInfo]:
        """Transcribe audio; returns (segments, info) like WhisperModel."""
        opts = _parse_transcribe_kwargs(kwargs)

        if isinstance(audio, (str, bytes)):
            audio, _ = load_audio(audio, sr=SAMPLE_RATE, int16=True)
        audio = _as_master(audio)
        duration = len(audio) / SAMPLE_RATE

        language_probability = 1.0
        if opts.language is None and len(audio) > 0:
            lang, language_probability, _ = self.detect_language(audio)
            opts = dataclasses.replace(opts, language=lang)

        speech_chunks = None
        if opts.vad_filter:
            vad_opts = opts.vad_parameters or VadOptions()
            speech_chunks = get_speech_timestamps(_host_f32(audio), vad_opts)
            audio = collect_chunks(audio, speech_chunks)
            duration_after_vad = len(audio) / SAMPLE_RATE
        else:
            duration_after_vad = duration

        info = TranscriptionInfo(
            language=opts.language or "zh",
            language_probability=language_probability,
            duration=duration,
            duration_after_vad=duration_after_vad,
        )
        if len(audio) == 0:
            return [], info

        windows = self._seek_loop(audio, opts)
        try:
            step = next(windows)
            while True:
                if isinstance(step, _AlignRequest):
                    step = windows.send(self._align_window_words(*step))
                    continue
                window, prompt_ids = step
                enc_out = self.encode_windows(window[None])
                step = windows.send(self._decode_with_fallback(
                    enc_out, prompt_ids, opts) + (enc_out,))
        except StopIteration as done:
            segments = done.value
        return _restore_times(segments, speech_chunks), info

    # -- continuous-batching path ---------------------------------------------

    async def _decode_with_fallback_server(self, server, window, prompt_ids,
                                           opts: TranscribeOptions,
                                           return_enc: bool):
        """:meth:`_decode_with_fallback` routed through a
        :class:`ttasr_torch.engine.serving.BatchServer`: the same
        temperature ladder, quality gates and best_of selection, each
        window decode packed into the server's shared slots."""
        dec_opts = self._decoding_options(opts)
        last = None
        for temperature in opts.temperatures:
            if temperature > 0.0 and opts.best_of > 1:
                # best_of candidates as K window requests: they pack into
                # the server's slots (often the same batch)
                results = await asyncio.gather(*[
                    server.transcribe_window(
                        window, prompt_ids, temperature=temperature,
                        opts=dec_opts, return_enc=return_enc)
                    for _ in range(opts.best_of)])
                lengths = np.asarray([len(r.tokens) for r in results])
                sums = np.asarray([r.sum_logprob for r in results])
                penalties = ((5.0 + lengths + 1.0) / 6.0) ** opts.length_penalty
                result = results[int(np.argmax(
                    sums / np.maximum(penalties, 1e-9)))]
            else:
                result = await server.transcribe_window(
                    window, prompt_ids, temperature=temperature,
                    opts=dec_opts, return_enc=return_enc)
            text = self.tokenizer.decode(result.tokens)
            ratio = compression_ratio(text)
            last = (result, ratio, temperature)
            if not self._needs_fallback(ratio, result.avg_logprob,
                                        result.no_speech_prob, opts):
                break
        return last

    async def transcribe_with_server(self, audio: Union[str, np.ndarray],
                                     server, **kwargs
                                     ) -> Tuple[List[Segment], TranscriptionInfo]:
        """The seek loop of :meth:`transcribe` with each window's decodes
        routed through a :class:`ttasr_torch.engine.serving.BatchServer`,
        so windows of concurrent files pack into shared decode slots.

        Decode-equivalent to :meth:`transcribe`: the same fallback ladder
        (best_of sampling included), no-speech gate and
        ``prompt_reset_on_temperature``; prompt carry stays sequential
        within a file (:func:`ttasr_torch.engine.serving.transcribe_files`
        runs many files at once).  The language is not detected here:
        ``language=None`` decodes as ``"zh"``, as in the reference."""
        opts = _parse_transcribe_kwargs(kwargs)
        if isinstance(audio, (str, bytes)):
            audio, _ = load_audio(audio, sr=SAMPLE_RATE, int16=True)
        audio = _as_master(audio)
        duration = len(audio) / SAMPLE_RATE

        speech_chunks = None
        duration_after_vad = duration
        if opts.vad_filter:
            vad_opts = opts.vad_parameters or VadOptions()
            speech_chunks = await run_vad_async(_host_f32(audio), vad_opts)
            audio = collect_chunks(audio, speech_chunks)
            duration_after_vad = len(audio) / SAMPLE_RATE

        info = TranscriptionInfo(
            language=opts.language or "zh", language_probability=1.0,
            duration=duration, duration_after_vad=duration_after_vad,
        )
        if len(audio) == 0:
            return [], info

        # session scope: lets the server wave-coalesce partial bulk sweeps
        # across concurrent prompt-carry files
        windows = self._seek_loop(audio, opts)
        loop = asyncio.get_running_loop()
        with server.session():
            try:
                step = next(windows)
                while True:
                    if isinstance(step, _AlignRequest):
                        # off the loop: the pass waits for the device lock,
                        # which a served group holds for its whole decode
                        step = windows.send(await loop.run_in_executor(
                            None, self._align_window_words, *step))
                        continue
                    window, prompt_ids = step
                    result, ratio, temperature = await self._decode_with_fallback_server(
                        server, window, prompt_ids, opts,
                        return_enc=opts.word_timestamps)
                    step = windows.send(
                        (result.tokens, result.avg_logprob, result.no_speech_prob,
                         ratio, temperature, result.enc))
            except StopIteration as done:
                segments = done.value
        return _restore_times(segments, speech_chunks), info

    # -- seek loop ------------------------------------------------------------

    def _seek_loop(self, audio: np.ndarray, opts: TranscribeOptions):
        """The 30 s seek loop over ``audio``, as a generator: it yields each
        window and its prompt, is sent the window's (tokens, avg_logprob,
        no_speech_prob, compression ratio, temperature) from the fallback
        ladder and its encoder states (the word alignment's input; None
        from the server unless ``opts.word_timestamps``), and returns the
        segments.  With ``opts.word_timestamps`` it also yields an
        :class:`_AlignRequest` for each window with text and is sent that
        window's words.  :meth:`transcribe` drives it with direct decodes,
        :meth:`transcribe_with_server` through a server."""
        tok = self.tokenizer
        content_frames = max(len(audio) // HOP_LENGTH, 1)
        seek = 0
        all_tokens: List[int] = []
        prompt_reset_since = 0
        initial_prompt_tokens: List[int] = []
        if opts.initial_prompt:
            initial_prompt_tokens = tok.encode(" " + opts.initial_prompt.strip())
            all_tokens.extend(initial_prompt_tokens)
        segments: List[Segment] = []
        seg_id = 0

        while seek < content_frames:
            time_offset = seek * HOP_LENGTH / SAMPLE_RATE
            window = audio[seek * HOP_LENGTH: seek * HOP_LENGTH + N_SAMPLES]
            segment_frames = min(N_FRAMES, content_frames - seek)
            segment_duration = segment_frames * HOP_LENGTH / SAMPLE_RATE

            previous = (all_tokens[prompt_reset_since:]
                        if opts.condition_on_previous_text else [])
            prompt_ids = build_prompt(
                tok,
                language=opts.language or "zh",
                task=opts.task,
                without_timestamps=opts.without_timestamps,
                prefix_tokens=(tok.encode(" " + opts.prefix.strip())
                               if opts.prefix else ()),
                previous_tokens=previous,
                initial_prompt_tokens=() if previous else initial_prompt_tokens,
            )

            tokens, avg_logprob, no_speech_prob, ratio, temperature, enc_out = (
                yield window, prompt_ids)

            if (opts.no_speech_threshold is not None
                    and no_speech_prob > opts.no_speech_threshold):
                should_skip = True
                if (opts.log_prob_threshold is not None
                        and avg_logprob > opts.log_prob_threshold):
                    should_skip = False  # confident despite no_speech
                if should_skip:
                    seek += segment_frames
                    continue

            new_segments, seek_advance = self._parse_window_tokens(
                tokens, time_offset, segment_duration, segment_frames)
            window_words = None
            if opts.word_timestamps and any(s[0] for s in new_segments):
                window_words = yield _AlignRequest(
                    [t for s in new_segments for t in s[0]], enc_out, time_offset)
            for s_tokens, s_start, s_end in new_segments:
                text = tok.decode(s_tokens)
                if not text.strip():
                    continue
                segments.append(Segment(
                    id=seg_id, seek=seek, start=s_start, end=s_end, text=text,
                    tokens=s_tokens, avg_logprob=avg_logprob,
                    compression_ratio=ratio, no_speech_prob=no_speech_prob,
                    temperature=temperature,
                    words=_words_in(window_words, s_start, s_end),
                ))
                seg_id += 1
                all_tokens.extend(s_tokens)

            if temperature > opts.prompt_reset_on_temperature:
                prompt_reset_since = len(all_tokens)

            seek += seek_advance

        return segments

    def _align_window_words(self, text_tokens: List[int], enc_out,
                            time_offset: float) -> List[Word]:
        """Cross-attention DTW word timestamps for one window.  A failure is
        logged and gives no words, as in the reference.  The teacher-forced
        pass holds the engine's device lock; the host DTW does not."""
        try:
            with self._device_lock, self._decoder_slices() as (params, group):
                qk = alignment_heads_qk(params, self.cfg, self.tokenizer,
                                        text_tokens, enc_out, tp_group=group)
            words = merge_tokens_to_words(
                self.tokenizer, token_timings(self.tokenizer, text_tokens, qk))
        except Exception:
            logger.exception("word alignment failed; words omitted")
            return []
        return [
            Word(start=w["start"] + time_offset, end=w["end"] + time_offset,
                 word=w["word"])
            for w in words
        ]

    def _parse_window_tokens(self, tokens: List[int], time_offset: float,
                             segment_duration: float, segment_frames: int):
        """Split decoded tokens into timestamped segments; compute the seek
        advance (openai-whisper seek rules)."""
        tok = self.tokenizer
        ts0 = tok.timestamp_begin

        if not tokens:
            return [], segment_frames

        is_ts = [tok.is_timestamp(t) for t in tokens]
        consecutive = [
            i + 1
            for i in range(len(tokens) - 1)
            if is_ts[i] and is_ts[i + 1]
        ]
        new_segments = []
        if consecutive:
            last_slice = 0
            for boundary in consecutive:
                sliced = tokens[last_slice:boundary]
                start_ts = sliced[0] - ts0
                end_ts = sliced[-1] - ts0
                new_segments.append((
                    [t for t in sliced if not tok.is_timestamp(t)],
                    time_offset + start_ts * TIME_PRECISION,
                    time_offset + end_ts * TIME_PRECISION,
                ))
                last_slice = boundary
            # seek to the last consecutive timestamp
            last_ts = tokens[last_slice - 1] - ts0
            seek_advance = last_ts * 2  # ts units are 0.02 s = 2 frames
        else:
            # single segment covering the window; end at the last timestamp
            # if present, else the window duration
            duration = segment_duration
            ts_tokens = [t - ts0 for t in tokens if tok.is_timestamp(t)]
            if ts_tokens and ts_tokens[-1] != 0:
                duration = ts_tokens[-1] * TIME_PRECISION
            new_segments.append((
                [t for t in tokens if not tok.is_timestamp(t)],
                time_offset,
                time_offset + duration,
            ))
            seek_advance = segment_frames

        if not self.tokenizer.is_timestamp(tokens[0]) and not any(is_ts):
            # no timestamps at all (without_timestamps mode)
            new_segments = [(
                [t for t in tokens if not tok.is_timestamp(t)],
                time_offset,
                time_offset + segment_duration,
            )]
            seek_advance = segment_frames
        seek_advance = max(int(seek_advance), 1)
        return new_segments, seek_advance
