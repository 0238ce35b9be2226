"""Batched single-file transcription (port of ``ttasr/engine/batched.py``).

The sequential seek loop (``WhisperEngine.transcribe``) is serial within one
file: window *i+1*'s start comes from window *i*'s last timestamp, and
``condition_on_previous_text`` carries its tokens forward.  This module
removes that dependency as faster-whisper's ``BatchedInferencePipeline``
does: the VAD's speech timestamps become the chunking oracle.  Speech
segments merge into independent <= 30 s spans of the ORIGINAL audio, every
span decodes concurrently through a
:class:`ttasr_torch.engine.serving.BatchServer`, and timestamps are parsed
per chunk at its own absolute offset.

Semantics against the sequential path:

- ``vad_filter`` is implicitly on: the VAD gives the chunk boundaries;
- ``condition_on_previous_text`` is ignored (chunks are independent);
  ``initial_prompt`` still applies to every chunk;
- each chunk runs the same per-window machinery as the seek loop: the
  temperature fallback ladder with its quality gates, the no-speech skip
  and timestamp-token parsing
  (``WhisperEngine._decode_with_fallback_server`` /
  ``_parse_window_tokens``), and with ``word_timestamps=True`` the word
  alignment on the chunk's encoder row at its absolute offset.
"""

from __future__ import annotations

import asyncio
import threading
from typing import List, Optional, Tuple

from ttasr_torch.audio.io import load_audio
from ttasr_torch.audio.vad import VadOptions
from ttasr_torch.engine.results import Segment, TranscriptionInfo
from ttasr_torch.engine.serving import BatchServer
from ttasr_torch.engine.transcriber import (
    _as_master,
    _host_f32,
    _parse_transcribe_kwargs,
    _words_in,
    run_vad_async,
)
from ttasr_torch.models.whisper.decode import build_prompt
from ttasr_torch.ops.mel import HOP_LENGTH, N_FRAMES, N_SAMPLES, SAMPLE_RATE

__all__ = ["BatchedInferencePipeline", "build_speech_chunks",
           "transcribe_batched_with_server"]


def build_speech_chunks(speech_ts: List[dict], total_samples: int,
                        max_samples: int = N_SAMPLES) -> List[dict]:
    """Merge VAD speech segments into decode chunks <= ``max_samples``.

    Each chunk is a contiguous ``{"start", "end"}`` sample span of the
    ORIGINAL audio covering whole speech segments; the silence between
    merged segments rides along, so decoded timestamps are already
    absolute.  A single speech segment longer than ``max_samples`` splits
    at window boundaries.
    """
    chunks: List[dict] = []
    cur_start: Optional[int] = None
    cur_end = 0

    def flush():
        nonlocal cur_start
        if cur_start is not None and cur_end > cur_start:
            chunks.append({"start": cur_start, "end": min(cur_end,
                                                          total_samples)})
        cur_start = None

    for seg in speech_ts:
        s, e = int(seg["start"]), int(seg["end"])
        if cur_start is not None and e - cur_start <= max_samples:
            cur_end = max(cur_end, e)
            continue
        flush()
        cur_start, cur_end = s, e
        while cur_end - cur_start > max_samples:
            chunks.append({"start": cur_start,
                           "end": cur_start + max_samples})
            cur_start += max_samples
    flush()
    return chunks


async def transcribe_batched_with_server(
        engine, server, audio, *, chunk_length: Optional[float] = None,
        **kwargs
) -> Tuple[List[Segment], TranscriptionInfo]:
    """VAD-chunked concurrent transcription of ONE file through a running
    :class:`~ttasr_torch.engine.serving.BatchServer`.

    All chunks are submitted at once; the server packs them into its
    decode slots (beside any other files' windows).  ``chunk_length``
    (seconds) caps each chunk below the 30 s window.  Returns
    ``(segments, info)`` like :meth:`WhisperEngine.transcribe`.
    """
    max_samples = (N_SAMPLES if chunk_length is None
                   else min(int(chunk_length * SAMPLE_RATE), N_SAMPLES))
    opts = _parse_transcribe_kwargs(kwargs)
    if isinstance(audio, (str, bytes)):
        audio, _ = load_audio(audio, sr=SAMPLE_RATE, int16=True)
    audio = _as_master(audio)
    duration = len(audio) / SAMPLE_RATE

    # host VAD in the serial executor: off the event loop, FIFO, and
    # counted so the server defers partial bulk sweeps while sibling
    # files' VADs still run
    speech_ts = await run_vad_async(_host_f32(audio),
                                    opts.vad_parameters or VadOptions())
    duration_after_vad = sum(
        c["end"] - c["start"] for c in speech_ts) / SAMPLE_RATE
    info = TranscriptionInfo(
        language=opts.language or "zh", language_probability=1.0,
        duration=duration, duration_after_vad=duration_after_vad,
    )
    if not speech_ts:
        return [], info

    chunks = build_speech_chunks(speech_ts, len(audio),
                                 max_samples=max_samples)
    tok = engine.tokenizer
    initial_prompt_tokens = (
        tok.encode(" " + opts.initial_prompt.strip())
        if opts.initial_prompt else [])
    prompt_ids = build_prompt(
        tok, language=opts.language or "zh", task=opts.task,
        without_timestamps=opts.without_timestamps,
        prefix_tokens=(tok.encode(" " + opts.prefix.strip())
                       if opts.prefix else ()),
        previous_tokens=(),
        initial_prompt_tokens=initial_prompt_tokens,
    )

    async def parse_chunk(chunk, result, ratio, temperature) -> List[Segment]:
        time_offset = chunk["start"] / SAMPLE_RATE
        chunk_frames = min(N_FRAMES,
                           max((chunk["end"] - chunk["start"])
                               // HOP_LENGTH, 1))
        chunk_duration = chunk_frames * HOP_LENGTH / SAMPLE_RATE
        avg_logprob = result.avg_logprob
        no_speech_prob = result.no_speech_prob

        # the seek loop's no-speech skip
        if (opts.no_speech_threshold is not None
                and no_speech_prob > opts.no_speech_threshold):
            if not (opts.log_prob_threshold is not None
                    and avg_logprob > opts.log_prob_threshold):
                return []

        new_segments, _ = engine._parse_window_tokens(
            result.tokens, time_offset, chunk_duration, chunk_frames)
        window_words = None
        if opts.word_timestamps and any(s[0] for s in new_segments):
            # off the loop: the pass waits for the engine's device lock
            window_words = await asyncio.get_running_loop().run_in_executor(
                None, engine._align_window_words,
                [t for s in new_segments for t in s[0]], result.enc,
                time_offset)
        out: List[Segment] = []
        for s_tokens, s_start, s_end in new_segments:
            text = tok.decode(s_tokens)
            if not text.strip():
                continue
            out.append(Segment(
                id=-1, seek=chunk["start"] // HOP_LENGTH,
                start=s_start, end=min(s_end, duration), text=text,
                tokens=s_tokens, avg_logprob=avg_logprob,
                compression_ratio=ratio, no_speech_prob=no_speech_prob,
                temperature=temperature,
                words=_words_in(window_words, s_start, s_end),
            ))
        return out

    async def one(chunk) -> List[Segment]:
        result, ratio, temperature = await engine._decode_with_fallback_server(
            server, audio[chunk["start"]: chunk["end"]], prompt_ids, opts,
            return_enc=opts.word_timestamps,
        )
        # parse as each chunk's decode resolves: the host's token ->
        # segment work of sweep N overlaps sweep N+1's decode
        return await parse_chunk(chunk, result, ratio, temperature)

    per_chunk = await asyncio.gather(*[one(c) for c in chunks])
    segments: List[Segment] = [s for segs in per_chunk for s in segs]
    for i, s in enumerate(segments):
        s.id = i
    return segments, info


class BatchedInferencePipeline:
    """faster-whisper's batched entry point on the port's engine.

    >>> pipeline = BatchedInferencePipeline(engine)
    >>> segments, info = pipeline.transcribe("audio.wav", batch_size=8)

    ``batch_size`` is the decode-slot count of the internal
    :class:`BatchServer`.
    """

    def __init__(self, model, batch_size: int = 8):
        self.model = model
        self.batch_size = batch_size
        # A private event loop in a thread, with one BatchServer on it:
        # the synchronous ``transcribe`` is callable from any context
        # (inside a running event loop too), and repeated calls reuse one
        # server.  Async callers should prefer
        # :func:`transcribe_batched_with_server` on their own loop.
        self._loop = None
        self._thread = None
        self._server = None
        self._server_cfg = None

    def _ensure_loop(self):
        if self._loop is None or not self._thread.is_alive():
            self._loop = asyncio.new_event_loop()
            self._thread = threading.Thread(
                target=self._loop.run_forever,
                name="ttasr-batched-pipeline", daemon=True)
            self._thread.start()
        return self._loop

    async def _get_server(self, slots: int, beam_size: int):
        cfg = (slots, beam_size)
        if (self._server is None or self._server._stop
                or self._server_cfg != cfg):
            if self._server is not None and not self._server._stop:
                await self._server.stop()
            self._server = BatchServer(self.model, slots=slots,
                                       beam_size=beam_size)
            await self._server.start()
            self._server_cfg = cfg
        return self._server

    def transcribe(self, audio, batch_size: Optional[int] = None,
                   chunk_length: Optional[float] = None,
                   **kwargs) -> Tuple[List[Segment], TranscriptionInfo]:
        slots = int(batch_size or self.batch_size)
        beam_size = int(kwargs.get("beam_size", 5))

        async def run():
            server = await self._get_server(slots, beam_size)
            return await transcribe_batched_with_server(
                self.model, server, audio,
                chunk_length=chunk_length, **kwargs)

        loop = self._ensure_loop()
        return asyncio.run_coroutine_threadsafe(run(), loop).result()

    def close(self) -> None:
        """Stop the private server and loop (idempotent)."""
        if self._loop is None:
            return
        loop, self._loop = self._loop, None
        if self._server is not None and not self._server._stop:
            asyncio.run_coroutine_threadsafe(
                self._server.stop(), loop).result(timeout=30)
        self._server = None
        loop.call_soon_threadsafe(loop.stop)
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None
        if not loop.is_running():
            loop.close()  # and its default executor (word alignments)

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
