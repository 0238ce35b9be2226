"""Streaming ASR plugin backed by the port's Whisper engine (the
counterpart of ``ttasr/streaming/asr/jax_whisper_asr.py``).

Parity surface: reference asr/faster_whisper_asr.py —
- model dir resolution + required-file validation (:26-53),
- device/compute selection from api config with fallback (:57-136),
- default transcribe kwargs ``vad_filter=True, beam_size=5,
  condition_on_previous_text=True, initial_prompt="繁體中文"`` (:139-149),
- empty-result retry with ``vad_filter=False`` (:184-200),
- hallucination ``filter_text`` with fallback to raw text (:213-217),
- result payload with words offset by ``client.last_start_time``
  (:240-255), and ``warm_up()`` (:269-303).

As in the JAX plugin, the scratch PCM buffer feeds the engine directly —
no temp-WAV round trip per chunk (reference :155-157).  The engine runs on
``config.MODEL_DEVICE`` (default ``cuda``); without CUDA the constructor
raises unless that is ``cpu``.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Optional

import numpy as np

from ttasr_torch.audio.io import pcm16_bytes_to_float32
from ttasr_torch.streaming.asr.asr_interface import ASRInterface
from ttasr_torch.text.filters import filter_text

logger = logging.getLogger("ttasr_torch.streaming.asr")

REQUIRED_MODEL_FILES = ("model.safetensors", "config.json", "tokenizer.json")


def _resolve_model_path(model_size: str) -> str:
    """Model dir relative to the project root, else treat as name
    (reference faster_whisper_asr.py:26-53)."""
    here = os.path.abspath(__file__)
    project_root = os.path.abspath(os.path.join(here, *[".."] * 4))
    candidate = os.path.join(project_root, model_size)
    if os.path.isdir(candidate):
        return candidate
    return model_size


class TorchWhisperASR(ASRInterface):
    def __init__(self, **kwargs):
        model_size = kwargs.get("model_size", "large-v3-turbo")
        model_path = _resolve_model_path(model_size)

        from ttasr_torch.api import config as app_config

        # compute type and device from the api config module
        compute_type = kwargs.get("compute_type")
        if compute_type is None:
            compute_type = getattr(app_config, "MODEL_COMPUTE_TYPE", "int8")

        engine = kwargs.get("engine")
        if engine is None:
            # process-wide shared engine: when the task API loads the
            # same model path + compute + device, both serve from ONE
            # weight set and one shared BatchServer
            # (ttasr_torch.engine.registry)
            from ttasr_torch.engine.registry import get_engine

            engine = get_engine(model_path, compute_type=compute_type,
                                device=app_config.MODEL_DEVICE)
        self.engine = engine
        self.asr_pipeline = engine  # name exposed for health checks
        # Optional continuous-batching server: concurrent streams' chunks
        # pack into one fixed-slot decode program instead of separate calls.
        self.server = kwargs.get("server")
        # a string: /stream/health returns it as JSON
        self.device = str(getattr(engine, "device", app_config.MODEL_DEVICE))
        self.compute_type = compute_type
        self.model_size = model_size
        self.model_path = model_path

        self.default_transcribe_kwargs = {
            "word_timestamps": False,
            "vad_filter": True,
            "beam_size": 5,
            "condition_on_previous_text": True,
            "initial_prompt": "繁體中文",
        }
        # Partial-latency knob: cap the temperature-fallback ladder for
        # streaming chunks (e.g. "0" = single rung).  A failed quality
        # gate on a 1.5 s partial otherwise costs 6 rungs of decode
        # before the next chunk can start — with real weights rung 0
        # passes almost always, but a backlog death-spirals either way.
        temps = os.environ.get("TTASR_STREAM_TEMPERATURES")
        if temps:
            self.default_transcribe_kwargs["temperatures"] = tuple(
                float(t) for t in temps.split(",")
            )
        # Short-window encode for partials (default on): a 1.5-3.5 s
        # chunk encodes a 5.12 s prefix window (256 positions) instead
        # of the padded 30 s window — ~6x less encoder work and
        # S-proportional cross-attention per decode step
        # (ttasr_torch.engine.serving.window_bucket).  TTASR_STREAM_SHORT_WINDOW=0
        # restores the full-window semantics whisper was trained with.
        self.short_window = os.environ.get(
            "TTASR_STREAM_SHORT_WINDOW", "1").lower() not in (
            "0", "false", "no")

    @staticmethod
    def _token_budget(duration_s: float) -> int:
        """Decode-token cap for a streaming chunk, in the JAX plugin's
        buckets (there each maps to one compiled decode program; here
        equal buckets keep partials of one bucket in one server group,
        since requests batch only with equal options).  Whisper emits ~4 tokens per second of dense zh speech; the
        buckets are ~10/s — generous headroom while keeping a 1.5-3.5 s
        partial's worst-case decode ~5x cheaper than the 224-token
        window budget (which a chunk's audio physically cannot fill).
        TTASR_STREAM_TOKEN_CAP=N forces a single fixed budget of N
        tokens (0 = the full 224-token window budget).

        Boundaries EQUAL the short-window encode buckets
        (serving.WINDOW_BUCKETS: 81920 samples = 5.12 s, 245760 =
        15.36 s) so only |buckets|+1 (window, budget) combos are ever
        reachable."""
        cap = os.environ.get("TTASR_STREAM_TOKEN_CAP")
        if cap is not None:
            n = int(cap)
            return 224 if n <= 0 else min(n, 224)
        from ttasr_torch.engine.serving import WINDOW_BUCKETS
        if duration_s * 16000 <= WINDOW_BUCKETS[0]:   # <= 5.12 s
            return 48
        if duration_s * 16000 <= WINDOW_BUCKETS[1]:   # <= 15.36 s
            return 96
        return 224

    async def transcribe(self, client) -> Optional[dict]:
        try:
            raw = bytes(client.scratch_buffer)
            if self.server is not None:
                # ship PCM16 as-is through the batch server: the mel
                # converts (exact /32768), halving the per-chunk copy
                audio = np.frombuffer(raw, dtype="<i2")
                if len(audio) == 0:
                    return None
                return await self._transcribe_batched(audio, client)
            audio = pcm16_bytes_to_float32(raw)
            if len(audio) == 0:
                return None
            language = "zh"
            kwargs = dict(self.default_transcribe_kwargs)
            kwargs["language"] = language
            kwargs["max_new_tokens"] = self._token_budget(len(audio) / 16000)

            segments, info = self.engine.transcribe(audio, **kwargs)
            segments = list(segments)
            if len(segments) == 0:
                # over-aggressive VAD: retry without it
                retry_kwargs = dict(kwargs)
                retry_kwargs["vad_filter"] = False
                try:
                    segments, info = self.engine.transcribe(audio, **retry_kwargs)
                    segments = list(segments)
                except Exception:
                    pass
                if len(segments) == 0:
                    return None

            text = " ".join((s.text or "").strip() for s in segments)
            filtered = filter_text(text)
            if filtered is None:
                logger.debug("hallucination filter hit; keeping raw text")
                filtered = text
            text = filtered

            flattened_words = []
            for seg in segments:
                if getattr(seg, "words", None):
                    flattened_words.extend(seg.words)
            # faster-whisper parity: info.duration is the AUDIO duration
            # of the transcribed buffer (reference faster_whisper_asr.py
            # returns it as "duration"), not the last decoded timestamp
            duration = len(audio) / 16000.0

            return {
                "language": getattr(info, "language", None),
                "language_probability": getattr(info, "language_probability", None),
                "final": True,
                "text": text,
                "duration": duration,
                "words": [
                    {
                        "word": getattr(w, "word", ""),
                        "start": (getattr(w, "start", 0) or 0) + client.last_start_time,
                        "end": (getattr(w, "end", 0) or 0) + client.last_start_time,
                        "probability": getattr(w, "probability", None),
                    }
                    for w in flattened_words
                ],
            }
        except Exception:
            logger.exception("streaming transcription failed")
            return None

    async def _transcribe_batched(self, audio, client) -> Optional[dict]:
        """Chunk transcription through the continuous-batching server:
        concurrent streams' partials share one decode sweep, ahead of
        bulk groups (``priority=1``)."""
        from ttasr_torch.models.whisper.decode import build_prompt

        tok = self.engine.tokenizer
        prompt = build_prompt(
            tok, language="zh", task="transcribe",
            initial_prompt_tokens=tok.encode(" 繁體中文"),
        )
        budget = self._token_budget(len(audio) / 16000)
        result = await self.server.transcribe_window(
            audio, prompt, sample_len=budget, priority=1,
            short_window=self.short_window)
        if len(result.tokens) >= budget:
            # no eot within budget: the partial may be truncated (dense zh
            # + timestamp tokens can approach ~10 tok/s);
            # TTASR_STREAM_TOKEN_CAP raises the budget if this recurs
            logger.debug(
                "streaming token budget %d exhausted on a %.1fs chunk; "
                "partial may be truncated", budget, len(audio) / 16000)
        text_tokens = [t for t in result.tokens if not tok.is_timestamp(t)]
        if not text_tokens:
            return None
        text = tok.decode(text_tokens).strip()
        if not text:
            return None
        filtered = filter_text(text)
        text = filtered if filtered is not None else text
        duration = len(audio) / 16000.0  # faster-whisper info.duration
        return {
            "language": "zh",
            "language_probability": None,
            "final": True,
            "text": text,
            "duration": duration,
            "words": [],
        }

    async def warm_up_async(self) -> None:
        """Warm every streaming (window, token-budget) bucket through the
        same path live chunks take (the batched server when enabled).
        On the card this builds the CUDA kernels and the cuBLAS handles
        before the first live chunk; there is no compile as in JAX."""
        import asyncio

        from ttasr_torch.models.whisper.decode import build_prompt

        logger.info("warming up ASR pipeline (kernels, cuBLAS handles)...")
        t0 = time.time()
        tok = self.engine.tokenizer
        prompt = build_prompt(
            tok, language="zh", task="transcribe",
            initial_prompt_tokens=tok.encode(" 繁體中文"),
        )
        # all three _token_budget buckets (48/96/224) and all reachable
        # window buckets (5.12 s / 15.36 s / 30 s): scratch can exceed
        # 15.36 s when processing falls behind and the silence gate
        # keeps accumulating.  Budget boundaries EQUAL the window
        # buckets, so exactly these three (window, budget) combos exist.
        for seconds in (1.5, 6.0, 16.0):
            budget = self._token_budget(seconds)
            try:
                if self.server is not None:
                    # int16 zeros: live chunks ship PCM16; short_window
                    # matches live chunks, so the warmed buckets are the
                    # ones they take
                    audio = np.zeros(int(16000 * seconds), np.int16)
                    await self.server.transcribe_window(
                        audio, prompt, sample_len=budget,
                        short_window=self.short_window)
                else:
                    audio = np.zeros(int(16000 * seconds), np.float32)
                    loop = asyncio.get_running_loop()
                    await loop.run_in_executor(
                        None, lambda a=audio, b=budget: self.engine.transcribe(
                            a, language="zh", vad_filter=False, beam_size=5,
                            condition_on_previous_text=True,
                            initial_prompt="繁體中文", max_new_tokens=b))
            except Exception:
                logger.exception("warm-up decode failed (budget %d)", budget)
        logger.info("warm-up complete in %.1fs", time.time() - t0)

    def warm_up(self) -> None:
        """Run the decode path on a dummy 1.5 s chunk so the first real
        request is fast (replaces warm_up.wav — reference :269-303)."""
        logger.info("warming up ASR pipeline (kernels, cuBLAS handles)...")
        t0 = time.time()
        dummy = np.zeros(int(16000 * 1.5), dtype=np.float32)
        try:
            self.engine.transcribe(
                dummy, language="zh", vad_filter=False, beam_size=5,
                condition_on_previous_text=True, initial_prompt="繁體中文",
                max_new_tokens=self._token_budget(1.5),
            )
            logger.info("warm-up complete in %.1fs", time.time() - t0)
        except Exception:
            logger.exception("warm-up failed")
