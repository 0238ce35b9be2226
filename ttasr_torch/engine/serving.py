"""Continuous-batching serving core (port of ``ttasr/engine/serving.py``).

One decode program serves many callers through fixed slots:

- requests (30 s windows + prompts) enter an asyncio queue,
- a collator packs up to ``slots`` requests per sweep (idle slots get
  zero audio and a minimal prompt),
- requests carry per-call decode options and a ladder temperature; the
  collator groups compatible requests (same DecodingOptions) per sweep,
  and the greedy decode takes per-row temperatures, so windows at
  different fallback rungs share a batch,
- one group decodes per sweep and arrivals re-rank between sweeps:
  latency-priority requests (streaming partials, ``priority=1``) order
  ahead of bulk task-API groups, with starvation aging so bulk work
  still progresses under a steady partial stream,
- bulk sweeps pipeline at depth 2 (``TTASR_PIPELINE_GROUPS``): the next
  group is packed in a second executor thread while the in-flight group
  decodes, and starts its device work as soon as that group's ends,
- mel + encode + decode run in executor threads (the event loop never
  blocks), and each request's future resolves with its row of the batch.

The scheduler is the reference's, line for line, with its knobs
(``TTASR_PIPELINE_GROUPS``, ``TTASR_PARTIAL_GATHER_MS``,
``TTASR_WAVE_WAIT_MS``) and their defaults.  What differs: sampling draws
from a ``torch.Generator`` seeded per dispatch, the decode threads are a
plain executor of ``pipeline_groups`` workers per server, and the device
work of one group at a time goes to the device's current stream (see
:meth:`BatchServer._run` and :meth:`BatchServer._decode_batch`).
"""

from __future__ import annotations

import asyncio
import contextlib
import dataclasses
import logging
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ttasr_torch.engine.transcriber import vad_pending
from ttasr_torch.models.whisper.decode import DecodingOptions, pad_prompts
from ttasr_torch.ops.mel import N_SAMPLES

logger = logging.getLogger("ttasr_torch.serving")

# Short-window encode buckets for streaming partials: a 1.5-3.5 s chunk
# that encodes the full 30 s window pays 1500 encoder positions and a
# 1500-slot cross-attention every decode step; a PREFIX window cuts both
# by ~S/1500.  Bucket lengths are multiples of 320 samples per position:
#   81920 samples =  5.12 s -> S=256   (typical 1.5-3.5 s partials)
#  245760 samples = 15.36 s -> S=768   (backlogged scratch <= 12 s)
# Everything longer uses the full 30 s window.
WINDOW_BUCKETS = (81920, 245760)


def window_bucket(n_samples: int) -> int:
    """Smallest short-window bucket holding ``n_samples``, else the
    full 30 s window."""
    for b in WINDOW_BUCKETS:
        if n_samples <= b:
            return b
    return N_SAMPLES


@dataclasses.dataclass
class WindowRequest:
    audio: np.ndarray                  # <= 30 s float32 or int16 mono 16 kHz
    prompt_ids: Sequence[int]
    future: "asyncio.Future"
    loop: "asyncio.AbstractEventLoop"
    opts: DecodingOptions              # per-request decode options
    temperature: float = 0.0           # fallback-ladder rung
    return_enc: bool = False           # include encoder row (word align)
    priority: int = 0                  # higher decodes sooner (streaming=1)
    window_samples: int = N_SAMPLES    # encode window (short-window bucket)
    submitted_at: float = dataclasses.field(default_factory=time.time)

    @property
    def group_key(self) -> Tuple:
        """Requests with equal keys share one decode call.

        The audio dtype is part of the key (int16 PCM uploads as-is and
        converts on the device), and so is the window bucket (each is its
        own encoder length and cross-attention width)."""
        is_beam = self.temperature == 0.0 and self.opts.beam_size > 1
        is_i16 = np.asarray(self.audio).dtype == np.int16
        return (self.opts, is_beam, is_i16, self.window_samples)


@dataclasses.dataclass
class WindowResult:
    tokens: List[int]
    sum_logprob: float
    avg_logprob: float
    no_speech_prob: float
    temperature: float = 0.0
    enc: Optional[Any] = None          # (1, S, d) device tensor if requested


async def transcribe_files(engine, paths: Sequence[str], *, slots: int = 4,
                           beam_size: int = 5, **transcribe_kwargs) -> dict:
    """Transcribe many files concurrently through shared decode slots.

    Each file keeps its sequential prompt-carry seek loop; windows from
    different files pack into the same decode sweep.  Returns
    ``{path: (segments, info)}``, with a file's exception as its value.
    """
    server = BatchServer(engine, slots=slots, beam_size=beam_size)
    await server.start()
    try:
        async def one(path):
            return await engine.transcribe_with_server(
                path, server, **transcribe_kwargs)

        results = await asyncio.gather(*[one(p) for p in paths],
                                       return_exceptions=True)
        return dict(zip(paths, results))
    finally:
        await server.stop()


# Process-wide servers, one per engine instance: callers that share an
# engine (ttasr_torch.engine.registry) also share ONE batching queue, so
# their windows pack into the same decode sweeps.
_SHARED_SERVERS: dict = {}


async def shared_server(engine, *, slots: int = 4, beam_size: int = 5,
                        **kwargs) -> "BatchServer":
    """The process-wide BatchServer for ``engine`` on the running loop.

    Creates and starts one on first use; recreates it if the previous
    one was stopped or belongs to another event loop.
    """
    key = id(engine)
    srv = _SHARED_SERVERS.get(key)
    loop = asyncio.get_running_loop()
    if (srv is None or srv._stop
            or getattr(srv, "_loop", None) is not loop):
        srv = BatchServer(engine, slots=slots, beam_size=beam_size, **kwargs)
        await srv.start()
        _SHARED_SERVERS[key] = srv
    elif srv.slots != slots or srv.opts.beam_size != beam_size:
        # the first caller pins the shared config; say so rather than
        # ignore a later caller's knobs silently
        logger.warning(
            "shared_server already running with slots=%d beam_size=%d; "
            "requested slots=%d beam_size=%d ignored",
            srv.slots, srv.opts.beam_size, slots, beam_size)
    return srv


class BatchServer:
    """Persistent fixed-slot decode server over one WhisperEngine."""

    def __init__(self, engine, *, slots: int = 4, beam_size: int = 5,
                 sample_len: int = 224, linger_ms: float = 5.0,
                 without_timestamps: bool = False,
                 starvation_ms: float = 2000.0,
                 pipeline_groups: Optional[int] = None):
        self.engine = engine
        self.slots = slots
        self.linger_s = linger_ms / 1000.0
        # Pipelined dispatch depth: with 2 (default), the NEXT group is
        # dispatched (packed, then waiting for the device) while the current
        # group decodes.  Bulk
        # pre-dispatch is suspended while a stream is active
        # (_pipeline_ok), so a partial never finds an extra bulk group
        # queued on the card ahead of it.
        if pipeline_groups is None:
            pipeline_groups = int(
                os.environ.get("TTASR_PIPELINE_GROUPS", "2") or 2)
        self.pipeline_groups = max(1, int(pipeline_groups))
        self._last_priority_ts = 0.0
        self._priority_quiet_s = 5.0
        self._prev_is_priority = False   # in-flight sweep carries partials
        # Priority-partial saturation: when a priority sweep finishes with
        # more partials already waiting, gather arrivals for up to
        # TTASR_PARTIAL_GATHER_MS before the next priority dispatch, so
        # sweeps carry several rows.  Unsaturated (a solo stream, an
        # aligned herd) dispatch stays immediate.
        self._priority_saturated = False
        self._partial_gather_s = float(
            os.environ.get("TTASR_PARTIAL_GATHER_MS", "250") or 250) / 1000.0
        # active seek-loop sessions (transcribe_with_server).  The
        # scheduler holds a PARTIAL bulk sweep for up to _wave_wait_s
        # while fewer windows are pending than there are sessions: just-
        # resolved prompt-carry clients resubmit within ms, and dispatching
        # before they do phase-locks the server at half-full sweeps.
        self._active_sessions = 0
        self._wave_wait_s = float(
            os.environ.get("TTASR_WAVE_WAIT_MS", "250") or 250) / 1000.0
        self._rng_lock = threading.Lock()
        self._rng_seq = 0
        # a group whose oldest request waited this long decodes next
        # regardless of priority (bulk work cannot starve under a steady
        # stream of priority partials)
        self.starvation_s = starvation_ms / 1000.0
        self.ti = engine.ti
        kv_int8 = getattr(engine, "kv_cache_int8", False)
        self.opts = DecodingOptions(
            beam_size=beam_size, sample_len=sample_len,
            without_timestamps=without_timestamps,
            kv_int8=kv_int8,
            # mirror WhisperEngine._decoding_options EXACTLY, the int4
            # cache sub-modes included, so the served windows run the same
            # decode as every other path (the reference once left the int4
            # flags out here and served int8 cross-KV without noticing)
            cross_kv_int8=kv_int8 and getattr(
                engine, "compute_type", "") == "int8",
            cross_kv_int4=kv_int8 and getattr(
                engine, "cross_kv_int4", False),
            kv_int4=kv_int8 and getattr(engine, "kv_int4", False),
        )
        self._queue: "asyncio.Queue[WindowRequest]" = None
        self._worker_task = None
        self._executor: Optional[ThreadPoolExecutor] = None
        self._stop = False
        self._steps = 0
        self._served = 0
        self._pool: List[WindowRequest] = []
        self._inflight: List[WindowRequest] = []

    # -- lifecycle ----------------------------------------------------------

    async def start(self) -> None:
        self._queue = asyncio.Queue()
        self._stop = False
        self._loop = asyncio.get_running_loop()
        # at most two groups are in flight (the running one and the one
        # dispatched behind it)
        self._executor = ThreadPoolExecutor(max_workers=self.pipeline_groups,
                                        thread_name_prefix="ttasr-decode")
        self._worker_task = self._loop.create_task(self._run())

    async def stop(self) -> None:
        self._stop = True
        if self._worker_task:
            self._worker_task.cancel()
            try:
                await self._worker_task
            except asyncio.CancelledError:
                pass
        # fail anything in flight, absorbed into the pending pool, or still
        # queued: callers' awaits must not hang past stop() (the cancel
        # above can land mid-decode, orphaning that group's futures)
        leftovers = list(self._inflight) + list(self._pool)
        self._inflight = []
        self._pool.clear()
        if self._queue is not None:
            while True:
                try:
                    leftovers.append(self._queue.get_nowait())
                except asyncio.QueueEmpty:
                    break
        for req in leftovers:
            if not req.future.done():
                req.future.set_exception(
                    RuntimeError("BatchServer stopped before decoding"))
        if self._executor is not None:
            # a decode still running in a thread finishes on its own
            self._executor.shutdown(wait=False)

    @property
    def stats(self) -> dict:
        return {"steps": self._steps, "served": self._served,
                "slots": self.slots,
                "pending": len(self._pool) + (self._queue.qsize()
                                                 if self._queue else 0)}

    # -- request path --------------------------------------------------------

    @contextlib.contextmanager
    def session(self):
        """Mark a seek-loop session active for wave coalescing.

        ``transcribe_with_server`` wraps its window loop in this; the
        scheduler then knows how many prompt-carry clients are live and
        waits (bounded by ``TTASR_WAVE_WAIT_MS``) for all of them to
        resubmit before dispatching a partial bulk sweep.
        """
        self._active_sessions += 1
        try:
            yield
        finally:
            self._active_sessions -= 1

    async def transcribe_window(self, audio: np.ndarray,
                                prompt_ids: Sequence[int], *,
                                temperature: float = 0.0,
                                beam_size: Optional[int] = None,
                                without_timestamps: Optional[bool] = None,
                                sample_len: Optional[int] = None,
                                opts: Optional[DecodingOptions] = None,
                                return_enc: bool = False,
                                priority: int = 0,
                                short_window: bool = False) -> WindowResult:
        """Decode one window.  Per-request overrides (beam_size /
        without_timestamps / sample_len, or a full ``opts``) batch with
        other requests that share the same resolved options;
        ``temperature`` picks the fallback rung (> 0 switches from beam to
        sampling).  ``priority`` > 0 (streaming partials) orders the
        request's group ahead of bulk groups between sweeps.
        ``short_window`` encodes a prefix of the 30 s window
        (``window_bucket``), for streaming partials."""
        if opts is None:
            overrides = {}
            if beam_size is not None:
                overrides["beam_size"] = beam_size
            if without_timestamps is not None:
                overrides["without_timestamps"] = without_timestamps
            if sample_len is not None:
                overrides["sample_len"] = sample_len
            opts = (dataclasses.replace(self.opts, **overrides)
                    if overrides else self.opts)
        loop = asyncio.get_running_loop()
        fut: asyncio.Future = loop.create_future()
        ws = (window_bucket(len(np.asarray(audio))) if short_window
              else N_SAMPLES)
        if priority > 0:
            # streaming activity: suspends bulk pre-dispatch (_pipeline_ok)
            self._last_priority_ts = time.time()
        await self._queue.put(WindowRequest(
            audio, list(prompt_ids), fut, loop, opts,
            temperature=float(temperature), return_enc=return_enc,
            priority=int(priority), window_samples=ws,
        ))
        return await fut

    # -- batching loop ---------------------------------------------------------

    def _pipeline_ok(self, pending) -> bool:
        """Whether a second group may dispatch behind the in-flight one.

        A pending priority group is always allowed (dispatching it right
        behind the running decode is strictly sooner than waiting for the
        fetch).  BULK groups pre-dispatch only when (a) no stream has been
        active recently and (b) a fresh queue drain confirmed no unranked
        arrivals: a partial arriving mid-decode must not find an extra
        bulk group already queued on the card ahead of it."""
        if self.pipeline_groups < 2:
            return False
        if any(r.priority > 0 for r in pending):
            # Behind a BULK decode: pre-dispatch.  Behind another PRIORITY
            # sweep while SATURATED: wait for its fetch instead, so
            # partials from unaligned streams coalesce into one next sweep.
            return not (self._prev_is_priority
                        and self._priority_saturated)
        if not self._queue.empty():
            return False          # finish + re-rank with the arrivals
        return (time.time() - self._last_priority_ts) > self._priority_quiet_s

    async def _finish(self, group: List[WindowRequest], fut) -> None:
        """Await an in-flight decode and resolve its requests' futures."""
        try:
            results = await fut
            for req, res in zip(group, results):
                if not req.future.done():
                    req.future.set_result(res)
        except Exception as exc:
            logger.exception("batch decode failed")
            for req in group:
                if not req.future.done():
                    req.future.set_exception(exc)
        gone = {id(r) for r in group}
        self._inflight = [r for r in self._inflight if id(r) not in gone]
        self._steps += 1
        self._served += len(group)
        if any(r.priority > 0 for r in group):
            # PRIORITY arrivals already waiting at a priority fetch: the
            # sweep rate can't keep up with the partial arrival rate (bulk
            # backlog doesn't count)
            qd = getattr(self._queue, "_queue", ()) if self._queue else ()
            self._priority_saturated = (
                any(r.priority > 0 for r in self._pool)
                or any(r.priority > 0 for r in qd))

    async def _run(self) -> None:
        pending = self._pool
        loop = asyncio.get_running_loop()
        prev_group: Optional[List[WindowRequest]] = None
        prev_fut = None                   # in-flight executor future
        while not self._stop:
            if not pending and self._queue.empty():
                if prev_fut is not None:
                    # nothing further to dispatch: drain the in-flight
                    # group (arrivals during it absorb next iteration)
                    await self._finish(prev_group, prev_fut)
                    prev_group = prev_fut = None
                    continue
                pending.append(await self._queue.get())
                deadline = time.time() + self.linger_s
                while len(pending) < self.slots:
                    timeout = deadline - time.time()
                    if timeout <= 0:
                        break
                    try:
                        pending.append(await asyncio.wait_for(
                            self._queue.get(), timeout=timeout))
                    except asyncio.TimeoutError:
                        break
            # absorb everything queued: group ranking must see ALL waiting
            # work so a priority partial that arrived during the previous
            # decode overtakes queued bulk groups
            while True:
                try:
                    pending.append(self._queue.get_nowait())
                except asyncio.QueueEmpty:
                    break
            # coalesce bulk arrivals while host VADs are still running:
            # pending VADs mean more windows are at most seconds away, and
            # a partial bulk sweep costs about as much as a full one.
            # Bounded by starvation_ms; priority partials are never held.
            while (not self._stop and pending
                   and len(pending) < self.slots
                   and prev_fut is None
                   and vad_pending() > 0
                   and not any(r.priority > 0 for r in pending)
                   and (time.time() - min(r.submitted_at for r in pending)
                        < self.starvation_s)):
                try:
                    pending.append(await asyncio.wait_for(
                        self._queue.get(), timeout=0.02))
                except asyncio.TimeoutError:
                    pass
            # wave coalescing: with fewer bulk windows pending than there
            # are active seek-loop sessions, the missing clients were just
            # resolved and resubmit within ms; dispatching before they do
            # phase-locks the server at partial sweeps.  The sleep(0) tick
            # lets just-resolved clients run to their queue.put; the
            # deadline bounds a session stuck in a slow host phase.
            if (pending and prev_fut is None
                    and not any(r.priority > 0 for r in pending)):
                wave_deadline = time.time() + self._wave_wait_s
                while (not self._stop and pending
                       and len(pending) < min(self.slots,
                                              self._active_sessions)
                       and not any(r.priority > 0 for r in pending)
                       and time.time() < wave_deadline
                       and (time.time()
                            - min(r.submitted_at for r in pending)
                            < self.starvation_s)):
                    await asyncio.sleep(0)
                    try:
                        pending.append(await asyncio.wait_for(
                            self._queue.get(), timeout=0.01))
                    except asyncio.TimeoutError:
                        pass
            # saturation gather: the partial arrival rate has outrun the
            # solo-sweep rate; hold the next priority dispatch briefly so
            # concurrent streams' partials share one sweep.  Skipped when
            # unsaturated, so a lone stream keeps its one-sweep latency.
            if (pending and prev_fut is None and self._priority_saturated
                    and any(r.priority > 0 for r in pending)):
                gather_deadline = time.time() + self._partial_gather_s
                while (not self._stop and len(pending) < self.slots
                       and time.time() < gather_deadline):
                    try:
                        pending.append(await asyncio.wait_for(
                            self._queue.get(), timeout=0.02))
                    except asyncio.TimeoutError:
                        pass
            if prev_fut is not None and not any(
                    r.priority > 0 for r in pending):
                # about to consider BULK pre-dispatch: give every ready
                # coroutine one loop tick so an already-scheduled priority
                # transcribe_window lands its put before the decision (the
                # decode threads can starve the loop of the GIL), then
                # re-drain
                await asyncio.sleep(0)
                while True:
                    try:
                        pending.append(self._queue.get_nowait())
                    except asyncio.QueueEmpty:
                        break
            if prev_fut is not None and not self._pipeline_ok(pending):
                # finish the running group FIRST, then re-rank with
                # whatever arrived during it (one group at a time)
                await self._finish(prev_group, prev_fut)
                prev_group = prev_fut = None
                continue
            if not pending:
                continue
            # group compatible requests; decode ONE group per sweep so new
            # arrivals re-rank between sweeps (a slow beam group does not
            # head-of-line-block streaming partials behind it)
            by_key: dict = {}
            for req in pending:
                by_key.setdefault(req.group_key, []).append(req)
            now = time.time()

            def rank(group):
                oldest = min(r.submitted_at for r in group)
                if now - oldest >= self.starvation_s:
                    return (0, 0, oldest)          # starved: age order
                return (1, -max(r.priority for r in group), oldest)

            group = min(by_key.values(), key=rank)
            # slot cap within the group: starved members, then priority,
            # then age (a priority partial sharing a bulk group's key must
            # not lose its slot to older bulk members)
            group.sort(key=lambda r: (
                (0, 0, r.submitted_at)
                if now - r.submitted_at >= self.starvation_s
                else (1, -r.priority, r.submitted_at)))
            group = group[: self.slots]
            if (prev_fut is not None and len(group) < self.slots
                    and not any(r.priority > 0 for r in group)):
                # partial BULK group while a decode is in flight: wait for
                # the decode instead of dispatching now, so arrivals during
                # it coalesce into a fuller group.  Priority partials still
                # dispatch at once.
                await self._finish(prev_group, prev_fut)
                prev_group = prev_fut = None
                continue
            taken = {id(r) for r in group}
            pending[:] = [r for r in pending if id(r) not in taken]
            self._inflight = self._inflight + group
            # Dispatch NOW, then fetch the previous group's results.  Both
            # executor threads enqueue on the device's current stream (no
            # per-group streams), and _decode_batch runs one group's device
            # work at a time: group N+1's slot packing overlaps group N's
            # decode, and the card never runs two groups' kernels at once.
            # The persistent MLP kernel (B4/B14) needs this: its counters
            # are one buffer per device (ops/decoder_mlp.py), and its
            # cooperative launch wants the whole card.
            fut = loop.run_in_executor(self._executor, self._decode_batch, group)
            if prev_fut is not None:
                await self._finish(prev_group, prev_fut)
            prev_group, prev_fut = group, fut
            self._prev_is_priority = any(r.priority > 0 for r in group)

    # -- device work (runs in an executor thread) ------------------------------

    def _decode_batch(self, batch: List[WindowRequest]) -> List[WindowResult]:
        engine = self.engine
        opts, is_beam, is_i16, win = batch[0].group_key
        n = len(batch)
        # int16 groups ship PCM as-is; the device converts
        dt = np.int16 if is_i16 else np.float32
        audio = np.zeros((self.slots, win), dt)
        prompts: List[Sequence[int]] = []
        temps = np.zeros((self.slots,), np.float32)
        for i, req in enumerate(batch):
            a = np.asarray(req.audio, dt)[:win]
            audio[i, : len(a)] = a
            prompts.append(req.prompt_ids)
            temps[i] = req.temperature
        # idle slots: minimal prompt, zero audio
        filler = engine.tokenizer.sot_sequence(
            "zh", "transcribe",
            predict_timestamps=not opts.without_timestamps)
        for _ in range(n, self.slots):
            prompts.append(filler)

        prompt, pad = pad_prompts(prompts, self.ti.eot)
        # unique per dispatch, thread-safe: two pipelined groups may be
        # packing at once and must not share a sampling seed
        with self._rng_lock:
            seed = self._rng_seq
            self._rng_seq += 1
        # One stream: every group's encode, decode and copies are enqueued
        # on the device's current stream, and the engine's device lock (one
        # per engine, shared with its other servers and direct callers) lets
        # one group's work run at a time.  A pipelined group waits here,
        # packed, for the group ahead of it: the eager decode loop from two
        # threads at once takes ~2.5x a step, and B4/B14's counters are one
        # buffer per device.
        with engine._device_lock:
            enc_out = engine.encode_windows(audio, window_samples=win)
            rng = torch.Generator(device=engine.device).manual_seed(seed)
            if is_beam:
                out = engine.run_beam_decode(enc_out, prompt, pad, rng, opts=opts)
            else:
                out = engine.run_greedy_decode(enc_out, prompt, pad, rng, temps,
                                               opts=opts)
            tokens = out["tokens"].cpu().numpy()
            lengths = out["lengths"].cpu().numpy()
            sum_logprob = out["sum_logprob"].cpu().numpy()
            no_speech = out["no_speech_prob"].cpu().numpy()

        results = []
        for i, req in enumerate(batch):
            tl = [int(t) for t in tokens[i, : lengths[i]]]
            results.append(WindowResult(
                tokens=tl,
                sum_logprob=float(sum_logprob[i]),
                avg_logprob=float(sum_logprob[i]) / (len(tl) + 1),
                no_speech_prob=float(no_speech[i]),
                temperature=req.temperature,
                enc=enc_out[i: i + 1] if req.return_enc else None,
            ))
        return results
