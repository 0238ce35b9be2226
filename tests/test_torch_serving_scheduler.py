"""The port's serving layer (``ttasr_torch/engine/serving.py``) on the CPU,
without the JAX package: its parity against JAX is in
``test_torch_serving.py``.

- The int8 ``micro64-test`` engine against itself: a served beam group
  equals a direct ``encode_windows`` + ``run_beam_decode`` of the same
  packed batch bit for bit, and in a mixed-temperature greedy group the
  T = 0 row equals the same row of a direct decode with every row at
  T = 0; ``BatchServer.opts`` carries the engine's int4 and int8 cache
  flags.
- ``decode_stats`` and the launch counters stay exact with two decode
  threads.
- The scheduler, on a stub engine whose decode waits on events: priority
  over bulk, starvation aging, ``stop()`` failing stranded futures, the
  pipelined dispatch and its suspension under a priority stream, coalescing
  while VADs are pending and wave coalescing.  These assert orders and
  counts, never durations.
- The registry shares one engine per (path, compute type, device).
"""

import asyncio
import threading

import numpy as np
import pytest
import torch

from ttasr_torch.engine import registry
from ttasr_torch.engine import serving as t_serving
from ttasr_torch.engine import transcriber as t_tr
from ttasr_torch.engine.transcriber import TranscribeOptions
from ttasr_torch.engine.transcriber import WhisperEngine as TEngine
from ttasr_torch.models.whisper.decode import pad_prompts
from ttasr_torch.ops.mel import N_SAMPLES

from torch_serving_helpers import (  # noqa: F401 (one_torch_thread: autouse)
    NAME,
    PROMPT,
    SAMPLE_LEN,
    TOK,
    one_torch_thread,
    serve,
    speech,
)



@pytest.fixture(scope="module")
def engine_int8():
    return TEngine(NAME, compute_type="int8", tokenizer=TOK, device="cpu")


# -- the int8 engine against its own direct decodes ---------------------------

def _packed(audios, slots, width=N_SAMPLES):
    batch = np.zeros((slots, width), np.float32)
    for i, a in enumerate(audios):
        batch[i, : len(a)] = a[:width]
    return batch


def _prompts(n, slots, prompt=PROMPT):
    filler = TOK.sot_sequence("zh", "transcribe", predict_timestamps=True)
    return pad_prompts([list(prompt)] * n + [filler] * (slots - n), TOK.eot)


def _row(out, i):
    n = int(out["lengths"][i])
    return ([int(t) for t in out["tokens"][i, :n]], float(out["sum_logprob"][i]),
            float(out["no_speech_prob"][i]))


def test_int8_served_beam_group_equals_direct_decode(engine_int8):
    e = engine_int8
    audios = [speech(s, seed) for s, seed in ((6.0, 10), (9.0, 11), (4.0, 12))]
    got = serve(t_serving.BatchServer, e, [(a, PROMPT, {}) for a in audios],
                 slots=4, beam_size=5, sample_len=SAMPLE_LEN, linger_ms=200)
    server = t_serving.BatchServer(e, slots=4, beam_size=5, sample_len=SAMPLE_LEN)
    enc = e.encode_windows(_packed(audios, 4))
    prompt, pad = _prompts(3, 4)
    out = e.run_beam_decode(enc, prompt, pad,
                            torch.Generator().manual_seed(0), opts=server.opts)
    for i, res in enumerate(got):
        tokens, sum_logprob, no_speech = _row(out, i)
        assert res.tokens == tokens
        assert res.sum_logprob == sum_logprob
        assert res.no_speech_prob == no_speech


def test_int8_mixed_temperature_group_keeps_the_t0_row(engine_int8):
    """Greedy rows at T = 0 and T > 0 share one group; the T = 0 row equals
    the same row of the same packed batch decoded with every row at T = 0."""
    e = engine_int8
    audios = [speech(s, seed) for s, seed in ((7.0, 13), (7.0, 14), (7.0, 15))]
    temps = (0.0, 0.6, 1.0)
    got = serve(t_serving.BatchServer, e,
                 [(a, PROMPT, dict(temperature=t)) for a, t in zip(audios, temps)],
                 slots=4, beam_size=1, sample_len=SAMPLE_LEN, linger_ms=200)
    assert [r.temperature for r in got] == list(temps)
    server = t_serving.BatchServer(e, slots=4, beam_size=1, sample_len=SAMPLE_LEN)
    enc = e.encode_windows(_packed(audios, 4))
    prompt, pad = _prompts(3, 4)
    out = e.run_greedy_decode(enc, prompt, pad, None, np.zeros(4, np.float32),
                              opts=server.opts)
    tokens, sum_logprob, no_speech = _row(out, 0)
    assert got[0].tokens == tokens
    assert got[0].sum_logprob == sum_logprob
    assert got[0].no_speech_prob == no_speech


def test_server_opts_carry_the_engines_cache_flags(engine_int8, monkeypatch):
    """The reference once built the served DecodingOptions without the int4
    flags; the port's server must decode as ``_decode_window`` does."""
    e = engine_int8
    seen = []

    def spy(enc_out, prompt, pad, rng, opts):
        seen.append(opts)
        return {"tokens": torch.zeros((1, 1), dtype=torch.long),
                "lengths": torch.zeros(1, dtype=torch.long),
                "sum_logprob": torch.zeros(1), "no_speech_prob": torch.zeros(1)}

    monkeypatch.setattr(e, "run_beam_decode", spy)
    e._decode_window(torch.zeros((1, 1500, 128)), PROMPT, TranscribeOptions(), 0.0)
    server = t_serving.BatchServer(e, slots=4, beam_size=5)
    window = seen[0]
    assert window.kv_int8 and window.cross_kv_int8
    assert window.kv_int4 and window.cross_kv_int4
    for flag in ("kv_int8", "cross_kv_int8", "cross_kv_int4", "kv_int4"):
        assert getattr(server.opts, flag) == getattr(window, flag), flag
    assert server.opts == e._decoding_options(TranscribeOptions())


# -- counting with two decode threads -----------------------------------------

def test_decode_stats_exact_with_two_decode_threads(engine_int8):
    """``pipeline_groups=2`` over a stream of groups: the engine's counts
    equal the sums over the decodes the server ran."""
    e = engine_int8
    outs = []
    beam, greedy = e.run_beam_decode, e.run_greedy_decode

    def record(fn):
        def wrapped(*args, **kwargs):
            out = fn(*args, **kwargs)
            outs.append(("beam" if fn is beam else "greedy", out["steps"]))
            return out
        return wrapped

    e.run_beam_decode, e.run_greedy_decode = record(beam), record(greedy)
    before = dict(e.decode_stats)
    try:
        requests = [(speech(3.0, 20 + i), PROMPT,
                     dict(beam_size=1 + 4 * (i % 2), sample_len=8 + 8 * (i % 3)))
                    for i in range(12)]
        got = serve(t_serving.BatchServer, e, requests, slots=2, beam_size=5,
                     pipeline_groups=2)
    finally:
        del e.run_beam_decode, e.run_greedy_decode
    assert len(got) == 12
    stats = e.decode_stats
    for kind in ("beam", "greedy"):
        ran = [s for k, s in outs if k == kind]
        assert ran
        assert stats[f"{kind}_decodes"] - before[f"{kind}_decodes"] == len(ran)
        assert stats[f"{kind}_steps"] - before[f"{kind}_steps"] == sum(ran)
    assert stats["encoder_passes"] - before["encoder_passes"] == len(outs)


def test_count_launch_is_exact_across_threads():
    from ttasr_torch.ops._build import count_launch

    def fn():
        pass

    fn.launches = 0

    def work():
        for _ in range(20000):
            count_launch(fn)

    threads = [threading.Thread(target=work) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert fn.launches == 8 * 20000


# -- the scheduler, on a stub engine ------------------------------------------

class _TI:
    eot = 50257


class StubEngine:
    ti = _TI()
    kv_cache_int8 = False


class Gate:
    """A stand-in for ``_decode_batch`` that records each group and can
    hold the first call until released."""

    def __init__(self, hold_first=True):
        self.groups = []            # (priorities,) per call, in call order
        self.entered = threading.Event()
        self.release = threading.Event()
        self.hold_first = hold_first
        self.inflight = 0
        self.max_inflight = 0
        self._lock = threading.Lock()
        self.second = threading.Event()

    def __call__(self, batch):
        with self._lock:
            self.groups.append(tuple(r.priority for r in batch))
            first = len(self.groups) == 1
            self.inflight += 1
            self.max_inflight = max(self.max_inflight, self.inflight)
            if len(self.groups) == 2:
                self.second.set()
        self.entered.set()
        if first and self.hold_first:
            self.release.wait(60)
        with self._lock:
            self.inflight -= 1
        return [t_serving.WindowResult(tokens=[1], sum_logprob=-0.1,
                                       avg_logprob=-0.05, no_speech_prob=0.0)
                for _ in batch]


async def _until(event):
    while not event.is_set():
        await asyncio.sleep(0.001)


def _window():
    return np.zeros(1600, np.float32)


def test_priority_overtakes_queued_bulk():
    gate = Gate()

    async def run():
        server = t_serving.BatchServer(StubEngine(), slots=1, linger_ms=1,
                                       pipeline_groups=1,
                                       starvation_ms=600000.0)
        server._decode_batch = gate
        await server.start()
        try:
            first = asyncio.ensure_future(server.transcribe_window(_window(), [1]))
            await _until(gate.entered)
            bulk = [asyncio.ensure_future(server.transcribe_window(_window(), [1]))
                    for _ in range(3)]
            hot = asyncio.ensure_future(
                server.transcribe_window(_window(), [1], priority=1))
            await asyncio.sleep(0)
            await asyncio.sleep(0)
            gate.release.set()
            await asyncio.gather(first, hot, *bulk)
        finally:
            await server.stop()

    asyncio.run(run())
    assert gate.groups == [(0,), (1,), (0,), (0,), (0,)]


def test_starved_bulk_beats_priority():
    gate = Gate()

    async def run():
        server = t_serving.BatchServer(StubEngine(), slots=1, linger_ms=1,
                                       pipeline_groups=1, starvation_ms=50.0)
        server._decode_batch = gate
        await server.start()
        try:
            first = asyncio.ensure_future(server.transcribe_window(_window(), [1]))
            await _until(gate.entered)
            old = asyncio.ensure_future(server.transcribe_window(_window(), [1]))
            await asyncio.sleep(0.1)      # the bulk request ages past 50 ms
            hot = [asyncio.ensure_future(
                server.transcribe_window(_window(), [1], priority=1))
                for _ in range(3)]
            await asyncio.sleep(0)
            gate.release.set()
            await asyncio.gather(first, old, *hot)
        finally:
            await server.stop()

    asyncio.run(run())
    assert gate.groups[:2] == [(0,), (0,)]
    assert gate.groups[2:] == [(1,)] * 3


def test_stop_fails_stranded_requests():
    gate = Gate()

    async def run():
        server = t_serving.BatchServer(StubEngine(), slots=1, linger_ms=1,
                                       pipeline_groups=1)
        server._decode_batch = gate
        await server.start()
        futs = [asyncio.ensure_future(server.transcribe_window(_window(), [1]))]
        await _until(gate.entered)
        futs += [asyncio.ensure_future(server.transcribe_window(_window(), [1]))
                 for _ in range(2)]
        await asyncio.sleep(0)
        await server.stop()
        gate.release.set()
        return await asyncio.gather(*futs, return_exceptions=True)

    results = asyncio.run(run())
    assert len(results) == 3
    assert all(isinstance(r, RuntimeError) and "stopped" in str(r) for r in results)


def test_pipelined_dispatch_overlaps_bulk_groups():
    """With two pipeline groups and no stream, the second bulk group is
    dispatched while the first is still in its decode."""
    gate = Gate()

    async def run():
        server = t_serving.BatchServer(StubEngine(), slots=1, linger_ms=1,
                                       pipeline_groups=2)
        server._decode_batch = gate
        await server.start()
        try:
            futs = [asyncio.ensure_future(server.transcribe_window(_window(), [1]))
                    for _ in range(3)]
            await _until(gate.second)        # dispatched behind the held one
            overlapped = gate.max_inflight == 2 and not gate.release.is_set()
            gate.release.set()
            await asyncio.gather(*futs)
            return overlapped
        finally:
            await server.stop()

    assert asyncio.run(run())
    assert gate.max_inflight == 2 and len(gate.groups) == 3


class DeviceStub(StubEngine):
    """An engine whose encode waits (bounded) for a second group to be
    dispatched, and that records how many groups are on the device."""

    device = torch.device("cpu")

    class tokenizer:
        @staticmethod
        def sot_sequence(*args, **kwargs):
            return [1]

    def __init__(self):
        self._device_lock = threading.RLock()   # as WhisperEngine's
        self.lock = threading.Lock()
        self.active = self.max_active = self.done = 0
        self.second = threading.Event()

    def encode_windows(self, audio, window_samples=None):
        with self.lock:
            self.active += 1
            self.max_active = max(self.max_active, self.active)
        self.second.wait(10)
        return torch.zeros((audio.shape[0], 1, 1))

    def run_beam_decode(self, enc_out, prompt, pad, rng, opts):
        with self.lock:
            self.active -= 1
            self.done += 1
        rows = enc_out.shape[0]
        return {"tokens": torch.zeros((rows, 1), dtype=torch.long),
                "lengths": torch.zeros(rows, dtype=torch.long),
                "sum_logprob": torch.zeros(rows), "no_speech_prob": torch.zeros(rows)}


def test_pipelined_groups_take_the_device_one_at_a_time():
    """The second group is dispatched while the first decodes, and waits
    for it before its own device work: never two groups' launches at once."""
    engine = DeviceStub()
    entered = []

    async def run():
        server = t_serving.BatchServer(engine, slots=1, linger_ms=1,
                                       pipeline_groups=2)
        real = server._decode_batch

        def dispatched(batch):
            entered.append(engine.done)
            if len(entered) == 2:
                engine.second.set()
            return real(batch)

        server._decode_batch = dispatched
        await server.start()
        try:
            await asyncio.gather(*[server.transcribe_window(_window(), [1])
                                   for _ in range(3)])
        finally:
            await server.stop()

    asyncio.run(run())
    assert entered[:2] == [0, 0]   # the second was dispatched before the first finished
    assert engine.max_active == 1


def test_two_servers_on_one_engine_take_the_device_one_at_a_time():
    """The device lock is the engine's: two servers over one engine (the
    CLI's and a pipeline's, say) each dispatch a group, and the groups'
    device work still runs one at a time."""
    engine = DeviceStub()
    entered = []

    async def run():
        servers = [t_serving.BatchServer(engine, slots=1, linger_ms=1, pipeline_groups=1)
                   for _ in range(2)]
        for server in servers:
            real = server._decode_batch

            def dispatched(batch, real=real):
                entered.append(engine.done)
                if len(entered) == 2:
                    engine.second.set()
                return real(batch)

            server._decode_batch = dispatched
            await server.start()
        try:
            await asyncio.gather(*[server.transcribe_window(_window(), [1])
                                   for server in servers])
        finally:
            for server in servers:
                await server.stop()

    asyncio.run(run())
    assert entered == [0, 0]       # both dispatched before either finished
    assert engine.max_active == 1


def test_direct_engine_calls_share_the_device_lock(engine_int8):
    """A direct ``encode_windows`` waits while another caller holds the
    engine's device lock, as a server's group does."""
    e = engine_int8
    done = threading.Event()
    worker = threading.Thread(
        target=lambda: (e.encode_windows(speech(1.0, 5)), done.set()))
    with e._device_lock:
        worker.start()
        held_off = not done.wait(0.2)
    worker.join(120)
    assert held_off and done.is_set()


@pytest.mark.parametrize("pipeline_groups,stream", [(2, True), (1, False)],
                         ids=["priority-stream", "knob-off"])
def test_one_group_at_a_time(pipeline_groups, stream):
    """A recent priority stream (or ``pipeline_groups=1``) suspends bulk
    pre-dispatch: the held first group is the only one in flight until it
    is released."""
    gate = Gate(hold_first=False)

    async def run():
        server = t_serving.BatchServer(StubEngine(), slots=1, linger_ms=1,
                                       pipeline_groups=pipeline_groups)
        server._priority_quiet_s = 3600.0   # the stream stays recent
        server._decode_batch = gate
        await server.start()
        try:
            if stream:
                await server.transcribe_window(_window(), [1], priority=1)
            gate.hold_first = True
            gate.groups.clear()
            gate.entered.clear()
            futs = [asyncio.ensure_future(server.transcribe_window(_window(), [1]))
                    for _ in range(3)]
            await _until(gate.entered)
            for _ in range(20):
                await asyncio.sleep(0.005)   # room for a wrong pre-dispatch
            alone = len(gate.groups) == 1
            gate.release.set()
            await asyncio.gather(*futs)
            return alone
        finally:
            await server.stop()

    assert asyncio.run(run())
    assert gate.max_inflight == 1


def test_bulk_coalesces_while_vad_pending(monkeypatch):
    gate = Gate(hold_first=False)

    async def run():
        server = t_serving.BatchServer(StubEngine(), slots=4, linger_ms=1,
                                       starvation_ms=600000.0)
        server._decode_batch = gate
        await server.start()
        try:
            monkeypatch.setattr(t_tr, "_VAD_PENDING", 1)
            futs = [asyncio.ensure_future(server.transcribe_window(_window(), [1]))]
            for _ in range(20):
                await asyncio.sleep(0.005)   # alone, it would dispatch now
            futs += [asyncio.ensure_future(server.transcribe_window(_window(), [1]))
                     for _ in range(2)]
            for _ in range(5):
                await asyncio.sleep(0.005)
            held = len(gate.groups)
            monkeypatch.setattr(t_tr, "_VAD_PENDING", 0)
            await asyncio.gather(*futs)
            return held
        finally:
            await server.stop()

    assert asyncio.run(run()) == 0
    assert gate.groups == [(0, 0, 0)]


def test_vad_pending_never_holds_priority(monkeypatch):
    gate = Gate(hold_first=False)

    async def run():
        server = t_serving.BatchServer(StubEngine(), slots=4, linger_ms=1,
                                       starvation_ms=600000.0)
        server._decode_batch = gate
        await server.start()
        try:
            monkeypatch.setattr(t_tr, "_VAD_PENDING", 1)
            await server.transcribe_window(_window(), [1], priority=1)
        finally:
            await server.stop()

    asyncio.run(run())    # returns while the VAD count stays up
    assert gate.groups == [(1,)]


def test_wave_coalescing_waits_for_every_session():
    """Three seek-loop sessions are live: a bulk sweep waits for all three
    windows instead of dispatching the first alone."""
    gate = Gate(hold_first=False)

    async def run():
        server = t_serving.BatchServer(StubEngine(), slots=4, linger_ms=1,
                                       starvation_ms=600000.0)
        server._wave_wait_s = 600.0
        server._decode_batch = gate
        await server.start()
        try:
            with server.session(), server.session(), server.session():
                futs = [asyncio.ensure_future(
                    server.transcribe_window(_window(), [1]))]
                for _ in range(20):
                    await asyncio.sleep(0.005)
                futs += [asyncio.ensure_future(
                    server.transcribe_window(_window(), [1])) for _ in range(2)]
                await asyncio.gather(*futs)
        finally:
            await server.stop()

    asyncio.run(run())
    assert gate.groups == [(0, 0, 0)]


def test_shared_server_is_one_per_engine_and_loop():
    async def run():
        e = StubEngine()
        a = await t_serving.shared_server(e, slots=2)
        b = await t_serving.shared_server(e, slots=2)
        other = await t_serving.shared_server(StubEngine(), slots=2)
        await a.stop()
        c = await t_serving.shared_server(e, slots=2)
        for srv in (b, other, c):
            await srv.stop()
        return a, b, other, c

    a, b, other, c = asyncio.run(run())
    assert a is b and other is not a and c is not a


# -- the registry ---------------------------------------------------------------

def test_registry_shares_one_engine_per_key(monkeypatch):
    registry.reset_engines()
    try:
        a = registry.get_engine(NAME, compute_type="float32", device="cpu")
        b = registry.get_engine(NAME, compute_type="float32", device="cpu")
        c = registry.get_engine(NAME, compute_type="int8", device="cpu")
        assert a is b and c is not a
        assert a.device.type == "cpu" and c.compute_type == "int8"
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA"):
            registry.get_engine(NAME, compute_type="float32")
    finally:
        registry.reset_engines()
