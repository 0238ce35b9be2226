"""What ``test_torch_serving.py`` and ``test_torch_serving_scheduler.py``
share: the byte-fallback tokenizer, the micro model's name, the request
prompt, synthesized speech, a server run over a set of requests, and one
torch thread per module."""

import asyncio

import numpy as np
import pytest
import torch

from tools.train_vad import synth_speech
from ttasr.text.tokenizer import build_byte_fallback_tokenizer

TOK = build_byte_fallback_tokenizer()
NAME = "micro64-test"
SAMPLE_LEN = 32  # tokens per window in the request-level cases
PROMPT = TOK.sot_sequence("zh", predict_timestamps=True)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The micro model's eager ops run faster on one thread, and the suite
    runs several workers to a machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def speech(seconds, seed):
    return synth_speech(np.random.default_rng(seed), seconds)[0]


def serve(server_cls, engine, requests, **server_kw):
    """``requests``: (audio, prompt, transcribe_window kwargs); all are
    submitted at once to one server; returns the results in order."""
    async def run():
        server = server_cls(engine, **server_kw)
        await server.start()
        try:
            return await asyncio.gather(*[
                server.transcribe_window(a, p, **kw) for a, p, kw in requests])
        finally:
            await server.stop()

    return asyncio.run(run())
