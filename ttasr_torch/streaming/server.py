"""Standalone WebSocket streaming server (raw ``websockets`` transport).

The reference ships a legacy entry point (api/stt_streaming/src/main.py)
that imports a ``Server`` class which does not exist anywhere in the
repo (a vestige of upstream VoiceStreamAI — SURVEY.md §2.1).  This is
the working equivalent: a minimal server over the ``websockets`` library
with the same constructor signature and per-connection flow as the
aiohttp endpoint (Client + VAD + ASR pipelines, binary PCM frames, JSON
config messages).
"""

from __future__ import annotations

import asyncio
import base64
import json
import logging
import time
import uuid
from typing import List, Optional

from ttasr_torch.streaming.client import Client

logger = logging.getLogger("ttasr_torch.streaming.server")


class Server:
    """``Server(vad_pipeline, asr_pipeline, host, port, sampling_rate,
    samples_width)`` — the constructor the reference's main.py expects."""

    def __init__(self, vad_pipeline, asr_pipeline, host: str = "127.0.0.1",
                 port: int = 8765, sampling_rate: int = 16000,
                 samples_width: int = 2, max_clients: int = 10):
        self.vad_pipeline = vad_pipeline
        self.asr_pipeline = asr_pipeline
        self.host = host
        self.port = port
        self.sampling_rate = sampling_rate
        self.samples_width = samples_width
        self.max_clients = max_clients
        self.connected_clients: List[Client] = []

    async def handle_connection(self, websocket) -> None:
        if len(self.connected_clients) >= self.max_clients:
            await websocket.send(json.dumps(
                {"code": 400, "description": "exceeded number of connections"},
                ensure_ascii=False,
            ))
            await websocket.close()
            return

        connection_id = str(uuid.uuid4())
        client = Client(connection_id, self.sampling_rate, self.samples_width,
                        f"job_{int(time.time())}", 0, [])
        client.connection_id = connection_id
        self.connected_clients.append(client)
        await websocket.send(json.dumps(
            {"id": connection_id, "code": 100, "message": "服務準備中"},
            ensure_ascii=False,
        ))
        try:
            async for message in websocket:
                if isinstance(message, (bytes, bytearray)):
                    client.append_audio_data(bytes(message))
                else:
                    try:
                        data = json.loads(message)
                    except json.JSONDecodeError:
                        continue
                    if data.get("type") == "config" and isinstance(
                        data.get("data"), dict
                    ):
                        cfg = data["data"]
                        update = {
                            k: cfg[k]
                            for k in ("language", "processing_strategy",
                                      "processing_args")
                            if cfg.get(k)
                        }
                        if update:
                            client.update_config(update)
                        await websocket.send(json.dumps(
                            {"code": 200, "description": "config 已更新"},
                            ensure_ascii=False,
                        ))
                        continue
                    elif data.get("audio"):
                        try:
                            client.append_audio_data(base64.b64decode(data["audio"]))
                        except Exception:
                            continue
                    else:
                        continue
                client.process_audio(websocket, self.vad_pipeline,
                                     self.asr_pipeline)
        finally:
            self.connected_clients = [
                c for c in self.connected_clients
                if c.client_id != client.client_id
            ]

    async def serve(self) -> None:
        import websockets

        async with websockets.serve(self.handle_connection, self.host, self.port):
            logger.info("streaming server on ws://%s:%d", self.host, self.port)
            await asyncio.Future()  # run forever

    def start(self) -> None:  # pragma: no cover - blocking entry
        asyncio.run(self.serve())
