"""Realtime streaming WebSocket server (port of ``ttasr/api/streaming_ws.py``).

Parity surface: reference api/streaming_asr.py —
- WS endpoint ``/ws/stt`` (re-exposed as ``/ws/v1/transcript`` by the
  combined app), token query param, 10-connection cap (:70-75,351),
- handshake messages ``{"id", "code": 100, "message": "服務準備中"}`` then
  ``{"id", "taskId", "code": 180, "message": "服務已就緒"}`` (:378-423),
- receive loop: binary PCM frames, JSON config updates, base64 audio
  (:197-328),
- non-blocking background init of VAD/ASR gated by ``FASTAPI_SKIP_INIT``
  / ``FASTAPI_WARMUP`` / ``FASTAPI_ASR_MODEL_SIZE`` (:89-155),
- ``/health`` exposing pipeline/device/compute state (:445-466).
"""

from __future__ import annotations

import asyncio
import base64
import json
import logging
import os
import random
import time
import uuid
from typing import List, Optional

from aiohttp import WSMsgType, web

from ttasr_torch.streaming.asr.asr_factory import ASRFactory
from ttasr_torch.streaming.client import Client
from ttasr_torch.streaming.vad.vad_factory import VADFactory

logger = logging.getLogger("ttasr_torch.api.streaming")


class ResponseCode:
    SUCCESS = 200
    BAD_REQUEST = 400
    UNAUTHORIZED = 401
    TIMEOUT = 408


class Settings:
    def __init__(self):
        self.max_streaming_count = int(os.getenv("TTASR_MAX_STREAMS", "10"))


class StreamingService:
    """Holds pipelines + connection state (the reference's module globals)."""

    def __init__(self):
        self.settings = Settings()
        self.connected_clients: List[Client] = []
        self.vad_pipeline = None
        self.asr_pipeline = None
        self.batch_server = None
        self.asr_ready_event: Optional[asyncio.Event] = None

    # -- lifecycle -----------------------------------------------------------

    async def startup_event(self) -> None:
        """Non-blocking init (reference streaming_asr.py:89-155)."""
        self.asr_ready_event = asyncio.Event()
        if os.getenv("FASTAPI_SKIP_INIT", "0") in ("1", "true", "True"):
            logger.warning("skipping VAD/ASR init (FASTAPI_SKIP_INIT=1)")
            return
        asyncio.get_running_loop().create_task(self._initialize_background())

    async def _initialize_background(self) -> None:
        try:
            self.vad_pipeline = VADFactory.create_vad_pipeline(
                os.getenv("TTASR_VAD_TYPE", "simple"), min_duration=0.1
            )
            logger.info("VAD pipeline ready")
        except Exception:
            self.vad_pipeline = None
            logger.exception("VAD init failed")

        model_size = os.getenv("FASTAPI_ASR_MODEL_SIZE", "models")
        warmup = os.getenv("FASTAPI_WARMUP", "0") in ("1", "true", "True")
        try:
            self.asr_pipeline = ASRFactory.create_asr_pipeline(
                "torch_whisper", model_size=model_size
            )
            # Continuous batching: concurrent streams pack into fixed
            # decode slots (TTASR_BATCH_SLOTS=0 disables).
            slots = int(os.getenv("TTASR_BATCH_SLOTS", "4"))
            if slots > 0:
                from ttasr_torch.engine.serving import shared_server

                # process-wide server: task-API uploads on the same
                # engine pack into these same decode slots
                self.batch_server = await shared_server(
                    self.asr_pipeline.engine, slots=slots, beam_size=5
                )
                self.asr_pipeline.server = self.batch_server
            logger.info("ASR pipeline ready")
            if not warmup:
                self.asr_ready_event.set()
        except Exception:
            self.asr_pipeline = None
            logger.exception("ASR init failed")

        if self.asr_pipeline is not None and warmup:
            try:
                if hasattr(self.asr_pipeline, "warm_up_async"):
                    # warms both token-budget buckets through the same
                    # (possibly batched) path live chunks take
                    await self.asr_pipeline.warm_up_async()
                else:
                    await asyncio.get_running_loop().run_in_executor(
                        None, self.asr_pipeline.warm_up
                    )
            except Exception:
                logger.exception("warm-up failed")
            finally:
                self.asr_ready_event.set()

    async def shutdown_event(self) -> None:
        for client in self.connected_clients:
            logger.info("cleaning client %s", client.client_id)
        self.connected_clients.clear()
        if self.batch_server is not None:
            await self.batch_server.stop()

    # -- websocket -----------------------------------------------------------

    async def websocket_handler(self, request: web.Request) -> web.WebSocketResponse:
        ws = web.WebSocketResponse()
        await ws.prepare(request)

        token = request.query.get("token")
        if not token:
            await ws.send_str(json.dumps(
                {"code": ResponseCode.BAD_REQUEST, "description": "token is required"},
                ensure_ascii=False,
            ))
            await ws.close()
            return ws
        user_id = token

        if len(self.connected_clients) >= self.settings.max_streaming_count:
            await ws.send_str(json.dumps(
                {"code": ResponseCode.BAD_REQUEST,
                 "description": "exceeded number of connections"},
                ensure_ascii=False,
            ))
            await ws.close()
            return ws

        job_id = f"job_{int(time.time())}"
        connection_id = str(uuid.uuid4())
        task_id = random.randint(100000, 999999)
        client = Client(user_id, 16000, 2, job_id, 0, [])
        client.connection_id = connection_id

        # Advanced query params (documented by the reference README:508-523
        # but unimplemented there): enableTransient -> final=0 partials;
        # charactersToNumbers -> zh numerals to Arabic in transcripts;
        # rate -> input sampling rate.
        query = request.query
        if query.get("enableTransient") == "1":
            args = dict(client.config["processing_args"])
            args["enable_transient"] = True
            client.update_config({"processing_args": args})
        client.characters_to_numbers = query.get("charactersToNumbers") == "1"
        if query.get("rate") in ("8000", "16000"):
            client.sampling_rate = int(query["rate"])
        self.connected_clients.append(client)
        logger.info("client connected: user=%s job=%s task=%s", user_id, job_id, task_id)

        try:
            await ws.send_str(json.dumps(
                {"id": connection_id, "code": 100, "message": "服務準備中"},
                ensure_ascii=False,
            ))
        except Exception:
            logger.exception("failed to send 服務準備中")

        async def _notify_ready():
            try:
                if self.asr_ready_event is not None:
                    await self.asr_ready_event.wait()
                await ws.send_str(json.dumps(
                    {"id": connection_id, "taskId": task_id, "code": 180,
                     "message": "服務已就緒"},
                    ensure_ascii=False,
                ))
            except Exception:
                logger.exception("failed to send 服務已就緒")

        notify_task = asyncio.get_running_loop().create_task(_notify_ready())

        try:
            await self._handle_audio(client, ws)
        finally:
            notify_task.cancel()
            duration = time.time() - client.start_time if client.start_time else 0
            logger.info(
                "connection closed: user=%s job=%s duration=%.1fs",
                client.client_id, job_id, duration,
            )
            self.connected_clients = [
                c for c in self.connected_clients
                if c.client_id != client.client_id
            ]
        return ws

    async def _handle_audio(self, client: Client, ws: web.WebSocketResponse) -> None:
        """Receive loop (reference streaming_asr.py:197-328)."""
        async for msg in ws:
            if msg.type == WSMsgType.BINARY:
                if msg.data:
                    client.append_audio_data(msg.data)
            elif msg.type == WSMsgType.TEXT:
                try:
                    message_data = json.loads(msg.data)
                except json.JSONDecodeError:
                    logger.error("invalid JSON message: %s", msg.data[:200])
                    continue
                if message_data.get("type") == "config" and isinstance(
                    message_data.get("data"), dict
                ):
                    cfg = message_data["data"]
                    config_update = {}
                    for key in ("language", "processing_strategy"):
                        if cfg.get(key):
                            config_update[key] = cfg[key]
                    if isinstance(cfg.get("processing_args"), dict):
                        config_update["processing_args"] = cfg["processing_args"]
                    if config_update:
                        client.update_config(config_update)
                    if isinstance(cfg.get("sampleRate"), (int, float)):
                        client.sampling_rate = int(cfg["sampleRate"])
                    await ws.send_str(json.dumps(
                        {"code": ResponseCode.SUCCESS, "description": "config 已更新"},
                        ensure_ascii=False,
                    ))
                    continue
                elif message_data.get("audio"):
                    try:
                        client.append_audio_data(
                            base64.b64decode(message_data["audio"])
                        )
                    except Exception:
                        logger.error("base64 audio decode failed")
                        continue
                else:
                    logger.warning("unknown message: %s", message_data)
                    continue
            elif msg.type in (WSMsgType.CLOSE, WSMsgType.CLOSING, WSMsgType.ERROR):
                break
            else:
                continue

            if self.vad_pipeline is None or self.asr_pipeline is None:
                await ws.send_str(json.dumps(
                    {
                        "code": ResponseCode.SUCCESS,
                        "description": "audio received (ASR/VAD not initialized)",
                        "data": {"buffer_bytes": len(client.buffer)},
                    },
                    ensure_ascii=False,
                ))
            else:
                client.process_audio(ws, self.vad_pipeline, self.asr_pipeline)

    # -- http ----------------------------------------------------------------

    async def root(self, _request: web.Request) -> web.Response:
        return web.json_response({"message": "STT Streaming API", "version": "1.0.0"})

    async def health_check(self, _request: web.Request) -> web.Response:
        details = {
            "status": "healthy",
            "connected_clients": len(self.connected_clients),
            "vad_pipeline": "ready" if self.vad_pipeline else "not_ready",
            "asr_pipeline": "ready" if self.asr_pipeline else "not_ready",
        }
        if self.asr_pipeline is not None:
            details.update({
                "asr_device": getattr(self.asr_pipeline, "device", None),
                "asr_compute_type": getattr(self.asr_pipeline, "compute_type", None),
                "asr_model_size": getattr(self.asr_pipeline, "model_size", None),
            })
        return web.json_response(details)


def make_streaming_app(service: Optional[StreamingService] = None
                       ) -> tuple:
    """Build the standalone streaming app; returns (app, service)."""
    service = service or StreamingService()
    app = web.Application()
    app.router.add_get("/ws/stt", service.websocket_handler)
    app.router.add_get("/", service.root)
    app.router.add_get("/health", service.health_check)

    async def _startup(_app):
        await service.startup_event()

    async def _shutdown(_app):
        await service.shutdown_event()

    app.on_startup.append(_startup)
    app.on_shutdown.append(_shutdown)
    return app, service


def main() -> None:  # pragma: no cover
    logging.basicConfig(level=logging.INFO)
    app, _ = make_streaming_app()
    host = os.getenv("FASTAPI_HOST", "127.0.0.1")
    try:
        port = int(os.getenv("FASTAPI_PORT", "8000"))
    except ValueError:
        port = 8000
    web.run_app(app, host=host, port=port)


if __name__ == "__main__":  # pragma: no cover
    main()
