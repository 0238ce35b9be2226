"""Combined ASR API application (port of ``ttasr/api/app.py``).

    python -m ttasr_torch.api.app        # TTASR_API_PORT, default 5000

Parity surface: reference api/app.py — one port-5000 app exposing:
- the file task API routes (``/api/...``),
- the auth routes (``/api/v1/...``),
- the streaming app mounted under ``/stream`` (``/stream/ws/stt``,
  ``/stream/health``), and
- the streaming WS re-registered at ``/ws/v1/transcript`` (app.py:28-30).

Startup runs auth bootstrap, the tasks schema init, and the streaming
background init (the reference's manually composed lifespan, app.py:33-64).
The task API and the stream resolve to one ``WhisperEngine`` on
``config.MODEL_DEVICE`` (default ``cuda``) and one ``BatchServer``.
"""

from __future__ import annotations

import logging
import os
from typing import Optional

from aiohttp import web

from ttasr_torch import resolve_device
from ttasr_torch.api import config, file_tasks
from ttasr_torch.api.auth import add_auth_routes, auth_error_middleware, auth_startup
from ttasr_torch.api.streaming_ws import StreamingService, make_streaming_app

logger = logging.getLogger("ttasr_torch.api.app")


def create_app(streaming_service: Optional[StreamingService] = None
               ) -> web.Application:
    app = web.Application(middlewares=[auth_error_middleware])

    # file task API + auth routes on the root app
    file_tasks.add_task_routes(app)
    add_auth_routes(app)

    # streaming sub-app under /stream
    streaming_app, service = make_streaming_app(streaming_service)
    app.add_subapp("/stream", streaming_app)
    app["streaming_service"] = service

    # WS alias at /ws/v1/transcript (reference app.py:28-30)
    app.router.add_get("/ws/v1/transcript", service.websocket_handler)

    async def _startup(_app):
        try:
            auth_startup()
        except Exception:
            logger.exception("auth startup failed")
        try:
            file_tasks.ensure_tasks_schema()
        except Exception:
            logger.exception("task schema init failed")
        # streaming startup runs via the sub-app's own on_startup hook

    app.on_startup.append(_startup)
    return app


def main() -> None:  # pragma: no cover
    logging.basicConfig(level=logging.INFO)
    # without CUDA this raises unless TTASR_MODEL_DEVICE=cpu is set
    resolve_device(config.MODEL_DEVICE)
    app = create_app()
    port = int(os.getenv("TTASR_API_PORT", "5000"))
    web.run_app(app, host="0.0.0.0", port=port)


if __name__ == "__main__":  # pragma: no cover
    main()
