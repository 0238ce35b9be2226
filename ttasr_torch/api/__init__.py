"""HTTP/WS product surface (port of ``ttasr/api/``).

aiohttp-based replacement for the reference FastAPI stack (api/app.py,
api/file_asr.py, api/auth_api.py, api/streaming_asr.py): same routes,
status codes, payload shapes and env vars; JWT and pbkdf2_sha256 are
stdlib implementations, copied from the JAX package.  The engine behind
the routes is the port's ``WhisperEngine`` on the card
(``TTASR_MODEL_DEVICE``, default ``cuda``).
"""
