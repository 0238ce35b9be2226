"""Typed configuration tree with env-var overrides.

The reference scatters config across four mechanisms (env vars, module
constants, HF dataclasses, per-client WS JSON — SURVEY.md §5).  This
module unifies the service-level knobs into one dataclass tree while
keeping every documented reference env var name working:

- ``ASR_API_{AUTH_DB,JWT_SECRET,JWT_ALGORITHM,BOOTSTRAP_ADMIN_*,
  RESET_ADMIN_ON_STARTUP}`` (auth_api.py:18-20,129-131,160)
- ``FASTAPI_{SKIP_INIT,WARMUP,ASR_MODEL_SIZE,HOST,PORT}``
  (streaming_asr.py:99,116,124,497-499)
- ``BUFFERING_CHUNK_{LENGTH,OFFSET}_SECONDS`` (buffering_strategies.py:32-40)
plus the framework's additions (``TTASR_*``).  A copy of
``ttasr/core/config.py`` whose one change is the model's device default:
``cuda``.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional


def _env(name: str, default: str) -> str:
    return os.getenv(name, default)


def _env_bool(name: str, default: bool) -> bool:
    return os.getenv(name, "1" if default else "0") in ("1", "true", "True")


@dataclasses.dataclass
class AuthConfig:
    db_path: str = dataclasses.field(
        default_factory=lambda: _env("ASR_API_AUTH_DB", "auth.db"))
    jwt_secret: str = dataclasses.field(
        default_factory=lambda: _env("ASR_API_JWT_SECRET", "CHANGE_ME_SECRET"))
    jwt_algorithm: str = dataclasses.field(
        default_factory=lambda: _env("ASR_API_JWT_ALGORITHM", "HS256"))
    bootstrap_admin_username: str = dataclasses.field(
        default_factory=lambda: _env("ASR_API_BOOTSTRAP_ADMIN_USERNAME", "admin"))
    reset_admin_on_startup: bool = dataclasses.field(
        default_factory=lambda: _env_bool("ASR_API_RESET_ADMIN_ON_STARTUP", True))


@dataclasses.dataclass
class ModelConfig:
    model_path: str = dataclasses.field(
        default_factory=lambda: _env("TTASR_MODEL_PATH",
                                     _env("FASTAPI_ASR_MODEL_SIZE", "models")))
    compute_type: str = dataclasses.field(
        default_factory=lambda: _env("TTASR_MODEL_COMPUTE_TYPE", "bfloat16"))
    device: str = dataclasses.field(
        default_factory=lambda: _env("TTASR_MODEL_DEVICE", "cuda"))


@dataclasses.dataclass
class StreamingConfig:
    skip_init: bool = dataclasses.field(
        default_factory=lambda: _env_bool("FASTAPI_SKIP_INIT", False))
    warmup: bool = dataclasses.field(
        default_factory=lambda: _env_bool("FASTAPI_WARMUP", False))
    host: str = dataclasses.field(
        default_factory=lambda: _env("FASTAPI_HOST", "127.0.0.1"))
    port: int = dataclasses.field(
        default_factory=lambda: int(_env("FASTAPI_PORT", "8000")))
    max_streams: int = dataclasses.field(
        default_factory=lambda: int(_env("TTASR_MAX_STREAMS", "10")))
    chunk_length_seconds: float = dataclasses.field(
        default_factory=lambda: float(_env("BUFFERING_CHUNK_LENGTH_SECONDS", "1.5")))
    chunk_offset_seconds: float = dataclasses.field(
        default_factory=lambda: float(_env("BUFFERING_CHUNK_OFFSET_SECONDS", "0.1")))
    vad_type: str = dataclasses.field(
        default_factory=lambda: _env("TTASR_VAD_TYPE", "simple"))


@dataclasses.dataclass
class ServiceConfig:
    auth: AuthConfig = dataclasses.field(default_factory=AuthConfig)
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    streaming: StreamingConfig = dataclasses.field(default_factory=StreamingConfig)
    api_port: int = dataclasses.field(
        default_factory=lambda: int(_env("TTASR_API_PORT", "5000")))
    data_dir: Optional[str] = dataclasses.field(
        default_factory=lambda: os.getenv("TTASR_API_DATA_DIR"))


def load_config() -> ServiceConfig:
    """Snapshot the full config tree from the environment."""
    return ServiceConfig()
