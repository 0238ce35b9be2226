"""Logging setup.

Parity surface: the reference's three logging stacks —
- task API: console INFO + rotating 10 MB x5 ``asr_api.log`` and an
  ERROR-only ``asr_api_error.log`` (reference api/file_asr.py:102-141),
- streaming: basicConfig file+console (streaming_asr.py:35-48),
- legacy: hourly TimedRotatingFileHandler x24 (main.py:31-48).

Unified here behind one function per flavor.
"""

from __future__ import annotations

import logging
import os
from logging.handlers import RotatingFileHandler, TimedRotatingFileHandler

_FORMAT = "%(asctime)s - %(name)s - %(levelname)s - %(message)s"
_DATEFMT = "%Y-%m-%d %H:%M:%S"


def setup_api_logging(logs_dir: str, name: str = "asr_api") -> logging.Logger:
    """Console INFO + rotating file DEBUG + rotating ERROR file
    (reference file_asr.py:102-141)."""
    os.makedirs(logs_dir, exist_ok=True)
    logger = logging.getLogger(name)
    logger.setLevel(logging.DEBUG)
    logger.handlers.clear()

    console = logging.StreamHandler()
    console.setLevel(logging.INFO)
    console.setFormatter(logging.Formatter(_FORMAT, _DATEFMT))
    logger.addHandler(console)

    file_handler = RotatingFileHandler(
        os.path.join(logs_dir, f"{name}.log"),
        maxBytes=10 * 1024 * 1024, backupCount=5, encoding="utf-8",
    )
    file_handler.setLevel(logging.DEBUG)
    file_handler.setFormatter(logging.Formatter(_FORMAT, _DATEFMT))
    logger.addHandler(file_handler)

    error_handler = RotatingFileHandler(
        os.path.join(logs_dir, f"{name}_error.log"),
        maxBytes=10 * 1024 * 1024, backupCount=5, encoding="utf-8",
    )
    error_handler.setLevel(logging.ERROR)
    error_handler.setFormatter(logging.Formatter(_FORMAT, _DATEFMT))
    logger.addHandler(error_handler)
    return logger


def setup_hourly_logging(log_path: str, name: str = "ttasr") -> logging.Logger:
    """Hourly rotation, 24 backups (reference main.py:31-48)."""
    os.makedirs(os.path.dirname(log_path) or ".", exist_ok=True)
    logger = logging.getLogger(name)
    logger.setLevel(logging.INFO)
    handler = TimedRotatingFileHandler(
        log_path, when="H", interval=1, backupCount=24, encoding="utf-8"
    )
    handler.setFormatter(logging.Formatter(_FORMAT, _DATEFMT))
    logger.addHandler(handler)
    return logger
