"""Task-based file transcription API (port of ``ttasr/api/file_tasks.py``).

Parity surface: reference api/file_asr.py — endpoints, the 17 status
codes (:54-68), ``subtitle_tasks`` schema (:71-90), per-task UUID dirs,
TXT + strict-SRT outputs (:477-517), subtitle-types/link/download routes
(:591-685), and the monkeypatchable ``load_model`` test seam (:178-193).

As in the JAX package, the transcription runs off the event loop (the
shared BatchServer's executor, or a thread for engines without a server
path), so uploads and the streaming WebSocket keep being answered while
the card decodes.
"""

from __future__ import annotations

import asyncio
import logging
import os
import sqlite3
import uuid
from datetime import datetime
from pathlib import Path
from typing import List, Optional

from aiohttp import web

from ttasr_torch import resolve_device
from ttasr_torch.api import config
from ttasr_torch.api.auth import auth_startup, db_path, require_token_payload
from ttasr_torch.engine.results import segments_to_srt
from ttasr_torch.text.cer import compare_texts
from ttasr_torch.text.normalize import postprocess_transcript

logger = logging.getLogger("ttasr_torch.api.tasks")

BASE_DIR = Path(os.getenv("TTASR_API_DATA_DIR", os.path.dirname(__file__)))

# Task status codes (reference file_asr.py:54-68)
STATUS_WAIT_CONFIRM = 0
STATUS_SUCCESS = 3
STATUS_FAILED = 4
STATUS_CANCELLED = 5
STATUS_UPLOAD_IN_PROGRESS = 10
STATUS_WAIT_TRANSCRIPT = 11
STATUS_FILE_DOWNLOADING = 12
STATUS_TRANSCRIPT_PROCESSING = 13
STATUS_AUDIO_WAITING = 20
STATUS_AUDIO_PROCESSING = 21
STATUS_AUDIO_DONE = 22
STATUS_STREAMING_RUNNING = 30
STATUS_STREAMING_SUCCESS = 31
STATUS_STREAMING_FAILED = 32
STATUS_STREAMING_EMPTY = 33

ALLOWED_EXTENSIONS = {".wav", ".mp3", ".flac", ".m4a", ".aac"}

whisper_engine = None  # global singleton (reference file_asr.py:175)


def load_model() -> bool:
    """Load the inference engine once (reference file_asr.py:178-193).

    Module-level and monkeypatchable — the reference's test suite swaps
    this out for a dummy model and ours supports the same seam.
    """
    global whisper_engine
    if whisper_engine is None:
        # the device is resolved outside the try: without CUDA this raises
        # unless TTASR_MODEL_DEVICE=cpu is set; nothing falls back to the CPU
        device = resolve_device(config.MODEL_DEVICE)
        try:
            from ttasr_torch.engine.registry import get_engine

            models_path = os.getenv("TTASR_MODEL_PATH", "models")
            # int8 matches the reference task API's compute choice
            # (file_asr.py:188 loads CPU int8) and is the fused-kernel
            # path on the card; override via TTASR_MODEL_COMPUTE_TYPE.
            # The registry shares the engine (one weight set on the card +
            # one batch queue) with the streaming server when paths match.
            compute = os.getenv("TTASR_MODEL_COMPUTE_TYPE", "int8")
            logger.info("loading model: %s (%s, %s)", models_path, compute,
                        device)
            whisper_engine = get_engine(models_path, compute_type=compute,
                                        device=device)
        except Exception:
            logger.exception("model load failed")
            return False
    return True


def ensure_tasks_schema() -> None:
    """Create subtitle_tasks (reference file_asr.py:71-90)."""
    os.makedirs(os.path.dirname(db_path()) or ".", exist_ok=True)
    with sqlite3.connect(db_path()) as conn:
        conn.execute(
            """
            CREATE TABLE IF NOT EXISTS subtitle_tasks (
                id INTEGER PRIMARY KEY AUTOINCREMENT,
                status INTEGER NOT NULL,
                progress INTEGER NOT NULL DEFAULT 0,
                input_filename TEXT,
                temp_path TEXT,
                result_txt_path TEXT,
                result_srt_path TEXT,
                error TEXT,
                created_at TEXT,
                updated_at TEXT
            )
            """
        )
        conn.commit()


def _tasks_conn():
    return sqlite3.connect(db_path(), check_same_thread=False)


def _now_iso() -> str:
    return datetime.now().isoformat()


def _update_task(task_id: int, **fields) -> None:
    fields["updated_at"] = _now_iso()
    cols = ", ".join(f"{k}=?" for k in fields)
    with _tasks_conn() as conn:
        conn.execute(
            f"UPDATE subtitle_tasks SET {cols} WHERE id=?",
            (*fields.values(), task_id),
        )
        conn.commit()


# ---------------------------------------------------------------------------
# Worker
# ---------------------------------------------------------------------------

TRANSCRIBE_KWARGS = dict(
    language="zh",
    word_timestamps=False,
    vad_filter=True,
    beam_size=5,
    condition_on_previous_text=True,
    initial_prompt="",
)


def _transcribe_blocking(file_path: str):
    """Run in a thread: decode + transcribe + post-process."""
    if not load_model():
        raise RuntimeError("模型載入失敗")
    segments, info = whisper_engine.transcribe(file_path, **TRANSCRIBE_KWARGS)
    segments = list(segments)
    full_text = "".join(seg.text for seg in segments)
    processed = postprocess_transcript(full_text)
    return segments, processed


async def _transcribe_task(file_path: str):
    """Decode one task's audio, batched when possible.

    Default path: the process-wide BatchServer (shared with the
    streaming WS chunks when both run on one engine —
    ``ttasr_torch.engine.registry``), so N concurrent uploads pack their 30 s
    windows into shared fixed decode slots instead of serializing N
    full-cost decodes (reference behavior, file_asr.py:440-543).  The
    ladder/gates are decode-equivalent to ``transcribe`` (tests/
    test_torch_serving.py).  ``TTASR_TASK_BATCH_SLOTS=0`` or an engine
    without server support (the monkeypatched test dummies) falls back
    to the executor-thread sequential path.
    """
    loop = asyncio.get_running_loop()
    if not await loop.run_in_executor(None, load_model):
        raise RuntimeError("模型載入失敗")
    slots = int(os.getenv("TTASR_TASK_BATCH_SLOTS", "4"))
    if slots <= 0 or not hasattr(whisper_engine, "transcribe_with_server"):
        return await loop.run_in_executor(None, _transcribe_blocking,
                                          file_path)
    from ttasr_torch.audio.io import load_audio
    from ttasr_torch.engine.serving import shared_server

    linger_ms = float(os.getenv("TTASR_TASK_BATCH_LINGER_MS", "5"))
    server = await shared_server(whisper_engine, slots=slots,
                                 linger_ms=linger_ms)
    # audio decode (ffmpeg/RIFF) off the loop; the decode itself runs in
    # the server's executor.  int16=True keeps PCM16 sources int16 so
    # windows copy to the card at half the bytes (the mel converts).
    audio, _sr = await loop.run_in_executor(
        None, lambda: load_audio(file_path, int16=True))
    # Default ON, as in the JAX package: VAD chunks of THIS upload decode
    # concurrently through the server.  Costs prompt carry
    # (condition_on_previous_text) — set TTASR_TASK_BATCHED=0 to restore
    # the sequential seek loop, which remains the CLI default for
    # reference-kwargs parity.
    if os.getenv("TTASR_TASK_BATCHED", "1").lower() not in ("0", "false",
                                                            "no", ""):
        from ttasr_torch.engine.batched import transcribe_batched_with_server

        segments, info = await transcribe_batched_with_server(
            whisper_engine, server, audio, **TRANSCRIBE_KWARGS)
    else:
        segments, info = await whisper_engine.transcribe_with_server(
            audio, server, **TRANSCRIBE_KWARGS)
    segments = list(segments)
    full_text = "".join(seg.text for seg in segments)
    return segments, postprocess_transcript(full_text)


async def _worker(task_id: int, file_path: str, task_dir: str,
                  reference_text: Optional[str]) -> None:
    try:
        _update_task(task_id, status=STATUS_AUDIO_PROCESSING, progress=5)
        segments, processed_text = await _transcribe_task(file_path)

        result_txt_path = os.path.join(task_dir, f"{task_id}.txt")
        with open(result_txt_path, "w", encoding="utf-8") as fh:
            fh.write(processed_text)

        result_srt_path = os.path.join(task_dir, f"{task_id}.srt")
        try:
            with open(result_srt_path, "w", encoding="utf-8", newline="") as fh:
                fh.write(segments_to_srt(segments))
        except Exception as exc:  # SRT failure must not kill TXT output
            logger.warning("SRT 產生失敗: %s", exc)

        if reference_text:
            cer = compare_texts(reference_text, processed_text)
            if cer is not None:
                cer_path = os.path.join(task_dir, f"{task_id}_cer.txt")
                with open(cer_path, "w", encoding="utf-8") as fh:
                    fh.write(f"CER: {cer.cer_rate:.4f}\n正確率: {cer.correct_rate:.2f}%\n")

        _update_task(
            task_id, status=STATUS_AUDIO_DONE, progress=100,
            result_txt_path=result_txt_path, result_srt_path=result_srt_path,
        )
    except Exception as exc:
        logger.error("任務 %s 處理失敗: %s", task_id, exc)
        _update_task(task_id, status=STATUS_FAILED, error=str(exc))


def process_audio_file(audio_file_path: str,
                       reference_text: Optional[str] = None) -> dict:
    """Synchronous single-file transcription helper
    (reference file_asr.py:258-338): transcribe, post-process, optional
    CER vs ``reference_text``; returns the success/error dict shape."""
    import time as _time

    if not load_model():
        return {"error": "模型載入失敗"}
    try:
        t0 = _time.time()
        segments, info = whisper_engine.transcribe(
            audio_file_path, language="zh", word_timestamps=False,
            vad_filter=True, beam_size=5, condition_on_previous_text=True,
            initial_prompt="",
        )
        processing_time = _time.time() - t0
        text = "".join(seg.text for seg in segments)
        processed_text = postprocess_transcript(text)
        result: dict = {
            "success": True,
            "asr_result": processed_text,
            "original_text": reference_text,
            "cer_result": None,
            "processing_time": processing_time,
        }
        if reference_text:
            cer = compare_texts(reference_text, processed_text)
            if cer is not None:
                result["cer_result"] = cer.to_dict()
        return result
    except Exception as exc:
        logger.exception("process_audio_file failed")
        return {"error": f"處理音檔時發生錯誤: {exc}"}


# ---------------------------------------------------------------------------
# Handlers
# ---------------------------------------------------------------------------

async def health_check(_request: web.Request) -> web.Response:
    """GET /api/health (reference file_asr.py:342-349)."""
    return web.json_response({
        "status": "healthy",
        "model_loaded": whisper_engine is not None,
        "timestamp": datetime.now().isoformat(),
    })


UPLOAD_CHUNK_BYTES = 64 * 1024


async def create_subtitle_task(request: web.Request) -> web.Response:
    """POST /api/v1/subtitle/tasks (reference file_asr.py:373-565).

    The audio part streams to disk in fixed-size chunks — constant
    memory for arbitrarily large uploads, matching the reference's
    stream-to-disk behavior (a 2 h WAV never lands in RSS).
    """
    require_token_payload(request)
    reader = await request.multipart()
    filename = None
    reference_text = None
    temp_file_path = None
    task_dir = None
    task_id = None
    try:
        async for part in reader:
            if part.name == "audio" and temp_file_path is None:
                filename = part.filename or ""
                _, ext = os.path.splitext(filename)
                if ext.lower() not in ALLOWED_EXTENSIONS:
                    return web.json_response(
                        {"error": "不支援的檔案格式。支援的格式: "
                                  + ", ".join(sorted(ALLOWED_EXTENSIONS))},
                        status=400,
                    )
                tasks_root = os.path.join(BASE_DIR, "audio_files", "tasks")
                os.makedirs(tasks_root, exist_ok=True)
                task_dir = os.path.join(tasks_root, str(uuid.uuid4()))
                os.makedirs(task_dir, exist_ok=True)
                temp_file_path = os.path.join(task_dir, f"input{ext}")
                with _tasks_conn() as conn:
                    cur = conn.execute(
                        "INSERT INTO subtitle_tasks (status, progress,"
                        " input_filename, temp_path, created_at, updated_at)"
                        " VALUES (?, ?, ?, ?, ?, ?)",
                        (STATUS_UPLOAD_IN_PROGRESS, 0, filename, temp_file_path,
                         _now_iso(), _now_iso()),
                    )
                    task_id = cur.lastrowid
                    conn.commit()
                try:
                    with open(temp_file_path, "wb") as out:
                        while True:
                            chunk = await part.read_chunk(UPLOAD_CHUNK_BYTES)
                            if not chunk:
                                break
                            out.write(chunk)
                except Exception as exc:
                    _update_task(task_id, status=STATUS_FAILED,
                                 error=f"upload failed: {exc}")
                    return web.json_response(
                        {"error": f"檔案儲存失敗: {exc}"}, status=500)
            elif part.name == "reference_text":
                reference_text = (await part.text()) or None
    except Exception as exc:
        # a disconnect after the audio part (e.g. while the
        # reference_text part or closing boundary streams) must
        # not strand the row in STATUS_UPLOAD_IN_PROGRESS forever
        if task_id is not None:
            _update_task(task_id, status=STATUS_FAILED,
                         error=f"upload aborted: {exc}")
        return web.json_response({"error": f"上傳中斷: {exc}"},
                                 status=400)

    if temp_file_path is None:
        return web.json_response(
            {"error": "不支援的檔案格式。支援的格式: "
                      + ", ".join(sorted(ALLOWED_EXTENSIONS))},
            status=400,
        )

    _update_task(task_id, status=STATUS_AUDIO_WAITING, progress=0)
    asyncio.get_running_loop().create_task(
        _worker(task_id, temp_file_path, task_dir, reference_text)
    )
    return web.json_response({"code": 200, "message": "created", "id": task_id})


async def get_task_status(request: web.Request) -> web.Response:
    """POST /api/v1/subtitle/tasks/{id} (reference file_asr.py:568-588)."""
    require_token_payload(request)
    task_id = int(request.match_info["task_id"])
    with _tasks_conn() as conn:
        cur = conn.execute(
            "SELECT status, progress FROM subtitle_tasks WHERE id=?", (task_id,)
        )
        row = cur.fetchone()
    if not row:
        return web.json_response({"error": "task not found"}, status=404)
    return web.json_response(
        {"code": 200, "data": [{"status": int(row[0]), "progress": int(row[1])}]}
    )


def _task_paths(task_id: int):
    with _tasks_conn() as conn:
        cur = conn.execute(
            "SELECT result_txt_path, result_srt_path FROM subtitle_tasks WHERE id=?",
            (task_id,),
        )
        return cur.fetchone()


async def get_subtitle_types(request: web.Request) -> web.Response:
    """GET .../subtitle-types (reference file_asr.py:591-619)."""
    require_token_payload(request)
    task_id = int(request.match_info["task_id"])
    row = _task_paths(task_id)
    if not row:
        return web.json_response({"error": "task not found"}, status=404)
    txt_path, srt_path = row
    types: List[str] = []
    if txt_path and os.path.exists(txt_path):
        types.append("TXT")
    if srt_path and os.path.exists(srt_path):
        types.append("SRT")
        types.append("DIA")  # DIA backed by SRT until diarization lands
    return web.json_response({"code": 200, "data": [{"id": task_id, "types": types}]})


def resolve_type_param(type_param: Optional[str]) -> str:
    """1/TXT/TEXT -> TXT, 2/SRT -> SRT, 3/DIA -> DIA, default TXT
    (reference file_asr.py:622-632)."""
    if type_param is None:
        return "TXT"
    t = str(type_param).strip().upper()
    if t in ("1", "TXT", "TEXT"):
        return "TXT"
    if t in ("2", "SRT"):
        return "SRT"
    if t in ("3", "DIA"):
        return "DIA"
    return "TXT"


async def get_subtitle_link(request: web.Request) -> web.Response:
    """GET .../subtitle-link (reference file_asr.py:635-645)."""
    require_token_payload(request)
    task_id = int(request.match_info["task_id"])
    subtype = resolve_type_param(request.query.get("type"))
    url = f"/api/v1/subtitle/tasks/{task_id}/subtitle?type={subtype}"
    return web.json_response(
        {"code": 200, "data": [{"id": task_id, "type": subtype, "url": url}]}
    )


async def download_subtitle(request: web.Request) -> web.Response:
    """GET .../subtitle (reference file_asr.py:648-685)."""
    require_token_payload(request)
    task_id = int(request.match_info["task_id"])
    subtype = resolve_type_param(request.query.get("type"))
    row = _task_paths(task_id)
    if not row:
        return web.json_response({"error": "task not found"}, status=404)
    txt_path, srt_path = row
    if subtype == "TXT":
        target, media_type = txt_path, "text/plain"
    elif subtype == "SRT":
        target, media_type = srt_path, "application/x-subrip"
    elif subtype == "DIA":
        target, media_type = srt_path, "text/plain"
    else:
        target, media_type = txt_path, "text/plain"
    if not target or not os.path.exists(target):
        return web.json_response({"error": f"{subtype} not available"}, status=404)
    return web.FileResponse(
        path=target,
        headers={
            "Content-Type": media_type,
            "Content-Disposition":
                f'attachment; filename="{os.path.basename(target)}"',
        },
    )


async def get_test_files_html(_request: web.Request) -> web.Response:
    test_file = BASE_DIR / "test_files.html"
    if test_file.exists():
        return web.FileResponse(path=str(test_file))
    return web.json_response({"error": "test_files.html 不存在"}, status=404)


async def get_test_realtime_html(_request: web.Request) -> web.Response:
    test_file = BASE_DIR / "test_realtime.html"
    if test_file.exists():
        return web.FileResponse(path=str(test_file))
    return web.json_response({"error": "test_realtime.html 不存在"}, status=404)


def add_task_routes(app: web.Application) -> None:
    app.router.add_get("/api/health", health_check)
    app.router.add_post("/api/v1/subtitle/tasks", create_subtitle_task)
    app.router.add_post("/api/v1/subtitle/tasks/{task_id}", get_task_status)
    app.router.add_get(
        "/api/v1/subtitle/tasks/{task_id}/subtitle-types", get_subtitle_types
    )
    app.router.add_get(
        "/api/v1/subtitle/tasks/{task_id}/subtitle-link", get_subtitle_link
    )
    app.router.add_get(
        "/api/v1/subtitle/tasks/{task_id}/subtitle", download_subtitle
    )
    app.router.add_get("/test_files.html", get_test_files_html)
    app.router.add_get("/test_realtime.html", get_test_realtime_html)
