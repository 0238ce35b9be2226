"""Auth API: JWT login/logout/user management over SQLite.

Parity surface: reference api/auth_api.py — routes under ``/api/v1``
(health, login, logout, user, user/password), ``users`` table schema
(:23-41), bootstrap admin with optional startup password reset
(:126-178), rememberMe token TTLs (:211), role gating (:115-117).
Env vars: ``ASR_API_AUTH_DB``, ``ASR_API_BOOTSTRAP_ADMIN_{USERNAME,
PASSWORD,NICKNAME}``, ``ASR_API_RESET_ADMIN_ON_STARTUP``.
"""

from __future__ import annotations

import os
import re
import sqlite3
from contextlib import contextmanager
from datetime import datetime, timezone
from typing import Dict, Optional

from aiohttp import web

from ttasr_torch.api.jwt import (
    AuthError,
    generate_jwt_token,
    get_bearer_token_from_authorization_header,
    verify_jwt_token,
)
from ttasr_torch.api.passwords import hash_password, verify_password

REMEMBER_ME_TTL = 34560000  # 400 days (reference auth_api.py:211)
DEFAULT_TTL = 86400


def db_path() -> str:
    return os.getenv(
        "ASR_API_AUTH_DB",
        os.path.join(os.path.dirname(__file__), "auth.db"),
    )


def ensure_db_schema() -> None:
    os.makedirs(os.path.dirname(db_path()) or ".", exist_ok=True)
    with sqlite3.connect(db_path()) as conn:
        conn.execute(
            """
            CREATE TABLE IF NOT EXISTS users (
                username TEXT PRIMARY KEY,
                nickname TEXT,
                role TEXT NOT NULL,
                comment TEXT,
                password_hash TEXT NOT NULL,
                status INTEGER NOT NULL,
                expired_time TEXT NOT NULL,
                created_at TEXT NOT NULL,
                updated_at TEXT NOT NULL
            )
            """
        )
        conn.commit()


@contextmanager
def get_db_conn():
    conn = sqlite3.connect(db_path(), check_same_thread=False)
    try:
        yield conn
    finally:
        conn.close()


def _now_utc() -> datetime:
    return datetime.now(timezone.utc)


def _parse_iso8601(dt_str: str) -> datetime:
    if dt_str.endswith("Z"):
        dt_str = dt_str[:-1] + "+00:00"
    dt = datetime.fromisoformat(dt_str)
    if dt.tzinfo is None:
        dt = dt.replace(tzinfo=timezone.utc)
    return dt


def auth_startup() -> None:
    """Create schema; bootstrap/reset the admin user
    (reference auth_api.py:126-178)."""
    ensure_db_schema()
    username = os.getenv("ASR_API_BOOTSTRAP_ADMIN_USERNAME", "admin")
    password = os.getenv("ASR_API_BOOTSTRAP_ADMIN_PASSWORD", "admin@0935")
    nickname = os.getenv("ASR_API_BOOTSTRAP_ADMIN_NICKNAME", "ADMIN")
    expired_iso = datetime(2099, 12, 31, 23, 59, 59, tzinfo=timezone.utc).isoformat()
    now_iso = _now_utc().isoformat()
    with get_db_conn() as conn:
        cur = conn.execute("SELECT username FROM users WHERE username=?", (username,))
        if cur.fetchone() is None:
            conn.execute(
                "INSERT INTO users (username, nickname, role, comment, password_hash,"
                " status, expired_time, created_at, updated_at)"
                " VALUES (?, ?, 'admin', '', ?, 1, ?, ?, ?)",
                (username, nickname, hash_password(password), expired_iso,
                 now_iso, now_iso),
            )
            conn.commit()
        elif os.getenv("ASR_API_RESET_ADMIN_ON_STARTUP", "1") in ("1", "true", "True"):
            conn.execute(
                "UPDATE users SET password_hash=?, status=1, expired_time=?,"
                " updated_at=? WHERE username=?",
                (hash_password(password), expired_iso, now_iso, username),
            )
            conn.commit()


# ---------------------------------------------------------------------------
# Request helpers
# ---------------------------------------------------------------------------

def _json_error(status: int, detail: str) -> web.Response:
    return web.json_response({"detail": detail}, status=status)


def require_token_payload(request: web.Request) -> Dict:
    token = get_bearer_token_from_authorization_header(
        request.headers.get("Authorization")
    )
    return verify_jwt_token(token)


def require_admin(payload: Dict) -> None:
    if payload.get("role") != "admin":
        raise AuthError("admin only", status=403)


# ---------------------------------------------------------------------------
# Handlers
# ---------------------------------------------------------------------------

async def health(_request: web.Request) -> web.Response:
    return web.json_response({"status": "ok"})


async def login(request: web.Request) -> web.Response:
    """POST /api/v1/login (reference auth_api.py:186-227)."""
    try:
        body = await request.json()
    except Exception:
        return _json_error(400, "invalid json")
    username = body.get("username")
    password = body.get("password")
    remember = int(body.get("rememberMe") or 0)
    with get_db_conn() as conn:
        cur = conn.execute(
            "SELECT username, nickname, role, password_hash, status, expired_time"
            " FROM users WHERE username=?",
            (username,),
        )
        row = cur.fetchone()
    if not row:
        return _json_error(401, "invalid credentials")
    username, nickname, role, password_hash, status_flag, expired_time_str = row
    if status_flag != 1:
        return _json_error(403, "user disabled")
    try:
        expired_time = _parse_iso8601(expired_time_str)
    except Exception:
        return _json_error(403, "user expired")
    if expired_time <= _now_utc():
        return web.json_response({"code": 200, "pwdExpired": 1})
    if not verify_password(password or "", password_hash):
        return _json_error(401, "invalid credentials")
    expiration = REMEMBER_ME_TTL if remember else DEFAULT_TTL
    token = generate_jwt_token(
        {
            "sub": username,
            "role": role,
            "nickname": nickname,
            "loginType": "default",
            "expiration": expiration,
        },
        expires_in_seconds=expiration,
    )
    return web.json_response(
        {"code": 200, "token": token, "expiration": expiration, "pwdExpired": 0}
    )


async def logout(request: web.Request) -> web.Response:
    """POST /api/v1/logout (reference auth_api.py:230-236)."""
    payload = require_token_payload(request)
    username = payload.get("sub") or payload.get("username") or ""
    return web.json_response({"code": 200, "username": username, "message": "logged out"})


async def create_user(request: web.Request) -> web.Response:
    """POST /api/v1/user — admin only (reference auth_api.py:239-275)."""
    payload = require_token_payload(request)
    require_admin(payload)
    try:
        body = await request.json()
    except Exception:
        return _json_error(400, "invalid json")
    role = body.get("role", "")
    if not re.fullmatch(r"admin|user", role or ""):
        return _json_error(422, "role must be admin or user")
    for field in ("username", "nickname", "password", "expiredTime"):
        if not body.get(field):
            return _json_error(422, f"{field} required")
    try:
        expired_dt = _parse_iso8601(str(body["expiredTime"]))
    except Exception:
        return _json_error(400, "invalid expiredTime format")
    now_iso = _now_utc().isoformat()
    with get_db_conn() as conn:
        try:
            conn.execute(
                "INSERT INTO users (username, nickname, role, comment, password_hash,"
                " status, expired_time, created_at, updated_at)"
                " VALUES (?, ?, ?, ?, ?, ?, ?, ?, ?)",
                (
                    body["username"], body["nickname"], role,
                    body.get("comment") or "", hash_password(body["password"]),
                    int(body.get("status", 1)), expired_dt.isoformat(),
                    now_iso, now_iso,
                ),
            )
            conn.commit()
        except sqlite3.IntegrityError:
            return _json_error(409, "username exists")
    return web.json_response(
        {"code": 200, "username": body["username"], "message": "added"}
    )


async def update_password(request: web.Request) -> web.Response:
    """PUT /api/v1/user/password (reference auth_api.py:278-323)."""
    payload = require_token_payload(request)
    username = request.query.get("username")
    new_password = request.query.get("newPassword")
    if not username or not new_password:
        return _json_error(422, "username and newPassword required")
    is_admin = payload.get("role") == "admin"
    if not is_admin and payload.get("sub") != username:
        return _json_error(403, "forbidden")
    with get_db_conn() as conn:
        cur = conn.execute(
            "SELECT password_hash FROM users WHERE username=?", (username,)
        )
        if cur.fetchone() is None:
            return _json_error(404, "user not found")
        conn.execute(
            "UPDATE users SET password_hash=?, updated_at=? WHERE username=?",
            (hash_password(new_password), _now_utc().isoformat(), username),
        )
        conn.commit()
        cur = conn.execute(
            "SELECT password_hash FROM users WHERE username=?", (username,)
        )
        row = cur.fetchone()
        if not row or not verify_password(new_password, row[0]):
            return _json_error(500, "password update verification failed")
    return web.json_response(
        {"code": 200, "username": username, "message": "password updated"}
    )


@web.middleware
async def auth_error_middleware(request: web.Request, handler):
    """Translate AuthError into the FastAPI-style {detail} JSON errors."""
    try:
        return await handler(request)
    except AuthError as exc:
        return _json_error(exc.status, exc.detail)


def add_auth_routes(app: web.Application) -> None:
    app.router.add_get("/api/v1/health", health)
    app.router.add_post("/api/v1/login", login)
    app.router.add_post("/api/v1/logout", logout)
    app.router.add_post("/api/v1/user", create_user)
    app.router.add_put("/api/v1/user/password", update_password)
