"""HS256/HS384/HS512 JWT — stdlib replacement for PyJWT.

Parity surface: reference api/auth_shared.py (generate_jwt_token,
verify_jwt_token, bearer extraction; env ``ASR_API_JWT_SECRET`` /
``ASR_API_JWT_ALGORITHM``; 401 details "token expired"/"invalid token").
Tokens are interoperable with PyJWT (same header/payload/signature).
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import json
import os
import time
from typing import Dict, Optional

_ALGS = {"HS256": hashlib.sha256, "HS384": hashlib.sha384, "HS512": hashlib.sha512}


def _secret() -> str:
    return os.getenv("ASR_API_JWT_SECRET", "CHANGE_ME_SECRET")


def _algorithm() -> str:
    return os.getenv("ASR_API_JWT_ALGORITHM", "HS256")


class AuthError(Exception):
    """Raised on auth failures; carries the HTTP status + detail."""

    def __init__(self, detail: str, status: int = 401):
        super().__init__(detail)
        self.detail = detail
        self.status = status


def _b64url(data: bytes) -> str:
    return base64.urlsafe_b64encode(data).rstrip(b"=").decode("ascii")


def _b64url_decode(s: str) -> bytes:
    return base64.urlsafe_b64decode(s + "=" * (-len(s) % 4))


def generate_jwt_token(claims: Dict, expires_in_seconds: int) -> str:
    """Signed JWT with iat/exp (reference auth_shared.py:14-28)."""
    alg = _algorithm()
    if alg not in _ALGS:
        raise ValueError(f"unsupported algorithm: {alg}")
    now = int(time.time())
    payload = {**claims, "iat": now, "exp": now + int(expires_in_seconds)}
    header = {"alg": alg, "typ": "JWT"}
    signing_input = (
        _b64url(json.dumps(header, separators=(",", ":")).encode())
        + "."
        + _b64url(json.dumps(payload, separators=(",", ":")).encode())
    )
    sig = hmac.new(_secret().encode(), signing_input.encode(), _ALGS[alg]).digest()
    return signing_input + "." + _b64url(sig)


def verify_jwt_token(token: Optional[str]) -> Dict:
    """Validate signature + expiry; 401 AuthError on failure
    (reference auth_shared.py:31-45)."""
    if not token:
        raise AuthError("invalid token")
    parts = token.split(".")
    if len(parts) != 3:
        raise AuthError("invalid token")
    head_b64, payload_b64, sig_b64 = parts
    try:
        header = json.loads(_b64url_decode(head_b64))
        alg = header.get("alg", "")
        digestmod = _ALGS[alg]
        expected = hmac.new(
            _secret().encode(), f"{head_b64}.{payload_b64}".encode(), digestmod
        ).digest()
        if not hmac.compare_digest(expected, _b64url_decode(sig_b64)):
            raise AuthError("invalid token")
        payload = json.loads(_b64url_decode(payload_b64))
    except AuthError:
        raise
    except Exception:
        raise AuthError("invalid token")
    exp = payload.get("exp")
    if exp is not None and time.time() >= float(exp):
        raise AuthError("token expired")
    return payload


def get_bearer_token_from_authorization_header(authorization: Optional[str]) -> str:
    """Extract the Bearer token (reference auth_shared.py:48-55)."""
    if not authorization:
        raise AuthError("authorization header required")
    parts = authorization.split(" ", 1)
    if len(parts) != 2 or parts[0].lower() != "bearer":
        raise AuthError("invalid authorization header")
    return parts[1].strip()
