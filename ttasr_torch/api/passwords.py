"""passlib-compatible pbkdf2_sha256 hashing (stdlib only).

The reference hashes passwords with ``passlib.hash.pbkdf2_sha256``
(api/auth_api.py:53-72).  This module produces/validates the identical
modular-crypt format ``$pbkdf2-sha256$<rounds>$<salt>$<checksum>`` with
passlib's adapted base64 ("./"-shifted alphabet, no padding), so existing
user databases keep working.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import os

_DEFAULT_ROUNDS = 29000
_SALT_BYTES = 16


def _ab64_encode(data: bytes) -> str:
    return base64.b64encode(data, altchars=b"./").rstrip(b"=").decode("ascii")


def _ab64_decode(data: str) -> bytes:
    return base64.b64decode(data + "=" * (-len(data) % 4), altchars=b"./")


def hash_password(password: str, rounds: int = _DEFAULT_ROUNDS,
                  salt: bytes = None) -> str:
    if salt is None:
        salt = os.urandom(_SALT_BYTES)
    digest = hashlib.pbkdf2_hmac("sha256", password.encode("utf-8"), salt, rounds)
    return f"$pbkdf2-sha256${rounds}${_ab64_encode(salt)}${_ab64_encode(digest)}"


def verify_password(password: str, password_hash: str) -> bool:
    try:
        _, scheme, rounds_s, salt_s, digest_s = password_hash.split("$")
        if scheme != "pbkdf2-sha256":
            return False
        rounds = int(rounds_s)
        salt = _ab64_decode(salt_s)
        expected = _ab64_decode(digest_s)
        got = hashlib.pbkdf2_hmac("sha256", password.encode("utf-8"), salt, rounds)
        return hmac.compare_digest(got, expected)
    except Exception:
        return False
