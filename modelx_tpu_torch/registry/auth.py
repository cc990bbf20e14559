"""OIDC bearer-token verification (counterpart of
``modelx_tpu/registry/auth.py``): an RS256 JWT is parsed, its signature
checked against the issuer's JWKS (found through
``/.well-known/openid-configuration``), and its ``exp``, ``nbf`` and
``iss`` claims checked; the audience is not (the reference's
``SkipClientIDCheck``). The verified username reaches the handlers.

The JAX package verifies the signature with ``cryptography``, which the
card's host lacks, so this module verifies RSASSA-PKCS1-v1_5 with SHA-256
itself: the signature must be as long as the modulus and below it, and
``pow(s, e, n)`` must equal the whole EMSA-PKCS1-v1_5 encoding,
``00 01 FF..FF 00 || DigestInfo(SHA-256) || H(message)``, compared in
constant time. The JWKS is fetched over ``http.client``.

Verdicts, as the JAX package's: 401 for a malformed token, an ``alg``
other than RS256, an unknown ``kid``, a bad signature, an expired token, a
missing or unreadable ``exp``, a token not yet valid or the wrong issuer;
503 when the IdP cannot be reached. An unknown ``kid`` refreshes the keys
at most once every ``MIN_REFRESH_INTERVAL_S``. One stricter verdict: an
``exp`` or ``nbf`` that is not a finite number (JSON's ``NaN``,
``Infinity``) is malformed here, where the JAX package's comparison lets
a ``NaN`` expiry through.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import http.client
import json
import math
import ssl
import threading
import time
import urllib.parse
from typing import Any

from modelx_tpu_torch import errors

# DER of DigestInfo{AlgorithmIdentifier{sha256, NULL}, OCTET STRING(32)}
SHA256_DIGEST_INFO = bytes.fromhex("3031300d060960864801650304020105000420")


def _b64url_decode(s: str) -> bytes:
    return base64.urlsafe_b64decode(s + "=" * (-len(s) % 4))


def _b64url_to_int(s: str) -> int:
    return int.from_bytes(_b64url_decode(s), "big")


class RSAPublicKey:
    """An RSA public key (modulus ``n``, exponent ``e``) that verifies
    RSASSA-PKCS1-v1_5 SHA-256 signatures."""

    def __init__(self, n: int, e: int) -> None:
        if n <= 0 or e <= 0:
            raise ValueError("invalid RSA public numbers")
        self.n, self.e = n, e
        self.size = (n.bit_length() + 7) // 8  # k, the modulus' length in bytes

    def verify(self, signature: bytes, message: bytes) -> bool:
        k = self.size
        if len(signature) != k:
            return False
        s = int.from_bytes(signature, "big")
        if s >= self.n:
            return False
        encoded = pow(s, self.e, self.n).to_bytes(k, "big")
        t = SHA256_DIGEST_INFO + hashlib.sha256(message).digest()
        if k < len(t) + 11:  # room for 8 bytes of padding at least
            return False
        expected = b"\x00\x01" + b"\xff" * (k - len(t) - 3) + b"\x00" + t
        return hmac.compare_digest(encoded, expected)


def _get_json(url: str, timeout: float = 10.0) -> Any:
    """GET ``url`` and decode its JSON body; a transport failure or an
    error status raises OSError, a bad body ValueError."""
    u = urllib.parse.urlsplit(url)
    if u.scheme == "https":
        conn = http.client.HTTPSConnection(u.hostname or "", u.port or 443, timeout=timeout,
                                           context=ssl.create_default_context())
    else:
        conn = http.client.HTTPConnection(u.hostname or "", u.port or 80, timeout=timeout)
    try:
        conn.request("GET", (u.path or "/") + (f"?{u.query}" if u.query else ""))
        r = conn.getresponse()
        body = r.read()
    except http.client.HTTPException as e:
        raise OSError(str(e)) from e
    finally:
        conn.close()
    if r.status >= 400:
        raise OSError(f"{r.status} error for url: {url}")
    return json.loads(body)


def _number_claim(claims: dict, name: str) -> float | None:
    value = claims.get(name)
    if value is None:
        return None
    value = float(value)  # TypeError / ValueError: malformed
    if not math.isfinite(value):
        raise ValueError(f"{name} is not a finite number")
    return value


class OIDCVerifier:
    """Verifies RS256 JWTs against an issuer's JWKS. Keys are cached and
    refreshed on an unknown kid (standard rotation behavior)."""

    # minimum seconds between JWKS refreshes: bounds unknown-kid outbound
    # amplification against the IdP (one cheap inbound request must not buy
    # an outbound fetch every time)
    MIN_REFRESH_INTERVAL_S = 30.0

    def __init__(self, issuer: str, jwks_uri: str = "", leeway_s: int = 30) -> None:
        self.issuer = issuer.rstrip("/")
        self._jwks_uri = jwks_uri
        self._keys: dict[str, RSAPublicKey] = {}
        self._lock = threading.Lock()
        self._last_refresh = 0.0
        self.leeway_s = leeway_s

    def _discover(self) -> str:
        if self._jwks_uri:
            return self._jwks_uri
        self._jwks_uri = _get_json(f"{self.issuer}/.well-known/openid-configuration")["jwks_uri"]
        return self._jwks_uri

    def _refresh_keys(self) -> None:
        try:
            body = _get_json(self._discover())
        except (OSError, ValueError, KeyError, TypeError) as e:
            # IdP unreachable is a service problem, not a client one
            raise errors.ErrorInfo(503, errors.ErrCodeUnknown, f"OIDC keys unavailable: {e}") from e
        keys = {}
        for jwk in body.get("keys", []) if isinstance(body, dict) else []:
            if jwk.get("kty") != "RSA":
                continue
            try:
                pub = RSAPublicKey(n=_b64url_to_int(jwk["n"]), e=_b64url_to_int(jwk["e"]))
            except (KeyError, ValueError, TypeError):
                continue
            keys[jwk.get("kid", "")] = pub
        with self._lock:
            self._keys = keys
            self._last_refresh = time.monotonic()

    def _key_for(self, kid: str) -> RSAPublicKey | None:
        with self._lock:
            key = self._keys.get(kid)
            stale = time.monotonic() - self._last_refresh > self.MIN_REFRESH_INTERVAL_S
        if key is None and stale:
            self._refresh_keys()
            with self._lock:
                key = self._keys.get(kid)
        return key

    def verify(self, token: str) -> dict:
        """Returns the claims dict; raises errors.unauthorized on any failure."""
        try:
            header_b64, payload_b64, sig_b64 = token.split(".")
            header = json.loads(_b64url_decode(header_b64))
            claims = json.loads(_b64url_decode(payload_b64))
            signature = _b64url_decode(sig_b64)
            if not isinstance(header, dict) or not isinstance(claims, dict):
                raise ValueError("header/payload must be objects")
        except (ValueError, KeyError, TypeError):
            raise errors.unauthorized("malformed token") from None
        if header.get("alg") != "RS256":
            raise errors.unauthorized(f"unsupported alg {header.get('alg')!r}")
        key = self._key_for(header.get("kid", ""))
        if key is None:
            raise errors.unauthorized("unknown signing key")
        if not key.verify(signature, f"{header_b64}.{payload_b64}".encode()):
            raise errors.unauthorized("invalid signature")
        now = time.time()
        try:
            exp = _number_claim(claims, "exp")
            nbf = _number_claim(claims, "nbf")
        except (TypeError, ValueError):
            raise errors.unauthorized("malformed exp/nbf claim") from None
        if exp is None:
            # a token without an expiry is rejected, not immortal
            raise errors.unauthorized("token missing exp claim")
        if now > exp + self.leeway_s:
            raise errors.unauthorized("token expired")
        if nbf is not None and now < nbf - self.leeway_s:
            raise errors.unauthorized("token not yet valid")
        iss = str(claims.get("iss", "")).rstrip("/")
        if iss != self.issuer:
            raise errors.unauthorized(f"issuer mismatch: {iss!r}")
        return claims

    def username(self, claims: dict) -> str:
        return claims.get("preferred_username") or claims.get("name") or claims.get("sub", "")
