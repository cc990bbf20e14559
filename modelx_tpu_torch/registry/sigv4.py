"""AWS Signature Version 4 signing and presigning, standard library only
(counterpart of ``modelx_tpu/registry/sigv4.py``): the canonical request,
the string to sign and the signing-key ladder of the public specification,
for header-signed requests (the registry's own S3 calls) and query-
presigned URLs (the load-separation data plane). ``GOOG_SIG`` spells the
same algorithm as Google Cloud Storage's GOOG4-HMAC-SHA256. For the same
credentials, clock, method, path and query the port presigns the JAX
package's URL character for character; the AWS documentation's example
vectors hold both (``tests/test_torch_sigv4.py``).
"""

from __future__ import annotations

import dataclasses
import datetime
import hashlib
import hmac
import urllib.parse

UNSIGNED_PAYLOAD = "UNSIGNED-PAYLOAD"
EMPTY_SHA256 = hashlib.sha256(b"").hexdigest()


@dataclasses.dataclass(frozen=True)
class SigSpec:
    """The V4 algorithm's provider-specific spellings. Google Cloud
    Storage's HMAC signing (GOOG4-HMAC-SHA256) is byte-for-byte the AWS
    algorithm with different constants — same canonical request, same key
    derivation ladder, different prefixes — so one implementation serves
    both (the GCS location provider reuses everything here)."""

    algorithm: str = "AWS4-HMAC-SHA256"
    key_prefix: str = "AWS4"
    request_suffix: str = "aws4_request"
    param_prefix: str = "X-Amz-"
    date_header: str = "x-amz-date"
    content_sha_header: str = "x-amz-content-sha256"


AWS_SIG = SigSpec()
GOOG_SIG = SigSpec(
    algorithm="GOOG4-HMAC-SHA256",
    key_prefix="GOOG4",
    request_suffix="goog4_request",
    param_prefix="X-Goog-",
    date_header="x-goog-date",
    content_sha_header="x-goog-content-sha256",
)


@dataclasses.dataclass
class Credentials:
    access_key: str
    secret_key: str
    region: str = "us-east-1"
    service: str = "s3"


def _hmac(key: bytes, msg: str) -> bytes:
    return hmac.new(key, msg.encode(), hashlib.sha256).digest()


def signing_key(creds: Credentials, datestamp: str, spec: SigSpec = AWS_SIG) -> bytes:
    k = _hmac((spec.key_prefix + creds.secret_key).encode(), datestamp)
    k = _hmac(k, creds.region)
    k = _hmac(k, creds.service)
    return _hmac(k, spec.request_suffix)


def _quote(s: str, safe: str = "-_.~") -> str:
    return urllib.parse.quote(s, safe=safe)


def canonical_query(params: dict[str, str]) -> str:
    return "&".join(
        f"{_quote(k)}={_quote(v)}" for k, v in sorted(params.items())
    )


def _canonical_request(
    method: str,
    path: str,
    query: dict[str, str],
    headers: dict[str, str],
    signed_headers: list[str],
    payload_hash: str,
) -> str:
    """For S3, the canonical URI is the path exactly as sent on the wire
    (already single-percent-encoded by the caller) — re-encoding here would
    double-encode '%' and produce SignatureDoesNotMatch for any key with an
    encodable character."""
    canon_headers = "".join(
        f"{h}:{' '.join(headers[h].split())}\n" for h in signed_headers
    )
    return "\n".join(
        [
            method,
            path or "/",
            canonical_query(query),
            canon_headers,
            ";".join(signed_headers),
            payload_hash,
        ]
    )


def _string_to_sign(amzdate: str, scope: str, canonical_request: str,
                    spec: SigSpec = AWS_SIG) -> str:
    return "\n".join(
        [
            spec.algorithm,
            amzdate,
            scope,
            hashlib.sha256(canonical_request.encode()).hexdigest(),
        ]
    )


def _now() -> datetime.datetime:
    return datetime.datetime.now(datetime.timezone.utc)


def sign_headers(
    creds: Credentials,
    method: str,
    url: str,
    headers: dict[str, str] | None = None,
    payload_hash: str = UNSIGNED_PAYLOAD,
    now: datetime.datetime | None = None,
    spec: SigSpec = AWS_SIG,
) -> dict[str, str]:
    """Return headers (including Authorization) for a header-signed request."""
    now = now or _now()
    amzdate = now.strftime("%Y%m%dT%H%M%SZ")
    datestamp = now.strftime("%Y%m%d")
    u = urllib.parse.urlsplit(url)
    query = dict(urllib.parse.parse_qsl(u.query, keep_blank_values=True))

    out = dict(headers or {})
    out["host"] = u.netloc
    out[spec.date_header] = amzdate
    out[spec.content_sha_header] = payload_hash
    lower = {k.lower(): v for k, v in out.items()}
    signed = sorted(lower)

    scope = f"{datestamp}/{creds.region}/{creds.service}/{spec.request_suffix}"
    creq = _canonical_request(method, u.path or "/", query, lower, signed, payload_hash)
    sts = _string_to_sign(amzdate, scope, creq, spec)
    signature = hmac.new(
        signing_key(creds, datestamp, spec), sts.encode(), hashlib.sha256
    ).hexdigest()
    out["Authorization"] = (
        f"{spec.algorithm} Credential={creds.access_key}/{scope}, "
        f"SignedHeaders={';'.join(signed)}, Signature={signature}"
    )
    del out["host"]  # transport sets it
    return out


def presign_url(
    creds: Credentials,
    method: str,
    url: str,
    expires_s: int = 3600,
    extra_params: dict[str, str] | None = None,
    now: datetime.datetime | None = None,
    spec: SigSpec = AWS_SIG,
    signed_headers: dict[str, str] | None = None,
) -> str:
    """Produce a presigned URL (query-string auth) for GET/PUT etc.

    ``signed_headers``: extra headers the CALLER promises to send verbatim
    (they join host in the signature — GCS resumable initiation signs
    ``x-goog-resumable: start`` this way)."""
    now = now or _now()
    amzdate = now.strftime("%Y%m%dT%H%M%SZ")
    datestamp = now.strftime("%Y%m%d")
    u = urllib.parse.urlsplit(url)
    scope = f"{datestamp}/{creds.region}/{creds.service}/{spec.request_suffix}"

    headers = {"host": u.netloc}
    headers.update({k.lower(): v for k, v in (signed_headers or {}).items()})
    signed = sorted(headers)
    query = dict(urllib.parse.parse_qsl(u.query, keep_blank_values=True))
    query.update(extra_params or {})
    query.update(
        {
            spec.param_prefix + "Algorithm": spec.algorithm,
            spec.param_prefix + "Credential": f"{creds.access_key}/{scope}",
            spec.param_prefix + "Date": amzdate,
            spec.param_prefix + "Expires": str(expires_s),
            spec.param_prefix + "SignedHeaders": ";".join(signed),
        }
    )
    creq = _canonical_request(method, u.path or "/", query, headers, signed, UNSIGNED_PAYLOAD)
    sts = _string_to_sign(amzdate, scope, creq, spec)
    signature = hmac.new(
        signing_key(creds, datestamp, spec), sts.encode(), hashlib.sha256
    ).hexdigest()
    query[spec.param_prefix + "Signature"] = signature
    return urllib.parse.urlunsplit((u.scheme, u.netloc, u.path, canonical_query(query), ""))
