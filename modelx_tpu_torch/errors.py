"""OCI-distribution-style error model (counterpart of ``modelx_tpu/errors.py``).

Same codes, same HTTP status mapping and the same JSON body shape
``{"code": ..., "message": ..., "detail": ...}``, byte for byte, as the JAX
package's registry answers.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any

# Error codes (errors.go:12-31) — mirrors the OCI distribution spec.
ErrCodeBlobUnknown = "BLOB_UNKNOWN"
ErrCodeBlobUploadInvalid = "BLOB_UPLOAD_INVALID"
ErrCodeBlobUploadUnknown = "BLOB_UPLOAD_UNKNOWN"
ErrCodeDigestInvalid = "DIGEST_INVALID"
ErrCodeManifestBlobUnknown = "MANIFEST_BLOB_UNKNOWN"
ErrCodeManifestInvalid = "MANIFEST_INVALID"
ErrCodeManifestUnknown = "MANIFEST_UNKNOWN"
ErrCodeNameInvalid = "NAME_INVALID"
ErrCodeNameUnknown = "NAME_UNKNOWN"
ErrCodeIndexUnknown = "INDEX_UNKNOWN"
ErrCodeSizeInvalid = "SIZE_INVALID"
ErrCodeUnauthorized = "UNAUTHORIZED"
ErrCodeDenied = "DENIED"
ErrCodeUnsupported = "UNSUPPORTED"
ErrCodeTooManyRequests = "TOOMANYREQUESTS"
ErrCodeConfigInvalid = "CONFIG_INVALID"
ErrCodeInternal = "INTERNAL"
ErrCodeUnknown = "UNKNOWN"


@dataclasses.dataclass
class ErrorInfo(Exception):
    """errors.go:35-44 — carries HTTP status + machine code + message.

    ``detail`` is either a human string or a JSON-serializable structure:
    commit-verification failures carry ``{"missing": [...], "sizeMismatch":
    [...]}`` so clients can re-push exactly the delta (docs/api.md)."""

    http_status: int = 500
    code: str = ErrCodeUnknown
    message: str = ""
    detail: Any = ""

    def __post_init__(self) -> None:
        super().__init__(self.message or self.code)

    def to_json(self) -> dict[str, Any]:
        return {"code": self.code, "message": self.message, "detail": self.detail}

    def encode(self) -> bytes:
        return json.dumps(self.to_json()).encode()

    @classmethod
    def decode(cls, data: bytes, http_status: int = 500) -> "ErrorInfo":
        try:
            d = json.loads(data)
            if not isinstance(d, dict):
                raise ValueError
        except (ValueError, UnicodeDecodeError):
            return cls(http_status=http_status, code=ErrCodeUnknown, message=data.decode(errors="replace"))
        return cls(
            http_status=http_status,
            code=d.get("code", ErrCodeUnknown),
            message=d.get("message", ""),
            detail=d.get("detail", ""),
        )

    def __str__(self) -> str:
        s = f"{self.code}: {self.message}"
        if self.detail:
            s += f" ({self.detail})"
        return s


def is_err_code(err: BaseException, code: str) -> bool:
    """errors.go:46-55 IsErrCode."""
    return isinstance(err, ErrorInfo) and err.code == code


# Constructors (errors.go:57-107)


def blob_unknown(digest: str) -> ErrorInfo:
    return ErrorInfo(404, ErrCodeBlobUnknown, f"blob unknown: {digest}")


def blob_upload_invalid(detail: str = "") -> ErrorInfo:
    return ErrorInfo(400, ErrCodeBlobUploadInvalid, "blob upload invalid", detail)


def digest_invalid(digest: str, detail: str = "") -> ErrorInfo:
    return ErrorInfo(400, ErrCodeDigestInvalid, f"digest invalid: {digest}", detail)


def manifest_blob_unknown(digest: str) -> ErrorInfo:
    return ErrorInfo(404, ErrCodeManifestBlobUnknown, f"manifest blob unknown: {digest}")


def manifest_invalid(detail: str = "") -> ErrorInfo:
    return ErrorInfo(400, ErrCodeManifestInvalid, "manifest invalid", detail)


def manifest_unknown(reference: str) -> ErrorInfo:
    return ErrorInfo(404, ErrCodeManifestUnknown, f"manifest unknown: {reference}")


def name_invalid(name: str, detail: str = "") -> ErrorInfo:
    return ErrorInfo(400, ErrCodeNameInvalid, f"name invalid: {name}", detail)


def name_unknown(name: str) -> ErrorInfo:
    return ErrorInfo(404, ErrCodeNameUnknown, f"repository name unknown: {name}")


def index_unknown(name: str) -> ErrorInfo:
    return ErrorInfo(404, ErrCodeIndexUnknown, f"index unknown: {name}")


def size_invalid(detail: str = "") -> ErrorInfo:
    return ErrorInfo(400, ErrCodeSizeInvalid, "size invalid", detail)


def commit_invalid(missing: list[str], mismatched: list[dict]) -> ErrorInfo:
    """Manifest-PUT commit verification failed: the manifest references
    blobs that are absent or whose stored size disagrees with the
    descriptor. A structured 400 — ``detail`` carries the exact delta so
    the client re-pushes only those digests instead of the whole model.
    The code stays SIZE_INVALID when every problem is a size mismatch
    (the pre-existing S3 commit contract); any missing blob makes it
    MANIFEST_BLOB_UNKNOWN."""
    code = ErrCodeManifestBlobUnknown if missing else ErrCodeSizeInvalid
    return ErrorInfo(
        400,
        code,
        "manifest commit verification failed",
        {"missing": list(missing), "sizeMismatch": list(mismatched)},
    )


def unauthorized(detail: str = "") -> ErrorInfo:
    return ErrorInfo(401, ErrCodeUnauthorized, "authentication required", detail)


def denied(detail: str = "") -> ErrorInfo:
    return ErrorInfo(403, ErrCodeDenied, "requested access to the resource is denied", detail)


def unsupported(detail: str = "") -> ErrorInfo:
    return ErrorInfo(405, ErrCodeUnsupported, "the operation is unsupported", detail)


def too_many_requests(detail: str = "") -> ErrorInfo:
    return ErrorInfo(429, ErrCodeTooManyRequests, "too many requests", detail)


def config_invalid(detail: str = "") -> ErrorInfo:
    return ErrorInfo(400, ErrCodeConfigInvalid, "config invalid", detail)


def internal(detail: str = "") -> ErrorInfo:
    return ErrorInfo(500, ErrCodeInternal, "internal error", detail)
