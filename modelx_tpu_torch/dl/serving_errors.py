"""Typed serving errors and the resume wire contract (the part of
``modelx_tpu/dl/serving_errors.py`` this port serves; a copy, since the port
imports nothing of the JAX package).

A ``resume`` block continues a severed stream: the emitted token ids and
the original seed, as the native ``resume`` field or as the
``X-ModelX-Resume-*`` headers. Continuing one needs the continuous engine,
which is not ported, so a well-formed resume is refused exactly as the JAX
sidecar without ``--continuous-batch`` refuses it.
"""

from __future__ import annotations

RESUME_EMITTED_HEADER = "X-ModelX-Resume-Emitted"
RESUME_SEED_HEADER = "X-ModelX-Resume-Seed"


class ServingError(RuntimeError):
    """Base for typed serving failures; ``http_status`` is the status every
    transport answers with."""

    http_status = 500

    def headers(self) -> dict[str, str]:
        return {}


class MalformedResumeError(ServingError):
    """A resume block the pod cannot honor as stated (400): the caller must
    not silently restart a stream the client already holds k tokens of."""

    http_status = 400

    def __init__(self, detail: str) -> None:
        super().__init__(f"malformed resume: {detail}")


class ResumeExhaustedError(ServingError):
    """The resume frontier is at or past the request's end (422): every
    budgeted token, or a stop token, was already emitted."""

    http_status = 422

    def __init__(self, detail: str) -> None:
        super().__init__(f"resume exhausted: {detail}")


def parse_resume(emitted_value, seed_value):
    """Resume block -> ``(emitted token ids, seed)``, or None when absent.
    ``emitted_value`` is the header's comma-separated string or the native
    field's id list; ``seed_value`` the header string or native int.
    Anything not honorable as stated raises ``MalformedResumeError``."""
    if emitted_value is None and seed_value is None:
        return None
    if emitted_value is None or seed_value is None:
        raise MalformedResumeError(
            "resume requires both the emitted tokens and the original seed"
        )
    try:
        seed = int(str(seed_value).strip())
    except (TypeError, ValueError):
        raise MalformedResumeError(
            f"resume seed {seed_value!r} is not an integer"
        ) from None
    if not 0 <= seed < 2**31:
        raise MalformedResumeError(f"resume seed {seed} out of [0, 2^31)")
    if isinstance(emitted_value, str):
        parts = [p for p in emitted_value.split(",") if p.strip()]
    elif isinstance(emitted_value, (list, tuple)):
        parts = list(emitted_value)
    else:
        raise MalformedResumeError("resume emitted must be a token id list")
    if not parts:
        raise MalformedResumeError("resume emitted is empty: nothing to resume")
    emitted = []
    for p in parts:
        try:
            t = int(str(p).strip())
        except (TypeError, ValueError):
            raise MalformedResumeError(
                f"resume emitted token {p!r} is not an integer"
            ) from None
        if t < 0:
            raise MalformedResumeError(f"resume emitted token {t} is negative")
        emitted.append(t)
    return emitted, seed
