"""The push side of the client (counterpart of ``modelx_tpu/client/push.py``).

Only ``commit_delta_digests`` is ported so far: the derived-artifact
publishes (``dl/program_store.py``, ``dl/kv_store.py``) re-upload their
blob once when the registry's commit verification names it missing. The
directory pusher (``Pusher``, ``parse_manifest_from_dir``) comes with the
``modelx`` CLI in the control-plane slice.
"""

from __future__ import annotations

from modelx_tpu_torch import errors


def commit_delta_digests(e: errors.ErrorInfo) -> set[str]:
    """Digests the server's commit-verification 400 wants re-pushed:
    ``detail`` carries ``{"missing": [...], "sizeMismatch": [{"digest":
    ...}]}``. Empty set = not a delta-shaped error."""
    if e.http_status != 400 or not isinstance(e.detail, dict):
        return set()
    out = {d for d in e.detail.get("missing", ()) if isinstance(d, str)}
    for m in e.detail.get("sizeMismatch", ()):
        if isinstance(m, dict) and isinstance(m.get("digest"), str):
            out.add(m["digest"])
    return out
