"""Registry operations built on the client API: copy, diff and verify
(counterpart of ``modelx_tpu/client/ops.py``; the same results).

- ``copy_model``: replicate one model version between registries (or repos)
  with content-address skip — blobs the destination already holds move zero
  bytes, so promoting ``staging -> prod`` after a small delta re-push costs
  only the changed shards. Bytes are re-hashed in transit; a digest
  mismatch aborts before the manifest commit, so a partial copy is never
  addressable.
- ``verify_repo``: registry fsck — re-hash every blob a repo's manifests
  reference and report digest/size mismatches and missing blobs.

Reference parity: none — the reference offers no cross-registry copy or
integrity audit; both are standard registry tooling (think ``crane cp`` /
``oras cp`` in the OCI world) rebuilt on this client.
"""

from __future__ import annotations

import hashlib
import http.client
import tempfile
from typing import Callable

from modelx_tpu_torch import errors
from modelx_tpu_torch.types import Descriptor


def _stream_and_hash(remote, repository: str, desc: Descriptor, sink) -> tuple[str, int]:
    """Stream one blob into ``sink`` (or nowhere), returning (digest, size).
    A mid-stream transport failure surfaces as ErrorInfo — the iterator
    raises the raw ``OSError`` or ``http.client.HTTPException`` that the
    client wrapper only catches for the initial call, and a multi-hour
    fsck must not die to one blip."""
    h = hashlib.sha256()
    n = 0
    try:
        for chunk in remote.get_blob_content(repository, desc.digest):
            h.update(chunk)
            n += len(chunk)
            if sink is not None:
                sink.write(chunk)
    except (OSError, http.client.HTTPException) as e:
        raise errors.ErrorInfo(
            502, errors.ErrCodeUnknown,
            f"stream of {desc.name or desc.digest} interrupted: {e}",
        ) from e
    return f"sha256:{h.hexdigest()}", n


def copy_model(
    src_remote,
    src_repo: str,
    src_version: str,
    dst_remote,
    dst_repo: str,
    dst_version: str,
    log: Callable[[str], None] = lambda s: None,
) -> dict:
    """Copy one model version; returns {blobs, copied, skipped, bytes}."""
    manifest = src_remote.get_manifest(src_repo, src_version)
    copied = skipped = moved = 0
    for desc in manifest.all_descriptors():
        if dst_remote.head_blob(dst_repo, desc.digest):
            skipped += 1
            log(f"skip  {desc.name or desc.digest[:19]} (already present)")
            continue
        # spool through disk, not RAM: model blobs are multi-GB
        with tempfile.SpooledTemporaryFile(max_size=64 << 20) as spool:
            digest, size = _stream_and_hash(src_remote, src_repo, desc, spool)
            if digest != desc.digest or (desc.size and size != desc.size):
                raise errors.ErrorInfo(
                    502,
                    errors.ErrCodeDigestInvalid,
                    f"source blob {desc.name or desc.digest} corrupt in "
                    f"transit: got {digest} ({size}B), want {desc.digest} "
                    f"({desc.size}B)",
                )
            spool.seek(0)
            dst_remote.upload_blob_content(dst_repo, desc, spool)
        copied += 1
        moved += size
        log(f"copy  {desc.name or desc.digest[:19]} ({size} bytes)")
    # manifest PUT last: the commit point, same as push (push.go:56-64)
    dst_remote.put_manifest(dst_repo, dst_version, manifest)
    return {"blobs": copied + skipped, "copied": copied, "skipped": skipped,
            "bytes": moved}


def diff_versions(
    a_remote, a_repo: str, a_version: str,
    b_remote, b_repo: str, b_version: str,
) -> dict:
    """Manifest-level diff of two model versions — zero blob bytes move.

    Returns {added, removed, changed, unchanged: [blob names], bytes_added,
    bytes_unchanged, tensors: {added, removed, layout_changed} | None}.
    ``tensors`` compares the safetensors tensor-index annotations when both
    sides carry them (docs/annotations.md): for a checkpoint re-pushed
    after training, it names exactly which tensors changed inside a
    changed blob (layout_changed = shape/dtype differs; same-layout
    tensors in a changed blob are possibly-changed and not listed)."""
    from modelx_tpu_torch.dl import safetensors as st
    from modelx_tpu_torch.types import AnnotationTensorIndex

    ma = a_remote.get_manifest(a_repo, a_version)
    mb = b_remote.get_manifest(b_repo, b_version)
    da = {d.name: d for d in ma.all_descriptors()}
    db = {d.name: d for d in mb.all_descriptors()}
    added = sorted(set(db) - set(da))
    removed = sorted(set(da) - set(db))
    changed = sorted(n for n in set(da) & set(db) if da[n].digest != db[n].digest)
    unchanged = sorted(n for n in set(da) & set(db) if da[n].digest == db[n].digest)

    tensors = None
    pairs = [
        (da[n], db[n]) for n in changed
        if AnnotationTensorIndex in da[n].annotations
        and AnnotationTensorIndex in db[n].annotations
    ]
    if pairs:
        t_added, t_removed, t_changed = [], [], []
        for desc_a, desc_b in pairs:
            try:
                ia, _ = st.parse_index_annotation(desc_a.annotations[AnnotationTensorIndex])
                ib, _ = st.parse_index_annotation(desc_b.annotations[AnnotationTensorIndex])
            except (ValueError, KeyError, TypeError) as e:
                # a corrupt annotation (older/buggy pusher) degrades this
                # pair to blob-level diff; it must not kill the whole diff
                t_changed.append(f"<{desc_b.name}: unreadable tensor index: {e}>")
                continue
            t_added += sorted(set(ib) - set(ia))
            t_removed += sorted(set(ia) - set(ib))
            # the index carries shapes/dtypes/offsets, not content hashes:
            # "changed" here means layout changed; same-layout tensors in a
            # changed blob are "possibly changed" and are not listed
            t_changed += sorted(
                n for n in set(ia) & set(ib)
                if (ia[n].shape, ia[n].dtype) != (ib[n].shape, ib[n].dtype)
            )
        tensors = {"added": t_added, "removed": t_removed,
                   "layout_changed": t_changed}
    return {
        "added": added,
        "removed": removed,
        "changed": changed,
        "unchanged": unchanged,
        "bytes_added": sum(db[n].size for n in added + changed),
        "bytes_unchanged": sum(db[n].size for n in unchanged),
        "tensors": tensors,
    }


def verify_repo(
    remote,
    repository: str,
    version: str = "",
    log: Callable[[str], None] = lambda s: None,
) -> dict:
    """Re-hash every referenced blob; returns {versions, blobs,
    program_blobs, bytes, errors: [str]} (shared blobs across versions
    hash once; program_blobs counts the compiled-program bundle
    descriptors among them)."""
    from modelx_tpu_torch.types import MediaTypeModelProgram

    if version:
        versions = [version]
    else:
        index = remote.get_index(repository)
        versions = [m.name for m in index.manifests]
    seen: dict[str, str | None] = {}  # digest -> error (None = ok)
    problems: list[str] = []
    total_bytes = 0
    blob_count = 0
    program_count = 0
    for ver in versions:
        try:
            manifest = remote.get_manifest(repository, ver)
        except errors.ErrorInfo as e:
            problems.append(f"{ver}: manifest unreadable: {e}")
            continue
        for desc in manifest.all_descriptors():
            blob_count += 1
            if desc.media_type == MediaTypeModelProgram:
                program_count += 1
            if desc.digest in seen:
                if seen[desc.digest]:
                    problems.append(f"{ver}/{desc.name}: {seen[desc.digest]}")
                continue
            err: str | None = None
            try:
                digest, size = _stream_and_hash(remote, repository, desc, None)
                if digest != desc.digest:
                    err = f"digest mismatch: got {digest}, want {desc.digest}"
                elif desc.size and size != desc.size:
                    err = f"size mismatch: got {size}, want {desc.size}"
                else:
                    total_bytes += size
            except errors.ErrorInfo as e:
                err = f"unreadable: {e}"
            seen[desc.digest] = err
            if err:
                problems.append(f"{ver}/{desc.name}: {err}")
                log(f"BAD   {ver}/{desc.name}: {err}")
            else:
                log(f"ok    {ver}/{desc.name}")
    return {"versions": len(versions), "blobs": blob_count,
            "program_blobs": program_count,
            "bytes": total_bytes, "errors": problems}
