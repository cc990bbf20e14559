"""Archive + digest helpers (counterpart of ``modelx_tpu/client/helper.py``):
deterministic tar.gz (cleared attributes, so a directory's digest is stable
across hosts and times, and equal to the JAX package's), the digest
computed while writing, extraction that preserves file modes, and the
descriptor of a file or of bytes.
"""

from __future__ import annotations

import gzip
import hashlib
import io
import os
import tarfile
from typing import BinaryIO

from modelx_tpu_torch.types import Descriptor, Digest, MediaTypeModelDirectoryTarGz


class _HashingWriter:
    """Tee writer: forwards to an optional sink while hashing (helper.go:24-53
    TGZ's MultiWriter)."""

    def __init__(self, sink: BinaryIO | None) -> None:
        self.sink = sink
        self.hasher = hashlib.sha256()
        self.size = 0

    def write(self, data: bytes) -> int:
        self.hasher.update(data)
        self.size += len(data)
        if self.sink is not None:
            self.sink.write(data)
        return len(data)

    def digest(self) -> Digest:
        return Digest("sha256:" + self.hasher.hexdigest())


def tgz(src_dir: str, dest: str | None) -> Descriptor:
    """Deterministic tar.gz of a directory; returns a Descriptor with the
    stream's digest and size. ``dest=None`` hashes without writing a file
    (used for the pull-side "is local dir already current?" check,
    pull.go:145-166)."""
    sink: BinaryIO | None = None
    if dest is not None:
        os.makedirs(os.path.dirname(dest) or ".", exist_ok=True)
        sink = open(dest, "wb")
    try:
        hw = _HashingWriter(sink)
        # mtime=0 + no original filename in the gzip header => deterministic
        with gzip.GzipFile(fileobj=hw, mode="wb", mtime=0, filename="") as gz:  # type: ignore[arg-type]
            with tarfile.open(fileobj=gz, mode="w", format=tarfile.PAX_FORMAT) as tar:
                entries = []
                for root, dirs, files in os.walk(src_dir):
                    dirs.sort()
                    for fn in sorted(files):
                        full = os.path.join(root, fn)
                        entries.append((os.path.relpath(full, src_dir).replace(os.sep, "/"), full))
                for arcname, full in sorted(entries):
                    info = tar.gettarinfo(full, arcname=arcname)
                    # ClearAttributes (helper.go:33-40): zero everything that
                    # varies across hosts so the digest is content-only
                    info.mtime = 0
                    info.uid = info.gid = 0
                    info.uname = info.gname = ""
                    info.mode = 0o755 if info.mode & 0o100 else 0o644
                    info.pax_headers = {}
                    with open(full, "rb") as f:
                        tar.addfile(info, f)
        return Descriptor(
            name=os.path.basename(src_dir),
            media_type=MediaTypeModelDirectoryTarGz,
            digest=str(hw.digest()),
            size=hw.size,
        )
    finally:
        if sink is not None:
            sink.close()


def untgz(src: str | BinaryIO, dest_dir: str) -> None:
    """helper.go:55-79 — extract preserving modes; refuses path escapes."""
    os.makedirs(dest_dir, exist_ok=True)
    f: BinaryIO
    if isinstance(src, str):
        f = open(src, "rb")
        close = True
    else:
        f, close = src, False
    try:
        with tarfile.open(fileobj=f, mode="r|gz") as tar:
            tar.extractall(dest_dir, filter="data")
    finally:
        if close:
            f.close()


def descriptor_for_file(path: str, name: str, media_type: str) -> Descriptor:
    """The descriptor of a regular file: its digest (the native engine's
    GIL-free sha256 when built), size, mode bits and mtime."""
    st = os.stat(path)
    return Descriptor(
        name=name,
        media_type=media_type,
        digest=str(Digest.from_file(path)),
        size=st.st_size,
        mode=st.st_mode & 0o777,
        modified=_rfc3339(st.st_mtime),
    )


def _rfc3339(ts: float) -> str:
    import datetime

    return (
        datetime.datetime.fromtimestamp(ts, tz=datetime.timezone.utc)
        .isoformat(timespec="seconds")
        .replace("+00:00", "Z")
    )


def descriptor_for_bytes(data: bytes, name: str, media_type: str) -> Descriptor:
    return Descriptor(
        name=name, media_type=media_type, digest=str(Digest.from_bytes(data)), size=len(data)
    )
