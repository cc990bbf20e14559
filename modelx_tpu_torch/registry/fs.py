"""FSProvider: the raw object storage under the registry store (counterpart
of ``modelx_tpu/registry/fs.py``): ``put/get/stat/remove/exists/list``
with ranged ``get``, so blob bytes stream per range toward the card.
Implementations: ``MemoryFSProvider`` (tests) and ``LocalFSProvider``
(files under a base path, written through a temp file + rename, with a
``.meta`` sidecar for the content type). S3 and GCS come with the
control-plane slice.
"""

from __future__ import annotations

import dataclasses
import io
import json
import os
import shutil
import tempfile
import threading
import time
from typing import BinaryIO, Protocol, runtime_checkable


@dataclasses.dataclass
class FSMeta:
    """Stat result (fs.go FsObjectMeta)."""

    name: str
    size: int
    last_modified: float = 0.0
    content_type: str = ""


@dataclasses.dataclass
class FSContent:
    """A readable object plus its metadata."""

    reader: BinaryIO
    size: int
    content_type: str = ""

    def read_all(self) -> bytes:
        try:
            return self.reader.read()
        finally:
            self.reader.close()


class FSNotFound(FileNotFoundError):
    pass


@runtime_checkable
class FSProvider(Protocol):
    """fs.go:15-22, plus ranged get."""

    def put(self, path: str, content: BinaryIO, size: int = -1, content_type: str = "") -> None: ...

    def get(self, path: str, offset: int = 0, length: int = -1) -> FSContent: ...

    def stat(self, path: str) -> FSMeta: ...

    def remove(self, path: str) -> None: ...

    def exists(self, path: str) -> bool: ...

    def list(self, prefix: str, recursive: bool = False) -> list[FSMeta]: ...


def _norm(path: str) -> str:
    return path.strip("/")


class MemoryFSProvider:
    """In-memory provider: the hermetic test fake."""

    def __init__(self) -> None:
        self._objects: dict[str, tuple[bytes, str, float]] = {}
        self._lock = threading.Lock()

    def put(self, path: str, content: BinaryIO, size: int = -1, content_type: str = "") -> None:
        data = content.read()
        if size >= 0 and len(data) != size:
            raise ValueError(f"size mismatch: declared {size}, got {len(data)}")
        with self._lock:
            self._objects[_norm(path)] = (data, content_type, time.time())

    def get(self, path: str, offset: int = 0, length: int = -1) -> FSContent:
        with self._lock:
            try:
                data, ctype, _ = self._objects[_norm(path)]
            except KeyError:
                raise FSNotFound(path) from None
        if offset or length >= 0:
            end = len(data) if length < 0 else offset + length
            data = data[offset:end]
        return FSContent(reader=io.BytesIO(data), size=len(data), content_type=ctype)

    def stat(self, path: str) -> FSMeta:
        with self._lock:
            try:
                data, ctype, mtime = self._objects[_norm(path)]
            except KeyError:
                raise FSNotFound(path) from None
        return FSMeta(name=_norm(path), size=len(data), last_modified=mtime, content_type=ctype)

    def remove(self, path: str) -> None:
        p = _norm(path)
        with self._lock:
            # Remove the object, or — like a prefix delete — everything under it.
            if p in self._objects:
                del self._objects[p]
                return
            doomed = [k for k in self._objects if k.startswith(p + "/")]
            if not doomed:
                raise FSNotFound(path)
            for k in doomed:
                del self._objects[k]

    def exists(self, path: str) -> bool:
        with self._lock:
            return _norm(path) in self._objects

    def list(self, prefix: str, recursive: bool = False) -> list[FSMeta]:
        p = _norm(prefix)
        out: list[FSMeta] = []
        seen_dirs: set[str] = set()
        with self._lock:
            items = sorted(self._objects.items())
        for key, (data, ctype, mtime) in items:
            if p and not (key == p or key.startswith(p + "/")):
                continue
            rel = key[len(p) :].lstrip("/") if p else key
            if not recursive and "/" in rel:
                # surface only the first path element, as a directory entry
                d = rel.split("/", 1)[0]
                if d not in seen_dirs:
                    seen_dirs.add(d)
                    out.append(FSMeta(name=d, size=0, last_modified=mtime))
                continue
            out.append(FSMeta(name=rel, size=len(data), last_modified=mtime, content_type=ctype))
        return out


class LocalFSProvider:
    """Objects as files under a base path, with a sidecar ``<path>.meta``
    JSON carrying the content type, and flat or recursive listing. Writes go
    through a temp file + rename so concurrent readers never observe
    partial objects."""

    META_SUFFIX = ".meta"

    def __init__(self, basepath: str, fsync: bool = True) -> None:
        self.basepath = os.path.abspath(basepath)
        self.fsync = fsync
        os.makedirs(self.basepath, exist_ok=True)

    def _abs(self, path: str) -> str:
        p = os.path.normpath(os.path.join(self.basepath, _norm(path)))
        if not (p == self.basepath or p.startswith(self.basepath + os.sep)):
            raise ValueError(f"path escapes basepath: {path}")
        return p

    def put(self, path: str, content: BinaryIO, size: int = -1, content_type: str = "") -> None:
        abspath = self._abs(path)
        os.makedirs(os.path.dirname(abspath), exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(abspath), prefix=".tmp-")
        try:
            written = 0
            with os.fdopen(fd, "wb") as f:
                shutil.copyfileobj(content, f, 4 * 1024 * 1024)
                written = f.tell()
                if size >= 0 and written != size:
                    raise ValueError(f"size mismatch: declared {size}, got {written}")
                if self.fsync:
                    # fsync-before-rename: without it a host crash can leave
                    # the rename durable but the DATA torn — a committed,
                    # visible blob with garbage bytes. The rename's own
                    # durability comes from the directory fsync below.
                    f.flush()
                    os.fsync(f.fileno())
            os.chmod(tmp, 0o644)
            os.replace(tmp, abspath)
            if self.fsync:
                dfd = os.open(os.path.dirname(abspath), os.O_RDONLY)
                try:
                    os.fsync(dfd)
                finally:
                    os.close(dfd)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        if content_type:
            meta = json.dumps({"contentType": content_type}).encode()
            with open(abspath + self.META_SUFFIX, "wb") as f:
                f.write(meta)

    def _content_type(self, abspath: str) -> str:
        try:
            with open(abspath + self.META_SUFFIX, "rb") as f:
                return json.load(f).get("contentType", "")
        except (OSError, ValueError):
            return ""

    def get(self, path: str, offset: int = 0, length: int = -1) -> FSContent:
        abspath = self._abs(path)
        try:
            f = open(abspath, "rb")  # noqa: SIM115 — handed to caller
        except FileNotFoundError:
            raise FSNotFound(path) from None
        total = os.fstat(f.fileno()).st_size
        if offset:
            f.seek(offset)
        size = total - offset if length < 0 else min(length, total - offset)
        reader: BinaryIO = f
        if length >= 0:
            reader = _LimitedReader(f, size)  # type: ignore[assignment]
        return FSContent(reader=reader, size=size, content_type=self._content_type(abspath))

    def stat(self, path: str) -> FSMeta:
        abspath = self._abs(path)
        try:
            st = os.stat(abspath)
        except FileNotFoundError:
            raise FSNotFound(path) from None
        return FSMeta(
            name=_norm(path),
            size=st.st_size,
            last_modified=st.st_mtime,
            content_type=self._content_type(abspath),
        )

    def local_path(self, path: str) -> str:
        """Absolute on-disk path for an object — the hook the FS store's
        ``file`` blob-location redirect uses. Only providers physically
        backed by a local filesystem define this method."""
        return self._abs(path)

    def remove(self, path: str) -> None:
        abspath = self._abs(path)
        if os.path.isdir(abspath):
            shutil.rmtree(abspath)
            return
        try:
            os.unlink(abspath)
        except FileNotFoundError:
            raise FSNotFound(path) from None
        try:
            os.unlink(abspath + self.META_SUFFIX)
        except FileNotFoundError:
            pass

    def exists(self, path: str) -> bool:
        return os.path.isfile(self._abs(path))

    def list(self, prefix: str, recursive: bool = False) -> list[FSMeta]:
        base = self._abs(prefix)
        if not os.path.isdir(base):
            return []
        out: list[FSMeta] = []
        if recursive:
            for root, _dirs, files in os.walk(base):
                for fn in sorted(files):
                    if fn.endswith(self.META_SUFFIX) or fn.startswith(".tmp-"):
                        continue
                    full = os.path.join(root, fn)
                    try:
                        st = os.stat(full)
                    except FileNotFoundError:
                        continue  # removed between walk and stat
                    out.append(
                        FSMeta(
                            name=os.path.relpath(full, base).replace(os.sep, "/"),
                            size=st.st_size,
                            last_modified=st.st_mtime,
                        )
                    )
        else:
            for entry in sorted(os.scandir(base), key=lambda e: e.name):
                if entry.name.endswith(self.META_SUFFIX) or entry.name.startswith(".tmp-"):
                    continue
                try:
                    st = entry.stat()
                except FileNotFoundError:
                    continue  # removed between scandir and stat
                out.append(
                    FSMeta(
                        name=entry.name,
                        size=0 if entry.is_dir() else st.st_size,
                        last_modified=st.st_mtime,
                    )
                )
        return sorted(out, key=lambda m: m.name)


class _LimitedReader(io.RawIOBase):
    """Read at most ``limit`` bytes from an underlying file, then EOF.

    Exposes ``raw_file`` so the HTTP server can sendfile() the range."""

    def __init__(self, f: BinaryIO, limit: int) -> None:
        self._f = f
        self._remaining = limit

    @property
    def raw_file(self) -> BinaryIO:
        return self._f

    def read(self, n: int = -1) -> bytes:  # type: ignore[override]
        if self._remaining <= 0:
            return b""
        if n < 0 or n > self._remaining:
            n = self._remaining
        data = self._f.read(n)
        self._remaining -= len(data)
        return data

    def readable(self) -> bool:
        return True

    def close(self) -> None:
        self._f.close()
        super().close()
