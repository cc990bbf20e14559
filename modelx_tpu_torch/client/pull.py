"""Pull engine: manifest -> concurrent blob downloads with hash-skip
(counterpart of ``modelx_tpu/client/pull.py``):

- per-file content-address skip: a local file whose sha256 equals the
  descriptor's digest is not downloaded again, so every pull is an
  incremental resume;
- an interrupted download resumes its sequential prefix with a ranged GET;
- directory blobs: compare the deterministic tgz digest, then download and
  extract through a pipe;
- the registry's download location first (``file`` or presigned URL),
  the direct GET when the location is not usable here.

``stats`` counts what each pull moved: blobs downloaded and their bytes,
and blobs found up to date.
"""

from __future__ import annotations

import hashlib
import os
from typing import Callable

import threading

from modelx_tpu_torch.client import helper
from modelx_tpu_torch.client.extension import LocationUnreachable, get_extension
from modelx_tpu_torch.client.progress import PULL_PUSH_CONCURRENCY, run_jobs
from modelx_tpu_torch.client.remote import RegistryClient
from modelx_tpu_torch.types import (
    BlobLocationPurposeDownload,
    Descriptor,
    Digest,
    Manifest,
    MediaTypeModelDirectoryTarGz,
)
from modelx_tpu_torch.utils import trace


class _HashingFile:
    """Seekable file wrapper that hashes writes as long as they stay
    sequential; any seek/truncate invalidates the running hash (the ranged
    downloader will seek, sequential streams will not)."""

    def __init__(self, f) -> None:
        self._f = f
        self._hasher = hashlib.sha256()
        self._pos = 0
        self._dirty = False

    def write(self, data: bytes) -> int:
        if not self._dirty:
            self._hasher.update(data)
            self._pos += len(data)
        return self._f.write(data)

    def seek(self, offset: int, whence: int = 0):
        if not (whence == 0 and offset == self._pos):
            self._dirty = True
        return self._f.seek(offset, whence)

    def truncate(self, *a):
        self._dirty = True
        return self._f.truncate(*a)

    def seekable(self) -> bool:
        return True

    def tell(self) -> int:
        return self._f.tell()

    def digest(self) -> str | None:
        return None if self._dirty else "sha256:" + self._hasher.hexdigest()


class Puller:
    def __init__(self, remote: RegistryClient, quiet: bool = False, concurrency: int | None = None):
        self.remote = remote
        self.quiet = quiet
        self.concurrency = concurrency or PULL_PUSH_CONCURRENCY
        self._lock = threading.Lock()
        self.stats = {"downloaded": 0, "downloaded_bytes": 0, "up_to_date": 0}

    def _count(self, key: str, n: int = 1) -> None:
        with self._lock:
            self.stats[key] += n

    def pull(self, repository: str, version: str, directory: str) -> Manifest:
        manifest = self.remote.get_manifest(repository, version)
        os.makedirs(directory, exist_ok=True)
        self.pull_blobs(repository, manifest, directory)
        return manifest

    def pull_blobs(self, repository: str, manifest: Manifest, directory: str) -> None:
        """Bounded-concurrency fan-out over the manifest's blobs."""

        def job(desc: Descriptor) -> Callable[[], None]:
            def run() -> None:
                if desc.media_type == MediaTypeModelDirectoryTarGz:
                    self._pull_directory(repository, desc, directory)
                else:
                    self._pull_file(repository, desc, directory)

            return run

        descs = [d for d in manifest.all_descriptors() if d.digest]
        run_jobs([job(d) for d in descs], self.concurrency)

    # -- files ----------------------------------------------------------------

    def _pull_file(self, repository: str, desc: Descriptor, directory: str) -> None:
        with trace.span("pull.blob", blob=desc.name, bytes=desc.size):
            self._pull_file_inner(repository, desc, directory)

    def _pull_file_inner(self, repository: str, desc: Descriptor, directory: str) -> None:
        target = os.path.join(directory, desc.name)
        if os.path.isfile(target) and str(Digest.from_file(target)) == desc.digest:
            self._count("up_to_date")  # hash-skip
            return
        os.makedirs(os.path.dirname(target) or ".", exist_ok=True)
        # content-addressed partial file: an interrupted download resumes
        # from its sequential prefix with a ranged GET. The name also
        # hashes desc.name so duplicate-digest blobs in one
        # manifest don't share a partial, and an flock guards against a
        # concurrent pull into the same directory (shared volumes).
        hexpart = desc.digest.split(":", 1)[-1][:16]
        namepart = hashlib.sha256(desc.name.encode()).hexdigest()[:8]
        tmp = os.path.join(directory, f".partial-{hexpart}-{namepart}")
        lock_path = tmp + ".lock"
        lock_fd = os.open(lock_path, os.O_CREAT | os.O_RDWR, 0o600)
        have_lock = False
        try:
            import fcntl

            try:
                fcntl.flock(lock_fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
                have_lock = True
            except OSError:
                # another puller owns this partial: use a private temp and
                # skip resume rather than corrupt theirs
                import tempfile

                fd, tmp = tempfile.mkstemp(dir=directory, prefix=".pull-")
                os.close(fd)
            try:
                self._download_to_partial(repository, desc, tmp)
            except ValueError:
                # corrupt partial (bad prefix bytes): restart once from scratch
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
                self._download_to_partial(repository, desc, tmp)
            os.chmod(tmp, desc.mode or 0o644)
            os.replace(tmp, target)
        finally:
            os.close(lock_fd)
            if have_lock:  # never remove a lock another process holds
                try:
                    os.unlink(lock_path)
                except OSError:
                    pass
        self._count("downloaded")

    def _download_to_partial(self, repository: str, desc: Descriptor, tmp: str) -> None:
        """Download into the partial file, resuming its sequential prefix if
        one exists; verifies the digest. Keeps the partial for a future
        resume on transient failure, removes it when its bytes are bad."""
        resumed_from = 0
        if os.path.isfile(tmp):
            size = os.path.getsize(tmp)
            if 0 < size < desc.size:
                resumed_from = size
            else:
                os.unlink(tmp)  # empty or oversized: start over
        hf = None
        bad = False
        try:
            if resumed_from:
                with open(tmp, "r+b") as f:
                    hf = _HashingFile(f)
                    with open(tmp, "rb") as prev:  # hash the existing prefix
                        while chunk := prev.read(4 * 1024 * 1024):
                            hf._hasher.update(chunk)
                            hf._pos += len(chunk)
                    f.seek(resumed_from)
                    for chunk in self.remote.get_blob_content(
                        repository, desc.digest, offset=resumed_from
                    ):
                        hf.write(chunk)
                        self._count("downloaded_bytes", len(chunk))
            else:
                with open(tmp, "wb") as f:
                    hf = _HashingFile(f)
                    self._download_blob(repository, desc, hf)
            # sequential downloads hashed inline for free; out-of-order
            # (ranged) downloads need a post-hoc re-read
            got = hf.digest() or str(Digest.from_file(tmp))
            if got != desc.digest:
                bad = True  # corrupt bytes must not be resumed
                raise ValueError(f"digest mismatch for {desc.name}: got {got}, want {desc.digest}")
        except BaseException:
            # keep a clean sequential prefix for the next attempt to resume;
            # anything with holes (the ranged/extension writer seeked) or
            # bad bytes dies — recomputed here because a mid-download error
            # never reaches the lines above
            if bad or hf is None or hf._dirty:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
            raise

    # -- directories -----------------------------------------------------------

    def _pull_directory(self, repository: str, desc: Descriptor, directory: str) -> None:
        """tgz-digest compare, then streaming download+extract."""
        target = os.path.join(directory, desc.name)
        if os.path.isdir(target):
            local = helper.tgz(target, None)  # hash without writing
            if local.digest == desc.digest:
                self._count("up_to_date")
                return
        # stream download straight into the tar extractor via a pipe
        import threading

        rfd, wfd = os.pipe()
        reader = os.fdopen(rfd, "rb")
        writer = os.fdopen(wfd, "wb")
        errs: list[BaseException] = []

        def extract() -> None:
            try:
                helper.untgz(reader, target)
            except BaseException as e:  # surfaced after join
                errs.append(e)
                try:
                    reader.close()
                except OSError:
                    pass

        t = threading.Thread(target=extract, daemon=True)
        t.start()
        try:
            self._download_blob(repository, desc, writer)
        except BrokenPipeError:
            # extractor died and closed the pipe; its error (in errs) is the
            # real cause — don't let the pipe write mask it
            pass
        finally:
            try:
                writer.close()
            except OSError:
                pass
            t.join()
        if errs:
            raise errs[0]
        self._count("downloaded")

    # -- shared download path --------------------------------------------------

    def _download_blob(self, repository: str, desc: Descriptor, writer) -> None:
        """The download location first, the direct GET as the fallback."""
        location = self.remote.get_blob_location(repository, desc, BlobLocationPurposeDownload)
        if location is not None:
            ext = get_extension(location.provider)
            try:
                ext.download(location, desc, writer,
                             progress=lambda n: self._count("downloaded_bytes", n))
                return
            except LocationUnreachable:
                # a location only a colocated client could use (e.g. a file
                # path on the registry host): take the direct GET instead
                pass
        for chunk in self.remote.get_blob_content(repository, desc.digest):
            writer.write(chunk)
            self._count("downloaded_bytes", len(chunk))
