"""The port's local blob cache (modelx_tpu_torch.dl.blob_cache), the cases
of tests/test_blob_cache.py on the CPU: the cold tee admits a verified
blob, a partial spool is discarded without a hidden download, a dead tee
leaves the load uncached, a warm load makes zero network reads, a tampered
entry is evicted and fetched again, LRU eviction at the byte cap, an
over-cap blob is refused, stale spools of dead processes are swept,
mismatched admits are refused, and concurrent admits of one digest race
to identical bytes. Tensors loaded through the cache must equal the
written arrays exactly (tolerance 0)."""

import os
import threading

import numpy as np
import pytest

from modelx_tpu_torch.dl import blob_cache as bc
from modelx_tpu_torch.dl import safetensors as st
from modelx_tpu_torch.dl.blob_cache import BlobCache, CachingByteSource
from modelx_tpu_torch.dl.loader import LocalFileSource, load_safetensors
from modelx_tpu_torch.types import Digest


class SpySource(LocalFileSource):
    """A 'network' stand-in that counts every ranged read."""

    def __init__(self, path):
        super().__init__(path)
        self.reads = 0
        self._spy_lock = threading.Lock()

    def read_range(self, offset, length, out=None):
        with self._spy_lock:
            self.reads += 1
        return super().read_range(offset, length, out)


@pytest.fixture
def checkpoint(tmp_path):
    rng = np.random.RandomState(3)
    tensors = {
        "model.layers.0.self_attn.q_proj.weight": rng.rand(32, 16).astype(np.float32),
        "model.layers.0.self_attn.o_proj.weight": rng.rand(16, 32).astype(np.float32),
        "model.norm.weight": rng.rand(16).astype(np.float32),
    }
    path = str(tmp_path / "ckpt.safetensors")
    st.write_safetensors(path, tensors)
    with open(path, "rb") as f:
        digest = str(Digest.from_bytes(f.read()))
    return path, tensors, digest, os.path.getsize(path)


def _assert_loaded(arrays, tensors):
    for name, expected in tensors.items():
        np.testing.assert_array_equal(arrays[name].numpy(), expected)


def _fill(cache, path, digest, size):
    src = cache.wrap(SpySource(path), digest, size)
    load_safetensors(src, "cpu")
    src.close()
    assert cache.stats["admitted"] == 1


def test_cold_load_admits_verified_blob(checkpoint, tmp_path):
    path, tensors, digest, size = checkpoint
    cache = BlobCache(str(tmp_path / "cache"))
    src = cache.wrap(SpySource(path), digest, size)
    assert isinstance(src, CachingByteSource)
    arrays, _ = load_safetensors(src, "cpu")
    _assert_loaded(arrays, tensors)
    src.close()  # finalize: backfill the header gap, verify, admit
    assert cache.stats["admitted"] == 1
    hit = cache.lookup(digest, expected_size=size)
    assert hit is not None
    with open(hit, "rb") as f, open(path, "rb") as g:
        assert f.read() == g.read()


def test_cold_load_with_the_index_annotation_backfills_the_header(checkpoint, tmp_path):
    """With the tensor index in hand the load never reads the header; the
    spool's close backfills it and the entry still verifies."""
    path, tensors, digest, size = checkpoint
    index, offset = st.read_header_from_file(path)
    cache = BlobCache(str(tmp_path / "cache"))
    inner = SpySource(path)
    src = cache.wrap(inner, digest, size)
    arrays, _ = load_safetensors(src, "cpu", tensors=index, data_offset=offset)
    reads = inner.reads
    _assert_loaded(arrays, tensors)
    src.close()
    assert inner.reads == reads + 1  # one backfill read of the header
    assert cache.stats["admitted"] == 1


def test_partial_spool_is_discarded(checkpoint, tmp_path):
    path, _tensors, digest, size = checkpoint
    cache = BlobCache(str(tmp_path / "cache"))
    inner = SpySource(path)
    src = cache.wrap(inner, digest, size)
    src.read_range(0, 8)  # header length only: minority coverage
    src.close()
    assert inner.reads == 1  # close() did not download the rest
    assert cache.stats["admitted"] == 0
    assert cache.lookup(digest) is None
    assert [n for n in os.listdir(cache.root) if ".tmp" in n] == []


def test_tee_write_failure_keeps_load_uncached(checkpoint, tmp_path, monkeypatch):
    path, tensors, digest, size = checkpoint
    cache = BlobCache(str(tmp_path / "cache"))
    src = cache.wrap(SpySource(path), digest, size)

    def broken_pwrite(_fd, _data, _offset):
        raise OSError(28, "No space left on device")

    monkeypatch.setattr(os, "pwrite", broken_pwrite)
    arrays, _ = load_safetensors(src, "cpu")
    src.close()
    monkeypatch.undo()
    _assert_loaded(arrays, tensors)
    assert cache.stats["admitted"] == 0
    assert cache.lookup(digest) is None


def test_wrap_refuses_uncacheable(checkpoint, tmp_path):
    path, _t, _d, size = checkpoint
    cache = BlobCache(str(tmp_path / "cache"))
    inner = SpySource(path)
    assert cache.wrap(inner, "weird:abc", size) is inner  # unknown algo
    assert cache.wrap(inner, "sha256:00", 0) is inner  # unknown size


def test_warm_load_zero_network_reads(checkpoint, tmp_path):
    path, tensors, digest, size = checkpoint
    cache = BlobCache(str(tmp_path / "cache"))
    _fill(cache, path, digest, size)
    network = SpySource(path)
    hit = cache.lookup(digest, expected_size=size)
    assert hit is not None
    arrays, _ = load_safetensors(LocalFileSource(hit), "cpu")
    _assert_loaded(arrays, tensors)
    assert network.reads == 0


def test_tampered_entry_is_evicted_and_fetched_again(checkpoint, tmp_path):
    path, tensors, digest, size = checkpoint
    cache = BlobCache(str(tmp_path / "cache"))
    _fill(cache, path, digest, size)
    entry = cache.entry_path(digest)
    with open(entry, "r+b") as f:  # same-size corruption: only the digest catches it
        f.seek(size - 4)
        f.write(b"\xde\xad\xbe\xef")
    assert cache.lookup(digest, expected_size=size) is None
    assert cache.stats["corrupt_rejected"] == 1
    assert cache.stats["cache_corrupt_evictions"] == 1
    assert not os.path.exists(entry)
    self_heal = cache.wrap(SpySource(path), digest, size)
    arrays, _ = load_safetensors(self_heal, "cpu")
    self_heal.close()
    _assert_loaded(arrays, tensors)
    assert self_heal.network_reads > 0
    assert cache.lookup(digest, expected_size=size) is not None


def test_truncated_entry_counts_rejection_not_rot(checkpoint, tmp_path):
    path, _tensors, digest, size = checkpoint
    cache = BlobCache(str(tmp_path / "cache"))
    _fill(cache, path, digest, size)
    with open(cache.entry_path(digest), "r+b") as f:
        f.truncate(size - 1)
    assert cache.lookup(digest, expected_size=size) is None
    assert cache.stats["corrupt_rejected"] == 1
    assert cache.stats["cache_corrupt_evictions"] == 0


def _admit_blob(cache, tmp_path, name, nbytes):
    data = np.full(nbytes, ord(name[0]), np.uint8).tobytes()
    digest = str(Digest.from_bytes(data))
    tmp = str(tmp_path / f"{name}.tmp")
    with open(tmp, "wb") as f:
        f.write(data)
    assert cache.admit_file(digest, tmp) is not None
    return digest


def test_lru_eviction_at_byte_cap(tmp_path):
    cache = BlobCache(str(tmp_path / "cache"), max_bytes=2500)
    d_a = _admit_blob(cache, tmp_path, "a", 1000)
    d_b = _admit_blob(cache, tmp_path, "b", 1000)
    os.utime(cache.entry_path(d_a), (1, 1))  # a older than b...
    os.utime(cache.entry_path(d_b), (2, 2))
    assert cache.lookup(d_a) is not None  # ...then a is touched: b is the LRU entry
    d_c = _admit_blob(cache, tmp_path, "c", 1000)
    assert cache.total_bytes() <= 2500
    assert cache.stats["evicted"] == 1
    assert cache.lookup(d_b) is None
    assert cache.lookup(d_a) is not None
    assert cache.lookup(d_c) is not None


def test_unbounded_cache_never_evicts(tmp_path):
    cache = BlobCache(str(tmp_path / "cache"), max_bytes=0)
    for name in "abcde":
        _admit_blob(cache, tmp_path, name, 1000)
    assert cache.stats["evicted"] == 0
    assert cache.total_bytes() == 5000


def test_blob_larger_than_cap_refused(tmp_path):
    cache = BlobCache(str(tmp_path / "cache"), max_bytes=1500)
    d_a = _admit_blob(cache, tmp_path, "a", 1000)
    data = np.full(2000, ord("x"), np.uint8).tobytes()
    digest = str(Digest.from_bytes(data))
    tmp = str(tmp_path / "big.tmp")
    with open(tmp, "wb") as f:
        f.write(data)
    assert cache.admit_file(digest, tmp) is None
    assert cache.stats["admit_rejected"] == 1
    assert cache.lookup(d_a) is not None
    assert cache.stats["evicted"] == 0


def test_stale_dead_pid_spool_swept_on_init(tmp_path):
    root = tmp_path / "cache"
    root.mkdir()
    stale = root / "sha256-aa.blob.tmp-999999-0"  # dead pid
    stale.write_bytes(b"x" * 64)
    mine = root / f"sha256-bb.blob.tmp-{os.getpid()}-0"  # live pid (us)
    mine.write_bytes(b"y" * 64)
    BlobCache(str(root))
    assert not stale.exists()
    assert mine.exists()


def test_admit_rejects_digest_mismatch(tmp_path):
    cache = BlobCache(str(tmp_path / "cache"))
    tmp = str(tmp_path / "x.tmp")
    with open(tmp, "wb") as f:
        f.write(b"not the advertised bytes")
    digest = str(Digest.from_bytes(b"different bytes"))
    assert cache.admit_file(digest, tmp) is None
    assert cache.stats["admit_rejected"] == 1
    assert not os.path.exists(tmp)
    assert cache.lookup(digest) is None


def test_admit_race_lands_identical_bytes(tmp_path):
    """Eight threads admit the same content at once, each from its own
    spool: every admit succeeds, one entry stays, and it verifies."""
    cache = BlobCache(str(tmp_path / "cache"))
    data = np.random.RandomState(5).bytes(1 << 16)
    digest = str(Digest.from_bytes(data))
    spools = []
    for i in range(8):
        p = str(tmp_path / f"spool{i}")
        with open(p, "wb") as f:
            f.write(data)
        spools.append(p)
    results = [None] * 8
    barrier = threading.Barrier(8)

    def admit(i):
        barrier.wait()
        results[i] = cache.admit_file(digest, spools[i])

    threads = [threading.Thread(target=admit, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    assert results == [cache.entry_path(digest)] * 8
    assert cache.stats["admitted"] == 8
    assert [n for n in os.listdir(cache.root) if n.endswith(".blob")] == [
        os.path.basename(cache.entry_path(digest))]
    assert cache.lookup(digest, expected_size=len(data)) is not None


def test_env_configured_default(tmp_path, monkeypatch):
    monkeypatch.setattr(bc, "_default", None)
    monkeypatch.setattr(bc, "_default_set", False)
    monkeypatch.setenv("MODELX_BLOB_CACHE_DIR", str(tmp_path / "envcache"))
    monkeypatch.setenv("MODELX_BLOB_CACHE_MAX_BYTES", "12345")
    cache = bc.default_cache()
    assert cache is not None and cache.max_bytes == 12345
    assert bc.default_cache() is cache


def test_unset_env_means_no_cache(monkeypatch):
    monkeypatch.setattr(bc, "_default", None)
    monkeypatch.setattr(bc, "_default_set", False)
    monkeypatch.delenv("MODELX_BLOB_CACHE_DIR", raising=False)
    assert bc.default_cache() is None


def test_transient_read_faults_still_admit(checkpoint, tmp_path):
    """Two reads fail once each: the loader's retries re-read the ranges,
    the spool verifies, and the next load is a zero-network warm hit."""
    path, tensors, digest, size = checkpoint
    spy = SpySource(path)
    failures = {1, 3}

    class Flaky:
        def __init__(self):
            self.n = 0

        def read_range(self, offset, length, out=None):
            self.n += 1
            if self.n in failures:
                raise OSError("reset")
            return spy.read_range(offset, length, out)

    cache = BlobCache(str(tmp_path / "cache"))
    src = cache.wrap(Flaky(), digest, size)
    arrays, _ = load_safetensors(src, "cpu", concurrency=1)
    src.close()
    _assert_loaded(arrays, tensors)
    assert cache.stats["admitted"] == 1
    reads = spy.reads
    arrays, _ = load_safetensors(LocalFileSource(cache.lookup(digest, size)), "cpu")
    _assert_loaded(arrays, tensors)
    assert spy.reads == reads
