"""The port's native IO engine (modelx_tpu_torch/native) against the JAX
package's (modelx_tpu/native) and the Python paths, on the CPU: every case
of tests/test_native.py run against the port (build, hashing, scatter
reads, raw-socket ranged HTTP with its fallbacks, the baked-.so fallback,
int8 rows), then the two engines side by side on seeded inputs: sha256 of
files of 0 B to 17 MiB and of buffers, scatter reads, and the int8 codes
and scales of f32, f16 and bf16 rows, half-integers included; and the
engine wired where the JAX package wires it (Digest.from_file, the
loader's LocalFileSource and HTTPSource, ops/quant's host rule).

Tolerance: exact equality throughout (digests, bytes, int8 codes, f32
scales as bits).
"""

import hashlib
import http.server
import os
import socket
import threading

import ml_dtypes
import numpy as np
import pytest
import torch

from modelx_tpu import native as jnative
from modelx_tpu_torch import native

pytestmark = pytest.mark.skipif(not native.available(), reason="no native toolchain")


# -- the cases of tests/test_native.py, against the port ----------------------


class TestSha256:
    def test_file_matches_hashlib(self, tmp_path):
        data = os.urandom(3 * 1024 * 1024 + 17)
        p = tmp_path / "blob"
        p.write_bytes(data)
        assert native.sha256_file(str(p)) == hashlib.sha256(data).hexdigest()

    def test_empty_file(self, tmp_path):
        p = tmp_path / "empty"
        p.write_bytes(b"")
        assert native.sha256_file(str(p)) == hashlib.sha256(b"").hexdigest()

    def test_missing_file_raises(self, tmp_path):
        with pytest.raises(OSError):
            native.sha256_file(str(tmp_path / "nope"))

    def test_buffer(self):
        for payload in (b"", b"abc", os.urandom(100_000)):
            assert native.sha256_buffer(payload) == hashlib.sha256(payload).hexdigest()

    def test_digest_from_file_uses_native(self, tmp_path, monkeypatch):
        from modelx_tpu_torch.types import Digest

        data = b"x" * 123457
        p = tmp_path / "f"
        p.write_bytes(data)
        calls = []
        orig = native.sha256_file
        monkeypatch.setattr(native, "sha256_file", lambda path: calls.append(path) or orig(path))
        assert str(Digest.from_file(str(p))) == "sha256:" + hashlib.sha256(data).hexdigest()
        assert calls == [str(p)]


class TestPreadScatter:
    def test_scatter(self, tmp_path):
        data = os.urandom(1 << 20)
        p = tmp_path / "blob"
        p.write_bytes(data)
        bufs = [np.empty(4096, np.uint8) for _ in range(16)]
        ranges = [(i * 4096, 4096, memoryview(b)) for i, b in enumerate(bufs)]
        native.pread_scatter(str(p), ranges, threads=4)
        for i, b in enumerate(bufs):
            assert bytes(b) == data[i * 4096:(i + 1) * 4096]

    def test_short_file_raises(self, tmp_path):
        p = tmp_path / "small"
        p.write_bytes(b"abc")
        buf = np.empty(10, np.uint8)
        with pytest.raises(OSError):
            native.pread_scatter(str(p), [(0, 10, memoryview(buf))])

    def test_undersized_buffer_rejected(self, tmp_path):
        """The native side writes `length` bytes unconditionally: an
        undersized buffer is refused before it becomes heap corruption."""
        p = tmp_path / "blob"
        p.write_bytes(b"x" * 4096)
        small = np.empty(16, np.uint8)
        with pytest.raises(ValueError, match="buffer"):
            native.pread_scatter(str(p), [(0, 4096, memoryview(small))])

    def test_pread_fd_undersized_buffer_rejected(self, tmp_path):
        p = tmp_path / "blob"
        p.write_bytes(b"y" * 4096)
        fd = os.open(str(p), os.O_RDONLY)
        try:
            small = np.empty(16, np.uint8)
            with pytest.raises(ValueError, match="buffer"):
                native.pread_fd(fd, 0, 4096, memoryview(small))
            buf = np.empty(4096, np.uint8)
            native.pread_fd(fd, 0, 4096, memoryview(buf))
            assert bytes(buf) == b"y" * 4096
        finally:
            os.close(fd)


@pytest.fixture(scope="module")
def served_blob():
    """A blob on the port's registry (an in-memory store)."""
    from modelx_tpu_torch.registry.fs import MemoryFSProvider
    from modelx_tpu_torch.registry.server import Options, RegistryServer, free_port
    from modelx_tpu_torch.registry.store import BlobContent
    from modelx_tpu_torch.registry.store_fs import FSRegistryStore
    from modelx_tpu_torch.types import Digest

    import io

    store = FSRegistryStore(MemoryFSProvider())
    srv = RegistryServer(Options(listen=f"127.0.0.1:{free_port()}"), store=store)
    base = srv.serve_background()
    data = np.random.RandomState(3).bytes(2 << 20)
    digest = str(Digest.from_bytes(data))
    store.put_blob("library/n", digest, BlobContent(io.BytesIO(data), len(data)))
    yield base, f"/library/n/blobs/{digest}", data
    srv.shutdown()


def _one_shot_server(responses):
    """A raw socket server answering each accepted connection's requests
    with the given byte strings in turn: [[resp, ...] per connection]."""
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(len(responses))

    def serve():
        for answers in responses:
            conn, _ = srv.accept()
            for answer in answers:
                req = b""
                while b"\r\n\r\n" not in req:
                    req += conn.recv(4096)
                conn.sendall(answer(req) if callable(answer) else answer)
            conn.close()

    threading.Thread(target=serve, daemon=True).start()
    return srv, srv.getsockname()[1]


class TestNativeHTTP:
    def test_ranged_get_and_keepalive(self, served_blob):
        base, path, data = served_blob
        from urllib.parse import urlsplit

        u = urlsplit(base)
        conn = native.NativeHTTPConnection(u.hostname, u.port)
        try:
            buf = np.empty(4096, np.uint8)
            assert conn.get_range(path, 100, 4096, memoryview(buf)) == 206
            assert bytes(buf) == data[100:4196]
            assert conn.get_range(path, 0, 10, memoryview(buf)[:10]) == 206
            assert bytes(buf[:10]) == data[:10]
        finally:
            conn.close()

    def test_error_status_reported_and_connection_survives(self, served_blob):
        base, path, data = served_blob
        from urllib.parse import urlsplit

        u = urlsplit(base)
        conn = native.NativeHTTPConnection(u.hostname, u.port)
        try:
            buf = np.empty(16, np.uint8)
            missing = "/library/n/blobs/sha256:" + "0" * 64
            assert conn.get_range(missing, 0, 16, memoryview(buf)) == 404
            assert conn.get_range(path, 0, 16, memoryview(buf)) == 206
        finally:
            conn.close()

    def test_httpsource_python_fallback(self, served_blob, monkeypatch):
        """With the native engine unavailable the loader's HTTPSource keeps
        serving ranged reads through http.client."""
        from modelx_tpu_torch.dl.loader import HTTPSource

        monkeypatch.setattr(native, "available", lambda: False)
        base, path, data = served_blob
        src = HTTPSource(base + path)
        got = bytes(memoryview(src.read_range(7, 1000)))
        assert got == data[7:1007]
        assert src.native_reads == 0 and not src._use_native
        src.close()

    def test_httpsource_native_path(self, served_blob):
        from modelx_tpu_torch.dl.loader import HTTPSource

        base, path, data = served_blob
        src = HTTPSource(base + path)
        assert src._use_native
        got = bytes(memoryview(src.read_range(0, 2 << 20)))
        assert got == data
        assert src.native_reads == 1
        src.close()

    def test_large_error_body_drained_then_reusable(self):
        """A 404 whose error body exceeds the header scratch buffer must not
        poison the keep-alive stream for the next request."""
        big = b"E" * 64 * 1024
        payload = b"0123456789abcdef"

        def answer(req):
            if b"/missing" in req:
                return (b"HTTP/1.1 404 Not Found\r\nContent-Length: " + str(len(big)).encode()
                        + b"\r\n\r\n" + big)
            return b"HTTP/1.1 206 Partial Content\r\nContent-Length: 16\r\n\r\n" + payload

        srv, port = _one_shot_server([[answer, answer]])
        conn = native.NativeHTTPConnection("127.0.0.1", port)
        try:
            buf = np.empty(16, np.uint8)
            assert conn.get_range("/missing", 0, 16, memoryview(buf)) == 404
            assert conn.get_range("/blob", 0, 16, memoryview(buf)) == 206
            assert bytes(buf) == payload
        finally:
            conn.close()
            srv.close()

    def test_unknown_length_error_redials(self):
        """No Content-Length on an error: the connection is dropped and the
        next request transparently redials."""
        payload = b"fresh-connection"
        srv, port = _one_shot_server([
            [b"HTTP/1.1 503 Unavailable\r\n\r\nsome trailing junk"],
            [b"HTTP/1.1 206 Partial Content\r\nContent-Length: 16\r\n\r\n" + payload],
        ])
        conn = native.NativeHTTPConnection("127.0.0.1", port)
        try:
            buf = np.empty(16, np.uint8)
            assert conn.get_range("/x", 0, 16, memoryview(buf)) == 503
            assert conn.get_range("/y", 0, 16, memoryview(buf)) == 206
            assert bytes(buf) == payload
        finally:
            conn.close()
            srv.close()


class TestBakedSoFallback:
    def test_existing_so_used_when_toolchain_missing(self, monkeypatch):
        """An image may bake an arch-correct .so but ship no g++, with
        install mtimes that make the source look newer: build() returns the
        existing library, not None."""
        import subprocess

        built = native.build(force=True)
        if built is None:
            pytest.skip("no local toolchain to produce a .so")
        os.utime(native._SRC)  # the source looks newer

        def no_gxx(*a, **kw):
            raise OSError("g++ not found")

        monkeypatch.setattr(subprocess, "run", no_gxx)
        assert native.build() == native._SO


def _numpy_ref(w32):
    amax = np.max(np.abs(w32), axis=1)
    scale = (amax / 127.0 + (amax == 0)).astype(np.float32)
    inv = (np.float32(1.0) / scale)[:, None]
    q = np.clip(np.rint(w32 * inv), -127, 127).astype(np.int8)
    return q, scale


def _port_input(w, dt):
    """The port's form of a weight: numpy f32/f16, or a CPU torch bf16
    tensor over the same bits."""
    if dt == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(w).view(np.uint16).astype(np.int16)).view(
            torch.bfloat16)
    return w


DTYPES = {"float32": np.float32, "float16": np.float16, "bfloat16": ml_dtypes.bfloat16}


class TestQuantizeRows:
    """mx_quantize_rows is bit-identical to ops/quant.py's numpy rule (the
    f32 reciprocal, round half to even)."""

    def test_parity_all_dtypes(self):
        rng = np.random.RandomState(7)
        for name, dt in DTYPES.items():
            w = rng.randn(37, 129).astype(dt)
            w[5] = 0  # an all-zero row: its scale pins to 1.0
            ref_q, ref_s = _numpy_ref(np.asarray(w, np.float32))
            src = _port_input(w, name)
            q, s = native.quantize_rows(src)
            np.testing.assert_array_equal(s, ref_s)
            np.testing.assert_array_equal(q, ref_q)
            q2, _ = native.quantize_rows(src, scales=ref_s)  # the caller's scales
            np.testing.assert_array_equal(q2, ref_q)
            q3, s3 = native.quantize_rows(src, want_q=False)  # scales only
            assert q3 is None
            np.testing.assert_array_equal(s3, ref_s)
            q4, s4 = native.quantize_rows(src, threads=4)  # the split changes nothing
            np.testing.assert_array_equal(q4, ref_q)
            np.testing.assert_array_equal(s4, ref_s)

    def test_half_integer_rounding(self):
        """Values exactly on .5 take round half to even, as np.rint."""
        w = (np.arange(-508, 508, dtype=np.float32).reshape(4, 254)) / 2.0
        ref = np.clip(np.rint(w), -127, 127).astype(np.int8)
        q, _ = native.quantize_rows(w, scales=np.ones((4,), np.float32))
        np.testing.assert_array_equal(q, ref)

    def test_unsupported_shapes_fall_back(self):
        assert native.quantize_rows(np.zeros((3,), np.float32)) is None  # 1-D
        assert native.quantize_rows(np.zeros((2, 2), np.int8)) is None  # int
        assert native.quantize_rows(np.zeros((0, 4), np.float32)) is None
        base = np.zeros((4, 8), np.float32)
        assert native.quantize_rows(base[:, ::2]) is None  # non-contiguous
        assert native.quantize_rows(torch.zeros(4, 8)[:, ::2]) is None
        assert native.quantize_rows(torch.zeros(4, 8, dtype=torch.float64)) is None


# -- the port's engine against the JAX package's ------------------------------

SIZES = [0, 1, 55, 56, 64, (4 << 20) + 1, 17 << 20]


@pytest.fixture(scope="module")
def jax_engine():
    if not jnative.available():
        pytest.skip("the JAX package's engine did not build")
    return jnative


@pytest.mark.parametrize("size", SIZES)
def test_sha256_equals_the_jax_engine_and_hashlib(tmp_path, jax_engine, size):
    data = np.random.RandomState(size % 1000).bytes(size)
    p = tmp_path / "f"
    p.write_bytes(data)
    want = hashlib.sha256(data).hexdigest()
    assert native.sha256_file(str(p)) == jax_engine.sha256_file(str(p)) == want
    assert native.sha256_buffer(data) == jax_engine.sha256_buffer(data) == want
    # a writable buffer takes the zero-copy address path
    assert native.sha256_buffer(bytearray(data)) == want


def test_pread_scatter_equals_the_jax_engine(tmp_path, jax_engine):
    rng = np.random.RandomState(5)
    data = rng.bytes(3 << 20)
    p = tmp_path / "blob"
    p.write_bytes(data)
    spans = [(int(o), int(n)) for o, n in zip(rng.randint(0, (3 << 20) - 70000, 24),
                                               rng.randint(1, 70000, 24))]
    got, want = [], []
    for engine, out in ((native, got), (jax_engine, want)):
        bufs = [np.empty(n, np.uint8) for _, n in spans]
        engine.pread_scatter(str(p), [(o, n, memoryview(b)) for (o, n), b in zip(spans, bufs)],
                             threads=4)
        out.extend(bytes(b) for b in bufs)
    assert got == want == [data[o:o + n] for o, n in spans]


def _weights(dt, seed):
    rng = np.random.RandomState(seed)
    w = (rng.randn(33, 200) * rng.choice([1e-3, 1.0, 300.0], size=(33, 1))).astype(np.float32)
    w[0] = 0.0
    # exact half-integer multiples of the scale: round half to even
    w[1, :8] = np.array([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, -126.5], np.float32)
    w[1, 8:] = 0.0
    w[1, -1] = 127.0
    return w.astype(dt)


@pytest.mark.parametrize("name", list(DTYPES))
@pytest.mark.parametrize("seed", [0, 1])
def test_int8_bytes_equal_the_jax_engine(jax_engine, name, seed):
    w = _weights(DTYPES[name], seed)
    jq, js = jax_engine.quantize_rows(w)
    tq, ts = native.quantize_rows(_port_input(w, name))
    assert tq.tobytes() == jq.tobytes()
    assert ts.tobytes() == js.tobytes()
    ones = np.ones(w.shape[0], np.float32)
    assert native.quantize_rows(_port_input(w, name), scales=ones)[0].tobytes() == \
        jax_engine.quantize_rows(w, scales=ones)[0].tobytes()
    if name == "bfloat16":
        # raw bf16 bits as uint16 take the same code path
        bits = np.ascontiguousarray(w).view(np.uint16)
        assert native.quantize_rows(bits)[0].tobytes() == jq.tobytes()


@pytest.mark.parametrize("name", list(DTYPES))
def test_host_quantizers_equal_the_jax_package(name):
    """ops/quant's channel_scales, quantize_rows and quantize_fused (the
    native pass) give the JAX package's bytes; the numpy fallback too."""
    from modelx_tpu.ops import quant as jquant
    from modelx_tpu_torch.ops import quant as tquant

    w = _weights(DTYPES[name], 3)
    src = _port_input(w, name)
    js = jquant.channel_scales(w)
    assert tquant.channel_scales(src).tobytes() == js.tobytes()
    assert tquant.quantize_rows(src, js).tobytes() == jquant.quantize_rows(w, js).tobytes()
    q, s = tquant.quantize_fused(src)
    jqq, jss = jquant.quantize_fused(w)
    assert q.tobytes() == jqq.tobytes() and s.tobytes() == jss.tobytes()


def test_host_quantizers_fall_back_without_the_engine(monkeypatch):
    from modelx_tpu.ops import quant as jquant
    from modelx_tpu_torch.ops import quant as tquant

    monkeypatch.setattr(native, "lib", lambda: None)
    w = _weights(np.float32, 4)
    q, s = tquant.quantize_fused(w)
    jqq, jss = jquant.quantize_fused(w)
    assert q.tobytes() == jqq.tobytes() and s.tobytes() == jss.tobytes()
    assert tquant.quantize_fused(torch.from_numpy(w))[0].tobytes() == jqq.tobytes()


def test_local_file_source_reads_through_pread_fd(tmp_path, monkeypatch):
    from modelx_tpu_torch.dl.loader import LocalFileSource

    data = np.random.RandomState(9).bytes(1 << 20)
    p = tmp_path / "blob"
    p.write_bytes(data)
    src = LocalFileSource(str(p))
    out = np.empty(5000, np.uint8)
    src.read_range(1234, 5000, out)
    assert bytes(out) == data[1234:6234] and src.native_reads == 1
    assert bytes(src.read_range(0, 10)) == data[:10] and src.native_reads == 2
    src.close()
    monkeypatch.setattr(native, "available", lambda: False)
    src = LocalFileSource(str(p))
    assert bytes(src.read_range(7, 100)) == data[7:107] and src.native_reads == 0
    src.close()


def test_httpsource_error_status_raises(served_blob):
    from modelx_tpu_torch.dl.loader import HTTPSource

    base, _, _ = served_blob
    src = HTTPSource(base + "/library/n/blobs/sha256:" + "0" * 64)
    with pytest.raises(OSError, match="HTTP 404"):
        src.read_range(0, 16)
    src.close()


def test_httpsource_drops_to_python_when_range_is_ignored():
    """A server answering 200 with the whole body (Range ignored): the
    native read refuses the length mismatch and the source falls back to
    http.client, which slices the range out."""
    body = bytes(range(256)) * 4

    class Handler(http.server.BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, *a):
            pass

        def do_GET(self):
            self.send_response(200)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        from modelx_tpu_torch.dl.loader import HTTPSource

        src = HTTPSource(f"http://127.0.0.1:{httpd.server_address[1]}/blob")
        assert bytes(src.read_range(10, 100)) == body[10:110]
        assert not src._use_native and src.native_reads == 0
        src.close()
    finally:
        httpd.shutdown()
        httpd.server_close()


def test_native_http_against_a_stdlib_server():
    """NativeHTTPConnection against the standard library's http.server
    (SimpleHTTPRequestHandler honors no Range, so a handler that does)."""
    blob = np.random.RandomState(2).bytes(300_000)

    class Handler(http.server.BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, *a):
            pass

        def do_GET(self):
            lo, hi = self.headers["Range"].split("=")[1].split("-")
            chunk = blob[int(lo):int(hi) + 1]
            self.send_response(206)
            self.send_header("Content-Length", str(len(chunk)))
            self.end_headers()
            self.wfile.write(chunk)

    httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    conn = native.NativeHTTPConnection("127.0.0.1", httpd.server_address[1])
    try:
        for off, n in ((0, 1), (17, 65536), (299_000, 1000)):
            buf = bytearray(n)
            assert conn.get_range("/b", off, n, memoryview(buf)) == 206
            assert bytes(buf) == blob[off:off + n]
    finally:
        conn.close()
        httpd.shutdown()
        httpd.server_close()
