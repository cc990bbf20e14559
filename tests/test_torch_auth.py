"""The port's registry auth (registry/auth.py, the server's auth filter,
the GC cron and grace) on the CPU: the cases of tests/test_auth.py against
the port, then a table of tokens signed in the test with ``cryptography``
(tampered, truncated and wrong-length signatures, another key and a key of
another size, every claim verdict) on which the JAX package's verifier and
the port's give the same verdict and status. The port verifies RS256
itself (RSASSA-PKCS1-v1_5, SHA-256); ``cryptography`` only mints the
tokens here, so the file skips without it, as tests/test_auth.py does.

Tolerance: exact equality of verdicts (claims, or status and code).
"""

import base64
import io
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

pytest.importorskip("cryptography", reason="mints the test's RS256 tokens")

from modelx_tpu.registry.auth import OIDCVerifier as JaxVerifier  # noqa: E402
from modelx_tpu_torch import errors  # noqa: E402
from modelx_tpu_torch.registry.auth import OIDCVerifier, RSAPublicKey  # noqa: E402
from modelx_tpu_torch.registry.fs import MemoryFSProvider  # noqa: E402
from modelx_tpu_torch.registry.server import Options, RegistryServer, free_port  # noqa: E402
from modelx_tpu_torch.registry.store import BlobContent  # noqa: E402
from modelx_tpu_torch.registry.store_fs import FSRegistryStore  # noqa: E402
from modelx_tpu_torch.types import Digest, Manifest  # noqa: E402


def _b64url(data: bytes) -> str:
    return base64.urlsafe_b64encode(data).rstrip(b"=").decode()


class FakeIssuer:
    """Serves /.well-known/openid-configuration + a JWKS of its keys and
    mints RS256 JWTs with any of them."""

    def __init__(self, sizes=(2048,)) -> None:
        from cryptography.hazmat.primitives.asymmetric import rsa

        self.keys = {f"key-{i}": rsa.generate_private_key(public_exponent=65537, key_size=n)
                     for i, n in enumerate(sizes)}
        self.kid = "key-0"
        self.fetches = 0
        issuer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_GET(self):
                if self.path == "/.well-known/openid-configuration":
                    body = json.dumps({"jwks_uri": issuer.url + "/keys"}).encode()
                elif self.path == "/keys":
                    issuer.fetches += 1
                    keys = []
                    for kid, key in issuer.keys.items():
                        pub = key.public_key().public_numbers()
                        keys.append({"kty": "RSA", "kid": kid,
                                     "n": _b64url(pub.n.to_bytes((pub.n.bit_length() + 7) // 8,
                                                                 "big")),
                                     "e": _b64url(pub.e.to_bytes(3, "big").lstrip(b"\x00"))})
                    keys.append({"kty": "EC", "kid": "ec-1", "crv": "P-256"})
                    body = json.dumps({"keys": keys}).encode()
                else:
                    self.send_response(404)
                    self.end_headers()
                    return
                self.send_response(200)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.httpd.daemon_threads = True
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}"
        threading.Thread(target=self.httpd.serve_forever, daemon=True).start()

    def sign(self, signing_input: bytes, kid: str) -> bytes:
        from cryptography.hazmat.primitives import hashes
        from cryptography.hazmat.primitives.asymmetric import padding

        return self.keys[kid].sign(signing_input, padding.PKCS1v15(), hashes.SHA256())

    def mint(self, claims: dict, kid: str | None = None, alg: str = "RS256",
             sign_with: str | None = None) -> str:
        header = {"alg": alg, "kid": kid or self.kid}
        h64 = _b64url(json.dumps(header).encode())
        p64 = _b64url(json.dumps(claims).encode())
        sig = self.sign(f"{h64}.{p64}".encode(), sign_with or kid or self.kid)
        return f"{h64}.{p64}.{_b64url(sig)}"

    def stop(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()


@pytest.fixture(scope="module")
def issuer():
    iss = FakeIssuer(sizes=(2048, 3072, 1024))
    yield iss
    iss.stop()


# -- the cases of tests/test_auth.py, against the port --------------------------


class TestOIDCVerifier:
    def test_valid_token(self, issuer):
        v = OIDCVerifier(issuer.url)
        claims = {"iss": issuer.url, "sub": "alice", "exp": time.time() + 300,
                  "preferred_username": "alice"}
        got = v.verify(issuer.mint(claims))
        assert got["sub"] == "alice" and v.username(got) == "alice"

    def test_expired(self, issuer):
        v = OIDCVerifier(issuer.url)
        with pytest.raises(errors.ErrorInfo, match="expired"):
            v.verify(issuer.mint({"iss": issuer.url, "exp": time.time() - 300}))

    def test_missing_exp_rejected(self, issuer):
        v = OIDCVerifier(issuer.url)
        with pytest.raises(errors.ErrorInfo, match="missing exp"):
            v.verify(issuer.mint({"iss": issuer.url, "sub": "alice"}))

    def test_wrong_issuer(self, issuer):
        v = OIDCVerifier(issuer.url)
        with pytest.raises(errors.ErrorInfo, match="issuer"):
            v.verify(issuer.mint({"iss": "https://evil.example", "exp": time.time() + 300}))

    def test_tampered_payload(self, issuer):
        v = OIDCVerifier(issuer.url)
        tok = issuer.mint({"iss": issuer.url, "sub": "alice", "exp": time.time() + 300})
        h64, _, s64 = tok.split(".")
        evil = _b64url(json.dumps({"iss": issuer.url, "sub": "mallory",
                                   "exp": time.time() + 300}).encode())
        with pytest.raises(errors.ErrorInfo, match="signature"):
            v.verify(f"{h64}.{evil}.{s64}")

    def test_unknown_kid(self, issuer):
        v = OIDCVerifier(issuer.url)
        tok = issuer.mint({"iss": issuer.url, "exp": time.time() + 300}, kid="nope",
                          sign_with="key-0")
        with pytest.raises(errors.ErrorInfo, match="unknown signing key"):
            v.verify(tok)

    def test_alg_none_rejected(self, issuer):
        v = OIDCVerifier(issuer.url)
        tok = f"{_b64url(json.dumps({'alg': 'none'}).encode())}.{_b64url(b'{}')}."
        with pytest.raises(errors.ErrorInfo):
            v.verify(tok)

    def test_malformed(self, issuer):
        with pytest.raises(errors.ErrorInfo, match="malformed"):
            OIDCVerifier(issuer.url).verify("not-a-jwt")


def _get(base: str, headers=None, path: str = "/") -> int:
    import urllib.error
    import urllib.request

    req = urllib.request.Request(base + path, headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status
    except urllib.error.HTTPError as e:
        return e.code


def test_jwt_accepted_by_registry(issuer):
    srv = RegistryServer(Options(listen=f"127.0.0.1:{free_port()}", oidc_issuer=issuer.url,
                                 auth_tokens=("static-token",)),
                         store=FSRegistryStore(MemoryFSProvider()))
    base = srv.serve_background()
    try:
        assert _get(base) == 401
        tok = issuer.mint({"iss": issuer.url, "sub": "ci", "exp": time.time() + 300})
        assert _get(base, {"Authorization": f"Bearer {tok}"}) == 200
        assert _get(base, {"Authorization": "Bearer garbage"}) == 401
        assert _get(base, {"Authorization": "Bearer static-token"}) == 200
        assert _get(base, path="/?token=static-token") == 200
        assert _get(base, path="/?access_token=static-token") == 200
        assert _get(base, path="/healthz") == 200  # never behind the filter
    finally:
        srv.shutdown()


def test_gc_cron_sweeps_orphans():
    store = FSRegistryStore(MemoryFSProvider())
    srv = RegistryServer(Options(listen=f"127.0.0.1:{free_port()}", gc_interval_s=0.2,
                                 gc_grace_s=0.0), store=store)
    srv.serve_background()
    try:
        store.put_manifest("library/x", "v1", "", Manifest())
        orphan = b"orphan!"
        store.put_blob("library/x", str(Digest.from_bytes(orphan)),
                       BlobContent(io.BytesIO(orphan), len(orphan)))
        deadline = time.time() + 5
        while time.time() < deadline and store.list_blobs("library/x"):
            time.sleep(0.1)
        assert store.list_blobs("library/x") == []
        assert srv.registry.metrics.counters["gc_blobs_deleted_total"] == 1
    finally:
        srv.shutdown()


def test_young_blobs_survive_sweep():
    from modelx_tpu_torch.registry.gc import gc_blobs

    store = FSRegistryStore(MemoryFSProvider())
    store.put_manifest("library/y", "v1", "", Manifest())
    data = b"just uploaded, manifest not committed yet"
    store.put_blob("library/y", str(Digest.from_bytes(data)),
                   BlobContent(io.BytesIO(data), len(data)))
    assert gc_blobs(store, "library/y").deleted == 0
    assert gc_blobs(store, "library/y", grace_s=0).deleted == 1


def test_idp_outage_is_503_not_500(issuer):
    v = OIDCVerifier(f"http://127.0.0.1:{free_port()}")  # nothing listening
    tok = issuer.mint({"iss": v.issuer, "exp": time.time() + 300})
    with pytest.raises(errors.ErrorInfo) as ei:
        v.verify(tok)
    assert ei.value.http_status == 503


def test_crafted_exp_claim_is_401(issuer):
    with pytest.raises(errors.ErrorInfo) as ei:
        OIDCVerifier(issuer.url).verify(issuer.mint({"iss": issuer.url, "exp": "soon"}))
    assert ei.value.http_status == 401


def test_jwks_refresh_rate_limited(issuer):
    v = OIDCVerifier(issuer.url)
    v.verify(issuer.mint({"iss": issuer.url, "exp": time.time() + 300}))
    fetches = []
    orig = v._refresh_keys
    v._refresh_keys = lambda: fetches.append(1) or orig()
    for _ in range(20):
        with pytest.raises(errors.ErrorInfo):
            v.verify(issuer.mint({"iss": issuer.url, "exp": time.time() + 300}, kid="spam",
                                 sign_with="key-0"))
    assert len(fetches) == 0  # within MIN_REFRESH_INTERVAL_S: no refetch


# -- the port's verifier against the JAX package's --------------------------------


def _tamper_sig(tok: str, fn) -> str:
    h, p, s = tok.split(".")
    sig = base64.urlsafe_b64decode(s + "=" * (-len(s) % 4))
    return f"{h}.{p}.{_b64url(fn(sig))}"


def _token_table(issuer) -> list[tuple[str, str]]:
    now = time.time()
    iss = issuer.url
    good = {"iss": iss, "sub": "alice", "exp": now + 300}
    mint = issuer.mint
    t = mint(good)
    h, p, s = t.split(".")
    return [
        ("valid", t),
        ("valid-3072-bit-key", mint(good, kid="key-1")),
        ("valid-1024-bit-key", mint(good, kid="key-2")),
        ("valid-issuer-with-slash", mint({**good, "iss": iss + "/"})),
        ("valid-nbf-past", mint({**good, "nbf": now - 10})),
        ("valid-within-leeway", mint({**good, "exp": now - 10})),
        ("nbf-future", mint({**good, "nbf": now + 3600})),
        ("expired", mint({**good, "exp": now - 3600})),
        ("missing-exp", mint({"iss": iss})),
        ("exp-string", mint({**good, "exp": "soon"})),
        ("exp-list", mint({**good, "exp": [1]})),
        ("valid-exp-numeric-string", mint({**good, "exp": str(now + 300)})),
        ("nbf-garbage", mint({**good, "nbf": {"a": 1}})),
        ("wrong-issuer", mint({**good, "iss": "https://evil.example"})),
        ("no-issuer", mint({"sub": "a", "exp": now + 300})),
        ("unknown-kid", mint(good, kid="missing", sign_with="key-0")),
        ("other-key-same-kid", mint(good, kid="key-0", sign_with="key-1")),
        ("alg-hs256", mint(good, alg="HS256")),
        ("alg-none", f"{_b64url(json.dumps({'alg': 'none'}).encode())}.{p}."),
        ("tampered-payload",
         f"{h}.{_b64url(json.dumps({**good, 'sub': 'mallory'}).encode())}.{s}"),
        ("flipped-bit", _tamper_sig(t, lambda b: b[:-1] + bytes([b[-1] ^ 1]))),
        ("truncated-signature", _tamper_sig(t, lambda b: b[:-1])),
        ("zero-padded-signature", _tamper_sig(t, lambda b: b"\x00" + b)),
        ("empty-signature", f"{h}.{p}."),
        ("signature-of-zeros", _tamper_sig(t, lambda b: bytes(len(b)))),
        ("signature-above-modulus", _tamper_sig(t, lambda b: b"\xff" * len(b))),
        ("signature-is-one", _tamper_sig(t, lambda b: (1).to_bytes(len(b), "big"))),
        ("bad-base64-signature", f"{h}.{p}.@@@"),
        ("two-parts", f"{h}.{p}"),
        ("four-parts", f"{t}.x"),
        ("payload-not-object", f"{h}.{_b64url(b'[1, 2]')}.{s}"),
        ("payload-not-json", f"{h}.{_b64url(b'not json')}.{s}"),
        ("header-not-json", f"{_b64url(b'{')}.{p}.{s}"),
        ("empty", ""),
    ]


def _verdict(verifier, token: str):
    try:
        return ("ok", verifier.verify(token))
    except errors.ErrorInfo as e:
        return (e.http_status, e.code, e.message, e.detail)
    except Exception as e:  # the JAX package's ErrorInfo is another class
        if hasattr(e, "http_status"):
            return (e.http_status, e.code, e.message, e.detail)
        raise


def test_verdicts_equal_the_jax_verifier(issuer):
    tv, jv = OIDCVerifier(issuer.url), JaxVerifier(issuer.url)
    rows = _token_table(issuer)
    verdicts = []
    for name, token in rows:
        got, want = _verdict(tv, token), _verdict(jv, token)
        assert got == want, name
        verdicts.append((name, got[0]))
    assert dict(verdicts)["valid"] == "ok" and dict(verdicts)["valid-1024-bit-key"] == "ok"
    assert sum(v == "ok" for _, v in verdicts) == 7
    assert all(v == 401 for name, v in verdicts if not name.startswith("valid"))


def test_idp_unreachable_verdicts_equal(issuer):
    dead = f"http://127.0.0.1:{free_port()}"
    tok = issuer.mint({"iss": dead, "exp": time.time() + 300})
    got, want = _verdict(OIDCVerifier(dead), tok), _verdict(JaxVerifier(dead), tok)
    assert got[:2] == want[:2] == (503, errors.ErrCodeUnknown)


def test_non_finite_exp_is_malformed_here(issuer):
    """JSON's NaN expiry: the JAX verifier's comparison lets it through
    (a known gap of the reference); the port answers 401."""
    tok = issuer.mint({"iss": issuer.url, "exp": float("nan")})
    assert _verdict(JaxVerifier(issuer.url), tok)[0] == "ok"
    assert _verdict(OIDCVerifier(issuer.url), tok)[:2] == (401, errors.ErrCodeUnauthorized)


def test_rsa_verify_matches_cryptography(issuer):
    """RSAPublicKey.verify against cryptography's verify, on messages and
    signatures of every key."""
    from cryptography.exceptions import InvalidSignature
    from cryptography.hazmat.primitives import hashes
    from cryptography.hazmat.primitives.asymmetric import padding

    for kid, key in issuer.keys.items():
        nums = key.public_key().public_numbers()
        pub = RSAPublicKey(nums.n, nums.e)
        for msg in (b"", b"a", b"x" * 1000):
            sig = issuer.sign(msg, kid)
            for candidate, message in ((sig, msg), (sig, msg + b"!"),
                                       (sig[:-1] + bytes([sig[-1] ^ 0x80]), msg)):
                try:
                    key.public_key().verify(candidate, message, padding.PKCS1v15(),
                                            hashes.SHA256())
                    want = True
                except InvalidSignature:
                    want = False
                assert pub.verify(candidate, message) is want
