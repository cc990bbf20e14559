"""The port's prefix-KV store (modelx_tpu_torch.dl.kv_store) and the
PrefixKVCache plumbing it rides on, against the JAX package's, on the CPU,
mirroring tests/test_kv_store.py:

- the same KV arrays (fp32 and bf16, a fake two-leaf entry and a tiny
  llama's per-layer cache) bundled by both packages give the same member
  names, leaf bytes and meta, apart from the environment fields
  (``jax``, ``backend``, ``codeVersion``, ``mesh``) and the prefix hash
  they key; a bundle of one package is a version skew to the other;
- every hardening case of the reference's ``TestBundleHardening`` skips
  for the same reason in both (the reason's words before the first colon);
- the same hit sequence makes ``KVPublisher`` publish the same keys; the
  fetch-through installs on a miss and the next lookup hits;
- the registry round trip on the port's registry server, and the
  pod-kill drill of ``TestKillDrill``: a bundle spooled by a pod that dies
  is published by the next generation's drainer, pulled with the weights
  and installed at load;
- a decode resumed from an installed bundle equals a locally prefilled one
  and the JAX package's tokens, greedy and sampled, exactly in fp32
  (``ChunkedDecoder`` here; the engine, dense and paged, in
  tests/test_torch_continuous.py).
"""

import dataclasses
import io
import json
import os
import tarfile

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from modelx_tpu.dl import aot_cache
from modelx_tpu.dl import kv_store as jkv
from modelx_tpu.models import decode as jdecode
from modelx_tpu.models import llama as jl
from modelx_tpu_torch.client.client import Client
from modelx_tpu_torch.dl import kv_store as kv
from modelx_tpu_torch.dl import program_store as ps
from modelx_tpu_torch.dl.blob_cache import BlobCache
from modelx_tpu_torch.dl.outbox import Drainer, Outbox
from modelx_tpu_torch.dl.weights import from_jax_params
from modelx_tpu_torch.models import llama as tl
from modelx_tpu_torch.models.decode import ChunkedDecoder, PrefixKVCache, pad_seq_len
from modelx_tpu_torch.types import (
    AnnotationKVModel,
    AnnotationKVPrefix,
    AnnotationKVTokens,
    Digest,
    MediaTypeModelKVCache,
)
from tests.test_torch_registry import start_port_registry, write_model_dir

IDS = [3, 1, 4, 1, 5]
ENV_FIELDS = ("jax", "backend", "codeVersion", "mesh", "prefixHash")
REPO_NAME = "library/kv"


def fake_init(b, n):
    """Stand-in for a family's init_kv_cache: the shape oracle."""
    return {"k": torch.zeros((b, n, 2, 4)), "v": torch.zeros((b, n, 2, 4))}


def jfake_init(b, n):
    return {"k": jnp.zeros((b, n, 2, 4), jnp.float32), "v": jnp.zeros((b, n, 2, 4), jnp.float32)}


def fake_arrays(n: int = 16, seed: int = 0, dtype: str = "float32",
                names=("k", "v")) -> dict:
    """numpy leaves from a seed: fp32, or bf16 as their 16-bit words."""
    rng = np.random.RandomState(seed)
    out = {}
    for name in names:
        x = rng.randn(1, n, 2, 4).astype(np.float32)
        if dtype == "bfloat16":
            x = torch.from_numpy(x).to(torch.bfloat16).view(torch.int16).numpy()
        out[name] = x
    return out


def port_entry(arrays: dict, dtype: str = "float32") -> dict:
    return {k: (torch.from_numpy(v.copy()).view(torch.bfloat16) if dtype == "bfloat16"
                else torch.from_numpy(v.copy())) for k, v in arrays.items()}


def jax_entry(arrays: dict, dtype: str = "float32") -> dict:
    return {k: (jnp.asarray(v).view(jnp.bfloat16) if dtype == "bfloat16" else jnp.asarray(v))
            for k, v in arrays.items()}


def fake_entry(n: int = 16, seed: int = 0) -> dict:
    return port_entry(fake_arrays(n, seed))


def _members(data: bytes) -> list:
    with tarfile.open(fileobj=io.BytesIO(data), mode="r:") as tar:
        return [(m.name, tar.extractfile(m).read()) for m in tar.getmembers()]


# -- bundles against the JAX package ---------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("names", [("k", "v"), ("k0", "k1", "k10", "k2", "v0", "v1", "v10",
                                                "v2")], ids=["kv", "layers"])
def test_the_same_arrays_bundle_to_the_same_members_and_meta(dtype, names):
    arrays = fake_arrays(16, seed=3, dtype=dtype, names=names)
    ours = kv.build_bundle(IDS, port_entry(arrays, dtype), model_key="m1")
    theirs = jkv.build_bundle(IDS, jax_entry(arrays, dtype), model_key="m1")
    mine, ref = _members(ours), _members(theirs)
    # leaves in JAX's pytree order of a dict: sorted keys ("k10" before "k2")
    assert [n for n, _ in mine] == [n for n, _ in ref] == [
        "meta.json"] + [f"leaf-{i:05d}.bin" for i in range(len(names))]
    assert [b for _, b in mine[1:]] == [b for _, b in ref[1:]]
    assert [b for _, b in mine[1:]] == [arrays[k].tobytes() for k in sorted(names)]
    meta, jmeta = (json.loads(m[0][1]) for m in (mine, ref))
    assert {k: v for k, v in meta.items() if k not in ENV_FIELDS} == \
        {k: v for k, v in jmeta.items() if k not in ENV_FIELDS}
    assert meta["leaves"][0]["dtype"] == dtype and meta["storedLen"] == 16
    assert meta["prefixHash"] == kv.prefix_hash("m1", kv.env_key(), IDS)
    assert kv.prefix_hash("m1", "e" * 12, IDS) == jkv.prefix_hash("m1", "e" * 12, IDS)
    assert kv.bundle_name("e" * 12, "h" * 16) == jkv.bundle_name("e" * 12, "h" * 16)
    assert meta["mesh"] == "dp=1" and meta["jax"].startswith("torch ")
    # the other package's bundle is another world's: skipped, never installed
    got = kv.install_bundle(theirs, lambda b, n: port_entry(fake_arrays(n, 0, dtype, names),
                                                            dtype), PrefixKVCache(4))
    assert got["installed"] == 0 and got["reasons"][0].startswith("version skew")
    back = jkv.install_bundle(ours, lambda b, n: jax_entry(fake_arrays(n, 0, dtype, names),
                                                           dtype), jdecode.PrefixKVCache(4))
    assert back["installed"] == 0 and back["reasons"][0].startswith("version skew")


def test_build_is_deterministic_and_empty_builds_nothing():
    a = kv.build_bundle(IDS, fake_entry())
    assert a == kv.build_bundle(IDS, fake_entry()) and a is not None
    assert kv.build_bundle([], fake_entry()) is None and kv.build_bundle(IDS, {}) is None


def test_install_roundtrip_and_origin():
    data = kv.build_bundle(IDS, fake_entry())
    cache = PrefixKVCache(4)
    stats = kv.install_bundle(data, fake_init, cache)
    assert (stats["installed"], stats["skipped"]) == (1, 0)
    assert cache.entry_origin(IDS) == "installed"
    hit = cache.lookup(IDS + [9])
    assert hit is not None and hit[0] == len(IDS)
    assert torch.equal(hit[1]["k"], fake_entry()["k"])
    assert cache.hits_installed == 1 and cache.stats()["installed_total"] == 1
    assert cache.take_publishable(1) == []  # never published again
    again = kv.install_bundle(data, fake_init, cache)
    assert (again["installed"], again["present"]) == (0, 1)


def test_install_never_overwrites_local_entries():
    cache = PrefixKVCache(4)
    local = fake_entry(seed=7)
    cache.put(IDS, local)
    stats = kv.install_bundle(kv.build_bundle(IDS, fake_entry()), fake_init, cache)
    assert (stats["present"], stats["installed"]) == (1, 0)
    assert cache.entry_origin(IDS) == "local"
    assert torch.equal(cache.lookup(IDS + [9])[1]["k"], local["k"])


def test_a_re_put_keeps_an_installed_entry_installed():
    cache = PrefixKVCache(4)
    kv.install_bundle(kv.build_bundle(IDS, fake_entry()), fake_init, cache)
    cache.put(IDS, fake_entry(seed=2))  # the engine refreshes its entries
    assert cache.entry_origin(IDS) == "installed" and cache.take_publishable(1) == []


def test_install_from_dir_aggregates(tmp_path):
    d = tmp_path / "model"
    d.mkdir()
    data = kv.build_bundle(IDS, fake_entry())
    meta = kv._bundle_meta(data)
    (d / kv.bundle_name(kv.env_key(), meta["prefixHash"])).write_bytes(data)
    (d / (".kv-deadbeef0000-" + "0" * 16 + ".tar")).write_bytes(b"junk from another pod")
    total = kv.install_from_dir(str(d), fake_init, PrefixKVCache(4))
    assert (total["bundles"], total["installed"]) == (2, 1) and total["reasons"]


def test_install_for_server_uses_the_family_decode_fns(tmp_path):
    class Fam:
        @staticmethod
        def decode_fns(params, cfg):
            return None, fake_init

    class Srv:
        family, cfg, params = Fam(), None, {}

        def __init__(self):
            self._prefix_cache = PrefixKVCache(4)

    d = tmp_path / "model"
    d.mkdir()
    (d / (".kv-" + "a" * 12 + "-" + "b" * 16 + ".tar")).write_bytes(
        kv.build_bundle(IDS, fake_entry()))
    srv = Srv()
    assert kv.install_for_server(srv, str(d))["installed"] == 1
    assert srv._prefix_cache.entry_origin(IDS) == "installed"
    srv._prefix_cache = None
    assert kv.install_for_server(srv, str(d)) is None


# -- the hardening ladder, against the JAX package ---------------------------------------


def _kinds(stats: dict) -> list:
    return [r.split(":")[0] for r in stats["reasons"]]


def _evil(pkg, name: str) -> bytes:
    import hashlib

    blob = np.zeros((1, 16, 2, 4), np.float32).tobytes()
    env = ps._env(None) if pkg == "port" else jkv._ps._env(None)
    meta = {"formatVersion": 1, "jax": env[0], "backend": env[1], "codeVersion": env[2],
            "mesh": env[3], "modelKey": "", "prefixHash": "x", "tokens": IDS,
            "storedLen": 16,
            "leaves": [{"name": name, "dtype": "float32", "shape": [1, 16, 2, 4],
                        "spec": None, "sha256": hashlib.sha256(blob).hexdigest(),
                        "size": len(blob)}] * 2}
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w", format=tarfile.USTAR_FORMAT) as tar:
        for n, payload in [("meta.json", json.dumps(meta).encode()),
                           (name.replace("..", "dot"), blob)]:
            info = tarfile.TarInfo(n)
            info.size = len(payload)
            tar.addfile(info, io.BytesIO(payload))
    return buf.getvalue()


CASES = ["garbage", "cut-100", "cut-700", "cut-1800", "cut-3000", "version", "mesh", "model",
         "tampered", "evil-traversal", "evil-atime", "evil-upper", "format", "layout",
         "byte-cap", "present"]


@pytest.mark.parametrize("case", CASES)
def test_every_hardening_case_skips_for_the_reference_reason(case, monkeypatch):
    got = {}
    for pkg in ("jax", "port"):
        mod, init = (jkv, jfake_init) if pkg == "jax" else (kv, fake_init)
        entry = (jax_entry if pkg == "jax" else port_entry)(fake_arrays())
        cache = (jdecode.PrefixKVCache if pkg == "jax" else PrefixKVCache)(
            4, max_bytes=64 if case == "byte-cap" else 0)
        data = mod.build_bundle(IDS, entry, model_key="m-one" if case == "model" else "",
                                mesh="dp=2,tp=4" if case == "mesh" else None)
        kw = {"model_key": "m-two"} if case == "model" else {}
        with monkeypatch.context() as m:
            if case == "garbage":
                data = b"this is not a tar archive"
            elif case.startswith("cut-"):
                data = data[:int(case[4:])]
            elif case == "version":
                m.setattr(*((aot_cache, "_code_version", "f" * 16) if pkg == "jax"
                            else (ps, "_code_version", "f" * 16)))
            elif case == "tampered":
                with tarfile.open(fileobj=io.BytesIO(data), mode="r:") as tar:
                    off = tar.getmember("leaf-00000.bin").offset_data
                data = bytearray(data)
                data[off + 8] ^= 0xFF
                data = bytes(data)
            elif case.startswith("evil-"):
                data = _evil(pkg, {"traversal": "../evil.bin", "atime": "leaf-00000.bin.atime",
                                   "upper": "LEAF-00000.bin"}[case[5:]])
            elif case == "format":
                data = data.replace(b'"formatVersion":1', b'"formatVersion":9')
            elif case == "layout":
                init = ((lambda b, n: {"k": jnp.zeros((b, n, 4, 8), jnp.float32),
                                       "v": jnp.zeros((b, n, 4, 8), jnp.float32)})
                        if pkg == "jax" else
                        (lambda b, n: {"k": torch.zeros((b, n, 4, 8)),
                                       "v": torch.zeros((b, n, 4, 8))}))
            elif case == "present":
                cache.put(IDS, entry)
            got[pkg] = mod.install_bundle(data, init, cache, **kw)
            if case not in ("present",):
                assert cache.stats()["entries"] == 0
    assert _kinds(got["port"]) == _kinds(got["jax"])
    for k in ("installed", "present", "skipped"):
        assert got["port"][k] == got["jax"][k], k
    if case == "layout":
        assert got["port"]["reasons"] == got["jax"]["reasons"]  # the whole message


def test_model_and_mesh_skews_install_where_the_world_matches():
    data = kv.build_bundle(IDS, fake_entry(), model_key="m-one")
    # an unreachable manifest gives an empty local key: the check is skipped
    assert kv.install_bundle(data, fake_init, PrefixKVCache(4))["installed"] == 1
    other = kv.build_bundle(IDS, fake_entry(), mesh="dp=2,tp=4")
    assert kv.install_bundle(other, fake_init, PrefixKVCache(4),
                             mesh="dp=2,tp=4")["installed"] == 1


# -- the publisher and the fetcher -------------------------------------------------------


class _Srv:
    def __init__(self, cache):
        self._prefix_cache = cache


HOT_REF = "http://127.0.0.1:9/library/x@v1"  # the model key lookup fails: ""


@pytest.mark.parametrize("threshold", [1, 2, 3])
def test_the_same_hits_publish_the_same_keys(threshold):
    keys = {}
    for pkg in ("jax", "port"):
        mod = jkv if pkg == "jax" else kv
        cache = (jdecode.PrefixKVCache if pkg == "jax" else PrefixKVCache)(4)
        mk = jax_entry if pkg == "jax" else port_entry
        for i, ids in enumerate(([1, 2], [1, 2, 3], [7, 7], [5])):
            cache.put(ids, mk(fake_arrays(seed=i)))
        for probe in ([1, 2, 3, 4], [1, 2, 9], [1, 2, 3, 8], [7, 7, 7], [5, 5], [1, 2, 3, 1]):
            cache.lookup(probe)
        shipped = []
        pub = mod.KVPublisher(lambda cache=cache: [(HOT_REF, _Srv(cache))],
                              lambda ref, data: shipped.append(mod._bundle_meta(data)["tokens"]),
                              threshold=threshold)
        assert pub.flush() == len(shipped)
        assert pub.flush() == 0  # marked at take
        keys[pkg] = (sorted(shipped), cache.stats()["published_total"],
                     pub.snapshot()["published_total"])
    assert keys["port"] == keys["jax"]


def test_sink_failure_counted_not_raised():
    cache = PrefixKVCache(4)
    cache.put(IDS, fake_entry())
    cache.lookup(IDS + [1])
    cache.lookup(IDS + [2])

    def sink(ref, data):
        raise RuntimeError("outbox disk full")

    pub = kv.KVPublisher(lambda: [(HOT_REF, _Srv(cache))], sink, threshold=2)
    assert pub.flush() == 0 and pub.snapshot()["sink_failures_total"] == 1
    assert pub.last_build_ms > 0


def test_on_miss_is_bounded_and_lookup_notifies_outside_the_lock():
    cache = PrefixKVCache(4)
    fetcher = kv.KVFetcher("reg/m@v1", fake_init, cache)
    for i in range(kv.KVFetcher.MAX_QUEUE * 3):
        fetcher.on_miss([i])
    assert fetcher.snapshot()["pending"] == kv.KVFetcher.MAX_QUEUE

    class Probe:
        def on_miss(self, ids):
            assert cache._lock.acquire(blocking=False)  # not held by lookup
            cache._lock.release()
            raise RuntimeError("a broken fetcher never breaks a lookup")

    cache.fetcher = Probe()
    assert cache.lookup([1, 2]) is None and cache.misses == 1


@pytest.fixture
def pushed(tmp_path):
    from modelx_tpu.client.client import Client as JaxClient

    srv, base = start_port_registry()
    JaxClient(base, quiet=True).push(REPO_NAME, "v1", write_model_dir(tmp_path / "m"))
    client = Client(base, quiet=True)
    yield base, client
    client.remote.close()
    srv.shutdown()


@pytest.fixture
def bundle():
    return kv.build_bundle(IDS, fake_entry())


def test_publish_is_a_real_descriptor(pushed, bundle):
    base, client = pushed
    desc = kv.publish(client.remote, REPO_NAME, "v1", bundle)
    manifest = client.get_manifest(REPO_NAME, "v1")
    (got,) = kv.kv_descriptors(manifest)
    envk = kv.env_key()
    assert got.media_type == MediaTypeModelKVCache and desc.size == len(bundle)
    assert got.name == kv.bundle_name(envk, kv.prefix_hash("", envk, IDS))
    assert str(got.digest) == str(Digest.from_bytes(bundle))
    assert got.annotations[AnnotationKVTokens] == str(len(IDS))
    assert got.annotations[AnnotationKVPrefix] == kv.prefix_hash("", envk, IDS)
    assert got.annotations[AnnotationKVModel] == ""
    assert any(b.name == "model.safetensors" for b in manifest.blobs)


def test_republish_replaces_other_prefix_coexists(pushed, bundle):
    base, client = pushed
    kv.publish(client.remote, REPO_NAME, "v1", bundle)
    first = client.get_manifest(REPO_NAME, "v1").blobs
    kv.publish(client.remote, REPO_NAME, "v1", bundle)
    assert client.get_manifest(REPO_NAME, "v1").blobs == first  # a no-op
    kv.publish(client.remote, REPO_NAME, "v1", kv.build_bundle([9, 9, 9], fake_entry(seed=3)))
    assert len(kv.kv_descriptors(client.get_manifest(REPO_NAME, "v1"))) == 2


def test_pull_and_install_through_the_blob_cache(pushed, bundle, tmp_path):
    base, client = pushed
    kv.publish(client.remote, REPO_NAME, "v1", bundle)
    bc = BlobCache(str(tmp_path / "bc"))
    manifest = client.get_manifest(REPO_NAME, "v1")
    s1 = kv.pull_and_install(client, REPO_NAME, manifest, fake_init, PrefixKVCache(4),
                             blob_cache=bc)
    assert (s1["installed"], s1["bundles"]) == (1, 1) and bc.stats["admitted"] >= 1
    s2 = kv.pull_and_install(client, REPO_NAME, manifest, fake_init, PrefixKVCache(4),
                             blob_cache=bc)
    assert s2["installed"] == 1 and bc.stats["hits"] >= 1


def test_skew_annotations_skip_without_fetching(pushed, bundle, monkeypatch):
    base, client = pushed
    kv.publish(client.remote, REPO_NAME, "v1", bundle)
    kv.publish(client.remote, REPO_NAME, "v1",
               kv.build_bundle([7, 7], fake_entry(seed=2), mesh="dp=2,tp=4"))
    manifest = client.get_manifest(REPO_NAME, "v1")
    fetches = []
    monkeypatch.setattr(client.remote, "get_blob_content",
                        lambda *a, **k: fetches.append(a) or iter(()))
    stats = kv.pull_and_install(client, REPO_NAME, manifest, fake_init, PrefixKVCache(4),
                                mesh="dp=8,tp=1")
    assert stats["installed"] == 0 and not fetches
    assert sum("skew (annotation)" in r for r in stats["reasons"]) == 2


def test_pull_model_lands_the_bundle_next_to_the_weights(pushed, bundle, tmp_path):
    from modelx_tpu_torch.dl.initializer import pull_model

    base, client = pushed
    desc = kv.publish(client.remote, REPO_NAME, "v1", bundle)
    stats = pull_model(f"{base}/{REPO_NAME}@v1", str(tmp_path / "dest"))
    assert stats["kv_blobs"] == 1 and os.path.isfile(tmp_path / "dest" / desc.name)


def test_miss_fetches_and_the_next_lookup_hits(pushed, bundle):
    base, client = pushed
    kv.publish(client.remote, REPO_NAME, "v1", bundle)
    cache = PrefixKVCache(4)
    fetcher = kv.KVFetcher(f"{base}/{REPO_NAME}@v1", fake_init, cache)
    cache.fetcher = fetcher
    assert cache.lookup(IDS) is None  # the whole prompt: not a usable prefix
    assert fetcher.drain_once() and fetcher.snapshot()["fetched_total"] == 0
    assert cache.lookup(IDS + [9, 9]) is None  # a miss enqueues
    assert fetcher.drain_once() is True
    snap = fetcher.snapshot()
    assert snap["installed_total"] == 1 and snap["install_ms_total"] > 0
    hit = cache.lookup(IDS + [9, 9])
    assert hit is not None and hit[0] == len(IDS) and cache.hits_installed == 1


def test_a_failed_install_is_not_refetched(pushed):
    base, client = pushed
    bad = kv.build_bundle(IDS, {"k": torch.zeros((1, 16, 4, 8)), "v": torch.zeros((1, 16, 4, 8))})
    kv.publish(client.remote, REPO_NAME, "v1", bad)
    cache = PrefixKVCache(4)
    fetcher = kv.KVFetcher(f"{base}/{REPO_NAME}@v1", fake_init, cache)
    fetcher.MANIFEST_TTL_S = 0.0
    cache.fetcher = fetcher
    assert cache.lookup(IDS + [9]) is None and fetcher.drain_once()
    assert (fetcher.snapshot()["fetched_total"], fetcher.snapshot()["installed_total"]) == (1, 0)
    assert cache.lookup(IDS + [9, 9]) is None and fetcher.drain_once()
    assert fetcher.snapshot()["fetched_total"] == 1  # tried once: no refetch


# -- real decodes: the byte-exactness contract, against the JAX package -------------------


_CFG_FIELDS = ("vocab_size", "hidden_size", "intermediate_size", "num_layers", "num_heads",
               "num_kv_heads", "head_dim", "rope_theta", "rms_eps", "tie_embeddings",
               "qkv_bias")


@pytest.fixture(scope="module")
def model():
    jcfg = dataclasses.replace(jl.LlamaConfig.tiny(vocab_size=64), dtype=jnp.float32)
    jparams = jl.init_params(jcfg, jax.random.PRNGKey(0))
    tcfg = tl.LlamaConfig(**{f: getattr(jcfg, f) for f in _CFG_FIELDS}, dtype=torch.float32)
    tparams = from_jax_params({k: np.asarray(v) for k, v in jparams.items()}, device="cpu")
    fwd, init = tl.decode_fns(tparams, tcfg)

    def jfwd(p, t, kv_cache, cache_offset=0, mesh=None):
        return jl.forward(p, t, jcfg, kv_cache=kv_cache, cache_offset=cache_offset)

    return dict(jparams=jparams, tparams=tparams, fwd=fwd, init=init, jfwd=jfwd,
                jinit=lambda b, n: jl.init_kv_cache(jcfg, b, n))


def _controls(samp: dict) -> dict:
    out = {}
    for key, val in samp.items():
        key = "seeds" if key == "seed" else key
        out[key] = np.asarray([val], np.float32 if key in ("temperature", "top_p") else np.int32)
    return out


def _stream(dec, params, ids, n, samp, jax_side=False):
    prompt = np.zeros((1, pad_seq_len(len(ids))), np.int32)
    prompt[0, : len(ids)] = ids
    tokens = jnp.asarray(prompt) if jax_side else torch.from_numpy(prompt.astype(np.int64))
    lens = np.asarray([len(ids)], np.int32)
    pieces = list(dec.stream(params, tokens, lens, n, **_controls(samp)))
    return np.concatenate([np.asarray(p) for p in pieces], axis=1)[0].tolist()


@pytest.mark.parametrize("samp", [{}, {"temperature": 0.9, "seed": 11},
                                  {"temperature": 0.9, "top_k": 8, "top_p": 0.9, "seed": 5}],
                         ids=["greedy", "sampled", "filtered"])
def test_a_stream_from_installed_kv_equals_local_prefill_and_jax(model, samp):
    turn1 = [3, 4, 5, 6, 7]
    turn2 = turn1 + [8, 8, 8]
    cold = _stream(ChunkedDecoder(model["fwd"], model["init"], 4), model["tparams"], turn2, 8,
                   samp)
    jcold = _stream(jdecode.ChunkedDecoder(model["jfwd"], model["jinit"], 4), model["jparams"],
                    turn2, 8, samp, jax_side=True)
    assert cold == jcold
    # the publisher's side: heat a capture decoder, take the hot entry
    cap = ChunkedDecoder(model["fwd"], model["init"], 4, prefix_cache=PrefixKVCache(4))
    _stream(cap, model["tparams"], turn1, 8, samp)
    local = _stream(cap, model["tparams"], turn2, 8, samp)  # a local strict-prefix hit
    taken = dict(cap.prefix_cache.take_publishable(1))
    data = kv.build_bundle(turn1, taken[tuple(turn1)])
    # the JAX package's capture bundles the same leaf bytes
    jcap = jdecode.ChunkedDecoder(model["jfwd"], model["jinit"], 4,
                                  prefix_cache=jdecode.PrefixKVCache(4))
    _stream(jcap, model["jparams"], turn1, 8, samp, jax_side=True)
    assert _stream(jcap, model["jparams"], turn2, 8, samp, jax_side=True) == jcold
    jdata = jkv.build_bundle(turn1, dict(jcap.prefix_cache.take_publishable(1))[tuple(turn1)])
    np.testing.assert_allclose(
        np.frombuffer(_members(data)[1][1], np.float32),
        np.frombuffer(_members(jdata)[1][1], np.float32), rtol=1e-5, atol=1e-5)
    pc = PrefixKVCache(4)
    assert kv.install_bundle(data, model["init"], pc)["installed"] == 1
    warm = ChunkedDecoder(model["fwd"], model["init"], 4, prefix_cache=pc)
    assert _stream(warm, model["tparams"], turn2, 8, samp) == local == cold
    assert pc.hits_installed == 1


# -- the pod-kill drill ----------------------------------------------------------------


def test_publish_pod_kill_reinstall(tmp_path):
    """Pod 1 heats a shared prefix and ships it threshold -> outbox, and
    dies before the publish lands; the next generation's drainer (the
    spool is files) publishes it; a replacement pod pulls the model,
    installs the bundle at its load and serves the hot prompt's tokens
    without prefilling the prefix."""
    from modelx_tpu.client.client import Client as JaxClient
    from modelx_tpu_torch.dl.initializer import pull_model
    from modelx_tpu_torch.dl.serve import ModelServer
    from tests.test_torch_serve import _write_tiny_fp32

    d = tmp_path / "m"
    _write_tiny_fp32(str(d))
    srv, base = start_port_registry()
    try:
        JaxClient(base, quiet=True).push("library/drill", "v1", str(d))
        ref = f"{base}/library/drill@v1"

        def stream(pod, ids, n=6):
            pieces = list(pod.generate_stream(np.asarray([ids], np.int32), max_new_tokens=n,
                                              chunk_size=4))
            return np.concatenate(pieces, axis=1)[0].tolist()

        pod1 = ModelServer(str(d), dtype="float32", device="cpu", max_seq_len=64,
                           prefix_cache_size=4, name="pod1")
        pod1.load()
        hot = [5, 6, 7, 8, 9]
        stream(pod1, hot)
        expect = stream(pod1, hot + [4])   # hit 1
        stream(pod1, hot + [2])            # hit 2: crosses the threshold
        ob = Outbox(str(tmp_path / "outbox"))

        def sink(r, b):
            if not ob.enqueue(kv.OUTBOX_KIND, r, b):
                raise RuntimeError("spool full")

        pub = kv.KVPublisher(lambda: [(ref, pod1)], sink, threshold=2)
        assert pub.flush() == 1
        del pod1, pub  # the pod dies; the spool survives as files
        dr = Drainer(Outbox(str(tmp_path / "outbox")), handler=None)
        dr.register_handler(kv.OUTBOX_KIND, lambda k, r, data: kv.publish_bundle(r, data))
        assert dr.drain_once()
        client = Client(base, quiet=True)
        (desc,) = kv.kv_descriptors(client.get_manifest("library/drill", "v1"))
        assert desc.annotations[AnnotationKVModel] == kv.model_key_for_ref(ref) != ""
        dest = str(tmp_path / "pulled")
        assert pull_model(ref, dest)["kv_blobs"] == 1
        pod2 = ModelServer(dest, dtype="float32", device="cpu", max_seq_len=64,
                           prefix_cache_size=4, name="pod2")
        stats = pod2.load()  # installs the pulled bundle at the load's tail
        assert stats["kv"]["installed"] == 1 and stats["kv"]["ms"] >= 0
        assert pod2._prefix_cache.stats()["installed_total"] == 1
        assert stream(pod2, hot + [4]) == expect
        assert pod2._prefix_cache.hits_installed == 1
        client.remote.close()
    finally:
        srv.shutdown()
