"""The port's directory pusher (modelx_tpu_torch/client/push.py) against
the JAX package's, on the CPU: the manifest each builds for the same
directory is byte-identical (``json.dumps(..., sort_keys=True)`` tensor
index, the 256 KiB cap, descriptor order, modes, the shard spec and the
mesh annotation), for llama-, gemma2- and mixtral-layout safetensors,
modelx.yaml with and without ``serving.mesh``, a tokenizer.json, nested
directories and a file past the tensor-index cap; a push by either
package's client of the same directory commits the same manifest digest,
and the commit's delta retry re-pushes only what the server names.

Tolerance: exact byte equality.
"""

import hashlib
import os

import numpy as np
import pytest
import torch

from modelx_tpu.client import push as jpush
from modelx_tpu.client.client import Client as JaxClient
from modelx_tpu_torch.client import push as tpush
from modelx_tpu_torch.client.client import Client
from modelx_tpu_torch.dl import safetensors as st
from modelx_tpu_torch.registry.fs import MemoryFSProvider
from modelx_tpu_torch.registry.server import Options, RegistryServer, free_port
from modelx_tpu_torch.registry.store_fs import FSRegistryStore
from modelx_tpu_torch.types import AnnotationShardMesh, AnnotationShardSpec, AnnotationTensorIndex


def _tensors(layout: str, seed: int) -> dict:
    g = torch.Generator().manual_seed(seed)

    def t(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, generator=g).to(dtype)

    p = {"model.embed_tokens.weight": t(32, 8), "model.norm.weight": t(8, dtype=torch.float32),
         "lm_head.weight": t(32, 8)}
    for i in range(2):
        pre = f"model.layers.{i}."
        p[pre + "self_attn.q_proj.weight"] = t(8, 8)
        p[pre + "self_attn.k_proj.weight"] = t(4, 8)
        p[pre + "self_attn.v_proj.weight"] = t(4, 8)
        p[pre + "self_attn.o_proj.weight"] = t(8, 8)
        p[pre + "input_layernorm.weight"] = t(8)
        if layout == "mixtral":
            p[pre + "block_sparse_moe.gate.weight"] = t(4, 8)
            for e in range(4):
                for w, shape in (("w1", (16, 8)), ("w2", (8, 16)), ("w3", (16, 8))):
                    p[pre + f"block_sparse_moe.experts.{e}.{w}.weight"] = t(*shape)
        else:
            p[pre + "mlp.gate_proj.weight"] = t(16, 8)
            p[pre + "mlp.up_proj.weight"] = t(16, 8)
            p[pre + "mlp.down_proj.weight"] = t(8, 16)
        if layout == "gemma2":
            p[pre + "pre_feedforward_layernorm.weight"] = t(8)
            p[pre + "post_feedforward_layernorm.weight"] = t(8)
    return p


def _past_the_cap() -> dict:
    """Enough tensors that the index annotation passes 256 KiB."""
    return {f"model.layers.{i}.extra.some_long_tensor_name_to_fill_the_index.weight":
            torch.zeros(2, dtype=torch.int8) for i in range(3000)}


def _write_dir(root, case: str) -> str:
    d = root / case
    d.mkdir()
    if case in ("llama", "gemma2", "mixtral"):
        st.write_safetensors(str(d / "model.safetensors"), _tensors(case, 1))
    if case == "llama":
        (d / "modelx.yaml").write_text("description: tiny llama\nframework: pytorch\n"
                                       "serving:\n  mesh: dp=1,tp=2\n  dtype: bfloat16\n")
        (d / "tokenizer.json").write_text('{"model": {"type": "BPE", "vocab": {"a": 0}}}')
    if case == "gemma2":
        (d / "modelx.yaml").write_text("description: no mesh\nmodelFiles: [model.safetensors]\n")
        nested = d / "extras" / "deep" / "deeper"
        nested.mkdir(parents=True)
        (nested / "a.bin").write_bytes(np.random.RandomState(2).bytes(1000))
        (d / "extras" / "b.txt").write_text("b\n")
        os.chmod(d / "extras" / "b.txt", 0o755)
        (d / ".hidden").write_text("skipped")
        (d / "empty.bin").write_bytes(b"")
    if case == "mixtral":
        shards = d / "shards"
        shards.mkdir()
        st.write_safetensors(str(shards / "part.safetensors"), _tensors("llama", 2))
        (d / "config.json").write_text('{"num_local_experts": 4}')
        os.chmod(d / "config.json", 0o600)
    if case == "capped":
        st.write_safetensors(str(d / "big.safetensors"), _past_the_cap())
        st.write_safetensors(str(d / "small.safetensors"), _tensors("llama", 3))
        (d / "modelx.yaml").write_text("serving: {mesh: 'dp=2'}\n")
    if case == "bad-yaml":
        (d / "modelx.yaml").write_text("serving: [unclosed\n")
        (d / "weights.safetensors").write_bytes(b"not a safetensors file")
    return str(d)


CASES = ["llama", "gemma2", "mixtral", "capped", "bad-yaml"]


@pytest.mark.parametrize("case", CASES)
def test_manifest_bytes_equal_the_jax_pusher(tmp_path, case):
    d = _write_dir(tmp_path, case)
    tm, tt = tpush.parse_manifest_from_dir(d, cache_dir=str(tmp_path / "tcache"))
    jm, jt = jpush.parse_manifest_from_dir(d, cache_dir=str(tmp_path / "jcache"))
    assert tm.encode() == jm.encode()
    assert hashlib.sha256(tm.encode()).hexdigest() == hashlib.sha256(jm.encode()).hexdigest()
    assert sorted(tt) == sorted(jt)
    for digest in tt:
        with open(tt[digest], "rb") as a, open(jt[digest], "rb") as b:
            assert a.read() == b.read()


def test_annotations_present_as_expected(tmp_path):
    m, _ = tpush.parse_manifest_from_dir(_write_dir(tmp_path, "llama"),
                                         cache_dir=str(tmp_path / "c"))
    assert m.annotations[AnnotationShardMesh] == "dp=1,tp=2"
    (w,) = [b for b in m.blobs if b.name == "model.safetensors"]
    assert AnnotationTensorIndex in w.annotations and AnnotationShardSpec in w.annotations
    m, _ = tpush.parse_manifest_from_dir(_write_dir(tmp_path, "capped"),
                                         cache_dir=str(tmp_path / "c2"))
    big, small = (next(b for b in m.blobs if b.name == n)
                  for n in ("big.safetensors", "small.safetensors"))
    assert AnnotationTensorIndex not in big.annotations  # past the 256 KiB cap
    assert AnnotationTensorIndex in small.annotations
    assert m.annotations[AnnotationShardMesh] == "dp=2"
    m, _ = tpush.parse_manifest_from_dir(_write_dir(tmp_path, "bad-yaml"),
                                         cache_dir=str(tmp_path / "c3"))
    assert AnnotationShardMesh not in m.annotations
    assert m.blobs[0].annotations == {}


@pytest.fixture
def registry():
    store = FSRegistryStore(MemoryFSProvider())
    srv = RegistryServer(Options(listen=f"127.0.0.1:{free_port()}"), store=store)
    base = srv.serve_background()
    yield base, store
    srv.shutdown()


@pytest.mark.parametrize("case", ["llama", "gemma2", "mixtral"])
def test_both_clients_push_the_same_manifest(tmp_path, registry, case):
    base, store = registry
    d = _write_dir(tmp_path, case)
    Client(base, quiet=True).push("library/port", "v1", d)
    JaxClient(base, quiet=True).push("library/jax", "v1", d)
    tm = store.get_manifest("library/port", "v1")
    jm = store.get_manifest("library/jax", "v1")
    assert tm.encode() == jm.encode()
    assert sorted(store.list_blobs("library/port")) == sorted(store.list_blobs("library/jax"))
    out = tmp_path / "out"
    Client(base, quiet=True).pull("library/port", "v1", str(out))
    for b in tm.blobs:
        if b.media_type.endswith("tar+gzip"):
            continue
        with open(os.path.join(d, b.name), "rb") as a, open(out / b.name, "rb") as c:
            assert a.read() == c.read()


def test_commit_delta_retry_repushes_only_the_named_blob(tmp_path, registry, monkeypatch):
    """A commit refused with a blob's digest as missing re-pushes just that
    blob, skipping the dedup probe, and commits on the retry."""
    from modelx_tpu_torch import errors

    base, store = registry
    d = _write_dir(tmp_path, "llama")
    client = Client(base, quiet=True)
    client.push("library/x", "v1", d)
    weights = next(b for b in store.get_manifest("library/x", "v1").blobs
                   if b.name == "model.safetensors")
    refusals = []
    orig_put = store.put_manifest

    def put_manifest(repo, ref, ctype, manifest):
        if not refusals:
            refusals.append(ref)
            raise errors.commit_invalid([weights.digest], [])
        return orig_put(repo, ref, ctype, manifest)

    monkeypatch.setattr(store, "put_manifest", put_manifest)
    pushed = []
    orig = tpush.Pusher.push_blob
    monkeypatch.setattr(tpush.Pusher, "push_blob",
                        lambda self, repo, desc, path, force=False:
                        pushed.append((desc.name, force)) or orig(self, repo, desc, path, force))
    client.push("library/x", "v2", d)
    assert refusals == ["v2"]
    assert [p for p in pushed if p[1]] == [("model.safetensors", True)]
    assert store.get_manifest("library/x", "v2").encode() == \
        store.get_manifest("library/x", "v1").encode()
    e = errors.commit_invalid(["sha256:" + "1" * 64], [{"digest": "sha256:" + "2" * 64}])
    assert tpush.commit_delta_digests(e) == {"sha256:" + "1" * 64, "sha256:" + "2" * 64}
    assert tpush.commit_delta_digests(errors.blob_unknown("x")) == set()
