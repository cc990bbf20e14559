"""The port's deploy path (modelx_tpu_torch.dl.initializer, dl_main)
against the JAX package's, on the CPU:

- ``filter_blobs`` equals the JAX one on hypothesis manifests (nested
  modelFiles paths, program and KV bundles);
- ``run_initializer(device_put=True, device="cpu")`` puts tensors on the
  device that equal ``np.asarray`` of the JAX ``load_to_mesh`` arrays bit
  for bit (fp32 and bf16 tiny checkpoints), through each rung of the
  transport ladder: the ``file`` redirect, the registry's ranged GET, a
  presigned URL, and a warm blob-cache hit; its summary carries the JAX
  summary's keys;
- ``modelxdl-torch`` through ``main(argv)``: the dest it pulls, served by
  the port's sidecar, answers ``/v1/forward`` byte-identically to the JAX
  sidecar on the same dest; without ``--device cpu`` it raises (no card
  here, no silent fallback).
"""

import dataclasses
import json
import os
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from modelx_tpu.client.client import Client as JaxClient
from modelx_tpu.dl import safetensors as jst
from modelx_tpu.dl.initializer import filter_blobs as jax_filter_blobs
from modelx_tpu.dl.initializer import run_initializer as jax_run_initializer
from modelx_tpu.dl.serve import ModelServer as JaxModelServer
from modelx_tpu.dl.serve import serve as jax_serve
from modelx_tpu.models import llama as jl
from modelx_tpu.registry.server import free_port
from modelx_tpu.types import Descriptor as JaxDescriptor
from modelx_tpu.types import Manifest as JaxManifest
from modelx_tpu_torch.dl import dl_main, serve_main
from modelx_tpu_torch.dl.initializer import filter_blobs, run_initializer
from modelx_tpu_torch.registry.fs import LocalFSProvider
from modelx_tpu_torch.registry.server import Options, RegistryServer
from modelx_tpu_torch.registry.store_fs import FSRegistryStore
from modelx_tpu_torch.types import BlobLocation, Descriptor, Manifest

PROGRAM = "application/vnd.modelx.program.v1"
KVCACHE = "application/vnd.modelx.kvcache.v1"
FILE = "application/vnd.modelx.model.file.v1"
TGZ = "application/vnd.modelx.model.directory.v1.tar+gzip"

_segment = st.text(alphabet="abcxyz._-", min_size=1, max_size=4)
_path = st.lists(_segment, min_size=1, max_size=3).map("/".join)


@settings(max_examples=150, deadline=None, derandomize=True)
@given(blobs=st.lists(st.tuples(_path, st.sampled_from([FILE, TGZ, PROGRAM, KVCACHE])),
                      max_size=8),
       model_files=st.lists(st.one_of(_path, _path.map(lambda p: "/" + p + "/")), max_size=5))
def test_filter_blobs_equals_jax(blobs, model_files):
    digest = "sha256:" + "0" * 64
    port = Manifest(blobs=[Descriptor(name=n, media_type=m, digest=digest) for n, m in blobs])
    ref = JaxManifest(blobs=[JaxDescriptor(name=n, media_type=m, digest=digest)
                             for n, m in blobs])
    got = filter_blobs(port, model_files)
    want = jax_filter_blobs(ref, model_files)
    assert got.encode() == want.encode()


def _write_checkpoint(dirpath, dtype):
    """tests/test_lifecycle.py's write_tiny in ``dtype``, with llama-3's
    rope_theta, plus a modelx.yaml selecting the weights."""
    cfg = dataclasses.replace(jl.LlamaConfig.tiny(), rope_theta=500000.0, dtype=dtype)
    params = jl.init_params(cfg, jax.random.PRNGKey(0), dtype=dtype)
    os.makedirs(dirpath, exist_ok=True)
    jst.write_safetensors(os.path.join(dirpath, "model.safetensors"),
                          {k: np.asarray(v) for k, v in params.items()})
    with open(os.path.join(dirpath, "modelx.yaml"), "w") as f:
        f.write("description: tiny\nmodelFiles:\n- model.safetensors\n")
    with open(os.path.join(dirpath, "notes.txt"), "w") as f:
        f.write("left out by modelFiles\n")


class _PresignStore(FSRegistryStore):
    """A store that hands out an ``http`` location whose url is the blob
    endpoint itself: the presigned-URL rung of the ladder."""

    base = ""

    def get_blob_location(self, repository, digest, purpose, properties):
        if self.base and purpose == "download":
            return BlobLocation(provider="http", purpose=purpose,
                                properties={"url": f"{self.base}/{repository}/blobs/{digest}"})
        return super().get_blob_location(repository, digest, purpose, properties)


@pytest.fixture(scope="module")
def deployed(tmp_path_factory):
    """fp32 and bf16 tiny models pushed (by the JAX client) into a port
    registry on a local FS store (``file`` locations), and into one whose
    store presigns."""
    root = tmp_path_factory.mktemp("deploy")
    out = {}
    servers = []
    for name, dtype in (("fp32", jnp.float32), ("bf16", jnp.bfloat16)):
        _write_checkpoint(str(root / name), dtype)
    for kind in ("local", "presign"):
        cls = _PresignStore if kind == "presign" else FSRegistryStore
        store = cls(LocalFSProvider(str(root / f"registry-{kind}")), local_redirect=True)
        srv = RegistryServer(Options(listen=f"127.0.0.1:{free_port()}"), store=store)
        base = srv.serve_background()
        servers.append(srv)
        for name in ("fp32", "bf16"):
            JaxClient(base, quiet=True).push(f"library/{name}", "v1", str(root / name))
        store.base = base
        out[kind] = base
    out["root"] = root
    yield out
    for srv in servers:
        srv.shutdown()


def _bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.contiguous().view(torch.uint8).numpy()
    return np.ascontiguousarray(np.asarray(x)).view(np.uint8)


_JAX_LOADS: dict = {}


def _jax_arrays(base, name, tmp_path):
    if (base, name) not in _JAX_LOADS:
        summary = jax_run_initializer(f"{base}/library/{name}@v1", str(tmp_path / "jax-dest"),
                                      device_put=True, mesh_spec="dp=1", quiet=True)
        _JAX_LOADS[(base, name)] = summary
    return _JAX_LOADS[(base, name)]


@pytest.mark.parametrize("name", ["fp32", "bf16"])
@pytest.mark.parametrize("rung", ["file", "registry", "url", "cache"])
def test_device_put_equals_jax_load_to_mesh(deployed, tmp_path, monkeypatch, name, rung):
    base = deployed["presign" if rung == "url" else "local"]
    jsum = _jax_arrays(base, name, tmp_path)
    cache_dir = str(tmp_path / "blob-cache")
    if rung != "file":
        monkeypatch.setenv("MODELX_DL_NO_LOCAL_REDIRECT", "1")
    if rung == "cache":  # a cold deploy fills the cache; the measured one hits it
        run_initializer(f"{base}/library/{name}@v1", str(tmp_path / "cold"), device_put=True,
                        device="cpu", quiet=True, blob_cache_dir=cache_dir)
    summary = run_initializer(f"{base}/library/{name}@v1", str(tmp_path / "dest"),
                              device_put=True, device="cpu", quiet=True,
                              blob_cache_dir=cache_dir)
    load = summary["load"]
    assert load["transports"] == {"model.safetensors": rung}
    arrays = load.pop("arrays")
    want = jsum["load"]["arrays"]
    assert sorted(arrays) == sorted(want)
    for k in want:
        assert arrays[k].device.type == "cpu"
        assert tuple(arrays[k].shape) == tuple(want[k].shape)
        np.testing.assert_array_equal(_bits(arrays[k]), _bits(want[k]), err_msg=k)
    # the JAX summary's keys, and the same counts
    assert set(jsum) <= set(summary)
    assert set(jsum["load"]) - {"mesh", "arrays"} <= set(load)
    for key in ("blobs", "bytes"):
        assert summary[key] == jsum[key]
    assert load["tensors"] == jsum["load"]["tensors"] and load["bytes"] == jsum["load"]["bytes"]
    assert sorted(os.listdir(str(tmp_path / "dest"))) == ["model.safetensors", "modelx.yaml"]
    if rung == "cache":
        assert load["network_bytes"] == 0 and summary["blob_cache"]["hits"] == 1
    elif rung in ("registry", "url"):
        assert load["network_bytes"] == load["bytes"]
        assert summary["blob_cache"]["admitted"] == 1


def _forward(port, tokens):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/forward",
                                 data=json.dumps({"tokens": tokens}).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.status, r.read()


def test_modelxdl_main_then_serve_equals_jax_sidecar(deployed, tmp_path, capsys, monkeypatch):
    monkeypatch.setenv("MODELX_DL_NO_LOCAL_REDIRECT", "1")
    dest = str(tmp_path / "dest")
    rc = dl_main.main([f"{deployed['local']}/library/fp32@v1", dest, "--device-put",
                       "--device", "cpu", "--blob-cache-dir", str(tmp_path / "cache")])
    assert rc == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert "arrays" not in summary["load"] and summary["load"]["tensors"] > 0
    assert summary["blob_cache"]["admitted"] == 1 and summary["pull"]["downloaded"] == 2
    # a second deploy: the puller's hash-skip downloads nothing, the cache serves
    assert dl_main.main([f"{deployed['local']}/library/fp32@v1", dest, "--device-put",
                         "--device", "cpu", "--blob-cache-dir", str(tmp_path / "cache")]) == 0
    warm = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert warm["pull"] == {"downloaded": 0, "downloaded_bytes": 0, "up_to_date": 2}
    assert warm["load"]["network_bytes"] == 0 and warm["blob_cache"]["hits"] == 1

    jserver = JaxModelServer(dest, mesh_spec="dp=1", dtype="float32")
    jserver.load()
    jhttpd = jax_serve(jserver, listen=f"127.0.0.1:{free_port()}")
    sset, thttpd = serve_main.start(["--model", f"m={dest}", "--device", "cpu",
                                     "--dtype", "float32",
                                     "--listen", f"127.0.0.1:{free_port()}"])
    try:
        tokens = np.random.RandomState(7).randint(0, 512, (2, 9)).tolist()
        want = _forward(jhttpd.server_address[1], tokens)
        got = _forward(thttpd.server_address[1], tokens)
        assert got == want and got[0] == 200
    finally:
        for h in (jhttpd, thttpd):
            h.shutdown()
            h.server_close()


def test_modelxdl_device_put_raises_without_a_card(deployed, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: cuda is the default device there")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dl_main.main([f"{deployed['local']}/library/fp32@v1", str(tmp_path / "d"),
                      "--device-put"])
    assert not os.path.exists(str(tmp_path / "d"))  # raised before any byte moved
    # a pull alone needs no device
    assert dl_main.main([f"{deployed['local']}/library/fp32@v1", str(tmp_path / "d")]) == 0


def test_modelxdl_reports_a_missing_version(deployed, tmp_path, capsys):
    assert dl_main.main([f"{deployed['local']}/library/fp32@nope", str(tmp_path / "d")]) == 1
    assert "MANIFEST_UNKNOWN" in capsys.readouterr().err


def test_a_config_outside_the_yaml_subset_pulls_everything(deployed, tmp_path):
    """ROADMAP C.4: a block scalar is outside the port's YAML reader, so
    its initializer ignores modelFiles and pulls every blob, where the JAX
    one (pyyaml) pulls only the selected weights."""
    src = deployed["root"] / "block-scalar"
    _write_checkpoint(str(src), jnp.float32)
    (src / "modelx.yaml").write_text("description: |\n  two lines\n  of text\n"
                                     "modelFiles:\n- model.safetensors\n")
    base = deployed["local"]
    JaxClient(base, quiet=True).push("library/block", "v1", str(src))
    port = run_initializer(f"{base}/library/block@v1", str(tmp_path / "port"), quiet=True)
    jax_ = jax_run_initializer(f"{base}/library/block@v1", str(tmp_path / "jax"), quiet=True)
    assert (jax_["blobs"], port["blobs"]) == (1, 2)
    assert sorted(os.listdir(tmp_path / "port")) == ["model.safetensors", "modelx.yaml",
                                                      "notes.txt"]
