"""The port's deploy-TTFT runner (modelx_tpu_torch.dl.ttft) on the CPU,
through the plain attention: from a registry the JAX client pushed, its
first token equals the last position of the port server's
``forward_argmax`` on the local checkpoint and of the JAX sidecar's
``/v1/forward`` (fp32, exact); a warm run loads every blob from the blob
cache; it prints its stage timings; without ``--device cpu`` it raises."""

import json
import os
import urllib.request

import numpy as np
import pytest
import torch

from modelx_tpu.client.client import Client as JaxClient
from modelx_tpu.dl.serve import ModelServer as JaxModelServer
from modelx_tpu.dl.serve import serve as jax_serve
from modelx_tpu.registry.server import free_port
from modelx_tpu_torch.dl import ttft
from modelx_tpu_torch.dl.serve import ModelServer
from modelx_tpu_torch.registry.fs import LocalFSProvider
from modelx_tpu_torch.registry.server import Options, RegistryServer
from modelx_tpu_torch.registry.store_fs import FSRegistryStore
from tests.test_torch_serve import _write_tiny_fp32

REPO = "library/tiny"
STAGES = {"ttft_ms", "plan_ms", "load_ms", "kernel_join_ms", "first_exec_ms",
          "kernel_thread_ms", "weights_ready_ms", "bytes_to_device", "warm_blobs",
          "first_token", "flash_launches"}


@pytest.fixture(scope="module")
def pushed(tmp_path_factory):
    src = str(tmp_path_factory.mktemp("ttft-model"))
    _write_tiny_fp32(src)
    store = FSRegistryStore(LocalFSProvider(str(tmp_path_factory.mktemp("ttft-registry"))),
                            local_redirect=True)
    srv = RegistryServer(Options(listen=f"127.0.0.1:{free_port()}"), store=store)
    base = srv.serve_background()
    JaxClient(base, quiet=True).push(REPO, "v1", src)
    yield base, src
    srv.shutdown()


def test_first_token_equals_both_sidecars(pushed, tmp_path, monkeypatch):
    base, src = pushed
    monkeypatch.setenv("MODELX_DL_NO_LOCAL_REDIRECT", "1")
    cache = str(tmp_path / "blob-cache")
    cold = ttft.measure_once(base, REPO, blob_cache_dir=cache, device="cpu")
    warm = ttft.measure_once(base, REPO, blob_cache_dir=cache, device="cpu")
    assert STAGES <= set(cold)
    assert cold["warm_blobs"] == 0 and warm["warm_blobs"] == warm["blobs"] == 1
    assert cold["flash_launches"] == warm["flash_launches"] == 0  # CPU: plain version
    assert cold["kernel_thread_ms"] is None  # no kernel library on the CPU

    server = ModelServer(src, dtype="float32", device="cpu")
    server.load()
    port_token = int(server.forward_argmax(np.asarray(ttft.PROMPT))[0, -1])
    jserver = JaxModelServer(src, mesh_spec="dp=1", dtype="float32")
    jserver.load()
    jhttpd = jax_serve(jserver, listen=f"127.0.0.1:{free_port()}")
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{jhttpd.server_address[1]}/v1/forward",
            data=json.dumps({"tokens": ttft.PROMPT}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            jax_token = json.loads(r.read())["logits_argmax"][0][-1]
    finally:
        jhttpd.shutdown()
        jhttpd.server_close()
    assert cold["first_token"] == warm["first_token"] == port_token == jax_token


def test_main_prints_one_json_line(pushed, capsys):
    base, _ = pushed
    assert ttft.main([base, REPO, "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip())
    assert STAGES <= set(out) and out["device"] == "cpu" and out["ttft_ms"] > 0


def test_raises_without_a_card(pushed):
    if torch.cuda.is_available():
        pytest.skip("a card is present: cuda is the default device there")
    base, _ = pushed
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttft.main([base, REPO])
