"""Port serving path (modelx_tpu_torch.dl) against the JAX package, on the CPU.

safetensors bytes and loaded tensors must be byte-equal to the JAX
package's; config inference must agree; and a JAX ModelServer and the
port's server on the same tiny fp32 checkpoint must return identical JSON
bodies for /v1/forward and /v1/generate (greedy, fp32: token-exact).
"""

import dataclasses
import json
import os
import urllib.error
import urllib.request

import ml_dtypes
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from modelx_tpu.dl import families as jfam
from modelx_tpu.dl import safetensors as jst
from modelx_tpu.dl.serve import ModelServer as JaxModelServer
from modelx_tpu.dl.serve import serve as jax_serve
from modelx_tpu.dl.sharding import infer_family as jax_infer_family
from modelx_tpu.models import llama as jl
from modelx_tpu.registry.server import free_port
from modelx_tpu_torch.dl import families as tfam
from modelx_tpu_torch.dl import safetensors as tst
from modelx_tpu_torch.dl import serve_main
from modelx_tpu_torch.dl.loader import LocalFileSource, load_safetensors
from modelx_tpu_torch.dl.serve import ModelServer
from modelx_tpu_torch.dl.sharding import infer_family
from modelx_tpu_torch.dl.weights import from_jax_params, to_tensor


def _mixed_arrays():
    rng = np.random.RandomState(0)
    return {
        "f32": rng.randn(3, 5).astype(np.float32),
        "bf16": rng.randn(4, 6).astype(ml_dtypes.bfloat16),
        "f8": rng.randn(7).astype(ml_dtypes.float8_e4m3fn),
        "i32": rng.randint(-9, 9, (2, 2)).astype(np.int32),
        "u8": rng.randint(0, 255, (9,)).astype(np.uint8),
        "scalar": np.asarray(1.5, np.float16),
    }


def _bytes(x) -> bytes:
    if isinstance(x, torch.Tensor):
        return x.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()
    return np.ascontiguousarray(x).tobytes()


def test_write_safetensors_is_byte_identical_to_jax(tmp_path):
    arrays = _mixed_arrays()
    jst.write_safetensors(str(tmp_path / "j.safetensors"), arrays, {"k": "v"})
    tst.write_safetensors(str(tmp_path / "t.safetensors"), arrays, {"k": "v"})
    # torch tensors of the same values write the same bytes too
    tst.write_safetensors(str(tmp_path / "tt.safetensors"),
                          {k: to_tensor(v) for k, v in arrays.items()}, {"k": "v"})
    ref = (tmp_path / "j.safetensors").read_bytes()
    assert (tmp_path / "t.safetensors").read_bytes() == ref
    assert (tmp_path / "tt.safetensors").read_bytes() == ref


def test_read_tensors_and_loader_byte_equal_to_jax(tmp_path):
    path = str(tmp_path / "m.safetensors")
    jst.write_safetensors(path, _mixed_arrays())
    want = jst.read_tensors(path)
    got = tst.read_tensors(path)
    src = LocalFileSource(path)
    try:
        loaded, stats = load_safetensors(src, "cpu")
    finally:
        src.close()
    assert sorted(got) == sorted(loaded) == sorted(want)
    for name, arr in want.items():
        assert tuple(got[name].shape) == arr.shape == tuple(loaded[name].shape)
        assert _bytes(got[name]) == _bytes(arr) == _bytes(loaded[name]), name
    assert got["bf16"].dtype == torch.bfloat16 and got["f8"].dtype == torch.float8_e4m3fn
    assert stats.tensors == len(want)
    assert stats.bytes_to_device == sum(a.nbytes for a in want.values())
    assert stats.gbps > 0


def test_loader_dtype_casts_floats_only(tmp_path):
    path = str(tmp_path / "m.safetensors")
    jst.write_safetensors(path, _mixed_arrays())
    src = LocalFileSource(path)
    try:
        loaded, _ = load_safetensors(src, "cpu", dtype=torch.float32)
    finally:
        src.close()
    assert loaded["bf16"].dtype == torch.float32 and loaded["i32"].dtype == torch.int32
    np.testing.assert_array_equal(loaded["bf16"].numpy(),
                                  _mixed_arrays()["bf16"].astype(np.float32))


def test_from_jax_params_bf16_bit_exact():
    params = jl.init_params(jl.LlamaConfig.tiny(), jax.random.PRNGKey(0))  # bf16
    np_params = {k: np.asarray(v) for k, v in params.items()}
    port = from_jax_params(np_params, device="cpu")
    for name, arr in np_params.items():
        assert port[name].dtype == torch.bfloat16
        assert _bytes(port[name]) == arr.tobytes(), name


@pytest.mark.parametrize("names", [
    ["model.layers.0.self_attn.q_proj.weight", "model.layers.0.mlp.gate_proj.weight"],
    ["model.layers.0.self_attn.q_proj.bias", "model.layers.0.self_attn.q_proj.weight"],
    ["model.layers.0.pre_feedforward_layernorm.weight"],
    ["model.layers.0.pre_feedforward_layernorm.weight", "model.layers.0.self_attn.q_norm.weight"],
    ["model.layers.0.block_sparse_moe.gate.weight"],
    ["model.layers.0.self_attn.qkv_proj.weight"],
    ["transformer.wte.weight"],
    ["embeddings.word_embeddings.weight"],
    ["mystery.weight"],
])
def test_infer_family_matches_jax(names):
    assert infer_family(names) == jax_infer_family(names)


def test_detect_refuses_later_slice_families_and_unknowns():
    assert tfam.detect(["model.layers.0.self_attn.q_proj.weight"]).name == "llama"
    assert tfam.detect(["model.layers.0.self_attn.q_proj.bias"]).name == "qwen2"
    with pytest.raises(NotImplementedError, match="not yet ported"):
        tfam.detect(["model.layers.0.block_sparse_moe.gate.weight"])
    with pytest.raises(ValueError, match="cannot determine"):
        tfam.detect(["mystery.weight"])
    with pytest.raises(ValueError, match="cannot determine"):  # the gemma3 refusal
        tfam.detect(["x.pre_feedforward_layernorm.weight", "x.q_norm.weight"])


def _abstract(jcfg):
    shapes = jl.param_shapes(jcfg)
    jax_abs = {n: jax.ShapeDtypeStruct(s, jnp.bfloat16) for n, s in shapes.items()}
    port_abs = {n: torch.empty(s, dtype=torch.bfloat16, device="meta") for n, s in shapes.items()}
    return jax_abs, port_abs


_CHECK_FIELDS = ("vocab_size", "hidden_size", "intermediate_size", "num_layers", "num_heads",
                 "num_kv_heads", "head_dim", "rope_theta", "rms_eps", "tie_embeddings",
                 "qkv_bias")


@pytest.mark.parametrize("jcfg", [
    jl.LlamaConfig.tiny(),
    dataclasses.replace(jl.LlamaConfig.tiny(), qkv_bias=True, tie_embeddings=True),
    dataclasses.replace(jl.LlamaConfig.llama3_8b(), num_layers=2),
    dataclasses.replace(jl.LlamaConfig(), hidden_size=896, num_heads=14, num_kv_heads=2,
                        head_dim=64, intermediate_size=4864, num_layers=1),
], ids=["tiny", "tiny-qwen2", "llama3-8b-2layer", "qwen2-0.5b-1layer"])
def test_infer_config_matches_jax(jcfg):
    jax_abs, port_abs = _abstract(jcfg)
    fam_name = "qwen2" if jcfg.qkv_bias else "llama"
    jc = jfam.FAMILIES[fam_name].infer_config(jax_abs)
    tc = tfam.FAMILIES[fam_name].infer_config(port_abs)
    assert {f: getattr(tc, f) for f in _CHECK_FIELDS} == {f: getattr(jc, f) for f in _CHECK_FIELDS}
    assert tc.dtype == torch.bfloat16


@pytest.mark.parametrize("sidecar", [
    {"rope_theta": 10000},
    {"rope_theta": "oops"},
    {"rope_scaling": {"type": "llama3", "factor": 8.0}},
    {"rope_scaling": {"rope_type": "longrope"}},
    {"rope_scaling": {"type": "yarn"}},
    {"rope_scaling": "su"},
    {"rope_scaling": {"factor": 2.0}},
])
def test_apply_sidecar_config_matches_jax(sidecar):
    jax_abs, port_abs = _abstract(jl.LlamaConfig.tiny())
    jc = jfam.infer_llama_config(jax_abs)
    tc = tfam.infer_llama_config(port_abs)
    try:
        jout = jfam.apply_sidecar_config(jc, sidecar, "llama")
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tfam.apply_sidecar_config(tc, sidecar, "llama")
        assert str(got.value) == str(e)
        return
    assert tfam.apply_sidecar_config(tc, sidecar, "llama").rope_theta == jout.rope_theta


# -- HTTP: the JAX sidecar and the port answer the same bytes -------------------


def _write_tiny_fp32(dirpath):
    """tests/test_lifecycle.py's write_tiny, in fp32 and with llama-3's
    rope_theta (the value config inference assumes)."""
    cfg = dataclasses.replace(jl.LlamaConfig.tiny(), rope_theta=500000.0, dtype=jnp.float32)
    params = jl.init_params(cfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    os.makedirs(dirpath, exist_ok=True)
    jst.write_safetensors(os.path.join(dirpath, "model.safetensors"),
                          {k: np.asarray(v) for k, v in params.items()})
    return cfg


@pytest.fixture(scope="module")
def pods(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("tiny-fp32"))
    _write_tiny_fp32(d)
    jserver = JaxModelServer(d, mesh_spec="dp=1", dtype="float32")
    jserver.load()
    jhttpd = jax_serve(jserver, listen=f"127.0.0.1:{free_port()}")
    sset, thttpd = serve_main.start([
        "--model", f"default={d}", "--device", "cpu", "--dtype", "float32",
        "--listen", f"127.0.0.1:{free_port()}"])
    yield jhttpd.server_address[1], thttpd.server_address[1], sset
    for h in (jhttpd, thttpd):
        h.shutdown()
        h.server_close()


def _call(port, path, body=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


_TOKS = np.random.RandomState(3).randint(0, 512, (2, 12)).tolist()

PARITY_REQUESTS = [
    ("/v1/forward", {"tokens": _TOKS}),
    ("/v1/default/forward", {"tokens": _TOKS[:1]}),
    ("/v1/generate", {"tokens": _TOKS, "max_new_tokens": 6}),
    ("/v1/default/generate", {"tokens": _TOKS[1:], "max_new_tokens": 4}),
    ("/v1/generate", {"tokens": _TOKS[:1], "max_new_tokens": 6, "stop_token_ids": [138, 396]}),
    ("/v1/generate", {"tokens": [[1, 999]]}),
    ("/v1/forward", {"tokens": [1, 2]}),
    ("/v1/forward", {"tokens": [[]]}),
    ("/v1/forward", {"toks": [[1]]}),
    ("/v1/generate", {"tokens": _TOKS, "max_new_tokens": 0}),
    ("/v1/generate", {"tokens": _TOKS, "max_new_tokens": "x"}),
    ("/v1/generate", {"tokens": _TOKS, "temperature": -1}),
    ("/v1/generate", {"tokens": _TOKS, "stop_token_ids": [1, 9999]}),
    ("/v1/generate", {"tokens": _TOKS, "text": "hi"}),
    ("/v1/forward", {"text": "hi"}),
    ("/v1/nomodel/forward", {"tokens": _TOKS}),
    ("/v1/forward", [1, 2]),
]


@pytest.mark.parametrize("path,body", PARITY_REQUESTS,
                         ids=[f"{i}{p}" for i, (p, _) in enumerate(PARITY_REQUESTS)])
def test_http_json_identical_to_jax_sidecar(pods, path, body):
    jport, tport, _ = pods
    jstatus, jbody = _call(jport, path, body)
    tstatus, tbody = _call(tport, path, body)
    assert tstatus == jstatus
    assert tbody == jbody


@pytest.mark.parametrize("body", [
    {"tokens": _TOKS, "temperature": 0.7},
    {"tokens": _TOKS, "stream": True},
    {"text": "hello"},
], ids=["sampling", "stream", "text"])
def test_later_slice_requests_answer_typed_501(pods, body):
    _, tport, _ = pods
    status, raw = _call(tport, "/v1/generate", body)
    assert status == 501
    payload = json.loads(raw)
    assert payload["type"] == "not_ported" and payload["slice"] in payload["error"]


def test_health_models_and_admin(pods):
    _, tport, sset = pods
    assert _call(tport, "/healthz") == (200, b'{"status": "ok"}')
    status, raw = _call(tport, "/v1/models")
    models = json.loads(raw)
    assert status == 200 and models["default"] == "default"
    stats = models["models"]["default"]
    assert stats["ready"] and stats["family"] == "llama" and stats["device"] == "cpu"
    assert stats["load_bytes"] > 0
    assert _call(tport, "/admin/models")[0] == 501
    assert _call(tport, "/nope")[0] == 404
    assert sset.servers["default"].cfg.dtype == torch.float32


def test_generate_ragged_matches_jax(pods, tmp_path):
    _write_tiny_fp32(str(tmp_path))
    js = JaxModelServer(str(tmp_path), mesh_spec="dp=1", dtype="float32")
    js.load()
    ts = ModelServer(str(tmp_path), dtype="float32", device="cpu")
    ts.load()
    tok = np.asarray(_TOKS, np.int32)
    lens = np.array([12, 7], np.int32)
    np.testing.assert_array_equal(ts.generate_ragged(tok, lens, 5),
                                  js.generate_ragged(tok, lens, 5))


def test_server_refuses_longrope_checkpoint(tmp_path):
    _write_tiny_fp32(str(tmp_path))
    (tmp_path / "config.json").write_text(json.dumps({"rope_scaling": {"type": "longrope"}}))
    with pytest.raises(ValueError, match="rope_scaling"):
        ModelServer(str(tmp_path), dtype="float32", device="cpu").load()


def test_failed_model_degrades_while_the_other_serves(tmp_path):
    good, bad = tmp_path / "good", tmp_path / "bad"
    _write_tiny_fp32(str(good))
    bad.mkdir()
    tst.write_safetensors(str(bad / "model.safetensors"),
                          {"mystery.weight": np.zeros((4, 4), np.float32)})
    sset, httpd = serve_main.start([
        "--model", f"good={good}", "--model", f"bad={bad}", "--device", "cpu",
        "--dtype", "float32", "--listen", f"127.0.0.1:{free_port()}"])
    port = httpd.server_address[1]
    try:
        status, raw = _call(port, "/healthz")
        assert status == 200 and json.loads(raw)["status"] == "degraded"
        status, raw = _call(port, "/v1/bad/forward", {"tokens": [[1, 2]]})
        assert status == 503 and "cannot determine model family" in json.loads(raw)["error"]
        assert _call(port, "/v1/forward", {"tokens": [[1, 2]]})[0] == 200
        assert "error" in json.loads(_call(port, "/v1/models")[1])["models"]["bad"]
    finally:
        httpd.shutdown()
        httpd.server_close()


def test_serve_main_rejects_bad_model_specs():
    for argv in (["--model", "nodir"], ["--model", "a=x", "--model", "a=y"], []):
        with pytest.raises(SystemExit):
            serve_main.start(argv + ["--device", "cpu"])
