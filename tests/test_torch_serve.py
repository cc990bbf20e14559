"""Port serving path (modelx_tpu_torch.dl) against the JAX package, on the CPU.

safetensors bytes and loaded tensors must be byte-equal to the JAX
package's; config inference must agree; and a JAX ModelServer and the
port's server on the same tiny fp32 checkpoint must return identical bodies
for /v1/forward and /v1/generate: JSON for greedy and seeded sampled
requests, NDJSON for streams, the same status and error for refused ones
(text on a model without tokenizer.json among them), and the same 504
status, headers and body for an expired X-ModelX-Deadline-Ms (fp32,
token-exact: the port draws jax.random's bits, so a seeded row samples the
same tokens). The text surface itself is tests/test_torch_openai.py's.
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
    # both at --max-seq-len 32: the plain path serves longer requests
    jserver = JaxModelServer(d, mesh_spec="dp=1", dtype="float32", max_seq_len=32)
    jserver.load()
    jhttpd = jax_serve(jserver, listen=f"127.0.0.1:{free_port()}")
    wp = str(tmp_path_factory.mktemp("tiny-wordpiece"))
    os.symlink(os.path.join(d, "model.safetensors"), os.path.join(wp, "model.safetensors"))
    with open(os.path.join(wp, "tokenizer.json"), "w") as f:
        json.dump({"version": "1.0", "truncation": None, "padding": None, "added_tokens": [],
                   "normalizer": None, "pre_tokenizer": {"type": "Whitespace"},
                   "post_processor": None, "decoder": None,
                   "model": {"type": "WordPiece", "unk_token": "[UNK]",
                             "continuing_subword_prefix": "##",
                             "max_input_chars_per_word": 100,
                             "vocab": {"[UNK]": 0, "hello": 1}}}, f)
    sset, thttpd = serve_main.start([
        "--model", f"default={d}", "--model", f"wordpiece={wp}", "--device", "cpu",
        "--dtype", "float32", "--max-seq-len", "32", "--listen", f"127.0.0.1:{free_port()}"])
    yield jhttpd.server_address[1], thttpd.server_address[1], sset
    for h in (jhttpd, thttpd):
        h.shutdown()
        h.server_close()


def _call(port, path, body=None, headers=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


_TOKS = np.random.RandomState(3).randint(0, 512, (2, 12)).tolist()
_LONG = np.random.RandomState(4).randint(0, 512, (1, 40))

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
    # sampled, per-row seeds; top_k/top_p inside K_CAP, and a near-flat
    # top_p 0.99 nucleus that overflows it (the full-sort branch)
    ("/v1/generate", {"tokens": _TOKS, "max_new_tokens": 6, "temperature": 0.8,
                      "top_k": 40, "top_p": 0.95, "seed": 7}),
    ("/v1/generate", {"tokens": _TOKS[:1], "max_new_tokens": 5, "temperature": 1.3,
                      "top_p": 0.99, "seed": 3}),
    ("/v1/generate", {"tokens": _TOKS[1:], "max_new_tokens": 4, "temperature": 0.5}),
    # streams: one token per line on one row, one line per chunk on two
    ("/v1/generate", {"tokens": _TOKS[:1], "max_new_tokens": 11, "temperature": 0.8,
                      "top_k": 40, "top_p": 0.95, "seed": 7, "stream": True}),
    ("/v1/generate", {"tokens": _TOKS[:1], "max_new_tokens": 9, "stream": True,
                      "stop_token_ids": [138, 396]}),
    ("/v1/generate", {"tokens": _TOKS, "max_new_tokens": 10, "temperature": 0.9,
                      "seed": 1, "stream": True}),
    ("/v1/generate", {"tokens": _TOKS, "stream": True, "stop_token_ids": [1]}),
    # resume: refused as the JAX sidecar without the continuous engine does
    ("/v1/generate", {"tokens": _TOKS[:1], "max_new_tokens": 6, "stream": True,
                      "resume": {"emitted": [5, 6], "seed": 7}}),
    ("/v1/generate", {"tokens": _TOKS[:1], "max_new_tokens": 6,
                      "resume": {"emitted": [5], "seed": 7}}),
    ("/v1/generate", {"tokens": _TOKS[:1], "max_new_tokens": 2, "stream": True,
                      "resume": {"emitted": [5, 6], "seed": 7}}),
    ("/v1/generate", {"tokens": _TOKS[:1], "stream": True, "resume": {"emitted": [5]}}),
    ("/v1/generate", {"tokens": _TOKS[:1], "stream": True, "resume": [5]}),
    # text on a model without tokenizer.json, and malformed text
    ("/v1/generate", {"text": "hello", "max_new_tokens": 3}),
    ("/v1/generate", {"text": ""}),
    ("/v1/generate", {"text": 5}),
    ("/v1/generate", {"text": "hello", "stream": True}),
    ("/v1/completions", {"prompt": "hello", "seed": 1}),
    # longer than --max-seq-len 32: served, as the JAX sidecar's plain path does
    ("/v1/forward", {"tokens": _LONG[:, :40].tolist()}),
    ("/v1/generate", {"tokens": _LONG[:, :28].tolist(), "max_new_tokens": 8}),
    ("/v1/generate", {"tokens": _LONG[:, :28].tolist(), "max_new_tokens": 8, "stream": True}),
]


@pytest.mark.parametrize("path,body", PARITY_REQUESTS,
                         ids=[f"{i}{p}" for i, (p, _) in enumerate(PARITY_REQUESTS)])
def test_http_json_identical_to_jax_sidecar(pods, path, body):
    jport, tport, _ = pods
    jstatus, jbody = _call(jport, path, body)
    tstatus, tbody = _call(tport, path, body)
    assert tstatus == jstatus
    assert tbody == jbody


@pytest.mark.parametrize("path,body,slice_name", [
    ("/v1/generate", {"tokens": _TOKS[:1], "stream": True, "include_timing": True},
     "observability"),
    # a tokenizer.json component the reader does not implement (WordPiece,
    # the bert family's) refuses text on both surfaces
    ("/v1/completions", {"model": "wordpiece", "prompt": "hello", "seed": 0}, "other families"),
    ("/v1/wordpiece/generate", {"text": "hello"}, "other families"),
], ids=["include_timing", "openai", "text"])
def test_later_slice_requests_answer_typed_501(pods, path, body, slice_name):
    _, tport, _ = pods
    status, raw = _call(tport, path, body)
    assert status == 501
    payload = json.loads(raw)
    if isinstance(payload["error"], dict):  # the OpenAI error shape
        payload = {"error": payload["error"]["message"], "type": payload["error"]["type"],
                   "slice": slice_name}
    assert payload["type"] == "not_ported" and payload["slice"] == slice_name
    assert slice_name in payload["error"]
    if body.get("include_timing") is None:
        assert "model WordPiece" in payload["error"]


@pytest.mark.parametrize("headers", [
    {"X-ModelX-Resume-Emitted": "5,6", "X-ModelX-Resume-Seed": "7"},
    {"X-ModelX-Resume-Emitted": "5,x", "X-ModelX-Resume-Seed": "7"},
    {"X-ModelX-Resume-Seed": "7"},
], ids=["valid", "bad-token", "seed-only"])
def test_resume_headers_answer_as_jax(pods, headers):
    jport, tport, _ = pods
    body = {"tokens": _TOKS[:1], "max_new_tokens": 6, "stream": True,
            "resume": {"emitted": [1], "seed": 2}}  # the headers win
    assert _call(tport, "/v1/generate", body, headers) == _call(jport, "/v1/generate", body,
                                                                headers)


def _call_full(port, path, body, headers):
    """(status, headers, body); the headers without Date and the JAX
    sidecar's request-id, attempt and timing echo (the observability
    slice, not ported)."""
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json", **headers})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            status, hdrs, raw = r.status, r.headers, r.read()
    except urllib.error.HTTPError as e:
        status, hdrs, raw = e.code, e.headers, e.read()
    keep = {k: v for k, v in hdrs.items()
            if k != "Date" and not k.startswith(("X-ModelX-Request-Id", "X-ModelX-Attempt",
                                                  "X-ModelX-Timing-"))}
    return status, keep, raw


@pytest.mark.parametrize("path,body", [
    ("/v1/forward", {"tokens": _TOKS}),
    ("/v1/generate", {"tokens": _TOKS, "max_new_tokens": 4}),
    ("/v1/generate", {"tokens": _TOKS[:1], "max_new_tokens": 4, "stream": True}),
    ("/v1/generate", {"text": "hello"}),
    ("/v1/completions", {"prompt": "hello"}),
    ("/v1/chat/completions", {"messages": [{"role": "user", "content": "hi"}],
                              "stream": True}),
], ids=["forward", "generate", "stream", "text", "completions", "chat-stream"])
@pytest.mark.parametrize("deadline", ["0", "-30"])
def test_expired_deadline_answers_the_jax_504(pods, path, body, deadline):
    jport, tport, _ = pods
    headers = {"X-ModelX-Deadline-Ms": deadline, "X-ModelX-Priority": "batch"}
    want = _call_full(jport, path, body, headers)
    assert want[0] == 504
    assert _call_full(tport, path, body, headers) == want


@pytest.mark.parametrize("deadline", ["60000", "soon", "inf"])
def test_live_or_malformed_deadline_serves_as_jax(pods, deadline):
    jport, tport, _ = pods
    body = {"tokens": _TOKS, "max_new_tokens": 3}
    headers = {"X-ModelX-Deadline-Ms": deadline}
    want = _call_full(jport, "/v1/generate", body, headers)
    assert want[0] == 200
    assert _call_full(tport, "/v1/generate", body, headers) == want


def _ndjson_tokens(raw: bytes) -> list[int]:
    lines = [json.loads(x) for x in raw.splitlines()]
    assert lines[-1] == {"done": True}
    return [t for line in lines[:-1] for t in line["tokens"][0]]


def test_prefix_cache_hit_streams_the_cold_tokens(pods):
    _, tport, sset = pods
    model_dir = sset.servers["default"].model_dir
    cached, httpd = serve_main.start([
        "--model", f"default={model_dir}", "--device", "cpu", "--dtype", "float32",
        "--listen", f"127.0.0.1:{free_port()}", "--prefix-cache", "2",
        "--stream-chunk-size", "3"])
    port = httpd.server_address[1]
    try:
        samp = {"max_new_tokens": 7, "temperature": 0.8, "top_k": 40, "seed": 5,
                "stream": True}
        turn1 = _TOKS[0][:9]
        status, raw = _call(port, "/v1/generate", {"tokens": [turn1], **samp})
        assert status == 200
        turn2 = turn1 + _ndjson_tokens(raw) + [9]
        status, raw = _call(port, "/v1/generate", {"tokens": [turn2], **samp})
        stats = json.loads(_call(port, "/v1/models")[1])["models"]["default"]["prefix_cache"]
        assert status == 200 and stats["hits"] == 1 and stats["entries"] == 2
        # the pod without a prefix cache, streamed and not
        assert raw == _call(tport, "/v1/generate", {"tokens": [turn2], **samp})[1]
        body = {k: v for k, v in samp.items() if k != "stream"}
        plain = json.loads(_call(tport, "/v1/generate", {"tokens": [turn2], **body})[1])
        assert _ndjson_tokens(raw) == plain["tokens"][0][len(turn2):]
    finally:
        httpd.shutdown()
        httpd.server_close()


def test_stream_holds_the_device_lock_one_chunk_at_a_time(pods):
    _, _, sset = pods
    server = sset.servers["default"]
    gen = server.generate_stream(np.asarray(_TOKS[:1], np.int32), max_new_tokens=9,
                                 chunk_size=4)
    first = next(gen)
    assert first.shape == (1, 4)
    # suspended between chunks: the device is free for other requests
    assert not server._device_lock.locked()
    assert server.forward_argmax(np.asarray(_TOKS[:1], np.int32)).shape == (1, 12)
    rest = list(gen)
    assert [p.shape[1] for p in rest] == [4, 1]
    gen2 = server.generate_stream(np.asarray(_TOKS[:1], np.int32), max_new_tokens=9,
                                  chunk_size=4)
    next(gen2)
    gen2.close()  # a client that went away
    assert not server._device_lock.locked()
    want = server.generate(np.asarray(_TOKS[:1], np.int32), max_new_tokens=9)[0, 12:]
    np.testing.assert_array_equal(np.concatenate([first] + rest, axis=1)[0], want)


def test_health_models_and_admin(pods):
    _, tport, sset = pods
    status, raw = _call(tport, "/healthz")
    assert status == 200 and json.loads(raw)["status"] == "ok"
    assert json.loads(raw)["control_plane"]["state"] in ("ok", "degraded", "offline")
    status, raw = _call(tport, "/v1/models")
    models = json.loads(raw)
    assert status == 200 and models["default"] == "default"
    stats = models["models"]["default"]
    assert stats["ready"] and stats["family"] == "llama" and stats["device"] == "cpu"
    assert stats["load_bytes"] > 0
    # the admin surface answers (the model pool); /admin/profile waits for
    # the observability slice
    status, raw = _call(tport, "/admin/models")
    admin = json.loads(raw)
    assert status == 200 and admin["models"]["default"]["state"] == "READY"
    assert set(admin) == {"models", "pool", "serving", "control_plane"}
    status, raw = _call(tport, "/admin/profile", {"duration_s": 1})
    assert status == 501 and json.loads(raw)["slice"] == "observability"
    assert _call(tport, "/livez") == (200, b'{"status": "ok"}')
    assert _call(tport, "/nope")[0] == 404
    assert sset.servers["default"].cfg.dtype == torch.float32


@pytest.mark.parametrize("events", [(), ("ok",), ("failure",), ("ok", "failure", "ok"),
                                    ("offline_serve",), ("mirror_ok",)],
                         ids=["fresh", "ok", "offline", "degraded", "offline-serve", "mirror"])
def test_healthz_control_plane_identical_to_jax(pods, events):
    """The same control-plane events on both pods' trackers (a frozen
    clock) give byte-identical /healthz bodies."""
    from modelx_tpu.dl import manifest_cache as jmc
    from modelx_tpu_torch.dl import manifest_cache as tmc

    jport, tport, _ = pods
    trackers = [jmc.health(), tmc.health()]
    clocks = [h._clock for h in trackers]
    try:
        for h in trackers:
            h._clock = lambda: 1000.0
            h.reset()
            for event in events:
                if event == "mirror_ok":
                    h.note_ok(mirror=True)
                else:
                    getattr(h, f"note_{event}")()
        want = _call(jport, "/healthz")
        assert _call(tport, "/healthz") == want and want[0] == 200
    finally:
        for h, clock in zip(trackers, clocks):
            h._clock = clock
            h.reset()


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


# -- the serving options: --dynamic-batch over HTTP, and the new flags ---------


@pytest.fixture(scope="module")
def batched_pods(pods):
    """A JAX ServerSet(dynamic_batch=True) pod and the port's
    ``--dynamic-batch`` pod on the same tiny fp32 checkpoint."""
    from modelx_tpu.dl.serve import ServerSet as JaxServerSet

    model_dir = pods[2].servers["default"].model_dir
    jserver = JaxModelServer(model_dir, mesh_spec="dp=1", dtype="float32")
    jserver.load()
    jsset = JaxServerSet({"default": jserver}, dynamic_batch=True, batch_window_ms=30.0)
    jhttpd = jax_serve(jsset, listen=f"127.0.0.1:{free_port()}")
    tsset, thttpd = serve_main.start([
        "--model", f"default={model_dir}", "--device", "cpu", "--dtype", "float32",
        "--listen", f"127.0.0.1:{free_port()}", "--dynamic-batch", "--batch-window-ms", "30"])
    yield jhttpd.server_address[1], thttpd.server_address[1], tsset
    for h in (jhttpd, thttpd):
        h.shutdown()
        h.server_close()
    tsset.close()
    for b in jsset.batchers.values():
        b.close()


BATCHED_REQUESTS = [
    ("/v1/forward", {"tokens": _TOKS}),
    ("/v1/default/forward", {"tokens": [_TOKS[0][:5]]}),
    ("/v1/generate", {"tokens": _TOKS, "max_new_tokens": 6}),
    ("/v1/generate", {"tokens": _TOKS[:1], "max_new_tokens": 6, "stop_token_ids": [138, 396]}),
    ("/v1/generate", {"tokens": _TOKS, "max_new_tokens": 6, "temperature": 0.8,
                      "top_k": 40, "top_p": 0.95, "seed": 7}),
    ("/v1/generate", {"tokens": _TOKS[1:], "max_new_tokens": 4, "temperature": 0.5}),
    ("/v1/forward", {"tokens": [[]]}),
    ("/v1/generate", {"tokens": [[1, 999]]}),
]


@pytest.mark.parametrize("path,body", BATCHED_REQUESTS,
                         ids=[f"{i}{p}" for i, (p, _) in enumerate(BATCHED_REQUESTS)])
def test_batched_sidecar_json_identical_to_jax(batched_pods, path, body):
    jport, tport, _ = batched_pods
    want = _call(jport, path, body)
    assert _call(tport, path, body) == want


def test_concurrent_batched_requests_identical_to_jax(batched_pods):
    """Requests sent at once coalesce (fewer device calls than requests) and
    each answers the JAX pod's bytes."""
    from concurrent.futures import ThreadPoolExecutor

    jport, tport, tsset = batched_pods
    reqs = BATCHED_REQUESTS[:6]
    with ThreadPoolExecutor(len(reqs)) as pool:
        want = list(pool.map(lambda r: _call(jport, *r), reqs))
    batches = tsset.batchers["default"].batches if tsset.batchers else 0
    with ThreadPoolExecutor(len(reqs)) as pool:
        got = list(pool.map(lambda r: _call(tport, *r), reqs))
    assert got == want and all(status == 200 for status, _ in got)
    assert tsset.batchers["default"].batches - batches < len(reqs)
    models = json.loads(_call(tport, "/v1/models")[1])["models"]["default"]
    assert models["batches"] == tsset.batchers["default"].batches


def test_serve_main_parses_the_option_flags():
    args = serve_main.build_parser().parse_args(["--model", "m=/x"])
    assert (args.dynamic_batch, args.max_batch, args.batch_window_ms, args.quantize,
            args.speculative_k, args.loras) == (False, 32, 3.0, None, 0, [])
    args = serve_main.build_parser().parse_args([
        "--model", "m=/x", "--dynamic-batch", "--max-batch", "8", "--batch-window-ms", "1.5",
        "--quantize", "int8", "--speculative-k", "6", "--lora", "m=/a", "--lora", "n=/b"])
    assert (args.dynamic_batch, args.max_batch, args.batch_window_ms, args.quantize,
            args.speculative_k, args.loras) == (True, 8, 1.5, "int8", 6, ["m=/a", "n=/b"])


@pytest.mark.parametrize("argv", [
    ["--model", "a=/x", "--lora", "a"],
    ["--model", "a=/x", "--lora", "b=/y"],
    ["--model", "a=/x", "--lora", "a=/y", "--quantize", "int8"],
], ids=["no-dir", "no-model", "with-quantize"])
def test_serve_main_option_usage_errors_equal_jax(argv, capsys):
    from click.testing import CliRunner

    from modelx_tpu.dl import serve_main as jax_serve_main

    ran = CliRunner().invoke(jax_serve_main.main, argv + ["--no-compile-cache"])
    assert ran.exit_code == 2
    want = ran.output.strip().splitlines()[-1].removeprefix("Error: ")
    with pytest.raises(SystemExit) as exc:
        serve_main.start(argv + ["--device", "cpu"])
    assert exc.value.code == 2
    assert capsys.readouterr().err.strip().splitlines()[-1].split("error: ", 1)[1] == want


def test_serve_main_registry_flags_set_the_process_defaults(tmp_path, monkeypatch):
    """--registry-mirror (repeatable, comma lists), --blob-cache-dir,
    --blob-cache-max-bytes and --manifest-cache-dir configure the
    process-wide registry defaults, as the JAX sidecar's flags do."""
    from modelx_tpu_torch.client import remote
    from modelx_tpu_torch.dl import blob_cache, manifest_cache

    monkeypatch.setattr(remote, "_MIRRORS", [])
    monkeypatch.setattr(blob_cache, "_default", None)
    monkeypatch.setattr(blob_cache, "_default_set", False)
    monkeypatch.setattr(manifest_cache, "_default", None)
    monkeypatch.setattr(manifest_cache, "_default_configured", False)
    args = serve_main.build_parser().parse_args([
        "--model", "m=/x", "--registry-mirror", "http://a:1/, http://b:2",
        "--registry-mirror", "http://c:3", "--blob-cache-dir", str(tmp_path / "bc"),
        "--blob-cache-max-bytes", "4096", "--manifest-cache-dir", str(tmp_path / "mc")])
    serve_main.configure_registry(args)
    assert remote.default_mirrors() == ["http://a:1", "http://b:2", "http://c:3"]
    assert remote.RegistryClient("http://p:9").endpoints == [
        "http://p:9", "http://a:1", "http://b:2", "http://c:3"]
    cache = blob_cache.default_cache()
    assert cache.root == str(tmp_path / "bc") and cache.max_bytes == 4096
    assert manifest_cache.default_cache().root == str(tmp_path / "mc")
