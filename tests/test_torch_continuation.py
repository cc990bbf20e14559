"""The port's HTTP surface with the continuous engine on, against the JAX
package's, on the CPU: a JAX ``ServerSet(continuous_batch=True)`` pod and
``modelx-serve-torch --continuous-batch`` serve one tiny fp32 model (with a
word-level tokenizer.json), and every body must be byte-identical: greedy,
sampled, multi-row and stop-token ``/v1/generate`` JSON, NDJSON streams,
``resume`` on native streams (the field and the ``X-ModelX-Resume-*``
headers) and on chat SSE (``id``/``created`` masked), the resume refusals,
and the engine's state on ``/healthz``, ``/livez`` and ``/admin/models``.
A resumed stream concatenates to the uninterrupted one; ``include_timing``
adds the same timing line (values are clocks, so its keys are compared).
"""

import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from modelx_tpu.dl import safetensors as jst
from modelx_tpu.dl import serve as jserve
from modelx_tpu.models import llama as jl
from modelx_tpu.registry.server import free_port
from modelx_tpu_torch.dl import serve_main
from tests.test_torch_openai import _call, _chat, _parse, _wordlevel_json

SAMPLED = {"temperature": 0.9, "top_k": 20, "top_p": 0.95, "seed": 5}
_TOKS = np.random.RandomState(3).randint(4, 64, (2, 12)).tolist()


@pytest.fixture(scope="module")
def fronts(tmp_path_factory):
    import dataclasses

    d = tmp_path_factory.mktemp("cont-front")
    cfg = dataclasses.replace(jl.LlamaConfig.tiny(vocab_size=64), rope_theta=500000.0,
                              dtype=jnp.float32)
    jst.write_safetensors(str(d / "model.safetensors"),
                          {k: np.asarray(v) for k, v in
                           jl.init_params(cfg, jax.random.PRNGKey(0), dtype=jnp.float32).items()})
    (d / "tokenizer.json").write_text(_wordlevel_json())
    jsset = jserve.ServerSet(
        {"m": jserve.ModelServer(str(d), mesh_spec="dp=1", dtype="float32", name="m",
                                 max_seq_len=128)},
        continuous_batch=True, max_slots=4, stream_chunk_size=4)
    jhttpd = jserve.serve(jsset, listen=f"127.0.0.1:{free_port()}")
    jsset.load_all()
    tsset, thttpd = serve_main.start([
        "--model", f"m={d}", "--device", "cpu", "--dtype", "float32", "--max-seq-len", "128",
        "--continuous-batch", "--max-slots", "4", "--stream-chunk-size", "4",
        "--listen", f"127.0.0.1:{free_port()}"])
    yield jhttpd.server_address[1], thttpd.server_address[1], tsset
    for h in (jhttpd, thttpd):
        h.shutdown()
        h.server_close()
    tsset.close()
    for cb in list(jsset.cbatchers.values()):
        cb.close()


def _both(fronts, path, body, headers=None):
    jport, tport, _ = fronts
    j = _call(jport, path, body, headers)
    t = _call(tport, path, body, headers)
    assert t[:2] == j[:2], (t, j)
    return j, t


GENERATE = {
    "greedy": {"tokens": _TOKS[:1], "max_new_tokens": 9},
    "sampled": {"tokens": _TOKS[:1], "max_new_tokens": 9, **SAMPLED},
    "multirow-sampled": {"tokens": _TOKS, "max_new_tokens": 7, **SAMPLED},
    "stop": {"tokens": _TOKS, "max_new_tokens": 9, "stop_token_ids": [7, 11, 30]},
    "stream": {"tokens": _TOKS[:1], "max_new_tokens": 10, "stream": True, **SAMPLED},
    "stream-stop": {"tokens": _TOKS[:1], "max_new_tokens": 10, "stream": True,
                    "stop_token_ids": [7, 11, 30]},
    "multirow-stream": {"tokens": _TOKS, "max_new_tokens": 6, "stream": True},
    "resume": {"tokens": _TOKS[:1], "max_new_tokens": 10, "stream": True, **SAMPLED},
    "too-long": {"tokens": [list(range(4, 64)) * 2], "max_new_tokens": 20},
}


@pytest.mark.parametrize("name", sorted(GENERATE))
def test_generate_bodies_identical_to_the_jax_engine(fronts, name):
    body = dict(GENERATE[name])
    if name == "resume":
        # continue the uninterrupted stream after 4 tokens
        (_, _, whole), _ = _both(fronts, "/v1/generate", body)
        tokens = [json.loads(x)["tokens"][0][0] for x in whole.splitlines()[:-1]]
        body["resume"] = {"emitted": tokens[:4], "seed": SAMPLED["seed"]}
        body["seed"] = 0  # resume.seed pins the stream's seed
    (_, _, jraw), (_, _, traw) = _both(fronts, "/v1/generate", body)
    assert traw == jraw
    if name == "resume":
        cont = [json.loads(x)["tokens"][0][0] for x in traw.splitlines()[:-1]]
        assert tokens[:4] + cont == tokens


def test_resume_headers_and_refusals_identical(fronts):
    body = {"tokens": _TOKS[:1], "max_new_tokens": 8, "stream": True, **SAMPLED}
    for headers, extra in (
        ({"X-ModelX-Resume-Emitted": "5,6", "X-ModelX-Resume-Seed": "5"}, {}),
        ({}, {"resume": {"emitted": list(range(4, 12)), "seed": 5}}),  # exhausted: 422
        ({}, {"resume": {"emitted": [99], "seed": 5}}),  # out of vocab: 400
        ({}, {"resume": {"emitted": [5], "seed": 5}, "stream": False}),  # not a stream
        ({"X-ModelX-Resume-Seed": "5"}, {}),  # both-or-neither
    ):
        (jstatus, _, jraw), (_, _, traw) = _both(fronts, "/v1/generate", {**body, **extra},
                                                 headers)
        assert traw == jraw, (headers, extra, jstatus)


def test_chat_sse_resume_identical(fronts):
    jport, tport, _ = fronts
    req = _chat(stream=True, max_tokens=8, temperature=0.8, seed=3)
    (_, jctype, jraw), (_, _, traw) = _both(fronts, "/v1/chat/completions", req)
    assert _parse(jctype, traw) == _parse(jctype, jraw)
    resumed = dict(req, resume={"emitted": [9, 12, 40], "seed": 3})
    (jstatus, jctype, jraw), (_, _, traw) = _both(fronts, "/v1/chat/completions", resumed)
    assert jstatus == 200 and _parse(jctype, traw) == _parse(jctype, jraw)
    # the usage chunk carries the engine's timing on both (clock values)
    usage = dict(req, stream_options={"include_usage": True})
    (_, jctype, jraw), (_, _, traw) = _both(fronts, "/v1/completions",
                                            {**usage, "prompt": "hello world"})
    jev, tev = _parse(jctype, jraw), _parse(jctype, traw)
    assert set(tev[-2]["timing"]) == set(jev[-2]["timing"]) >= {"queue_ms", "ttft_ms"}
    for ev in (jev, tev):
        ev[-2].pop("timing")
    assert tev == jev


def test_completions_json_identical(fronts):
    for body in ({"prompt": "hello world tpu", "max_tokens": 6, "seed": 0, "temperature": 0},
                 {"prompt": ["hello", "tpu world"], "max_tokens": 5, "n": 2, "seed": 4,
                  "temperature": 0.7}):
        (_, jctype, jraw), (_, _, traw) = _both(fronts, "/v1/completions", body)
        assert _parse(jctype, traw) == _parse(jctype, jraw)


def test_include_timing_line(fronts):
    body = {"tokens": _TOKS[:1], "max_new_tokens": 6, "stream": True, "include_timing": True}
    (_, _, jraw), (_, _, traw) = _both(fronts, "/v1/generate", body)
    jl_, tl_ = jraw.splitlines(), traw.splitlines()
    assert tl_[:-2] == jl_[:-2] and tl_[-1] == jl_[-1] == b'{"done": true}'
    jt, tt = json.loads(jl_[-2])["timing"], json.loads(tl_[-2])["timing"]
    assert list(tt) == list(jt) and tt["tokens"] == jt["tokens"] == 6
    assert tt["ttft_ms"] <= tt["total_ms"]


def test_engine_state_surfaces_identical(fronts):
    jport, tport, tsset = fronts
    for path in ("/healthz", "/livez"):
        (jstatus, _, jraw), (tstatus, _, traw) = _call(jport, path), _call(tport, path)
        # the control-plane block is each process's registry history (other
        # tests in the worker move it), not the engine's
        j, t = json.loads(jraw), json.loads(traw)
        j.pop("control_plane", None)
        t.pop("control_plane", None)
        assert (tstatus, t) == (jstatus, j) == (200, {"status": "ok"})
    j = json.loads(_call(jport, "/admin/models")[2])["serving"]
    t = json.loads(_call(tport, "/admin/models")[2])["serving"]
    assert t == j == {"m": {"queue_depth": 0, "active": 0, "waiting": 0,
                            "engine_state": "running"}}
    snap = tsset.cbatchers["m"].snapshot()
    assert snap["admitted"] > 0 and snap["engine_state"] == "running"
