"""The port's text surface (text on /v1/generate, /v1/completions,
/v1/chat/completions, SSE, logprobs) against the JAX sidecar, on the CPU.

One tiny fp32 llama with tests/test_openai_api.py's word-level
tokenizer.json is served by a JAX pod and by a port pod, under four names:
``m`` (no chat template), ``t`` (tests/test_openai_api.py's template, with
``raise_exception``), ``b`` (a template that fails on every render: the
broken-template fallback) and ``e`` (a config.json whose ``eos_token_id`` is
a token the greedy decode emits). Every request carries an explicit seed.
The two pods must answer the same status and the same body, JSON or SSE
events, once the random ``id`` and ``created`` are masked. Logprob values
agree within ``LOGPROB_ATOL`` (fp32 logits from two forwards that differ
in reduction order only); token strings, ids and everything else exactly.
"""

import dataclasses
import json
import os
import types
import urllib.error
import urllib.request
from types import SimpleNamespace

import numpy as np
import pytest
import tokenizers

import jax
import jax.numpy as jnp

from modelx_tpu.dl import openai_api as joai
from modelx_tpu.dl import safetensors as jst
from modelx_tpu.dl import serve as jserve
from modelx_tpu.models import llama as jl
from modelx_tpu.registry.server import free_port
from modelx_tpu_torch.dl import openai_api as toai
from modelx_tpu_torch.dl import serve as tserve
from modelx_tpu_torch.dl import serve_main
from modelx_tpu_torch.dl.tokenizer import Tokenizer

LOGPROB_ATOL = 1e-5

PROMPT = "hello world tpu"
TEMPLATE = (  # tests/test_openai_api.py's templated_front
    "{{ bos_token }} "
    "{% for m in messages %}"
    "{% if m['role'] not in ['system', 'user', 'assistant'] %}"
    "{{ raise_exception('unknown role ' + m['role']) }}"
    "{% endif %}"
    "{{ m['content'] }} "
    "{% endfor %}"
    "{% if add_generation_prompt %}world{% endif %}"
)


def _wordlevel_json() -> str:
    vocab = {"<unk>": 0, "hello": 1, "world": 2, "tpu": 3}
    vocab.update({f"w{i}": i for i in range(4, 64)})
    tok = tokenizers.Tokenizer(tokenizers.models.WordLevel(vocab, unk_token="<unk>"))
    tok.pre_tokenizer = tokenizers.pre_tokenizers.Whitespace()
    return tok.to_str()


@pytest.fixture(scope="module")
def pods(tmp_path_factory):
    root = tmp_path_factory.mktemp("oai")
    cfg = dataclasses.replace(jl.LlamaConfig.tiny(vocab_size=64), dtype=jnp.float32)
    weights = str(root / "model.safetensors")
    jst.write_safetensors(weights, {k: np.asarray(v) for k, v in
                                    jl.init_params(cfg, jax.random.PRNGKey(0)).items()})
    dirs = {}
    for name in ("m", "t", "b", "e"):
        d = root / name
        d.mkdir()
        os.symlink(weights, d / "model.safetensors")
        (d / "tokenizer.json").write_text(_wordlevel_json())
        dirs[name] = str(d)
    (root / "t" / "tokenizer_config.json").write_text(json.dumps({
        "bos_token": {"content": "hello"}, "chat_template": TEMPLATE}))
    (root / "b" / "tokenizer_config.json").write_text(json.dumps({
        "bos_token": "hello", "chat_template": "{{ bos_token }} {{ nothing.at_all }}"}))
    # the eos of model e: the second token the greedy decode of PROMPT emits
    probe = tserve.ModelServer(dirs["m"], dtype="float32", device="cpu")
    probe.load()
    greedy = probe.generate(np.asarray([[1, 2, 3]], np.int32), max_new_tokens=6)[0, 3:]
    eos = int(greedy[1])
    (root / "e" / "config.json").write_text(json.dumps({"eos_token_id": eos}))

    jsset = jserve.ServerSet({n: jserve.ModelServer(d, mesh_spec="dp=1", dtype="float32", name=n)
                              for n, d in dirs.items()}, default="m")
    jhttpd = jserve.serve(jsset, listen=f"127.0.0.1:{free_port()}")
    jsset.load_all()
    argv = [a for n, d in dirs.items() for a in ("--model", f"{n}={d}")]
    tsset, thttpd = serve_main.start(argv + ["--device", "cpu", "--dtype", "float32",
                                             "--listen", f"127.0.0.1:{free_port()}"])
    yield SimpleNamespace(jport=jhttpd.server_address[1], tport=thttpd.server_address[1],
                          jsset=jsset, tsset=tsset, eos=eos, greedy=greedy.tolist())
    for h in (jhttpd, thttpd):
        h.shutdown()
        h.server_close()


def _call(port, path, body=None, headers=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, r.headers.get("Content-Type"), r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.read()


def _mask(obj):
    if isinstance(obj, dict):
        return {k: ("<masked>" if k in ("id", "created") and k in obj and not isinstance(
            obj[k], (dict, list)) else v) for k, v in obj.items()}
    return obj


def _parse(ctype: str, raw: bytes):
    """A JSON body, or the list of SSE events (``[DONE]`` as a string),
    each with ``id``/``created`` masked."""
    if ctype == "text/event-stream":
        assert raw.endswith(b"\n\n")
        out = []
        for chunk in raw.decode().split("\n\n")[:-1]:
            assert chunk.startswith("data: ")
            data = chunk[len("data: "):]
            out.append(data if data == "[DONE]" else _mask(json.loads(data)))
        return out
    return _mask(json.loads(raw))


def _assert_same(got, want, where="body"):
    """Equal, floats within LOGPROB_ATOL."""
    if isinstance(want, float):
        assert isinstance(got, float) and abs(got - want) <= LOGPROB_ATOL, (where, got, want)
    elif isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), (where, got, want)
        for k in want:
            _assert_same(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), (where, got, want)
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, f"{where}[{i}]")
    else:
        assert got == want, (where, got, want)


def _assert_pods_agree(pods, path, body, headers=None):
    jstatus, jctype, jraw = _call(pods.jport, path, body, headers)
    tstatus, tctype, traw = _call(pods.tport, path, body, headers)
    assert (tstatus, tctype) == (jstatus, jctype), (traw, jraw)
    want, got = _parse(jctype, jraw), _parse(tctype, traw)
    if "logprobs" in json.dumps(want):
        _assert_same(got, want)
    else:
        assert json.dumps(got) == json.dumps(want)  # exact, key order included
    return jstatus, want


def _chat(content="world tpu", **kw):
    return {"messages": [{"role": "system", "content": "hello"},
                         {"role": "user", "content": content}], "seed": 0, **kw}


CASES = {
    # completions
    "completion": ("/v1/completions", {"prompt": PROMPT, "max_tokens": 4, "temperature": 0,
                                       "seed": 0}),
    "batch-prompts": ("/v1/completions", {"prompt": ["hello world", "tpu hello"],
                                          "max_tokens": 2, "temperature": 0, "seed": 0}),
    "n-sampled": ("/v1/completions", {"prompt": "hello", "n": 3, "max_tokens": 3,
                                      "temperature": 0.9, "seed": 5}),
    "batch-n-filtered": ("/v1/completions", {"prompt": ["hello world", "tpu w7 w9"], "n": 2,
                                             "max_tokens": 3, "temperature": 1.0, "top_k": 5,
                                             "top_p": 0.9, "seed": 11}),
    "default-model": ("/v1/completions", {"prompt": "hello", "max_tokens": 1, "seed": 0}),
    "explicit-model": ("/v1/completions", {"prompt": "hello", "model": "m", "max_tokens": 1,
                                           "seed": 0}),
    "unknown-model": ("/v1/completions", {"prompt": "hello", "model": "nope", "seed": 0}),
    "max-completion-tokens": ("/v1/completions", {"prompt": "hello", "max_tokens": 9,
                                                  "max_completion_tokens": 3,
                                                  "temperature": 0, "seed": 0}),
    "unknown-words": ("/v1/completions", {"prompt": "hello w99 zebra", "max_tokens": 2,
                                          "temperature": 0, "seed": 0}),
    "empty-tools": ("/v1/completions", {"prompt": "hello", "tools": [], "max_tokens": 1,
                                        "seed": 0}),
    "stream-options-without-stream": ("/v1/completions", {"prompt": "hello", "seed": 0,
                                                          "stream_options": {}}),
    "tools": ("/v1/completions", {"prompt": "hello", "tools": [{"x": 1}], "seed": 0}),
    "completions-on-templated-model": ("/v1/completions", {"model": "t", "prompt": "tpu",
                                                           "max_tokens": 2, "temperature": 0,
                                                           "seed": 0}),
    # chat
    "chat": ("/v1/chat/completions", _chat(max_tokens=3, temperature=0)),
    "chat-sampled": ("/v1/chat/completions", _chat(max_tokens=4, temperature=0.7, seed=9)),
    "chat-template": ("/v1/chat/completions", {"model": "t", "messages": [
        {"role": "user", "content": "tpu"}], "max_tokens": 2, "temperature": 0, "seed": 0}),
    "chat-template-raise": ("/v1/chat/completions", {"model": "t", "messages": [
        {"role": "tool", "content": "x"}], "max_tokens": 2, "seed": 0}),
    "chat-template-broken": ("/v1/chat/completions", {"model": "b", "messages": [
        {"role": "user", "content": "tpu hello"}], "max_tokens": 2, "temperature": 0,
        "seed": 0}),
    # SSE
    "stream": ("/v1/completions", {"prompt": PROMPT, "max_tokens": 12, "temperature": 0,
                                   "stream": True, "seed": 0}),
    "stream-sampled": ("/v1/completions", {"prompt": PROMPT, "max_tokens": 10,
                                           "temperature": 0.8, "top_k": 20, "stream": True,
                                           "seed": 4}),
    "stream-usage": ("/v1/completions", {"prompt": PROMPT, "max_tokens": 5, "temperature": 0,
                                         "stream": True, "seed": 0,
                                         "stream_options": {"include_usage": True}}),
    "chat-stream": ("/v1/chat/completions", _chat(max_tokens=9, temperature=0, stream=True)),
    "chat-stream-usage": ("/v1/chat/completions", _chat(
        max_tokens=3, temperature=0, stream=True, stream_options={"include_usage": True})),
    "chat-stream-template": ("/v1/chat/completions", {"model": "t", "messages": [
        {"role": "user", "content": "tpu"}], "max_tokens": 4, "temperature": 0,
        "stream": True, "seed": 0}),
    "stream-n": ("/v1/completions", {"prompt": "hello", "n": 2, "stream": True, "seed": 0}),
    "stream-logprobs": ("/v1/completions", {"prompt": "hello", "logprobs": 1, "stream": True,
                                            "seed": 0}),
    "stream-prompt-list": ("/v1/completions", {"prompt": ["a", "b"], "stream": True,
                                               "seed": 0}),
    "stream-options-not-object": ("/v1/completions", {"prompt": "hello", "stream": True,
                                                      "stream_options": [1], "seed": 0}),
    "chat-stream-raise": ("/v1/chat/completions", {"model": "t", "messages": [
        {"role": "tool", "content": "x"}], "stream": True, "seed": 0}),
    # logprobs
    "logprobs-3": ("/v1/completions", {"prompt": PROMPT, "max_tokens": 4, "temperature": 0,
                                       "logprobs": 3, "seed": 0}),
    "logprobs-0": ("/v1/completions", {"prompt": PROMPT, "max_tokens": 3, "temperature": 0,
                                       "logprobs": 0, "seed": 0}),
    "logprobs-batch-n": ("/v1/completions", {"prompt": ["hello world", "tpu"], "n": 2,
                                             "max_tokens": 3, "temperature": 0.9,
                                             "logprobs": 5, "seed": 2}),
    "chat-logprobs": ("/v1/chat/completions", _chat(max_tokens=3, temperature=0,
                                                    logprobs=True, top_logprobs=2)),
    "chat-logprobs-no-top": ("/v1/chat/completions", _chat(max_tokens=2, temperature=0,
                                                           logprobs=True)),
    "logprobs-null": ("/v1/completions", {"prompt": "hello", "max_tokens": 2, "logprobs": None,
                                          "n": None, "temperature": 0, "seed": 0}),
    "chat-logprobs-false": ("/v1/chat/completions", _chat(max_tokens=2, temperature=0,
                                                          logprobs=False)),
    # EOS
    "eos-trim": ("/v1/completions", {"model": "e", "prompt": PROMPT, "max_tokens": 6,
                                     "temperature": 0, "seed": 0}),
    "eos-trim-logprobs": ("/v1/completions", {"model": "e", "prompt": PROMPT, "max_tokens": 6,
                                              "temperature": 0, "logprobs": 2, "seed": 0}),
    "eos-ignored": ("/v1/completions", {"model": "e", "prompt": PROMPT, "max_tokens": 6,
                                        "temperature": 0, "ignore_eos": True, "seed": 0}),
    "eos-stream": ("/v1/completions", {"model": "e", "prompt": PROMPT, "max_tokens": 6,
                                       "temperature": 0, "stream": True, "seed": 0,
                                       "stream_options": {"include_usage": True}}),
    "eos-chat-stream": ("/v1/chat/completions", {"model": "e", **_chat(
        content="tpu", max_tokens=6, temperature=0, stream=True)}),
    "eos-ignore-not-bool": ("/v1/completions", {"model": "e", "prompt": PROMPT,
                                                "ignore_eos": "yes", "seed": 0}),
    # resume: continuing a stream needs the continuous engine
    "resume-stream": ("/v1/completions", {"prompt": PROMPT, "max_tokens": 6, "stream": True,
                                          "seed": 0, "resume": {"emitted": [5], "seed": 7}}),
    "resume-not-stream": ("/v1/completions", {"prompt": PROMPT, "seed": 0,
                                              "resume": {"emitted": [5], "seed": 7}}),
    "resume-exhausted": ("/v1/completions", {"prompt": PROMPT, "max_tokens": 2, "stream": True,
                                             "seed": 0, "resume": {"emitted": [5, 6],
                                                                   "seed": 7}}),
    "resume-malformed": ("/v1/chat/completions", _chat(stream=True, resume=[5])),
    # text in/out on the native route
    "text": ("/v1/generate", {"text": PROMPT, "max_new_tokens": 3}),
    "text-sampled": ("/v1/t/generate", {"text": "tpu hello", "max_new_tokens": 4,
                                        "temperature": 0.7, "seed": 3}),
    "text-stop-ids": ("/v1/e/generate", {"text": PROMPT, "max_new_tokens": 5,
                                         "stop_token_ids": [9, 11]}),
    "text-stream": ("/v1/generate", {"text": PROMPT, "stream": True}),
    "text-zero-tokens": ("/v1/generate", {"text": "   "}),
    "text-and-tokens": ("/v1/generate", {"text": PROMPT, "tokens": [[1]]}),
}

VALIDATION = [  # tests/test_openai_api.py's 400s, completions then chat
    ("/v1/completions", {"prompt": ""}),
    ("/v1/completions", {"prompt": 7}),
    ("/v1/completions", {"prompt": "hello", "max_tokens": 0}),
    ("/v1/completions", {"prompt": "hello", "max_tokens": 1025}),
    ("/v1/completions", {"prompt": "hello", "max_completion_tokens": "x"}),
    ("/v1/completions", {"prompt": "hello", "temperature": 3.0}),
    ("/v1/completions", {"prompt": "hello", "top_p": 0.0}),
    ("/v1/completions", {"prompt": "hello", "top_k": -1}),
    ("/v1/completions", {"prompt": "hello", "stop": ["a", "b", "c", "d", "e"]}),
    ("/v1/completions", {"prompt": "hello", "stop": [""]}),
    ("/v1/completions", {"prompt": "hello", "n": 0}),
    ("/v1/completions", {"prompt": "hello", "n": 33}),
    ("/v1/completions", {"prompt": "hello", "logprobs": 6}),
    ("/v1/completions", {"prompt": "hello", "logprobs": True}),
    ("/v1/completions", {"prompt": ["hello"] * 33}),
    ("/v1/completions", {"prompt": "hello", "echo": True}),
    ("/v1/chat/completions", {"messages": []}),
    ("/v1/chat/completions", {"messages": [{"role": "alien", "content": "x"}]}),
    ("/v1/chat/completions", {"messages": [{"role": "user"}]}),
    ("/v1/chat/completions", {"messages": "hi"}),
    ("/v1/chat/completions", {"messages": [{"role": "user", "content": "x"}],
                              "top_logprobs": 2}),
    ("/v1/chat/completions", {"messages": [{"role": "user", "content": "x"}],
                              "logprobs": 3}),
    ("/v1/chat/completions", {"messages": [{"role": "user", "content": "x"}],
                              "logprobs": True, "top_logprobs": 21}),
]


@pytest.mark.parametrize("name", sorted(CASES))
def test_pods_agree(pods, name):
    path, body = CASES[name]
    _assert_pods_agree(pods, path, body)


@pytest.mark.parametrize("path,body", VALIDATION, ids=[str(i) for i in range(len(VALIDATION))])
def test_validation_errors_agree(pods, path, body):
    status, want = _assert_pods_agree(pods, path, {**body, "seed": 0})
    assert status == 400 and want["error"]["type"] == "invalid_request_error"


def test_results_are_what_they_claim(pods):
    """The agreed bodies mean what the JAX tests say they mean: text ==
    decode of the token request, the template (not the fallback) made the
    prompt, EOS ends the completion, the broken template fell back."""
    tok = pods.tsset.servers["m"].tokenizer()
    _, body = _assert_pods_agree(pods, *CASES["completion"])
    _, gen = _assert_pods_agree(pods, "/v1/generate", {"tokens": [[1, 2, 3]],
                                                       "max_new_tokens": 4})
    assert body["choices"][0]["text"] == tok.decode(gen["tokens"][0][3:])
    _, text = _assert_pods_agree(pods, *CASES["text"])
    assert text["tokens"][0][:3] == [1, 2, 3] and text["text"] == tok.decode(text["tokens"][0][3:])
    _, tpl = _assert_pods_agree(pods, *CASES["chat-template"])
    assert tpl["usage"]["prompt_tokens"] == 3  # "hello tpu world"
    _, eos = _assert_pods_agree(pods, *CASES["eos-trim"])
    assert eos["choices"][0]["finish_reason"] == "stop"
    assert eos["usage"]["completion_tokens"] == 2  # the EOS counts, its text does not
    _, broken = _assert_pods_agree(pods, *CASES["chat-template-broken"])
    # the generic role template: "<|", "user", "|>", "tpu", "hello", "<|", "assistant", "|>"
    assert broken["usage"]["prompt_tokens"] == 8
    assert pods.tsset.servers["b"].chat_template()["broken"]


def test_stop_sequences_agree(pods):
    """Stops cut the text the same way on both pods, streamed and not,
    including a stop that straddles two decode chunks (8 tokens each)."""
    _, body = _assert_pods_agree(pods, "/v1/completions", {
        "prompt": PROMPT, "max_tokens": 12, "temperature": 0, "seed": 0})
    words = body["choices"][0]["text"].split()
    assert len(words) == 12
    stops = [words[1], f"{words[7]} {words[8]}", [words[10], words[3]], "zzz", words[0][:1]]
    for stop in stops:
        for stream in (False, True):
            req = {"prompt": PROMPT, "max_tokens": 12, "temperature": 0, "seed": 0,
                   "stop": stop, "stream": stream}
            _, got = _assert_pods_agree(pods, "/v1/completions", req)
            if not stream and stop != "zzz":
                assert got["choices"][0]["finish_reason"] == "stop"
        _assert_pods_agree(pods, "/v1/completions", {
            "prompt": PROMPT, "max_tokens": 12, "temperature": 0, "seed": 0, "stop": stop,
            "logprobs": 2})


def test_models_payload_agrees(pods):
    """Both contracts agree, except the JAX pod's lifecycle pool (the
    registry-deploy slice): its ``lifecycle_state`` on each OpenAI row."""
    _, _, jraw = _call(pods.jport, "/v1/models")
    _, _, traw = _call(pods.tport, "/v1/models")
    want, got = json.loads(jraw), json.loads(traw)
    assert {r.pop("lifecycle_state") for r in want["data"]} == {"READY"}
    for key in ("object", "data", "default"):
        assert got[key] == want[key]
    assert list(got["models"]) == list(want["models"])
    assert all(got["models"][n]["ready"] for n in got["models"])


@pytest.mark.parametrize("deadline,path,body", [
    ("0", "/v1/completions", {"prompt": PROMPT, "seed": 0}),
    ("-1", "/v1/chat/completions", _chat(stream=True)),
    ("0", "/v1/generate", {"text": PROMPT}),
    ("120000", "/v1/completions", {"prompt": PROMPT, "max_tokens": 2, "seed": 0}),
])
def test_deadline_header_agrees(pods, deadline, path, body):
    status, _ = _assert_pods_agree(pods, path, body, headers={"X-ModelX-Deadline-Ms": deadline})
    assert status == (200 if deadline == "120000" else 504)


# -- library level: the same functions on the same inputs ----------------------------


def test_score_logprobs_rows_match_jax(pods):
    rows = [([1, 2, 3], [5, 9, 2]), ([4], [7]), ([1, 2, 3, 9, 9], [10, 11, 12, 13]),
            ([2, 2], [])]
    for top_k in (0, 4):
        want = pods.jsset.servers["m"].score_logprobs_rows(rows, top_k=top_k)
        got = pods.tsset.servers["m"].score_logprobs_rows(rows, top_k=top_k)
        for (wc, wi, wl), (gc, gi, gl) in zip(want, got):
            np.testing.assert_allclose(gc, wc, rtol=0, atol=LOGPROB_ATOL)
            if top_k:
                np.testing.assert_allclose(gl, wl, rtol=0, atol=LOGPROB_ATOL)
                # ids must match where the values are distinct (ties may order apart)
                distinct = np.abs(np.diff(wl, axis=-1)) > LOGPROB_ATOL
                distinct = np.concatenate([distinct[..., :1], distinct], axis=-1)
                assert (gi[distinct] == wi[distinct]).all()
            else:
                assert gi is None and wi is None


def _fake_sset(module, pieces, decode=None, eos=()):
    """tests/test_openai_api.py's fake harness: a scripted decode behind
    each package's real ServerSet.stream_source / engine_for."""

    class Tok:
        def encode(self, text, add_special_tokens=True):
            return [1, 2]

        def decode(self, ids):
            return decode(ids) if decode else " ".join(f"w{i}" for i in ids)

        def eos_ids(self):
            return tuple(eos)

    def gen_stream(tokens, max_new_tokens, **samp):
        for p in pieces:
            yield np.asarray(p)
            if any(t in eos for t in p[0]):
                return

    server = SimpleNamespace(
        name="f", ready=True, speculative_k=0, chat_template=lambda: None,
        cfg=SimpleNamespace(vocab_size=100),
        family=SimpleNamespace(decode_fns=object(), name="fake", generate_ragged=None),
        stats={"requests": 0}, tokenizer=lambda: Tok(), generate_stream=gen_stream)
    sset = SimpleNamespace(servers={"f": server}, default="f", max_new_tokens_limit=64,
                           stream_chunk_size=8, batcher_for=lambda s: None,
                           continuous_for=lambda s: None)
    sset.stream_source = types.MethodType(module.ServerSet.stream_source, sset)
    sset.engine_for = types.MethodType(module.ServerSet.engine_for, sset)
    return sset


_GLYPH = {(5,): "a�", (5, 6): "aé", (5, 6, 7): "aéb"}
STREAM_SCRIPTS = {
    "stop-straddles-chunks": ([[[5]], [[6]], [[7]]], None, (), {"stop": ["w5 w6"]}),
    "stop-prefix-held": ([[[5]], [[6]], [[7]]], None, (), {"stop": ["w6"]}),
    "no-stop": ([[[5]], [[6]]], None, (), {}),
    "glyph-held": ([[[5]], [[6]], [[7]]], lambda ids: _GLYPH[tuple(ids)], (), {}),
    "divergent-flush": ([[[5]], [[6, 50]]], lambda ids: "a�" if list(ids) == [5]
                        else "X rewritten", (50,), {}),
    "eos": ([[[5]], [[6, 50]], [[7]]], None, (50,),
            {"stream_options": {"include_usage": True}}),
    "ignore-eos": ([[[5]], [[6, 50]], [[7]]], None, (50,), {"ignore_eos": True}),
}


@pytest.mark.parametrize("chat", [False, True], ids=["completions", "chat"])
@pytest.mark.parametrize("name", sorted(STREAM_SCRIPTS))
def test_stream_events_match_jax(name, chat):
    pieces, decode, eos, extra = STREAM_SCRIPTS[name]
    req = {"max_tokens": 8, **extra, **({"messages": [{"role": "user", "content": "x"}]}
                                        if chat else {"prompt": "x"})}
    events = {}
    for label, module, api in (("jax", jserve, joai), ("port", tserve, toai)):
        sset = _fake_sset(module, pieces, decode, eos)
        events[label] = [_mask(e) for e in api.stream_completion(sset, dict(req), chat=chat)]
    assert events["port"] == events["jax"]


class _FakeTemplate:
    def __init__(self, render):
        self.render_fn = render

    def render(self, messages, **_kw):
        return self.render_fn(messages)


def _boom_on(word, exc):
    def render(messages):
        if any(word in m["content"] for m in messages):
            raise exc("cannot format this content")
        return "rendered"
    return render


@pytest.mark.parametrize("case", ["message-dependent", "broken", "probe-rejected"])
def test_template_triage_matches_jax(case):
    """TestTemplateFailureTriage's three cases through both render_messages:
    the same text or the same 400, and the same memoized broken verdict."""
    def outcome(api, rejected):
        if case == "message-dependent":
            render = _boom_on("boom", RuntimeError)
        elif case == "broken":
            def render(_m):
                raise RuntimeError("no filter named 'tojson'")
        else:
            def render(messages):
                if not any(m["role"] == "system" for m in messages):
                    raise rejected("needs a system turn")
                if "boom" in messages[-1]["content"]:
                    raise RuntimeError("message-dependent failure")
                return "rendered"
        spec = {"compiled": _FakeTemplate(render), "bos_token": "", "eos_token": ""}
        out = []
        for msgs in ([{"role": "system", "content": "s"}, {"role": "user", "content": "boom"}],
                     [{"role": "system", "content": "s"}, {"role": "user", "content": "ok"}]):
            try:
                out.append(api.render_messages(msgs, spec))
            except api.APIError as e:
                out.append((e.status, e.payload))
        return out, bool(spec.get("broken"))

    assert outcome(toai, tserve.ChatTemplateRejected) == outcome(joai, jserve.ChatTemplateRejected)


@pytest.mark.parametrize("files", [
    {},
    {"generation_config.json": {"eos_token_id": [7, 7, 9]}, "config.json": {"eos_token_id": 3}},
    {"config.json": {"eos_token_id": 3}},
    {"config.json": {"eos_token_id": True}, "tokenizer_config.json": {"eos_token": "w9"}},
    {"tokenizer_config.json": {"eos_token": {"content": "tpu"}}},
    {"tokenizer_config.json": {"eos_token": "not-in-vocab"}},
    {"config.json": "{not json", "tokenizer_config.json": {"eos_token": "w5"}},
], ids=["none", "generation-config", "config", "tokenizer-config", "added-token-form",
        "unknown-spelling", "malformed-config"])
def test_eos_from_config_matches_jax(tmp_path, files):
    for name, content in files.items():
        (tmp_path / name).write_text(content if isinstance(content, str) else json.dumps(content))
    text = _wordlevel_json()
    want = jserve._eos_from_config(str(tmp_path), tokenizers.Tokenizer.from_str(text))
    got = tserve._eos_from_config(str(tmp_path), Tokenizer.from_str(text))
    assert got == want


def test_eos_probe_matches_jax():
    vocab = {"<unk>": 0, "<|endoftext|>": 1, "<|im_end|>": 2, "x": 3}
    tok = tokenizers.Tokenizer(tokenizers.models.WordLevel(vocab, unk_token="<unk>"))
    text = tok.to_str()
    want = jserve._Tokenizer(tokenizers.Tokenizer.from_str(text)).eos_ids()
    assert tserve._Tokenizer(Tokenizer.from_str(text)).eos_ids() == want == (1, 2)


@pytest.mark.parametrize("req", [
    {}, {"seed": 7, "temperature": 0.5, "top_k": 3, "top_p": 0.5, "max_tokens": 9},
    {"max_completion_tokens": None, "max_tokens": 4, "seed": 1}, {"max_tokens": "x"},
    {"seed": 2**31}, {"functions": None, "tool_choice": {}, "seed": 1}, {"echo": 1},
], ids=range(7))
def test_parse_sampling_matches_jax(req):
    def outcome(api):
        try:
            n, samp = api.parse_sampling(dict(req), 64)
            return n, {**samp, "seed": samp["seed"] if "seed" in req else None}
        except api.APIError as e:
            return e.status, e.payload
    assert outcome(toai) == outcome(joai)


@pytest.mark.parametrize("content", [None, "{not json", _wordlevel_json()],
                         ids=["absent", "corrupt", "present"])
def test_tokenizer_load_outcomes_match_jax(tmp_path, content):
    """No tokenizer.json: None (cached); a file that fails to load: a
    RuntimeError each time (503 on both surfaces, retried next request); a
    good file: a tokenizer with the same ids."""
    if content is not None:
        (tmp_path / "tokenizer.json").write_text(content)
    servers = (jserve.ModelServer(str(tmp_path), mesh_spec="dp=1", dtype="float32"),
               tserve.ModelServer(str(tmp_path), dtype="float32", device="cpu"))
    prefix = "tokenizer.json exists but failed to load: "
    outcomes = []
    for server in servers:
        for _ in range(2):
            try:
                tok = server.tokenizer()
                outcomes.append(None if tok is None else tok.encode(PROMPT))
            except RuntimeError as e:
                assert str(e).startswith(prefix)
                outcomes.append("failed")
    assert outcomes[:2] == outcomes[2:]
