"""Shared by tests/test_torch_{gemma2,phi3,mixtral,gpt2}.py: a tiny fp32
checkpoint written by the JAX package, a JAX pod and a port pod serving
it over HTTP, the requests whose bodies the two must answer byte for
byte, and the port's continuous engine (dense, paged gather, paged in
place) against the JAX package's plain generate.

Config inference runs on both sides (rope theta, softcaps, windows come
from the shapes), so the two pods serve the same inferred model whatever
the JAX init's config said."""

import concurrent.futures
import json
import os
import urllib.error
import urllib.request

import numpy as np

from modelx_tpu.dl import safetensors as jst
from modelx_tpu.dl.serve import ModelServer as JaxModelServer
from modelx_tpu.dl.serve import serve as jax_serve
from modelx_tpu.registry.server import free_port
from modelx_tpu_torch.dl import serve_main
from modelx_tpu_torch.dl.continuous import ContinuousBatcher

MAX_SEQ_LEN = 64
SAMPLED = {"temperature": 0.8, "top_k": 40, "top_p": 0.95, "seed": 7}


def write_checkpoint(dirpath: str, params: dict) -> str:
    """``params`` (JAX arrays or numpy) as one fp32 safetensors file."""
    os.makedirs(dirpath, exist_ok=True)
    jst.write_safetensors(os.path.join(dirpath, "model.safetensors"),
                          {k: np.asarray(v) for k, v in params.items()})
    return dirpath


class Pods:
    """A JAX sidecar and a port ``serve_main`` over one checkpoint, fp32 on
    the CPU, both at ``MAX_SEQ_LEN``."""

    def __init__(self, model_dir: str, name: str) -> None:
        self.jserver = JaxModelServer(model_dir, mesh_spec="dp=1", dtype="float32",
                                      max_seq_len=MAX_SEQ_LEN, name=name)
        self.jserver.load()
        self.jhttpd = jax_serve(self.jserver, listen=f"127.0.0.1:{free_port()}")
        self.sset, self.thttpd = serve_main.start([
            "--model", f"{name}={model_dir}", "--device", "cpu", "--dtype", "float32",
            "--max-seq-len", str(MAX_SEQ_LEN), "--listen", f"127.0.0.1:{free_port()}"])
        self.server = self.sset.servers[name]

    def both(self, path: str, body) -> tuple:
        """((JAX status, raw body), (port status, raw body))."""
        return (call(self.jhttpd.server_address[1], path, body),
                call(self.thttpd.server_address[1], path, body))

    def close(self) -> None:
        for h in (self.jhttpd, self.thttpd):
            h.shutdown()
            h.server_close()


def call(port: int, path: str, body) -> tuple[int, bytes]:
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def parity_requests(vocab: int, seq: int = 12, seed: int = 3) -> list:
    """Forward, greedy, seeded sampled and streamed requests (one row and
    two) over ``seq``-token prompts."""
    toks = np.random.RandomState(seed).randint(0, vocab, (2, seq)).tolist()
    return [
        ("/v1/forward", {"tokens": toks}),
        ("/v1/generate", {"tokens": toks, "max_new_tokens": 6}),
        ("/v1/generate", {"tokens": toks[:1], "max_new_tokens": 6, **SAMPLED}),
        ("/v1/generate", {"tokens": toks, "max_new_tokens": 5, "temperature": 1.1, "seed": 2}),
        ("/v1/generate", {"tokens": toks[:1], "max_new_tokens": 9, "stream": True}),
        ("/v1/generate", {"tokens": toks[1:], "max_new_tokens": 7, "stream": True, **SAMPLED}),
        ("/v1/generate", {"tokens": toks, "max_new_tokens": 8, "temperature": 0.9, "seed": 1,
                          "stream": True}),
    ]


def engine_requests(vocab: int, lens=(5, 13, 30, 13), seed: int = 0) -> list:
    """(prompt [1, S] int32, sampling) per request; odd ones seeded sampled."""
    rng = np.random.RandomState(seed)
    return [(rng.randint(1, vocab, (1, n)).astype(np.int32),
             {} if i % 2 == 0 else {"temperature": 0.8, "seed": 40 + i})
            for i, n in enumerate(lens)]


ENGINE_MODES = {
    "dense": {},
    "gather": {"page_size": 16, "max_live_tokens": 1024},
    "in-place": {"page_size": 16, "max_live_tokens": 1024, "paged_attention": "in-place"},
}


def engine_tokens(server, requests: list, mode: str, n_new: int) -> list:
    """Each request through a continuous engine in ``mode``, all at once."""
    cb = ContinuousBatcher(server, max_slots=4, chunk_size=4, **ENGINE_MODES[mode])
    try:
        with concurrent.futures.ThreadPoolExecutor(len(requests)) as pool:
            return list(pool.map(lambda r: cb.generate(r[0], max_new_tokens=n_new, **r[1]),
                                 requests))
    finally:
        cb.close()
