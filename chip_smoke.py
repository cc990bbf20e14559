#!/usr/bin/env python3
"""On-card smoke of the PyTorch/CUDA port (``modelx_tpu_torch``).

    python3 chip_smoke.py                 # every phase, one H100
    python3 chip_smoke.py --phases kernels

Phases, in order, each failing the run (exit code != 0) on any error:

1. device: the card's name and power limit;
2. build: every CUDA kernel of the serving path, compiled from ``csrc/``;
3. kernels: each kernel against its plain PyTorch version on the card at
   the shapes the serving path gives it, with stated tolerances and times
   (kernel, plain version, PyTorch's library call as a yardstick, bound);
4. main: a full-width Llama-3-8B-shaped checkpoint (random weights from a
   seed) written with the port's safetensors writer, served by
   ``modelx_tpu_torch.dl.serve_main`` on the card, answering ``/v1/forward``
   and ``/v1/generate``; the kernel's launch count must rise by
   ``num_layers`` per cache-free forward.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``. Without CUDA, or without the
``modelx_tpu_torch`` package beside this file, it exits non-zero and
prints no result. It imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published dense peaks (NVIDIA data sheet) at the 700 W limit
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12

# kernel in its working dtype vs the plain version in fp32, elementwise:
# |err| <= ATOL + RTOL * |ref|. bf16: the output is rounded to bf16 (half
# an ulp is 2^-9 relative) after an fp32 online softmax, so two bf16
# half-ulps plus a small absolute floor; fp32: reduction order only.
TOL = {"bfloat16": (2e-3, 8e-3), "float32": (2e-5, 2e-5)}


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median device time of one call, by CUDA events, after warm-up."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# -- phase 1: device -----------------------------------------------------------


def phase_device() -> dict:
    import torch

    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    log(f"device: {name}; torch {torch.__version__} cuda {torch.version.cuda}; "
        f"count {torch.cuda.device_count()}")
    log(card)
    return {"name": name, "card": card}


# -- phase 2: build --------------------------------------------------------------


def phase_build() -> float:
    from modelx_tpu_torch.kernels import build

    t0 = time.monotonic()
    built = build.build()
    secs = time.monotonic() - t0
    log(f"build: flash_attention {'compiled by nvcc' if built else 'cached'} in {secs:.3f} s")
    for line in build.build_log.splitlines():
        if "registers" in line or "spill" in line or "error" in line.lower():
            log(f"  nvcc: {line.strip()}")
    return secs


# -- phase 3: kernels against their plain versions ---------------------------------

# (label, B, H, Hkv, S, D, causal, scale, softcap, window, dtype)
ATTN_CASES = [
    ("llama3-8b prefill", 1, 32, 8, 2048, 128, True, None, 0.0, 0, "bfloat16"),
    ("batch 4x512", 4, 32, 8, 512, 128, True, None, 0.0, 0, "bfloat16"),
    ("non-causal", 2, 16, 16, 512, 128, False, None, 0.0, 0, "bfloat16"),
    ("head_dim 64", 2, 16, 4, 512, 64, True, None, 0.0, 0, "bfloat16"),
    ("gemma2 softcap+window", 1, 16, 8, 1024, 256, True, 256 ** -0.5, 50.0, 256, "bfloat16"),
    ("ragged S=1000", 2, 32, 8, 1000, 128, True, None, 0.0, 0, "bfloat16"),
    ("fp32 ragged S=333", 1, 8, 2, 333, 128, True, None, 0.0, 0, "float32"),
]


def visible_pairs(s: int, causal: bool, window: int) -> int:
    """(query, key) pairs the mask leaves visible for Sq == Sk == s."""
    if not causal:
        return s * s
    if window <= 0:
        return s * (s + 1) // 2
    return sum(min(window, i + 1) for i in range(s))


def attention_bound(b, h, hkv, s, d, causal, window, dtype) -> tuple[float, str]:
    """Least time in ms: max(bytes / HBM rate, FLOPs / peak rate for the
    dtype). FLOPs = 4*D per visible pair per head (QK^T and PV); bytes =
    q, k, v read once (k/v at Hkv heads) and o written once."""
    esize = 2 if dtype == "bfloat16" else 4
    nbytes = esize * b * s * d * (2 * h + 2 * hkv)
    flops = 4 * d * visible_pairs(s, causal, window) * b * h
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def library_attention(q, k, v, ref, causal, scale, cap, window):
    """PyTorch's own call for the same function, as a yardstick only (the
    port never calls it): ``scaled_dot_product_attention`` (kv heads
    repeated outside the timed call), or, with a softcap or a window,
    ``flex_attention`` compiled with a tanh ``score_mod`` and a
    causal-window block mask. Returns (the call, its max abs error against
    ``ref``), or (None, None) when this torch has no such call."""
    import torch
    import torch.nn.functional as F

    if cap == 0.0 and window == 0:
        rep = q.shape[1] // k.shape[1]
        kr, vr = (x.repeat_interleave(rep, dim=1) for x in (k, v))

        def call():
            return F.scaled_dot_product_attention(q, kr, vr, is_causal=causal, scale=scale)
    else:
        try:
            from torch.nn.attention.flex_attention import create_block_mask, flex_attention
        except ImportError:
            log(f"library: torch {torch.__version__} has no flex_attention")
            return None, None

        def score_mod(score, b, h, qi, ki):
            return cap * torch.tanh(score / cap) if cap > 0.0 else score

        def mask_mod(b, h, qi, ki):
            seen = ki <= qi if causal else ki >= 0
            return seen & (qi - ki < window) if window > 0 else seen

        mask = create_block_mask(mask_mod, None, None, q.shape[2], k.shape[2], device="cuda")
        flex = torch.compile(flex_attention)

        def call():
            return flex(q, k, v, score_mod=score_mod, block_mask=mask, scale=scale,
                        enable_gqa=True)
    err = float((call().float() - ref).abs().max())
    return call, err


def phase_kernels() -> list[dict]:
    import torch

    from modelx_tpu_torch.ops import attention as attn

    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version is full fp32
    torch.backends.cudnn.allow_tf32 = False
    results = []
    failures = []
    for i, (label, b, h, hkv, s, d, causal, scale, cap, window, dt) in enumerate(ATTN_CASES):
        dtype = getattr(torch, dt)
        gen = torch.Generator(device="cuda").manual_seed(1000 + i)
        q = torch.randn(b, h, s, d, generator=gen, device="cuda").to(dtype)
        k = torch.randn(b, hkv, s, d, generator=gen, device="cuda").to(dtype)
        v = torch.randn(b, hkv, s, d, generator=gen, device="cuda").to(dtype)
        kw = dict(causal=causal, scale=scale, logit_softcap=cap, window=window)
        out = attn.flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        ref = attn.attention_reference(q.float(), k.float(), v.float(), **kw)
        diff = (out.float() - ref).abs()
        atol, rtol = TOL[dt]
        max_err = float(diff.max())
        ok = bool(torch.isfinite(out).all()) and bool((diff <= atol + rtol * ref.abs()).all())
        library_call, library_err = library_attention(q, k, v, ref, causal, scale, cap, window)
        del ref, diff
        ms = time_ms(lambda: attn.flash_attention(q, k, v, **kw))
        plain_ms = time_ms(lambda: attn.attention_reference(q, k, v, **kw), iters=10)
        library_ms = time_ms(library_call) if library_call else None
        bound_ms, bound_by = attention_bound(b, h, hkv, s, d, causal, window, dt)
        row = {
            "case": label, "shape": [b, h, s, d], "kv_heads": hkv, "dtype": dt,
            "causal": causal, "softcap": cap, "window": window,
            "max_abs_err": max_err, "tol": f"{atol} + {rtol}*|ref|", "ok": ok,
            "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "library_max_abs_err": library_err,
            "bound_ms": bound_ms, "bound_by": bound_by,
        }
        results.append(row)
        log(f"kernel flash_attention [{label}] q{[b, h, s, d]} kv_heads {hkv} {dt}: "
            f"max_abs_err {max_err:.3e} (tol {atol} + {rtol}*|ref|) {'ok' if ok else 'FAIL'}; "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"library {'n/a' if library_ms is None else f'{library_ms:.4f} ms'} "
            f"(max_abs_err {library_err}), "
            f"bound {bound_ms * 1e3:.2f} us ({bound_by}), "
            f"{bound_ms / ms * 100:.1f}% of bound")
        if not ok:
            failures.append(label)
    if failures:
        raise RuntimeError(f"flash_attention disagrees with its plain version: {failures}")
    return results


# -- main --------------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default="kernels,main",
                    help="comma list of phases after device+build: kernels, main")
    args = ap.parse_args(argv)
    phases = {p.strip() for p in args.phases.split(",") if p.strip()}
    if not phases <= {"kernels", "main"}:
        ap.error(f"unknown phases {sorted(phases - {'kernels', 'main'})}")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this smoke runs on the card only",
              file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, "modelx_tpu_torch")):
        print(f"chip_smoke: no modelx_tpu_torch package beside {__file__}", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)

    device = phase_device()
    phase_build()
    kernel_rows = phase_kernels() if "kernels" in phases else []
    main_stats = phase_main() if "main" in phases else {}

    head = next((r for r in kernel_rows if r["case"] == "llama3-8b prefill"), None)
    record = {
        "name": "flash_attention",
        "route": "cuda",
        "source": "modelx_tpu_torch/csrc/flash_attention.cu",
        "replaces": "modelx_tpu/ops/attention.py:149",
        # null, not 0, when the main path did not run (--phases kernels)
        "launches": main_stats.get("flash_launches"),
        "max_abs_err": max((r["max_abs_err"] for r in kernel_rows), default=None),
        "ms": head and head["ms"],
        "plain_ms": head and head["plain_ms"],
        "bound_ms": head and head["bound_ms"],
        "bound_by": head and head["bound_by"],
        "library_ms": head and head["library_ms"],
        "at": "q [1,32,2048,128] bf16, 8 kv heads, causal",
        "cases": kernel_rows,
    }
    log(json.dumps({"kernels": [record]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device["name"], "count": torch.cuda.device_count()}}))
    return 0


# -- phase 4: the serving path ---------------------------------------------------

MODEL = "llama3-8b"
FORWARD_SHAPES = ((1, 2048), (4, 512))
GENERATE_PROMPTS = (128, 512, 1000)  # prompt lengths, one row each
NEW_TOKENS = 32
# kernel-path and plain-path argmax must agree at every position whose
# top-2 logit margin (plain path, fp32) exceeds this: 4 bf16 ulps at the
# logits' magnitude (~4), the rounding the two bf16 paths may differ by
MARGIN_TOL = 0.125


def _http(port: int, path: str, body=None, timeout: float = 600.0):
    import urllib.error
    import urllib.request

    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _checkpoint_dir(nbytes: int) -> str:
    """The candidate directory (the temp dir, else the checkout) with the
    most free space; fails when even that cannot hold the checkpoint."""
    import shutil
    import tempfile

    cands = [tempfile.gettempdir(), REPO]
    free = {c: shutil.disk_usage(c).free for c in cands}
    best = max(cands, key=free.get)
    log(f"checkpoint dir candidates (free GB): "
        f"{ {c: round(f / 1e9, 1) for c, f in free.items()} }")
    if free[best] < 1.05 * nbytes:
        raise RuntimeError(f"no directory with {nbytes / 1e9:.1f} GB free for the checkpoint")
    return tempfile.mkdtemp(prefix="modelx-smoke-", dir=best)


def phase_main(device: str = "cuda", cfg=None) -> dict:
    """Drive the serving path. ``device="cpu"`` with a small ``cfg`` is a
    rehearsal of this phase's control flow (the CPU tests run it): there
    the kernel wrapper runs its plain version and launches nothing."""
    import shutil

    import torch

    from modelx_tpu_torch.dl import safetensors as st
    from modelx_tpu_torch.dl import serve_main
    from modelx_tpu_torch.models import llama
    from modelx_tpu_torch.ops import attention as attn

    on_card = device == "cuda"
    # full width AND full depth: the whole run takes about a minute of the limit
    cfg = cfg or llama.LlamaConfig.llama3_8b()
    nbytes = 2 * sum(math.prod(s) for s in llama.param_shapes(cfg).values())
    ckpt = _checkpoint_dir(nbytes)
    stats: dict = {}
    httpd = None
    try:
        t0 = time.monotonic()
        gen = torch.Generator(device=device).manual_seed(0)
        params = llama.init_params(cfg, gen, dtype=torch.bfloat16)
        st.write_safetensors(os.path.join(ckpt, "model.safetensors"), params)
        del params
        if on_card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        log(f"main: wrote a seeded random Llama-3-8B-shaped checkpoint ({cfg.num_layers} "
            f"layers, hidden {cfg.hidden_size}, ffn {cfg.intermediate_size}, heads "
            f"{cfg.num_heads}/{cfg.num_kv_heads}, vocab {cfg.vocab_size}, bf16, "
            f"{nbytes / 1e9:.3f} GB) in {time.monotonic() - t0:.1f} s")

        # the main path: every kernel count starts at 0 here
        attn.flash_attention.launches = 0
        per_forward = cfg.num_layers if on_card else 0
        port = _free_port()
        t0 = time.monotonic()
        sset, httpd = serve_main.start([
            "--model", f"{MODEL}={ckpt}", "--listen", f"127.0.0.1:{port}",
            "--device", device, "--dtype", "bfloat16", "--max-seq-len", "2048"])
        start_s = time.monotonic() - t0
        status, body = _http(port, "/healthz")
        if status != 200:
            raise RuntimeError(f"/healthz answered {status} {body}")
        server = sset.servers[MODEL]
        if server.cfg.num_layers != cfg.num_layers or server.cfg.vocab_size != cfg.vocab_size:
            raise RuntimeError(f"inferred config {server.cfg} does not match {cfg}")
        s = server.stats
        log(f"main: serve_main up in {start_s:.2f} s; load {s['load_seconds']} s, "
            f"{s['load_bytes'] / 1e9:.3f} GB at {s['load_gbps']} GB/s, ready "
            f"{s['ready_seconds']} s (includes one warm-up forward)")
        stats.update(load_seconds=s["load_seconds"], load_gbps=s["load_gbps"])

        rng = torch.Generator().manual_seed(1)
        forwards = {}
        for shape, rep in ((sh, r) for sh in FORWARD_SHAPES for r in range(2)):
            if rep == 0:
                tokens = torch.randint(0, cfg.vocab_size, shape, generator=rng)
            before = attn.flash_attention.launches
            t0 = time.monotonic()
            status, body = _http(port, "/v1/forward", {"tokens": tokens.tolist()})
            ms = (time.monotonic() - t0) * 1e3
            if status != 200:
                raise RuntimeError(f"/v1/forward {shape} answered {status} {body}")
            got = torch.tensor(body["logits_argmax"])
            if tuple(got.shape) != shape or int(got.min()) < 0 or int(got.max()) >= cfg.vocab_size:
                raise RuntimeError(f"/v1/forward {shape}: bad logits_argmax shape {tuple(got.shape)}")
            rose = attn.flash_attention.launches - before
            if rose != per_forward:
                raise RuntimeError(f"/v1/forward {shape}: flash_attention launched {rose} "
                                   f"times, want {per_forward} (one per layer on the card)")
            if rep and not torch.equal(got, forwards[shape][1]):
                raise RuntimeError(f"/v1/forward {shape}: a repeated request answered differently")
            forwards[shape] = (tokens, got)
            log(f"main: /v1/forward {list(shape)} ({'repeat' if rep else 'first'}): 200 in "
                f"{ms:.1f} ms; flash_attention launches +{rose}")
            stats[f"forward_ms_{shape[0]}x{shape[1]}" + ("" if rep else "_first")] = ms

        for plen in GENERATE_PROMPTS:
            prompt = torch.randint(0, cfg.vocab_size, (1, plen), generator=rng)
            before = attn.flash_attention.launches
            t0 = time.monotonic()
            status, body = _http(port, "/v1/generate",
                                 {"tokens": prompt.tolist(), "max_new_tokens": NEW_TOKENS})
            secs = time.monotonic() - t0
            if status != 200:
                raise RuntimeError(f"/v1/generate prompt {plen} answered {status} {body}")
            out = torch.tensor(body["tokens"])
            if tuple(out.shape) != (1, plen + NEW_TOKENS) or not torch.equal(out[:, :plen], prompt):
                raise RuntimeError(f"/v1/generate prompt {plen}: bad tokens shape {tuple(out.shape)}")
            if int(out.max()) >= cfg.vocab_size or attn.flash_attention.launches != before:
                raise RuntimeError("/v1/generate: token out of vocab, or the cached path "
                                   "launched the cache-free kernel")
            log(f"main: /v1/generate prompt {plen} + {NEW_TOKENS} greedy: 200 in {secs:.3f} s, "
                f"{NEW_TOKENS / secs:.1f} tokens/s (prefill included)")
            stats[f"generate_s_{plen}"] = secs
        stats["flash_launches"] = attn.flash_attention.launches
        if on_card:
            stats["max_memory_allocated_gb"] = torch.cuda.max_memory_allocated() / 1e9
            log(f"main: torch.cuda.max_memory_allocated "
                f"{stats['max_memory_allocated_gb']:.3f} GB")
        log(f"main: flash_attention launches on the main path: {stats['flash_launches']}")

        # outside the counted run: the kernel path against the plain path in-process
        tokens, http_argmax = forwards[FORWARD_SHAPES[0]]
        with torch.inference_mode():
            tok = tokens.to(device)
            flash = llama.forward(server.params, tok, server.cfg)[0].float()
            plain = llama.forward(server.params, tok, server.cfg, attention_impl="reference")[0]
            plain = plain.float()
        am_flash = flash.argmax(-1).cpu()
        if not torch.equal(am_flash, http_argmax):
            raise RuntimeError("in-process kernel-path argmax differs from /v1/forward's")
        top2 = plain.topk(2, dim=-1).values
        margin = (top2[..., 0] - top2[..., 1]).cpu()
        clear = margin > MARGIN_TOL
        agree = am_flash == plain.argmax(-1).cpu()
        max_diff = float((flash - plain).abs().max())
        n_clear, n_bad = int(clear.sum()), int((clear & ~agree).sum())
        log(f"main: kernel vs plain path on {list(tokens.shape)}: max |logit diff| "
            f"{max_diff:.4f} (logit max {float(plain.abs().max()):.2f}); argmax agrees at "
            f"{int(agree.sum())}/{agree.numel()} positions, at {n_clear - n_bad}/{n_clear} "
            f"whose top-2 margin > {MARGIN_TOL}")
        if n_bad or n_clear == 0:
            raise RuntimeError("kernel-path argmax disagrees with the plain path")
        if not (torch.isfinite(flash).all() and torch.isfinite(plain).all()):
            raise RuntimeError("non-finite logits")
        stats.update(logit_max_diff=max_diff, argmax_checked=n_clear)
    finally:
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
        shutil.rmtree(ckpt, ignore_errors=True)
    return stats


if __name__ == "__main__":
    sys.exit(main())
