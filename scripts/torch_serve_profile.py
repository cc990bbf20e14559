#!/usr/bin/env python3
"""Where the serving path's time goes on the card (PyTorch/CUDA port).

    python3 scripts/torch_serve_profile.py [--out FILE]

Builds a seeded random Llama-3-8B-shaped model on the card (bf16, full
width and depth) and traces, with ``torch.profiler``, (a) the cache-free
forward that ``/v1/forward`` runs at [1, 2048] and [4, 512], (b) the greedy
decode ``/v1/generate`` runs (prompt 128 + 32 tokens, through the ragged
decode with one row length, as the server calls it), and (c) the same decode
sampled (temperature 0.8, top_k 40, top_p 0.95, seed 7). For each window it
reports the host wall time (ending in a synchronize), the device's busy
time (the union of kernel intervals), the idle share, and kernel time by
class: the port's flash kernel, matrix products (cuBLAS), and the rest.
Prints one JSON line last; needs one CUDA card. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _classify(name: str) -> str:
    n = name.lower()
    if "flash_fwd" in n:
        return "flash_attention"
    if any(k in n for k in ("gemm", "xmma", "cutlass", "nvjet", "cublas")):
        return "matmul"
    if "memcpy" in n or "memset" in n:
        return "copy"
    return "other"


def _window(fn, steps: int = 1) -> dict:
    """Trace ``fn`` once (after the caller warmed it up)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans = []
    by_class: dict[str, float] = {}
    launches: dict[str, int] = {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        start, end = e.time_range.start, e.time_range.end
        spans.append((start, end))
        c = _classify(e.name)
        by_class[c] = by_class.get(c, 0.0) + (end - start)
        launches[c] = launches.get(c, 0) + 1
    spans.sort()
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    if not spans:
        raise RuntimeError("torch.profiler recorded no device activity")
    return {
        "wall_ms": wall_us / 1e3,
        "device_busy_ms": busy / 1e3,
        "idle_share": max(0.0, 1.0 - busy / wall_us),
        "kernel_ms_by_class": {k: v / 1e3 for k, v in sorted(by_class.items())},
        "kernels_by_class": dict(sorted(launches.items())),
        "per_step_wall_ms": wall_us / 1e3 / steps,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="", help="also write the JSON result here")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("torch_serve_profile: needs a CUDA card", file=sys.stderr)
        return 2
    from modelx_tpu_torch.models import llama

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "unknown"
    print(card, flush=True)
    cfg = llama.LlamaConfig.llama3_8b()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = llama.init_params(cfg, gen, dtype=torch.bfloat16)
    rng = torch.Generator().manual_seed(1)
    result = {"card": card, "layers": cfg.num_layers}
    with torch.inference_mode():
        for b, s in ((1, 2048), (4, 512)):
            tok = torch.randint(0, cfg.vocab_size, (b, s), generator=rng).cuda()

            def fwd(tok=tok):
                llama.forward(params, tok, cfg)[0].argmax(-1).cpu()

            fwd()
            result[f"forward_{b}x{s}"] = _window(fwd)
        prompt = torch.randint(0, cfg.vocab_size, (1, 128), generator=rng).cuda()

        # 128 is a whole 16-bucket: the server's padded prompt is this one
        def gen32():
            llama.ragged_greedy_generate(params, prompt, [128], cfg, max_new_tokens=32).cpu()

        gen32()
        result["generate_128+32"] = _window(gen32, steps=32)

        def sampled32():
            llama.ragged_greedy_generate(params, prompt, [128], cfg, max_new_tokens=32,
                                         temperature=[0.8], top_k=[40], top_p=[0.95],
                                         seeds=[7]).cpu()

        sampled32()
        result["sampled_128+32"] = _window(sampled32, steps=32)
    for k, v in result.items():
        if isinstance(v, dict):
            print(f"{k}: wall {v['wall_ms']:.2f} ms, device busy {v['device_busy_ms']:.2f} ms, "
                  f"idle {v['idle_share'] * 100:.1f}%, kernel ms {v['kernel_ms_by_class']}, "
                  f"kernels {v['kernels_by_class']}", flush=True)
    line = json.dumps(result)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
