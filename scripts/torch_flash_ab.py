#!/usr/bin/env python3
"""The port's flash kernel against other builds of it, timed in one call.

    python3 scripts/torch_flash_ab.py --baseline NAME=DIR [--baseline NAME=DIR ...] [--out FILE]
        [--cases LABEL,LABEL]

Each DIR holds a ``flash_attention.cu`` (with any headers it includes) that
exports ``mx_flash_attention`` with the port's C interface
(``kernels/build.py``'s ``ARGTYPES``): an earlier commit's
``modelx_tpu_torch/csrc/`` unpacked with ``git archive``, or a copy of it
with one change. Every ``.cu`` in DIR is compiled into the baseline's
library, with the port's nvcc flags, beside the port's
own library. Then, at each of ``chip_smoke.ATTN_CASES`` on the smoke's
inputs, every library is checked against the fp32 plain version and timed
in turns (the port, each baseline, each baseline again in reverse, the
port) by both of the smoke's methods: ``time_ms`` (CUDA events around
back-to-back calls) and ``time_call_ms`` (events around a lone call, so the
host's launch cost is in each sample). Baselines are yardsticks only; the
port never builds them. Needs one CUDA card; prints one JSON line last.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

PORT = "port"


def parse_baseline(spec: str) -> tuple[str, str]:
    """``NAME=DIR`` -> (NAME, DIR); DIR must hold ``flash_attention.cu``."""
    name, sep, path = spec.partition("=")
    if not sep or not name or name == PORT:
        raise argparse.ArgumentTypeError(f"want NAME=DIR with NAME != {PORT!r}, got {spec!r}")
    if not os.path.isfile(os.path.join(path, "flash_attention.cu")):
        raise argparse.ArgumentTypeError(f"no flash_attention.cu in {path!r}")
    return name, os.path.abspath(path)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", type=parse_baseline, action="append", required=True,
                    metavar="NAME=DIR", help="a kernel source directory to time against")
    ap.add_argument("--out", default="", help="also write the JSON result here")
    ap.add_argument("--cases", default="",
                    help="comma list of chip_smoke.ATTN_CASES labels to time (default: all; "
                         "a baseline older than a case's head_dim cannot run it)")
    args = ap.parse_args(argv)
    names = [n for n, _ in args.baseline]
    if len(set(names)) != len(names):
        ap.error(f"baseline names repeat: {names}")

    import torch

    if not torch.cuda.is_available():
        print("torch_flash_ab: needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke
    from modelx_tpu_torch.kernels import build
    from modelx_tpu_torch.ops import attention as attn

    device = chip_smoke.phase_device()
    libs = {PORT: build.load_library()}
    build_s = {}
    for name, path in args.baseline:
        t0 = time.monotonic()
        so = os.path.join(build.BUILD_DIR, "baselines", f"{name}.so")
        build.compile_library(path, so)
        build_s[name] = time.monotonic() - t0
        libs[name] = build.bind(so)
        print(f"built baseline {name} from {path} in {build_s[name]:.1f} s", flush=True)
    order = [PORT, *names, *reversed(names), PORT]

    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version is full fp32
    rows = []
    wanted = {c.strip() for c in args.cases.split(",") if c.strip()}
    unknown = wanted - {c[0] for c in chip_smoke.ATTN_CASES}
    if unknown:
        ap.error(f"unknown cases {sorted(unknown)}")
    for i, (label, b, h, hkv, s, d, causal, scale, cap, window, dt) in enumerate(
            chip_smoke.ATTN_CASES):
        if wanted and label not in wanted:
            continue
        q, k, v = chip_smoke.case_tensors(i)
        kw = dict(causal=causal, scale=scale, logit_softcap=cap, window=window)
        ref = attn.attention_reference(q.float(), k.float(), v.float(), **kw)
        atol, rtol = chip_smoke.TOL[dt]
        bound_ms, bound_by = chip_smoke.attention_bound(b, h, hkv, s, d, causal, window, dt)
        row = {"case": label, "shape": [b, h, s, d], "kv_heads": hkv, "dtype": dt,
               "bound_ms": bound_ms, "bound_by": bound_by, "libs": {}}
        for name in order:
            def call(lib=libs[name]):
                return attn._flash_cuda(q, k, v, causal, scale, cap, window, lib=lib)

            diff = (call().float() - ref).abs()
            r = row["libs"].setdefault(name, {"ms": [], "call_ms": []})
            r["max_abs_err"] = float(diff.max())
            r["tol_misses"] = int((diff > atol + rtol * ref.abs()).sum())
            r["ms"].append(chip_smoke.time_ms(call))
            r["call_ms"].append(chip_smoke.time_call_ms(call))
        port = row["libs"][PORT]
        for name in names:
            base = row["libs"][name]
            # > 1: the port is that many times faster than the baseline
            base["speedup"] = statistics.mean(base["ms"]) / statistics.mean(port["ms"])
            base["call_speedup"] = (statistics.mean(base["call_ms"])
                                    / statistics.mean(port["call_ms"]))
        rows.append(row)
        print(f"{label} (bound {bound_ms:.4f} ms, {bound_by}): " + "; ".join(
            f"{n} {r['ms']} ms back to back, {r['call_ms']} ms a lone call, "
            f"max_abs_err {r['max_abs_err']:.3e}, {r['tol_misses']} past TOL"
            for n, r in row["libs"].items()), flush=True)
        del q, k, v, ref, diff
    line = json.dumps({"card": device["card"], "torch": torch.__version__,
                       "baselines": dict(args.baseline), "build_s": build_s, "cases": rows})
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
