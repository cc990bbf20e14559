#!/usr/bin/env python3
"""The port's flash kernels against other builds of them, timed in one call.

    python3 scripts/torch_flash_ab.py --baseline NAME=DIR [--baseline NAME=DIR ...] [--out FILE]
        [--cases LABEL,LABEL] [--kernel forward|backward]

Each DIR holds a ``flash_attention.cu`` (with any headers it includes) that
exports ``mx_flash_attention`` (and, for ``--kernel backward``,
``mx_flash_attention_bwd``) with the port's C interface
(``kernels/build.py``'s ``ARGTYPES``, ``BWD_ARGTYPES``): an earlier
commit's ``modelx_tpu_torch/csrc/`` unpacked with ``git archive``, or a
copy of it with one change. Every ``.cu`` in DIR is compiled into the
baseline's library, with the port's nvcc flags, beside the port's own
library. Then, at each of ``chip_smoke.ATTN_CASES`` (the forward) or
``chip_smoke.BWD_CASES`` (the backward) on the smoke's inputs, every
library is checked against the fp32 plain version (``TOL``; the backward's
dq, dk, dv under ``BWD_TOL``, from the port's training forward's o and
lse) and timed in turns (the port, each baseline, each baseline again in
reverse, the port) by both of the smoke's methods: ``time_ms`` (CUDA
events around back-to-back calls) and ``time_call_ms`` (events around a
lone call, so the host's launch cost is in each sample). A baseline's
backward gets the port's workspace (``backward_workspace_floats``), which
holds at least the ``B * H * Sq`` floats an earlier interface took for
D_i. Baselines are yardsticks only; the port never builds them. Needs one
CUDA card; prints one JSON line last.
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


def timed_in_turns(chip_smoke, row, order, call, check, iters=20):
    """Check and time ``call(lib)`` for each library of ``order`` in turn
    into ``row["libs"]``; ``check(result)`` -> (max abs error, misses)."""
    for name, lib in order:
        r = row["libs"].setdefault(name, {"ms": [], "call_ms": []})
        try:
            result = call(lib)
        except RuntimeError as e:
            raise RuntimeError(f"{name} at {row['case']}: {e}") from e
        r["max_abs_err"], r["tol_misses"] = check(result)
        r["ms"].append(chip_smoke.time_ms(lambda: call(lib), iters=iters))
        r["call_ms"].append(chip_smoke.time_call_ms(lambda: call(lib), iters=iters))


def forward_row(chip_smoke, attn, i, case, libs, order):
    label, b, h, hkv, s, d, causal, scale, cap, window, dt = case
    q, k, v = chip_smoke.case_tensors(i)
    kw = dict(causal=causal, scale=scale, logit_softcap=cap, window=window)
    ref = attn.attention_reference(q.float(), k.float(), v.float(), **kw)
    atol, rtol = chip_smoke.TOL[dt]
    bound_ms, bound_by = chip_smoke.attention_bound(b, h, hkv, s, d, causal, window, dt)
    row = {"case": label, "shape": [b, h, s, d], "kv_heads": hkv, "dtype": dt,
           "bound_ms": bound_ms, "bound_by": bound_by, "libs": {}}

    def check(out):
        diff = (out.float() - ref).abs()
        return float(diff.max()), int((diff > atol + rtol * ref.abs()).sum())

    timed_in_turns(chip_smoke, row, [(n, libs[n]) for n in order],
                   lambda lib: attn._flash_cuda(q, k, v, causal, scale, cap, window, lib=lib),
                   check)
    return row


def backward_row(chip_smoke, attn, i, case, libs, order):
    label, b, h, hkv, s, d, causal, scale, cap, window, dt = case
    q, k, v, do = chip_smoke.bwd_case_tensors(i)
    kw = dict(causal=causal, scale=scale, logit_softcap=cap, window=window)
    out, lse = attn._flash_cuda(q, k, v, causal, scale, cap, window, with_lse=True)
    want = attn.attention_backward_reference(q.float(), k.float(), v.float(), out.float(),
                                             do.float(), lse, **kw)
    atol, rtol = chip_smoke.BWD_TOL[dt]
    bound_ms, bound_by = chip_smoke.backward_bound(b, h, hkv, s, d, causal, window, dt)
    row = {"case": label, "shape": [b, h, s, d], "kv_heads": hkv, "dtype": dt,
           "bound_ms": bound_ms, "bound_by": bound_by, "libs": {}}

    def check(grads):
        err, misses = 0.0, 0
        for got, ref in zip(grads, want):
            diff = (got.float() - ref).abs()
            err = max(err, float(diff.max()))
            misses += int((diff > atol * ref.abs().max() + rtol * ref.abs()).sum())
        return err, misses

    timed_in_turns(chip_smoke, row, [(n, libs[n]) for n in order],
                   lambda lib: attn._flash_bwd_cuda(q, k, v, out, do, lse, causal, scale, cap,
                                                    window, lib=lib),
                   check, iters=10)
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", type=parse_baseline, action="append", required=True,
                    metavar="NAME=DIR", help="a kernel source directory to time against")
    ap.add_argument("--out", default="", help="also write the JSON result here")
    ap.add_argument("--cases", default="",
                    help="comma list of case labels to time (default: all; a baseline older "
                         "than a case's head_dim cannot run it)")
    ap.add_argument("--kernel", choices=("forward", "backward"), default="forward",
                    help="the forward (chip_smoke.ATTN_CASES) or the backward "
                         "(chip_smoke.BWD_CASES)")
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
    table = chip_smoke.ATTN_CASES if args.kernel == "forward" else chip_smoke.BWD_CASES
    wanted = {c.strip() for c in args.cases.split(",") if c.strip()}
    unknown = wanted - {c[0] for c in table}
    if unknown:
        ap.error(f"unknown cases {sorted(unknown)}")
    rows = []
    for i, case in enumerate(table):
        if wanted and case[0] not in wanted:
            continue
        row = (forward_row if args.kernel == "forward" else backward_row)(
            chip_smoke, attn, i, case, libs, order)
        port = row["libs"][PORT]
        for name in names:
            base = row["libs"][name]
            # > 1: the port is that many times faster than the baseline
            base["speedup"] = statistics.mean(base["ms"]) / statistics.mean(port["ms"])
            base["call_speedup"] = (statistics.mean(base["call_ms"])
                                    / statistics.mean(port["call_ms"]))
        rows.append(row)
        print(f"{row['case']} (bound {row['bound_ms']:.4f} ms, {row['bound_by']}): " + "; ".join(
            f"{n} {r['ms']} ms back to back, {r['call_ms']} ms a lone call, "
            f"max_abs_err {r['max_abs_err']:.3e}, {r['tol_misses']} past TOL"
            for n, r in row["libs"].items()), flush=True)
    line = json.dumps({"card": device["card"], "torch": torch.__version__, "kernel": args.kernel,
                       "baselines": dict(args.baseline), "build_s": build_s, "cases": rows})
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
