#!/usr/bin/env python3
"""Does a ``torch.profiler`` window leave the process slower once it ends?

Times eager kernel launches on the card (a chain of small elementwise ops
on a 4-element tensor, synchronized at the end: the host's launch path,
which bounds the port's decode) in ``--groups`` groups before any
``utils/trace.torch_profile`` window with CUDA activity, then as many after
each of ``--windows`` windows; ``--control`` runs the same groups with no
window between them (the process's own drift). Prints one JSON line: the
median microseconds per launch before and after each window, and each
median's ratio to the first. ``torch_profile`` sets ``TEARDOWN_CUPTI=1``
unless it is set: run with ``TEARDOWN_CUPTI=0`` to see a window that leaves
CUPTI subscribed.

    python3 scripts/torch_profiler_overhead.py [--control] [--windows 4]

Needs a card: it exits non-zero without CUDA.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def launch_us(n: int) -> float:
    """Microseconds per launch of ``n`` chained small adds."""
    import torch

    x = torch.zeros(4, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        x = x + 1
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e6


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--launches", type=int, default=20000)
    ap.add_argument("--groups", type=int, default=10)
    ap.add_argument("--windows", type=int, default=1)
    ap.add_argument("--control", action="store_true",
                    help="no profiler window between the two sides")
    args = ap.parse_args(argv)

    import torch

    from modelx_tpu_torch.utils import trace

    if not torch.cuda.is_available():
        print("torch_profiler_overhead: no CUDA device", file=sys.stderr)
        return 2
    import statistics

    def median_us() -> float:
        return statistics.median(launch_us(args.launches) for _ in range(args.groups))

    launch_us(1000)  # warm the allocator and the launch path
    out = {"device": torch.cuda.get_device_name(0), "control": args.control,
           "env": {k: v for k, v in os.environ.items() if "CUPTI" in k or "KINETO" in k},
           "us": [median_us()], "window_s": []}
    with tempfile.TemporaryDirectory() as tmp:
        for i in range(args.windows):
            t0 = time.monotonic()
            if not args.control:
                with trace.torch_profile(os.path.join(tmp, str(i))):
                    launch_us(1000)
            out["window_s"].append(time.monotonic() - t0)
            out["us"].append(median_us())
    out["ratio"] = [round(u / out["us"][0], 3) for u in out["us"]]
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
