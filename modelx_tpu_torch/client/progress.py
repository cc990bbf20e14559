"""The bounded worker pool of the pull engine (counterpart of
``modelx_tpu/client/progress.py``): at most ``concurrency`` transfers in
flight, and the first failure cancels the jobs not yet started and
re-raises. The JAX package draws rich progress bars around the same pool;
the card's host has no rich, so the port draws none.
"""

from __future__ import annotations

from concurrent.futures import FIRST_EXCEPTION, ThreadPoolExecutor, wait
from typing import Callable, Iterable

# Blob-level transfer parallelism, as the JAX package's.
PULL_PUSH_CONCURRENCY = 8


def run_jobs(jobs: Iterable[Callable[[], None]],
             concurrency: int = PULL_PUSH_CONCURRENCY) -> None:
    """Run every job, at most ``concurrency`` at once; the first failure
    cancels the rest and raises."""
    with ThreadPoolExecutor(max_workers=concurrency) as pool:
        futures = [pool.submit(j) for j in jobs]
        done, not_done = wait(futures, return_when=FIRST_EXCEPTION)
        first_error = next((f.exception() for f in done if f.exception() is not None), None)
        if first_error is not None:
            for f in not_done:
                f.cancel()
            raise first_error
        for f in futures:
            if not f.cancelled() and f.exception() is not None:
                raise f.exception()
