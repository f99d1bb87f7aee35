"""Device timing: host clock around work that ends in ``block_until_ready``.

JAX dispatches asynchronously, so a timing that does not wait for the
device measures the enqueue.  Every helper here runs ``fn`` once to warm
up (compilation is set-up, not part of the window), then times ``iters``
calls that each end in ``jax.block_until_ready``.
"""

from __future__ import annotations

import time

import jax


def timed_seconds_per_iter(fn, iters: int = 8) -> float:
    """Mean wall seconds per call of ``fn`` after one warm-up call."""
    jax.block_until_ready(fn())
    t0 = time.perf_counter()
    for _ in range(iters):
        jax.block_until_ready(fn())
    return (time.perf_counter() - t0) / iters


def timed_throughput(fn, units_per_iter: int, iters: int = 8) -> float:
    """units/sec form of ``timed_seconds_per_iter``."""
    return units_per_iter / timed_seconds_per_iter(fn, iters)


def timed_spread(fn, units_per_iter: int, iters: int = 8, reps: int = 3
                 ) -> tuple[float, list[float]]:
    """(median, [min, max]) throughput over ``reps`` repeated windows, so
    run-to-run spread is reported beside the number."""
    vals = sorted(timed_throughput(fn, units_per_iter, iters)
                  for _ in range(reps))
    return vals[len(vals) // 2], [vals[0], vals[-1]]
