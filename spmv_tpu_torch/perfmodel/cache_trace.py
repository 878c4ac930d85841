"""Cache-trace orchestration.

Equivalent of src/cache-trace.{hpp,cpp}: for every cache in the machine
model, determine the active threads (those whose first-level cache has
this cache on its parent chain), generate their reference strings,
replay the interleaved strings through an LRU model sized in cache
lines, and report misses per thread per NUMA domain — with an optional
uncounted warmup replay first (cache-trace.cpp:92-161).

The replay dispatches to the native C++ core when available.

The port's copy of ``spmv_tpu/perfmodel/cache_trace.py``: the same code,
importing the port's copies instead of the JAX package.
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Dict

import numpy as np

from spmv_tpu_torch.perfmodel.cache_sim import (
    LRU,
    trace_cache_misses_interleaved,
)
from spmv_tpu_torch.perfmodel.trace_config import TraceConfig
from spmv_tpu_torch.utils.jsonio import sanitize

__all__ = ["CacheTrace", "trace_cache_misses"]


@dataclasses.dataclass
class CacheTrace:
    """Simulation result (cache-trace.hpp:14-33): per cache, a
    (num_threads, num_numa_domains) miss matrix."""

    trace_config: TraceConfig
    kernel_info: dict
    warmup: bool
    cache_misses: Dict[str, np.ndarray]

    def to_json(self) -> dict:
        """Report shape mirrors operator<< (cache-trace.cpp:241-256)."""
        return sanitize({
            "trace_config": self.trace_config.to_json(),
            "kernel": self.kernel_info,
            "warmup": self.warmup,
            "cache_misses": {
                name: m.tolist() for name, m in self.cache_misses.items()
            },
        })


def trace_cache_misses(
    trace_config: TraceConfig,
    kernel,
    warmup: bool = False,
    verbose: bool = False,
    use_native: bool = True,
    progress_interval: float = 0.0,
) -> CacheTrace:
    """Simulate every cache in the config (cache-trace.cpp:163-187).

    ``progress_interval`` > 0 prints replay progress to stderr at most
    once per that many seconds (the reference's SIGALRM progress,
    replacement.cpp:65-93).
    """
    num_threads = trace_config.num_threads
    num_domains = trace_config.num_numa_domains

    cache_misses: Dict[str, np.ndarray] = {}
    for name, cache in trace_config.caches.items():
        threads = trace_config.active_threads(name)
        if not threads:
            cache_misses[name] = np.zeros(
                (num_threads, num_domains), dtype=np.int64
            )
            continue

        strings = []
        for t in threads:
            if verbose:
                print(
                    f"Tracing memory accesses of kernel "
                    f"{kernel.name} for cache {name} (thread {t})",
                    file=sys.stderr,
                )
            strings.append(
                kernel.memory_reference_string(
                    trace_config, t, num_threads
                )
            )

        if verbose:
            print(
                f"Simulating LRU cache replacement for cache {name}",
                file=sys.stderr,
            )

        progress = None
        if progress_interval > 0:
            def progress(done, total, is_warmup, _name=name):
                pct = 100.0 * done / total if total else 100.0
                phase = "warmup " if is_warmup else ""
                print(
                    f"Cache {_name}: {phase}replayed {done} of {total} "
                    f"memory references ({pct:.1f}%)",
                    file=sys.stderr,
                )

        misses = _replay(
            cache.num_lines, cache.line_size, strings, num_domains,
            warmup=warmup, use_native=use_native,
            progress=progress, progress_interval=progress_interval,
        )

        full = np.zeros((num_threads, num_domains), dtype=np.int64)
        for i, t in enumerate(threads):
            full[t] = misses[i]
        cache_misses[name] = full

    return CacheTrace(
        trace_config=trace_config,
        kernel_info=kernel.describe(),
        warmup=warmup,
        cache_misses=cache_misses,
    )


def _replay(num_lines, line_size, strings, num_domains, warmup, use_native,
            progress=None, progress_interval=0.0):
    if use_native:
        from spmv_tpu_torch.perfmodel import native

        if native.available():
            return native.replay_interleaved(
                0, num_lines, line_size, strings, num_domains,
                warmup=warmup,
                progress=progress, progress_interval=progress_interval,
            )
    alg = LRU(num_lines, line_size)
    if warmup:
        wp = ((lambda d, t, _w: progress(d, t, True))
              if progress else None)
        trace_cache_misses_interleaved(
            alg, strings, num_domains, use_native=False,
            progress=wp, progress_interval=progress_interval,
        )
    return trace_cache_misses_interleaved(
        alg, strings, num_domains, use_native=False,
        progress=progress, progress_interval=progress_interval,
    )
