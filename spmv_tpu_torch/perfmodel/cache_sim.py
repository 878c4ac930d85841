"""Cache replacement simulation (LRU / FIFO / RAND).

Semantics match src/cache-simulation/ exactly:

- fully associative, line-granular: line = address // line_size;
- LRU (lru.cpp:31-54): hit moves the line to most-recently-used; miss
  inserts and evicts the least-recently-used when over capacity;
- FIFO (fifo.cpp:30-47): insertion order, no recency update on hit;
- RAND (rand.cpp:26-39): evicts an arbitrary resident line — the
  reference erases ``*begin()`` of an unordered_set (arbitrary but
  deterministic per run); we evict a deterministic pseudo-random
  resident line (xorshift64) so results are reproducible;
- interleaved multi-thread replay (replacement.cpp:41-95): at each
  step t, every thread p with t < len_p issues its t-th reference in
  thread order; misses are attributed to [thread][numa_domain].

The Python classes are the specification; the interleaved replay
dispatches to the C++ core (csrc/simcache.cpp via
spmv_tpu_torch.perfmodel.native) when available — that loop touches every
reference and is the simulator's hot path (SURVEY.md section 3.1).

The port's copy of ``spmv_tpu/perfmodel/cache_sim.py``: the same code,
importing the port's copies instead of the JAX package.
"""

from __future__ import annotations

from collections import OrderedDict, deque
from typing import List, Sequence, Tuple

import numpy as np

__all__ = [
    "LRU",
    "FIFO",
    "RAND",
    "trace_cache_misses_single",
    "trace_cache_misses_interleaved",
]


class ReplacementAlgorithm:
    def __init__(self, cache_lines: int, line_size: int):
        if cache_lines <= 0 or line_size <= 0:
            raise ValueError("cache_lines and line_size must be positive")
        self.cache_lines = int(cache_lines)
        self.line_size = int(line_size)

    def allocate(self, address: int, numa_domain: int = 0) -> int:
        """Replay one reference; returns 1 on miss, 0 on hit."""
        raise NotImplementedError

    name = "base"
    policy_id = -1


class LRU(ReplacementAlgorithm):
    name = "LRU"
    policy_id = 0

    def __init__(self, cache_lines, line_size, initial_state=()):
        super().__init__(cache_lines, line_size)
        self._lines = OrderedDict((int(l), None) for l in initial_state)

    def allocate(self, address, numa_domain: int = 0) -> int:
        line = int(address) // self.line_size
        if line in self._lines:
            self._lines.move_to_end(line)
            return 0
        self._lines[line] = None
        if len(self._lines) > self.cache_lines:
            self._lines.popitem(last=False)
        return 1

    @property
    def contents(self):
        return list(self._lines.keys())


class FIFO(ReplacementAlgorithm):
    name = "FIFO"
    policy_id = 1

    def __init__(self, cache_lines, line_size, initial_state=()):
        super().__init__(cache_lines, line_size)
        self._set = set(int(l) for l in initial_state)
        self._queue = deque(int(l) for l in initial_state)

    def allocate(self, address, numa_domain: int = 0) -> int:
        line = int(address) // self.line_size
        if line in self._set:
            return 0
        self._set.add(line)
        if len(self._set) > self.cache_lines:
            self._set.discard(self._queue.popleft())
        self._queue.append(line)
        return 1


class RAND(ReplacementAlgorithm):
    name = "RAND"
    policy_id = 2

    def __init__(self, cache_lines, line_size, initial_state=(), seed=1):
        super().__init__(cache_lines, line_size)
        self._set = set(int(l) for l in initial_state)
        self._list: List[int] = list(self._set)
        self._state = np.uint64(seed if seed else 1)

    def _next_rand(self) -> int:
        # xorshift64 — same generator as the C++ core.
        x = np.uint64(self._state)
        with np.errstate(over="ignore"):
            x ^= x << np.uint64(13)
            x ^= x >> np.uint64(7)
            x ^= x << np.uint64(17)
        self._state = x
        return int(x)

    def allocate(self, address, numa_domain: int = 0) -> int:
        line = int(address) // self.line_size
        if line in self._set:
            return 0
        if len(self._set) == self.cache_lines:
            victim_idx = self._next_rand() % len(self._list)
            victim = self._list[victim_idx]
            self._set.discard(victim)
            last = self._list.pop()
            if last != victim:
                self._list[victim_idx] = last
        self._set.add(line)
        self._list.append(line)
        return 1


def trace_cache_misses_single(
    alg: ReplacementAlgorithm,
    addresses: np.ndarray,
    numa_domains: np.ndarray,
    num_numa_domains: int,
) -> np.ndarray:
    """Replay one reference string; per-domain miss counts
    (replacement.cpp:18-32)."""
    misses = np.zeros(num_numa_domains, dtype=np.int64)
    for a, d in zip(addresses.tolist(), numa_domains.tolist()):
        misses[d] += alg.allocate(a, d)
    return misses


def trace_cache_misses_interleaved(
    alg: ReplacementAlgorithm,
    strings: Sequence[Tuple[np.ndarray, np.ndarray]],
    num_numa_domains: int,
    use_native: bool = True,
    progress=None,
    progress_interval: float = 0.0,
) -> np.ndarray:
    """Round-robin interleaved replay of P strings
    (replacement.cpp:41-95): step t issues ws[p][t] for each live p in
    thread order.  Returns (P, num_numa_domains) miss counts.

    Dispatches to the C++ core when available and the algorithm carries
    no pre-existing state; falls back to pure Python.

    ``progress(refs_done, refs_total, is_warmup)`` is invoked at most
    once per ``progress_interval`` seconds — the timer-thread analogue
    of the reference's SIGALRM progress printing
    (replacement.cpp:34-39,65-93).
    """
    P = len(strings)
    if use_native and getattr(alg, "policy_id", -1) >= 0:
        from spmv_tpu_torch.perfmodel import native

        if native.available() and _is_pristine(alg):
            return native.replay_interleaved(
                alg.policy_id,
                alg.cache_lines,
                alg.line_size,
                strings,
                num_numa_domains,
                seed=getattr(alg, "_state", 1),
                progress=progress,
                progress_interval=progress_interval,
            )

    import time

    misses = np.zeros((P, num_numa_domains), dtype=np.int64)
    lens = [a.size for a, _ in strings]
    t_max = max(lens, default=0)
    total = sum(lens)
    addr_lists = [a.tolist() for a, _ in strings]
    numa_lists = [d.tolist() for _, d in strings]
    done = 0
    last = time.monotonic()
    report = progress is not None and progress_interval > 0
    for t in range(t_max):
        for p in range(P):
            if t < lens[p]:
                d = numa_lists[p][t]
                misses[p, d] += alg.allocate(addr_lists[p][t], d)
                done += 1
        if report and t % 4096 == 0 and t:
            now = time.monotonic()
            if now - last >= progress_interval:
                last = now
                progress(done, total, False)
    return misses


def _is_pristine(alg: ReplacementAlgorithm) -> bool:
    """True when the algorithm holds no resident lines yet (the native
    core builds its own fresh state)."""
    if isinstance(alg, LRU):
        return not alg._lines
    if isinstance(alg, FIFO):
        return not alg._set
    if isinstance(alg, RAND):
        return not alg._set
    return False
