"""Machine-model ("trace") configuration.

Same JSON document schema as the reference (README.md:49-75,
src/trace-config.cpp:198-343):

```json
{
  "caches": {
    "L1-0": {"size": 32768, "line_size": 64, "parent": "L2-0"},
    ...
  },
  "num_numa_domains": 2,
  "thread_affinities": [
    {"thread": 0, "cpu": 0, "cache": "L1-0", "numa_domain": 0,
     "event_groups": [["l1-dcache-loads"], ...]},
    ...
  ]
}
```

Optional per-cache fields ``bandwidth`` / ``bandwidth_per_numa_domain``
and ``cache_miss_event`` are parsed and round-tripped like the
reference (which never uses them in computation either —
SURVEY.md L4 note).  Validation matches trace-config.cpp:96-127: every
parent must name an existing cache, every thread's cache must exist and
its numa_domain must be in range.

The port's copy of ``spmv_tpu/perfmodel/trace_config.py``: the same
code, importing the port's copies instead of the JAX package.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional

from spmv_tpu_torch.errors import TraceConfigError

__all__ = [
    "Cache",
    "ThreadAffinity",
    "TraceConfig",
    "parse_trace_config",
    "read_trace_config",
]


@dataclasses.dataclass(frozen=True)
class Cache:
    name: str
    size: int               # bytes
    line_size: int          # bytes
    parent: Optional[str]   # name of next level, None for last level
    bandwidth: Optional[float] = None
    bandwidth_per_numa_domain: tuple = ()
    cache_miss_event: str = ""

    @property
    def num_lines(self) -> int:
        # ceil(size / line_size), cache-trace.cpp:127.
        return (self.size + self.line_size - 1) // self.line_size

    def to_json(self) -> dict:
        d = {
            "size": self.size,
            "line_size": self.line_size,
            "parent": self.parent,
        }
        if self.bandwidth is not None:
            d["bandwidth"] = self.bandwidth
        if self.bandwidth_per_numa_domain:
            d["bandwidth_per_numa_domain"] = list(
                self.bandwidth_per_numa_domain
            )
        if self.cache_miss_event:
            d["cache_miss_event"] = self.cache_miss_event
        return d


@dataclasses.dataclass(frozen=True)
class ThreadAffinity:
    thread: int
    cpu: int
    cache: str              # first-level cache name
    numa_domain: int
    event_groups: tuple = ()  # tuple of tuples of event names

    def to_json(self) -> dict:
        d = {
            "thread": self.thread,
            "cpu": self.cpu,
            "cache": self.cache,
            "numa_domain": self.numa_domain,
        }
        if self.event_groups:
            d["event_groups"] = [list(g) for g in self.event_groups]
        return d


@dataclasses.dataclass(frozen=True)
class TraceConfig:
    caches: Dict[str, Cache]
    num_numa_domains: int
    thread_affinities: tuple  # tuple of ThreadAffinity
    name: str = ""
    description: str = ""

    def __post_init__(self):
        for c in self.caches.values():
            if c.parent is not None and c.parent not in self.caches:
                raise TraceConfigError(
                    f"cache {c.name!r}: parent {c.parent!r} does not exist"
                )
            if c.size <= 0 or c.line_size <= 0:
                raise TraceConfigError(
                    f"cache {c.name!r}: size and line_size must be positive"
                )
        ids = [t.thread for t in self.thread_affinities]
        if ids != list(range(len(ids))):
            # cache_trace and the reference-string generators index
            # per-thread arrays by the raw thread id, so ids must be
            # exactly 0..N-1 in order
            raise TraceConfigError(
                "thread ids must be 0..N-1 in order; got "
                f"{ids}"
            )
        for t in self.thread_affinities:
            if t.cache not in self.caches:
                raise TraceConfigError(
                    f"thread {t.thread}: cache {t.cache!r} does not exist"
                )
            if not (0 <= t.numa_domain < self.num_numa_domains):
                raise TraceConfigError(
                    f"thread {t.thread}: numa_domain {t.numa_domain} out of "
                    f"range [0, {self.num_numa_domains})"
                )
        # Cycle check along parent chains.
        for c in self.caches.values():
            seen = set()
            cur = c
            while cur.parent is not None:
                if cur.name in seen:
                    raise TraceConfigError(
                        f"cache parent cycle involving {cur.name!r}"
                    )
                seen.add(cur.name)
                cur = self.caches[cur.parent]

    @property
    def num_threads(self) -> int:
        return len(self.thread_affinities)

    def max_cache_size(self) -> int:
        """Largest cache (trace-config.cpp:164-173)."""
        return max((c.size for c in self.caches.values()), default=0)

    def numa_domains_of_threads(self) -> List[int]:
        return [t.numa_domain for t in self.thread_affinities]

    def cache_has_ancestor(self, cache_name: str, ancestor: str) -> bool:
        """Walk the parent chain (cache-trace.cpp:47-66), inclusive."""
        cur = self.caches[cache_name]
        while True:
            if cur.name == ancestor:
                return True
            if cur.parent is None:
                return False
            cur = self.caches[cur.parent]

    def active_threads(self, cache_name: str) -> List[int]:
        """Threads whose first-level cache has ``cache_name`` as an
        ancestor (cache-trace.cpp:68-90)."""
        return [
            t.thread
            for t in self.thread_affinities
            if self.cache_has_ancestor(t.cache, cache_name)
        ]

    def to_json(self) -> dict:
        return {
            "name": self.name,
            "description": self.description,
            "caches": {k: c.to_json() for k, c in self.caches.items()},
            "num_numa_domains": self.num_numa_domains,
            "thread_affinities": [
                t.to_json() for t in self.thread_affinities
            ],
        }


def parse_trace_config(doc: dict) -> TraceConfig:
    if not isinstance(doc, dict):
        raise TraceConfigError("trace config must be a JSON object")
    try:
        caches_doc = doc["caches"]
        num_numa = int(doc["num_numa_domains"])
        affinities_doc = doc["thread_affinities"]
    except KeyError as e:
        raise TraceConfigError(f"missing required key: {e}") from e

    caches = {}
    for name, c in caches_doc.items():
        try:
            caches[name] = Cache(
                name=name,
                size=int(c["size"]),
                line_size=int(c["line_size"]),
                parent=c.get("parent"),
                # explicit JSON nulls are valid in the reference's
                # schema (trace-config.cpp requires the keys, null OK)
                bandwidth=c.get("bandwidth"),
                bandwidth_per_numa_domain=tuple(
                    c.get("bandwidth_per_numa_domain") or ()
                ),
                cache_miss_event=c.get("cache_miss_event") or "",
            )
        except (KeyError, TypeError, ValueError) as e:
            raise TraceConfigError(f"invalid cache {name!r}: {e}") from e

    affinities = []
    for t in affinities_doc:
        try:
            affinities.append(
                ThreadAffinity(
                    thread=int(t["thread"]),
                    cpu=int(t["cpu"]),
                    cache=t["cache"],
                    numa_domain=int(t["numa_domain"]),
                    event_groups=tuple(
                        tuple(g) for g in (t.get("event_groups") or ())
                    ),
                )
            )
        except (KeyError, TypeError, ValueError) as e:
            raise TraceConfigError(f"invalid thread affinity: {e}") from e

    return TraceConfig(
        caches=caches,
        num_numa_domains=num_numa,
        thread_affinities=tuple(affinities),
        name=doc.get("name", ""),
        description=doc.get("description", ""),
    )


def read_trace_config(path: str) -> TraceConfig:
    """Load and validate a trace config file
    (trace-config.cpp:386-404)."""
    try:
        with open(path) as f:
            doc = json.load(f)
    except OSError as e:
        raise TraceConfigError(f"cannot read {path!r}: {e}") from e
    except json.JSONDecodeError as e:
        raise TraceConfigError(f"invalid JSON in {path!r}: {e}") from e
    return parse_trace_config(doc)
