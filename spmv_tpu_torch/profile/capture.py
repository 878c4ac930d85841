"""Profiler capture and its summary: the port's counterpart of
``spmv_tpu/profile/xplane.py``.

The reference's profiling report carries measured per-thread hardware
event groups (src/util/perf-events.cpp:382-441) as a
``profiling_events`` section (src/profile-kernel.cpp:376-391).  The JAX
package fills it from an XLA xplane capture; the port fills it from a
``torch.profiler`` capture: CUPTI's activity records of every kernel,
memcpy and memset the card ran, with their streams, durations and
launch stats, written as one Chrome trace (``*.pt.trace.json``).

``trace`` takes the capture (the CLI's ``--jax-profile DIR``, whose name
stays so both CLIs take the same flags).  ``summarize_capture`` reads it
with the standard library and aggregates events per (plane, line, event
name) into ``summarize_xplane``'s document: occurrence count, duration
statistics in the reference's sample shape (src/util/sample.hpp:138-165)
and each event's fraction of its plane's busy time.  Planes and lines:

- ``/device:GPU:<i>``: CUDA device i's kernel, memcpy and memset events
  (Kineto's categories ``kernel``, ``gpu_memcpy``, ``gpu_memset``), one
  line a stream (``stream <id>``).  Kernel names are demangled C++
  names (``void dia_spmv_kernel<float>(...)``): match by substring.
  Each such plane also counts ``events_lost``: the host's launch
  records (the runtime and driver calls that enqueue device work) whose
  ``correlation`` id has no device record in the capture.  A capture
  can lose device records (PERF.md §6); its counts are then short
  by that many.
- ``/host:CPU``: the host's events (``cpu_op`` and the CUDA runtime
  calls), one line a thread.  In a capture that lists no GPU it counts
  as the device plane, as the CPU backend's ``/host:CPU`` does in the
  JAX package; in one that lists a GPU it is a host plane, shown only
  with ``include_host``, so a card's capture never falls back to it.

Trace timestamps and durations are in microseconds; the summary's are in
nanoseconds.
"""

from __future__ import annotations

import contextlib
import glob
import json
import os
import re
import socket
import tempfile
import time
from typing import Optional

import torch

from spmv_tpu_torch.errors import ProfileError
from spmv_tpu_torch.utils.sample import Sample

__all__ = ["trace", "find_capture_file", "summarize_capture",
           "profiling_events_section", "op_bytes_accessed",
           "list_profile_events", "interval_union_ns"]

CAPTURE_SUFFIX = ".pt.trace.json"
HOST_PLANE = "/host:CPU"
# CUPTI activity kinds that are device work, by their Kineto category
_DEVICE_CATEGORIES = {"kernel", "gpu_memcpy", "gpu_memset"}
# the profiler's own span over the window, and host annotations that
# Kineto projects onto the device's timeline (they enclose kernels, and
# are no device work of their own)
_SKIP_CATEGORIES = {"Trace", "gpu_user_annotation"}
# host calls that enqueue device work, by their Kineto categories and
# names (cudaLaunchKernel, cuLaunchKernelEx, cudaMemcpyAsync, ...); each
# carries the ``correlation`` id of the device record it makes
_LAUNCH_CATEGORIES = {"cuda_runtime", "cuda_driver"}
_LAUNCH_RE = re.compile(r"Launch(?!HostFunc)|Memcpy|Memset")
# the profiler's step marker over the window (``trace``'s schedule), the
# counterpart of the xplane's "Steps" line the JAX package skips
_STEP_PREFIX = "ProfilerStep#"

# Measured per-op byte accounting: a ``cpu_op`` event recorded with
# shapes carries its tensor inputs' dims and element types ("Input
# Dims", "Input type", TypeMeta names).  Their sum is the bytes the op
# read, the counterpart of the JAX package's sum over an HLO signature's
# shapes; the event's duration over it is an achieved rate.  Outputs are
# not recorded, so an op's writes are not counted.
_TYPE_BYTES = {
    "bool": 1, "unsigned char": 1, "signed char": 1,
    "c10::Float8_e4m3fn": 1, "c10::Float8_e5m2": 1,
    "short int": 2, "c10::Half": 2, "c10::BFloat16": 2,
    "int": 4, "float": 4, "unsigned int": 4,
    "long int": 8, "double": 8, "c10::complex<float>": 8,
    "c10::complex<double>": 16,
}


def op_bytes_accessed(args: dict) -> Optional[int]:
    """Bytes of an op event's tensor inputs (its ``Input Dims`` times the
    width of its ``Input type``), or None when the event records no
    tensor input (a CUDA kernel event, or an op traced without shapes).

    A 0-d tensor counts one element; scalars, lists of tensors and
    inputs of an unknown type are not counted.
    """
    dims = args.get("Input Dims")
    types = args.get("Input type")
    if not isinstance(dims, list) or not isinstance(types, list):
        return None
    total = 0
    found = False
    for shape, tname in zip(dims, types):
        nbytes = _TYPE_BYTES.get(tname)
        if nbytes is None or not isinstance(shape, list) or not all(
                isinstance(d, int) for d in shape):
            continue
        found = True
        n = 1
        for d in shape:
            n *= d
        total += n * nbytes
    return total if found else None


# Forward-compatible passthrough, as in the JAX package: numeric event
# args of these names flow into the report unchanged (Kineto's
# ``est. achieved occupancy %``, a memcpy's ``bytes`` and ``memory
# bandwidth (GB/s)``).
_COUNTER_STAT_RE = re.compile(
    r"byte|flop|bandwidth|dma|stall|occupancy", re.IGNORECASE)


def interval_union_ns(intervals) -> float:
    """Total measure of a union of (start, end) intervals in ns.

    The exact busy time of a plane whose lines overlap (kernels on two
    streams, or host ops enclosing their children): sort by start,
    sweep, and sum merged extents.
    """
    if not intervals:
        return 0.0
    ivs = sorted(intervals)
    total = 0.0
    cur_s, cur_e = ivs[0]
    for s, e in ivs[1:]:
        if s > cur_e:
            total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    total += cur_e - cur_s
    return float(total)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# Kernels launched in ``trace``'s warm-up step, before the window opens.
# On an H100 (torch 2.11, CUDA 12.8) a capture loses the device records
# of the first kernels it could record: one more for every 15 s since the
# process's first capture, while their launch records stay (what
# ``events_lost`` counts).  Sleeping at either end of the window changes
# nothing; launches in the warm-up step take the loss in the window's
# place, so 1024 of them cover about four hours.  Some captures lose more
# all the same (python -m spmv_tpu_torch.profile.capture_study; PERF.md
# §6).
WARMUP_LAUNCHES = 1024


@contextlib.contextmanager
def trace(directory: str, device):
    """Capture the block with ``torch.profiler`` into one Chrome trace,
    ``<host>_<pid>.<ns>.pt.trace.json`` in ``directory``.

    Host activity always, CUDA activity on a CUDA ``device``, with the
    ops' input shapes.  The device is synchronised before the window
    opens, so no kernel enqueued earlier lands in it, and before it
    closes, so CUPTI has every kernel the window launched.  The profiler
    starts in a warm-up step, which on a CUDA device launches
    ``WARMUP_LAUNCHES`` one-element fills, and the window opens at the
    next step.  Yields the profiler.
    """
    from torch.profiler import ProfilerActivity, profile, schedule

    device = torch.device(device)
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"{socket.gethostname()}_{os.getpid()}."
                                   f"{time.time_ns()}{CAPTURE_SUFFIX}")
    _sync(device)
    with profile(activities=activities, record_shapes=True,
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda p: p.export_chrome_trace(path)
                 ) as prof:
        if device.type == "cuda":
            scratch = torch.zeros(1, device=device)
            for _ in range(WARMUP_LAUNCHES):
                scratch.fill_(0.0)
        _sync(device)
        prof.step()
        yield prof
        _sync(device)


def find_capture_file(path: str) -> str:
    """Newest ``*.pt.trace.json`` under a capture directory (or the file
    itself)."""
    if os.path.isfile(path):
        return path
    hits = glob.glob(os.path.join(path, "**", "*" + CAPTURE_SUFFIX),
                     recursive=True)
    if not hits:
        raise ProfileError(
            f"no *{CAPTURE_SUFFIX} capture found under {path!r}; pass the "
            "directory given to --jax-profile after a profiled run")
    return max(hits, key=os.path.getmtime)


def _load(fn: str) -> dict:
    with open(fn) as f:
        doc = json.load(f)
    if not isinstance(doc, dict) or "traceEvents" not in doc:
        raise ProfileError(f"{fn!r} is not a Chrome trace (no traceEvents)")
    return doc


def _planes(doc: dict) -> dict:
    """{plane name: {line name: [event, ...]}} of the trace's complete
    events, in the trace's order; device planes first, sorted."""
    threads = {}
    for ev in doc["traceEvents"]:
        if ev.get("ph") == "M" and ev.get("name") == "thread_name":
            threads[(ev.get("pid"), ev.get("tid"))] = ev["args"]["name"]
    planes: dict = {}
    for ev in doc["traceEvents"]:
        cat = ev.get("cat")
        if ev.get("ph") != "X" or cat in _SKIP_CATEGORIES or str(
                ev.get("name", "")).startswith(_STEP_PREFIX):
            continue
        args = ev.get("args") or {}
        if cat in _DEVICE_CATEGORIES:
            plane = f"/device:GPU:{args.get('device', ev.get('pid'))}"
            line = f"stream {args.get('stream', ev.get('tid'))}"
        else:
            plane = HOST_PLANE
            key = (ev.get("pid"), ev.get("tid"))
            line = threads.get(key, f"thread {ev.get('tid')}")
        planes.setdefault(plane, {}).setdefault(line, []).append(ev)
    return dict(sorted(planes.items(), key=lambda kv: (
        kv[0] == HOST_PLANE, kv[0])))


def _is_launch(ev: dict) -> bool:
    """A host record of a call that enqueues device work."""
    return (ev.get("ph") == "X" and ev.get("cat") in _LAUNCH_CATEGORIES
            and bool(_LAUNCH_RE.search(str(ev.get("name", ""))))
            and "correlation" in (ev.get("args") or {}))


def _events_lost(doc: dict) -> dict:
    """{device plane name: launch records without their device record}.

    A launch record names its device where Kineto gives one; else it is
    the capture's first GPU's (a process of the port drives one card).
    """
    recorded, launches = set(), []
    for ev in doc["traceEvents"]:
        args = ev.get("args") or {}
        if ev.get("ph") == "X" and ev.get("cat") in _DEVICE_CATEGORIES:
            recorded.add(args.get("correlation"))
        elif _is_launch(ev):
            launches.append(args)
    gpus = sorted(p.get("id", 0) for p in doc.get("deviceProperties") or [])
    if not gpus:
        return {}
    lost: dict = {f"/device:GPU:{g}": 0 for g in gpus}
    for args in launches:
        if args["correlation"] not in recorded:
            plane = f"/device:GPU:{args.get('device', gpus[0])}"
            lost[plane] = lost.get(plane, 0) + 1
    return lost


def _is_device_plane(name: str, doc: dict) -> bool:
    """A GPU's plane; the host's where the capture lists no GPU."""
    return name != HOST_PLANE or not doc.get("deviceProperties")


def summarize_capture(
    path: str,
    top_k: int = 25,
    include_host: bool = False,
) -> dict:
    """Aggregate a capture per (plane, line, event name).

    Returns {"capture": file, "planes": [{name, busy_ns,
    num_event_kinds, events_dropped_below_top_k, events: [{name, line,
    count, total_ns, duration_ns: {sample stats}, fraction_of_plane,
    ...}]}]}, ``summarize_xplane``'s document; a GPU's plane adds
    ``events_lost`` and is listed whenever it has events or lost some.
    Device planes only unless ``include_host``; zero-duration events
    are dropped.
    """
    fn = find_capture_file(path)
    doc = _load(fn)
    lost = _events_lost(doc)
    planes = _planes(doc)
    for name in lost:
        planes.setdefault(name, {})
    planes_out = []
    for name, lines in sorted(planes.items(), key=lambda kv: (
            kv[0] == HOST_PLANE, kv[0])):
        if not (_is_device_plane(name, doc) or include_host):
            continue
        per_op, counter_stats, op_bytes = {}, {}, {}
        intervals = []
        for line_name, events in lines.items():
            for ev in events:
                dur = float(ev.get("dur") or 0.0) * 1e3
                if dur <= 0.0:
                    continue
                key = (line_name, ev["name"])
                per_op.setdefault(key, []).append(dur)
                args = ev.get("args") or {}
                for sname, sval in args.items():
                    if isinstance(sval, (int, float)) and \
                            _COUNTER_STAT_RE.search(sname):
                        acc = counter_stats.setdefault(key, {})
                        acc[sname] = acc.get(sname, 0) + sval
                nbytes = op_bytes_accessed(args)
                if nbytes:
                    op_bytes.setdefault(key, []).append(nbytes)
                start = float(ev["ts"]) * 1e3
                intervals.append((start, start + dur))
        if not per_op and not lost.get(name):
            continue
        # lines overlap in wall time (streams run at once; host ops
        # enclose their children), so the exact busy time is the
        # measure of the union of the intervals, not their sum
        plane_busy = interval_union_ns(intervals)
        events = []
        for (line_name, op), durs in per_op.items():
            s = Sample(size=len(durs), values=tuple(durs), unit="ns")
            ev_doc = {
                "name": op,
                "line": line_name,
                "count": len(durs),
                "total_ns": float(sum(durs)),
                "duration_ns": s.to_json(),
                "fraction_of_plane": (
                    float(sum(durs)) / plane_busy if plane_busy else 0.0
                ),
            }
            # bytes a call from the recorded input shapes (the calls of
            # one name may differ in shape: their mean), over the
            # measured durations: achieved GB/s (bytes/ns == GB/s)
            nb = op_bytes.get((line_name, op))
            if nb:
                ev_doc["bytes_accessed"] = sum(nb) // len(nb)
                ev_doc["total_bytes"] = sum(nb)
                ev_doc["achieved_gb_per_s"] = sum(nb) / float(sum(durs))
            extra = counter_stats.get((line_name, op))
            if extra:
                ev_doc["counter_stats"] = extra
            events.append(ev_doc)
        events.sort(key=lambda e: -e["total_ns"])
        dropped = max(len(events) - top_k, 0)
        plane = {
            "name": name,
            "busy_ns": plane_busy,
            "num_event_kinds": len(events),
            "events_dropped_below_top_k": dropped,
            "events": events[:top_k],
        }
        if name in lost:
            plane["events_lost"] = lost[name]
        planes_out.append(plane)
    return {"capture": fn, "planes": planes_out}


def profiling_events_section(
    jax_profile_dir: Optional[str], top_k: int = 25
) -> Optional[dict]:
    """The report's ``profiling_events`` block, or an error marker.

    Mirrors profile-kernel.cpp:376-391's per-event blocks; never raises
    (a failed parse must not lose the timing report).
    """
    if not jax_profile_dir:
        return None
    try:
        return summarize_capture(jax_profile_dir, top_k=top_k)
    except Exception as e:  # noqa: BLE001 — report the parse failure
        return {"error": f"{type(e).__name__}: {e}"}


def _probe(directory: str) -> None:
    """Capture one DIA SpMV (K1 on the card) of poisson2d(64, 64) on the
    default device into ``directory``, after one untimed call that loads
    the kernel."""
    from spmv_tpu_torch.io.generate import poisson2d
    from spmv_tpu_torch.models import DiaMatrix
    from spmv_tpu_torch.models.device import (
        DeviceDia,
        default_device,
        default_value_dtype,
    )
    from spmv_tpu_torch.ops import dia_spmv

    device = default_device()
    A = DeviceDia.from_host(DiaMatrix.from_matrix_market(poisson2d(64, 64)),
                            dtype=default_value_dtype(), device=device)
    x = torch.ones(A.num_columns, dtype=A.data.dtype, device=device)
    dia_spmv(A, x)
    with trace(directory, device):
        dia_spmv(A, x)


def list_profile_events(capture: Optional[str] = None) -> dict:
    """Enumerate the profiler's event/stat namespace.

    The analogue of the reference's ``--list-perf-events``
    (src/util/perf-events.cpp:104-181): the capture's planes, their
    lines, each line's event count and the names and types of the args
    attached to its events, plus the fields ``summarize_capture``
    derives from them.  With no ``capture``, a DIA SpMV of
    poisson2d(64, 64) is profiled first on the default device, so the
    listing shows this device's namespace (on the card, a hand-written
    kernel's launch stats).
    """
    if capture is None:
        capture = tempfile.mkdtemp(prefix="spmv_tpu_torch_evlist_")
        _probe(capture)
    fn = find_capture_file(capture)
    planes = []
    for name, lines in _planes(_load(fn)).items():
        out = []
        for line_name, events in lines.items():
            statnames: dict = {}
            for ev in events:
                for sname, sval in (ev.get("args") or {}).items():
                    statnames.setdefault(sname, type(sval).__name__)
            out.append({
                "line": line_name,
                "num_events": len(events),
                "event_stats": [
                    {"name": k, "type": v}
                    for k, v in sorted(statnames.items())
                ],
            })
        planes.append({"plane": name, "lines": out})
    return {
        "capture": fn,
        "planes": planes,
        # what the report layer computes on top of the raw namespace
        "derived_event_fields": [
            "count", "total_ns", "duration_ns (sample statistics)",
            "fraction_of_plane",
            "bytes_accessed (Input Dims x Input type)",
            "total_bytes", "achieved_gb_per_s",
            "counter_stats (byte/flop/bandwidth/dma/stall/occupancy "
            "passthrough)",
        ],
    }
