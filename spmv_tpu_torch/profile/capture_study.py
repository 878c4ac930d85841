"""Does a ``torch.profiler`` capture keep every device record it should,
and how long after the process's first capture?

    python -m spmv_tpu_torch.profile.capture_study [--seconds 600]
        [--every 15] [--pad-ms 20] [--modes plain,trace,...]

In one long-lived process on the first CUDA device, every ``--every``
seconds it takes one capture in each of several ways of opening and
closing the window, each around the same work: an ``aten::add`` (a
torch op: its ``cpu_op`` event is on the host's own clock, its runtime
and kernel records on CUPTI's), then ``LAUNCHES`` K1 launches at
poisson2d(1024²), each followed by a synchronise, then another
``aten::add``.

- ``plain``: ``torch.profiler`` with a one-step warm-up, the device
  synchronised before the window opens and before it closes;
- ``trace``: ``capture.trace`` as shipped;
- ``pad_start`` / ``pad_end``: ``plain`` with ``--pad-ms`` of sleep just
  after the window opens / just before it closes;
- ``warmup_sleep``: ``plain`` with ``--pad-ms`` of sleep in the warm-up
  step (the profiler on, the window not yet open, no launch);
- ``warmup_fills``: ``plain`` with ``WARMUP_FILLS`` one-element fills in
  the warm-up step (launches, and the time they take);
- ``no_warmup``: ``plain`` whose window opens with the profiler, with no
  warm-up step.

``warmup_sleep`` against ``warmup_fills`` tells a cut in time from a cut
in launches.  For each capture, one JSON line with three counts of K1's
device records for the same window: ``launch_records`` (the runtime and
driver calls that enqueue device work, from the exported trace),
``in_memory`` (the kernels among the activities that the profiler hands
back in memory before ``export_chrome_trace``: ``trace_activities()``,
and ``events()``' CUDA events) and ``exported`` (the trace's kernel
events); then the launches without a device record, their positions in
the launches' time order, and their starts against the profiler's start
(the trace's ``Trace`` span) and the window's (its ``ProfilerStep``
span), the least and the median start of a device record minus its
launch's, the ``capture.summarize_capture`` verdict, and the skew of
CUPTI's clock against the host's: the least start of an ``aten::add``'s
launch record minus the start of its op (a few us when the clocks
agree).  Needs a CUDA device: exits 2 without one.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import tempfile
import time

import torch

__all__ = ["main", "reading"]

GRID = 1024
LAUNCHES = 83           # phase 34's K1 launches in a window
WARMUP_FILLS = 1024     # capture.WARMUP_LAUNCHES, as shipped
MODES = ("plain", "trace", "pad_start", "pad_end", "warmup_sleep",
         "warmup_fills", "no_warmup")
K1_NAME = "dia_spmv"
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _in_memory(prof) -> dict:
    """K1's device records among what the profiler hands back in memory,
    before any export: Kineto's activities (``trace_activities``, where
    this torch has it) and the CUDA events of ``events()``."""
    res = prof.profiler.kineto_results
    out = {}
    acts = getattr(res, "trace_activities", None)
    if acts is not None:
        kernels = [a for a in acts() if str(a.type()).lower().endswith(
            "kernel") and K1_NAME in a.name()]
        out["activities"] = len(kernels)
    out["events"] = sum(
        1 for e in res.events()
        if e.device_type() == torch.autograd.DeviceType.CUDA
        and K1_NAME in e.name())
    return out


@contextlib.contextmanager
def _window(directory, device, pad_start=0.0, pad_end=0.0, warmup=1,
            warmup_sleep=0.0, warmup_fills=0, memo=None):
    """``torch.profiler`` over the block, into one Chrome trace in
    ``directory``: a ``warmup``-step warm-up (holding ``warmup_sleep``
    seconds of sleep and ``warmup_fills`` launches), then the window.
    ``memo`` receives the in-memory counts before the export."""
    from torch.profiler import ProfilerActivity, profile, schedule

    from spmv_tpu_torch.profile.capture import CAPTURE_SUFFIX

    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"{time.time_ns()}{CAPTURE_SUFFIX}")

    def ready(p):
        if memo is not None:
            memo.update(_in_memory(p))
        p.export_chrome_trace(path)

    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True,
                 schedule=schedule(wait=0, warmup=warmup, active=1),
                 on_trace_ready=ready) as prof:
        for _ in range(warmup):
            if warmup_fills:
                scratch = torch.zeros(1, device=device)
                for _ in range(warmup_fills):
                    scratch.fill_(0.0)
            time.sleep(warmup_sleep)
            torch.cuda.synchronize(device)
            prof.step()
        time.sleep(pad_start)
        yield
        torch.cuda.synchronize(device)
        time.sleep(pad_end)


@contextlib.contextmanager
def _shipped(directory, device, memo):
    from spmv_tpu_torch.profile.capture import trace

    with trace(directory, device) as prof:
        yield
    memo.update(_in_memory(prof))


def reading(path: str, k1_launches: int = None) -> dict:
    """The counts, the losses' places and the clock skew of one exported
    capture (a Chrome trace file or its directory)."""
    from spmv_tpu_torch.profile.capture import (
        _is_launch,
        find_capture_file,
        summarize_capture,
    )

    fn = find_capture_file(path)
    with open(fn) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X"]
    device = [e for e in events if e.get("cat") in _DEVICE_CATS]
    k1 = [e for e in device if K1_NAME in e["name"]]
    adds = [e for e in events
            if e.get("cat") == "cpu_op" and e["name"] == "aten::add"]
    add_ids = {(e.get("args") or {}).get("External id") for e in adds}
    add_kernels = [e for e in device
                   if (e.get("args") or {}).get("External id") in add_ids]
    launches = sorted((e for e in events if _is_launch(e)),
                      key=lambda e: e["ts"])
    recorded = {(e.get("args") or {}).get("correlation") for e in device}
    lost_at = [i for i, e in enumerate(launches)
               if e["args"]["correlation"] not in recorded]
    launched = {e["args"]["correlation"]: e["ts"] for e in launches}
    lags = sorted(e["ts"] - launched[e["args"]["correlation"]]
                  for e in device
                  if (e.get("args") or {}).get("correlation") in launched)
    skews = []
    for op in adds:
        xid = (op.get("args") or {}).get("External id")
        skews += [e["ts"] - op["ts"] for e in launches
                  if (e.get("args") or {}).get("External id") == xid]
    # the profiler's own span (its start) and the window's step span
    spans = {"profiler": [e["ts"] for e in events
                          if e.get("cat") == "Trace"],
             "window": [e["ts"] for e in events
                        if str(e.get("name", "")).startswith(
                            "ProfilerStep#")]}
    starts = {k: min(v) if v else None for k, v in spans.items()}
    lost_ts = [launches[i]["ts"] for i in lost_at]
    kept_ts = [e["ts"] for e in launches
               if e["args"]["correlation"] in recorded]
    device_ts = sorted(e["ts"] for e in device)

    def since(k, ts):
        return None if starts[k] is None or not ts else [
            ts[0] - starts[k], ts[-1] - starts[k]]

    try:
        summary = summarize_capture(fn)
        verdict = "ok: " + ", ".join(
            f"{p['name']} events_lost {p['events_lost']}"
            for p in summary["planes"] if "events_lost" in p)
    except Exception as e:  # noqa: BLE001 — the verdict is the reading
        verdict = f"{type(e).__name__}: {e}"
    return {"k1_launches": k1_launches, "exported": len(k1),
            "add_records": len(add_kernels),
            "launch_records": len(launches),
            "launch_records_unmatched": len(lost_at),
            "lost_at": lost_at,
            "lost_minus_profiler_us": since("profiler", lost_ts),
            "lost_minus_window_us": since("window", lost_ts),
            "kept_minus_window_us": since("window", kept_ts[:1]),
            "first_record_minus_profiler_us": since("profiler",
                                                    device_ts[:1]),
            "first_record_minus_window_us": since("window", device_ts[:1]),
            "window_minus_profiler_us": (
                None if None in starts.values()
                else starts["window"] - starts["profiler"]),
            "record_minus_launch_us": ([lags[0], lags[len(lags) // 2]]
                                       if lags else None),
            "cupti_minus_host_us": min(skews) if skews else None,
            "summary": verdict}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seconds", type=float, default=600.0)
    p.add_argument("--every", type=float, default=15.0)
    p.add_argument("--pad-ms", type=float, default=20.0)
    p.add_argument("--modes", default=",".join(MODES))
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    from spmv_tpu_torch.io.generate import poisson2d
    from spmv_tpu_torch.models import DiaMatrix
    from spmv_tpu_torch.models.device import DeviceDia
    from spmv_tpu_torch.ops import dia_spmv, dia_spmv_core

    device = torch.device("cuda", 0)
    A = DeviceDia.from_host(DiaMatrix.from_matrix_market(
        poisson2d(GRID, GRID)), dtype=torch.float32, device=device)
    x = torch.ones(A.num_columns, device=device)
    dia_spmv(A, x)
    pad = args.pad_ms / 1e3
    opens = {
        "plain": lambda d, m: _window(d, device, memo=m),
        "trace": lambda d, m: _shipped(d, device, m),
        "pad_start": lambda d, m: _window(d, device, pad_start=pad, memo=m),
        "pad_end": lambda d, m: _window(d, device, pad_end=pad, memo=m),
        "warmup_sleep": lambda d, m: _window(d, device, warmup_sleep=pad,
                                             memo=m),
        "warmup_fills": lambda d, m: _window(d, device,
                                             warmup_fills=WARMUP_FILLS,
                                             memo=m),
        "no_warmup": lambda d, m: _window(d, device, warmup=0, memo=m)}
    modes = [m for m in args.modes.split(",") if m]
    tmp = tempfile.mkdtemp(prefix="capture_study_")
    first = None
    n = 0
    while first is None or time.monotonic() - first < args.seconds:
        round_t0 = time.monotonic()
        for mode in modes:
            d = os.path.join(tmp, f"{mode}_{n}")
            before = dia_spmv_core.launches
            if first is None:
                first = time.monotonic()
            since = time.monotonic() - first
            memo = {}
            with opens[mode](d, memo):
                x.add(1.0)
                for _ in range(LAUNCHES):
                    dia_spmv(A, x)
                    torch.cuda.synchronize(device)
                x.add(1.0)
            print(json.dumps({"mode": mode, "seconds_since_first": since,
                              "in_memory": memo,
                              **reading(d, dia_spmv_core.launches
                                        - before)}), flush=True)
        n += 1
        time.sleep(max(0.0, args.every - (time.monotonic() - round_t0)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
