"""Does a ``torch.profiler`` capture keep every device record it should,
and how long after the process's first capture?

    python -m spmv_tpu_torch.profile.capture_study [--seconds 300]
        [--every 15] [--pad-ms 20]

In one long-lived process on the first CUDA device, every ``--every``
seconds it takes one capture in each of five ways of opening and closing
the window, each around the same work: an ``aten::add`` (a torch op:
its ``cpu_op`` event is on the host's own clock, its runtime and kernel
records on CUPTI's), then ``LAUNCHES`` K1 launches at poisson2d(1024²),
each followed by a synchronise, then another ``aten::add``.

- ``plain``: ``torch.profiler`` with a one-step warm-up, the device
  synchronised before the window opens and before it closes;
- ``trace``: ``capture.trace`` as shipped;
- ``pad_start`` / ``pad_end``: ``plain`` with ``--pad-ms`` of sleep just
  after the window opens / just before it closes;
- ``no_warmup``: ``plain`` whose window opens with the profiler, with no
  warm-up step.

For each capture, one JSON line: the seconds since the process's first
capture, K1's launches (its wrapper's counter) and its device records,
the ``aten::add`` kernels' records (2 expected), the launch records
(runtime and driver calls that enqueue device work), how many of them
have no device record and where they stand in the launches' time order,
the least and the median start of a device record minus its launch's,
the ``capture.summarize_capture`` verdict, and the skew of CUPTI's clock
against the host's: the least start of an ``aten::add``'s launch record
minus the start of its op (a few us when the clocks agree; negative when
CUPTI's runs early).  Needs a CUDA device: exits 2 without one.
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

__all__ = ["main"]

GRID = 1024
LAUNCHES = 83           # phase 34's K1 launches in a window
MODES = ("plain", "trace", "pad_start", "pad_end", "no_warmup")


@contextlib.contextmanager
def _window(directory, device, pad_start=0.0, pad_end=0.0, warmup=1):
    """``torch.profiler`` over the block, into one Chrome trace in
    ``directory``: a ``warmup``-step warm-up with no work, then the
    window."""
    from torch.profiler import ProfilerActivity, profile, schedule

    from spmv_tpu_torch.profile.capture import CAPTURE_SUFFIX

    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"{time.time_ns()}{CAPTURE_SUFFIX}")
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True,
                 schedule=schedule(wait=0, warmup=warmup, active=1),
                 on_trace_ready=lambda p: p.export_chrome_trace(path)
                 ) as prof:
        for _ in range(warmup):
            torch.cuda.synchronize(device)
            prof.step()
        time.sleep(pad_start)
        yield
        torch.cuda.synchronize(device)
        time.sleep(pad_end)


def _reading(path: str, k1_launches: int) -> dict:
    """The counts and the clock skew of one capture."""
    from spmv_tpu_torch.profile.capture import (
        _is_launch,
        find_capture_file,
        summarize_capture,
    )

    fn = find_capture_file(path)
    with open(fn) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X"]
    device = [e for e in events
              if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    k1 = [e for e in device if "dia_spmv" in e["name"]]
    adds = [e for e in events
            if e.get("cat") == "cpu_op" and e["name"] == "aten::add"]
    add_ids = {(e.get("args") or {}).get("External id") for e in adds}
    add_kernels = [e for e in device
                   if (e.get("args") or {}).get("External id") in add_ids]
    launches = [e for e in events if _is_launch(e)]
    recorded = {(e.get("args") or {}).get("correlation") for e in device}
    launches.sort(key=lambda e: e["ts"])
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
    try:
        summary = summarize_capture(fn)
        verdict = "ok: " + ", ".join(
            f"{p['name']} events_lost {p['events_lost']}"
            for p in summary["planes"] if "events_lost" in p)
    except Exception as e:  # noqa: BLE001 — the verdict is the reading
        verdict = f"{type(e).__name__}: {e}"
    return {"k1_launches": k1_launches, "k1_records": len(k1),
            "add_records": len(add_kernels),
            "launch_records": len(launches),
            "launch_records_unmatched": len(lost_at),
            "lost_at": lost_at,
            "record_minus_launch_us": ([lags[0], lags[len(lags) // 2]]
                                       if lags else None),
            "cupti_minus_host_us": min(skews) if skews else None,
            "summary": verdict}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seconds", type=float, default=300.0)
    p.add_argument("--every", type=float, default=15.0)
    p.add_argument("--pad-ms", type=float, default=20.0)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    from spmv_tpu_torch.io.generate import poisson2d
    from spmv_tpu_torch.models import DiaMatrix
    from spmv_tpu_torch.models.device import DeviceDia
    from spmv_tpu_torch.ops import dia_spmv, dia_spmv_core
    from spmv_tpu_torch.profile.capture import trace

    device = torch.device("cuda", 0)
    A = DeviceDia.from_host(DiaMatrix.from_matrix_market(
        poisson2d(GRID, GRID)), dtype=torch.float32, device=device)
    x = torch.ones(A.num_columns, device=device)
    dia_spmv(A, x)
    pad = args.pad_ms / 1e3
    opens = {"plain": lambda d: _window(d, device),
             "trace": lambda d: trace(d, device),
             "pad_start": lambda d: _window(d, device, pad_start=pad),
             "pad_end": lambda d: _window(d, device, pad_end=pad),
             "no_warmup": lambda d: _window(d, device, warmup=0)}
    tmp = tempfile.mkdtemp(prefix="capture_study_")
    first = None
    n = 0
    while first is None or time.monotonic() - first < args.seconds:
        round_t0 = time.monotonic()
        for mode in MODES:
            d = os.path.join(tmp, f"{mode}_{n}")
            before = dia_spmv_core.launches
            if first is None:
                first = time.monotonic()
            since = time.monotonic() - first
            with opens[mode](d):
                x.add(1.0)
                for _ in range(LAUNCHES):
                    dia_spmv(A, x)
                    torch.cuda.synchronize(device)
                x.add(1.0)
            print(json.dumps({"mode": mode, "seconds_since_first": since,
                              **_reading(d, dia_spmv_core.launches
                                         - before)}), flush=True)
        n += 1
        time.sleep(max(0.0, args.every - (time.monotonic() - round_t0)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
