"""Where the time of a DIA conjugate-gradient iteration goes.

    python -m spmv_tpu_torch.profile.cg_breakdown [--trace-dir DIR]

For poisson2d(1024, 1024) (1M rows: its vectors and diagonals fit the
H100's L2) and poisson2d(4096, 4096) (16.8M rows: streams from device
memory), in float32 on the first CUDA device:

- seconds per CG iteration with K1's fused p.Ap dot and with a separate
  ``torch.dot`` (``dia_conjugate_gradient(fused=True | False)``): the
  slope between two fixed iteration counts (tolerance 0), so set-up
  cancels; device time from CUDA events and host wall time beside it;
- a ``torch.profiler`` table of one fixed-length fused solve and of a
  chain of K1 launches: device time per kernel, and the device's busy
  share of the traced window (kernel time over the window's host time).

With ``--trace-dir`` each traced window is also written as a Chrome
trace.  Needs a CUDA device: exits 2 without one.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import torch

__all__ = ["cg_seconds_per_iteration", "traced", "main"]

GRIDS = (1024, 4096)
ITERATIONS = 50          # CG iterations counted per timing and per trace
# the shorter timed solve runs this many iterations, so the slope leaves
# the set-up out
_BASE_ITERATIONS = 10


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _solve(A, b, iterations: int, fused: bool):
    from spmv_tpu_torch.ops import dia_conjugate_gradient

    return dia_conjugate_gradient(A, b, tol=0.0, max_iterations=iterations,
                                  path="pallas", fused=fused)


def _times(fn, device: torch.device) -> tuple[float, float]:
    """(device seconds, host seconds) of ``fn()``; the device time is the
    host time on the CPU."""
    _sync(device)
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        fn()
        end.record()
        end.synchronize()
        wall = time.perf_counter() - t0
        return start.elapsed_time(end) * 1e-3, wall
    t0 = time.perf_counter()
    fn()
    wall = time.perf_counter() - t0
    return wall, wall


def cg_seconds_per_iteration(A, b, fused: bool, iterations: int,
                             runs: int = 3) -> tuple[float, float]:
    """(device, host) seconds per CG iteration: the slope between solves
    of ``_BASE_ITERATIONS`` and ``_BASE_ITERATIONS + iterations``
    iterations, the fastest of ``runs`` each."""
    device = b.device
    n1, n2 = _BASE_ITERATIONS, _BASE_ITERATIONS + iterations
    for n in (n1, n2):
        res = _solve(A, b, n, fused)
        if res.iterations != n:
            raise RuntimeError(f"CG stopped after {res.iterations} of {n} "
                               "iterations at tolerance 0")
    short = [_times(lambda: _solve(A, b, n1, fused), device)
             for _ in range(runs)]
    long = [_times(lambda: _solve(A, b, n2, fused), device)
            for _ in range(runs)]
    return tuple((min(t[i] for t in long) - min(t[i] for t in short))
                 / iterations for i in (0, 1))


def traced(fn, device: torch.device, trace_path: str = None):
    """Run ``fn()`` under ``torch.profiler``.  Returns (host seconds of
    the window, device seconds of its kernels, the per-kernel table)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    _sync(device)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        fn()
        _sync(device)
        wall = time.perf_counter() - t0
    if trace_path:
        prof.export_chrome_trace(trace_path)
    events = prof.key_averages()
    device_us = sum(e.self_device_time_total for e in events
                    if e.device_type == DeviceType.CUDA)
    table = events.table(sort_by="self_device_time_total"
                         if device.type == "cuda" else "self_cpu_time_total",
                         row_limit=12, max_name_column_width=60)
    return wall, device_us * 1e-6, table


def _k1_chain(A, x, length: int):
    from spmv_tpu_torch.ops import dia_spmv_core

    bufs = (x, torch.empty_like(x))

    def run():
        for i in range(length):
            dia_spmv_core(A, bufs[i % 2], out=bufs[(i + 1) % 2])

    return run


def breakdown(grid: int, iterations: int, device: torch.device,
              trace_dir: str = None, say=print) -> dict:
    """Time and trace CG and a K1 chain on poisson2d(grid, grid) in
    float32; returns the numbers it printed."""
    from spmv_tpu_torch.io.generate import poisson2d
    from spmv_tpu_torch.models import DiaMatrix
    from spmv_tpu_torch.models import DeviceDia
    from spmv_tpu_torch.ops import spmv

    host = DiaMatrix.from_matrix_market(poisson2d(grid, grid))
    A = DeviceDia.from_host(host, dtype=torch.float32, device=device)
    b = spmv(A, torch.ones(A.num_columns, dtype=torch.float32,
                           device=device))
    out = {}
    for fused in (True, False):
        dev_s, host_s = cg_seconds_per_iteration(A, b, fused, iterations)
        out[f"cg_fused={fused}"] = dev_s
        say(f"CG poisson2d({grid}) fused={fused}: {dev_s * 1e6:.2f} "
            f"us/iteration (events), {host_s * 1e6:.2f} us host wall")

    def path(name):
        return os.path.join(trace_dir, f"{name}.json") if trace_dir else None

    windows = (
        (f"cg_{grid}", lambda: _solve(A, b, iterations, True), iterations),
        (f"k1_chain_{grid}", _k1_chain(A, b.clone(), iterations),
         iterations),
    )
    for name, fn, count in windows:
        fn()                                   # warm, outside the window
        wall, dev, table = traced(fn, device, path(name))
        out[name] = {"wall_s": wall, "device_s": dev}
        say(f"== {name}: wall {wall * 1e3:.3f} ms, device {dev * 1e3:.3f} "
            f"ms ({dev / count * 1e6:.2f} us per iteration), busy share "
            f"{dev / wall:.3f}, idle share {1 - dev / wall:.3f}")
        say(table)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m spmv_tpu_torch.profile.cg_breakdown",
        description=__doc__.split("\n\n")[0])
    p.add_argument("--trace-dir", default=None,
                   help="write each traced window here as a Chrome trace")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("cg_breakdown: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0].strip(), flush=True)
    if args.trace_dir:
        os.makedirs(args.trace_dir, exist_ok=True)
    for grid in GRIDS:
        breakdown(grid, ITERATIONS, device, args.trace_dir,
                  say=lambda s: print(s, flush=True))
        _sync(device)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
