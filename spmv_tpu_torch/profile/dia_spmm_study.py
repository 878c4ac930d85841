"""K2's two paths and the slab path's ring, side by side on one card.

    python -m spmv_tpu_torch.profile.dia_spmm_study [--out study.json]

At the shapes K2's callers run (poisson2d(4096²) with k = 4 and
poisson2d(1024²) with k = 8, float32 and float64; the CLI's k = 3 at
(1024²) and (4096²) and k = 16 at (1024²), float32) it times each
variant of ``dia_spmm_core`` alone: a CUDA graph of ``REPS`` launches,
each after a 64-MB fill that flushes the L2, less the graph of the fills
alone, the fastest of three replays.  The variants run in one order and
again in the reverse order, in one process:

- ``row``: the row path, where ``dia_spmm_plan`` allows it;
- ``slab``: the slab path as planned;
- ``slab_ring96k``: the slab path with its ring capped at 96 KB;
- ``slab_stages8``: the slab path with 8 stages a CTA where the ring
  holds them.

The ring's caps are ``ops.dia_kernels``' module constants, set for a
variant and restored after it.  Every Y is compared bit for bit with
the shape's first variant's.  One line a shape and variant (device ms of
both rounds, the share of the bound: data, offsets, X and Y once each
over 3.35 TB/s), then one JSON document.  Needs a CUDA device: exits 2
without one.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys

import torch

__all__ = ["main"]

REPS = 20
HBM_BPS = 3.35e12
SHAPES = ((4096, 4, (torch.float32, torch.float64)),
          (1024, 8, (torch.float32, torch.float64)),
          (1024, 3, (torch.float32,)),
          (4096, 3, (torch.float32,)),
          (1024, 16, (torch.float32,)))
# variant -> (path, the dia_kernels constants it sets)
VARIANTS = {"row": ("row", {}),
            "slab": ("slab", {}),
            "slab_ring96k": ("slab", {"SPMM_RING_BYTES": 96 * 1024}),
            "slab_stages8": ("slab", {"SPMM_STAGES": (8, 8)})}


@contextlib.contextmanager
def _constants(**values):
    from spmv_tpu_torch.ops import dia_kernels as dk

    keep = {k: getattr(dk, k) for k in values}
    for k, v in values.items():
        setattr(dk, k, v)
    dk.dia_spmm_plan.cache_clear()
    try:
        yield
    finally:
        for k, v in keep.items():
            setattr(dk, k, v)
        dk.dia_spmm_plan.cache_clear()


def _graph_ms(fn) -> float:
    """Device ms a call of fn: REPS calls in one CUDA graph, the fastest
    of three replays."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(REPS):
            fn()
    best = float("inf")
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / REPS)
    return best


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", default=None, help="write the JSON here too")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    from spmv_tpu_torch.io.generate import poisson2d
    from spmv_tpu_torch.models import DeviceDia, DiaMatrix
    from spmv_tpu_torch.ops import dia_spmm_core, dia_spmm_plan

    device = torch.device("cuda", 0)
    scratch = torch.empty(16 << 20, dtype=torch.float32, device=device)

    def flush():
        scratch.fill_(0.0)

    flush_ms = _graph_ms(flush)
    print(torch.cuda.get_device_name(device), flush=True)
    found = {}
    for grid, k, dtypes in SHAPES:
        host = DiaMatrix.from_matrix_market(poisson2d(grid, grid))
        for dt in dtypes:
            A = DeviceDia.from_host(host, dtype=dt, device=device)
            g = torch.Generator(device=device).manual_seed(26)
            X = torch.randn(A.num_columns, k, generator=g, device=device,
                            dtype=dt)
            Y = torch.empty(A.num_rows, k, device=device, dtype=dt)
            nbytes = sum(t.numel() * t.element_size()
                         for t in (A.data, A.offsets_dev, X, Y))
            bound_ms = nbytes / HBM_BPS * 1e3
            names = [n for n, (path, _) in VARIANTS.items()
                     if path != "row" or dia_spmm_plan(k, dt)["row_ok"]]
            shape = f"poisson2d({grid},{grid}) k={k} {str(dt)[6:]}"
            times, first = {n: [] for n in names}, None
            for name in names + names[::-1]:
                path, consts = VARIANTS[name]
                with _constants(**consts):
                    def run():
                        flush()
                        dia_spmm_core(A, X, out=Y, path=path)

                    times[name].append(_graph_ms(run) - flush_ms)
                    Y.fill_(float("nan"))
                    dia_spmm_core(A, X, out=Y, path=path)
                if first is None:
                    first = Y.clone()
                elif not torch.equal(Y, first):
                    print(f"{shape} {name}: Y differs from {names[0]}'s",
                          file=sys.stderr)
                    return 1
            for name in names:
                print(f"{shape} {name}: {times[name]} ms, "
                      f"{bound_ms / min(times[name]):.3f} of the "
                      f"{bound_ms:.4f}-ms bound", flush=True)
            found[shape] = {"bound_ms": bound_ms, "ms": times}
            del A, X, Y
    doc = json.dumps({"device": torch.cuda.get_device_name(device),
                      "reps": REPS, "shapes": found})
    if args.out:
        with open(args.out, "w") as f:
            f.write(doc)
    print(doc)
    return 0


if __name__ == "__main__":
    sys.exit(main())
