"""What holds the ELL SpMV back, measured on the card.

    python -m spmv_tpu_torch.profile.ell_study [--out FILE]

At the two shapes the ELL kernel runs at on the port's paths, float32 on
the first CUDA device: poisson2d(4096²) (``-s ell``, width 5) and the
ELL part of the hybrid at powerlaw(2²², 2²², 8.0, alpha 1.5, seed 5)
(width 6).  Each time is device ms a call, a CUDA graph of 30 calls
with the L2 flushed before each (as ``chip_smoke.py`` times kernels).

- **Sweep** of the ELL SpMV (``csrc/ell_spmv.cu``, built here again with
  ``-DELL_SPMV_THREADS`` and ``-DELL_SPMV_MIN_BLOCKS``; the port launches
  it at R = 1, 256 threads, no cap): rows a thread R in {1, 2, 4} x threads a block in {128, 256, 512} x no register cap
  or 64 registers a thread (``__launch_bounds__``), each output bitwise
  the port's own kernel's; in float64 too, at R of 1 and 2.
- **Layout:** the kernel before the redesign (a thread a row, rounds of
  4 slots), as it was, and the redesigned rows at R of 1 and 4, over the
  slot-major buffers and over a copy cut into slices of 32 R rows, each
  slice's slots contiguous (one index and one value stream).
- **Gathers alone** at the hybrid: the ELL launch's x gathers without
  its index and value streams (a hashed column for each entry slot, x[0]
  for each padding slot), its practical ceiling.
- **One launch** for the hybrid SpMV (ELL slots, then the row's short
  COO entries, in the same thread; long COO rows on warps and blocks)
  against the port's two launches, bitwise.

The variants live in ``profile/ell_study.cu`` and are built by this
module with nvcc into ``spmv_tpu_torch/_build/study/``; none is on a
path of the port.  Prints one JSON object last (with ``--out`` it is
also written there, with ptxas's register counts of every build).  Needs a CUDA device and nvcc: exits 2 without one.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

__all__ = ["main"]

GRID = 4096
HYBRID_ROWS = 1 << 22
SWEEP_ROWS = (1, 2, 4)
SWEEP_THREADS = (128, 256, 512)
CAP_REGISTERS = 64        # the capped builds: blocks an SM = 65536 / (64 t)
REPS = 30
HERE = Path(__file__).resolve().parent

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def _build(out_dir: Path) -> tuple:
    """The study library at each (threads, capped) of the sweep, built
    side by side; returns ({(threads, capped): CDLL}, {(threads, capped):
    ptxas's register lines of its float32 ELL SpMV kernels})."""
    from spmv_tpu_torch.ops._build import (
        CSRC_DIR,
        NVCC_FLAGS,
        KernelBuildError,
        find_nvcc,
    )

    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    procs = {}
    for t in SWEEP_THREADS:
        for capped in (False, True):
            blocks = 65536 // (CAP_REGISTERS * t) if capped else 1
            so = out_dir / f"ell_study_{t}_{blocks}.so"
            cmd = [nvcc, *NVCC_FLAGS, "-shared", f"-I{CSRC_DIR}",
                   f"-DELL_SPMV_THREADS={t}",
                   f"-DELL_SPMV_MIN_BLOCKS={blocks}", "-o", str(so),
                   str(HERE / "ell_study.cu")]
            procs[(t, capped)] = (so, cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
    libs, regs = {}, {}
    for key, (so, cmd, proc) in procs.items():
        log = proc.communicate(timeout=900)[0]
        if proc.returncode != 0:
            raise KernelBuildError(f"{' '.join(cmd)}\n{log}")
        regs[key] = _registers(log)
        lib = ctypes.CDLL(str(so))
        lib.ell_study_rows_launch.argtypes = [_I, _P, _P, _I, _I, _I, _L,
                                              _L, _P, _P, _P]
        lib.ell_study_before_launch.argtypes = [_P, _P, _I, _L, _L, _I, _P,
                                                _P, _P]
        lib.ell_study_layout_launch.argtypes = [_P, _P, _I, _I, _I, _L, _L,
                                                _L, _P, _P, _P]
        lib.ell_study_gather_launch.argtypes = [_P, _I, _L, _L, _P, _P, _P]
        lib.ell_study_hybrid_launch.argtypes = [
            _P, _P, _I, _I, _I, _P, _P, _P, _L, _L, _P, _L, _L, _I, _P, _P,
            _P]
        libs[key] = lib
    return libs, regs


def _registers(log: str) -> list:
    """ptxas's register lines of the float32 ELL SpMV kernels (mangled
    names: ell_spmv_kernelIfLi<R>ELi<L>E)."""
    lines, name = [], None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1] if "'" in ln else None
        elif "Used" in ln and "registers" in ln and name and \
                "ell_spmv_kernelIf" in name:
            tail = name.split("ell_spmv_kernelIf")[1][:12]
            lines.append(f"{tail}: {ln.split(':', 1)[1].strip()}")
            name = None
    return lines


def _replay_ms(fn, reps: int) -> float:
    """Device ms a call: reps calls in one CUDA graph, the fastest of
    three replays."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(reps):
            fn()
    best = float("inf")
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / reps)
    return best


class _Timer:
    """Cold device ms a call: graphs of (flush, fn) less flush alone."""

    def __init__(self, device):
        self.scratch = torch.empty(16 << 20, dtype=torch.float32,
                                   device=device)
        self.flush_ms = None

    def __call__(self, fn) -> float:
        flush = lambda: self.scratch.fill_(0.0)  # noqa: E731
        if self.flush_ms is None:
            self.flush_ms = _replay_ms(flush, REPS)

        def both():
            flush()
            fn()

        return _replay_ms(both, REPS) - self.flush_ms


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _sliced(t: torch.Tensor, h: int) -> torch.Tensor:
    """(L, n) slot-major -> slices of h rows, each slice's L slots
    contiguous."""
    L, n = t.shape
    return t.view(L, n // h, h).permute(1, 0, 2).contiguous().view(-1)


def _spmv(lib, A, x, y, R):
    L = A.padded_row_length
    _check(lib.ell_study_rows_launch(
        {torch.float32: 0, torch.float64: 1}[A.value.dtype],
        A.column_index.data_ptr(), A.value.data_ptr(), L, L, R, A.num_rows,
        A.num_columns, x.data_ptr(), y.data_ptr(), _stream()),
        "ell_study_rows_launch")


def _sweep(libs, A, x, timer, want, sweep_rows=SWEEP_ROWS) -> list:
    rows = []
    for (t, capped), lib in libs.items():
        for R in sweep_rows:
            y = torch.empty_like(want)
            _spmv(lib, A, x, y, R)
            torch.cuda.synchronize()
            rows.append({"threads": t, "register_cap": CAP_REGISTERS if capped
                         else None, "rows_per_thread": R,
                         "ms": timer(lambda: _spmv(lib, A, x, y, R)),
                         "bitwise_equal": bool(torch.equal(y, want))})
            print(f"  sweep {rows[-1]}", flush=True)
    return rows


def _float64_sweep(libs, A, timer, g) -> list:
    """The sweep in float64 (R of 1 and 2: 16-byte value loads at most),
    each output bitwise the port's kernel's."""
    from spmv_tpu_torch.ops import ell_spmv_core

    x = torch.randn(A.num_columns, generator=g, device=A.value.device,
                    dtype=torch.float64)
    want = ell_spmv_core(A, x)
    return _sweep(libs, A, x, timer, want, sweep_rows=(1, 2))


def _layout(lib, A, x, timer, want) -> dict:
    """The kernel before the redesign and the redesigned rows (R of 1 and
    4) over the slot-major buffers and over slices of 32 R rows."""
    out = {}
    L, n = A.padded_row_length, A.num_rows
    y = torch.empty_like(want)
    for R, before in ((1, True), (1, False), (4, False)):
        for h in (0, 32 * R):
            cols = _sliced(A.column_index, h) if h else A.column_index
            vals = _sliced(A.value, h) if h else A.value

            def run():
                if before:
                    rc = lib.ell_study_before_launch(
                        cols.data_ptr(), vals.data_ptr(), L, n,
                        A.num_columns, h, x.data_ptr(), y.data_ptr(),
                        _stream())
                else:
                    rc = lib.ell_study_layout_launch(
                        cols.data_ptr(), vals.data_ptr(), L, L, R, n,
                        A.num_columns, h, x.data_ptr(), y.data_ptr(),
                        _stream())
                _check(rc, "layout")

            run()
            torch.cuda.synchronize()
            name = (f"{'before the redesign' if before else f'redesign R={R}'}"
                    f", {f'slices of {h} rows' if h else 'slot-major'}")
            out[name] = {"ms": timer(run),
                         "bitwise_equal": bool(torch.equal(y, want))}
            print(f"  layout {name}: {out[name]}", flush=True)
            del cols, vals
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", default=None, help="also write the JSON here")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("ell_study: no CUDA device", file=sys.stderr)
        return 2
    from spmv_tpu_torch.io.generate import poisson2d, powerlaw
    from spmv_tpu_torch.models import (
        DeviceEll,
        DeviceHybrid,
        EllMatrix,
        HybridMatrix,
    )
    from spmv_tpu_torch.ops import ell_spmv_core, hybrid_spmv_core
    from spmv_tpu_torch.ops._build import BUILD_DIR

    device = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"card: {smi}", flush=True)
    libs, regs = _build(BUILD_DIR / "study")
    for ln in regs[(256, False)]:
        print(f"  registers at 256 threads, no cap: {ln}", flush=True)
    f32 = torch.float32
    timer = _Timer(device)
    g = torch.Generator(device=device).manual_seed(7)
    found = {"card": smi, "registers": {
        f"{t} threads{', capped' if c else ''}": r
        for (t, c), r in regs.items()}}

    host = EllMatrix.from_matrix_market(poisson2d(GRID, GRID))
    A = DeviceEll.from_host(host, dtype=f32, device=device)
    x = torch.randn(A.num_columns, generator=g, device=device, dtype=f32)
    want = ell_spmv_core(A, x)
    found["poisson2d"] = {
        "kernel_ms": timer(lambda: ell_spmv_core(A, x, out=want)),
        "sweep": _sweep(libs, A, x, timer, want),
        "layout": _layout(libs[(256, False)], A, x, timer, want)}
    del A, x, want
    found["poisson2d"]["float64_sweep"] = _float64_sweep(
        libs, DeviceEll.from_host(host, dtype=torch.float64, device=device),
        timer, g)
    del host

    mm = powerlaw(HYBRID_ROWS, HYBRID_ROWS, 8.0, alpha=1.5, seed=5)
    lengths = np.bincount(np.asarray(mm.rows_1based) - 1,
                          minlength=mm.num_rows)
    host = HybridMatrix.from_matrix_market(mm)
    del mm
    H = DeviceHybrid.from_host(host, dtype=torch.float64, device=device)
    f64_sweep = _float64_sweep(libs, H.ell, timer, g)
    H = DeviceHybrid.from_host(host, dtype=f32, device=device)
    del host
    E, C = H.ell, H.coo
    L = E.padded_row_length
    x = torch.randn(H.num_columns, generator=g, device=device, dtype=f32)
    want = ell_spmv_core(E, x)
    hyb = {"kernel_ms": timer(lambda: ell_spmv_core(E, x, out=want)),
           "sweep": _sweep(libs, E, x, timer, want),
           "layout": _layout(libs[(256, False)], E, x, timer, want)}
    lib = libs[(256, False)]
    short = torch.from_numpy(np.minimum(lengths, L).astype(np.uint8)).to(
        device)
    y = torch.empty_like(want)

    def gathers():
        _check(lib.ell_study_gather_launch(
            short.data_ptr(), L, E.num_rows, E.num_columns, x.data_ptr(),
            y.data_ptr(), _stream()), "ell_study_gather_launch")

    hyb["gathers_alone_ms"] = timer(gathers)
    hyb["gathers"] = {"entries": int(np.minimum(lengths, L).sum()),
                      "slots": E.num_rows * L}
    print(f"  gathers alone: {hyb['gathers_alone_ms']} ms, "
          f"{hyb['gathers']}", flush=True)
    whole = hybrid_spmv_core(H, x)
    hyb["two_launches_ms"] = timer(lambda: hybrid_spmv_core(H, x, out=y))
    ones = {}
    for r in (1, 4):
        def one():
            _check(lib.ell_study_hybrid_launch(
                E.column_index.data_ptr(), E.value.data_ptr(), L, L, r,
                C.row_ptr.data_ptr(), C.column_index.data_ptr(),
                C.value.data_ptr(), H.num_rows, H.num_columns,
                C.long_rows.data_ptr(), C.long_rows.numel(),
                C.num_block_rows, C.long_row_entries, x.data_ptr(),
                y.data_ptr(), _stream()), "ell_study_hybrid_launch")

        y.fill_(float("nan"))
        one()
        torch.cuda.synchronize()
        ones[f"R={r}"] = {"ms": timer(one),
                          "bitwise_equal": bool(torch.equal(y, whole))}
        print(f"  one launch R={r}: {ones[f'R={r}']}, two launches "
              f"{hyb['two_launches_ms']} ms", flush=True)
    hyb["one_launch"] = ones
    hyb["float64_sweep"] = f64_sweep
    found["hybrid_ell_part"] = hyb
    line = json.dumps(found)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    found.pop("registers")
    print(json.dumps(found), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
