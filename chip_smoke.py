#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (each prints readable lines; any failure exits non-zero):

1. Device: nvidia-smi's name and power limit, torch's device name, CUDA
   and nvcc versions.  Without a CUDA device it exits 2 and prints no
   result.
2. Build: compiles the kernels from ``spmv_tpu_torch/csrc`` with nvcc
   (sm_90a) and loads them.
3. Kernel against plain version: K1 (with and without the fused dot)
   and K2 (k = 4) in float64, float32 and bfloat16 storage on
   poisson2d(512, 512), a banded matrix with offsets beyond +-128 and a
   4 x 5 rectangular matrix, then K1 / K2 in float32 and bfloat16 at
   the main path's shape, poisson2d(4096, 4096).
   Then the WELL-CW kernels K3a (fallback level), K3b (pool), K3c
   (merged grid) and the CSR kernel in float64 and float32 on
   banded_random(16384, 512, 6) (merged, 64- and 128-group tails),
   banded_random(4096, 128, 8) (fallback level, pool, tail), the 16384
   matrix with chunks_per_step=32 (forced fallback) and random_sparse(256,
   256, 12) packed with one shallow level (a real CSR remainder): each
   launched twice (bitwise equal), against its plain version, and the
   whole product against the fp64 host product in float32.  Then the
   WELL-CW SpMM kernels K4a (merged), K4b (level), K4c (pool) and the CSR
   SpMM on the same four matrices in float64 and float32 at k = 3 and
   k = 8: each launched twice (bitwise equal), against its plain version,
   and column by column against the SpMV kernel (K3a-c, CSR) on that
   column, saying whether the columns are bitwise equal to it.  Last, at
   the batched-CG leg's shape (phase 9), poisson2d(1024, 1024) in
   float32: K1 / K2 (k = 4) and the WELL-CW SpMM kernels at k = 4; and
   at the shapes of the CLI's --nrhs 3 runs (phases 4 and 6, whose B is
   built by the SpMM under test): K2 on poisson2d(1024, 1024) and the
   WELL-CW SpMM kernels on poisson2d(256, 256), float32, k = 3.
   Then the WELL kernels K5a (whole x) and K5b (segmented) and the
   spill's CSR kernel in float64 and float32 on the kinds of matrix of
   the JAX WELL tests: poisson2d(256, 256) whole x and with
   blocks_per_out 2, a random band with forced segment_rows=4 and two
   far column clusters with segment_rows=2 (escaping slots spill),
   segment_rows=8 with blocks_per_out 4, two empty output blocks, a
   rectangular random_sparse(200, 150, 5) and banded_random(65536, 512,
   8) with a CSR spill: each launched twice (bitwise equal), against its
   plain version, the whole product against the plain composition and,
   in float32, the fp64 host product.  Then the WELL SpMM kernels K6a
   (whole x) and K6b (segmented) and the spill's CSR SpMM on the same
   eight matrices at k = 3 and 8, float64 and float32, and at the
   batched-CG shape (poisson2d(1024, 1024), float32, k = 4): twice
   (bitwise equal), against the plain version and column by column
   against K5 / the CSR SpMV on that column.  Last, K7 (the BSR SpMM) on
   block matrices of block height 8, 32 and 128 with blocks_per_step 8,
   3 and 1, an empty block row and a 300 x 200 shape, in float64,
   float32 and bf16 blocks, at k = 1, 3 and 128: twice (bitwise equal),
   against its plain version and the fp64 host product.
4. DIA main path through the CLI, in process, on a Matrix Market file of
   poisson2d(1024, 1024): profile, SpMM profile, CG, Jacobi CG, batched
   CG (--nrhs 3: K2), triad.  The DIA launch counts are zeroed just
   before this phase.
5. DIA full-size profile: poisson2d(4096, 4096) through
   kernels.make_kernel -> time_kernel -> profiling_report in float32 and
   bfloat16 storage, the fp64 host checksum gate, and the plain
   versions timed at the same size.  The DIA launch counts are read
   after it.
6. WELL-CW path through the CLI (the WELL-CW launch counts, K3 and K4,
   are zeroed just before): --profile 3 and --profile 3 --spmm 4 on
   banded_random(65536, 512, 8) (merged grid and tails: K3c/K4a,
   K3b/K4c) and on banded_random(4096, 128, 8) (fallback: K3a/K4b,
   K3b/K4c), --cg 2000 (K3c) and --cg 2000 --nrhs 3 (K4a) on
   poisson2d(256, 256).
7. WELL-CW full-size SpMV profile, the JAX bench's leg on the port:
   banded_random(1048576, 2048, 8) in float32 (merged grid, a 128-group
   tail pool and a CSR remainder: K3c, K3b, CSR) through
   kernels.make_kernel -> time_kernel -> profiling_report: the fp64
   host checksum gate, seconds per SpMV against the plain version, and
   the fraction of the triad roofline with the bench's byte count, and a
   torch.profiler table of 50 chained SpMVs (device time per kernel,
   busy share).
8. WELL-CW full-size SpMM, the bench's k = 8 leg on the same matrix
   (K4a, K4c, CSR SpMM) through make_kernel(...).spmm_fn(8): the fp64
   host checksum gate, seconds per chained SpMM against the plain
   version, the fraction of the triad roofline with the CLI's byte
   count, the per-nnz cost against the SpMV of phase 7, and a
   torch.profiler table of 20 chained SpMMs.
9. Batched CG, the bench's solver leg: poisson2d(1024, 1024) in float32,
   k = 4, on DIA (K2) and on WELL-CW (K4a): us per iteration of batched
   against single-RHS CG (fixed iteration counts, the slope between two
   lengths; host clock, the median and range of 11 interleaved rounds,
   and the kernels' device time from torch.profiler), the throughput
   against k sequential solves (k t1 / tk), and a solve to tolerance of
   B = A ((j + 1) ones), B from the fp64 host product, whose columns
   must match (j + 1) * ones.  The WELL-CW launch counts are read after
   it.
10. WELL-CW kernels alone at full size (not counted): K3c, K3b and CSR,
   and K4a, K4c and the CSR SpMM at k = 8, on the same matrix; K3a and
   K4b on its fallback layout (chunks_per_step=64): bitwise repeat, max
   error against the plain version, device ms (50 launches in a CUDA
   graph, the L2 flushed before each) and ms a call through the
   wrapper, against plain ms, the bound and, for the CSR kernels,
   torch.sparse.
11. WELL path through the CLI (the WELL launch counts, K5a, K5b and the
   spill's CSR kernel, are zeroed just before): --profile 5 and --cg 2000
   on poisson2d(256, 256) (K5a).
12. WELL profile: make_kernel("well").run_fn in float32 on
   poisson2d(1024, 1024) (whole x: K5a) and poisson2d(4096, 4096) (the
   DIA matrix of phase 5, segmented: K5b), each with its CSR spill: host
   packing time, the fp64 host checksum gate, seconds per chained SpMV
   (CUDA events) with the launch counts equal to the chain length, the
   plain version's time, the fraction of the triad roofline and K1's
   time on the same matrix.  The WELL launch counts are read after it.
13. WELL kernels alone at those two sizes (not counted): K5a, K5b and
   the spill's CSR kernel as in phase 10, each beside the torch.sparse
   CSR product (cuSPARSE) of the same entries and its bound; then the
   torch.sparse CSR SpMV of the whole matrix against the chained SpMV.
14. WELL SpMM path through the CLI (the K6a, K6b and CSR SpMM launch
   counts are zeroed just before): --profile 5 --spmm 8 and --cg 2000
   --nrhs 3 on poisson2d(256, 256) (K6a and the spill's CSR SpMM).
15. WELL SpMM profile: make_kernel("well").spmm_fn(8) in float32 on the
   host matrices of phase 12, poisson2d(1024, 1024) (K6a) and
   poisson2d(4096, 4096) (K6b): the fp64 host checksum (the DIA host
   product of the same matrix), seconds per chained SpMM with the
   launch counts equal to the chain length, the plain version's time,
   the fraction of the triad roofline with the CLI's byte count and the
   per-nnz cost against phase 12's SpMV.
16. Batched CG on WELL as phase 9 does for DIA and WELL-CW:
   poisson2d(1024, 1024), float32, k = 4 (K6a).  The WELL SpMM launch
   counts are read after it.
17. BSR path through the CLI (K7's count is zeroed just before): -s bsr
   --profile 5 --spmm 16 and -s bsr --cg 500 on poisson2d(128, 128),
   and -s auto --profile 3 --spmm 128 on block_random(2048, 2048, 4),
   whose report must name bsr.
18. The JAX bench's BSR leg: block_random(131072, 131072, 8, seed=2)
   through auto_format(workload="spmm"), which must choose bsr, then
   make_kernel("bsr").spmm_fn(128) with float32 and bf16 blocks: the
   fp64 host checksum gate (1e-4; 1e-2 for bf16), seconds per chained
   SpMM, TFLOP/s, the bound, the plain version's ms and one torch.sparse
   BSR product's (where torch takes the dtype); then the same in float32
   on block_random(262144, 262144, 2, seed=3), whose 134 MB X is past the
   80 MB line where the JAX bsr_spmm switches from K7b to K7a.  K7's
   launches are tallied under the Pallas kernel their X size selects and
   read after it.
19. K6a, K6b (at every column-block width that fits) and K7 at the
   phase 15 and 18 shapes alone (not counted), as in phase 10.

The second-to-last lines are the kernels' JSON summary (sixteen kernels,
each with its launches on the main path, max error, ms against plain
ms, bound and library ms, and summaries of each path) and nvidia-smi's
``name, power.limit``; the last line is the run's result.  Imports no JAX and nothing of the JAX
package: the machine with the card need not have it.  Bounds take the
data sheet's 3.35 TB/s, 67 TFLOP/s float32 and 989 TFLOP/s bfloat16
(H100 SXM, 700 W).
"""

from __future__ import annotations

import io
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

# Relative max-norm bounds of each comparison (see _compare).
TOL_F64 = 1e-12          # float64 kernel vs plain version
TOL_F32_HOST = 1e-5      # float32 kernel vs the fp64 host product
TOL_F32 = 1e-5           # float32 kernel vs plain version (FMA vs two roundings)
TOL_BF16 = 1e-2          # bf16 storage vs plain version, both f32-accumulated
TOL_DOT = {"float64": 1e-10, "float32": 1e-4, "bfloat16": 1e-4}
CHECKSUM_RTOL = 1e-4     # bench.py's fp64 host checksum gate
CG_RMS_ERR = 1e-2        # CG solution against all-ones, float32

SMALL_GRID = 512
CLI_GRID = 1024
FULL_GRID = 4096
SPMM_K = 4
CLI_NRHS = 3                  # right-hand sides of the CLI's --nrhs runs
CW_FULL_ROWS = 1 << 20        # bench.py's WELL-CW leg on the TPU
CW_FULL_HALF_BW = 2048
CW_CLI_ROWS = 1 << 16
CW_CG_GRID = 256
PROFILE_CHAIN = 50            # chained SpMVs in the traced window
CW_SPMM_K = 8                 # bench.py's WELL-CW SpMM leg
SPMM_CHAIN = 20               # chained SpMMs in the traced window
COMPARE_KS = (3, 8)           # right-hand sides of the K4 comparisons
CG_GRID = 1024                # bench.py's solver leg (batched CG)
CG_K = 4
CG_ITERS = (50, 250)          # fixed-length solves for the slope
CG_ROUNDS = 11                # rounds of those solves, for the spread
WELL_CLI_GRID = 256           # the WELL CLI phase's poisson2d
WELL_WHOLE_GRID = 1024        # K5a: x fits whole in float32
WELL_SEG_GRID = FULL_GRID     # K5b: x past 8 MiB, segmented mode
WELL_SPMM_K = 8               # the WELL SpMM legs' right-hand sides
BSR_K = 128                   # bench.py's BSR leg (bench.py:487-545)
BSR_ROWS = 1 << 17            # block_random(131072, 131072, 8): X 67 MB
BSR_FAR_ROWS = 1 << 18        # block_random(262144, 262144, 2): X 134 MB
BSR_WHOLEX_BYTES = 80 * 1024 * 1024  # the JAX bsr_spmm's K7a / K7b line
BSR_CLI_GRID = 128            # the BSR CLI phase's poisson2d
BSR_CLI_BLOCK_ROWS = 2048     # the -s auto run's block_random
TOL_BSR_BF16 = 1e-5           # K7, bf16 blocks, vs plain: same products, f32 sums
TOL_BF16_HOST = 3e-2          # bf16 blocks vs the fp64 host (tests/test_bsr.py)
BF16_CHECKSUM_RTOL = 1e-2     # bench.py's bf16 BSR checksum gate
HBM_BPS = 3.35e12             # H100 SXM data sheet, at 700 W
PEAK_F32_FLOPS = 67e12        # H100 SXM float32 outside the tensor cores
PEAK_BF16_FLOPS = 989e12      # H100 SXM bfloat16, dense tensor cores


def _fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def _say(msg: str) -> None:
    print(msg, flush=True)


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def _rel(got, want) -> float:
    got, want = got.double(), want.double()
    return float((got - want).abs().max() /
                 max(float(want.abs().max()), 1e-300))


def _time_launches(fn, reps: int) -> float:
    """Milliseconds per call of fn, by CUDA events around reps calls
    after one warm-up call: the eager time, host launch cost included."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _graph_replay_ms(fn, reps: int) -> float:
    """Device milliseconds per call of fn: reps calls captured in one
    CUDA graph, replayed between CUDA events (no host launch cost; the
    fastest of three replays).  fn must not allocate."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / reps)
    del graph
    return best


def _cold_graph_ms(fn, flush, reps: int) -> float:
    """Device milliseconds per call of fn with the L2 cache flushed
    before each call, as a chained caller finds it: graphs of (flush,
    fn) and of flush alone, the difference per call."""
    def both():
        flush()
        fn()

    return _graph_replay_ms(both, reps) - _graph_replay_ms(flush, reps)


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def _bound(nbytes: int, flops: int, triad_gbps: float,
           peak: float = PEAK_F32_FLOPS) -> dict:
    """The least time the card could take: the larger of the bytes the
    function must move (each input read once, each output written once)
    over the data sheet's memory rate and its operations over the peak
    rate for its inputs' type (float32 unless ``peak`` says otherwise:
    the bfloat16 BSR blocks take the bfloat16 peak); beside it, the
    bytes over the triad rate measured on this card."""
    t_bytes, t_ops = nbytes / HBM_BPS, flops / peak
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_triad_ms": nbytes / (triad_gbps * 1e9) * 1e3,
            "bytes": nbytes, "flops": flops}


def _torch_csr(row_ptr, column_index, value, shape):
    """A ``torch.sparse_csr_tensor`` with 32-bit indices: the card's own
    CSR product (cuSPARSE) as a yardstick, which the port never calls."""
    import torch

    return torch.sparse_csr_tensor(row_ptr.to(torch.int32),
                                   column_index.to(torch.int32), value,
                                   size=shape)


def _csr_of_coo(rows, cols, vals, shape):
    import torch

    S = torch.sparse_coo_tensor(torch.stack([rows, cols]), vals,
                                size=shape).coalesce()
    S = S.to_sparse_csr()
    return _torch_csr(S.crow_indices(), S.col_indices(), S.values(), shape)


def _csr_of_mm(mm, device, dtype):
    """The Matrix Market matrix as a torch CSR on the card."""
    import torch

    def t(a):
        return torch.from_numpy(np.asarray(a, np.int64) - 1).to(device)

    return _csr_of_coo(t(mm.rows_1based), t(mm.cols_1based),
                       torch.from_numpy(np.asarray(mm.values)).to(
                           device, dtype), (mm.num_rows, mm.num_columns))


def _library_ms(S, v, reps: int = 20) -> float:
    """Milliseconds of ``S @ v`` (cuSPARSE through torch.sparse)."""
    return _time_launches(lambda: S @ v, reps)


def phase_device():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        sys.exit(2)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    smi_line = smi.stdout.strip().splitlines()[0].strip()
    _say(f"[1 device] nvidia-smi: {smi_line}")
    _say(f"[1 device] torch {torch.__version__}, CUDA "
         f"{torch.version.cuda}, device 0: "
         f"{torch.cuda.get_device_name(0)} "
         f"(capability {torch.cuda.get_device_capability(0)}), "
         f"count {torch.cuda.device_count()}")
    return torch.device("cuda", 0), smi_line


# ---------------------------------------------------------------- phase 2
def phase_build():
    from spmv_tpu_torch.ops._build import (
        build_library,
        load_library,
        nvcc_version,
    )

    _say(f"[2 build] {nvcc_version()}")
    t0 = time.perf_counter()
    path, log = build_library()
    load_library()
    secs = time.perf_counter() - t0
    _say(f"[2 build] {os.path.relpath(path)} in {secs:.2f} s")
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            _say(f"[2 build]   {line.strip()}")


# ---------------------------------------------------------------- phase 3
def _banded_dia(n: int, offsets, seed: int):
    from spmv_tpu_torch.io.generate import from_coo_arrays
    from spmv_tpu_torch.models import DiaMatrix

    rng = np.random.default_rng(seed)
    rows, cols = [], []
    for off in offsets:
        i = np.arange(max(0, -off), min(n, n - off))
        rows.append(i)
        cols.append(i + off)
    rows, cols = np.concatenate(rows), np.concatenate(cols)
    return DiaMatrix.from_matrix_market(from_coo_arrays(
        n, n, rows, cols, rng.standard_normal(rows.size)))


def _rect_dia():
    # the 4 x 5 matrix of tests/conftest.py TINY_MTX
    from spmv_tpu_torch.io.generate import from_coo_arrays
    from spmv_tpu_torch.models import DiaMatrix

    rows = np.array([0, 0, 1, 2, 3, 3, 3])
    cols = np.array([0, 1, 1, 2, 0, 3, 4])
    vals = np.array([1.0, 2.0, 1.0, 3.0, -1.0, 2.0, 1.0])
    return DiaMatrix.from_matrix_market(
        from_coo_arrays(4, 5, rows, cols, vals))


def _compare(name, dia, dtype, device, k=SPMM_K):
    """K1 (plain and fused dot) and K2 (``k`` columns) against the plain
    versions on the same CUDA tensors; float32 also against the fp64 host
    product.
    Returns the max abs errors of K1 and K2 against the plain versions."""
    import torch

    from spmv_tpu_torch.models import DeviceDia
    from spmv_tpu_torch.ops import (
        dia_spmm_core,
        dia_spmm_reference,
        dia_spmv_core,
        dia_spmv_reference,
    )

    dtn = str(dtype).replace("torch.", "")
    A = DeviceDia.from_host(dia, dtype=dtype, device=device)
    g = torch.Generator(device=device).manual_seed(0)
    wide = torch.float64 if dtype == torch.float64 else torch.float32
    x = torch.randn(A.num_columns, generator=g, device=device,
                    dtype=wide).to(dtype)
    X = torch.randn(A.num_columns, k, generator=g, device=device,
                    dtype=wide).to(dtype)

    y = dia_spmv_core(A, x)
    Y = dia_spmm_core(A, X)
    _sync(device)
    y_plain = dia_spmv_reference(A, x)
    Y_plain = dia_spmm_reference(A, X)
    tol = {"float64": TOL_F64, "float32": TOL_F32,
           "bfloat16": TOL_BF16}[dtn]
    e1, e2 = _rel(y, y_plain), _rel(Y, Y_plain)
    line = f"[3 compare] {name} {dtn}: K1 {e1:.3e}, K2(k={k}) {e2:.3e}"
    if e1 > tol or e2 > tol:
        _fail(f"{line} > {tol}")
    if dtype == torch.float32:
        host = torch.from_numpy(dia.spmv(x.double().cpu().numpy()))
        eh = _rel(y.cpu(), host)
        line += f", K1 vs fp64 host {eh:.3e}"
        if eh > TOL_F32_HOST:
            _fail(f"{line} > {TOL_F32_HOST}")
    y2, dot = dia_spmv_core(A, x, with_dot=True)
    _sync(device)
    if _rel(y2, y) > tol:
        _fail(f"{name} {dtn}: with_dot changed y")
    r = min(A.num_rows, A.num_columns)
    if dtype == torch.bfloat16:
        _, want = dia_spmv_reference(A, x, with_dot=True)
    else:
        want = torch.dot(x[:r], y[:r])
    scale = float((x[:r].double() * y[:r].double()).abs().sum())
    ed = abs(float(dot) - float(want)) / scale
    line += f", fused dot {ed:.3e}"
    if ed > TOL_DOT[dtn]:
        _fail(f"{line} > {TOL_DOT[dtn]}")
    _say(line)
    return (float((y.double() - y_plain.double()).abs().max()),
            float((Y.double() - Y_plain.double()).abs().max()))


def phase_compare(device, full):
    import torch

    from spmv_tpu_torch.io.generate import poisson2d
    from spmv_tpu_torch.models import DiaMatrix

    cases = [
        (f"poisson2d({SMALL_GRID},{SMALL_GRID})",
         DiaMatrix.from_matrix_market(poisson2d(SMALL_GRID, SMALL_GRID))),
        ("banded(200000, offsets -300..300)",
         _banded_dia(200_000, (-300, -129, -128, -3, 0, 1, 127, 128, 300),
                     seed=1)),
        ("rectangular 4x5", _rect_dia()),
    ]
    for name, dia in cases:
        for dtype in (torch.float64, torch.float32, torch.bfloat16):
            _compare(name, dia, dtype, device)
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        errs[dtype] = _compare(f"poisson2d({FULL_GRID},{FULL_GRID})", full,
                               dtype, device)
    _sync(device)
    return errs


def _cw_parts(A, spmm: bool = False):
    """(kernel name, kernel call, plain call, part) of each launch that
    ``wellcw_spmv_core`` (``wellcw_spmm_core`` with ``spmm``) makes for
    A; each call takes x or X (and an optional out buffer for the
    kernel), and ``part`` is the container the kernel reads."""
    from spmv_tpu_torch import ops

    n = A.num_rows
    sfx = "_spmm" if spmm else ""

    def part(kind, plain, p):
        core = getattr(ops, f"wellcw_{kind}{sfx}_core")
        return (f"wellcw_{kind}{sfx}",
                lambda x, out=None: core(p, x, n, out=out),
                lambda x: plain(p, x, n), p)

    parts = []
    if A.merged is not None:
        parts.append(part("merged", ops.cw_merged_reference, A.merged))
    parts += [part("level", ops.cw_level_reference, lv) for lv in A.levels]
    pools = ([A.pool] if A.pool is not None else []) + list(A.tail_pools)
    parts += [part("pool", ops.cw_pool_reference, p) for p in pools]
    if A.remainder is not None:
        R = A.remainder
        core = ops.csr_spmm_core if spmm else ops.csr_spmv_core
        parts.append(("csr_spmm" if spmm else "csr_spmv",
                      lambda x, out=None: core(R, x, out=out),
                      lambda x: ops.csr_spmv_reference(R, x), R))
    return parts


def _compare_cw(name, w, dev_kw, dtype, device):
    """Each WELL-CW / CSR kernel launch of the product, twice (bitwise
    equal) and against its plain version; the whole product against the
    plain composition and, in float32, the fp64 host product."""
    import torch

    from spmv_tpu_torch.models import DeviceWellCw
    from spmv_tpu_torch.ops import wellcw_spmv_core, wellcw_spmv_reference

    dtn = str(dtype).replace("torch.", "")
    tol = TOL_F64 if dtype == torch.float64 else TOL_F32
    A = DeviceWellCw.from_host(w, dtype=dtype, device=device, **dev_kw)
    g = torch.Generator(device=device).manual_seed(0)
    x = torch.randn(A.num_columns, generator=g, device=device, dtype=dtype)
    errs = []
    for kname, run, plain, _ in _cw_parts(A):
        y1, y2 = run(x), run(x)
        _sync(device)
        if not torch.equal(y1, y2):
            _fail(f"{kname} on {name} {dtn}: two launches differ")
        e = _rel(y1, plain(x))
        errs.append(f"{kname} {e:.3e}")
        if e > tol:
            _fail(f"{kname} on {name} {dtn}: rel err {e} > {tol}")
    y = wellcw_spmv_core(A, x)
    _sync(device)
    e = _rel(y, wellcw_spmv_reference(A, x))
    line = (f"[3 compare] {name} {dtn}: " + ", ".join(errs)
            + f"; whole {e:.3e}")
    if e > tol:
        _fail(f"{line} > {tol}")
    if dtype == torch.float32:
        host = torch.from_numpy(w.spmv(x.double().cpu().numpy()))
        eh = _rel(y.cpu(), host)
        line += f", vs fp64 host {eh:.3e}"
        if eh > TOL_F32_HOST:
            _fail(f"{line} > {TOL_F32_HOST}")
    _say(line + " (each kernel twice, bitwise equal)")


def _compare_cw_spmm(name, w, dev_kw, dtype, k, device, bitwise):
    """Each K4 / CSR SpMM kernel launch of the product, twice (bitwise
    equal), against its plain version and, column by column, against the
    SpMV kernel on that column; the whole product against the plain
    composition and, in float32, the fp64 host product.  ``bitwise``
    records per kernel whether every column equalled the SpMV kernel's
    bit for bit."""
    import torch

    from spmv_tpu_torch.models import DeviceWellCw
    from spmv_tpu_torch.ops import wellcw_spmm_core, wellcw_spmv_reference

    dtn = str(dtype).replace("torch.", "")
    tol = TOL_F64 if dtype == torch.float64 else TOL_F32
    A = DeviceWellCw.from_host(w, dtype=dtype, device=device, **dev_kw)
    g = torch.Generator(device=device).manual_seed(0)
    X = torch.randn(A.num_columns, k, generator=g, device=device,
                    dtype=dtype)
    errs = []
    for (kname, run, plain, _), (_, run1, _, _) in zip(
            _cw_parts(A, spmm=True), _cw_parts(A)):
        Y1, Y2 = run(X), run(X)
        cols = torch.stack([run1(X[:, j].contiguous()) for j in range(k)],
                           dim=1)
        _sync(device)
        if not torch.equal(Y1, Y2):
            _fail(f"{kname} on {name} {dtn} k={k}: two launches differ")
        e, ec = _rel(Y1, plain(X)), _rel(Y1, cols)
        same = torch.equal(Y1, cols)
        bitwise[kname] = bitwise.get(kname, True) and same
        errs.append(f"{kname} {e:.3e} (vs SpMV kernel {ec:.3e}"
                    f"{', bitwise' if same else ''})")
        if e > tol or ec > tol:
            _fail(f"{kname} on {name} {dtn} k={k}: rel err {e} / {ec} "
                  f"> {tol}")
    Y = wellcw_spmm_core(A, X)
    _sync(device)
    e = _rel(Y, wellcw_spmv_reference(A, X))
    line = (f"[3 compare] {name} {dtn} k={k}: " + ", ".join(errs)
            + f"; whole {e:.3e}")
    if e > tol:
        _fail(f"{line} > {tol}")
    if dtype == torch.float32:
        host = torch.from_numpy(w.spmm(X.double().cpu().numpy()))
        eh = _rel(Y.cpu(), host)
        line += f", vs fp64 host {eh:.3e}"
        if eh > TOL_F32_HOST:
            _fail(f"{line} > {TOL_F32_HOST}")
    _say(line + " (each kernel twice, bitwise equal)")


def phase_compare_wellcw(device, cg_mats):
    """The WELL-CW SpMV kernels, then the SpMM kernels, on four matrices,
    then K2 and the K4 kernels at the batched-CG leg's shape (``cg_mats``,
    k = CG_K, float32) and at the CLI's --nrhs shapes (k = CLI_NRHS);
    returns per SpMM kernel whether its columns equalled the SpMV
    kernel's bit for bit in every case."""
    import torch

    from spmv_tpu_torch.io.generate import banded_random, poisson2d, random_sparse
    from spmv_tpu_torch.models import DiaMatrix, WellCwMatrix

    merged = WellCwMatrix.from_matrix_market(
        banded_random(16384, 512, 6, seed=20))
    cases = [
        ("banded_random(16384,512,6) merged", merged, {}),
        ("banded_random(4096,128,8) fallback", WellCwMatrix.from_matrix_market(
            banded_random(4096, 128, 8, seed=1)), {}),
        ("banded_random(16384,512,6) chunks_per_step=32", merged,
         {"chunks_per_step": 32}),
        ("random_sparse(256,256,12) remainder", WellCwMatrix.from_matrix_market(
            random_sparse(256, 256, 12, seed=7), levels=[(2, 1, 0.0)],
            pool_cap=0), {}),
    ]
    for name, w, dev_kw in cases:
        for dtype in (torch.float64, torch.float32):
            _compare_cw(name, w, dev_kw, dtype, device)
    bitwise = {}
    for name, w, dev_kw in cases:
        for dtype in (torch.float64, torch.float32):
            for k in COMPARE_KS:
                _compare_cw_spmm(name, w, dev_kw, dtype, k, device, bitwise)
    name = f"poisson2d({CG_GRID},{CG_GRID})"
    _compare(name, cg_mats["dia"], torch.float32, device)
    _compare_cw_spmm(name, cg_mats["wellcw"], {}, torch.float32, CG_K,
                     device, bitwise)
    # the CLI's --nrhs runs (phases 4 and 6) solve for a B built by the
    # SpMM under test, so their rms gate cannot see a wrong SpMM: hold it
    # here at their shapes
    name = f"poisson2d({CLI_GRID},{CLI_GRID})"
    _compare(name, DiaMatrix.from_matrix_market(
        poisson2d(CLI_GRID, CLI_GRID)), torch.float32, device, k=CLI_NRHS)
    name = f"poisson2d({CW_CG_GRID},{CW_CG_GRID})"
    _compare_cw_spmm(name, WellCwMatrix.from_matrix_market(
        poisson2d(CW_CG_GRID, CW_CG_GRID)), {}, torch.float32, CLI_NRHS,
        device, bitwise)
    _say("[3 compare] SpMM columns bitwise equal to the SpMV kernel's in "
         "every case: " + ", ".join(f"{n} {'yes' if b else 'no'}"
                                    for n, b in bitwise.items()))
    _sync(device)
    return bitwise


# ---------------------------------------------------------------- phase 4
def _run_cli(tag, runs):
    """Run the port's CLI in process; each run is (name, argv, wrappers
    that must launch).  Checks GPU timing, or CG convergence.  Returns
    the reports."""
    from spmv_tpu_torch.cli import main

    docs = []
    for name, argv, wrappers in runs:
        before = [w.launches for w in wrappers]
        buf = io.StringIO()
        t0 = time.perf_counter()
        rc = main(argv, out=buf)
        secs = time.perf_counter() - t0
        if rc != 0:
            _fail(f"CLI {' '.join(argv)} exited {rc}")
        doc = json.loads(buf.getvalue())
        for w, b in zip(wrappers, before):
            if w.launches <= b:
                _fail(f"CLI {name}: {w.__name__} was not launched")
        launched = "".join(f", {w.__name__} launches +{w.launches - b}"
                           for w, b in zip(wrappers, before))
        if "cg" in doc and "nrhs" in doc["cg"]:
            cg = doc["cg"]
            errs = cg["solution_rms_error_vs_ones"]
            _say(f"[{tag}] {name}: nrhs {cg['nrhs']}, iterations "
                 f"{cg['iterations']}, residuals "
                 f"{[f'{r:.3e}' for r in cg['residual_norms']]}, rms "
                 f"errors vs (j+1)*ones {[f'{e:.3e}' for e in errs]}, "
                 f"{cg['seconds']:.4f} s "
                 f"({cg['seconds'] / max(max(cg['iterations']), 1) * 1e6:.1f}"
                 f" us/iteration){launched}")
            if len(errs) != cg["nrhs"] or not all(
                    np.isfinite(e) and e <= CG_RMS_ERR for e in errs):
                _fail(f"CLI {name}: rms errors {errs} > {CG_RMS_ERR}")
        elif "cg" in doc:
            cg = doc["cg"]
            err = cg["solution_rms_error_vs_ones"]
            _say(f"[{tag}] {name}: {cg['iterations']} iterations, "
                 f"residual {cg['residual_norm']:.3e}, rms error vs ones "
                 f"{err:.3e}, {cg['seconds']:.4f} s "
                 f"({cg['seconds'] / max(cg['iterations'], 1) * 1e6:.1f}"
                 f" us/iteration){launched}")
            if not (np.isfinite(err) and err <= CG_RMS_ERR):
                _fail(f"CLI {name}: rms error {err} > {CG_RMS_ERR}")
        else:
            t = doc["device_seconds_per_iteration"]
            frac = doc["achieved"]["fraction_of_roofline"]
            _say(f"[{tag}] {name}: device_seconds_per_iteration {t:.6e}, "
                 f"fraction_of_roofline {frac:.4f} (roofline on "
                 f"{doc['roofline']['machine']}), "
                 f"{secs:.1f} s wall{launched}")
            if doc["device"]["platform"] != "gpu" or not t > 0:
                _fail(f"CLI {name}: not a GPU timing: {doc['device']}")
        docs.append(doc)
    return docs


def phase_cli(device):
    import torch

    from spmv_tpu_torch.io import write_matrix_market
    from spmv_tpu_torch.io.generate import poisson2d
    from spmv_tpu_torch.ops import dia_spmm_core, dia_spmv_core

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, f"poisson2d_{CLI_GRID}.mtx")
        t0 = time.perf_counter()
        write_matrix_market(poisson2d(CLI_GRID, CLI_GRID), path)
        _say(f"[4 cli] wrote {path} ({os.path.getsize(path) >> 20} MiB) in "
             f"{time.perf_counter() - t0:.1f} s")
        mat = ["--matrix", path, "--spmv-format", "dia"]
        _run_cli("4 cli", [
            ("profile", mat + ["--profile", "10"], (dia_spmv_core,)),
            ("spmm", mat + ["--profile", "5", "--spmm", str(SPMM_K)],
             (dia_spmm_core,)),
            ("cg", mat + ["--cg", "2000", "--cg-tol", "1e-5"],
             (dia_spmv_core,)),
            ("cg_jacobi", mat + ["--cg", "2000", "--cg-tol", "1e-5",
                                 "--precondition", "jacobi"],
             (dia_spmv_core,)),
            ("cg_nrhs", mat + ["--cg", "2000", "--cg-tol", "1e-5",
                               "--nrhs", str(CLI_NRHS)], (dia_spmm_core,)),
            ("triad", ["--triad", "100000000", "--profile", "5"], ()),
        ])
    _sync(device)


# ---------------------------------------------------------------- phase 5
def phase_profile(device, full, full_mm, smi_line):
    import torch

    from spmv_tpu_torch.kernels import make_kernel
    from spmv_tpu_torch.ops import dia_spmm_reference, dia_spmv_reference
    from spmv_tpu_torch.perfmodel import measured_machine
    from spmv_tpu_torch.profile import (
        profile_kernel_fn,
        profiling_report,
        time_kernel,
    )

    machine = measured_machine(device)
    _say(f"[5 profile] machine: {machine.name}, triad {machine.hbm_gbps:.1f} "
         f"GB/s measured (data sheet {machine.datasheet_hbm_gbps} GB/s), "
         f"card {smi_line}")
    times, extra = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        dtn = str(dtype).replace("torch.", "")
        kernel = make_kernel("dia", matrix=full, device=device, dtype=dtype)
        kernel.init()
        step, args = kernel.run_fn()
        A = args[1]
        if dtype == torch.float32:
            # bench.py's gate: |A x| summed in f32 on the card against
            # the fp64 host product, through the profiled step
            x = np.random.default_rng(0).standard_normal(
                full.num_columns).astype(np.float32)
            y = step(torch.from_numpy(x).to(device), A)
            got = float(y.abs().sum(dtype=torch.float32))
            want = float(np.abs(full.spmv(x.astype(np.float64))).sum())
            rel = abs(got - want) / want
            _say(f"[5 profile] checksum rel err {rel:.3e} (gate "
                 f"{CHECKSUM_RTOL})")
            if rel > CHECKSUM_RTOL:
                _fail(f"checksum gate: {rel} > {CHECKSUM_RTOL}")
        timing = time_kernel(step, args, k_small=8, k_large=136, runs=6)
        runs = profile_kernel_fn(step, args, runs=5)
        doc = profiling_report(kernel, runs, timing.seconds_per_iteration,
                               5, True, machine=machine, device=device)
        t_plain = time_kernel(lambda v, A: dia_spmv_reference(A, v),
                              (args[0], A), k_small=2, k_large=12,
                              runs=3).seconds_per_iteration
        t = doc["device_seconds_per_iteration"]
        frac = doc["achieved"]["fraction_of_roofline"]
        times[("spmv", dtn)] = (t, t_plain)
        _say(f"[5 profile] K1 {dtn}: kernel {t * 1e3:.4f} ms "
             f"({doc['achieved']['gb_per_s_modeled']:.1f} GB/s modeled, "
             f"fraction_of_roofline {frac:.4f}), plain {t_plain * 1e3:.4f}"
             f" ms, on {smi_line}")
        if not (np.isfinite(t) and t > 0):
            _fail(f"K1 {dtn}: bad timing {t}")

        step, args = kernel.spmm_fn(SPMM_K)
        t = time_kernel(step, args, k_small=4, k_large=40,
                        runs=6).seconds_per_iteration
        t_plain = time_kernel(lambda V, A: dia_spmm_reference(A, V),
                              args, k_small=2, k_large=8,
                              runs=3).seconds_per_iteration
        times[("spmm", dtn)] = (t, t_plain)
        _say(f"[5 profile] K2 {dtn} k={SPMM_K}: kernel {t * 1e3:.4f} ms, "
             f"plain {t_plain * 1e3:.4f} ms, on {smi_line}")
        if dtype == torch.float32:
            # the yardstick: the card's CSR product of the same matrix,
            # and each kernel's bound at this shape
            S = _csr_of_mm(full_mm, device, dtype)
            x, X = args[0][:, 0].contiguous(), args[0]
            nnz = full.num_entries
            for key, v, k in (("spmv", x, 1), ("spmm", X, SPMM_K)):
                lib = _library_ms(S, v)
                b = _bound(_nbytes(A.data, A.offsets_dev)
                           + (A.num_columns + A.num_rows) * k * 4,
                           2 * nnz * k, machine.hbm_gbps)
                extra[key] = {"library_ms": lib, **b}
                _say(f"[5 profile] {'K1' if k == 1 else f'K2 k={k}'} "
                     f"float32: torch.sparse CSR (cuSPARSE) {lib:.4f} ms; "
                     f"bound {b['bound_ms']:.4f} ms ({b['bound_by']}, "
                     f"{b['bytes']} B at {HBM_BPS / 1e12} TB/s), "
                     f"{b['bound_triad_ms']:.4f} ms at the triad rate")
            del S, x, X
        del kernel, step, args, A
        _sync(device)
    return times, extra


# ---------------------------------------------------------------- phase 6
def phase_cli_wellcw(device):
    from spmv_tpu_torch.io import write_matrix_market
    from spmv_tpu_torch.io.generate import banded_random, poisson2d
    from spmv_tpu_torch.ops import (
        wellcw_level_core,
        wellcw_level_spmm_core,
        wellcw_merged_core,
        wellcw_merged_spmm_core,
        wellcw_pool_core,
        wellcw_pool_spmm_core,
    )

    with tempfile.TemporaryDirectory() as tmp:
        mats = {
            "banded": (banded_random(CW_CLI_ROWS, 512, 8, seed=3),
                       f"banded_random({CW_CLI_ROWS},512,8)"),
            "fallback": (banded_random(4096, 128, 8, seed=1),
                         "banded_random(4096,128,8)"),
            "poisson": (poisson2d(CW_CG_GRID, CW_CG_GRID),
                        f"poisson2d({CW_CG_GRID},{CW_CG_GRID})"),
        }
        paths = {}
        for key, (mm, label) in mats.items():
            paths[key] = os.path.join(tmp, f"{key}.mtx")
            write_matrix_market(mm, paths[key])
            _say(f"[6 wellcw cli] wrote {label} ({mm.num_entries} entries)")

        def argv(key, *rest):
            return ["--matrix", paths[key], "--spmv-format", "wellcw", *rest]

        _run_cli("6 wellcw cli", [
            (f"profile {mats['banded'][1]}", argv("banded", "--profile", "3"),
             (wellcw_merged_core, wellcw_pool_core)),
            (f"profile {mats['fallback'][1]}",
             argv("fallback", "--profile", "3"),
             (wellcw_level_core, wellcw_pool_core)),
            (f"cg {mats['poisson'][1]}", argv("poisson", "--cg", "2000"),
             (wellcw_merged_core,)),
            (f"spmm k=4 {mats['banded'][1]}",
             argv("banded", "--profile", "3", "--spmm", "4"),
             (wellcw_merged_spmm_core, wellcw_pool_spmm_core)),
            (f"spmm k=4 {mats['fallback'][1]}",
             argv("fallback", "--profile", "3", "--spmm", "4"),
             (wellcw_level_spmm_core, wellcw_pool_spmm_core)),
            (f"cg nrhs={CLI_NRHS} {mats['poisson'][1]}",
             argv("poisson", "--cg", "2000", "--nrhs", str(CLI_NRHS)),
             (wellcw_merged_spmm_core,)),
        ])
    _sync(device)


# ---------------------------------------------------------------- phase 7
def _cw_stream_bytes(A) -> int:
    """bench.py's stored stream of a WELL-CW product (bench.py:413-428):
    the merged grid's or the levels' value + index, the pools' value +
    index + rowmap.  x and y are priced separately."""
    b = sum(lv.value.numel() * (lv.value.element_size() + 4)
            for lv in A.levels)
    if A.merged is not None:
        b += A.merged.value.numel() * (A.merged.value.element_size() + 4)
    for p in ([A.pool] if A.pool is not None else []) + list(A.tail_pools):
        b += p.value.numel() * (p.value.element_size() + 8)
    return b


def phase_profile_wellcw(device, cw, cw_mm, smi_line):
    import torch

    from spmv_tpu_torch.perfmodel.tiling import roofline_time
    from spmv_tpu_torch.kernels import make_kernel
    from spmv_tpu_torch.ops import wellcw_spmv_reference
    from spmv_tpu_torch.perfmodel import measured_machine
    from spmv_tpu_torch.profile import (
        profile_kernel_fn,
        profiling_report,
        time_kernel,
    )

    machine = measured_machine(device)
    kernel = make_kernel("wellcw", matrix=cw, device=device,
                         dtype=torch.float32)
    kernel.init()
    step, args = kernel.run_fn()
    A = args[1]
    mg = A.merged
    _say(f"[7 wellcw profile] layout: "
         + (f"merged grid {mg.num_blocks} blocks x {mg.kl} chunks "
            f"(cap {mg.cap}, pool {mg.pool_per_block})" if mg is not None
            else f"fallback, {len(A.levels)} level(s)")
         + f", tail pools {[(p.out_rows, p.num_chunks) for p in A.tail_pools]}"
         + f", remainder {0 if A.remainder is None else A.remainder.num_entries}"
         + " entries")
    # bench.py's gate: |A x| summed in f32 on the card against the fp64
    # host product, through the profiled step
    x = np.random.default_rng(0).standard_normal(
        cw.num_columns).astype(np.float32)
    y = step(torch.from_numpy(x).to(device), A)
    got = float(y.abs().sum(dtype=torch.float32))
    want = float(np.abs(cw.spmv(x.astype(np.float64))).sum())
    rel = abs(got - want) / want
    _say(f"[7 wellcw profile] checksum rel err {rel:.3e} (gate "
         f"{CHECKSUM_RTOL})")
    if not rel <= CHECKSUM_RTOL:
        _fail(f"wellcw checksum gate: {rel} > {CHECKSUM_RTOL}")
    timing = time_kernel(step, args, k_small=8, k_large=136, runs=6)
    runs = profile_kernel_fn(step, args, runs=5)
    doc = profiling_report(kernel, runs, timing.seconds_per_iteration, 5,
                           True, machine=machine, device=device)
    t = doc["device_seconds_per_iteration"]
    if not (np.isfinite(t) and t > 0) or doc["device"]["platform"] != "gpu":
        _fail(f"wellcw: bad timing {t} on {doc['device']}")
    stream = _cw_stream_bytes(A)
    roof = roofline_time(stream, 2 * cw.num_entries, machine=machine,
                         dtype="float32",
                         resident_rw_bytes=2 * 4 * cw.num_rows)
    frac = roof["time_roofline_s"] / t
    t_plain = time_kernel(lambda v, A: wellcw_spmv_reference(A, v),
                          (args[0], A), k_small=1, k_large=4,
                          runs=3).seconds_per_iteration
    _say(f"[7 wellcw profile] SpMV {t * 1e3:.4f} ms "
         f"({cw.num_entries / t / 1e9:.2f} Gnnz/s), plain {t_plain * 1e3:.4f}"
         f" ms; bench stream {stream} B + x, y {2 * 4 * cw.num_rows} B, "
         f"roofline {roof['time_roofline_s'] * 1e3:.4f} ms at "
         f"{machine.hbm_gbps:.1f} GB/s triad: fraction {frac:.4f} "
         f"(report's own count {doc['achieved']['fraction_of_roofline']:.4f})"
         f", on {smi_line}")
    # where the time goes: the kernels' device time in a traced chain
    from spmv_tpu_torch.profile.cg_breakdown import traced

    def chain():
        v = args[0]
        for _ in range(PROFILE_CHAIN):
            v = step(v, A)

    chain()
    wall, dev, table = traced(chain, device)
    _say(f"[7 wellcw profile] torch.profiler, {PROFILE_CHAIN} chained "
         f"SpMVs: device {dev / PROFILE_CHAIN * 1e6:.2f} us per SpMV, wall "
         f"{wall / PROFILE_CHAIN * 1e6:.2f} us, busy share {dev / wall:.3f}")
    for line in table.splitlines():
        _say(f"[7 wellcw profile]   {line}")
    lib = _library_ms(_csr_of_mm(cw_mm, device, torch.float32), args[0])
    _say(f"[7 wellcw profile] torch.sparse CSR (cuSPARSE) of the same "
         f"matrix: {lib:.4f} ms per SpMV")
    del kernel, step, args, A, y
    _sync(device)
    return {"ms": t * 1e3, "plain_ms": t_plain * 1e3, "library_ms": lib,
            "roofline_fraction": frac, "checksum_rel_err": rel,
            "device_busy_share": dev / wall}


# ---------------------------------------------------------------- phase 8
def phase_profile_wellcw_spmm(device, cw, cw_mm, smi_line, t_spmv):
    """The bench's WELL-CW SpMM leg (bench.py:433-468) at k = 8 through
    ``make_kernel("wellcw").spmm_fn``; ``t_spmv`` is phase 7's seconds
    per SpMV."""
    import torch

    from spmv_tpu_torch.kernels import make_kernel
    from spmv_tpu_torch.ops import wellcw_spmv_reference
    from spmv_tpu_torch.perfmodel import measured_machine
    from spmv_tpu_torch.profile import (
        profile_kernel_fn,
        profiling_report,
        time_kernel,
    )

    k = CW_SPMM_K
    machine = measured_machine(device)
    kernel = make_kernel("wellcw", matrix=cw, device=device,
                         dtype=torch.float32)
    kernel.init()
    step, args = kernel.spmm_fn(k)
    A = args[1]
    # bench.py's gate: |A X| summed in f32 on the card against the fp64
    # host product, through the profiled step
    X = np.random.default_rng(0).standard_normal(
        (cw.num_columns, k)).astype(np.float32)
    Y = step(torch.from_numpy(X).to(device), A)
    got = float(Y.abs().sum(dtype=torch.float32))
    want = float(np.abs(cw.spmm(X.astype(np.float64))).sum())
    rel = abs(got - want) / want
    _say(f"[8 wellcw spmm] k={k}: checksum rel err {rel:.3e} (gate "
         f"{CHECKSUM_RTOL})")
    if not rel <= CHECKSUM_RTOL:
        _fail(f"wellcw spmm checksum gate: {rel} > {CHECKSUM_RTOL}")
    timing = time_kernel(step, args, k_small=4, k_large=40, runs=6)
    runs = profile_kernel_fn(step, args, runs=5)
    # the CLI's --spmm count (spmv_tpu_torch/cli.py _profile): one matrix
    # stream, the x / y volume k times
    m = kernel.matrix
    flops = k * kernel.flops_per_run()
    nbytes = kernel.bytes_per_run() + (k - 1) * (
        m.num_columns + m.num_rows) * kernel.value_bytes
    doc = profiling_report(kernel, runs, timing.seconds_per_iteration, 5,
                           True, machine=machine, device=device,
                           op_info={"kind": "spmm", "k": k},
                           flops_per_run=flops, bytes_per_run=nbytes)
    t = doc["device_seconds_per_iteration"]
    if not (np.isfinite(t) and t > 0) or doc["device"]["platform"] != "gpu":
        _fail(f"wellcw spmm: bad timing {t} on {doc['device']}")
    frac = doc["achieved"]["fraction_of_roofline"]
    t_plain = time_kernel(lambda V, A: wellcw_spmv_reference(A, V),
                          (args[0], A), k_small=1, k_large=3,
                          runs=2).seconds_per_iteration
    per_nnz = (t / k) / t_spmv
    _say(f"[8 wellcw spmm] SpMM k={k} {t * 1e3:.4f} ms "
         f"({cw.num_entries * k / t / 1e9:.2f} effective Gnnz/s), plain "
         f"{t_plain * 1e3:.4f} ms; CLI byte count {nbytes} B, roofline "
         f"{nbytes / (machine.hbm_gbps * 1e9) * 1e3:.4f} ms at "
         f"{machine.hbm_gbps:.1f} GB/s triad: fraction {frac:.4f}; per nnz "
         f"against the SpMV {per_nnz:.4f} ((t / {k}) / {t_spmv * 1e3:.4f}"
         f" ms), on {smi_line}")
    from spmv_tpu_torch.profile.cg_breakdown import traced

    def chain():
        V = args[0]
        for _ in range(SPMM_CHAIN):
            V = step(V, A)

    chain()
    wall, dev, table = traced(chain, device)
    _say(f"[8 wellcw spmm] torch.profiler, {SPMM_CHAIN} chained SpMMs: "
         f"device {dev / SPMM_CHAIN * 1e6:.2f} us per SpMM, wall "
         f"{wall / SPMM_CHAIN * 1e6:.2f} us, busy share {dev / wall:.3f}")
    for line in table.splitlines():
        _say(f"[8 wellcw spmm]   {line}")
    lib = _library_ms(_csr_of_mm(cw_mm, device, torch.float32), args[0])
    _say(f"[8 wellcw spmm] torch.sparse CSR (cuSPARSE) of the same matrix "
         f"times X (k={k}): {lib:.4f} ms")
    del kernel, step, args, A, Y
    _sync(device)
    return {"k": k, "ms": t * 1e3, "plain_ms": t_plain * 1e3,
            "library_ms": lib,
            "roofline_fraction": frac, "checksum_rel_err": rel,
            "per_nnz_vs_spmv": per_nnz, "device_busy_share": dev / wall}


# ---------------------------------------------------------------- phase 9
def _spread(xs) -> dict:
    return {"median": float(np.median(xs)), "min": float(min(xs)),
            "max": float(max(xs))}


def _solve_slopes(solves, device) -> dict:
    """Host seconds per iteration of each ``solves[name](n)``: in each of
    CG_ROUNDS rounds every solve runs at both lengths of CG_ITERS, one
    after the other, so that the solves of a round see the same state of
    the machine; the round's slope is the difference of the two times
    over the difference of the lengths (host clock around work that ends
    in a synchronise).  Returns name -> one slope per round."""
    import torch

    def timed(solve, n):
        t0 = time.perf_counter()
        solve(n)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return time.perf_counter() - t0

    for solve in solves.values():
        for n in CG_ITERS:
            timed(solve, n)
    span = CG_ITERS[1] - CG_ITERS[0]
    slopes = {name: [] for name in solves}
    for _ in range(CG_ROUNDS):
        for name, solve in solves.items():
            short = timed(solve, CG_ITERS[0])
            slopes[name].append((timed(solve, CG_ITERS[1]) - short) / span)
    return slopes


def _device_slope(solve, device) -> float:
    """Device seconds per iteration of ``solve(n)``: the summed device
    time of the kernels torch.profiler traced in the solve of CG_ITERS[1]
    iterations, less that of CG_ITERS[0], over the difference."""
    from spmv_tpu_torch.profile.cg_breakdown import traced

    dev = [traced(lambda: solve(n), device)[1] for n in CG_ITERS]
    return (dev[1] - dev[0]) / (CG_ITERS[1] - CG_ITERS[0])


def phase_batched_cg(device, mats, smi_line, tag="9 batched cg"):
    """bench.py's solver leg (bench.py:694-712) on the port: batched CG
    (k = CG_K) against single-RHS CG at poisson2d(CG_GRID²), float32, on
    each format of ``mats``: DIA (K1 / K2), WELL-CW (K3 / K4) or WELL
    (K5 / K6 and the spill), all at tol 0 for fixed iteration counts;
    then a solve to tol 1e-5 of B = A ((j + 1) ones), B from the fp64
    host product."""
    import torch

    from spmv_tpu_torch.models import DeviceDia, DeviceWell, DeviceWellCw
    from spmv_tpu_torch.ops import (
        batched_conjugate_gradient,
        conjugate_gradient,
        dia_batched_conjugate_gradient,
        dia_conjugate_gradient,
        spmm,
        spmv,
    )

    f32 = torch.float32
    n = next(iter(mats.values())).num_rows
    g = torch.Generator(device=device).manual_seed(3)
    b = torch.randn(n, generator=g, device=device, dtype=f32)
    B = torch.randn(n, CG_K, generator=g, device=device, dtype=f32)
    out = {}
    for fmt, host in mats.items():
        if fmt == "dia":
            A = DeviceDia.from_host(host, dtype=f32, device=device)

            def single(it, rhs=b):
                return dia_conjugate_gradient(A, rhs, tol=0.0,
                                              max_iterations=it)

            def batched(it, rhs=B, tol=0.0):
                return dia_batched_conjugate_gradient(
                    A, rhs, tol=tol, max_iterations=it)
        else:
            cls = DeviceWellCw if fmt == "wellcw" else DeviceWell
            A = cls.from_host(host, dtype=f32, device=device)

            def single(it, rhs=b):
                return conjugate_gradient(lambda v: spmv(A, v), rhs,
                                          tol=0.0, max_iterations=it)

            def batched(it, rhs=B, tol=0.0):
                return batched_conjugate_gradient(
                    lambda V: spmm(A, V), rhs, tol=tol, max_iterations=it)
        slopes = _solve_slopes({"single": single, "batched": batched},
                               device)
        thr = [CG_K * t1 / tk
               for t1, tk in zip(slopes["single"], slopes["batched"])]
        d1, dk = _device_slope(single, device), _device_slope(batched, device)
        t1, tk, th = (_spread(slopes["single"]), _spread(slopes["batched"]),
                      _spread(thr))
        # B from the fp64 host product, so that a wrong SpMM fails the
        # rms gate instead of solving its own operator
        X_true = np.ones((n, CG_K)) * np.arange(1, CG_K + 1)
        rhs = torch.from_numpy(np.stack(
            [host.spmv(X_true[:, j]) for j in range(CG_K)], axis=1))
        res = batched(3000, rhs=rhs.to(device, f32).contiguous(), tol=1e-5)
        X = res.x.double().cpu().numpy()
        errs = [float(np.linalg.norm(X[:, j] - (j + 1)) / np.sqrt(n)
                      / (j + 1)) for j in range(CG_K)]
        its = [int(i) for i in res.iterations.cpu()]

        def us(st):
            return (f"{st['median'] * 1e6:.1f} [{st['min'] * 1e6:.1f}, "
                    f"{st['max'] * 1e6:.1f}]")

        _say(f"[{tag}] {fmt} poisson2d({CG_GRID}^2) float32, host "
             f"clock, median [min, max] of {CG_ROUNDS} rounds: single "
             f"{us(t1)} us/iteration, batched k={CG_K} {us(tk)} "
             f"us/iteration, throughput vs sequential {th['median']:.3f} "
             f"[{th['min']:.3f}, {th['max']:.3f}]; device (torch.profiler "
             f"kernel time): single {d1 * 1e6:.2f} us/iteration, batched "
             f"{dk * 1e6:.2f} us/iteration, throughput vs sequential "
             f"{CG_K * d1 / dk:.3f}; tol 1e-5 solve: iterations {its}, rms "
             f"errors vs (j+1)*ones {[f'{e:.3e}' for e in errs]}, on "
             f"{smi_line}")
        if not all(np.isfinite(e) and e <= CG_RMS_ERR for e in errs):
            _fail(f"batched cg {fmt}: rms errors {errs} > {CG_RMS_ERR}")
        if not (t1["median"] > 0 and tk["median"] > 0 and d1 > 0 and dk > 0):
            _fail(f"batched cg {fmt}: bad timing {t1}, {tk}, {d1}, {dk}")
        out[fmt] = {"single_us_per_iteration":
                    {key: v * 1e6 for key, v in t1.items()},
                    "batched_us_per_iteration":
                    {key: v * 1e6 for key, v in tk.items()},
                    "throughput_vs_sequential": th,
                    "rounds": CG_ROUNDS,
                    "device_single_us_per_iteration": d1 * 1e6,
                    "device_batched_us_per_iteration": dk * 1e6,
                    "device_throughput_vs_sequential": CG_K * d1 / dk,
                    "iterations": its, "rms_errors": errs}
        del A
        _sync(device)
    return out


# --------------------------------------------------------------- phase 10
def phase_kernels_wellcw(device, cw, smi_line, triad_gbps):
    """Each WELL-CW / CSR kernel alone at the full-size matrix: K3c, K3b
    and CSR, and K4a, K4c and the CSR SpMM at k = CW_SPMM_K, on its
    merged layout; K3a and K4b on its fallback layout."""
    import torch

    from spmv_tpu_torch.models import DeviceWellCw
    from spmv_tpu_torch.ops.wellcw_kernels import column_block

    f32 = torch.float32
    g = torch.Generator(device=device).manual_seed(1)
    x = torch.randn(cw.num_columns, device=device, dtype=f32, generator=g)
    X = torch.randn(cw.num_columns, CW_SPMM_K, device=device, dtype=f32,
                    generator=g)
    # 64 MiB written between launches evicts the 50 MB L2
    scratch = torch.empty(16 << 20, dtype=f32, device=device)
    found = {}
    for dev_kw in ({}, {"chunks_per_step": 64}):
        A = DeviceWellCw.from_host(cw, dtype=f32, device=device, **dev_kw)
        for spmm in (False, True):
            v = X if spmm else x
            for kname, run, plain, part in _cw_parts(A, spmm=spmm):
                if kname in found or (dev_kw and "level" not in kname):
                    continue
                out = torch.empty((A.num_rows,) + tuple(v.shape[1:]),
                                  dtype=f32, device=device)
                y1, y2 = run(v), run(v)
                _sync(device)
                if not torch.equal(y1, y2):
                    _fail(f"{kname} at full size: two launches differ")
                want = plain(v)
                err = float((y1.double() - want.double()).abs().max())
                rel = _rel(y1, want)
                if rel > TOL_F32:
                    _fail(f"{kname} at full size: rel err {rel} > "
                          f"{TOL_F32}")
                ms = _cold_graph_ms(lambda: run(v, out=out),
                                    lambda: scratch.fill_(0.0), 50)
                eager_ms = _time_launches(lambda: run(v, out=out), 50)
                plain_ms = _time_launches(lambda: plain(v), 3)
                k = CW_SPMM_K if spmm else 1
                if kname.startswith("csr"):
                    # one torch.sparse call computes the same product
                    S = _torch_csr(part.row_ptr, part.column_index,
                                   part.value, (A.num_rows, A.num_columns))
                    lib = _library_ms(S, v)
                    nnz, rows = part.num_entries, A.num_rows
                else:
                    lib = None
                    nnz = int((part.value != 0).sum())
                    rows = A.num_rows if not hasattr(part, "rowmap") else \
                        min(A.num_rows, 128 * int(part.rowmap.unique().numel()))
                b = _bound(_nbytes(*part.buffers(recurse=False))
                           + (A.num_columns + rows) * k * 4, 2 * nnz * k,
                           triad_gbps)
                found[kname] = {"max_abs_err": err, "ms": ms,
                                "plain_ms": plain_ms, "eager_ms": eager_ms,
                                "library_ms": lib, **b}
                what = ""
                if spmm:
                    kind = kname.split("_")[1]
                    rows = 128 if "pool" in kname else 64
                    if kind in ("merged", "level", "pool"):
                        kb = column_block(kind, f32, CW_SPMM_K, rows=rows)
                        found[kname]["columns_per_block"] = kb
                        what = f", {kb} columns a block"
                    what = f" k={CW_SPMM_K}{what}"
                _say(f"[10 wellcw kernels] {kname}{what}"
                     f"{' (chunks_per_step=64)' if dev_kw else ''}: "
                     f"{ms:.4f} ms on the device (CUDA graph, L2 flushed), "
                     f"{eager_ms:.4f} ms a call through the wrapper, plain "
                     f"{plain_ms:.4f} ms, "
                     + ("" if lib is None else
                        f"torch.sparse CSR {lib:.4f} ms, ")
                     + f"bound {b['bound_ms']:.4f} ms ({b['bound_by']}, "
                     f"{b['bytes']} B), max abs err {err:.3e} (rel "
                     f"{rel:.3e}), bitwise repeatable, on {smi_line}")
        del A
        _sync(device)
    missing = {"wellcw_merged", "wellcw_level", "wellcw_pool", "csr_spmv",
               "wellcw_merged_spmm", "wellcw_level_spmm",
               "wellcw_pool_spmm", "csr_spmm"} - set(found)
    if missing:
        _fail(f"full-size matrix did not reach {sorted(missing)}")
    return found


# ------------------------------------------------------- WELL (3, 11-13)
def _k1_seconds(dia, device) -> float:
    """K1's seconds per chained float32 SpMV on the host DIA matrix (the
    DIA yardstick of a WELL size that phase 5 does not run)."""
    import torch

    from spmv_tpu_torch.kernels import make_kernel
    from spmv_tpu_torch.profile import time_kernel

    kernel = make_kernel("dia", matrix=dia, device=device,
                         dtype=torch.float32)
    kernel.init()
    step, args = kernel.run_fn()
    return time_kernel(step, args, k_small=8, k_large=136,
                       runs=6).seconds_per_iteration


def _well_mm(kind, mod, *args):
    """The JAX WELL tests' hand-made matrices (tests/test_well.py): a
    near and a far diagonal in one row group (:192), two empty 8-group
    output blocks (:312), and a random band with unique entries
    (:163)."""
    if kind == "two_clusters":
        r = np.concatenate([np.arange(128)] * 2)
        c = np.concatenate([np.arange(128), np.arange(128) + 3000])
        n, m, v = 128, 4000, np.ones(r.size)
    elif kind == "empty_blocks":
        r = np.concatenate([np.arange(128), np.arange(2176, 2304)])
        c, n, m, v = r, 2304, 2304, np.ones(r.size)
    else:
        n, bw, per, seed = args
        rng = np.random.default_rng(seed)
        rows = np.repeat(np.arange(n), per)
        cols = np.clip(rows + rng.integers(-bw, bw + 1, rows.size), 0,
                       n - 1)
        key = np.unique(rows * n + cols)
        r, c, m = key // n, key % n, n
        v = rng.standard_normal(r.size)
    return mod.MatrixMarket("matrix", "coordinate", "real", "general", n, m,
                            r.size, r + 1, c + 1, v)


def _well_parts(A):
    """(kernel name, kernel call, plain call) of each launch that
    ``well_spmv_core`` makes for A: K5a or K5b, then the CSR spill."""
    from spmv_tpu_torch import ops

    seg = A.segment_of_step is not None
    core = ops.well_seg_core if seg else ops.well_whole_core
    parts = [("well_seg" if seg else "well_whole",
              lambda x, out=None: core(A, x, out=out),
              lambda x: ops.well_chunks_reference(A, x))]
    if A.spill is not None:
        R = A.spill
        parts.append(("csr_spmv",
                      lambda x, out=None: ops.csr_spmv_core(R, x, out=out),
                      lambda x: ops.csr_spmv_reference(R, x)))
    return parts


def _compare_well(name, w, dev_kw, dtype, device):
    """K5a / K5b and the spill's CSR kernel, each twice (bitwise equal)
    and against its plain version; the whole product against the plain
    composition and, in float32, the fp64 host product."""
    import torch

    from spmv_tpu_torch.models import DeviceWell
    from spmv_tpu_torch.ops import well_spmv_core, well_spmv_reference

    dtn = str(dtype).replace("torch.", "")
    tol = TOL_F64 if dtype == torch.float64 else TOL_F32
    A = DeviceWell.from_host(w, dtype=dtype, device=device, **dev_kw)
    g = torch.Generator(device=device).manual_seed(0)
    x = torch.randn(A.num_columns, generator=g, device=device, dtype=dtype)
    errs = []
    for kname, run, plain in _well_parts(A):
        y1, y2 = run(x), run(x)
        _sync(device)
        if not torch.equal(y1, y2):
            _fail(f"{kname} on {name} {dtn}: two launches differ")
        e = _rel(y1, plain(x))
        errs.append(f"{kname} {e:.3e}")
        if e > tol:
            _fail(f"{kname} on {name} {dtn}: rel err {e} > {tol}")
    y = well_spmv_core(A, x)
    _sync(device)
    e = _rel(y, well_spmv_reference(A, x))
    mode = ("whole x" if A.segment_rows is None else
            f"segment_rows {A.segment_rows}")
    line = (f"[3 compare] {name} {dtn} ({mode}, blocks_per_out "
            f"{A.blocks_per_out}, spill "
            f"{0 if A.spill is None else A.spill.num_entries}): "
            + ", ".join(errs) + f"; whole {e:.3e}")
    if e > tol:
        _fail(f"{line} > {tol}")
    if dtype == torch.float32:
        host = torch.from_numpy(w.spmv(x.double().cpu().numpy()))
        eh = _rel(y.cpu(), host)
        line += f", vs fp64 host {eh:.3e}"
        if eh > TOL_F32_HOST:
            _fail(f"{line} > {TOL_F32_HOST}")
    _say(line + " (each kernel twice, bitwise equal)")
    return A.segment_rows is not None


def phase_compare_well(device, cg_well):
    """K5a and K5b against their plain versions on the JAX WELL tests'
    kinds of matrix: whole x, forced segments of 4 and 2 rows (escaping
    slots spill), blocks_per_out 2 and 4, the empty-block matrix, a
    rectangular matrix and a banded matrix with a CSR spill; then K6a and
    K6b (and the spill's CSR SpMM) on the same matrices at k = 3 and 8,
    and at the batched-CG leg's shape (``cg_well``, k = CG_K, float32).
    Returns per SpMM kernel whether its columns equalled the SpMV
    kernel's bit for bit in every case."""
    import torch

    from spmv_tpu_torch import io as pio
    from spmv_tpu_torch.io.generate import (
        banded_random,
        poisson2d,
        random_sparse,
    )
    from spmv_tpu_torch.models import WellMatrix

    def well(mm, window_rows):
        return WellMatrix.from_matrix_market(mm, window_rows=window_rows)

    p = well(poisson2d(WELL_CLI_GRID, WELL_CLI_GRID), 4)
    cases = [
        (f"poisson2d({WELL_CLI_GRID},{WELL_CLI_GRID})", p, {}),
        (f"poisson2d({WELL_CLI_GRID},{WELL_CLI_GRID}) blocks_per_out=2", p,
         {"blocks_per_out": 2}),
        ("band(2000,60,5) segment_rows=4",
         well(_well_mm("band", pio, 2000, 60, 5, 30), 2),
         {"segment_rows": 4}),
        ("two clusters segment_rows=2",
         well(_well_mm("two_clusters", pio), 1), {"segment_rows": 2}),
        (f"poisson2d({WELL_CLI_GRID},{WELL_CLI_GRID}) segment_rows=8 "
         "blocks_per_out=4", p, {"segment_rows": 8, "blocks_per_out": 4}),
        ("empty blocks segment_rows=4",
         well(_well_mm("empty_blocks", pio), 1), {"segment_rows": 4}),
        ("random_sparse(200,150,5) rectangular",
         well(random_sparse(200, 150, 5, seed=6), 2), {}),
        ("banded_random(65536,512,8) spill",
         well(banded_random(65536, 512, 8, seed=3), 4), {}),
    ]
    seen = set()
    for name, w, dev_kw in cases:
        for dtype in (torch.float64, torch.float32):
            seen.add(_compare_well(name, w, dev_kw, dtype, device))
    if seen != {False, True}:
        _fail("the WELL comparisons did not reach both K5a and K5b")
    seen, bitwise = set(), {}
    for name, w, dev_kw in cases:
        for dtype in (torch.float64, torch.float32):
            for k in COMPARE_KS:
                seen.add(_compare_well_spmm(name, w, dev_kw, dtype, k,
                                            device, bitwise))
    if seen != {False, True}:
        _fail("the WELL SpMM comparisons did not reach both K6a and K6b")
    _compare_well_spmm(f"poisson2d({CG_GRID},{CG_GRID})", cg_well, {},
                       torch.float32, CG_K, device, bitwise)
    _say("[3 compare] WELL SpMM columns bitwise equal to the SpMV kernel's "
         "in every case: " + ", ".join(f"{n} {'yes' if b else 'no'}"
                                       for n, b in bitwise.items()))
    _sync(device)
    return bitwise


def phase_cli_well(device):
    from spmv_tpu_torch.io import write_matrix_market
    from spmv_tpu_torch.io.generate import poisson2d
    from spmv_tpu_torch.ops import well_whole_core

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "poisson.mtx")
        write_matrix_market(poisson2d(WELL_CLI_GRID, WELL_CLI_GRID), path)
        label = f"poisson2d({WELL_CLI_GRID},{WELL_CLI_GRID})"
        _say(f"[11 well cli] wrote {label}")
        argv = ["--matrix", path, "--spmv-format", "well"]
        _run_cli("11 well cli", [
            (f"profile {label}", argv + ["--profile", "5"],
             (well_whole_core,)),
            (f"cg {label}", argv + ["--cg", "2000"], (well_whole_core,)),
        ])
    _sync(device)


def phase_profile_well(device, mats, smi_line):
    """make_kernel("well").run_fn at each size of ``mats`` (label ->
    (host WellMatrix, whether K5b is expected, K1's seconds per SpMV on
    the same matrix)): the fp64 host checksum gate, seconds per chained
    SpMV (CUDA events) with the launch count equal to the chain length,
    the plain version's time and the fraction of the triad roofline.
    Returns per size its numbers and its DeviceWell."""
    import torch

    from spmv_tpu_torch.kernels import make_kernel
    from spmv_tpu_torch.ops import (
        csr_spmv_core,
        well_seg_core,
        well_spmv_reference,
        well_whole_core,
    )
    from spmv_tpu_torch.perfmodel import measured_machine
    from spmv_tpu_torch.profile import (
        profile_kernel_fn,
        profiling_report,
        time_kernel,
    )

    machine = measured_machine(device)
    out = {}
    for label, (w, segmented, t_k1) in mats.items():
        kernel = make_kernel("well", matrix=w, device=device,
                             dtype=torch.float32)
        kernel.init()
        t0 = time.perf_counter()
        step, args = kernel.run_fn()
        _sync(device)
        t_dev = time.perf_counter() - t0
        A = args[1]
        if (A.segment_of_step is not None) != segmented:
            _fail(f"well {label}: segmented mode is "
                  f"{A.segment_of_step is not None}, expected {segmented}")
        core = well_seg_core if segmented else well_whole_core
        _say(f"[12 well profile] {label} float32: {A.num_chunks} chunks, "
             f"segment_rows {A.segment_rows}, blocks_per_out "
             f"{A.blocks_per_out}, chunks_per_step {A.chunks_per_step}, "
             f"{A.num_out_blocks} output blocks, spill "
             f"{0 if A.spill is None else A.spill.num_entries} entries; "
             f"device packing and copy {t_dev:.1f} s")
        x = np.random.default_rng(0).standard_normal(
            w.num_columns).astype(np.float32)
        y = step(torch.from_numpy(x).to(device), A)
        got = float(y.abs().sum(dtype=torch.float32))
        want = float(np.abs(w.spmv(x.astype(np.float64))).sum())
        rel = abs(got - want) / want
        _say(f"[12 well profile] {label}: checksum rel err {rel:.3e} (gate "
             f"{CHECKSUM_RTOL})")
        if not rel <= CHECKSUM_RTOL:
            _fail(f"well {label} checksum gate: {rel} > {CHECKSUM_RTOL}")
        calls = [0]

        def counted(v, A, step=step):
            calls[0] += 1
            return step(v, A)

        before = (core.launches, csr_spmv_core.launches)
        timing = time_kernel(counted, args, k_small=8, k_large=136, runs=6)
        _sync(device)
        launched = (core.launches - before[0],
                    csr_spmv_core.launches - before[1])
        if launched != (calls[0], calls[0] if A.spill is not None else 0):
            _fail(f"well {label}: {launched} launches (K5, spill) for "
                  f"{calls[0]} chained SpMVs")
        runs = profile_kernel_fn(step, args, runs=5)
        doc = profiling_report(kernel, runs, timing.seconds_per_iteration,
                               5, True, machine=machine, device=device)
        t = doc["device_seconds_per_iteration"]
        if not (np.isfinite(t) and t > 0) or doc["device"]["platform"] != "gpu":
            _fail(f"well {label}: bad timing {t} on {doc['device']}")
        frac = doc["achieved"]["fraction_of_roofline"]
        t_plain = time_kernel(lambda v, A: well_spmv_reference(A, v),
                              (args[0], A), k_small=1, k_large=4,
                              runs=3).seconds_per_iteration
        _say(f"[12 well profile] {label}: SpMV {t * 1e3:.4f} ms "
             f"({w.num_entries / t / 1e9:.2f} Gnnz/s; {calls[0]} chained "
             f"SpMVs launched {core.__name__} {launched[0]} times and the "
             f"spill kernel {launched[1]} times), plain {t_plain * 1e3:.4f}"
             f" ms, fraction of the triad roofline {frac:.4f} "
             f"({kernel.bytes_per_run()} B at {machine.hbm_gbps:.1f} GB/s);"
             f" K1 (DIA) on the same matrix {t_k1 * 1e3:.4f} ms, on "
             f"{smi_line}")
        out[label] = {"A": A, "ms": t * 1e3, "plain_ms": t_plain * 1e3,
                      "k1_ms": t_k1 * 1e3, "roofline_fraction": frac,
                      "checksum_rel_err": rel, "chained": calls[0],
                      "launches": launched}
        del kernel, step, args, y
        _sync(device)
    return out


def _well_coo(A, spill: bool):
    """(rows, cols, values) on the card of the WELL chunks of A, and of
    its spill with ``spill``."""
    import torch

    k = A.chunks_per_step
    ws = A.window_start.transpose(1, 2).reshape(A.num_chunks, 8).long()
    if A.segment_of_step is not None:
        ws = ws + A.segment_of_step.long().repeat_interleave(k)[:, None]
    col = ws[:, :, None] * 128 + A.local_index.long()
    row = (A.group_of_chunk.reshape(-1).long()[:, None, None] * 128
           + torch.arange(128, device=col.device)).expand_as(col)
    keep = A.value != 0
    rows, cols, vals = [row[keep]], [col[keep]], [A.value[keep]]
    del col, row, keep
    if spill and A.spill is not None:
        R = A.spill
        rows.append(torch.repeat_interleave(
            torch.arange(R.num_rows, device=R.value.device),
            (R.row_ptr[1:] - R.row_ptr[:-1]).long()))
        cols.append(R.column_index.long())
        vals.append(R.value)
    return torch.cat(rows), torch.cat(cols), torch.cat(vals)


def phase_kernels_well(device, profiled, smi_line, triad_gbps):
    """K5a and K5b alone on the DeviceWell of each profiled size, and the
    spill's CSR kernel there: bitwise repeat, max error against the plain
    version, device ms (50 launches in a CUDA graph, the L2 flushed
    before each), ms a call through the wrapper, plain ms, the
    torch.sparse CSR product of the same entries (cuSPARSE) and the
    bound.  Not counted: the main path's counts were read before."""
    import torch

    f32 = torch.float32
    scratch = torch.empty(16 << 20, dtype=f32, device=device)
    found = {}
    for label, res in profiled.items():
        A = res["A"]
        g = torch.Generator(device=device).manual_seed(2)
        x = torch.randn(A.num_columns, generator=g, device=device, dtype=f32)
        out = torch.empty(A.num_rows, dtype=f32, device=device)
        for kname, run, plain in _well_parts(A):
            y1, y2 = run(x), run(x)
            _sync(device)
            if not torch.equal(y1, y2):
                _fail(f"{kname} on {label}: two launches differ")
            want = plain(x)
            err = float((y1.double() - want.double()).abs().max())
            rel = _rel(y1, want)
            if rel > TOL_F32:
                _fail(f"{kname} on {label}: rel err {rel} > {TOL_F32}")
            del y1, y2, want
            ms = _cold_graph_ms(lambda: run(x, out=out),
                                lambda: scratch.fill_(0.0), 50)
            eager_ms = _time_launches(lambda: run(x, out=out), 20)
            plain_ms = _time_launches(lambda: plain(x), 3)
            if kname == "csr_spmv":
                R = A.spill
                S = _torch_csr(R.row_ptr, R.column_index, R.value,
                               (R.num_rows, R.num_columns))
                b = _bound(_nbytes(R.row_ptr, R.column_index, R.value)
                           + (A.num_columns + A.num_rows) * 4,
                           2 * R.num_entries, triad_gbps)
            else:
                S = _csr_of_coo(*_well_coo(A, spill=False),
                                (A.num_rows, A.num_columns))
                b = _bound(_nbytes(A.value, A.local_index, A.window_start,
                                   A.group_of_chunk, A.segment_of_step,
                                   A.step_ptr)
                           + (A.num_columns + A.num_rows) * 4,
                           2 * int(S.values().numel()), triad_gbps)
            lib = _library_ms(S, x)
            del S
            row = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                   "eager_ms": eager_ms, "library_ms": lib, **b,
                   "shape": f"{label} float32"}
            _say(f"[13 well kernels] {kname} on {label}: {ms:.4f} ms on the "
                 f"device (CUDA graph, L2 flushed), {eager_ms:.4f} ms a "
                 f"call through the wrapper, plain {plain_ms:.4f} ms, "
                 f"torch.sparse CSR of the same entries {lib:.4f} ms, bound "
                 f"{b['bound_ms']:.4f} ms ({b['bound_by']}, {b['bytes']} B;"
                 f" {b['bound_triad_ms']:.4f} ms at the triad rate), max abs"
                 f" err {err:.3e} (rel {rel:.3e}), bitwise repeatable, on "
                 f"{smi_line}")
            found[(kname, label)] = row
        # the card's CSR SpMV of the whole matrix, the path's yardstick
        S = _csr_of_coo(*_well_coo(A, spill=True),
                        (A.num_rows, A.num_columns))
        res["library_ms"] = _library_ms(S, x)
        _say(f"[13 well kernels] {label}: torch.sparse CSR SpMV of the whole"
             f" matrix {res['library_ms']:.4f} ms against the chained WELL "
             f"SpMV's {res['ms']:.4f} ms")
        del S, A, res["A"]
        _sync(device)
    return found


# ------------------------------------------------ WELL SpMM (3, 14-16)
def _well_spmm_parts(A):
    """(kernel name, kernel call, plain call, SpMV kernel call) of each
    launch that ``well_spmm_core`` makes for A: K6a or K6b, then the CSR
    SpMM of the spill.  The kernel call takes X, an optional out buffer
    and (K6) an optional column-block width, which the wrapper leaves to
    its shared-memory budget: a width of the sweep launches one level
    below it."""
    from spmv_tpu_torch import ops
    from spmv_tpu_torch.ops.well_kernels import _launch_spmm

    seg = A.segment_of_step is not None
    core = ops.well_seg_spmm_core if seg else ops.well_whole_spmm_core
    spmv_core = ops.well_seg_core if seg else ops.well_whole_core
    name = "well_seg_spmm" if seg else "well_whole_spmm"

    def run(X, out=None, columns=None):
        if columns is None:
            return core(A, X, out=out)
        return _launch_spmm(core, name, A, X, out, seg, columns)

    parts = [(name, run,
              lambda X: ops.well_chunks_reference(A, X),
              lambda x: spmv_core(A, x))]
    if A.spill is not None:
        R = A.spill
        parts.append(("csr_spmm",
                      lambda X, out=None: ops.csr_spmm_core(R, X, out=out),
                      lambda X: ops.csr_spmv_reference(R, X),
                      lambda x: ops.csr_spmv_core(R, x)))
    return parts


def _host_spmm(host, X):
    """The fp64 host product of a host matrix with each column of X."""
    X = np.asarray(X, np.float64)
    return np.stack([host.spmv(X[:, j]) for j in range(X.shape[1])], 1)


def _compare_well_spmm(name, w, dev_kw, dtype, k, device, bitwise):
    """K6a / K6b and the spill's CSR SpMM, each twice (bitwise equal),
    against its plain version and, column by column, against the SpMV
    kernel (K5, CSR) on that column; the whole SpMM against the plain
    composition and, in float32, the fp64 host product.  ``bitwise``
    records per kernel whether every column equalled the SpMV kernel's
    bit for bit."""
    import torch

    from spmv_tpu_torch.models import DeviceWell
    from spmv_tpu_torch.ops import well_spmm_core, well_spmv_reference

    dtn = str(dtype).replace("torch.", "")
    tol = TOL_F64 if dtype == torch.float64 else TOL_F32
    A = DeviceWell.from_host(w, dtype=dtype, device=device, **dev_kw)
    g = torch.Generator(device=device).manual_seed(0)
    X = torch.randn(A.num_columns, k, generator=g, device=device,
                    dtype=dtype)
    errs = []
    for kname, run, plain, run1 in _well_spmm_parts(A):
        Y1, Y2 = run(X), run(X)
        cols = torch.stack([run1(X[:, j].contiguous()) for j in range(k)],
                           dim=1)
        _sync(device)
        if not torch.equal(Y1, Y2):
            _fail(f"{kname} on {name} {dtn} k={k}: two launches differ")
        e, ec = _rel(Y1, plain(X)), _rel(Y1, cols)
        same = torch.equal(Y1, cols)
        bitwise[kname] = bitwise.get(kname, True) and same
        errs.append(f"{kname} {e:.3e} (vs SpMV kernel {ec:.3e}"
                    f"{', bitwise' if same else ''})")
        if e > tol or ec > tol:
            _fail(f"{kname} on {name} {dtn} k={k}: rel err {e} / {ec} "
                  f"> {tol}")
    Y = well_spmm_core(A, X)
    _sync(device)
    e = _rel(Y, well_spmv_reference(A, X))
    line = (f"[3 compare] {name} {dtn} k={k}: " + ", ".join(errs)
            + f"; whole {e:.3e}")
    if e > tol:
        _fail(f"{line} > {tol}")
    if dtype == torch.float32:
        host = torch.from_numpy(_host_spmm(w, X.double().cpu().numpy()))
        eh = _rel(Y.cpu(), host)
        line += f", vs fp64 host {eh:.3e}"
        if eh > TOL_F32_HOST:
            _fail(f"{line} > {TOL_F32_HOST}")
    _say(line + " (each kernel twice, bitwise equal)")
    return A.segment_rows is not None


def _bsr_blocklets(bh: int, n: int = 1024):
    """Dense 8 x 128 blocklets at random (tests/test_bsr.py:172), packed
    at block height bh."""
    from spmv_tpu_torch.io.generate import random_sparse
    from spmv_tpu_torch.models import BsrMatrix

    rng = np.random.default_rng(bh)
    base = random_sparse(n // 8, n // 128, 2, seed=bh)
    rows = np.repeat((base.rows_1based - 1) * 8, 8 * 128) \
        + np.tile(np.repeat(np.arange(8), 128), base.num_entries)
    cols = np.repeat((base.cols_1based - 1) * 128, 8 * 128) \
        + np.tile(np.arange(128), 8 * base.num_entries)
    return BsrMatrix._build(n, n, rows, cols, rng.standard_normal(rows.size),
                            None, bh)


def phase_compare_bsr(device):
    """K7 against its plain version on block matrices: block heights 8,
    32 and 128, blocks_per_step 1, 3 and 8, an empty block row and a 300 x
    200 shape; float64, float32 and bf16 blocks; k = 1, 3 and BSR_K:
    twice (bitwise equal), and float32 / float64 against the fp64 host
    product, bf16 within the JAX test's bound of it."""
    import torch

    from spmv_tpu_torch.io.generate import random_sparse
    from spmv_tpu_torch.io.matrix_market import MatrixMarket
    from spmv_tpu_torch.models import BsrMatrix, DeviceBsr
    from spmv_tpu_torch.ops import bsr_spmm_core, bsr_spmm_reference

    empty = BsrMatrix.from_matrix_market(MatrixMarket(
        "matrix", "coordinate", "real", "general", 384, 384, 2,
        np.array([1, 384]), np.array([1, 384]), np.array([2.0, 3.0])))
    cases = [("bh 8, blocks_per_step 8", _bsr_blocklets(8), 8),
             ("bh 32, blocks_per_step 3", _bsr_blocklets(32), 3),
             ("bh 128, blocks_per_step 1", _bsr_blocklets(128), 1),
             ("empty block row", empty, 8),
             ("random_sparse(300,200,4)", BsrMatrix.from_matrix_market(
                 random_sparse(300, 200, 4, seed=3)), 8)]
    for name, b, kb in cases:
        for dtype in (torch.float64, torch.float32, torch.bfloat16):
            dtn = str(dtype).replace("torch.", "")
            A = DeviceBsr.from_host(b, dtype=dtype, blocks_per_step=kb,
                                    device=device)
            errs = []
            for k in (1, 3, BSR_K):
                g = torch.Generator(device=device).manual_seed(k)
                X = torch.randn(A.num_columns, k, generator=g,
                                device=device).to(dtype)
                Y1, Y2 = bsr_spmm_core(A, X), bsr_spmm_core(A, X)
                _sync(device)
                if not torch.equal(Y1, Y2):
                    _fail(f"bsr_spmm on {name} {dtn} k={k}: two launches "
                          "differ")
                tol = {"float64": TOL_F64, "float32": TOL_F32,
                       "bfloat16": TOL_BSR_BF16}[dtn]
                e = _rel(Y1, bsr_spmm_reference(A, X))
                host = torch.from_numpy(b.spmm(X.double().cpu().numpy()))
                eh = _rel(Y1.cpu(), host)
                th = TOL_BF16_HOST if dtype == torch.bfloat16 else tol
                errs.append(f"k={k} {e:.3e} (fp64 host {eh:.3e})")
                if e > tol or eh > th:
                    _fail(f"bsr_spmm on {name} {dtn} k={k}: rel err {e} > "
                          f"{tol} or vs host {eh} > {th}")
            _say(f"[3 compare] bsr {name} {dtn} (Y "
                 f"{str(Y1.dtype).replace('torch.', '')}): "
                 + ", ".join(errs) + " (each twice, bitwise equal)")
            del A
    _sync(device)


def phase_cli_well_spmm(device):
    from spmv_tpu_torch.io import write_matrix_market
    from spmv_tpu_torch.io.generate import poisson2d
    from spmv_tpu_torch.ops import well_whole_spmm_core

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "poisson.mtx")
        write_matrix_market(poisson2d(WELL_CLI_GRID, WELL_CLI_GRID), path)
        label = f"poisson2d({WELL_CLI_GRID},{WELL_CLI_GRID})"
        _say(f"[14 well spmm cli] wrote {label}")
        argv = ["--matrix", path, "--spmv-format", "well"]
        _run_cli("14 well spmm cli", [
            (f"spmm k={WELL_SPMM_K} {label}",
             argv + ["--profile", "5", "--spmm", str(WELL_SPMM_K)],
             (well_whole_spmm_core,)),
            (f"cg nrhs={CLI_NRHS} {label}",
             argv + ["--cg", "2000", "--nrhs", str(CLI_NRHS)],
             (well_whole_spmm_core,)),
        ])
    _sync(device)


def phase_profile_well_spmm(device, mats, smi_line):
    """make_kernel("well").spmm_fn(WELL_SPMM_K) on each host matrix of
    ``mats`` (label -> (host WellMatrix, whether K6b is expected, its DIA
    host matrix for the fp64 checksum, the SpMV's seconds of phase 12)):
    the fp64 host checksum gate, seconds per chained SpMM (CUDA events)
    with the launch counts equal to the chain length, the plain version's
    time, the fraction of the triad roofline with the CLI's byte count and
    the per-nnz cost against the SpMV.  Returns per size its numbers and
    its DeviceWell."""
    import torch

    from spmv_tpu_torch.kernels import make_kernel
    from spmv_tpu_torch.ops import (
        csr_spmm_core,
        well_seg_spmm_core,
        well_spmv_reference,
        well_whole_spmm_core,
    )
    from spmv_tpu_torch.ops.well_kernels import well_column_block
    from spmv_tpu_torch.perfmodel import measured_machine
    from spmv_tpu_torch.profile import (
        profile_kernel_fn,
        profiling_report,
        time_kernel,
    )

    k = WELL_SPMM_K
    machine = measured_machine(device)
    out = {}
    for label, (w, segmented, dia, t_spmv) in mats.items():
        kernel = make_kernel("well", matrix=w, device=device,
                             dtype=torch.float32)
        kernel.init()
        step, args = kernel.spmm_fn(k)
        A = args[1]
        if (A.segment_of_step is not None) != segmented:
            _fail(f"well spmm {label}: segmented mode is "
                  f"{A.segment_of_step is not None}, expected {segmented}")
        core = well_seg_spmm_core if segmented else well_whole_spmm_core
        kc = well_column_block(torch.float32, k, A.out_rows)
        X = np.random.default_rng(0).standard_normal(
            (w.num_columns, k)).astype(np.float32)
        Y = step(torch.from_numpy(X).to(device), A)
        got = float(Y.abs().sum(dtype=torch.float32))
        want = float(np.abs(_host_spmm(dia, X)).sum())
        rel = abs(got - want) / want
        _say(f"[15 well spmm] {label} float32 k={k}: {A.num_out_blocks} "
             f"output blocks of {A.out_rows} groups, {kc} columns a block; "
             f"checksum rel err {rel:.3e} against the fp64 host product "
             f"(gate {CHECKSUM_RTOL})")
        if not rel <= CHECKSUM_RTOL:
            _fail(f"well spmm {label} checksum gate: {rel} > "
                  f"{CHECKSUM_RTOL}")
        calls = [0]

        def counted(V, A, step=step):
            calls[0] += 1
            return step(V, A)

        before = (core.launches, csr_spmm_core.launches)
        timing = time_kernel(counted, args, k_small=4, k_large=40, runs=6)
        _sync(device)
        launched = (core.launches - before[0],
                    csr_spmm_core.launches - before[1])
        if launched != (calls[0], calls[0] if A.spill is not None else 0):
            _fail(f"well spmm {label}: {launched} launches (K6, spill) for "
                  f"{calls[0]} chained SpMMs")
        runs = profile_kernel_fn(step, args, runs=5)
        m = kernel.matrix
        nbytes = kernel.bytes_per_run() + (k - 1) * (
            m.num_columns + m.num_rows) * kernel.value_bytes
        doc = profiling_report(kernel, runs, timing.seconds_per_iteration,
                               5, True, machine=machine, device=device,
                               op_info={"kind": "spmm", "k": k},
                               flops_per_run=k * kernel.flops_per_run(),
                               bytes_per_run=nbytes)
        t = doc["device_seconds_per_iteration"]
        if not (np.isfinite(t) and t > 0) or doc["device"]["platform"] != "gpu":
            _fail(f"well spmm {label}: bad timing {t} on {doc['device']}")
        frac = doc["achieved"]["fraction_of_roofline"]
        t_plain = time_kernel(lambda V, A: well_spmv_reference(A, V),
                              (args[0], A), k_small=1, k_large=3,
                              runs=2).seconds_per_iteration
        per_nnz = (t / k) / t_spmv
        _say(f"[15 well spmm] {label}: SpMM k={k} {t * 1e3:.4f} ms "
             f"({w.num_entries * k / t / 1e9:.2f} effective Gnnz/s; "
             f"{calls[0]} chained SpMMs launched {core.__name__} "
             f"{launched[0]} times and the spill's CSR SpMM {launched[1]} "
             f"times), plain {t_plain * 1e3:.4f} ms, fraction of the triad "
             f"roofline {frac:.4f} ({nbytes} B at {machine.hbm_gbps:.1f} "
             f"GB/s); per nnz against the SpMV {per_nnz:.4f} ((t / {k}) / "
             f"{t_spmv * 1e3:.4f} ms), on {smi_line}")
        out[label] = {"A": A, "k": k, "columns_per_block": kc,
                      "ms": t * 1e3, "plain_ms": t_plain * 1e3,
                      "roofline_fraction": frac, "checksum_rel_err": rel,
                      "per_nnz_vs_spmv": per_nnz, "chained": calls[0],
                      "launches": launched}
        del kernel, step, args, Y
        _sync(device)
    return out


# ------------------------------------------------------ BSR (17-18)
def _bsr_regime(num_columns: int, k: int, itemsize: int) -> str:
    """Which Pallas kernel the JAX ``bsr_spmm`` would take for k columns
    of X over num_columns (padded to whole blocks) in blocks of
    ``itemsize`` bytes: K7b (``bsr_spmm_wholex``) while X fits its 80 MB,
    K7a (``bsr_spmm``) past it.  One CUDA kernel serves both."""
    x_bytes = -(-num_columns // 128) * 128 * k * itemsize
    return "bsr_spmm_wholex" if x_bytes <= BSR_WHOLEX_BYTES else "bsr_spmm"


def phase_cli_bsr(device):
    """-s bsr (--profile with --spmm, and --cg) on a small poisson2d, and
    -s auto --spmm on a small block_random, whose report must name bsr.
    Returns the K7 launches by regime: all K7b, which is checked for each
    run's X in the CLI's value dtype."""
    from spmv_tpu_torch.io import write_matrix_market
    from spmv_tpu_torch.io.generate import block_random, poisson2d
    from spmv_tpu_torch.models import default_value_dtype
    from spmv_tpu_torch.ops import bsr_spmm_core

    itemsize = default_value_dtype().itemsize
    for n, k in ((BSR_CLI_GRID ** 2, 16), (BSR_CLI_GRID ** 2, 1),
                 (BSR_CLI_BLOCK_ROWS, BSR_K)):
        if _bsr_regime(n, k, itemsize) != "bsr_spmm_wholex":
            _fail(f"the BSR CLI's X ({n} x {k}) passes the 80 MB line: its "
                  "launches would not all be K7b's")
    before = bsr_spmm_core.launches
    with tempfile.TemporaryDirectory() as tmp:
        paths = {"poisson": os.path.join(tmp, "poisson.mtx"),
                 "blocks": os.path.join(tmp, "blocks.mtx")}
        write_matrix_market(poisson2d(BSR_CLI_GRID, BSR_CLI_GRID),
                            paths["poisson"])
        write_matrix_market(block_random(BSR_CLI_BLOCK_ROWS,
                                         BSR_CLI_BLOCK_ROWS, 4, seed=5),
                            paths["blocks"])
        p = f"poisson2d({BSR_CLI_GRID},{BSR_CLI_GRID})"
        b = f"block_random({BSR_CLI_BLOCK_ROWS},{BSR_CLI_BLOCK_ROWS},4)"
        _say(f"[17 bsr cli] wrote {p} and {b}")
        docs = _run_cli("17 bsr cli", [
            (f"bsr spmm k=16 {p}", ["--matrix", paths["poisson"], "-s", "bsr",
                                    "--profile", "5", "--spmm", "16"],
             (bsr_spmm_core,)),
            (f"bsr cg {p}", ["--matrix", paths["poisson"], "-s", "bsr",
                             "--cg", "500"], (bsr_spmm_core,)),
            (f"auto spmm k={BSR_K} {b}",
             ["--matrix", paths["blocks"], "-s", "auto", "--profile", "3",
              "--spmm", str(BSR_K)], (bsr_spmm_core,)),
        ])
    fmt = docs[-1]["kernel"]["matrix_format"]
    _say(f"[17 bsr cli] -s auto --spmm {BSR_K} chose {fmt}")
    if fmt != "bsr":
        _fail(f"-s auto --spmm on {b} chose {fmt}, not bsr")
    _sync(device)
    return {"bsr_spmm_wholex": bsr_spmm_core.launches - before}


def _bsr_library(A, X):
    """One ``torch.sparse`` BSR product of A's stored blocks with X (a
    yardstick the port never calls): (a function of no arguments, None),
    or (None, why torch refused the dtype or block shape)."""
    import torch

    try:
        S = torch.sparse_bsr_tensor(
            A.row_ptr, A.block_col, A.blocks,
            size=(A.num_block_rows * A.block_rows, A.num_block_cols * 128))
        Xp = X.new_zeros((A.num_block_cols * 128, X.shape[1]))
        Xp[: X.shape[0]] = X
        S @ Xp
        _sync(X.device)
        return (lambda: S @ Xp), None
    except (RuntimeError, NotImplementedError, ValueError) as e:
        return None, f"{type(e).__name__}: {str(e).splitlines()[0][:160]}"


def _bsr_leg(tag, host, dtype, device, smi_line, triad_gbps, gate):
    """make_kernel("bsr", matrix=host).spmm_fn(BSR_K) in ``dtype`` blocks:
    the fp64 host checksum gate, seconds per chained SpMM (CUDA events)
    with one launch a step, TFLOP/s, the bound, the plain version's ms and
    the library's.  Returns its numbers, its DeviceBsr, its X and its
    launches by regime."""
    import torch

    from spmv_tpu_torch.kernels import make_kernel
    from spmv_tpu_torch.ops import bsr_spmm_core, bsr_spmm_reference
    from spmv_tpu_torch.profile import time_kernel

    k = BSR_K
    dtn = str(dtype).replace("torch.", "")
    kernel = make_kernel("bsr", matrix=host, device=device, dtype=dtype)
    kernel.init()
    step, args = kernel.spmm_fn(k)
    A = args[1]
    regime = _bsr_regime(A.num_columns, k, A.blocks.element_size())
    X = np.random.default_rng(0).standard_normal(
        (host.num_columns, k)).astype(np.float32)
    Xd = torch.from_numpy(X).to(device)
    before = bsr_spmm_core.launches
    Y = step(Xd, A)
    got = float(Y.abs().sum(dtype=torch.float32))
    want = float(np.abs(host.spmm(X.astype(np.float64))).sum())
    rel = abs(got - want) / want
    _say(f"[{tag}] {dtn} blocks (bh {A.block_rows}, {A.num_blocks} stored "
         f"blocks of which {host.num_blocks} the host's, "
         f"{A.num_block_rows} block rows), k={k}, X "
         f"{A.num_block_cols * 128 * k * A.blocks.element_size()} B ({regime}"
         f" regime): checksum rel err {rel:.3e} (gate {gate})")
    if not rel <= gate:
        _fail(f"bsr {dtn} checksum gate: {rel} > {gate}")
    calls = [1]                  # the checksum's step

    def counted(V, A):
        calls[0] += 1
        return step(V, A)

    t = time_kernel(counted, args, k_small=4, k_large=24,
                    runs=6).seconds_per_iteration
    _sync(device)
    launched = bsr_spmm_core.launches - before
    if launched != calls[0]:
        _fail(f"bsr {dtn}: {launched} launches for {calls[0]} SpMMs")
    if not (np.isfinite(t) and t > 0):
        _fail(f"bsr {dtn}: bad timing {t}")
    Xb = Xd.to(dtype)
    plain_ms = _time_launches(lambda: bsr_spmm_reference(A, Xb), 3)
    lib, why = _bsr_library(A, Xb)
    lib_ms = None if lib is None else _time_launches(lib, 10)
    # the bound counts the host's blocks, not the zero blocks that pad
    # each block row to a multiple of blocks_per_step
    nb = host.num_blocks
    flops = 2 * nb * A.block_rows * 128 * k
    acc = 4 if dtype == torch.bfloat16 else A.blocks.element_size()
    b = _bound(nb * (A.block_rows * 128 * A.blocks.element_size() + 4)
               + _nbytes(A.row_ptr, Xb) + A.num_rows * k * acc, flops,
               triad_gbps,
               peak=PEAK_BF16_FLOPS if dtype == torch.bfloat16
               else PEAK_F32_FLOPS)
    _say(f"[{tag}] {dtn}: SpMM k={k} {t * 1e3:.4f} ms chained "
         f"({flops / t / 1e12:.2f} TFLOP/s; {calls[0]} SpMMs, the checksum"
         f"'s included, {launched} launches), bound {b['bound_ms']:.4f} ms "
         f"({b['bound_by']}: {b['bytes']} B, {flops} flops), plain "
         f"{plain_ms:.4f} ms, one torch.sparse BSR product "
         + (f"{lib_ms:.4f} ms" if lib is not None else f"refused ({why})")
         + f", on {smi_line}")
    res = {"ms": t * 1e3, "tflops": flops / t / 1e12, "plain_ms": plain_ms,
           "library_ms": lib_ms, "checksum_rel_err": rel, **b,
           "chained": calls[0]}
    if why is not None:
        res["library_refused"] = why
    del kernel, step, args, Y, Xb
    _sync(device)
    return res, A, Xd, {regime: launched}


def phase_bsr_legs(device, smi_line, triad_gbps):
    """The JAX bench's BSR leg (bench.py:487-545): block_random(131072,
    131072, 8, seed=2) through the port's auto_format(workload="spmm"),
    which must pick bsr, then K7 at k = 128 with float32 and bf16 blocks;
    and K7 past the 80 MB line: block_random(262144, 262144, 2, seed=3),
    float32.  Returns the numbers, the containers and X for the kernels
    alone, and the K7 launches by regime."""
    import torch

    from spmv_tpu_torch.io.generate import block_random
    from spmv_tpu_torch.models import BsrMatrix, auto_format

    t0 = time.perf_counter()
    mm = block_random(BSR_ROWS, BSR_ROWS, 8, seed=2)
    t1 = time.perf_counter()
    host, why = auto_format(mm, workload="spmm")
    t2 = time.perf_counter()
    label = f"block_random({BSR_ROWS},{BSR_ROWS},8)"
    _say(f"[18 bsr] host {label}: {mm.num_entries} entries, generated in "
         f"{t1 - t0:.1f} s; auto_format(workload='spmm') chose "
         f"{why['format']} (fill {why.get('bsr_fill', float('nan')):.3f}, "
         f"block_rows {why.get('bsr_block_rows')}) in {t2 - t1:.1f} s")
    if why["format"] != "bsr":
        _fail(f"auto_format chose {why['format']} for {label}, not bsr")
    del mm
    out, launches, keep = {"shape": f"{label}, k={BSR_K}"}, {}, {}
    for dtype, gate in ((torch.float32, CHECKSUM_RTOL),
                        (torch.bfloat16, BF16_CHECKSUM_RTOL)):
        dtn = str(dtype).replace("torch.", "")
        res, A, X, n = _bsr_leg("18 bsr", host, dtype, device, smi_line,
                                triad_gbps, gate)
        out[dtn] = res
        keep[dtn] = (A, X)
        for r, c in n.items():
            launches[r] = launches.get(r, 0) + c
    out["bf16_speedup_vs_f32"] = out["float32"]["ms"] / out["bfloat16"]["ms"]
    del host
    t0 = time.perf_counter()
    far_label = f"block_random({BSR_FAR_ROWS},{BSR_FAR_ROWS},2)"
    far = BsrMatrix.from_matrix_market(
        block_random(BSR_FAR_ROWS, BSR_FAR_ROWS, 2, seed=3),
        block_rows="auto")
    _say(f"[18 bsr] host {far_label}: {far.num_entries} entries, BSR at "
         f"block_rows {far.block_rows} in {time.perf_counter() - t0:.1f} s")
    res, A, X, n = _bsr_leg("18 bsr far", far, torch.float32, device,
                            smi_line, triad_gbps, CHECKSUM_RTOL)
    for r, c in n.items():
        launches[r] = launches.get(r, 0) + c
    out["far"] = {**res, "shape": f"{far_label}, k={BSR_K}"}
    keep["far"] = (A, X)
    del far
    _sync(device)
    return out, keep, launches


# ------------------------------------------------------------ phase 19
def phase_kernels_spmm(device, well_profiled, bsr_keep, smi_line,
                       triad_gbps):
    """K6a / K6b on the DeviceWell of each size of phase 15 (k =
    WELL_SPMM_K, at the budget's column block and at the other widths
    that fit), and K7 on the bench's BSR leg (float32 and bf16 blocks)
    and past the 80 MB line: bitwise repeat, max error against the plain
    version, device ms (a CUDA graph, the L2 flushed before each launch),
    ms a call through the wrapper, plain ms, one torch.sparse product of
    the same entries (cuSPARSE) and the bound.  Not counted: the main
    path's counts were read before."""
    import torch

    from spmv_tpu_torch.ops import bsr_spmm_core, bsr_spmm_reference
    from spmv_tpu_torch.ops.well_kernels import SMEM_MAX

    f32 = torch.float32
    k = WELL_SPMM_K
    scratch = torch.empty(16 << 20, dtype=f32, device=device)
    found = {}
    for label, res in well_profiled.items():
        A = res["A"]
        g = torch.Generator(device=device).manual_seed(2)
        X = torch.randn(A.num_columns, k, generator=g, device=device,
                        dtype=f32)
        out = torch.empty(A.num_rows, k, dtype=f32, device=device)
        kname, run, plain, _ = _well_spmm_parts(A)[0]
        want = plain(X)
        plain_ms = _time_launches(lambda: plain(X), 2)
        S = _csr_of_coo(*_well_coo(A, spill=False),
                        (A.num_rows, A.num_columns))
        lib = _library_ms(S, X, reps=10)
        nnz = int(S.values().numel())
        del S
        b = _bound(_nbytes(A.value, A.local_index, A.window_start,
                           A.group_of_chunk, A.segment_of_step, A.step_ptr)
                   + (A.num_columns + A.num_rows) * k * 4, 2 * nnz * k,
                   triad_gbps)
        default = res["columns_per_block"]
        by_width = {}
        for kc in sorted({default, 1, 2, 4, 8}):
            if A.out_rows * kc * 128 * 4 > SMEM_MAX:
                continue
            Y1, Y2 = run(X, columns=kc), run(X, columns=kc)
            _sync(device)
            if not torch.equal(Y1, Y2):
                _fail(f"{kname} on {label} ({kc} columns a block): two "
                      "launches differ")
            err = float((Y1.double() - want.double()).abs().max())
            rel = _rel(Y1, want)
            if rel > TOL_F32:
                _fail(f"{kname} on {label}: rel err {rel} > {TOL_F32}")
            ms = _cold_graph_ms(lambda: run(X, out=out, columns=kc),
                                lambda: scratch.fill_(0.0), 20)
            eager_ms = _time_launches(lambda: run(X, out=out, columns=kc), 10)
            by_width[kc] = {"ms": ms, "eager_ms": eager_ms,
                            "max_abs_err": err}
            _say(f"[19 spmm kernels] {kname} on {label} k={k}, {kc} columns"
                 f" a block{' (the budget default)' if kc == default else ''}"
                 f": {ms:.4f} ms on the device (CUDA graph, L2 flushed), "
                 f"{eager_ms:.4f} ms a call through the wrapper, plain "
                 f"{plain_ms:.4f} ms, torch.sparse CSR of the same entries "
                 f"{lib:.4f} ms, bound {b['bound_ms']:.4f} ms "
                 f"({b['bound_by']}, {b['bytes']} B; {b['bound_triad_ms']:.4f}"
                 f" ms at the triad rate), max abs err {err:.3e} (rel "
                 f"{rel:.3e}), bitwise repeatable, on {smi_line}")
            del Y1, Y2
        found[kname] = {**by_width[default], "plain_ms": plain_ms,
                        "library_ms": lib, **b,
                        "columns_per_block": default,
                        "ms_by_columns_per_block":
                            {str(c): v["ms"] for c, v in by_width.items()},
                        "shape": f"{label} float32, k={k}"}
        del want, out, X, A, res["A"]
        _sync(device)
    for key, (A, X) in bsr_keep.items():
        dtype = A.blocks.dtype
        kname = _bsr_regime(A.num_columns, X.shape[1],
                            A.blocks.element_size())
        Xb = X.to(dtype)
        Y1, Y2 = bsr_spmm_core(A, Xb), bsr_spmm_core(A, Xb)
        _sync(device)
        if not torch.equal(Y1, Y2):
            _fail(f"bsr_spmm {key}: two launches differ")
        want = bsr_spmm_reference(A, Xb)
        err = float((Y1.double() - want.double()).abs().max())
        rel = _rel(Y1, want)
        tol = TOL_BSR_BF16 if dtype == torch.bfloat16 else TOL_F32
        if rel > tol:
            _fail(f"bsr_spmm {key}: rel err {rel} > {tol}")
        out = torch.empty_like(Y1)
        del Y1, Y2, want
        ms = _cold_graph_ms(lambda: bsr_spmm_core(A, Xb, out=out),
                            lambda: scratch.fill_(0.0), 10)
        eager_ms = _time_launches(lambda: bsr_spmm_core(A, Xb, out=out), 5)
        found[(kname, key)] = {"max_abs_err": err, "ms": ms,
                               "eager_ms": eager_ms}
        _say(f"[19 spmm kernels] K7 ({kname} regime) on the "
             f"{'far' if key == 'far' else 'bench'} matrix, "
             f"{str(dtype).replace('torch.', '')} blocks, k={X.shape[1]}: "
             f"{ms:.4f} ms on the device (CUDA graph, L2 flushed), "
             f"{eager_ms:.4f} ms a call through the wrapper, max abs err "
             f"{err:.3e} (rel {rel:.3e}), bitwise repeatable, on {smi_line}")
        del out, Xb
        _sync(device)
    return found


# ----------------------------------------------------------------- main
def main() -> int:
    device, smi_line = phase_device()

    import torch

    from spmv_tpu_torch.io.generate import banded_random, poisson2d
    from spmv_tpu_torch.models import DiaMatrix, WellCwMatrix, WellMatrix
    from spmv_tpu_torch.ops import (
        bsr_spmm_core,
        csr_spmm_core,
        csr_spmv_core,
        dia_spmm_core,
        dia_spmv_core,
        well_seg_core,
        well_seg_spmm_core,
        well_whole_core,
        well_whole_spmm_core,
        wellcw_level_core,
        wellcw_level_spmm_core,
        wellcw_merged_core,
        wellcw_merged_spmm_core,
        wellcw_pool_core,
        wellcw_pool_spmm_core,
    )

    phase_build()
    from spmv_tpu_torch.perfmodel import measured_machine

    triad_gbps = measured_machine(device).hbm_gbps
    t0 = time.perf_counter()
    full_mm = poisson2d(FULL_GRID, FULL_GRID)
    full = DiaMatrix.from_matrix_market(full_mm)
    _say(f"[3 compare] host poisson2d({FULL_GRID},{FULL_GRID}): "
         f"{full.num_rows} rows, {full.num_entries} entries, "
         f"{full.num_diagonals} diagonals, built in "
         f"{time.perf_counter() - t0:.1f} s")
    errs = phase_compare(device, full)
    t0 = time.perf_counter()
    cg_mm = poisson2d(CG_GRID, CG_GRID)
    cg_mats = {"dia": DiaMatrix.from_matrix_market(cg_mm),
               "wellcw": WellCwMatrix.from_matrix_market(cg_mm)}
    cg_well = WellMatrix.from_matrix_market(cg_mm, window_rows=4)
    _say(f"[3 compare] host poisson2d({CG_GRID},{CG_GRID}): "
         f"{cg_mm.num_rows} rows, {cg_mm.num_entries} entries, DIA, "
         f"WELL-CW and WELL built in {time.perf_counter() - t0:.1f} s")
    del cg_mm
    bitwise = phase_compare_wellcw(device, cg_mats)
    well_bitwise = phase_compare_well(device, cg_well)
    phase_compare_bsr(device)

    # the DIA path's run: its counts start from zero here
    dia_spmv_core.launches = 0
    dia_spmm_core.launches = 0
    phase_cli(device)
    times, dia_extra = phase_profile(device, full, full_mm, smi_line)
    launches = {"dia_spmv": dia_spmv_core.launches,
                "dia_spmm": dia_spmm_core.launches}

    # the WELL-CW path's run (SpMV, SpMM, batched CG): its counts start
    # from zero here
    cw_wrappers = {"wellcw_merged": wellcw_merged_core,
                   "wellcw_level": wellcw_level_core,
                   "wellcw_pool": wellcw_pool_core,
                   "csr_spmv": csr_spmv_core,
                   "wellcw_merged_spmm": wellcw_merged_spmm_core,
                   "wellcw_level_spmm": wellcw_level_spmm_core,
                   "wellcw_pool_spmm": wellcw_pool_spmm_core,
                   "csr_spmm": csr_spmm_core}
    for w in cw_wrappers.values():
        w.launches = 0
    phase_cli_wellcw(device)
    t0 = time.perf_counter()
    cw_mm = banded_random(CW_FULL_ROWS, half_bandwidth=CW_FULL_HALF_BW,
                          nnz_per_row=8, seed=1)
    cw = WellCwMatrix.from_matrix_market(cw_mm)
    _say(f"[7 wellcw profile] host banded_random({CW_FULL_ROWS}, "
         f"{CW_FULL_HALF_BW}, 8): {cw.num_entries} entries, packed in "
         f"{time.perf_counter() - t0:.1f} s")
    cw_times = phase_profile_wellcw(device, cw, cw_mm, smi_line)
    spmm_times = phase_profile_wellcw_spmm(device, cw, cw_mm, smi_line,
                                           cw_times["ms"] * 1e-3)
    cg_times = phase_batched_cg(device, cg_mats, smi_line)
    launches.update({k: w.launches for k, w in cw_wrappers.items()})
    _say("[9 batched cg] launches on the WELL-CW path: "
         + ", ".join(f"{k} {launches[k]}" for k in cw_wrappers))
    for name, n in launches.items():
        if n <= 0:
            _fail(f"{name} was never launched on the main path")
    cw_kernels = phase_kernels_wellcw(device, cw, smi_line, triad_gbps)
    del cw, cw_mm
    _sync(device)

    # the WELL path's run (CLI, then make_kernel("well") at both sizes):
    # its counts, the spill's CSR kernel's included, start from zero here
    well_wrappers = {"well_whole": well_whole_core,
                     "well_seg": well_seg_core,
                     "csr_spmv": csr_spmv_core}
    for w in well_wrappers.values():
        w.launches = 0
    phase_cli_well(device)
    well_mats, dia_of = {}, {}
    for grid, w, dia, segmented, t_k1 in (
            (WELL_WHOLE_GRID, cg_well, cg_mats["dia"], False,
             _k1_seconds(cg_mats["dia"], device)),
            (WELL_SEG_GRID, None, full, True,
             times[("spmv", "float32")][0])):
        label = f"poisson2d({grid},{grid})"
        if w is None:
            t0 = time.perf_counter()
            w = WellMatrix.from_matrix_market(full_mm, window_rows=4)
            _say(f"[12 well profile] host {label}: {w.num_entries} "
                 f"entries, {w.num_chunks} chunks, spill {w.num_spilled} "
                 f"entries, WELL packed on the host in "
                 f"{time.perf_counter() - t0:.1f} s")
        well_mats[label] = (w, segmented, t_k1)
        dia_of[label] = dia
    del full_mm
    profiled = phase_profile_well(device, well_mats, smi_line)
    well_launches = {k: w.launches for k, w in well_wrappers.items()}
    _say("[12 well profile] launches on the WELL path: "
         + ", ".join(f"{k} {n}" for k, n in well_launches.items()))
    for name, n in well_launches.items():
        if n <= 0:
            _fail(f"{name} was never launched on the WELL path")
    well_kernels = phase_kernels_well(device, profiled, smi_line, triad_gbps)

    # the WELL SpMM path's run (CLI, make_kernel("well").spmm_fn at both
    # sizes, batched CG): its counts, the spill's CSR SpMM included,
    # start from zero here
    spmm_wrappers = {"well_whole_spmm": well_whole_spmm_core,
                     "well_seg_spmm": well_seg_spmm_core,
                     "csr_spmm": csr_spmm_core}
    for w in spmm_wrappers.values():
        w.launches = 0
    phase_cli_well_spmm(device)
    well_spmm = phase_profile_well_spmm(device, {
        label: (w, segmented, dia_of[label], profiled[label]["ms"] * 1e-3)
        for label, (w, segmented, _) in well_mats.items()}, smi_line)
    well_cg = phase_batched_cg(device, {"well": cg_well}, smi_line,
                               tag="16 batched cg")["well"]
    well_spmm_launches = {k: w.launches for k, w in spmm_wrappers.items()}
    _say("[16 batched cg] launches on the WELL SpMM path: "
         + ", ".join(f"{k} {n}" for k, n in well_spmm_launches.items()))
    for name, n in well_spmm_launches.items():
        if n <= 0:
            _fail(f"{name} was never launched on the WELL SpMM path")
    del well_mats, dia_of, full, cg_well
    _sync(device)

    # the BSR path's run (CLI, the bench's leg in float32 and bf16, the
    # leg past the 80 MB line): K7's count starts from zero here; each
    # launch is tallied under the Pallas kernel its X size selects
    bsr_spmm_core.launches = 0
    bsr_launches = phase_cli_bsr(device)
    bsr_times, bsr_keep, leg_launches = phase_bsr_legs(device, smi_line,
                                                       triad_gbps)
    for r, n in leg_launches.items():
        bsr_launches[r] = bsr_launches.get(r, 0) + n
    if sum(bsr_launches.values()) != bsr_spmm_core.launches:
        _fail(f"K7 launches {bsr_launches} do not add up to the wrapper's "
              f"{bsr_spmm_core.launches}")
    _say("[18 bsr] launches on the BSR path: " + ", ".join(
        f"{k} {n}" for k, n in bsr_launches.items()))
    for name in ("bsr_spmm_wholex", "bsr_spmm"):
        if bsr_launches.get(name, 0) <= 0:
            _fail(f"{name} was never launched on the BSR path")
    spmm_kernels = phase_kernels_spmm(device, well_spmm, bsr_keep, smi_line,
                                      triad_gbps)
    del bsr_keep

    f32, bf16 = torch.float32, torch.bfloat16
    cw_shape = (f"banded_random({CW_FULL_ROWS}, {CW_FULL_HALF_BW}, 8) "
                "float32")
    mm_shape = f"{cw_shape}, k={CW_SPMM_K}"
    cw_csr = ("XLA `_csr_padded` (spmv_tpu/ops/spmv.py:42), not a TPU "
              "kernel")
    mm_csr = ("XLA `spmm` on DeviceCsr (spmv_tpu/ops/spmv.py:266), not a "
              "TPU kernel")
    cw_rows = {
        "wellcw_merged": ("wellcw_spmv.cu", "pallas_kernels.py:1568",
                          f"{cw_shape}, merged grid"),
        "wellcw_level": ("wellcw_spmv.cu", "pallas_kernels.py:1374",
                         f"{cw_shape}, fallback level (chunks_per_step=64)"),
        "wellcw_pool": ("wellcw_spmv.cu", "pallas_kernels.py:1484",
                        f"{cw_shape}, 128-group tail pool"),
        "csr_spmv": ("csr_spmv.cu", cw_csr, f"{cw_shape}, CSR remainder"),
        "wellcw_merged_spmm": ("wellcw_spmm.cu", "pallas_kernels.py:1653",
                               f"{mm_shape}, merged grid"),
        "wellcw_level_spmm": ("wellcw_spmm.cu", "pallas_kernels.py:1875",
                              f"{mm_shape}, fallback level "
                              "(chunks_per_step=64)"),
        "wellcw_pool_spmm": ("wellcw_spmm.cu", "pallas_kernels.py:1920",
                             f"{mm_shape}, 128-group tail pool"),
        "csr_spmm": ("csr_spmm.cu", mm_csr, f"{mm_shape}, CSR remainder"),
    }
    summary = {"kernels": [
        {
            "name": "dia_spmv",
            "route": "cuda",
            "source": "spmv_tpu_torch/csrc/dia_spmv.cu",
            "replaces": "spmv_tpu/ops/pallas_kernels.py:196",
            "launches": launches["dia_spmv"],
            "max_abs_err": errs[f32][0],
            "ms": times[("spmv", "float32")][0] * 1e3,
            "plain_ms": times[("spmv", "float32")][1] * 1e3,
            "max_abs_err_bf16": errs[bf16][0],
            "ms_bf16": times[("spmv", "bfloat16")][0] * 1e3,
            "plain_ms_bf16": times[("spmv", "bfloat16")][1] * 1e3,
            **dia_extra["spmv"],
            "shape": f"poisson2d({FULL_GRID},{FULL_GRID}) float32",
        },
        {
            "name": "dia_spmm",
            "route": "cuda",
            "source": "spmv_tpu_torch/csrc/dia_spmm.cu",
            "replaces": "spmv_tpu/ops/pallas_kernels.py:710",
            "launches": launches["dia_spmm"],
            "max_abs_err": errs[f32][1],
            "ms": times[("spmm", "float32")][0] * 1e3,
            "plain_ms": times[("spmm", "float32")][1] * 1e3,
            "max_abs_err_bf16": errs[bf16][1],
            "ms_bf16": times[("spmm", "bfloat16")][0] * 1e3,
            "plain_ms_bf16": times[("spmm", "bfloat16")][1] * 1e3,
            **dia_extra["spmm"],
            "shape": f"poisson2d({FULL_GRID},{FULL_GRID}) float32, "
                     f"k={SPMM_K}",
        },
    ] + [
        {
            "name": name,
            "route": "cuda",
            "source": "spmv_tpu_torch/csrc/well_spmv.cu",
            "replaces": f"spmv_tpu/ops/pallas_kernels.py:{line}",
            "launches": well_launches[name],
            **well_kernels[(name, f"poisson2d({grid},{grid})")],
        }
        for name, line, grid in (("well_whole", 431, WELL_WHOLE_GRID),
                                 ("well_seg", 557, WELL_SEG_GRID))
    ] + [
        {
            "name": name,
            "route": "cuda",
            "source": f"spmv_tpu_torch/csrc/{source}",
            "replaces": (replaces if replaces.startswith("XLA")
                         else f"spmv_tpu/ops/{replaces}"),
            "launches": launches[name],
            **cw_kernels[name],
            **({"columns_bitwise_equal_to_spmv_kernel": bitwise[name]}
               if name in bitwise else {}),
            "shape": shape,
        }
        for name, (source, replaces, shape) in cw_rows.items()
    ] + [
        {
            "name": name,
            "route": "cuda",
            "source": "spmv_tpu_torch/csrc/well_spmm.cu",
            "replaces": f"spmv_tpu/ops/pallas_kernels.py:{line}",
            "launches": well_spmm_launches[name],
            **spmm_kernels[name],
            "columns_bitwise_equal_to_spmv_kernel": well_bitwise[name],
        }
        for name, line in (("well_whole_spmm", 1079),
                           ("well_seg_spmm", 1121))
    ] + [
        {
            "name": name,
            "route": "cuda",
            "source": "spmv_tpu_torch/csrc/bsr_spmm.cu",
            "replaces": f"spmv_tpu/ops/pallas_kernels.py:{line}",
            "launches": bsr_launches[name],
            **{key: leg[key] for key in ("plain_ms", "library_ms",
                                         "bound_ms", "bound_by",
                                         "bound_triad_ms", "bytes", "flops")},
            **spmm_kernels[(name, key)],
            "chained_ms": leg["ms"],
            "tflops_chained": leg["tflops"],
            **({"library_refused": leg["library_refused"]}
               if "library_refused" in leg else {}),
            **extra,
            "shape": f"{shape} float32",
        }
        for name, line, key, leg, shape, extra in (
            ("bsr_spmm_wholex", 918, "float32", bsr_times["float32"],
             bsr_times["shape"], {
                 f"{f}_bf16": v for f, v in
                 {**bsr_times["bfloat16"],
                  **spmm_kernels[("bsr_spmm_wholex", "bfloat16")]}.items()
                 if f in ("ms", "max_abs_err", "plain_ms", "library_ms",
                          "bound_ms", "bound_by", "tflops")}),
            ("bsr_spmm", 896, "far", bsr_times["far"],
             bsr_times["far"]["shape"], {}))
    ], "wellcw_spmv": {**cw_times, "shape": cw_shape},
        "wellcw_spmm": {**spmm_times, "shape": mm_shape},
        "batched_cg": {**cg_times, "k": CG_K,
                       "shape": f"poisson2d({CG_GRID},{CG_GRID}) float32"},
        "well_spmv": {
            "launches_on_the_well_path": well_launches,
            **{label: {**{k: v for k, v in res.items() if k != "A"},
                       **({"spill": well_kernels[("csr_spmv", label)]}
                          if ("csr_spmv", label) in well_kernels else {})}
               for label, res in profiled.items()}},
        "well_spmm": {
            "launches_on_the_well_spmm_path": well_spmm_launches,
            **{label: {k: v for k, v in res.items() if k != "A"}
               for label, res in well_spmm.items()},
            "batched_cg": {**well_cg, "k": CG_K,
                           "shape": f"poisson2d({CG_GRID},{CG_GRID}) "
                                    "float32"}},
        "bsr_spmm": {"launches_on_the_bsr_path": bsr_launches,
                     **bsr_times}}
    print(json.dumps(summary), flush=True)
    print(smi_line, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
