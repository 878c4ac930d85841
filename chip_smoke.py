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
   whole product against the fp64 host product in float32.
4. DIA main path through the CLI, in process, on a Matrix Market file of
   poisson2d(1024, 1024): profile, SpMM profile, CG, Jacobi CG, triad.
   The DIA launch counts are zeroed just before this phase.
5. DIA full-size profile: poisson2d(4096, 4096) through
   kernels.make_kernel -> time_kernel -> profiling_report in float32 and
   bfloat16 storage, the fp64 host checksum gate, and the plain
   versions timed at the same size.  The DIA launch counts are read
   after it.
6. WELL-CW path through the CLI (the WELL-CW launch counts are zeroed
   just before): --profile 3 on banded_random(65536, 512, 8) (merged
   grid and tails: K3c, K3b) and on banded_random(4096, 128, 8)
   (fallback: K3a, K3b), --cg 2000 on poisson2d(256, 256) (K3c).
7. WELL-CW full-size profile, the JAX bench's leg on the port:
   banded_random(1048576, 2048, 8) in float32 (merged grid, a 128-group
   tail pool and a CSR remainder: K3c, K3b, CSR) through
   kernels.make_kernel -> time_kernel -> profiling_report: the fp64
   host checksum gate, seconds per SpMV against the plain version, and
   the fraction of the triad roofline with the bench's byte count, and a
   torch.profiler table of 50 chained SpMVs (device time per kernel,
   busy share).  The WELL-CW launch counts are read after it.
8. WELL-CW kernels alone at full size (not counted): K3c, K3b and CSR
   on the same matrix, K3a on its fallback layout (chunks_per_step=64):
   bitwise repeat, max error against the plain version, device ms (50
   launches in a CUDA graph, the L2 flushed before each) and ms a call
   through the wrapper, against plain ms.

The second-to-last lines are the kernels' JSON summary and nvidia-smi's
``name, power.limit``; the last line is the run's result.  Imports no
JAX: the machine with the card need not have it.
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
CW_FULL_ROWS = 1 << 20        # bench.py's WELL-CW leg on the TPU
CW_FULL_HALF_BW = 2048
CW_CLI_ROWS = 1 << 16
CW_CG_GRID = 256
PROFILE_CHAIN = 50            # chained SpMVs in the traced window


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
    from spmv_tpu.io.generate import from_coo_arrays
    from spmv_tpu.models import DiaMatrix

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
    from spmv_tpu.io.generate import from_coo_arrays
    from spmv_tpu.models import DiaMatrix

    rows = np.array([0, 0, 1, 2, 3, 3, 3])
    cols = np.array([0, 1, 1, 2, 0, 3, 4])
    vals = np.array([1.0, 2.0, 1.0, 3.0, -1.0, 2.0, 1.0])
    return DiaMatrix.from_matrix_market(
        from_coo_arrays(4, 5, rows, cols, vals))


def _compare(name, dia, dtype, device):
    """K1 (plain and fused dot) and K2 against the plain versions on the
    same CUDA tensors; float32 also against the fp64 host product.
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
    X = torch.randn(A.num_columns, SPMM_K, generator=g, device=device,
                    dtype=wide).to(dtype)

    y = dia_spmv_core(A, x)
    Y = dia_spmm_core(A, X)
    _sync(device)
    y_plain = dia_spmv_reference(A, x)
    Y_plain = dia_spmm_reference(A, X)
    tol = {"float64": TOL_F64, "float32": TOL_F32,
           "bfloat16": TOL_BF16}[dtn]
    e1, e2 = _rel(y, y_plain), _rel(Y, Y_plain)
    line = f"[3 compare] {name} {dtn}: K1 {e1:.3e}, K2(k={SPMM_K}) {e2:.3e}"
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

    from spmv_tpu.io.generate import poisson2d
    from spmv_tpu.models import DiaMatrix

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


def _cw_parts(A):
    """(kernel name, kernel call, plain call) of each launch that
    ``wellcw_spmv_core`` makes for A; each call takes x (and an optional
    out buffer for the kernel)."""
    from spmv_tpu_torch.ops import (
        csr_spmv_core,
        csr_spmv_reference,
        cw_level_reference,
        cw_merged_reference,
        cw_pool_reference,
        wellcw_level_core,
        wellcw_merged_core,
        wellcw_pool_core,
    )

    n = A.num_rows

    def part(name, core, plain, p):
        return (name, lambda x, out=None: core(p, x, n, out=out),
                lambda x: plain(p, x, n))

    parts = []
    if A.merged is not None:
        parts.append(part("wellcw_merged", wellcw_merged_core,
                          cw_merged_reference, A.merged))
    parts += [part("wellcw_level", wellcw_level_core, cw_level_reference,
                   lv) for lv in A.levels]
    pools = ([A.pool] if A.pool is not None else []) + list(A.tail_pools)
    parts += [part("wellcw_pool", wellcw_pool_core, cw_pool_reference, p)
              for p in pools]
    if A.remainder is not None:
        R = A.remainder
        parts.append(("csr_spmv",
                      lambda x, out=None: csr_spmv_core(R, x, out=out),
                      lambda x: csr_spmv_reference(R, x)))
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
    for kname, run, plain in _cw_parts(A):
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


def phase_compare_wellcw(device):
    import torch

    from spmv_tpu.io.generate import banded_random, random_sparse
    from spmv_tpu.models import WellCwMatrix

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
    _sync(device)


# ---------------------------------------------------------------- phase 4
def _run_cli(tag, runs):
    """Run the port's CLI in process; each run is (name, argv, wrappers
    that must launch).  Checks GPU timing, or CG convergence."""
    from spmv_tpu_torch.cli import main

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
        if "cg" in doc:
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


def phase_cli(device):
    import torch

    from spmv_tpu.io import write_matrix_market
    from spmv_tpu.io.generate import poisson2d
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
            ("triad", ["--triad", "100000000", "--profile", "5"], ()),
        ])
    _sync(device)


# ---------------------------------------------------------------- phase 5
def phase_profile(device, full, smi_line):
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
    times = {}
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
        del kernel, step, args, A
        _sync(device)
    return times


# ---------------------------------------------------------------- phase 6
def phase_cli_wellcw(device):
    from spmv_tpu.io import write_matrix_market
    from spmv_tpu.io.generate import banded_random, poisson2d
    from spmv_tpu_torch.ops import (
        wellcw_level_core,
        wellcw_merged_core,
        wellcw_pool_core,
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


def phase_profile_wellcw(device, cw, smi_line):
    import torch

    from spmv_tpu.perfmodel.tiling import roofline_time
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
    del kernel, step, args, A, y
    _sync(device)
    return {"ms": t * 1e3, "plain_ms": t_plain * 1e3,
            "roofline_fraction": frac, "checksum_rel_err": rel,
            "device_busy_share": dev / wall}


# ---------------------------------------------------------------- phase 8
def phase_kernels_wellcw(device, cw, smi_line):
    """Each WELL-CW / CSR kernel alone at the full-size matrix: K3c, K3b
    and CSR on its merged layout, K3a on its fallback layout."""
    import torch

    from spmv_tpu_torch.models import DeviceWellCw

    f32 = torch.float32
    x = torch.randn(cw.num_columns, device=device, dtype=f32,
                    generator=torch.Generator(device=device).manual_seed(1))
    # 64 MiB written between launches evicts the 50 MB L2
    scratch = torch.empty(16 << 20, dtype=f32, device=device)
    found = {}
    for dev_kw in ({}, {"chunks_per_step": 64}):
        A = DeviceWellCw.from_host(cw, dtype=f32, device=device, **dev_kw)
        for kname, run, plain in _cw_parts(A):
            if kname in found or (dev_kw and kname != "wellcw_level"):
                continue
            out = torch.empty(A.num_rows, dtype=f32, device=device)
            y1, y2 = run(x), run(x)
            _sync(device)
            if not torch.equal(y1, y2):
                _fail(f"{kname} at full size: two launches differ")
            want = plain(x)
            err = float((y1.double() - want.double()).abs().max())
            rel = _rel(y1, want)
            if rel > TOL_F32:
                _fail(f"{kname} at full size: rel err {rel} > {TOL_F32}")
            ms = _cold_graph_ms(lambda: run(x, out=out),
                                lambda: scratch.fill_(0.0), 50)
            eager_ms = _time_launches(lambda: run(x, out=out), 50)
            plain_ms = _time_launches(lambda: plain(x), 3)
            found[kname] = {"max_abs_err": err, "ms": ms,
                            "plain_ms": plain_ms, "eager_ms": eager_ms}
            _say(f"[8 wellcw kernels] {kname}"
                 f"{' (chunks_per_step=64)' if dev_kw else ''}: "
                 f"{ms:.4f} ms on the device (CUDA graph, L2 flushed), "
                 f"{eager_ms:.4f} "
                 f"ms a call through the wrapper, plain {plain_ms:.4f} ms, "
                 f"max abs err {err:.3e} (rel {rel:.3e}), bitwise "
                 f"repeatable, on {smi_line}")
        del A
        _sync(device)
    missing = {"wellcw_merged", "wellcw_level", "wellcw_pool",
               "csr_spmv"} - set(found)
    if missing:
        _fail(f"full-size matrix did not reach {sorted(missing)}")
    return found


# ----------------------------------------------------------------- main
def main() -> int:
    device, smi_line = phase_device()

    import torch

    from spmv_tpu.io.generate import banded_random, poisson2d
    from spmv_tpu.models import DiaMatrix, WellCwMatrix
    from spmv_tpu_torch.ops import (
        csr_spmv_core,
        dia_spmm_core,
        dia_spmv_core,
        wellcw_level_core,
        wellcw_merged_core,
        wellcw_pool_core,
    )

    phase_build()
    t0 = time.perf_counter()
    full = DiaMatrix.from_matrix_market(poisson2d(FULL_GRID, FULL_GRID))
    _say(f"[3 compare] host poisson2d({FULL_GRID},{FULL_GRID}): "
         f"{full.num_rows} rows, {full.num_entries} entries, "
         f"{full.num_diagonals} diagonals, built in "
         f"{time.perf_counter() - t0:.1f} s")
    errs = phase_compare(device, full)

    phase_compare_wellcw(device)

    # the DIA path's run: its counts start from zero here
    dia_spmv_core.launches = 0
    dia_spmm_core.launches = 0
    phase_cli(device)
    times = phase_profile(device, full, smi_line)
    launches = {"dia_spmv": dia_spmv_core.launches,
                "dia_spmm": dia_spmm_core.launches}
    del full

    # the WELL-CW path's run: its counts start from zero here
    cw_wrappers = {"wellcw_merged": wellcw_merged_core,
                   "wellcw_level": wellcw_level_core,
                   "wellcw_pool": wellcw_pool_core,
                   "csr_spmv": csr_spmv_core}
    for w in cw_wrappers.values():
        w.launches = 0
    phase_cli_wellcw(device)
    t0 = time.perf_counter()
    cw = WellCwMatrix.from_matrix_market(banded_random(
        CW_FULL_ROWS, half_bandwidth=CW_FULL_HALF_BW, nnz_per_row=8,
        seed=1))
    _say(f"[7 wellcw profile] host banded_random({CW_FULL_ROWS}, "
         f"{CW_FULL_HALF_BW}, 8): {cw.num_entries} entries, packed in "
         f"{time.perf_counter() - t0:.1f} s")
    cw_times = phase_profile_wellcw(device, cw, smi_line)
    launches.update({k: w.launches for k, w in cw_wrappers.items()})
    _say("[7 wellcw profile] launches on the WELL-CW path: "
         + ", ".join(f"{k} {launches[k]}" for k in cw_wrappers))
    for name, n in launches.items():
        if n <= 0:
            _fail(f"{name} was never launched on the main path")
    cw_kernels = phase_kernels_wellcw(device, cw, smi_line)

    f32, bf16 = torch.float32, torch.bfloat16
    cw_shape = (f"banded_random({CW_FULL_ROWS}, {CW_FULL_HALF_BW}, 8) "
                "float32")
    cw_rows = {
        "wellcw_merged": ("spmv_tpu/ops/pallas_kernels.py:1568",
                          f"{cw_shape}, merged grid"),
        "wellcw_level": ("spmv_tpu/ops/pallas_kernels.py:1374",
                         f"{cw_shape}, fallback level (chunks_per_step=64)"),
        "wellcw_pool": ("spmv_tpu/ops/pallas_kernels.py:1484",
                        f"{cw_shape}, 128-group tail pool"),
        "csr_spmv": ("XLA `_csr_padded` (spmv_tpu/ops/spmv.py:42), not a "
                     "TPU kernel", f"{cw_shape}, CSR remainder"),
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
            "shape": f"poisson2d({FULL_GRID},{FULL_GRID}) float32, "
                     f"k={SPMM_K}",
        },
    ] + [
        {
            "name": name,
            "route": "cuda",
            "source": ("spmv_tpu_torch/csrc/csr_spmv.cu" if name == "csr_spmv"
                       else "spmv_tpu_torch/csrc/wellcw_spmv.cu"),
            "replaces": replaces,
            "launches": launches[name],
            **cw_kernels[name],
            "shape": shape,
        }
        for name, (replaces, shape) in cw_rows.items()
    ], "wellcw_spmv": {**cw_times, "shape": cw_shape}}
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
