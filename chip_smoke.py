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
4. Main path through the CLI, in process, on a Matrix Market file of
   poisson2d(1024, 1024): profile, SpMM profile, CG, Jacobi CG, triad.
   Launch counts are zeroed just before this phase.
5. Full-size profile: poisson2d(4096, 4096) through
   kernels.make_kernel -> time_kernel -> profiling_report in float32 and
   bfloat16 storage, the fp64 host checksum gate, and the plain
   versions timed at the same size.  Launch counts are read after it.

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
    return float((got - want).abs().max() / want.abs().max())


# ---------------------------------------------------------------- phase 1
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


# ---------------------------------------------------------------- phase 4
def phase_cli(device):
    import torch

    from spmv_tpu.io import write_matrix_market
    from spmv_tpu.io.generate import poisson2d
    from spmv_tpu_torch.cli import main
    from spmv_tpu_torch.ops import dia_spmm_core, dia_spmv_core

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, f"poisson2d_{CLI_GRID}.mtx")
        t0 = time.perf_counter()
        write_matrix_market(poisson2d(CLI_GRID, CLI_GRID), path)
        _say(f"[4 cli] wrote {path} ({os.path.getsize(path) >> 20} MiB) in "
             f"{time.perf_counter() - t0:.1f} s")
        mat = ["--matrix", path, "--spmv-format", "dia"]
        runs = [
            ("profile", mat + ["--profile", "10"], dia_spmv_core),
            ("spmm", mat + ["--profile", "5", "--spmm", str(SPMM_K)],
             dia_spmm_core),
            ("cg", mat + ["--cg", "2000", "--cg-tol", "1e-5"],
             dia_spmv_core),
            ("cg_jacobi", mat + ["--cg", "2000", "--cg-tol", "1e-5",
                                 "--precondition", "jacobi"],
             dia_spmv_core),
            ("triad", ["--triad", "100000000", "--profile", "5"], None),
        ]
        for name, argv, wrapper in runs:
            before = wrapper.launches if wrapper else 0
            buf = io.StringIO()
            t0 = time.perf_counter()
            rc = main(argv, out=buf)
            secs = time.perf_counter() - t0
            if rc != 0:
                _fail(f"CLI {' '.join(argv)} exited {rc}")
            doc = json.loads(buf.getvalue())
            if wrapper is not None and wrapper.launches <= before:
                _fail(f"CLI {name}: {wrapper.__name__} was not launched")
            launched = (f", {wrapper.__name__} launches "
                        f"+{wrapper.launches - before}" if wrapper else "")
            if "cg" in doc:
                cg = doc["cg"]
                err = cg["solution_rms_error_vs_ones"]
                _say(f"[4 cli] {name}: {cg['iterations']} iterations, "
                     f"residual {cg['residual_norm']:.3e}, rms error vs ones "
                     f"{err:.3e}, {cg['seconds']:.4f} s "
                     f"({cg['seconds'] / max(cg['iterations'], 1) * 1e6:.1f}"
                     f" us/iteration){launched}")
                if not (np.isfinite(err) and err <= CG_RMS_ERR):
                    _fail(f"CLI {name}: rms error {err} > {CG_RMS_ERR}")
            else:
                t = doc["device_seconds_per_iteration"]
                frac = doc["achieved"]["fraction_of_roofline"]
                _say(f"[4 cli] {name}: device_seconds_per_iteration {t:.6e}, "
                     f"fraction_of_roofline {frac:.4f} (roofline on "
                     f"{doc['roofline']['machine']}), "
                     f"{secs:.1f} s wall{launched}")
                if doc["device"]["platform"] != "gpu" or not t > 0:
                    _fail(f"CLI {name}: not a GPU timing: {doc['device']}")
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


# ----------------------------------------------------------------- main
def main() -> int:
    device, smi_line = phase_device()

    import torch

    from spmv_tpu.io.generate import poisson2d
    from spmv_tpu.models import DiaMatrix
    from spmv_tpu_torch.ops import dia_spmm_core, dia_spmv_core

    phase_build()
    t0 = time.perf_counter()
    full = DiaMatrix.from_matrix_market(poisson2d(FULL_GRID, FULL_GRID))
    _say(f"[3 compare] host poisson2d({FULL_GRID},{FULL_GRID}): "
         f"{full.num_rows} rows, {full.num_entries} entries, "
         f"{full.num_diagonals} diagonals, built in "
         f"{time.perf_counter() - t0:.1f} s")
    errs = phase_compare(device, full)

    # the main path's run: counts start from zero here
    dia_spmv_core.launches = 0
    dia_spmm_core.launches = 0
    phase_cli(device)
    times = phase_profile(device, full, smi_line)
    launches = {"dia_spmv": dia_spmv_core.launches,
                "dia_spmm": dia_spmm_core.launches}
    for name, n in launches.items():
        if n <= 0:
            _fail(f"{name} was never launched on the main path")

    f32, bf16 = torch.float32, torch.bfloat16
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
    ]}
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
