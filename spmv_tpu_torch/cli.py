"""Command-line interface of the port.

Takes the JAX package's flags (``build_parser`` is the port's copy of
``spmv_tpu.cli.build_parser``: the same flags, defaults and help) and
runs the modes ported so far, printing the same JSON documents:

    python -m spmv_tpu_torch --matrix A.mtx --spmv-format dia --profile 10
    python -m spmv_tpu_torch --matrix A.mtx --spmv-format FMT --profile 5 --spmm 8
    python -m spmv_tpu_torch --matrix A.mtx --spmv-format FMT --cg 2000 \
        [--cg-tol 1e-6] [--precondition none|jacobi|amg] \
        [--recompute-residual K]
    python -m spmv_tpu_torch --matrix A.mtx --spmv-format FMT \
        --cg 2000 --nrhs 4 [--precondition none|jacobi]
    python -m spmv_tpu_torch --matrix A.mtx --spmv-format FMT --profile 5 \
        --traffic-split
    python -m spmv_tpu_torch --matrix A.mtx --spmv-format FMT \
        --trace-config configs/cpu-2thread.json [--warmup]
    python -m spmv_tpu_torch --triad 100000000 --profile 5
    python -m spmv_tpu_torch --list-devices

with FMT any of ``-s``'s values: the reference tool's formats ``csr``
(the default), ``coo``, ``coo-atomic``, ``ell`` and ``hybrid``, the
library comparison ``xla-csr`` (``torch.sparse``), and ``dia``,
``wellcw``, ``well``, ``bsr`` and ``auto`` (``--profile N`` alone times
the SpMV, ``--spmm K`` the SpMM of K columns).  ``--reorder
rcm|gp|sigma`` reorders the matrix before conversion on every explicit
format, as the JAX CLI does; ``-s auto`` picks the format as the JAX CLI
does (``auto_format``, the ``spmm`` workload when ``--spmm`` is given,
which lets a block-structured matrix pick BSR) and refuses
``--reorder``.  Every other mode or flag (``--reorder color`` among
them) prints ``spmv-tpu-torch: ... not yet ported`` and exits 1.  The
device is the first CUDA device; without one the CLI exits 1, unless
``SPMV_TPU_TORCH_DEVICE=cpu`` asks for the CPU (as the tests do).
``--list-devices`` lists the CPU when there is no card.

``--profile N --traffic-split`` also times the stream-only and
gather-only variants of the SpMV (``profile.traffic.
measure_traffic_split``: the hand-written CSR, ELL and WELL variants on
the card) on the matrix put on the device as the JAX CLI puts it
(``device_put_matrix``), and reports them under ``"traffic_split"``,
each leg priced at the port's measured triad rate.  As in the JAX CLI it
refuses ``--spmm`` and a kernel with no matrix (``--triad``), and ``-s
dia``, ``wellcw`` and ``bsr`` (also as ``-s auto``'s choice) exit 1 with
the variants' ``KernelError``.

``--profile 0`` (the default) is the simulation mode, as in the JAX CLI:
the kernel's per-thread memory reference strings (the format's
reference loop, ``Kernel.memory_reference_string``) replayed through the
``--trace-config`` machine model's LRU caches (``perfmodel.cache_trace``;
the replay in ``csrc/simcache.cpp``, built on the host), with an
uncounted replay first under ``--warmup``.  It runs on the host alone.

``--cg`` on any format but DIA runs the generic (P)CG over ``spmv``, as
the JAX CLI does (its ``fast_spmv`` runs the Pallas WELL kernel; the
port's ``spmv`` runs K5a or K5b, K7 on one column for BSR, the CSR
kernel for CSR and COO, the ELL kernel and for hybrid the CSR kernel
after it, ``torch.sparse`` for ``xla-csr``).  Jacobi reads the diagonal
from the Matrix Market entries the matrix was built from (the JAX CLI's
``extract_diagonal`` has no branch for the ELL, hybrid, WELL-CW, WELL
and BSR host formats).  On a DIA matrix and a CUDA device it runs the
kernel loop with K1's fused p.Ap dot
(``dia_conjugate_gradient``'s default, as in the JAX CLI), so both CLIs
run the same algorithm.  On an H100 the unfused loop (a separate
``torch.dot``) measured faster; ``python -m
spmv_tpu_torch.profile.cg_breakdown`` times both, and PERF.md keeps the
numbers until a kernel change or a measured choice settles which runs.

``--cg N --precondition amg`` runs PCG over ``spmv`` with one
smoothed-aggregation AMG V-cycle as the preconditioner on every format
(``amg_preconditioner``: A, P and P^T on the CSR kernel), before the
DIA kernel loop, as the JAX CLI does; the report carries the hierarchy
under ``"factorization"``.  The hierarchy is built from the Matrix Market
entries, also with ``-s auto``, where the JAX CLI raises.  ``--nrhs``
with amg is refused, with the JAX CLI's message.

``--cg N --nrhs K`` (K > 1) runs batched multi-RHS CG, one SpMM per
iteration (K2 on DIA, K4a-c and the CSR SpMM on WELL-CW, K6a or K6b on
WELL, K7 on BSR, the CSR SpMM on CSR and COO, the ELL SpMM on ELL and,
for hybrid, the CSR SpMM after it), on B = A X with column j of X
equal to (j + 1) * ones, and reports each column's iterations, residual and
error, as the JAX CLI does.
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from spmv_tpu_torch.errors import KernelError, SpmvError

__all__ = ["main", "build_parser"]

SPMV_FORMATS = (
    "auto", "coo", "coo-atomic", "csr", "ell", "hybrid", "dia", "well",
    "wellcw", "bsr", "xla-csr"
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="spmv-tpu-torch",
        description=(
            "Trace-based TPU memory-model simulation and on-device "
            "profiling of SpMV kernels (TPU-native rebuild of "
            "spmv-cache-trace)."
        ),
    )
    from spmv_tpu_torch import __version__

    p.add_argument("--version", action="version",
                   version=f"%(prog)s {__version__}")
    p.add_argument("-m", "--matrix", metavar="PATH",
                   help="Matrix Market file (.mtx, .mtx.gz, .tar.gz)")
    p.add_argument("-c", "--trace-config", metavar="PATH",
                   help="JSON machine model (caches, NUMA domains, "
                        "thread affinities)")
    p.add_argument("-s", "--spmv-format", choices=SPMV_FORMATS,
                   default="csr",
                   help="sparse format / kernel (default csr; 'dia' is "
                        "the TPU-native diagonal kernel)")
    p.add_argument("--triad", type=int, metavar="N", default=0,
                   help="run the STREAM-triad kernel over N elements "
                        "instead of SpMV")
    p.add_argument("-p", "--profile", type=int, metavar="N", default=0,
                   help="run on the device N times and report timing "
                        "statistics; 0 (default) simulates instead")
    p.add_argument("--warmup", action=argparse.BooleanOptionalAction,
                   default=None,
                   help="one untimed warmup run (or warmup replay in "
                        "simulation mode).  Default: on for profile "
                        "mode with more than one run — run 1 otherwise "
                        "measures the compile, poisoning the sample "
                        "statistics (the reference's warmup exists for "
                        "exactly this, profile-kernel.cpp:262-264) — "
                        "off elsewhere; --no-warmup forces it off")
    p.add_argument("--flush-caches", action="store_true",
                   help="stream a large buffer between profiled runs to "
                        "evict device-resident state (the TPU analogue "
                        "of the reference's cache flushing)")
    p.add_argument("--scaling", type=int, metavar="P", default=0,
                   help="predict the P-chip sharded-SpMV step for the "
                        "loaded matrix (halo volume measured from the "
                        "partition; ICI efficiency is an ASSUMPTION — "
                        "the report prints it next to the breakeven "
                        "value below which the weak-scaling claim "
                        "fails)")
    p.add_argument("--cg", type=int, metavar="MAXITER", default=0,
                   help="solve A x = b (b = A @ ones) with conjugate "
                        "gradient up to MAXITER iterations on the "
                        "device and report convergence + timing")
    p.add_argument("--cg-tol", type=float, default=1e-6,
                   help="CG relative-residual tolerance (default 1e-6)")
    p.add_argument("--nrhs", type=int, metavar="K", default=1,
                   help="with --cg and --solver cg: solve K "
                        "right-hand sides at once (batched multi-RHS "
                        "CG — one SpMM per iteration; per-column "
                        "convergence reported)")
    p.add_argument("--solver",
                   choices=("cg", "bicgstab", "gmres", "chebyshev"),
                   default="cg",
                   help="with --cg: Krylov method (cg for SPD systems, "
                        "bicgstab/gmres for general matrices, "
                        "chebyshev for SPD with Lanczos-estimated "
                        "spectral bounds — its loop needs no inner "
                        "products, so a sharded run has no "
                        "per-iteration reduction collective)")
    p.add_argument("--restart", type=int, default=32,
                   help="GMRES restart length m (default 32); the "
                        "Krylov basis costs m x rows values in HBM")
    p.add_argument("--precondition",
                   choices=("none", "jacobi", "ic0", "ic0-sweeps",
                            "ilu0", "ilu0-sweeps", "amg"),
                   default="none",
                   help="preconditioner for --cg (jacobi = diagonal "
                        "scaling; ic0/ilu0 = incomplete factorization "
                        "with level-scheduled triangular solves; the "
                        "-sweeps variants substitute the fixed-count "
                        "Jacobi-iteration approximate solve; amg = "
                        "smoothed-aggregation multigrid V-cycle with "
                        "Chebyshev smoothing)")
    p.add_argument("--recompute-residual", type=int, metavar="K",
                   default=0,
                   help="with --cg and --solver cg: replace the "
                        "recurrence residual with the true residual "
                        "b - A x every K iterations (costs one extra "
                        "SpMV per K); keeps the reported residual "
                        "honest when the f32 recurrence drifts past "
                        "the attainable accuracy")
    p.add_argument("--eigs", type=int, metavar="K", default=0,
                   help="compute the K extreme eigenpairs of the "
                        "(symmetric) matrix with block LOBPCG and "
                        "print a JSON report (--which picks the end; "
                        "--precondition jacobi/amg accelerates)")
    p.add_argument("--which", choices=("smallest", "largest"),
                   default="smallest",
                   help="with --eigs: which end of the spectrum")
    p.add_argument("--eigs-tol", type=float, default=1e-6,
                   help="with --eigs: residual tolerance relative to "
                        "the block's spectral scale")
    p.add_argument("--eigs-maxiter", type=int, default=200,
                   help="with --eigs: iteration cap")
    p.add_argument("--spmm", type=int, metavar="K", default=0,
                   help="with --profile: time the multi-vector product "
                        "A @ X for an (n, K) block X instead of SpMV")
    p.add_argument("--traffic-split", action="store_true",
                   help="with --profile: also time the stream-only and "
                        "gather-only kernel variants to separate regular "
                        "from irregular traffic on-device (the analogue "
                        "of the reference's spmv_regular_traffic / "
                        "spmv_irregular_traffic variants)")
    p.add_argument("--reorder",
                   choices=("none", "rcm", "gp", "sigma", "color"),
                   default="none",
                   help="reorder the matrix before conversion "
                        "(equivalent to the reference's __RCM/__GP "
                        "path suffixes, plus the SELL-sigma row sort "
                        "and greedy multicoloring — the order that "
                        "collapses ic0/ilu0 triangular-solve levels "
                        "to the color count)")
    p.add_argument("--jax-profile", metavar="DIR", default=None,
                   help="capture a jax.profiler trace (xplane) of the "
                        "profiled runs into DIR (the analogue of the "
                        "reference's perf-event capture)")
    p.add_argument("--list-devices", action="store_true",
                   help="list attached JAX devices and built-in machine "
                        "models (the analogue of --list-perf-events)")
    p.add_argument("--list-profile-events", nargs="?", const="",
                   metavar="DIR",
                   help="enumerate the profiler's event/stat namespace "
                        "(planes, lines, per-event stat names/types, "
                        "derived report fields) — the full analogue of "
                        "the reference's --list-perf-events PMU walk. "
                        "Reads an existing --jax-profile capture DIR, "
                        "or profiles a tiny run on the default device "
                        "when DIR is omitted")
    p.add_argument("--progress-interval", type=float, metavar="SECONDS",
                   default=5.0,
                   help="print simulation replay progress to stderr at "
                        "most once per interval when verbose "
                        "(0 disables; reference: SIGALRM progress)")
    p.add_argument("-v", "--verbose", action="store_true")
    return p


def _not_ported(what: str):
    raise KernelError(f"{what} is not yet ported to spmv_tpu_torch; see "
                      "ROADMAP.md")


def _check_ported(args) -> None:
    """Refuse, by name, every flag of the shared parser whose mode the
    port does not have yet."""
    if args.list_devices:
        return
    for flag, on in (
        ("--list-profile-events", args.list_profile_events is not None),
        ("--eigs", args.eigs > 0),
        ("--scaling", args.scaling > 0),
        ("--jax-profile", args.jax_profile is not None),
        ("--flush-caches", args.flush_caches),
        # -s auto refuses --reorder itself, as the JAX CLI does
        ("--reorder color",
         args.reorder == "color" and args.spmv_format != "auto"),
        ("--solver " + args.solver, args.solver != "cg"),
        ("--precondition " + args.precondition,
         args.precondition not in ("none", "jacobi", "amg")),
    ):
        if on:
            _not_ported(flag)


def _make_kernel(args, device, dtype):
    """The kernel of the flags, and with ``-s auto`` the Matrix Market
    entries its matrix was chosen and converted from (else None; with
    ``--reorder`` the kernel keeps the permuted entries)."""
    from spmv_tpu_torch.kernels import make_kernel

    if args.triad > 0:
        return make_kernel("triad", triad_entries=args.triad,
                           device=device, dtype=dtype), None
    if not args.matrix:
        raise SpmvError("either --matrix or --triad N is required "
                        "(see --help)")
    if args.spmv_format == "auto":
        from spmv_tpu_torch.io.matrix_market import load_matrix
        from spmv_tpu_torch.models import auto_format

        mm = load_matrix(args.matrix, verbose=args.verbose)
        if args.reorder != "none":
            raise SpmvError(
                "-s auto chooses its own reordering; drop --reorder")
        workload = "spmm" if args.spmm > 0 else "spmv"
        matrix, rationale = auto_format(mm, workload=workload)
        if args.verbose:
            print(f"auto format: {rationale}", file=sys.stderr)
        return make_kernel(matrix.format_name, matrix=matrix, device=device,
                           dtype=dtype), mm
    if args.reorder != "none":
        from spmv_tpu_torch.io.matrix_market import load_matrix
        from spmv_tpu_torch.models import reorder

        mm = load_matrix(args.matrix, verbose=args.verbose)
        order = {
            "rcm": reorder.find_new_order_rcm,
            "gp": reorder.find_new_order_gp,
            "sigma": reorder.find_new_order_sigma,
        }[args.reorder](mm)
        return make_kernel(args.spmv_format, mm=mm.permute(order),
                           device=device, dtype=dtype), None
    return make_kernel(args.spmv_format, matrix_path=args.matrix,
                       device=device, dtype=dtype), None


def _list_devices(out) -> None:
    from spmv_tpu_torch.utils.jsonio import dump_json
    from spmv_tpu_torch.models.device import default_device
    from spmv_tpu_torch.ops._build import nvcc_version
    from spmv_tpu_torch.perfmodel import measured_machine

    devices = []
    for i in range(torch.cuda.device_count()):
        p = torch.cuda.get_device_properties(i)
        devices.append({
            "id": i,
            "platform": "gpu",
            "device_kind": p.name,
            "compute_capability": f"{p.major}.{p.minor}",
            "multiprocessors": p.multi_processor_count,
            "memory_total_bytes": p.total_memory,
        })
    if not devices:
        devices.append({"id": 0, "platform": "cpu", "device_kind": "cpu"})
    try:
        nvcc = nvcc_version()
    except KernelError:
        nvcc = None
    try:
        dev = default_device()
    except KernelError:
        dev = torch.device("cpu")       # listing is not running
    dump_json({
        "devices": devices,
        "device_count": len(devices),
        "process_count": 1,
        "torch_version": torch.__version__,
        "platform_version": torch.version.cuda,
        "nvcc_version": nvcc,
        "default_backend": "gpu" if dev.type == "cuda" else "cpu",
        "profiler_capabilities": {
            "trace_capture": False,
            "xplane_parsing": False,
            "per_kernel_device_time": dev.type == "cuda",  # CUDA events
            "hardware_counters": False,
        },
        "machine_models": [measured_machine(dev).to_json()],
    }, out)


def _profile(args, out, device, dtype) -> None:
    from spmv_tpu_torch.utils.jsonio import dump_json
    from spmv_tpu_torch.perfmodel import measured_machine
    from spmv_tpu_torch.profile import (
        profile_kernel_fn,
        profiling_report,
        time_kernel,
    )

    kernel, _ = _make_kernel(args, device, dtype)
    kernel.init(verbose=args.verbose)
    op_info = None
    flops_override = bytes_override = None
    if args.spmm > 0:
        if not hasattr(kernel, "spmm_fn"):
            raise SpmvError(
                f"--spmm is not supported by the {kernel.name} kernel")
        step, fargs = kernel.spmm_fn(args.spmm)
        op_info = {"kind": "spmm", "k": args.spmm}
        flops_override = args.spmm * kernel.flops_per_run()
        bytes_override = kernel.spmm_bytes_per_run(args.spmm)
    else:
        step, fargs = kernel.run_fn()
    split = _traffic_split_matrix(args, kernel, device, dtype)
    if args.verbose:
        mode = f"spmm k={args.spmm}" if args.spmm > 0 else "spmv"
        print(f"profiling {kernel.name} ({mode}) for {args.profile} runs "
              f"on {device}", file=sys.stderr)
    warmup = (args.warmup if args.warmup is not None
              else args.profile > 1)
    runs = profile_kernel_fn(step, fargs, runs=args.profile,
                             warmup=warmup)
    chained = time_kernel(step, fargs)
    config = None
    if args.trace_config:
        from spmv_tpu_torch.perfmodel.trace_config import read_trace_config

        config = read_trace_config(args.trace_config)
    traffic = None
    if split is not None:
        from spmv_tpu_torch.profile.traffic import measure_traffic_split

        if args.verbose:
            print("timing traffic-isolation variants "
                  "(full / regular / irregular)", file=sys.stderr)
        traffic = measure_traffic_split(split,
                                        machine=measured_machine(device))
    doc = profiling_report(
        kernel,
        runs_sample=runs,
        seconds_per_iteration=chained.seconds_per_iteration,
        num_runs=args.profile,
        warmup=warmup,
        machine=measured_machine(device),
        device=device,
        trace_config=config,
        op_info=op_info,
        flops_per_run=flops_override,
        bytes_per_run=bytes_override,
    )
    if traffic is not None:
        doc["traffic_split"] = traffic
    dump_json(doc, out)


def _traffic_split_matrix(args, kernel, device, dtype):
    """With ``--traffic-split``: the device matrix to measure after the
    profile, put on the device as the JAX CLI puts it (None without the
    flag).  Refuses, as the JAX CLI does, ``--spmm``, a kernel with no
    matrix, and a format with no variants (the last with the variants'
    ``KernelError``), before any timing."""
    if not args.traffic_split:
        return None
    if args.spmm > 0:
        raise SpmvError("--traffic-split applies to the SpMV step, "
                        "not --spmm")
    if not hasattr(kernel, "matrix"):
        raise SpmvError(
            f"--traffic-split is not supported by the {kernel.name} kernel")
    from spmv_tpu_torch.models.device import device_put_matrix
    from spmv_tpu_torch.ops.traffic import check_traffic_format

    A = device_put_matrix(kernel.matrix, dtype=dtype, device=device)
    check_traffic_format(A)
    return A


def _simulate(args, out, device, dtype) -> None:
    """Simulation mode (``--profile 0``), after the JAX CLI's
    ``_simulate``: the kernel's reference strings replayed through the
    ``--trace-config`` machine model's caches, on the host."""
    from spmv_tpu_torch.perfmodel.cache_trace import trace_cache_misses
    from spmv_tpu_torch.perfmodel.trace_config import read_trace_config
    from spmv_tpu_torch.utils.jsonio import dump_json

    if not args.trace_config:
        raise SpmvError(
            "simulation mode requires --trace-config (JSON machine "
            "model); run with --profile N for on-device timing instead"
        )
    config = read_trace_config(args.trace_config)
    kernel, _ = _make_kernel(args, device, dtype)
    kernel.init(verbose=args.verbose)
    trace = trace_cache_misses(
        config, kernel, warmup=bool(args.warmup),
        verbose=args.verbose,
        progress_interval=(args.progress_interval
                           if args.verbose else 0.0),
    )
    dump_json(trace.to_json(), out)


def _solve_cg(args, out, device, dtype) -> None:
    import numpy as np

    from spmv_tpu_torch.utils.jsonio import dump_json
    from spmv_tpu_torch.ops import (
        dia_conjugate_gradient,
        jacobi_preconditioner,
        preconditioned_conjugate_gradient,
        spmv,
    )
    from spmv_tpu_torch.ops.solvers import extract_diagonal
    from spmv_tpu_torch.profile import device_info

    kernel, mm = _make_kernel(args, device, dtype)
    if kernel.name == "triad":
        raise SpmvError("--cg needs a matrix kernel, not triad")
    kernel.init(verbose=args.verbose)
    m = kernel.matrix
    if m.num_rows != m.num_columns:
        raise SpmvError("--cg requires a square matrix")
    if args.recompute_residual < 0:
        raise SpmvError("--recompute-residual must be >= 0")
    A = kernel.device_matrix()
    diag = None
    if args.precondition == "jacobi":
        # the host ELL, hybrid, WELL-CW, WELL and BSR formats keep no
        # diagonal: read it from the Matrix Market entries the matrix
        # was built from
        diag = extract_diagonal(m if kernel.name == "dia" else
                                mm if mm is not None else kernel._mm)
    if args.nrhs > 1:
        _solve_cg_batched(args, out, device, dtype, kernel, A, diag)
        return
    b = spmv(A, torch.ones(m.num_columns, dtype=dtype, device=device))

    factor_info = None
    if args.precondition == "amg":
        # before the DIA kernel loop, as in the JAX CLI: generic PCG
        # over spmv with the SA-AMG V-cycle, on every format
        minv, factor_info = _amg_preconditioner_cli(kernel, m, mm, device,
                                                    dtype)

        def solve(max_iterations):
            return preconditioned_conjugate_gradient(
                lambda v: spmv(A, v), b, minv, tol=args.cg_tol,
                max_iterations=max_iterations,
                recompute_every=args.recompute_residual)
    elif kernel.name == "dia":
        def solve(max_iterations):
            return dia_conjugate_gradient(
                A, b, tol=args.cg_tol, max_iterations=max_iterations,
                jacobi_diag=diag, recompute_every=args.recompute_residual)
    else:
        precond = None if diag is None else jacobi_preconditioner(
            torch.as_tensor(diag, dtype=dtype, device=device))

        def solve(max_iterations):
            # CG when precond is None, as conjugate_gradient runs it
            return preconditioned_conjugate_gradient(
                lambda v: spmv(A, v), b, precond, tol=args.cg_tol,
                max_iterations=max_iterations,
                recompute_every=args.recompute_residual)

    # One untimed iteration first: one-time set-up on the card (library
    # handles, first launches; about 90 ms, measured on an H100) stays out
    # of "seconds", as the JAX CLI's untimed first solve keeps the compile
    # out.
    solve(1)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    res = solve(args.cg)
    residual = float(res.residual_norm)          # synchronises
    seconds = time.perf_counter() - t0
    x = res.x.double().cpu().numpy()
    doc = {
        "kernel": kernel.describe(),
        "cg": {
            "solver": args.solver,
            "max_iterations": args.cg,
            "tolerance": args.cg_tol,
            "preconditioner": args.precondition,
            "iterations": int(res.iterations),
            "residual_norm": residual,
            "solution_rms_error_vs_ones": float(
                np.linalg.norm(x - 1.0) / np.sqrt(m.num_rows)),
            "seconds": seconds,
            "device": device_info(device)["platform"],
        },
    }
    if factor_info is not None:
        doc["cg"]["factorization"] = factor_info
    dump_json(doc, out)


def _amg_preconditioner_cli(kernel, m, mm, device, dtype):
    """The SA-AMG V-cycle apply for --precondition amg, after the JAX
    CLI's ``_amg_preconditioner_cli``: an unpadded host CSR as it is,
    else the Matrix Market entries the matrix was built from (the
    kernel's, or with ``-s auto`` the ones ``_make_kernel`` returned).
    The JAX CLI falls back to the converted matrix when the kernel kept
    no entries, and ``_as_host_csr`` has no WELL, WELL-CW or BSR branch,
    so its ``-s auto`` raises ``TypeError`` where the port reads the
    entries."""
    from spmv_tpu_torch.models.csr import CsrMatrix
    from spmv_tpu_torch.ops.amg import amg_preconditioner

    if isinstance(m, CsrMatrix) and int(m.row_ptr[-1]) == m.num_entries:
        host = m
    else:
        host = mm if mm is not None else kernel._mm
    return amg_preconditioner(host, dtype=dtype, device=device)


def _solve_cg_batched(args, out, device, dtype, kernel, A, diag) -> None:
    """--cg N --nrhs K: batched multi-RHS CG (one SpMM per iteration),
    per-column convergence in the report; after the JAX CLI's
    ``_solve_cg_batched``."""
    import numpy as np

    from spmv_tpu_torch.utils.jsonio import dump_json
    from spmv_tpu_torch.ops import (
        batched_conjugate_gradient,
        dia_batched_conjugate_gradient,
        jacobi_preconditioner,
        spmm,
    )
    from spmv_tpu_torch.profile import device_info

    if args.solver != "cg":
        raise SpmvError("--nrhs applies to --solver cg only")
    if args.precondition not in ("none", "jacobi"):
        raise SpmvError(
            "--nrhs supports --precondition none or jacobi (column-"
            "wise applies); use single-RHS solves for ic0/ilu0/amg")
    k = args.nrhs
    m = kernel.matrix
    # per-column scaled all-ones solutions: each column's B = A @
    # ((j+1) * ones), so the rms-error gate checks every column
    scale = torch.arange(1, k + 1, dtype=dtype, device=device)
    X_true = torch.ones((m.num_columns, k), dtype=dtype,
                        device=device) * scale
    B = spmm(A, X_true)

    if kernel.name == "dia":
        def solve(max_iterations):
            return dia_batched_conjugate_gradient(
                A, B, tol=args.cg_tol, max_iterations=max_iterations,
                jacobi_diag=diag, recompute_every=args.recompute_residual)
    else:
        precond = None if diag is None else jacobi_preconditioner(
            torch.as_tensor(diag, dtype=dtype, device=device)[:, None])

        def solve(max_iterations):
            return batched_conjugate_gradient(
                lambda V: spmm(A, V), B, preconditioner=precond,
                tol=args.cg_tol, max_iterations=max_iterations,
                recompute_every=args.recompute_residual)

    # one untimed iteration first, as in _solve_cg
    solve(1)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    res = solve(args.cg)
    residuals = res.residual_norm.double().cpu().numpy()   # synchronises
    seconds = time.perf_counter() - t0
    X = res.x.double().cpu().numpy()
    Xt = X_true.double().cpu().numpy()
    errs = [float(np.linalg.norm(X[:, j] - Xt[:, j])
                  / np.sqrt(m.num_rows) / (j + 1)) for j in range(k)]
    dump_json({
        "kernel": kernel.describe(),
        "cg": {
            "solver": "cg",
            "nrhs": k,
            "max_iterations": args.cg,
            "tolerance": args.cg_tol,
            "preconditioner": args.precondition,
            "iterations": [int(i) for i in res.iterations.cpu()],
            "residual_norms": [float(v) for v in residuals],
            "solution_rms_error_vs_ones": errs,
            "seconds": seconds,
            "device": device_info(device)["platform"],
        },
    }, out)


def main(argv=None, out=None) -> int:
    args = build_parser().parse_args(argv)
    out = out or sys.stdout
    try:
        _check_ported(args)
        from spmv_tpu_torch.models.device import (
            default_device,
            default_value_dtype,
        )

        if args.list_devices:
            _list_devices(out)
            return 0
        device = default_device()
        dtype = default_value_dtype()
        if args.cg > 0:
            _solve_cg(args, out, device, dtype)
        elif args.profile > 0:
            _profile(args, out, device, dtype)
        else:
            _simulate(args, out, device, dtype)
    except (SpmvError, FileNotFoundError) as e:
        print(f"spmv-tpu-torch: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
