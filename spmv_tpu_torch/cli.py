"""Command-line interface of the port.

Takes the JAX package's flags (``build_parser`` is the port's copy of
``spmv_tpu.cli.build_parser``: the same flags, defaults and help) and
runs the modes ported so far, printing the same JSON documents:

    python -m spmv_tpu_torch --matrix A.mtx --spmv-format dia --profile 10
    python -m spmv_tpu_torch --matrix A.mtx --spmv-format FMT --profile 5 --spmm 8
    python -m spmv_tpu_torch --matrix A.mtx --spmv-format FMT --cg 2000 \
        [--cg-tol 1e-6] [--solver cg|bicgstab|gmres|chebyshev] \
        [--restart 32] \
        [--precondition none|jacobi|ic0|ic0-sweeps|ilu0|ilu0-sweeps|amg] \
        [--recompute-residual K]
    python -m spmv_tpu_torch --matrix A.mtx --spmv-format FMT \
        --cg 2000 --nrhs 4 [--precondition none|jacobi]
    python -m spmv_tpu_torch --matrix A.mtx --spmv-format FMT --profile 5 \
        --traffic-split
    python -m spmv_tpu_torch --matrix A.mtx --spmv-format FMT \
        --trace-config configs/cpu-2thread.json [--warmup]
    python -m spmv_tpu_torch --matrix A.mtx --spmv-format FMT --eigs 8 \
        [--which smallest|largest] [--eigs-tol 1e-6] [--eigs-maxiter 200] \
        [--precondition none|jacobi|amg]
    python -m spmv_tpu_torch --matrix A.mtx --spmv-format FMT --scaling 4
    python -m spmv_tpu_torch --matrix A.mtx --spmv-format FMT --profile 10 \
        [--flush-caches] [--jax-profile DIR]
    python -m spmv_tpu_torch --triad 100000000 --profile 5
    python -m spmv_tpu_torch --list-profile-events [DIR]
    python -m spmv_tpu_torch --list-devices

with FMT any of ``-s``'s values: the reference tool's formats ``csr``
(the default), ``coo``, ``coo-atomic``, ``ell`` and ``hybrid``, the
library comparison ``xla-csr`` (``torch.sparse``), and ``dia``,
``wellcw``, ``well``, ``bsr`` and ``auto`` (``--profile N`` alone times
the SpMV, ``--spmm K`` the SpMM of K columns).  ``--reorder
rcm|gp|sigma|color`` reorders the matrix before conversion on every
explicit format, as the JAX CLI does (``color``: greedy multicoloring,
rows numbered color by color, which collapses an incomplete factor's
triangular-solve levels to the colors); ``-s auto`` picks the format as
the JAX CLI does (``auto_format``, the ``spmm`` workload when ``--spmm``
is given, which lets a block-structured matrix pick BSR) and refuses
``--reorder``.  The device is the first CUDA device; without one the
CLI exits 1, unless ``SPMV_TPU_TORCH_DEVICE=cpu`` asks for the CPU (as
the tests do).
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

In profile mode ``--flush-caches`` sweeps 64 MB through the caches
before every timed run (``profile.harness.cache_flusher``, a read past
the H100's 50 MB L2), and ``--jax-profile DIR`` captures the runs with
``torch.profiler`` into ``DIR/*.pt.trace.json`` (``profile.capture``),
whose kernels, memcpys and memsets fill the report's
``"profiling_events"``; the flag keeps the JAX CLI's name, and both are
ignored in the other modes, as there.  ``--list-profile-events [DIR]``
lists a capture's planes, lines and event args, or those of a DIA SpMV
it profiles first on the device when DIR is omitted.

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

``--cg N --solver bicgstab|gmres|chebyshev`` runs the JAX CLI's other
solvers over ``spmv`` on every format, with its branches and messages:
BiCGSTAB and GMRES (``--restart`` m, reported as ``restart``) with
``--precondition`` none, jacobi, ic0, ic0-sweeps, ilu0, ilu0-sweeps or
amg; Chebyshev with ``lanczos_bounds`` (reported as
``spectral_bounds``) and no preconditioner.  ``--precondition
ic0|ilu0`` (any solver but Chebyshev) factors the matrix on the host
(``ops.incomplete``, ``csrc/ic0.cpp``) from an unpadded CSR view (the
CSR matrix itself, else the Matrix Market entries; ``-s auto`` keeps
none and exits 1) and applies the level-scheduled triangular solves of
the hand-written ``tri_solve`` kernel; the ``-sweeps`` variants apply 6
Jacobi sweeps a triangle on the same kernel.  The report carries the
factor's levels, width and the JAX layout's ``padding_factor`` under
``"factorization"``.  ``--recompute-residual`` with a solver other than
cg exits 1, as in the JAX CLI.

``--cg N --nrhs K`` (K > 1) runs batched multi-RHS CG, one SpMM per
iteration (K2 on DIA, K4a-c and the CSR SpMM on WELL-CW, K6a or K6b on
WELL, K7 on BSR, the CSR SpMM on CSR and COO, the ELL SpMM on ELL and,
for hybrid, the CSR SpMM after it), on B = A X with column j of X
equal to (j + 1) * ones, and reports each column's iterations, residual and
error, as the JAX CLI does.

``--scaling P`` predicts the sharded SpMV step on P cards
(``perfmodel.scaling``): the halo each shard of the nnz-balanced row
partition must receive, counted on the host from the matrix's CSR view
(the CSR matrix itself, else the Matrix Market entries), the local time
priced with the triad measured on the device, the communication over an
assumed NVLink 4 rate with its breakeven efficiency.  The report keeps
the JAX CLI's keys but for the ICI-named ones (``interconnect``,
``interconnect_efficiency_assumed``, ``interconnect_efficiency_breakeven``)
and prices ``value_bytes`` at the value dtype's width.

``--eigs K`` computes the K extreme eigenpairs with block LOBPCG
(``ops.eigen.lobpcg``) over the format's SpMM, with the JAX CLI's guards
and messages: a matrix kernel, a square matrix, K below its dimension,
no skew-symmetric storage, and for general storage a random symmetry
probe (two SpMMs).  Symmetric storage is expanded and the matrix rebuilt
from the expanded entries.  ``--precondition jacobi`` reads the diagonal
from the Matrix Market entries; ``amg`` applies one SA-AMG V-cycle to the
whole (n, K) block (every product one CSR SpMM launch), built from the
expanded entries for symmetric storage and from the entries under ``-s
auto`` (the JAX CLI hands over the converted matrix, and raises
``TypeError`` where auto picks WELL).  The start block comes
from a ``torch.Generator`` seeded 0, so iteration counts differ from the
JAX CLI's, whose start is ``jax.random``'s.  One untimed solve of one
iteration first keeps the kernel builds out of ``seconds``.
"""

from __future__ import annotations

import argparse
import contextlib
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
            "color": reorder.find_new_order_coloring,
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
            # torch.profiler's capture, read by profile.capture (the key
            # keeps the JAX CLI's name)
            "trace_capture": True,
            "xplane_parsing": True,
            "per_kernel_device_time": dev.type == "cuda",  # CUDA events
            "hardware_counters": False,
        },
        "machine_models": [measured_machine(dev).to_json()],
    }, out)


def _scaling_report(args, out, device, dtype) -> None:
    """Predict the P-card sharded-SpMV step for the loaded matrix (the
    JAX CLI's ``_scaling_report``).

    The halo volume is counted on the host from the actual nnz-balanced
    row partition (``parallel.halo.communication_volume``); the local
    time is priced with the triad measured on ``device``; the NVLink
    efficiency is an assumption, printed beside the efficiency at which
    the weak-scaling claim would fail.  ``value_bytes`` is the value
    dtype's width, where the JAX CLI prices 4 bytes at every dtype.
    """
    import numpy as np

    from spmv_tpu_torch.models.csr import CsrMatrix
    from spmv_tpu_torch.models.partition import rows_partition_balanced_nnz
    from spmv_tpu_torch.parallel.halo import communication_volume
    from spmv_tpu_torch.perfmodel import measured_machine, spmv_scaling_model
    from spmv_tpu_torch.utils.jsonio import dump_json

    P = args.scaling
    kernel, mm = _make_kernel(args, device, dtype)
    if kernel.name == "triad":
        raise SpmvError("--scaling needs a matrix kernel, not triad")
    kernel.init(verbose=args.verbose)
    m = kernel.matrix
    csr = (m if isinstance(m, CsrMatrix) else CsrMatrix.from_matrix_market(
        kernel._mm if kernel._mm is not None else mm))
    if csr.num_rows < P:
        raise SpmvError(
            f"--scaling {P} exceeds the row count {csr.num_rows}")
    bounds = rows_partition_balanced_nnz(csr.row_ptr, P)
    vol = communication_volume(csr, bounds)
    need = np.asarray(vol["need"])
    # the exchanged elements of the worst shard (the halo paths pad
    # every shard's exchange to it): its distinct off-shard reads
    off_diag = need.sum(axis=1) - np.diag(need)
    halo = int(off_diag.max()) if P > 1 else 0
    # priced as the measured element count (ragged-halo: halo *
    # value_bytes), as the JAX CLI does: it already counts both sides
    scheme = "ragged-halo"
    machine = measured_machine(device)
    nnz_per_row = max(csr.num_entries / max(csr.num_rows, 1), 1.0)
    model = spmv_scaling_model(
        num_shards=P,
        rows_per_shard=-(-csr.num_rows // P),
        num_diagonals=max(int(round(nnz_per_row)), 1),
        halo=halo,
        value_bytes=dtype.itemsize,
        scheme=scheme,
        machine=machine,
    )
    doc = model.to_json()
    doc["scheme"] = scheme
    doc["halo_elements_measured"] = halo
    doc["all_gather_elements"] = int(vol["all_gather_elements"])
    doc["note"] = (
        f"local time priced at the triad measured on {machine.name} "
        f"({machine.hbm_gbps:.1f} GB/s); interconnect_efficiency_assumed is "
        "an assumption (no second card reachable): the weak-scaling claim "
        "fails below interconnect_efficiency_breakeven")
    dump_json({"kernel": {"name": kernel.name,
                          "num_rows": csr.num_rows,
                          "num_entries": csr.num_entries},
               "scaling": doc}, out)


def _profile(args, out, device, dtype) -> None:
    from spmv_tpu_torch.utils.jsonio import dump_json
    from spmv_tpu_torch.perfmodel import measured_machine
    from spmv_tpu_torch.profile import (
        cache_flusher,
        profile_kernel_fn,
        profiling_report,
        time_kernel,
    )
    from spmv_tpu_torch.profile.capture import trace

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
    flusher = cache_flusher(device) if args.flush_caches else None
    trace_ctx = (trace(args.jax_profile, device) if args.jax_profile
                 else contextlib.nullcontext())
    warmup = (args.warmup if args.warmup is not None
              else args.profile > 1)
    with trace_ctx:
        runs = profile_kernel_fn(step, fargs, runs=args.profile,
                                 warmup=warmup, between_runs=flusher)
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
        flush_caches=args.flush_caches,
        trace_config=config,
        jax_profile_dir=args.jax_profile,
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
        bicgstab,
        chebyshev,
        dia_conjugate_gradient,
        gmres,
        jacobi_preconditioner,
        lanczos_bounds,
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
    if args.recompute_residual and args.solver != "cg":
        raise SpmvError(
            "--recompute-residual applies to --solver cg only "
            "(bicgstab/gmres/chebyshev have their own residual "
            "semantics)")
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

    def matvec(v):
        return spmv(A, v)

    # the JAX CLI's choices: Chebyshev takes no preconditioner; amg and
    # ic0/ilu0 run the generic solver over spmv on every format, before
    # the DIA kernel loop, which takes plain and Jacobi CG
    factor_info = chebyshev_bounds = minv = None
    if args.solver == "chebyshev":
        if args.precondition != "none":
            raise SpmvError(
                "--solver chebyshev does not take a preconditioner "
                "(its spectral bounds already play that role)")
        lo, hi = lanczos_bounds(matvec, m.num_rows, dtype=dtype,
                                device=device)
        chebyshev_bounds = {"lambda_min": lo, "lambda_max": hi}
    elif args.precondition.startswith(("ic0", "ilu0")):
        minv, factor_info = _incomplete_preconditioner(args, kernel, m,
                                                       device, dtype)
    elif args.precondition == "amg":
        minv, factor_info = _amg_preconditioner_cli(kernel, m, mm, device,
                                                    dtype)
    elif diag is not None:
        minv = jacobi_preconditioner(
            torch.as_tensor(diag, dtype=dtype, device=device))

    if args.solver == "chebyshev":
        def solve(max_iterations):
            return chebyshev(matvec, b, lo, hi, tol=args.cg_tol,
                             max_iterations=max_iterations)
    elif args.solver == "gmres":
        def solve(max_iterations):
            return gmres(matvec, b, preconditioner=minv, tol=args.cg_tol,
                         restart=args.restart,
                         max_iterations=max_iterations)
    elif args.solver == "bicgstab":
        def solve(max_iterations):
            return bicgstab(matvec, b, preconditioner=minv,
                            tol=args.cg_tol, max_iterations=max_iterations)
    elif kernel.name == "dia" and factor_info is None:
        def solve(max_iterations):
            return dia_conjugate_gradient(
                A, b, tol=args.cg_tol, max_iterations=max_iterations,
                jacobi_diag=diag, recompute_every=args.recompute_residual)
    else:
        def solve(max_iterations):
            # CG when minv is None, as conjugate_gradient runs it
            return preconditioned_conjugate_gradient(
                matvec, b, minv, tol=args.cg_tol,
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
    if args.solver == "gmres":
        doc["cg"]["restart"] = args.restart
    if chebyshev_bounds is not None:
        doc["cg"]["spectral_bounds"] = chebyshev_bounds
    dump_json(doc, out)


def _incomplete_preconditioner(args, kernel, m, device, dtype):
    """The IC(0) / ILU(0) apply for ``--precondition ic0|ilu0[-sweeps]``,
    after the JAX CLI's ``_incomplete_preconditioner``: the factor of an
    unpadded host CSR view of the matrix (the matrix itself when it is
    one, else the Matrix Market entries the kernel was built from; a
    matrix that ``-s auto`` converted keeps none, and the CLI exits 1 as
    the JAX CLI does), applied by the level-scheduled solves, or by 6
    Jacobi sweeps a triangle for the ``-sweeps`` variants."""
    from spmv_tpu_torch.models.csr import CsrMatrix
    from spmv_tpu_torch.ops.incomplete import (
        ic0_factor,
        ic0_preconditioner,
        ilu0_factor,
        ilu0_preconditioner,
    )

    mm = kernel._mm
    if isinstance(m, CsrMatrix) and int(m.row_ptr[-1]) == m.num_entries:
        csr = m
    elif mm is not None:
        csr = CsrMatrix.from_matrix_market(mm)
    else:
        raise SpmvError(
            f"--precondition {args.precondition} needs a CSR view of "
            "the matrix; use -s csr (or a file-loaded matrix)"
        )
    name, _, variant = args.precondition.partition("-")
    method = "sweeps" if variant == "sweeps" else "levels"
    if name == "ic0":
        apply_fn, info = ic0_preconditioner(ic0_factor(csr), method=method,
                                            dtype=dtype, device=device)
    else:
        L, U = ilu0_factor(csr)
        apply_fn, info = ilu0_preconditioner(L, U, method=method,
                                             dtype=dtype, device=device)
    info["kind"] = name
    return apply_fn, info


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


def _solve_eigs(args, out, device, dtype) -> None:
    """--eigs K: block LOBPCG eigenpairs, JSON report on stdout; after the
    JAX CLI's ``_solve_eigs``."""
    from spmv_tpu_torch.kernels import make_kernel
    from spmv_tpu_torch.ops import jacobi_preconditioner, lobpcg, spmm
    from spmv_tpu_torch.ops.amg import amg_preconditioner
    from spmv_tpu_torch.ops.solvers import extract_diagonal
    from spmv_tpu_torch.profile import device_info
    from spmv_tpu_torch.utils.jsonio import dump_json

    kernel, mm = _make_kernel(args, device, dtype)
    if kernel.name == "triad":
        raise SpmvError("--eigs needs a matrix kernel, not triad")
    kernel.init(verbose=args.verbose)
    m = kernel.matrix
    if m.num_rows != m.num_columns:
        raise SpmvError("--eigs requires a square (symmetric) matrix")
    if args.eigs >= m.num_rows:
        raise SpmvError("--eigs K must be < the matrix dimension")
    # the entries the matrix was built from (-s auto keeps them apart)
    entries = mm if mm is not None else kernel._mm
    sym = entries.symmetry
    if sym == "skew-symmetric":
        raise SpmvError(
            "--eigs needs a symmetric operator; skew-symmetric "
            "matrices have an imaginary spectrum")
    mm_full = None
    operator = kernel
    if sym != "general":
        # symmetric storage holds one triangle; the eigenproblem needs
        # the whole operator
        mm_full = entries.expand_symmetry()
        operator = make_kernel(kernel.name, mm=mm_full, device=device,
                               dtype=dtype)
        operator.init()
    A = operator.device_matrix()
    n = m.num_rows
    if sym == "general":
        # general storage promises nothing: <u, A v> == <A u, v> on two
        # random pairs catches an asymmetric A for two SpMMs
        gen = torch.Generator(device=device).manual_seed(1)
        Up = torch.randn((n, 2), generator=gen, dtype=dtype, device=device)
        Vp = torch.randn((n, 2), generator=gen, dtype=dtype, device=device)
        AU = spmm(A, Up)
        AV = spmm(A, Vp)
        lhs = (Up * AV).sum(0)
        rhs = (AU * Vp).sum(0)
        scale = torch.maximum(
            lhs.abs() + rhs.abs(),
            torch.linalg.vector_norm(AU, dim=0)
            * torch.linalg.vector_norm(Vp, dim=0)
            * torch.finfo(torch.float32).eps)
        asym = float(((lhs - rhs).abs() / scale).max())
        if asym > 1e-3:
            raise SpmvError(
                "--eigs requires a numerically symmetric operator; "
                f"random probe found <u,Av> != <Au,v> (relative "
                f"asymmetry {asym:.2e}). Re-store the matrix with "
                "symmetric field or symmetrize it first.")
    minv = None
    if args.precondition == "jacobi":
        minv = jacobi_preconditioner(torch.as_tensor(
            extract_diagonal(entries), dtype=dtype, device=device)[:, None])
    elif args.precondition == "amg":
        if mm_full is not None:
            minv, _ = amg_preconditioner(mm_full, dtype=dtype, device=device)
        else:
            minv, _ = _amg_preconditioner_cli(kernel, m, mm, device, dtype)
    elif args.precondition != "none":
        raise SpmvError(
            "--eigs takes --precondition none, jacobi or amg")

    gen = torch.Generator(device=device).manual_seed(0)
    X0 = torch.randn((n, args.eigs), generator=gen, dtype=dtype,
                     device=device)

    def solve(max_iterations):
        return lobpcg(lambda V: spmm(A, V), X0, preconditioner=minv,
                      largest=(args.which == "largest"), tol=args.eigs_tol,
                      max_iterations=max_iterations)

    # one untimed iteration first, as in _solve_cg
    solve(1)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    res = solve(args.eigs_maxiter)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    seconds = time.perf_counter() - t0
    dump_json({
        "kernel": kernel.describe(),
        "eigs": {
            "k": args.eigs,
            "which": args.which,
            "method": "lobpcg",
            "preconditioner": args.precondition,
            "tolerance": args.eigs_tol,
            "eigenvalues": [float(v) for v in res.eigenvalues.cpu()],
            "residual_norms": [float(v) for v in res.residual_norms.cpu()],
            "iterations": int(res.iterations),
            "seconds": seconds,
            "device": device_info(device)["platform"],
        },
    }, out)


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
        from spmv_tpu_torch.models.device import (
            default_device,
            default_value_dtype,
        )

        if args.list_devices:
            _list_devices(out)
            return 0
        if args.list_profile_events is not None:
            from spmv_tpu_torch.profile import list_profile_events
            from spmv_tpu_torch.utils.jsonio import dump_json

            dump_json(list_profile_events(args.list_profile_events or None),
                      out)
            return 0
        device = default_device()
        dtype = default_value_dtype()
        if args.eigs > 0:
            _solve_eigs(args, out, device, dtype)
        elif args.scaling > 0:
            _scaling_report(args, out, device, dtype)
        elif args.cg > 0:
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
