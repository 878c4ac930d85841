"""Command-line interface of the port.

Takes the JAX package's flags (``spmv_tpu.cli.build_parser``) and runs
the modes ported so far, printing the same JSON documents:

    python -m spmv_tpu_torch --matrix A.mtx --spmv-format dia --profile 10
    python -m spmv_tpu_torch --matrix A.mtx --spmv-format dia --profile 5 --spmm 4
    python -m spmv_tpu_torch --matrix A.mtx --spmv-format dia --cg 2000 \
        [--cg-tol 1e-6] [--precondition none|jacobi] [--recompute-residual K]
    python -m spmv_tpu_torch --matrix A.mtx --spmv-format wellcw --profile 10
    python -m spmv_tpu_torch --matrix A.mtx --spmv-format wellcw --cg 2000
    python -m spmv_tpu_torch --triad 100000000 --profile 5
    python -m spmv_tpu_torch --list-devices

Every other mode or flag prints ``spmv-tpu-torch: ... not yet ported``
and exits 1.  The device is the first CUDA device when one is present,
else the CPU (for the tests).

``--cg`` on a WELL-CW matrix runs the generic (P)CG over ``spmv``, as
the JAX CLI does.  On a DIA matrix and a CUDA device it runs the kernel
loop with K1's fused p.Ap dot (``dia_conjugate_gradient``'s default, as
in the JAX CLI), so both CLIs run the same algorithm.  On an H100 the
unfused loop (a separate ``torch.dot``) measured faster; ``python -m
spmv_tpu_torch.profile.cg_breakdown`` times both, and PERF.md keeps the
numbers until a kernel change or a measured choice settles which runs.
"""

from __future__ import annotations

import sys
import time

import torch

from spmv_tpu.errors import KernelError, SpmvError

__all__ = ["main", "build_parser"]


def build_parser():
    from spmv_tpu.cli import build_parser as _shared

    p = _shared()
    p.prog = "spmv-tpu-torch"
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
        ("--traffic-split", args.traffic_split),
        ("--jax-profile", args.jax_profile is not None),
        ("--flush-caches", args.flush_caches),
        ("--reorder", args.reorder != "none"),
        ("--nrhs", args.nrhs != 1),
        ("--solver " + args.solver, args.solver != "cg"),
        ("--precondition " + args.precondition,
         args.precondition not in ("none", "jacobi")),
    ):
        if on:
            _not_ported(flag)
    if args.cg <= 0 and args.profile <= 0:
        _not_ported("simulation mode (--profile 0)")
    if args.triad <= 0 and args.matrix and \
            args.spmv_format not in ("dia", "wellcw"):
        _not_ported(f"--spmv-format {args.spmv_format}")
    if args.spmm > 0 and args.spmv_format == "wellcw":
        _not_ported("--spmm on wellcw (kernels K4)")


def _make_kernel(args, device, dtype):
    from spmv_tpu_torch.kernels import make_kernel

    if args.triad > 0:
        return make_kernel("triad", triad_entries=args.triad,
                           device=device, dtype=dtype)
    if not args.matrix:
        raise SpmvError("either --matrix or --triad N is required "
                        "(see --help)")
    return make_kernel(args.spmv_format, matrix_path=args.matrix,
                       device=device, dtype=dtype)


def _list_devices(out) -> None:
    from spmv_tpu.utils.jsonio import dump_json
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
    dev = default_device()
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
    from spmv_tpu.utils.jsonio import dump_json
    from spmv_tpu_torch.perfmodel import measured_machine
    from spmv_tpu_torch.profile import (
        profile_kernel_fn,
        profiling_report,
        time_kernel,
    )

    kernel = _make_kernel(args, device, dtype)
    kernel.init(verbose=args.verbose)
    op_info = None
    flops_override = bytes_override = None
    if args.spmm > 0:
        if not hasattr(kernel, "spmm_fn"):
            raise SpmvError(
                f"--spmm is not supported by the {kernel.name} kernel")
        step, fargs = kernel.spmm_fn(args.spmm)
        op_info = {"kind": "spmm", "k": args.spmm}
        # k products share one matrix stream; the x / y volume scales
        # with k at the same value width bytes_per_run uses
        m = kernel.matrix
        flops_override = args.spmm * kernel.flops_per_run()
        bytes_override = kernel.bytes_per_run() + (args.spmm - 1) * (
            m.num_columns + m.num_rows) * kernel.value_bytes
    else:
        step, fargs = kernel.run_fn()
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
        from spmv_tpu.perfmodel.trace_config import read_trace_config

        config = read_trace_config(args.trace_config)
    dump_json(profiling_report(
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
    ), out)


def _solve_cg(args, out, device, dtype) -> None:
    import numpy as np

    from spmv_tpu.utils.jsonio import dump_json
    from spmv_tpu_torch.ops import (
        dia_conjugate_gradient,
        jacobi_preconditioner,
        preconditioned_conjugate_gradient,
        spmv,
    )
    from spmv_tpu_torch.ops.solvers import extract_diagonal
    from spmv_tpu_torch.profile import device_info

    kernel = _make_kernel(args, device, dtype)
    if kernel.name == "triad":
        raise SpmvError("--cg needs a matrix kernel, not triad")
    kernel.init(verbose=args.verbose)
    m = kernel.matrix
    if m.num_rows != m.num_columns:
        raise SpmvError("--cg requires a square matrix")
    if args.recompute_residual < 0:
        raise SpmvError("--recompute-residual must be >= 0")
    A = kernel.device_matrix()
    b = spmv(A, torch.ones(m.num_columns, dtype=dtype, device=device))
    diag = None
    if args.precondition == "jacobi":
        # the host WELL-CW format keeps no diagonal: read it from the
        # Matrix Market entries the kernel was built from
        diag = extract_diagonal(m if kernel.name == "dia" else kernel._mm)

    if kernel.name == "dia":
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
    dump_json({
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

        device = default_device()
        dtype = default_value_dtype()
        if args.list_devices:
            _list_devices(out)
        elif args.cg > 0:
            _solve_cg(args, out, device, dtype)
        else:
            _profile(args, out, device, dtype)
    except (SpmvError, FileNotFoundError) as e:
        print(f"spmv-tpu-torch: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
