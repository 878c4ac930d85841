"""The port's simulation mode (``--profile 0``) against the JAX package.

The port keeps copies of ``spmv_tpu/perfmodel/{cache_sim,layout,
cache_trace,refstring,native}.py`` and of the kernel classes' layouts and
reference strings.  On small matrices made from fixed seeds:

- every kernel's per-thread memory reference string (addresses and NUMA
  domains) ``np.array_equal`` to JAX's at 1, 2 and 4 threads, for every
  kernel name (``xla-csr`` raises in both, as the reference's MKL
  wrapper does);
- ``trace_cache_misses(...).to_json()`` equal to JAX's on
  ``configs/cpu-2thread.json`` and ``configs/tpu-v5e-measured.json``,
  with and without warmup;
- the native replay (``csrc/simcache.cpp`` built by the port's own loader
  into ``spmv_tpu_torch/_build/host/``) equal to the pure-Python replay;
- the CLI's ``--profile 0`` document equal to the JAX CLI's, and its
  refusal without ``--trace-config`` JAX's, exit 1 and message.
"""

import io
import json
import os

import numpy as np
import pytest
import torch

from spmv_tpu.cli import main as jax_main
from spmv_tpu.io import generate as jgen
from spmv_tpu.io import write_matrix_market
from spmv_tpu.kernels import make_kernel as jax_make_kernel
from spmv_tpu.perfmodel import cache_trace as jcache_trace
from spmv_tpu.perfmodel import trace_config as jtrace_config
from spmv_tpu_torch.cli import main
from spmv_tpu_torch.errors import KernelError
from spmv_tpu_torch.io import generate as pgen
from spmv_tpu_torch.kernels import KERNEL_NAMES, make_kernel
from spmv_tpu_torch.models.device import DEVICE_ENV
from spmv_tpu_torch.perfmodel import (
    LRU,
    native,
    parse_trace_config,
    read_trace_config,
    trace_cache_misses,
    trace_cache_misses_interleaved,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = ("cpu-2thread.json", "tpu-v5e-measured.json")


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv(DEVICE_ENV, "cpu")


def _config(threads):
    """A machine of ``threads`` threads, each with a private 4 KiB L1,
    over a shared 64 KiB L3, across two NUMA domains."""
    return {
        "name": f"t{threads}", "num_numa_domains": 2,
        "caches": {**{f"L1-{t}": {"size": 4096, "line_size": 64,
                                   "parent": "L3"} for t in range(threads)},
                   "L3": {"size": 65536, "line_size": 64, "parent": None}},
        "thread_affinities": [{"thread": t, "cpu": t, "cache": f"L1-{t}",
                               "numa_domain": t % 2}
                              for t in range(threads)]}


def _kernels(name, matrix=lambda g: g.random_sparse(300, 300, 7, seed=3)):
    """(JAX kernel, the port's kernel) of ``name``, each initialised on
    its own package's copy of the same generated matrix."""
    if name == "triad":
        j, p = (jax_make_kernel("triad", triad_entries=1000),
                make_kernel("triad", triad_entries=1000))
    else:
        j = jax_make_kernel(name, mm=matrix(jgen))
        p = make_kernel(name, mm=matrix(pgen))
    j.init()
    p.init()
    return j, p


SIM_KERNELS = tuple(n for n in KERNEL_NAMES if n != "xla-csr")


@pytest.mark.parametrize("threads", [1, 2, 4])
@pytest.mark.parametrize("name", SIM_KERNELS)
def test_reference_strings_equal_jax(name, threads):
    j, p = _kernels(name)
    jc = jtrace_config.parse_trace_config(_config(threads))
    pc = parse_trace_config(_config(threads))
    total = 0
    for t in range(threads):
        ja, jn = j.memory_reference_string(jc, t, threads)
        pa, pn = p.memory_reference_string(pc, t, threads)
        assert np.array_equal(pa, ja) and np.array_equal(pn, jn), t
        assert pa.dtype == ja.dtype and pn.dtype == jn.dtype
        total += pa.size
    assert total > 0


def test_xla_csr_has_no_reference_string():
    j, p = _kernels("xla-csr")
    from spmv_tpu.errors import KernelError as JaxKernelError

    with pytest.raises(JaxKernelError):
        j.memory_reference_string(jtrace_config.parse_trace_config(
            _config(2)), 0, 2)
    with pytest.raises(KernelError, match="not implemented for the "
                       "library kernel 'xla-csr'"):
        p.memory_reference_string(parse_trace_config(_config(2)), 0, 2)


def test_layout_is_built_at_first_use():
    """Profile mode pays nothing for the simulation's layout: ``init``
    builds none, the first reference string does, and a new thread count
    rebuilds COO's workspace."""
    p = make_kernel("coo", mm=pgen.poisson2d(6, 6))
    p.init()
    assert p._layout is None
    cfg = parse_trace_config(_config(2))
    p.memory_reference_string(cfg, 0, 2)
    assert p._layout["workspace"].num_elements == 2 * 36
    p.memory_reference_string(parse_trace_config(_config(4)), 0, 4)
    assert p._layout["workspace"].num_elements == 4 * 36


@pytest.mark.parametrize("warmup", [False, True], ids=["cold", "warmup"])
@pytest.mark.parametrize("config", CONFIGS)
@pytest.mark.parametrize("name", ["csr", "ell", "coo", "hybrid", "dia",
                                  "well", "wellcw", "bsr", "triad"])
def test_trace_cache_misses_equal_jax(name, config, warmup):
    path = os.path.join(REPO, "configs", config)
    j, p = _kernels(name, lambda g: g.poisson2d(16, 16))
    want = jcache_trace.trace_cache_misses(
        jtrace_config.read_trace_config(path), j, warmup=warmup).to_json()
    got = trace_cache_misses(read_trace_config(path), p,
                             warmup=warmup).to_json()
    assert got == want


def test_native_core_is_the_ports_own_build():
    path = native.library_path()
    assert path is not None, "g++ is available here"
    assert os.path.dirname(path) == os.path.join(
        REPO, "spmv_tpu_torch", "_build", "host")
    assert os.path.basename(path).startswith("libsimcache_")


@pytest.mark.parametrize("policy,cls", [(0, LRU)], ids=["lru"])
def test_native_replay_equals_python_replay(policy, cls):
    rng = np.random.default_rng(42)
    strings = []
    for _ in range(4):
        n = int(rng.integers(100, 400))
        strings.append((rng.integers(0, 256, n).astype(np.uint64) * 64,
                        rng.integers(0, 3, n).astype(np.int32)))
    py = trace_cache_misses_interleaved(cls(32, 64), strings, 3,
                                        use_native=False)
    nat = native.replay_interleaved(policy, 32, 64, strings, 3)
    np.testing.assert_array_equal(py, nat)


@pytest.mark.parametrize("warmup", [False, True], ids=["cold", "warmup"])
@pytest.mark.parametrize("name", ["csr", "hybrid", "well"])
def test_native_orchestration_equals_python(name, warmup):
    _, p = _kernels(name, lambda g: g.poisson2d(12, 12))
    cfg = read_trace_config(os.path.join(REPO, "configs", CONFIGS[0]))
    a = trace_cache_misses(cfg, p, warmup=warmup, use_native=False)
    b = trace_cache_misses(cfg, p, warmup=warmup, use_native=True)
    assert a.to_json() == b.to_json()


@pytest.fixture(scope="module")
def matrix_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("simulate") / "scattered.mtx"
    write_matrix_market(jgen.random_sparse(200, 200, 6, seed=4), str(path))
    return str(path)


def _run(fn, argv):
    out = io.StringIO()
    rc = fn(argv, out=out)
    return rc, out.getvalue()


@pytest.mark.parametrize("extra", [[], ["--warmup"]], ids=["cold", "warmup"])
@pytest.mark.parametrize("fmt", ["csr", "coo", "ell", "hybrid", "dia",
                                 "well", "wellcw", "bsr"])
def test_cli_profile_0_equals_jax_cli(fmt, extra, matrix_file):
    argv = ["--matrix", matrix_file, "-s", fmt, "--profile", "0",
            "--trace-config", os.path.join(REPO, "configs", CONFIGS[0])]
    rc, text = _run(main, argv + extra)
    jrc, jtext = _run(jax_main, argv + extra)
    assert rc == jrc == 0
    assert json.loads(text) == json.loads(jtext)


def test_cli_triad_simulation_equals_jax_cli():
    argv = ["--triad", "5000", "--trace-config",
            os.path.join(REPO, "configs", CONFIGS[0])]
    rc, text = _run(main, argv)
    jrc, jtext = _run(jax_main, argv)
    assert rc == jrc == 0 and json.loads(text) == json.loads(jtext)


def test_cli_xla_csr_simulation_exits_1(matrix_file, capsys):
    argv = ["--matrix", matrix_file, "-s", "xla-csr", "--trace-config",
            os.path.join(REPO, "configs", CONFIGS[0])]
    rc, text = _run(main, argv)
    err = capsys.readouterr().err
    assert rc == 1 and text == ""
    assert "not implemented for the library kernel 'xla-csr'" in err


def test_cli_verbose_progress_goes_to_stderr(matrix_file, capsys):
    """``-v`` with ``--progress-interval`` prints the replay's progress
    and the tracing lines to stderr, as the JAX CLI does; stdout keeps
    the document."""
    argv = ["--matrix", matrix_file, "-s", "csr", "--trace-config",
            os.path.join(REPO, "configs", CONFIGS[0]), "-v",
            "--progress-interval", "1e-9"]
    rc, text = _run(main, argv)
    err = capsys.readouterr().err
    assert rc == 0 and json.loads(text)["cache_misses"]
    assert "Tracing memory accesses of kernel csr" in err


def test_cli_without_trace_config_exits_as_jax_cli(matrix_file, capsys):
    rc, text = _run(main, ["--matrix", matrix_file, "-s", "csr"])
    err = capsys.readouterr().err
    jrc, _ = _run(jax_main, ["--matrix", matrix_file, "-s", "csr"])
    jerr = capsys.readouterr().err
    assert rc == jrc == 1 and text == ""
    assert err == jerr.replace("spmv-tpu:", "spmv-tpu-torch:")
    assert "simulation mode requires --trace-config" in err
