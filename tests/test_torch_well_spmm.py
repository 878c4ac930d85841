"""The port's WELL SpMM (K6a and K6b, the spill folded in) against the JAX
package.

Inputs come from numpy with fixed seeds, on the matrices of
tests/test_torch_well.py (windows 1, 2 and 4; segment_rows 2, 4, 8 and
16; blocks_per_out 2 and 4; the empty-block and spill cases), and go
through both packages:

- the port's plain SpMM (what its wrappers run for CPU tensors) against
  JAX's XLA ``spmm`` on ``DeviceWell`` at k = 1, 3 and 8, and against
  ``well_spmm`` in Pallas interpret mode on one whole-x and one
  segmented matrix (the other interpret cases take longer and are
  marked ``slow``, as the JAX package's own, tests/test_well.py:259-301);
- column j of the plain SpMM against the plain SpMV of X[:, j];
- ``make_kernel("well").spmm_fn``, the CLI's ``--spmm`` and ``--cg
  --nrhs`` on ``-s well`` against the JAX CLI, and the ``--spmm``
  report's bytes: the JAX CLI's less the all-zero slots, which K6 does
  not read (a stated deviation, as for K5's SpMV report).

The plain SpMM (what K6 computes) is ``well_spmv_reference`` on 2-D X:
the live slots, then the spill; for finite X it is JAX's product.

Tolerances: rtol 1e-12 in float64 (the sums differ only in rounding
order); in float32, 1e-5 relative max-norm against the fp64 host
product (one float32 rounding per term and per partial sum).
"""

import functools
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spmv_tpu.cli import main as jax_main
from spmv_tpu.io.matrix_market import MatrixMarket as JaxMatrixMarket
from spmv_tpu.models import WellMatrix as JaxWellMatrix
from spmv_tpu.models import device as jdev
from spmv_tpu.ops import spmm as jspmm
from spmv_tpu.ops.pallas_kernels import well_spmm as jwell_spmm
from spmv_tpu_torch.cli import main
from spmv_tpu_torch.errors import KernelError
from spmv_tpu_torch.io import generate as pgen
from spmv_tpu_torch.io.matrix_market import MatrixMarket
from spmv_tpu_torch.kernels import make_kernel
from spmv_tpu_torch.models import DeviceWell, WellMatrix
from spmv_tpu_torch.ops import (
    csr_spmm_core,
    spmm,
    well_seg_spmm_core,
    well_spmm,
    well_spmm_core,
    well_spmv,
    well_spmv_reference,
    well_whole_spmm_core,
)
from spmv_tpu_torch.ops.well_kernels import well_column_block


def _gen(fn, *args, **kw):
    def make(mod):
        from spmv_tpu.io import generate as jgen

        return getattr(pgen if mod is MatrixMarket else jgen, fn)(
            *args, **kw)
    return make


def _two_clusters(mod):
    # tests/test_well.py:192-199: a near and a far diagonal in one group
    r = np.concatenate([np.arange(128)] * 2)
    c = np.concatenate([np.arange(128), np.arange(128) + 3000])
    return mod("matrix", "coordinate", "real", "general", 128, 4000,
               r.size, r + 1, c + 1, np.ones(r.size))


def _empty_blocks(mod):
    # tests/test_well.py:312-318: two whole 8-group output blocks empty
    r = np.concatenate([np.arange(128), np.arange(2176, 2304)])
    return mod("matrix", "coordinate", "real", "general", 2304, 2304,
               r.size, r + 1, r + 1, np.ones(r.size))


# name -> (matrix maker (given the MatrixMarket class), window_rows,
#          device options), as in tests/test_torch_well.py
CASES = {
    "poisson_w1": (_gen("poisson2d", 30, 40), 1, {}),
    "poisson_w2": (_gen("poisson2d", 30, 40), 2, {}),
    "poisson_w4": (_gen("poisson2d", 30, 40), 4, {}),
    "window_spill": (_gen("random_sparse", 300, 300, 6, seed=4), 1, {}),
    "rectangular": (_gen("random_sparse", 200, 150, 5, seed=6), 2, {}),
    "segment_rows_2": (_two_clusters, 1, {"segment_rows": 2}),
    "segment_rows_8_bpo_4": (_gen("poisson2d", 40, 40), 2,
                             {"segment_rows": 8, "blocks_per_out": 4}),
    "segment_rows_16_banded": (_gen("banded_random", 1024, 48, 6, seed=7),
                               2, {"segment_rows": 16, "blocks_per_out": 2,
                                   "chunks_per_step": 8}),
    "blocks_per_out_2": (_gen("poisson2d", 40, 40), 2,
                         {"blocks_per_out": 2}),
    "empty_blocks": (_empty_blocks, 1, {"segment_rows": 4}),
}
# one whole-x and one segmented case run in tier-1; the rest are slow
INTERPRET_FAST = ("poisson_w2", "segment_rows_8_bpo_4")
INTERPRET_SLOW = ("window_spill", "segment_rows_2", "empty_blocks")
SPMM_LAUNCHES = (well_whole_spmm_core, well_seg_spmm_core, csr_spmm_core)


@pytest.fixture(autouse=True)
def _fp64():
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(old)


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    # the port's entry points run on the card unless asked for the CPU
    monkeypatch.setenv("SPMV_TPU_TORCH_DEVICE", "cpu")


@functools.lru_cache(maxsize=None)
def _host(name, jax=False):
    make, window_rows, _ = CASES[name]
    cls = JaxWellMatrix if jax else WellMatrix
    return cls.from_matrix_market(
        make(JaxMatrixMarket if jax else MatrixMarket),
        window_rows=window_rows)


def _both(name, dtype=torch.float64):
    dev_kw = CASES[name][2]
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    Aj = jdev.DeviceWell.from_host(_host(name, jax=True), dtype=jdt,
                                   **dev_kw)
    At = DeviceWell.from_host(_host(name), dtype=dtype, device="cpu",
                              **dev_kw)
    return _host(name), Aj, At


def _X(n, k, seed=4):
    return np.random.default_rng(seed).standard_normal((n, k))


def _close(got, want, rtol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


def _host_spmm(w, X):
    return np.stack([w.spmv(X[:, j]) for j in range(X.shape[1])], axis=1)


@pytest.mark.parametrize("k", [1, 3, 8])
@pytest.mark.parametrize("name", list(CASES))
def test_plain_matches_jax_xla(name, k):
    w, Aj, At = _both(name)
    X = _X(At.num_columns, k)
    launches = [c.launches for c in SPMM_LAUNCHES]
    got = well_spmm(At, torch.from_numpy(X))
    assert got.shape == (At.num_rows, k)
    _close(got, np.asarray(jspmm(Aj, jnp.asarray(X))), 1e-12)
    _close(got, _host_spmm(w, X), 1e-12)
    # the wrappers' composition is the plain specification, bit for bit
    assert torch.equal(got, well_spmv_reference(At, torch.from_numpy(X)))
    # CPU tensors take the plain versions: no kernel launched
    assert [c.launches for c in SPMM_LAUNCHES] == launches


@pytest.mark.parametrize("name", [
    *INTERPRET_FAST,
    *(pytest.param(n, marks=pytest.mark.slow) for n in INTERPRET_SLOW)])
def test_plain_matches_pallas_interpret(name):
    _, Aj, At = _both(name)
    X = _X(At.num_columns, 3, seed=5)
    got = well_spmm(At, torch.from_numpy(X))
    _close(got, jwell_spmm(Aj, jnp.asarray(X), interpret=True), 1e-12)


@pytest.mark.parametrize("name", ["poisson_w4", "window_spill",
                                  "segment_rows_2", "empty_blocks"])
def test_columns_match_spmv(name):
    _, _, At = _both(name)
    X = torch.from_numpy(_X(At.num_columns, 3, seed=6))
    Y = well_spmm(At, X)
    for j in range(3):
        _close(Y[:, j], well_spmv(At, X[:, j].contiguous()), 1e-12)


@pytest.mark.parametrize("name", ["poisson_w2", "window_spill",
                                  "segment_rows_16_banded", "empty_blocks"])
def test_float32_matches_fp64_host(name):
    w, _, At = _both(name, dtype=torch.float32)
    X = _X(At.num_columns, 8, seed=7).astype(np.float32)
    got = spmm(At, torch.from_numpy(X))
    assert got.dtype == torch.float32
    want = _host_spmm(w, X.astype(np.float64))
    err = np.abs(got.double().numpy() - want).max() / np.abs(want).max()
    assert err <= 1e-5, err


def test_out_buffer_and_mode_checks():
    _, _, At = _both("window_spill")
    _, _, As = _both("segment_rows_2")
    X = torch.from_numpy(_X(At.num_columns, 2))
    out = torch.empty(At.num_rows, 2)
    assert well_spmm_core(At, X, out=out) is out
    _close(out, well_spmv_reference(At, X), 1e-12)
    with pytest.raises(KernelError, match="whole-x"):
        well_seg_spmm_core(At, X)
    with pytest.raises(KernelError, match="segmented"):
        well_whole_spmm_core(As, torch.from_numpy(_X(As.num_columns, 2)))


@pytest.mark.parametrize("what", ["dtype", "shape", "strided", "one_dim",
                                  "out_aliases_x", "out_shape",
                                  "meta_device"])
def test_wrapper_rejects_bad_inputs(what):
    """Checks run before anything else; a device that is neither the
    CPU nor CUDA raises instead of falling back."""
    _, _, At = _both("rectangular")
    n, m = At.num_rows, At.num_columns
    X = torch.ones(m, 3)
    args = {
        "dtype": dict(X=torch.ones(m, 3, dtype=torch.float32)),
        "shape": dict(X=torch.ones(m + 1, 3)),
        "strided": dict(X=torch.ones(m, 6)[:, ::2]),
        "one_dim": dict(X=torch.ones(m)),
        "out_aliases_x": dict(X=X, out=X[:n]),
        "out_shape": dict(X=X, out=torch.empty(n, 4)),
        "meta_device": dict(X=torch.ones(m, 3, device="meta")),
    }[what]
    if what == "meta_device":
        At = At.to("meta")
    with pytest.raises(KernelError):
        well_spmm_core(At, args["X"], out=args.get("out"))


@pytest.mark.parametrize("k, want", [
    (1, 1), (3, 3),                # never wider than k
    (8, 8), (9, 8), (17, 8),       # a thread's register block: 8 columns
])
def test_column_block_by_budget(k, want):
    """K6 keeps no shared tile: a block is as wide as a thread's 8
    registers of column sums, whatever the dtype and the output block."""
    assert well_column_block(k) == want


def test_column_block_refuses_a_tile_past_shared_memory():
    """The container's output block must fit K5's shared tile; the SpMM
    wrapper refuses the same containers, before any plain version."""
    A = DeviceWell.from_host(_host("poisson_w2"), dtype=torch.float64,
                             blocks_per_out=32, device="cpu")
    assert A.out_rows * 128 * 8 > 232448
    with pytest.raises(KernelError, match="shared memory"):
        well_spmm_core(A, torch.ones(A.num_columns, 2))


@pytest.mark.parametrize("name", ["poisson_w2", "rectangular",
                                  "segment_rows_8_bpo_4"])
def test_make_kernel_spmm_fn_chains(name):
    """``make_kernel("well").spmm_fn(k)`` chains Y back into X (two
    buffers in turn on a square matrix) like the JAX kernel's step."""
    mm = CASES[name][0](MatrixMarket)
    k = make_kernel("well", mm=mm, device="cpu", dtype=torch.float64,
                    window_rows=CASES[name][1])
    k.init()
    w = k.matrix
    step, args = k.spmm_fn(3)
    V, want = args[0], np.ones((w.num_columns, 3))
    assert V.shape == (w.num_columns, 3)
    for _ in range(3):
        nxt = step(V, *args[1:])
        assert nxt.data_ptr() != V.data_ptr()
        V = nxt
        Y = _host_spmm(w, want)
        want = Y[: w.num_columns] if Y.shape[0] >= w.num_columns else \
            np.concatenate([Y, want[Y.shape[0]:]])
    _close(V, want, 1e-12)
    with pytest.raises(KernelError, match="positive"):
        k.spmm_fn(0)


def test_dispatch_and_forward():
    """``spmm`` on ``DeviceWell`` casts X to the value dtype and runs the
    chunks and the spill; ``forward`` stays the SpMV."""
    w, _, At = _both("window_spill")
    X32 = torch.from_numpy(_X(At.num_columns, 2)).float()
    _close(spmm(At, X32), _host_spmm(w, X32.double().numpy()), 1e-12)
    x = X32[:, 0].double().contiguous()
    _close(At(x), w.spmv(x.numpy()), 1e-12)


@pytest.fixture(scope="module")
def poisson_file(tmp_path_factory):
    from spmv_tpu_torch.io import write_matrix_market

    p = tmp_path_factory.mktemp("well_spmm") / "poisson16.mtx"
    write_matrix_market(pgen.poisson2d(16, 16), str(p))
    return str(p)


def _run(fn, argv):
    out = io.StringIO()
    rc = fn(argv, out=out)
    return rc, out.getvalue()


def test_cli_spmm_matches_jax_cli(poisson_file):
    argv = ["--matrix", poisson_file, "--spmv-format", "well",
            "--profile", "2", "--spmm", "3"]
    before = [c.launches for c in SPMM_LAUNCHES]
    rc, text = _run(main, argv)
    assert rc == 0
    assert [c.launches for c in SPMM_LAUNCHES] == before  # CPU: plain only
    doc = json.loads(text)
    jrc, jtext = _run(jax_main, argv)
    assert jrc == 0
    want = json.loads(jtext)
    assert set(doc) == set(want)
    for sub in ("achieved", "roofline", "device"):
        assert set(doc[sub]) == set(want[sub]), sub
    assert doc["op"] == want["op"] == {"kind": "spmm", "k": 3}
    assert doc["kernel"] == want["kernel"]
    assert doc["device"]["platform"] == "cpu"
    assert doc["achieved"]["gflop_per_s"] > 0


# The --spmm report's matrices: poisson2d(64, 64) under -s well (96 of
# its 256 slots all zero) and a band that -s auto packs as WELL under the
# SpMM workload (24 of 64 slots all zero).
PRICED = {
    "well": (lambda: pgen.poisson2d(64, 64), 96),
    "auto": (lambda: pgen.banded_random(1024, half_bandwidth=32,
                                        nnz_per_row=5, seed=1), 24),
}


@pytest.mark.parametrize("fmt", list(PRICED))
def test_cli_spmm_prices_the_slots_k6_reads(fmt, tmp_path):
    """The float32 ``--spmm 8`` report prices what K6 reads: the JAX
    CLI's bytes less value + index of each all-zero slot, and the
    kernel's SpMM byte count; the flops are the JAX CLI's."""
    from spmv_tpu_torch.io import write_matrix_market

    make, dead = PRICED[fmt]
    path = str(tmp_path / f"{fmt}.mtx")
    write_matrix_market(make(), path)
    argv = ["--matrix", path, "--spmv-format", fmt, "--profile", "2",
            "--spmm", "8"]
    torch.set_default_dtype(torch.float32)   # restored by _fp64
    rc, text = _run(main, argv)
    assert rc == 0
    with jax.enable_x64(False):
        jrc, jtext = _run(jax_main, argv)
    assert jrc == 0
    doc, want = json.loads(text), json.loads(jtext)
    assert doc["kernel"]["name"] == want["kernel"]["name"] == "well"
    got = doc["roofline"]["bytes"]
    assert got == want["roofline"]["bytes"] - dead * 128 * (4 + 4)
    kernel = make_kernel("well", matrix_path=path, device="cpu",
                         dtype=torch.float32)
    kernel.init()
    dead_host = int((np.asarray(kernel.matrix.value) == 0).all(axis=2).sum())
    assert dead_host == dead
    assert got == kernel.spmm_bytes_per_run(8)
    assert doc["roofline"]["flops"] == want["roofline"]["flops"]
    if fmt == "well":
        assert (got, want["roofline"]["bytes"]) == (425984, 524288)
