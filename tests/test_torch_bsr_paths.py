"""K7's two paths and the port's unpadded BSR container, on the CPU.

- ``DeviceBsr.from_host(..., blocks_per_step=1)`` stores exactly the
  host's blocks (no zero padding), its ``row_ptr`` is the host's
  ``block_rowptr``, and its plain product equals JAX ``bsr_spmm`` on the
  JAX container at its default ``blocks_per_step`` 8, in Pallas interpret
  mode and through XLA ``spmm``, to rtol 1e-12 in float64 (the sums
  differ in order only).
- The stated deviation: the JAX container's padding blocks point at
  column block 0, so an inf there gives NaN (0 * inf) in every padded
  block row; the port's unpadded container gives the host's product.
- ``make_kernel("bsr")`` builds its chained steps on the unpadded
  container, and they match the JAX kernel's.
- ``bsr_path``, the pure function that picks K7's path from the shape:
  its table.

The JAX inputs are made with numpy from fixed seeds and handed to both
packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spmv_tpu.io import generate as jgen
from spmv_tpu.io.matrix_market import MatrixMarket as JaxMatrixMarket
from spmv_tpu.kernels import BsrKernel as JaxBsrKernel
from spmv_tpu.models import BsrMatrix as JaxBsrMatrix
from spmv_tpu.models import device as jdev
from spmv_tpu.ops import spmm as jspmm
from spmv_tpu.ops.pallas_kernels import bsr_spmm as jbsr_spmm
from spmv_tpu_torch.io import generate as pgen
from spmv_tpu_torch.io.matrix_market import MatrixMarket
from spmv_tpu_torch.kernels import make_kernel
from spmv_tpu_torch.models import BsrMatrix, DeviceBsr
from spmv_tpu_torch.ops import bsr_path, bsr_spmm, bsr_spmm_reference


def _blocks(mod, nbr, ncb, per_row, seed):
    # dense-ish 128 x 128 blocks, as tests/test_bsr.py:16-37
    rng = np.random.default_rng(seed)
    rows, cols = [], []
    for bi in range(nbr):
        for bj in rng.choice(ncb, size=min(per_row, ncb), replace=False):
            rows.append(bi * 128 + rng.integers(0, 128, 4096))
            cols.append(bj * 128 + rng.integers(0, 128, 4096))
    key = np.unique(np.concatenate(rows) * (ncb * 128) + np.concatenate(cols))
    rows, cols = key // (ncb * 128), key % (ncb * 128)
    return mod("matrix", "coordinate", "real", "general", nbr * 128,
               ncb * 128, rows.size, rows + 1, cols + 1,
               rng.standard_normal(rows.size))


def _ragged(mod):
    # a 300 x 200 shape: the last block row and column are partial
    return (pgen if mod is MatrixMarket else jgen).random_sparse(
        300, 200, 4, seed=3)


def _empty_block_row(mod):
    # rows 128..255 empty: the host gives that block row an inert block
    return mod("matrix", "coordinate", "real", "general", 384, 384, 2,
               np.array([1, 384]), np.array([1, 384]), np.array([2.0, 3.0]))


# name -> (matrix maker (given the MatrixMarket class), block_rows)
CASES = {
    "blocks_3x4": (lambda mod: _blocks(mod, 3, 4, 2, 1), 128),
    "blocks_5x5": (lambda mod: _blocks(mod, 5, 5, 3, 2), 128),
    "blocks_bh_64": (lambda mod: _blocks(mod, 3, 4, 3, 3), 64),
    "bh_auto": (lambda mod: _blocks(mod, 2, 3, 2, 4), "auto"),
    "ragged_300x200": (_ragged, 128),
    "empty_block_row": (_empty_block_row, 128),
}


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


def _hosts(name):
    make, bh = CASES[name]
    return (BsrMatrix.from_matrix_market(make(MatrixMarket), block_rows=bh),
            JaxBsrMatrix.from_matrix_market(make(JaxMatrixMarket),
                                            block_rows=bh))


def _close(got, want, rtol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32,
                                   torch.bfloat16], ids=str)
@pytest.mark.parametrize("name", list(CASES))
def test_unpadded_container_stores_the_host_blocks(name, dtype):
    b, _ = _hosts(name)
    A = DeviceBsr.from_host(b, dtype=dtype, blocks_per_step=1, device="cpu")
    assert A.blocks_per_step == 1 and A.num_blocks == b.num_blocks
    assert A.blocks.dtype == dtype
    assert torch.equal(A.blocks, torch.from_numpy(b.blocks).to(dtype))
    np.testing.assert_array_equal(A.block_col.numpy(), b.block_col)
    np.testing.assert_array_equal(A.row_ptr.numpy(), b.block_rowptr)
    # each block is its own step: block_row names every block's row
    np.testing.assert_array_equal(
        A.block_row.numpy(),
        np.repeat(np.arange(b.num_block_rows), np.diff(b.block_rowptr)))


@pytest.mark.parametrize("name", list(CASES))
def test_unpadded_plain_matches_jax_padded(name):
    """The port's plain product on its unpadded container against JAX
    ``bsr_spmm`` (Pallas interpret) and XLA ``spmm`` on the JAX container
    padded to blocks_per_step 8, and the fp64 host product: rtol 1e-12."""
    b, bj = _hosts(name)
    A = DeviceBsr.from_host(b, dtype=torch.float64, blocks_per_step=1,
                            device="cpu")
    Aj = jdev.DeviceBsr.from_host(bj, dtype=jnp.float64)
    assert Aj.blocks_per_step == 8
    X = np.random.default_rng(5).standard_normal((A.num_columns, 3))
    got = bsr_spmm(A, torch.from_numpy(X))
    _close(got, jbsr_spmm(Aj, jnp.asarray(X), interpret=True), 1e-12)
    _close(got, jspmm(Aj, jnp.asarray(X)), 1e-12)
    _close(got, b.spmm(X), 1e-12)


def _inf_case(mod):
    """Blocks (0, 1) and (1, 1) of a 256 x 256 matrix: no block of it
    reads column block 0, where X will hold an inf."""
    rng = np.random.default_rng(7)
    r, c = np.meshgrid(np.arange(256), 128 + np.arange(128), indexing="ij")
    r, c = r.ravel(), c.ravel()
    return mod("matrix", "coordinate", "real", "general", 256, 256, r.size,
               r + 1, c + 1, rng.standard_normal(r.size))


def test_zero_times_inf_deviation():
    """Stated deviation (ROADMAP.md, Queue 3): the JAX container pads each
    block row with zero blocks whose block column is 0; with inf in X's
    column block 0, 0 * inf gives NaN in every padded block row, in
    Pallas interpret mode and through XLA.  The port stores no padding
    and gives the host's (finite) product; the same padded container
    gives NaN in the port's plain version too."""
    b = BsrMatrix.from_matrix_market(_inf_case(MatrixMarket))
    bj = JaxBsrMatrix.from_matrix_market(_inf_case(JaxMatrixMarket))
    X = np.random.default_rng(8).standard_normal((256, 2))
    X[0, :] = np.inf
    want = b.spmm(X)
    assert np.isfinite(want).all()
    Aj = jdev.DeviceBsr.from_host(bj, dtype=jnp.float64)
    for jax_y in (jbsr_spmm(Aj, jnp.asarray(X), interpret=True),
                  jspmm(Aj, jnp.asarray(X))):
        assert np.isnan(np.asarray(jax_y)).all()
    A = DeviceBsr.from_host(b, dtype=torch.float64, blocks_per_step=1,
                            device="cpu")
    got = bsr_spmm(A, torch.from_numpy(X))
    assert torch.isfinite(got).all()
    _close(got, want, 1e-12)
    padded = DeviceBsr.from_host(b, dtype=torch.float64, blocks_per_step=8,
                                 device="cpu")
    assert torch.isnan(bsr_spmm_reference(padded, torch.from_numpy(X))).all()
    # the kernel's own entry point builds the unpadded container
    k = make_kernel("bsr", mm=_inf_case(MatrixMarket), device="cpu",
                    dtype=torch.float64)
    k.init()
    _, args = k.spmm_fn(2)
    assert torch.isfinite(bsr_spmm(args[1], torch.from_numpy(X))).all()


@pytest.mark.parametrize("name", ["blocks_3x4", "blocks_bh_64",
                                  "ragged_300x200", "empty_block_row"])
def test_make_kernel_steps_are_unpadded_and_match_jax(name):
    """``make_kernel("bsr")``'s SpMV and SpMM steps run on a container
    with exactly the host's blocks; two chained SpMV steps match the JAX
    kernel's (blocks_per_step 8) to rtol 1e-12, and an SpMM step matches
    JAX ``spmm`` on its container."""
    make, bh = CASES[name]
    k = make_kernel("bsr", mm=make(MatrixMarket), device="cpu",
                    dtype=torch.float64, block_rows=bh)
    k.init()
    jk = JaxBsrKernel(mm=make(JaxMatrixMarket), block_rows=bh)
    jk.init()
    step, (v, A) = k.run_fn()
    jstep, (jv, Aj) = jk.run_fn()
    assert A.blocks_per_step == 1 and A.num_blocks == k.matrix.num_blocks
    assert Aj.blocks_per_step == 8 and Aj.num_blocks >= A.num_blocks
    for _ in range(2):
        v, jv = step(v, A), jstep(jv, Aj)
        _close(v, jv, 1e-12)
    sstep, (V, As) = k.spmm_fn(3)
    assert As.blocks_per_step == 1 and As.num_blocks == k.matrix.num_blocks
    V = torch.from_numpy(np.random.default_rng(9).standard_normal(
        tuple(V.shape)))
    Y = sstep(V, As)
    # the step chains A V back into V's shape: the rows both have
    want = np.asarray(jspmm(Aj, jnp.asarray(V.numpy())))
    n = min(Y.shape[0], want.shape[0])
    _close(Y[:n], want[:n], 1e-12)


ALIGNED, OFF = 4096, 4098      # a 16-byte boundary, and 2 bytes past one

# (dtype, block_rows, k, addresses) -> path
PATH_TABLE = [
    (torch.bfloat16, 128, 128, (ALIGNED, ALIGNED), "tensor_core"),
    (torch.bfloat16, 64, 8, (ALIGNED, ALIGNED), "tensor_core"),
    (torch.bfloat16, 128, 136, (ALIGNED,), "tensor_core"),
    (torch.bfloat16, 64, 256, (), "tensor_core"),
    (torch.bfloat16, 128, 1, (ALIGNED,), "simt"),       # the SpMV
    (torch.bfloat16, 128, 12, (ALIGNED,), "simt"),      # k % 8 != 0
    (torch.bfloat16, 32, 128, (ALIGNED,), "simt"),      # bh < 64
    (torch.bfloat16, 96, 128, (ALIGNED,), "simt"),      # not 64 or 128
    (torch.bfloat16, 8, 128, (ALIGNED,), "simt"),
    (torch.bfloat16, 128, 128, (OFF, ALIGNED), "simt"),  # X off 16 B
    (torch.bfloat16, 128, 128, (ALIGNED, OFF), "simt"),  # Y off 16 B
    (torch.float32, 128, 128, (ALIGNED, ALIGNED), "simt"),
    (torch.float32, 64, 8, (ALIGNED,), "simt"),
    (torch.float64, 128, 128, (ALIGNED,), "simt"),
]


@pytest.mark.parametrize("dtype,bh,k,ptrs,path", PATH_TABLE)
def test_bsr_path_table(dtype, bh, k, ptrs, path):
    assert bsr_path(dtype, bh, k, *ptrs) == path
