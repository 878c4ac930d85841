"""The port's BSR path (``DeviceBsr``, kernel K7's plain version,
``BsrKernel``, ``-s bsr`` and ``-s auto``) against the JAX package.

Inputs come from numpy with fixed seeds, on the cases of
tests/test_bsr.py (dense-ish 128 x 128 blocks, blocks_per_step 1, 3 and
5, block heights 8, 32 and 128, an empty block row, a 300 x 200 shape,
poisson2d(16, 16)), and go through both packages:

- every array of the port's ``DeviceBsr`` equals the JAX container's bit
  for bit, bfloat16 blocks included, and ``bsr_from_spmv_tpu`` carries
  the JAX container across unchanged;
- the port's plain SpMM (what its wrapper runs for CPU tensors) against
  JAX's XLA ``spmm`` and ``bsr_spmm`` in Pallas interpret mode: rtol
  1e-12 in float64 (the sums differ in order: the Pallas kernels
  tree-sum a step's blocks); float32 blocks 1e-4 of the output's scale
  against the fp64 host product, as tests/test_bsr.py; bfloat16 blocks
  give a float32 result within that test's 3e-2 of scale of the host
  product, and within 1e-5 of scale of ``bsr_spmm``'s (both multiply
  the same bfloat16 values and sum in float32);
- ``make_kernel("bsr")`` and the CLI's ``-s bsr`` / ``-s auto`` modes
  against the JAX kernel and CLI: byte counts, report keys, kernel
  description and CG iteration counts.
"""

import functools
import io
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spmv_tpu.cli import main as jax_main
from spmv_tpu.io import generate as jgen
from spmv_tpu.io.matrix_market import MatrixMarket as JaxMatrixMarket
from spmv_tpu.kernels import BsrKernel as JaxBsrKernel
from spmv_tpu.models import BsrMatrix as JaxBsrMatrix
from spmv_tpu.models import device as jdev
from spmv_tpu.ops import spmm as jspmm
from spmv_tpu.ops import spmv as jspmv
from spmv_tpu.ops.pallas_kernels import bsr_spmm as jbsr_spmm
from spmv_tpu_torch.cli import main
from spmv_tpu_torch.errors import KernelError, MatrixError
from spmv_tpu_torch.io import generate as pgen
from spmv_tpu_torch.io.matrix_market import MatrixMarket
from spmv_tpu_torch.kernels import make_kernel
from spmv_tpu_torch.models import BsrMatrix, DeviceBsr, bsr_from_spmv_tpu
from spmv_tpu_torch.ops import (
    bsr_spmm,
    bsr_spmm_core,
    bsr_spmm_reference,
    bsr_spmv,
    spmm,
    spmv,
)


def _block_structured(mod, nbr, ncb, blocks_per_row, seed):
    # tests/test_bsr.py:16-37: dense-ish 128 x 128 blocks
    rng = np.random.default_rng(seed)
    rows, cols = [], []
    for bi in range(nbr):
        for bj in rng.choice(ncb, size=min(blocks_per_row, ncb),
                             replace=False):
            rows.append(bi * 128 + rng.integers(0, 128, 8192))
            cols.append(bj * 128 + rng.integers(0, 128, 8192))
    rows, cols = np.concatenate(rows), np.concatenate(cols)
    key = np.unique(rows * (ncb * 128) + cols)
    rows, cols = key // (ncb * 128), key % (ncb * 128)
    return mod("matrix", "coordinate", "real", "general", nbr * 128,
               ncb * 128, rows.size, rows + 1, cols + 1,
               rng.standard_normal(rows.size))


def _blocklets(mod, bh, n=1024):
    # tests/test_bsr.py:172-191: dense 8 x 128 blocklets at random
    rng = np.random.default_rng(bh)
    base = pgen.random_sparse(n // 8, n // 128, 2, seed=bh)
    rows = np.repeat((base.rows_1based - 1) * 8, 8 * 128) \
        + np.tile(np.repeat(np.arange(8), 128), base.num_entries)
    cols = np.repeat((base.cols_1based - 1) * 128, 8 * 128) \
        + np.tile(np.arange(128), 8 * base.num_entries)
    return mod("matrix", "coordinate", "real", "general", n, n, rows.size,
               rows + 1, cols + 1, rng.standard_normal(rows.size))


def _empty_block_row(mod):
    # tests/test_bsr.py:65-77: rows 128..255 empty
    return mod("matrix", "coordinate", "real", "general", 384, 384, 2,
               np.array([1, 384]), np.array([1, 384]), np.array([2.0, 3.0]))


def _gen(fn, *args, **kw):
    def make(mod):
        return getattr(pgen if mod is MatrixMarket else jgen, fn)(
            *args, **kw)
    return make


# name -> (matrix maker (given the MatrixMarket class), block_rows,
#          blocks_per_step)
CASES = {
    "blocks": (lambda mod: _block_structured(mod, 3, 4, 2, 1), 128, 8),
    "kb_1": (lambda mod: _block_structured(mod, 3, 4, 3, 11), 128, 1),
    "kb_3": (lambda mod: _block_structured(mod, 3, 4, 3, 11), 128, 3),
    "kb_5": (lambda mod: _block_structured(mod, 3, 4, 3, 11), 128, 5),
    "bh_8": (lambda mod: _blocklets(mod, 8), 8, 8),
    "bh_32": (lambda mod: _blocklets(mod, 32), 32, 8),
    "bh_128": (lambda mod: _blocklets(mod, 128), 128, 8),
    "bh_auto": (lambda mod: _blocklets(mod, 8), "auto", 8),
    "empty_block_row": (_empty_block_row, 128, 8),
    "rect_300x200": (_gen("random_sparse", 300, 200, 4, seed=3), 128, 8),
    "poisson16": (_gen("poisson2d", 16, 16), 128, 8),
}
INTERPRET_CASES = ("blocks", "kb_3", "kb_5", "bh_8", "bh_32",
                   "empty_block_row", "rect_300x200", "poisson16")
DTYPES = {torch.float64: jnp.float64, torch.float32: jnp.float32,
          torch.bfloat16: jnp.bfloat16}


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
    make, bh, _ = CASES[name]
    cls = JaxBsrMatrix if jax else BsrMatrix
    return cls.from_matrix_market(
        make(JaxMatrixMarket if jax else MatrixMarket), block_rows=bh)


def _both(name, dtype=torch.float64):
    kb = CASES[name][2]
    Aj = jdev.DeviceBsr.from_host(_host(name, jax=True),
                                  dtype=DTYPES[dtype], blocks_per_step=kb)
    At = DeviceBsr.from_host(_host(name), dtype=dtype, blocks_per_step=kb,
                             device="cpu")
    return _host(name), Aj, At


def _X(n, k, seed=4):
    return np.random.default_rng(seed).standard_normal((n, k))


def _close(got, want, rtol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


def _scaled_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1.0))


def _same_container(At, Aj):
    for f in ("num_rows", "num_columns", "num_entries", "num_blocks",
              "num_block_rows", "num_block_cols", "blocks_per_step",
              "block_rows"):
        assert getattr(At, f) == getattr(Aj, f), f
    blocks = np.asarray(Aj.blocks)
    assert str(At.blocks.dtype).replace("torch.", "") == blocks.dtype.name
    np.testing.assert_array_equal(At.blocks.float().numpy(),
                                  blocks.astype(np.float32))
    if At.blocks.dtype != torch.bfloat16:
        np.testing.assert_array_equal(At.blocks.numpy(), blocks)
    for f in ("block_col", "block_row"):
        t, a = getattr(At, f), np.asarray(getattr(Aj, f))
        assert t.dtype == torch.int32 and a.dtype == np.int32
        np.testing.assert_array_equal(t.numpy(), a)


@pytest.mark.parametrize("dtype", list(DTYPES), ids=str)
@pytest.mark.parametrize("name", list(CASES))
def test_arrays_match_jax_container(name, dtype):
    _, Aj, At = _both(name, dtype)
    _same_container(At, Aj)
    # the converter from the JAX container gives the very same arrays
    _same_container(bsr_from_spmv_tpu(Aj), Aj)


@pytest.mark.parametrize("name", list(CASES))
def test_row_pointers_cover_every_block(name):
    """Block row r's blocks are [row_ptr[r], row_ptr[r + 1]): every step
    of them has block row r, and every block row has at least one
    block (the host gives an empty one an inert block)."""
    _, _, At = _both(name)
    ptr, kb = At.row_ptr, At.blocks_per_step
    assert ptr.dtype == torch.int32 and ptr.numel() == At.num_block_rows + 1
    assert int(ptr[0]) == 0 and int(ptr[-1]) == At.num_blocks
    for r in range(At.num_block_rows):
        lo, hi = int(ptr[r]), int(ptr[r + 1])
        assert hi > lo and lo % kb == 0 and hi % kb == 0
        assert bool((At.block_row[lo // kb:hi // kb] == r).all())


@pytest.mark.parametrize("k", [1, 3, 8])
@pytest.mark.parametrize("name", list(CASES))
def test_plain_matches_jax_xla(name, k):
    b, Aj, At = _both(name)
    X = _X(At.num_columns, k)
    before = bsr_spmm_core.launches
    got = bsr_spmm(At, torch.from_numpy(X))
    assert got.dtype == torch.float64 and got.shape == (At.num_rows, k)
    _close(got, np.asarray(jspmm(Aj, jnp.asarray(X))), 1e-12)
    _close(got, b.spmm(X), 1e-12)
    assert bsr_spmm_core.launches == before     # CPU: the plain version
    if k == 1:
        x = X[:, 0]
        _close(bsr_spmv(At, torch.from_numpy(x)),
               np.asarray(jspmv(Aj, jnp.asarray(x))), 1e-12)


@pytest.mark.parametrize("name", INTERPRET_CASES)
def test_plain_matches_pallas_interpret(name):
    _, Aj, At = _both(name)
    X = _X(At.num_columns, 3, seed=5)
    got = bsr_spmm(At, torch.from_numpy(X))
    _close(got, jbsr_spmm(Aj, jnp.asarray(X), interpret=True), 1e-12)


@pytest.mark.parametrize("name", ["blocks", "kb_3", "bh_8", "bh_32",
                                  "rect_300x200"])
def test_float32_blocks_match_fp64_host(name):
    b, Aj, At = _both(name, torch.float32)
    X = _X(At.num_columns, 4, seed=9).astype(np.float32)
    got = bsr_spmm(At, torch.from_numpy(X))
    assert got.dtype == torch.float32
    want = b.spmm(X.astype(np.float64))
    assert _scaled_err(got, want) <= 1e-4
    assert _scaled_err(got, jbsr_spmm(Aj, jnp.asarray(X),
                                      interpret=True)) <= 1e-4


@pytest.mark.parametrize("name", ["blocks", "kb_5", "bh_8",
                                  "empty_block_row"])
def test_bfloat16_blocks_accumulate_in_float32(name):
    """bf16 blocks round X to bf16, accumulate in float32 and return
    float32, as ``bsr_spmm`` does (tests/test_bsr.py:127-143)."""
    b, Aj, At = _both(name, torch.bfloat16)
    X = _X(At.num_columns, 4, seed=9).astype(np.float32)
    got = bsr_spmm(At, torch.from_numpy(X))
    assert got.dtype == torch.float32
    want = jbsr_spmm(Aj, jnp.asarray(X), interpret=True)
    assert want.dtype == jnp.float32
    assert _scaled_err(got, b.spmm(X.astype(np.float64))) <= 3e-2
    assert _scaled_err(got, want) <= 1e-5
    # the plain version rounds X to bf16 first: a float64 X gives the
    # same product as its float32 copy
    assert torch.equal(got, bsr_spmm_reference(
        At, torch.from_numpy(X.astype(np.float64))))


def test_empty_block_row_reads_zero():
    _, _, At = _both("empty_block_row")
    y = spmv(At, torch.ones(384))
    assert float(y[0]) == 2.0 and float(y[383]) == 3.0
    assert bool((y[128:256] == 0).all())


@pytest.mark.parametrize("dtype", [torch.float16, torch.int32], ids=str)
def test_narrow_or_integer_blocks_refused(dtype):
    with pytest.raises(MatrixError, match="float32, float64 or bfloat16"):
        DeviceBsr.from_host(_host("blocks"), dtype=dtype)


@pytest.mark.parametrize("what", ["dtype", "shape", "strided", "one_dim",
                                  "out_dtype", "out_aliases_x",
                                  "meta_device"])
def test_wrapper_rejects_bad_inputs(what):
    """Checks run before anything else; a device that is neither the
    CPU nor CUDA raises instead of falling back."""
    _, _, At = _both("rect_300x200")
    n, m = At.num_rows, At.num_columns
    X = torch.ones(m, 3)
    args = {
        "dtype": dict(X=torch.ones(m, 3, dtype=torch.float32)),
        "shape": dict(X=torch.ones(m + 1, 3)),
        "strided": dict(X=torch.ones(m, 6)[:, ::2]),
        "one_dim": dict(X=torch.ones(m)),
        "out_dtype": dict(X=X, out=torch.empty(n, 3, dtype=torch.float32)),
        "out_aliases_x": dict(X=X, out=X[: min(n, m)]),
        "meta_device": dict(X=torch.ones(m, 3, device="meta")),
    }[what]
    if what == "meta_device":
        At = At.to("meta")
    with pytest.raises(KernelError):
        bsr_spmm_core(At, args["X"], out=args.get("out"))


def test_dispatch_and_forward():
    b, _, At = _both("rect_300x200")
    X32 = torch.from_numpy(_X(At.num_columns, 2)).float()
    _close(spmm(At, X32), b.spmm(X32.double().numpy()), 1e-12)
    x = X32[:, 0].double().contiguous()
    _close(At(x), b.spmv(x.numpy()), 1e-12)
    _close(spmv(At, x), b.spmv(x.numpy()), 1e-12)


@pytest.mark.parametrize("dtype", [torch.float64, torch.bfloat16], ids=str)
@pytest.mark.parametrize("name", ["blocks", "rect_300x200"])
def test_make_kernel_steps_chain(name, dtype):
    """``run_fn`` and ``spmm_fn(k)`` chain the product back into the
    input like the JAX kernel's step; with bf16 blocks the chained
    vectors stay float32 (each step rounds its input to bf16)."""
    mm = CASES[name][0](MatrixMarket)
    k = make_kernel("bsr", mm=mm, device="cpu", dtype=dtype)
    k.init()
    b = k.matrix
    assert b.block_rows == BsrMatrix.choose_block_rows(
        mm.rows_1based - 1, mm.cols_1based - 1, mm.num_columns)
    for cols in (None, 3):
        step, args = k.run_fn() if cols is None else k.spmm_fn(cols)
        V = args[0]
        assert V.dtype == (torch.float32 if dtype == torch.bfloat16
                           else dtype)
        want = V.double().numpy()
        for _ in range(2):
            nxt = step(V, *args[1:])
            assert nxt.data_ptr() != V.data_ptr() and nxt.dtype == V.dtype
            V = nxt
            Y = b @ want
            want = Y[: b.num_columns] if Y.shape[0] >= b.num_columns else \
                np.concatenate([Y, want[Y.shape[0]:]])
        tol = 3e-2 if dtype == torch.bfloat16 else 1e-12
        assert _scaled_err(V, want) <= tol


@pytest.mark.parametrize("name", ["blocks", "rect_300x200"])
def test_bytes_and_describe_match_jax_kernel_at_x64(name):
    jk = JaxBsrKernel(mm=CASES[name][0](JaxMatrixMarket))
    jk.init()
    for dtype, vb in ((torch.float64, 8), (torch.float32, 4)):
        k = make_kernel("bsr", mm=CASES[name][0](MatrixMarket),
                        device="cpu", dtype=dtype)
        k.init()
        assert k.value_bytes == vb
        if dtype == torch.float64:
            assert k.bytes_per_run() == jk.bytes_per_run()
            assert k.traffic_split() == jk.traffic_split()
        assert k.flops_per_run() == jk.flops_per_run()
        assert k.describe() == jk.describe()


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    from spmv_tpu_torch.io import write_matrix_market

    d = tmp_path_factory.mktemp("bsr")
    paths = {"poisson": str(d / "poisson16.mtx"),
             "blocks": str(d / "blocks512.mtx"),
             "spd_band": str(d / "spd_band.mtx")}
    write_matrix_market(pgen.poisson2d(16, 16), paths["poisson"])
    write_matrix_market(pgen.block_random(512, 512, 2, seed=2),
                        paths["blocks"])
    # a symmetric, diagonally dominant band too wide for DIA: -s auto
    # picks WELL-CW for it
    rng = np.random.default_rng(3)
    n = 256
    r = np.repeat(np.arange(n), 6)
    c = np.clip(r + rng.integers(-40, 41, r.size), 0, n - 1)
    key = np.unique(np.concatenate([r * n + c, c * n + r]))
    r, c = key // n, key % n
    off = r != c
    r, c = r[off], c[off]
    v = np.abs(rng.standard_normal(r.size))
    v = (v + v[np.lexsort((r, c))]) / 2          # symmetric values
    diag = np.bincount(r, weights=np.abs(v), minlength=n) + 1.0
    write_matrix_market(pgen.from_coo_arrays(
        n, n, np.concatenate([r, np.arange(n)]),
        np.concatenate([c, np.arange(n)]), np.concatenate([-v, diag])),
        paths["spd_band"])
    return paths


def _run(fn, argv):
    out = io.StringIO()
    rc = fn(argv, out=out)
    return rc, out.getvalue()


CLI_MODES = {
    "bsr_profile": ("poisson", ["-s", "bsr", "--profile", "2"]),
    "bsr_spmm": ("poisson", ["-s", "bsr", "--profile", "2", "--spmm", "3"]),
    "bsr_cg": ("poisson", ["-s", "bsr", "--cg", "300", "--cg-tol", "1e-10"]),
    "bsr_cg_nrhs": ("poisson", ["-s", "bsr", "--cg", "300", "--cg-tol",
                                "1e-10", "--nrhs", "3"]),
    "auto_spmm_picks_bsr": ("blocks", ["-s", "auto", "--profile", "2",
                                       "--spmm", "4"]),
    "auto_profile": ("blocks", ["-s", "auto", "--profile", "2"]),
    "auto_cg_picks_dia": ("poisson", ["-s", "auto", "--cg", "300",
                                      "--cg-tol", "1e-10"]),
}


@pytest.mark.parametrize("mode", list(CLI_MODES))
def test_cli_matches_jax_cli(mode, files):
    """The JAX CLI's report keys, kernel description and, for ``--cg``,
    its iteration counts (within one per column for ``--nrhs``)."""
    f, flags = CLI_MODES[mode]
    argv = ["--matrix", files[f]] + flags
    rc, text = _run(main, argv)
    assert rc == 0
    doc = json.loads(text)
    jrc, jtext = _run(jax_main, argv)
    assert jrc == 0
    want = json.loads(jtext)
    assert set(doc) == set(want)
    for sub in ("cg", "achieved", "roofline", "device"):
        if sub in want:
            assert set(doc[sub]) == set(want[sub]), sub
    assert doc["kernel"] == want["kernel"]
    if "auto_spmm" in mode:
        assert doc["kernel"]["matrix_format"] == "bsr"
    if "cg" in doc:
        its, jits = doc["cg"]["iterations"], want["cg"]["iterations"]
        if isinstance(its, list):
            assert max(abs(a - b) for a, b in zip(its, jits)) <= 1
            assert max(doc["cg"]["solution_rms_error_vs_ones"]) < 1e-8
        else:
            assert its == jits > 0
            assert doc["cg"]["solution_rms_error_vs_ones"] < 1e-8
    else:
        assert doc["op"] == want["op"]
        assert doc["device"]["platform"] == "cpu"


@pytest.mark.parametrize("fmt", ["bsr", "auto"])
def test_jacobi_cg_runs_the_dia_iteration(fmt, files):
    """Jacobi PCG on ``-s bsr`` and on ``-s auto`` (here WELL-CW, chosen
    for the SpMV) takes the DIA path's iteration count on the same matrix.
    The JAX CLI cannot: its ``extract_diagonal`` has no branch for the
    BSR, WELL and WELL-CW host formats; the port reads the diagonal from
    the Matrix Market entries the matrix was chosen and converted from."""
    args = ["--matrix", files["spd_band"], "--cg", "300", "--cg-tol",
            "1e-10", "--precondition", "jacobi"]
    docs = {}
    for f in (fmt, "dia"):
        rc, text = _run(main, args + ["--spmv-format", f])
        assert rc == 0
        docs[f] = json.loads(text)
    assert docs[fmt]["cg"]["iterations"] == \
        docs["dia"]["cg"]["iterations"] > 0
    assert docs[fmt]["cg"]["solution_rms_error_vs_ones"] < 1e-8
    if fmt == "auto":
        assert docs[fmt]["kernel"]["matrix_format"] == "wellcw"


def test_auto_refuses_reorder(files, capsys):
    argv = ["--matrix", files["poisson"], "-s", "auto", "--profile", "2",
            "--reorder", "rcm"]
    for fn in (main, jax_main):
        rc, text = _run(fn, argv)
        assert rc == 1 and text == ""
        assert "drop --reorder" in capsys.readouterr().err
