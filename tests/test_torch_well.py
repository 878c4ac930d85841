"""The port's WELL container, plain SpMV, kernel class and CLI against the
JAX package.

Inputs come from numpy with fixed seeds, on the JAX WELL tests' own
matrices (tests/test_well.py: windows 1, 2 and 4; segment_rows 2, 4, 8
and 16; blocks_per_out 1, 2 and 4; the empty-block, auto-segment and
banded cases), and go through both packages:

- every array of the port's ``DeviceWell`` equals the JAX container's
  bit for bit, and ``well_from_spmv_tpu`` carries the JAX container
  across unchanged;
- the port's plain version (what its wrappers run for CPU tensors) is
  held against JAX's XLA ``spmv`` and against ``well_spmv`` in Pallas
  interpret mode, as the JAX tests run it: rtol 1e-12 in float64 (the
  sums differ only in rounding order); in float32, 1e-5 relative
  max-norm against the fp64 host product (one float32 rounding per term
  and per partial sum);
- the CLI's ``--cg`` on WELL takes the JAX CLI's iteration count, and
  ``--profile`` prints the JAX CLI's report keys.
"""

import functools
import io
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spmv_tpu.cli import main as jax_main
from spmv_tpu.errors import MatrixError as JaxMatrixError
from spmv_tpu.io.matrix_market import MatrixMarket as JaxMatrixMarket
from spmv_tpu.kernels import WellKernel as JaxWellKernel
from spmv_tpu.models import WellMatrix as JaxWellMatrix
from spmv_tpu.models import device as jdev
from spmv_tpu.ops import spmv as jspmv
from spmv_tpu.ops import well_spmv as jwell_spmv
from spmv_tpu_torch.cli import main
from spmv_tpu_torch.errors import KernelError, MatrixError
from spmv_tpu_torch.io import generate as pgen
from spmv_tpu_torch.io.matrix_market import MatrixMarket
from spmv_tpu_torch.kernels import make_kernel
from spmv_tpu_torch.models import DeviceWell, WellMatrix, well_from_spmv_tpu
from spmv_tpu_torch.ops import (
    csr_spmv_core,
    spmm,
    spmv,
    well_chunks_reference,
    well_seg_core,
    well_spmv,
    well_spmv_core,
    well_spmv_reference,
    well_whole_core,
)


def _scattered_band(mod, n, bw, per, seed):
    # tests/test_well.py:163-172: a band of random width with unique
    # entries
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n), per)
    cols = np.clip(rows + rng.integers(-bw, bw + 1, rows.size), 0, n - 1)
    key = np.unique(rows * n + cols)
    r, c = key // n, key % n
    return mod("matrix", "coordinate", "real", "general", n, n, r.size,
               r + 1, c + 1, rng.standard_normal(r.size))


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


def _gen(fn, *args, **kw):
    def make(mod):
        from spmv_tpu.io import generate as jgen

        return getattr(pgen if mod is MatrixMarket else jgen, fn)(
            *args, **kw)
    return make


# name -> (matrix maker (given the MatrixMarket class), window_rows,
#          device options, num_columns override)
CASES = {
    "poisson_w1": (_gen("poisson2d", 30, 40), 1, {}, None),
    "poisson_w2": (_gen("poisson2d", 30, 40), 2, {}, None),
    "poisson_w4": (_gen("poisson2d", 30, 40), 4, {}, None),
    "window_spill": (_gen("random_sparse", 300, 300, 6, seed=4), 1, {},
                     None),
    "rectangular": (_gen("random_sparse", 200, 150, 5, seed=6), 2, {},
                    None),
    "random_128": (_gen("random_sparse", 128, 128, 4, seed=9), 1, {}, None),
    "segment_rows_2": (_two_clusters, 1, {"segment_rows": 2}, None),
    "segment_rows_4": (lambda mod: _scattered_band(mod, 2000, 60, 5, 30), 2,
                       {"segment_rows": 4}, None),
    "segment_rows_8_bpo_2": (_gen("poisson2d", 40, 40), 2,
                             {"segment_rows": 8, "blocks_per_out": 2},
                             None),
    "segment_rows_8_bpo_4": (_gen("poisson2d", 40, 40), 2,
                             {"segment_rows": 8, "blocks_per_out": 4},
                             None),
    "segment_rows_16_banded": (_gen("banded_random", 1024, 48, 6, seed=7),
                               2, {"segment_rows": 16, "blocks_per_out": 2,
                                   "chunks_per_step": 8}, None),
    "blocks_per_out_2": (_gen("poisson2d", 40, 40), 2,
                         {"blocks_per_out": 2}, None),
    "blocks_per_out_4": (_gen("poisson2d", 40, 40), 2,
                         {"blocks_per_out": 4}, None),
    "empty_blocks": (_empty_blocks, 1, {"segment_rows": 4}, None),
    # the JAX test pretends a huge column space (tests/test_well.py:209)
    "auto_segment": (_gen("poisson2d", 24, 24), 2, {}, 4_000_000),
}
# the Pallas interpreter takes seconds a matrix; these cover whole x,
# each segment width's spill and folding, and the empty block
INTERPRET_CASES = ("poisson_w2", "window_spill", "rectangular",
                   "segment_rows_2", "segment_rows_4", "segment_rows_8_bpo_4",
                   "empty_blocks")


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
    """The port's host matrix of a case, or with ``jax`` the JAX
    package's (the same packer's copy: equal arrays)."""
    make, window_rows, _, ncols = CASES[name]
    cls = JaxWellMatrix if jax else WellMatrix
    w = cls.from_matrix_market(make(JaxMatrixMarket if jax else MatrixMarket),
                               window_rows=window_rows)
    if ncols is not None:
        w.num_columns = ncols
    return w


def _both(name, dtype=torch.float64):
    dev_kw = CASES[name][2]
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    Aj = jdev.DeviceWell.from_host(_host(name, jax=True), dtype=jdt,
                                   **dev_kw)
    At = DeviceWell.from_host(_host(name), dtype=dtype, device="cpu",
                              **dev_kw)
    return _host(name), Aj, At


def _x(n, seed=4):
    return np.random.default_rng(seed).standard_normal(n)


def _close(got, want, rtol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


def _same(t, a):
    a = np.asarray(a)
    assert tuple(t.shape) == a.shape
    assert str(t.dtype).replace("torch.", "") == a.dtype.name
    np.testing.assert_array_equal(t.numpy(), a)


def _same_container(At, Aj):
    for f in ("num_rows", "num_columns", "num_entries", "window_rows",
              "num_chunks", "num_groups", "chunks_per_step",
              "blocks_per_out", "segment_rows"):
        assert getattr(At, f) == getattr(Aj, f), f
    for f in ("value", "local_index", "window_start", "group_of_chunk",
              "block_of_step"):
        _same(getattr(At, f), getattr(Aj, f))
    assert (At.segment_of_step is None) == (Aj.segment_of_step is None)
    if Aj.segment_of_step is not None:
        _same(At.segment_of_step, Aj.segment_of_step)
    assert (At.spill is None) == (Aj.spill is None)
    if Aj.spill is not None:
        s, sj = At.spill, Aj.spill
        n, stored = sj.num_rows, int(np.asarray(sj.row_ptr)[sj.num_rows])
        _same(s.row_ptr, np.asarray(sj.row_ptr)[: n + 1])
        _same(s.column_index, np.asarray(sj.column_index)[:stored])
        _same(s.value, np.asarray(sj.value)[:stored])


@pytest.mark.parametrize("name", list(CASES))
def test_arrays_match_jax_container(name):
    _, Aj, At = _both(name)
    assert (At.segment_of_step is not None) == (
        "segment_rows" in CASES[name][2] or name == "auto_segment")
    _same_container(At, Aj)
    # the converter from the JAX container gives the very same arrays
    _same_container(well_from_spmv_tpu(Aj), Aj)


def test_auto_segment_switch():
    """The automatic switch to segmented mode picks the JAX container's
    large-x defaults (tests/test_well.py:209-219)."""
    _, _, At = _both("auto_segment", dtype=torch.float32)
    assert At.segment_rows == 4096
    assert At.blocks_per_out == 4 and At.chunks_per_step == 32
    assert At.segment_of_step is not None


@pytest.mark.parametrize("name", list(CASES))
def test_step_pointers_cover_every_step(name):
    """Output block b's steps are [step_ptr[b], step_ptr[b + 1]), and
    every chunk of them adds into a group of block b."""
    _, _, At = _both(name)
    ptr, blk = At.step_ptr, At.block_of_step
    assert ptr[0] == 0 and ptr[-1] == blk.numel()
    assert ptr.numel() == At.num_out_blocks + 1
    grp = At.group_of_chunk.reshape(-1, At.chunks_per_step)
    for b in range(At.num_out_blocks):
        lo, hi = int(ptr[b]), int(ptr[b + 1])
        assert bool((blk[lo:hi] == b).all())
        assert bool((grp[lo:hi] // At.out_rows == b).all())


@pytest.mark.parametrize("name", [n for n in CASES if n != "auto_segment"])
def test_plain_matches_jax_xla(name):
    w, Aj, At = _both(name)
    x = _x(At.num_columns)
    launches = (well_whole_core.launches, well_seg_core.launches,
                csr_spmv_core.launches)
    got = well_spmv(At, torch.from_numpy(x))
    _close(got, np.asarray(jspmv(Aj, jnp.asarray(x)))[: At.num_rows], 1e-12)
    _close(got, w.spmv(x), 1e-12)
    # the wrappers' composition is the plain specification, bit for bit
    assert torch.equal(got, well_spmv_reference(At, torch.from_numpy(x)))
    # CPU tensors take the plain versions: no kernel launched
    assert (well_whole_core.launches, well_seg_core.launches,
            csr_spmv_core.launches) == launches


@pytest.mark.parametrize("name", INTERPRET_CASES)
def test_plain_matches_pallas_interpret(name):
    _, Aj, At = _both(name)
    x = _x(At.num_columns, seed=5)
    got = well_spmv(At, torch.from_numpy(x))
    _close(got, jwell_spmv(Aj, jnp.asarray(x), interpret=True), 1e-12)


@pytest.mark.parametrize("name", [n for n in CASES if n != "auto_segment"])
def test_float32_matches_fp64_host(name):
    w, _, At = _both(name, dtype=torch.float32)
    assert At.value_dtype == torch.float32
    x = _x(At.num_columns, seed=6).astype(np.float32)
    got = well_spmv(At, torch.from_numpy(x))
    assert got.dtype == torch.float32
    want = w.spmv(x.astype(np.float64))
    err = np.abs(got.double().numpy() - want).max() / np.abs(want).max()
    assert err <= 1e-5, err


def test_columns_past_the_end_read_zero():
    """A gathered column at or past num_columns reads 0, as the Pallas
    kernels' zero-padded x does (XLA's clip would read x's last entry):
    slot 0 of chunk 0 moved past the end adds nothing, whatever its
    values."""
    _, _, At = _both("rectangular")
    x = torch.from_numpy(_x(At.num_columns))
    At.window_start[0, 0, 0] = 1 << 20
    At.value[0, 0] = 0.0
    want = well_chunks_reference(At, x)
    At.value[0, 0] = 1.0
    assert torch.equal(well_chunks_reference(At, x), want)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_narrow_dtypes_refused(dtype):
    with pytest.raises(MatrixError, match=">=32-bit"):
        DeviceWell.from_host(_host("rectangular"), dtype=dtype)
    with pytest.raises(JaxMatrixError):
        jdev.DeviceWell.from_host(_host("rectangular", jax=True),
                                  dtype=jnp.bfloat16)


def test_dispatch_forward_and_spmm_refusal():
    """``forward`` and ``spmv`` run the SpMV; ``spmm`` on ``DeviceWell``
    (refused until K6 was ported) is the plain SpMM, column by column the
    SpMV."""
    w, _, At = _both("window_spill")
    x = torch.from_numpy(_x(At.num_columns))
    _close(At(x), w.spmv(x.numpy()), 1e-12)
    x32 = x.float()                            # spmv casts it to float64
    _close(spmv(At, x32), w.spmv(x32.double().numpy()), 1e-12)
    X = torch.stack([x, 2 * x], dim=1)
    Y = spmm(At, X)
    assert torch.equal(Y, well_spmv_reference(At, X))
    for j in range(2):
        _close(Y[:, j], w.spmv(X[:, j].numpy()), 1e-12)


def test_out_buffer_and_mode_checks():
    _, _, At = _both("window_spill")
    _, _, As = _both("segment_rows_4")
    x = torch.from_numpy(_x(At.num_columns))
    out = torch.empty(At.num_rows)
    assert well_spmv_core(At, x, out=out) is out
    with pytest.raises(KernelError, match="whole-x"):
        well_seg_core(At, x)
    with pytest.raises(KernelError, match="segmented"):
        well_whole_core(As, torch.from_numpy(_x(As.num_columns)))


def _bad(At):
    n, m = At.num_rows, At.num_columns
    x = torch.ones(m)
    return {
        "dtype": dict(x=torch.ones(m, dtype=torch.float32)),
        "shape": dict(x=torch.ones(m + 1)),
        "strided": dict(x=torch.ones(2 * m)[::2]),
        "two_dim": dict(x=torch.ones(m, 1)),
        "out_aliases_x": dict(x=x, out=x[:n]),
        "out_shape": dict(x=x, out=torch.empty(n + 1)),
        "meta_device": dict(x=torch.ones(m, device="meta")),
    }


@pytest.mark.parametrize("what", ["dtype", "shape", "strided", "two_dim",
                                  "out_aliases_x", "out_shape",
                                  "meta_device"])
def test_wrapper_rejects_bad_inputs(what):
    """Checks run before anything else; a device that is neither the
    CPU nor CUDA raises instead of falling back."""
    _, _, At = _both("rectangular")
    args = _bad(At)[what]
    if what == "meta_device":
        At = At.to("meta")
    with pytest.raises(KernelError):
        well_spmv_core(At, args["x"], out=args.get("out"))


@pytest.mark.parametrize("name", ["poisson_w2", "rectangular",
                                  "segment_rows_4"])
def test_make_kernel_run_fn_chains(name):
    """``make_kernel("well").run_fn()`` chains y back into x (two buffers
    in turn on a square matrix) like the JAX kernel's step."""
    mm = CASES[name][0](MatrixMarket)
    k = make_kernel("well", mm=mm, device="cpu", dtype=torch.float64,
                    window_rows=CASES[name][1])
    k.init()
    w = k.matrix
    step, args = k.run_fn()
    v, want = args[0], np.ones(w.num_columns)
    for _ in range(3):
        nxt = step(v, *args[1:])
        assert nxt.data_ptr() != v.data_ptr()
        v = nxt
        y = w.spmv(want)
        want = y[: w.num_columns] if y.size >= w.num_columns else \
            np.concatenate([y, want[y.size:]])
    _close(v, want, 1e-12)


@pytest.mark.parametrize("name", ["poisson_w4", "window_spill"])
def test_bytes_and_describe_match_jax_kernel_at_x64(name):
    """The byte count is the JAX class's, at the tensor's width (the
    tests run JAX with x64 on, so the JAX class prices 8-byte values),
    less value + index of the host's all-zero slots, which K5 does not
    read: equal to it where no slot is all zero."""
    jk = JaxWellKernel(mm=CASES[name][0](JaxMatrixMarket))
    jk.init()
    host = np.asarray(jk.matrix.value)
    dead = int((host == 0).all(axis=2).sum())
    for dtype, vb in ((torch.float64, 8), (torch.float32, 4)):
        k = make_kernel("well", mm=CASES[name][0](MatrixMarket),
                        device="cpu", dtype=dtype)
        k.init()
        assert k.value_bytes == vb
        if dtype == torch.float64:
            want = jk.bytes_per_run() - dead * 128 * (8 + 4)
            assert k.bytes_per_run() == want
            assert k.traffic_split() == (want - jk.traffic_split()[1],
                                         jk.traffic_split()[1])
            assert (k.bytes_per_run() == jk.bytes_per_run()) == (dead == 0)
        stream, vec = k.traffic_split()
        assert vec == (k.matrix.num_rows + k.matrix.num_columns) * vb
        assert stream + vec == k.bytes_per_run()
        assert k.describe() == jk.describe()


@pytest.fixture(scope="module")
def poisson_file(tmp_path_factory):
    from spmv_tpu_torch.io import write_matrix_market

    p = tmp_path_factory.mktemp("well") / "poisson16.mtx"
    write_matrix_market(pgen.poisson2d(16, 16), str(p))
    return str(p)


def _run(fn, argv):
    out = io.StringIO()
    rc = fn(argv, out=out)
    return rc, out.getvalue()


CLI_MODES = {
    "profile": ["--profile", "2"],
    "cg": ["--cg", "300", "--cg-tol", "1e-10"],
}


@pytest.mark.parametrize("mode", list(CLI_MODES))
def test_cli_matches_jax_cli(mode, poisson_file):
    """``-s well``: the JAX CLI's report keys, kernel description and, for
    ``--cg``, its iteration count."""
    argv = ["--matrix", poisson_file, "--spmv-format", "well"] + \
        CLI_MODES[mode]
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
    if mode.startswith("cg"):
        assert doc["cg"]["iterations"] == want["cg"]["iterations"] > 0
        assert doc["cg"]["solution_rms_error_vs_ones"] < 1e-8
    else:
        assert doc["op"] == want["op"]
        assert doc["device"]["platform"] == "cpu"


def test_jacobi_cg_runs_the_dia_iteration(poisson_file):
    """Jacobi PCG on a WELL matrix takes the DIA path's iteration count
    on the same matrix (the JAX CLI cannot read a diagonal off its host
    WELL matrix; the port reads it from the Matrix Market entries)."""
    args = ["--matrix", poisson_file, "--cg", "300", "--cg-tol", "1e-10",
            "--precondition", "jacobi"]
    docs = {}
    for fmt in ("well", "dia"):
        rc, text = _run(main, args + ["--spmv-format", fmt])
        assert rc == 0
        docs[fmt] = json.loads(text)["cg"]
    assert docs["well"]["iterations"] == docs["dia"]["iterations"] > 0
    assert docs["well"]["solution_rms_error_vs_ones"] < 1e-8
