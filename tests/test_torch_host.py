"""The port's copies of the JAX package's host code against the originals.

The port keeps its own copies of the host modules it needs (ingest and
generators, the host formats and their packers, the roofline, sample
statistics, JSON output and the machine-config reader), so that it
imports nothing of ``spmv_tpu``.  Each copy must give what the original
gives on the same inputs: equal arrays, bit for bit, from the native
packers and from the Python ones.
"""

import gzip
import io
import json

import numpy as np
import pytest

from spmv_tpu.io import generate as jgen
from spmv_tpu.io import matrix_market as jmm
from spmv_tpu.models import BsrMatrix as JBsr
from spmv_tpu.models import CsrMatrix as JCsr
from spmv_tpu.models import DiaMatrix as JDia
from spmv_tpu.models import WellCwMatrix as JWellCw
from spmv_tpu.models import WellMatrix as JWell
from spmv_tpu.models import _cw_native as j_cw_native
from spmv_tpu.models import _well_native as j_well_native
from spmv_tpu.models import auto_format as j_auto_format
from spmv_tpu.perfmodel import tiling as jtiling
from spmv_tpu.perfmodel import trace_config as jtrace
from spmv_tpu.utils import jsonio as jjsonio
from spmv_tpu.utils import sample as jsample
from spmv_tpu_torch.io import generate as pgen
from spmv_tpu_torch.io import matrix_market as pmm
from spmv_tpu_torch.models import BsrMatrix as PBsr
from spmv_tpu_torch.models import CsrMatrix as PCsr
from spmv_tpu_torch.models import DiaMatrix as PDia
from spmv_tpu_torch.models import WellCwMatrix as PWellCw
from spmv_tpu_torch.models import WellMatrix as PWell
from spmv_tpu_torch.models import _cw_native as p_cw_native
from spmv_tpu_torch.models import _well_native as p_well_native
from spmv_tpu_torch.models import auto_format as p_auto_format
from spmv_tpu_torch.perfmodel import tiling as ptiling
from spmv_tpu_torch.perfmodel import trace_config as ptrace
from spmv_tpu_torch.utils import jsonio as pjsonio
from spmv_tpu_torch.utils import sample as psample

GENERATORS = {
    "poisson2d": ("poisson2d", (13, 17), {}),
    "banded_random": ("banded_random", (700, 40, 6), {"seed": 3}),
    "random_sparse": ("random_sparse", (300, 250, 7), {"seed": 4}),
    "random_sparse_square": ("random_sparse", (400, 400, 9), {"seed": 1}),
}


def _gen(mod, name):
    fn, args, kw = GENERATORS[name]
    return getattr(mod, fn)(*args, **kw)


MM_FIELDS = ("object", "format", "field", "symmetry", "num_rows",
             "num_columns", "num_entries")
MM_ARRAYS = ("rows_1based", "cols_1based", "values")


def _same_arrays(a, b, fields):
    for f in fields:
        va, vb = getattr(a, f), getattr(b, f)
        if va is None or vb is None:
            assert va is None and vb is None, f
            continue
        va, vb = np.asarray(va), np.asarray(vb)
        assert va.dtype == vb.dtype, f
        np.testing.assert_array_equal(va, vb, err_msg=f)


def _same_mm(p, j):
    for f in MM_FIELDS:
        assert getattr(p, f) == getattr(j, f), f
    _same_arrays(p, j, MM_ARRAYS)


@pytest.mark.parametrize("name", list(GENERATORS))
def test_generators_match(name):
    _same_mm(_gen(pgen, name), _gen(jgen, name))


@pytest.mark.parametrize("suffix", [".mtx", ".mtx.gz"])
@pytest.mark.parametrize("name", list(GENERATORS))
def test_written_file_reads_back_equal(name, suffix, tmp_path):
    """The JAX writer's file, read by both loaders; and the port's
    writer gives the same bytes."""
    mm = _gen(jgen, name)
    path = tmp_path / f"m{suffix}"
    if suffix.endswith(".gz"):
        buf = io.StringIO()
        jmm.write_matrix_market(mm, buf)
        path.write_bytes(gzip.compress(buf.getvalue().encode()))
    else:
        jmm.write_matrix_market(mm, str(path))
    _same_mm(pmm.load_matrix(str(path)), jmm.load_matrix(str(path)))
    pbuf, jbuf = io.StringIO(), io.StringIO()
    pmm.write_matrix_market(_gen(pgen, name), pbuf)
    jmm.write_matrix_market(mm, jbuf)
    assert pbuf.getvalue() == jbuf.getvalue()


@pytest.fixture(params=["native", "python"])
def packer(request, monkeypatch):
    """Both packages' WELL and WELL-CW packers, native or Python."""
    if request.param == "python":
        for mod in (p_cw_native, j_cw_native, p_well_native, j_well_native):
            monkeypatch.setattr(mod, "available", lambda: False)
    return request.param


HOST_FORMATS = {
    "csr": (PCsr, JCsr, {}, ("row_ptr", "column_index", "value")),
    "dia": (PDia, JDia, {}, ("offsets", "data")),
    "well_w1": (PWell, JWell, {"window_rows": 1},
                ("value", "local_index", "window_start", "group_of_chunk")),
    "well_w4": (PWell, JWell, {"window_rows": 4},
                ("value", "local_index", "window_start", "group_of_chunk")),
    "wellcw": (PWellCw, JWellCw, {}, ()),
}


def _same_csr(p, j):
    if p is None or j is None:
        assert p is None and j is None
        return
    for f in ("num_rows", "num_columns", "num_entries"):
        assert getattr(p, f) == getattr(j, f), f
    _same_arrays(p, j, ("row_ptr", "column_index", "value"))


def _same_wellcw(p, j):
    for f in ("num_rows", "num_columns", "num_entries", "num_groups",
              "num_chunks", "remainder_fraction", "fill_ratio"):
        assert getattr(p, f) == getattr(j, f), f
    assert len(p.levels) == len(j.levels)
    for lp, lj in zip(p.levels, j.levels):
        assert lp.d == lj.d and lp.num_chunks == lj.num_chunks
        _same_arrays(lp, lj, ("value", "local_index", "anchor4",
                              "group_of_chunk"))
    pools_p, pools_j = p._pools(), j._pools()
    assert len(pools_p) == len(pools_j)
    for pp, pj in zip(pools_p, pools_j):
        assert pp.num_chunks == pj.num_chunks
        _same_arrays(pp, pj, ("value", "local_index", "anchor4", "rowmap"))
    _same_csr(p.remainder, j.remainder)


@pytest.mark.parametrize("fmt", list(HOST_FORMATS))
@pytest.mark.parametrize("name", ["banded_random", "random_sparse",
                                  "random_sparse_square"])
def test_host_formats_match(name, fmt, packer):
    pcls, jcls, kw, fields = HOST_FORMATS[fmt]
    p = pcls.from_matrix_market(_gen(pgen, name), **kw)
    j = jcls.from_matrix_market(_gen(jgen, name), **kw)
    if fmt == "wellcw":
        _same_wellcw(p, j)
    else:
        for f in ("num_rows", "num_columns", "num_entries"):
            assert getattr(p, f) == getattr(j, f), f
        _same_arrays(p, j, fields)
    if fmt.startswith("well_"):
        assert p.spill_fraction == j.spill_fraction
        _same_csr(p.spill, j.spill)
    x = np.random.default_rng(2).standard_normal(p.num_columns)
    np.testing.assert_array_equal(p.spmv(x), j.spmv(x))


BSR_FIELDS = ("num_rows", "num_columns", "num_entries", "block_rows",
              "num_blocks", "num_block_rows", "fill_ratio")


def _same_bsr(p, j):
    for f in BSR_FIELDS:
        assert getattr(p, f) == getattr(j, f), f
    _same_arrays(p, j, ("blocks", "block_col", "block_rowptr"))


@pytest.mark.parametrize("block_rows", [8, 32, 128, "auto"])
@pytest.mark.parametrize("name", ["poisson2d", "banded_random",
                                  "random_sparse"])
def test_bsr_host_matches(name, block_rows):
    """``BsrMatrix`` (``models/bsr.py``): the same blocks, block columns
    and row pointers from Matrix Market entries and from CSR, the same
    block counts and chosen height, and the same fp64 product."""
    pm, jm = _gen(pgen, name), _gen(jgen, name)
    p = PBsr.from_matrix_market(pm, block_rows=block_rows)
    j = JBsr.from_matrix_market(jm, block_rows=block_rows)
    _same_bsr(p, j)
    _same_bsr(PBsr.from_csr(PCsr.from_matrix_market(pm),
                            block_rows=block_rows),
              JBsr.from_csr(JCsr.from_matrix_market(jm),
                            block_rows=block_rows))
    rows, cols = pm.rows_1based - 1, pm.cols_1based - 1
    assert PBsr.block_counts(rows, cols, pm.num_columns) == \
        JBsr.block_counts(rows, cols, pm.num_columns)
    assert PBsr.choose_block_rows(rows, cols, pm.num_columns) == \
        JBsr.choose_block_rows(rows, cols, pm.num_columns)
    X = np.random.default_rng(5).standard_normal((p.num_columns, 3))
    np.testing.assert_array_equal(p.spmm(X), j.spmm(X))
    np.testing.assert_array_equal(p @ X[:, 0], j @ X[:, 0])


def test_bsr_host_guards_match():
    """The same refusals: a fill past ``max_fill``, a block height that
    is not a multiple of 8, padded CSR."""
    from spmv_tpu.errors import MatrixError as JMatrixError
    from spmv_tpu_torch.errors import MatrixError as PMatrixError

    for cls, gen, err in ((PBsr, pgen, PMatrixError),
                          (JBsr, jgen, JMatrixError)):
        mm = gen.random_sparse(1024, 1024, 2, seed=5)
        with pytest.raises(err, match="fill ratio"):
            cls.from_matrix_market(mm, max_fill=8.0)
        with pytest.raises(err, match="multiple of 8"):
            cls.from_matrix_market(mm, block_rows=12)


# name -> (generator, arguments, workload, the format both pick)
AUTO_CASES = {
    "dia": ("poisson2d", (13, 17), {}, "spmv", "dia"),
    "bsr": ("block_random", (1024, 1024, 2), {"seed": 2}, "spmm", "bsr"),
    "well": ("block_random", (1024, 1024, 2), {"seed": 2}, "spmv", "well"),
    "wellcw": ("random_sparse", (2000, 2000, 10), {"seed": 1}, "spmv",
               "wellcw"),
}


@pytest.mark.parametrize("case", list(AUTO_CASES))
def test_auto_format_matches(case):
    """``auto_format`` (``models/select.py``): the same format, the same
    rationale (every number it used) and the same host matrix."""
    fn, args, kw, workload, fmt = AUTO_CASES[case]
    p, p_why = p_auto_format(getattr(pgen, fn)(*args, **kw),
                             workload=workload)
    j, j_why = j_auto_format(getattr(jgen, fn)(*args, **kw),
                             workload=workload)
    assert p_why["format"] == fmt
    assert p_why == j_why
    assert p.format_name == j.format_name
    x = np.random.default_rng(6).standard_normal(p.num_columns)
    np.testing.assert_array_equal(p.spmv(x), j.spmv(x))


def test_native_packers_are_built_for_the_port():
    """The port builds the repository's C++ packers into its own ignored
    build directory (this machine has a C++ compiler)."""
    from spmv_tpu_torch import _hostlib

    for mod in (p_well_native, p_cw_native):
        assert mod.available()
    libs = sorted(p.name for p in _hostlib.BUILD_DIR.glob("*.so"))
    assert any(n.startswith("libwellpack_") for n in libs), libs
    assert any(n.startswith("libcwpack_") for n in libs), libs


@pytest.mark.parametrize("values", [[1.0], [3.0, 1.0, 2.0],
                                    [0.5, 0.25, 8.0, 2.0, 1.0, 1.5]])
def test_compute_sample_matches(values):
    p, j = psample.compute_sample(values, "s"), jsample.compute_sample(
        values, "s")
    assert vars(p) == vars(j)


def test_dump_json_matches():
    doc = {"a": 1, "b": [1.5, float("nan"), float("inf")],
           "c": {"d": np.float32(2.5), "e": np.arange(3)}, "f": None}
    pbuf, jbuf = io.StringIO(), io.StringIO()
    pjsonio.dump_json(doc, pbuf)
    jjsonio.dump_json(doc, jbuf)
    assert pbuf.getvalue() == jbuf.getvalue()
    json.loads(pbuf.getvalue())


@pytest.mark.parametrize("args", [
    dict(bytes_moved=1 << 30, flops=1 << 20),
    dict(bytes_moved=1 << 20, flops=1 << 40, dtype="bfloat16"),
    dict(bytes_moved=1 << 28, flops=1 << 28, resident_rw_bytes=1 << 20),
    dict(bytes_moved=1 << 28, flops=1 << 28, rw_bytes=1 << 26),
])
def test_roofline_time_matches(args):
    assert ptiling.roofline_time(**args) == jtiling.roofline_time(**args)


@pytest.mark.parametrize("name", ["cpu-2thread.json",
                                  "tpu-v5e-measured.json"])
def test_read_trace_config_matches(name):
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "configs", name)
    p, j = ptrace.read_trace_config(path), jtrace.read_trace_config(path)
    assert repr(p).replace("spmv_tpu_torch", "spmv_tpu") == repr(j)
