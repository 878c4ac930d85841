"""The ELL SpMV's plan (``ell_spmv_plan``, ``spmv_tpu_torch/ops/_launch.py``)
and the row lengths its kernel's paths are built for, against the JAX
package.

``ell_spmv_plan`` picks the path of ``csrc/ell_spmv.cu``: the row length
as a template argument up to ``ELL_MAX_SLOTS``, rounds of that many slots
past it.  The kernel runs only on the card (``tests/test_torch_cuda.py``
launches every path); here the plan is held to that definition and to
the C launcher's own cases, and ELL matrices of each row length the card
tests use (1, 4, 5, 6, 8, 9 and 12 slots, on both sides of the template
and of a round; 1,024 and 1,001 rows) go through the port's product (the
plain version the wrapper runs for CPU tensors) and JAX's XLA product
(``_ell_padded``) at rtol 1e-12 in float64, with the SpMM's columns
bitwise the SpMV's.  The sliced copy that ``profile/ell_study.py`` times
is held to its definition.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from spmv_tpu.io import generate as jgen
from spmv_tpu.models import EllMatrix as JEll
from spmv_tpu.models import device as jdev
from spmv_tpu.ops import spmv as jspmv
from spmv_tpu_torch.io import generate as pgen
from spmv_tpu_torch.models import DeviceEll, EllMatrix
from spmv_tpu_torch.ops import ell_spmm_core, ell_spmv_core
from spmv_tpu_torch.ops._launch import ELL_MAX_SLOTS, ell_spmv_plan
from spmv_tpu_torch.profile.ell_study import _sliced

RTOL = 1e-12
WIDTHS = (1, 4, 5, 6, 8, 9, 12)
SOURCE = (Path(__file__).resolve().parent.parent / "spmv_tpu_torch" / "csrc"
          / "ell_spmv.cu").read_text()


@pytest.mark.parametrize("length", range(0, 20))
def test_plan_slots_follow_the_row_length(length):
    """The template row length up to ELL_MAX_SLOTS; 0 (rounds) past it,
    and for a row length of 0 (no slot)."""
    plan = ell_spmv_plan(length)
    assert plan == {"slots": length if 0 < length <= ELL_MAX_SLOTS else 0}


def test_plan_stays_inside_the_launchers_limits():
    """The C launcher's template row lengths are the plan's: kMaxSlots,
    and a case for every slot count 0..kMaxSlots."""
    assert int(re.search(r"kMaxSlots = (\d+);", SOURCE).group(1)) == \
        ELL_MAX_SLOTS
    cases = {int(n) for n in re.findall(r"ELL_SLOTS_CASE\((\d+)\)", SOURCE)}
    assert cases == set(range(ELL_MAX_SLOTS + 1))


def _matrices(width, rows, seed):
    """The same ELL matrix in both packages: rows of 0..width entries at
    distinct columns below 700, the first row exactly width long."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(0, width + 1, size=rows)
    lengths[0] = width
    r = np.repeat(np.arange(rows), lengths)
    c = np.concatenate([rng.choice(700, size=n, replace=False)
                        for n in lengths])
    v = rng.standard_normal(r.size)
    return (EllMatrix.from_matrix_market(pgen.from_coo_arrays(
        rows, 700, r, c, v)), JEll.from_matrix_market(jgen.from_coo_arrays(
            rows, 700, r, c, v)))


@pytest.mark.parametrize("rows", [1024, 1001])
@pytest.mark.parametrize("width", WIDTHS)
def test_ell_widths_match_jax(width, rows):
    p, j = _matrices(width, rows, 100 * width + rows)
    A = DeviceEll.from_host(p, dtype=torch.float64, device="cpu")
    assert A.padded_row_length == width
    assert ell_spmv_plan(width)["slots"] == (
        width if width <= ELL_MAX_SLOTS else 0)
    rng = np.random.default_rng(width)
    x = rng.standard_normal(700)
    X = rng.standard_normal((700, 3))
    y = ell_spmv_core(A, torch.from_numpy(x))
    want = np.asarray(jspmv(jdev.DeviceEll.from_host(j), x))
    assert float(np.abs(y.numpy() - want).max()) <= \
        RTOL * float(np.abs(want).max())
    Y = ell_spmm_core(A, torch.from_numpy(X))
    for col in range(3):
        assert torch.equal(Y[:, col], ell_spmv_core(
            A, torch.from_numpy(X[:, col].copy())))


@pytest.mark.parametrize("h", [32, 128])
def test_study_slices_put_each_slot_where_the_layout_says(h):
    """``_sliced`` of a slot-major (L, n) buffer: slot s of row i at
    (i // h) h L + s h + i % h, so a slice's L slots lie together."""
    L, n = 5, 4 * h
    t = torch.arange(L * n, dtype=torch.int32).view(L, n)
    flat = _sliced(t, h)
    s, i = np.meshgrid(np.arange(L), np.arange(n), indexing="ij")
    at = (i // h) * h * L + s * h + i % h
    np.testing.assert_array_equal(flat.numpy()[at], t.numpy())
